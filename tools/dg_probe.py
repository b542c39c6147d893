"""Direct devgraph probe with live progress (no stderr redirect).

Usage: python tools/dg_probe.py [region] [--warm]
Prints per-k progress lines and the full stats dict of a single run.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def main() -> int:
    import bench
    from lancet_jax.config import Config
    from lancet_jax.runner import run

    bench.build_corpus()
    region = sys.argv[1] if len(sys.argv) > 1 else "chr1:300-12000"
    nwin = bench.count_windows(region)
    cfg = Config(tumor_bam=os.path.join(bench.CORPUS_DIR, "tumor.bam"),
                 normal_bam=os.path.join(bench.CORPUS_DIR, "normal.bam"),
                 ref_fasta=os.path.join(bench.CORPUS_DIR, "ref.fa"),
                 region=region, num_threads=8)
    os.environ["LANCET_DEVGRAPH"] = "1"
    os.environ["LANCET_PROGRESS"] = "1"
    passes = 2 if "--warm" in sys.argv else 1
    for p in range(passes):
        stats: dict = {}
        t0 = time.time()
        run(cfg, command_line="p", date="D\n", engine="device", stats=stats)
        dt = time.time() - t0
        print(f"pass {p}: {nwin} windows in {dt:.2f}s = {nwin/dt:.1f} wps",
              flush=True)
        print("  stats:", {k: (round(v, 3) if isinstance(v, float) else v)
                           for k, v in sorted(stats.items())
                           if isinstance(v, (int, float))}, flush=True)
        print("  causes:", stats.get("dev_fallback_causes"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
