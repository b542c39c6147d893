"""Quick devgraph end-to-end throughput probe on the bench corpus.

Usage: python tools/devgraph_bench.py [region] [--no-base]
Env: LANCET_DEVGRAPH_W to A/B chunk widths.

Runs the device graph engine (warm + timed) on the region and prints
windows/s plus the phase breakdown; optionally also checks the VCF
equals the default engine's.
"""

from __future__ import annotations

import contextlib
import io
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
    region = sys.argv[1] if len(sys.argv) > 1 else "chr1:300-30000"
    check_base = "--no-base" not in sys.argv
    nwin = bench.count_windows(region)
    cfg = Config(tumor_bam=os.path.join(bench.CORPUS_DIR, "tumor.bam"),
                 normal_bam=os.path.join(bench.CORPUS_DIR, "normal.bam"),
                 ref_fasta=os.path.join(bench.CORPUS_DIR, "ref.fa"),
                 region=region, num_threads=8)

    os.environ["LANCET_DEVGRAPH"] = "1"
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            run(cfg, command_line="p", date="D\n", engine="device",
                processes=True)  # warm: compiles cached
        stats: dict = {}
        t0 = time.time()
        with contextlib.redirect_stderr(io.StringIO()):
            vcf = run(cfg, command_line="p", date="D\n", engine="device",
                      processes=True, stats=stats)
        dt = time.time() - t0
    finally:
        del os.environ["LANCET_DEVGRAPH"]
    print(f"devgraph: {nwin} windows in {dt:.2f}s = {nwin / dt:.1f} wps")
    print("  phases:", {k: round(v, 2) for k, v in stats.items()
                        if k.startswith("t_dg")})
    print("  all stats:", {k: (round(v, 2) if isinstance(v, float) else v)
                              for k, v in sorted(stats.items())
                              if isinstance(v, (int, float))})
    print("  n_dev_windows:", stats.get("n_dev_windows"),
          "fallbacks:", stats.get("n_dev_fallback"),
          stats.get("dev_fallback_causes"),
          "attempts(chunk dispatches):", stats.get("n_dev_attempts"))
    if check_base:
        with contextlib.redirect_stderr(io.StringIO()):
            base = run(cfg, command_line="p", date="D\n", engine="device",
                       processes=True)
        print("  vcf_equal_to_default:", vcf == base)
    return 0


if __name__ == "__main__":
    sys.exit(main())
