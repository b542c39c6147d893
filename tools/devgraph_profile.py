"""Per-stage profile of the device graph engine's assemble executable.

`t_dg_assemble` is one jitted program (stages + path cover + job
materialization); this tool captures a REAL chunk's inputs from a bench
corpus run, then re-jits the three stages separately and times warm
executions — naming which stage dominates instead of one opaque number.

Usage: python tools/devgraph_profile.py [region]
(defaults to a 30 kb slice of the bench corpus; builds it if missing)
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
    from lancet_jax.engine import devicepipe
    from lancet_jax.runner import run

    bench.build_corpus()
    region = sys.argv[1] if len(sys.argv) > 1 else "chr1:300-30000"
    cfg = Config(tumor_bam=os.path.join(bench.CORPUS_DIR, "tumor.bam"),
                 normal_bam=os.path.join(bench.CORPUS_DIR, "normal.bam"),
                 ref_fasta=os.path.join(bench.CORPUS_DIR, "ref.fa"),
                 region=region, num_threads=8)

    # capture each (K, shapes) attempt's inputs while the run proceeds
    captured: dict = {}
    orig = devicepipe._assemble

    def spy(b, ranks, K, N, E, Nc, Ec, raw, cfg_s, dfs_limit,
            max_indel, max_mismatch, mesh):
        captured.setdefault((K, Nc, Ec), (b, ranks, raw, cfg_s, dfs_limit,
                                          max_indel, max_mismatch))
        return orig(b, ranks, K, N, E, Nc, Ec, raw, cfg_s, dfs_limit,
                    max_indel, max_mismatch, mesh)

    devicepipe._assemble = spy
    os.environ["LANCET_DEVGRAPH"] = "1"
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            run(cfg, command_line="prof", date="D\n", engine="device")
    finally:
        devicepipe._assemble = orig

    import jax

    from lancet_jax.device import pipeline

    CM = devicepipe._CMAX
    for (K, N, E), (b, ranks, raw, cfg_s, dfs_limit, max_indel,
                    max_mismatch) in sorted(captured.items()):
        import jax.numpy as jnp

        ranks = jnp.asarray(ranks)
        raw_j = jnp.asarray(raw)
        NCRp = pipeline.NCR_DEFAULT
        NI = NCRp + 2 * CM  # run_attempt returns the compact state

        s1 = jax.jit(lambda b, r: pipeline.run_attempt(
            b, r, K, N, E, CM, cfg_s))
        st, res = s1(b, ranks)
        s2 = jax.jit(lambda st, res: pipeline.path_cover(
            st, res, K, NCRp, NI, CM, res["ends"]["dist"], dfs_limit,
            max_indel))
        paths = s2(st, res)
        s3 = jax.jit(lambda st, b, paths, res, raw_j: pipeline.
                     materialize_jobs(st, b, paths, res, K, N, NI, CM,
                                      raw_j, max_mismatch))
        jobs = s3(st, b, paths, res, raw_j)

        def t(f, *a):
            out = f(*a)  # warm
            jax.block_until_ready(out)
            t0 = time.perf_counter()
            out = f(*a)
            jax.block_until_ready(out)
            return time.perf_counter() - t0

        t1 = t(s1, b, ranks)
        t2 = t(s2, st, res)
        t3 = t(s3, st, b, paths, res, raw_j)
        print(f"K={K} N={N} E={E}: run_attempt={t1:.3f}s "
              f"path_cover={t2:.3f}s materialize={t3:.3f}s "
              f"(sum={t1 + t2 + t3:.3f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
