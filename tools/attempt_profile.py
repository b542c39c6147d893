"""Sub-stage profile of pipeline.run_attempt — the dominant cost of the
device graph engine's assemble executable (tools/devgraph_profile.py
names run_attempt at ~83%; this tool names the stage INSIDE it).

Captures a real chunk's inputs like devgraph_profile, then re-jits each
internal stage of run_attempt separately and times warm executions.

Usage: python tools/attempt_profile.py [region]
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
    import jax.numpy as jnp

    from lancet_jax.device import pipeline, stages

    CM = devicepipe._CMAX
    only_k = int(os.environ.get("ATTEMPT_PROFILE_K", "0"))
    for (K, N, E), (b, ranks, raw, cfg_s, dfs_limit, max_indel,
                    max_mismatch) in sorted(captured.items()):
        if only_k and K != only_k:
            continue
        ranks = jnp.asarray(ranks)
        NI = N + 2 * CM
        W = int(b["alive"].shape[0])
        # replicate _assemble's slice-to-fit so sub-stage shapes match
        if b["alive"].shape[1] > N:
            b = dict(b)
            for key2 in ("counts", "totq", "mq", "alive", "is_tumor",
                         "is_normal"):
                b[key2] = b[key2][:, :N]
            b["mers_w"] = tuple(m[:, :N] for m in b["mers_w"])
            for key2 in ("edge_src", "edge_dst", "edge_dir",
                         "edge_exists"):
                b[key2] = b[key2][:, :E]
            b["nid_proj"] = jnp.where(b["nid_proj"] < N,
                                      b["nid_proj"], -1)
        avgcov = b["avgcov"]

        def timed(name, fn, *a):
            out = jax.jit(fn)(*a)  # compile + warm
            jax.block_until_ready(out)
            t0 = time.perf_counter()
            out = jax.jit(fn)(*a)
            jax.block_until_ready(out)
            dt = time.perf_counter() - t0
            print(f"  {name:<28s} {dt * 1e3:8.1f} ms")
            return out

        print(f"K={K} N={N} E={E} W={W}:")

        # stage 1: extend
        def f_extend(b, ranks):
            st, _ = pipeline._extend_items(b, ranks, W, N, CM, K)
            st, _ = pipeline._extend_edges(st, b, W, E, N, CM, K)
            return st

        st = timed("extend", f_extend, b, ranks)

        def f_components(st):
            return stages.components(st["alive"], st["e_src"], st["e_dst"],
                                     st["e_alive"], st["rank"], CM)

        comp, numcomp, over_c = timed("components", f_components, st)

        def f_ref_ends(b, comp, st):
            return stages.ref_ends(
                b["nid_proj"], b["proj_isF"], b["rawlen_dev"], K, comp,
                st["alive"], st["csum"], st["merlen"],
                cfg_s["cov_threshold"], CM)

        ends = timed("ref_ends", f_ref_ends, b, comp, st)

        def f_wire(ends, st, comp):
            return stages.wire_anchors(
                ends, N, CM, st["e_src"], st["e_dst"], st["e_dir"],
                st["e_alive"], st["e_okey"], st["special"], st["alive"],
                comp)

        wired = timed("wire_anchors", f_wire, ends, st, comp)
        (st["e_src"], st["e_dst"], st["e_dir"], st["e_alive"],
         st["e_okey"], st["special"], st["alive"], comp) = wired
        st["comp"] = comp

        def f_compress(st):
            return stages.compress_round(dict(st), K, NI, N)

        st_scr, fb_scr = timed("compress(screen)", f_compress, st)

        def f_screen(st_scr):
            return stages.cycle_screen(
                st_scr["e_src"], st_scr["e_dst"], st_scr["e_dir"],
                st_scr["e_alive"], st_scr["alive"], st_scr["special"],
                st_scr["comp"], N, NI, CM)

        scr1 = timed("cycle_screen", f_screen, st_scr)
        scr1 = scr1 | fb_scr[:, None]
        print(f"    (screen flagged lanes: "
              f"{int(jnp.asarray(scr1).any(axis=1).sum())}/{W})")

        def f_cycseq(st, scr1):
            return stages.has_cycle_seq(
                st["e_src"], st["e_dst"], st["e_dir"], st["e_alive"],
                st["e_okey"], st["alive"], st["special"], N, NI, CM,
                lane_mask=scr1)

        timed("has_cycle_seq(masked)", f_cycseq, st, scr1)

        # cleanup sub-stages
        def f_c1(st):
            return stages.compress_round(dict(st), K, NI, N)

        st1, _ = timed("cleanup.compress1", f_c1, st)

        def f_lowcov(st1):
            return stages.low_cov_pass(
                dict(st1), K, N, NI, cfg_s["low_cov_threshold"],
                cfg_s["min_cov_ratio"], avgcov)

        st2, _ = timed("cleanup.lowcov", f_lowcov, st1)
        st3, _ = timed("cleanup.compress2", f_c1, st2)

        max_tip = cfg_s["max_tip_len"]

        def f_tips1(st3):
            merlen = st3["merlen"]

            def cond(items, deg):
                ml = jnp.take_along_axis(merlen, items[:, None], 1)[:, 0]
                return (deg <= 1) & (ml < max_tip)

            return stages._seq_removal_pass(dict(st3), cond, 256, 24)

        st4, _, _ = timed("cleanup.tips_pass1", f_tips1, st3)
        st5, _ = timed("cleanup.compress3", f_c1, st4)

        def f_guard(st5):
            mincov, _ = stages.item_mincovs(st5, K, N, NI)
            merlen = st5["merlen"]
            cand = (st5["alive"] & ~st5["special"]
                    & (merlen < cfg_s["max_link_len"]) & (merlen > 0))
            return pipeline._short_link_str_guard(
                st5, cand, K, N, NI, cfg_s["max_unit_len"],
                cfg_s["min_report_units"], cfg_s["min_report_len"],
                cfg_s["dist_from_str"])

        timed("cleanup.sl_guard", f_guard, st5)

        def f_full(b, ranks):
            return pipeline.run_attempt(b, ranks, K, N, E, CM, cfg_s)

        st_f, res_f = timed("run_attempt(FULL)", f_full, b, ranks)

        NCRp = pipeline.NCR_DEFAULT
        NI_f = NCRp + 2 * CM  # run_attempt returns the compact state
        dfs_limit = int(os.environ.get("ATTEMPT_PROFILE_DFS", str(1 << 30)))

        def f_paths(st_f, res_f):
            return pipeline.path_cover(
                st_f, res_f, K, NCRp, NI_f, CM, res_f["ends"]["dist"],
                dfs_limit, 500)

        paths_f = timed("path_cover", f_paths, st_f, res_f)

        def f_mat(st_f, b, paths_f, res_f, raw):
            return pipeline.materialize_jobs(
                st_f, b, paths_f, res_f, K, N, NI_f, CM, raw,
                max_mismatch)

        jobs_f = timed("materialize_jobs", f_mat, st_f, b, paths_f,
                       res_f, raw)

        def f_isrep(paths_f, st_f):
            LP = 1728
            W2, JMAX, _ = paths_f["sel_edges"].shape
            seq = jnp.zeros((W2, JMAX, LP), jnp.int8)
            return pipeline._is_almost_repeat_paths(
                seq, jnp.full((W2, JMAX), 600, jnp.int32), K,
                max_mismatch, LP)

        timed("  (isrep alone, L=600)", f_isrep, paths_f, st_f)

        def f_donor(st_f):
            return pipeline._donor_tables(st_f, K, N, NI_f, 96, 1536)

        timed("  (donor tables alone)", f_donor, st_f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
