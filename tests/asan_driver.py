"""Driver for the sanitizer pass: exercises every native C++ entry point
(BGZF/BAM/BAI reader, faidx FASTA, sequence scans, lgb_build DBG kernel,
lgp_run per-k pipeline) WITHOUT touching JAX — XLA's compiler aborts
under an LD_PRELOADed ASan runtime through no fault of ours, so the
device stage is deliberately left undispatched (path jobs are collected
but never aligned). Run by test_native_asan.py in a subprocess with
LD_PRELOAD=libasan and LANCET_NATIVE_SO pointing at the ASan build.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))


def main() -> int:
    from goldengen import fuzz_corpus, scenario
    from helpers import write_pair

    from lancet_jax.config import Config
    from lancet_jax.engine.micro import Microassembler
    from lancet_jax.io import open_bam, open_fasta
    from lancet_jax.io.bam import BamReader as PyBam
    from lancet_jax.io.fasta import FastaFile as PyFasta
    from lancet_jax.native import NativeBamReader, NativeFastaFile
    from lancet_jax.runner import run
    from lancet_jax.windows import generate_windows

    assert os.environ.get("LANCET_NATIVE_SO"), "ASan .so not wired in"

    with tempfile.TemporaryDirectory() as td:
        refseq, tumor, normal, region = fuzz_corpus(3, n_events=6)
        ref_path, t_path, n_path = write_pair(td, refseq, "chr1",
                                              tumor, normal)

        # 1) native vs python reader equivalence (headers, jumps, scans)
        nb, pb = NativeBamReader(t_path), PyBam(t_path)
        assert nb.header_text.rstrip("\0") == pb.header_text.rstrip("\0")
        for lo, hi in [(600, 1800), (3000, 4200), (0, len(refseq))]:
            na = [(a.name, a.pos, a.cigar, a.seq) for a in
                  nb.fetch("chr1", lo, hi)]
            pa = [(a.name, a.pos, a.cigar, a.seq) for a in
                  pb.fetch("chr1", lo, hi)]
            assert na == pa, f"reader mismatch at {lo}-{hi}"
        nf, pf = NativeFastaFile(ref_path), PyFasta(ref_path)
        for lo, hi in [(1, 600), (2500, 3100), (len(refseq) - 99,
                                                len(refseq))]:
            assert nf.fetch("chr1", lo, hi) == pf.fetch("chr1", lo, hi)

        # 2) full oracle pipeline end-to-end over the native I/O plane
        cfg = Config(tumor_bam=t_path, normal_bam=n_path,
                     ref_fasta=ref_path, region=region)
        vcf = run(cfg, command_line="asan", date="D\n", engine="oracle")
        nrec = sum(1 for l in vcf.splitlines() if not l.startswith("#"))
        assert nrec > 0, "oracle run produced no records"

        # 3) lgb_build / lgp_run native kernels, device stage undispatched
        from lancet_jax.engine.fastpipe import available
        assert available(), "native pipeline kernel failed to load"
        fa = open_fasta(ref_path)
        windows = generate_windows(fa, [region], fa.lengths,
                                   cfg.window_size, cfg.padding)
        ma = Microassembler(cfg, readers=(open_bam(t_path),
                                          open_bam(n_path)), engine="device")
        for w in windows:
            ma.process_window(w)
        assert ma.path_jobs, "native pipeline produced no path jobs"

        # 4) LR-mode native plane (BX/HP extraction, LR build replay,
        # BX tables, HP/BX variant fields, varbuf v1). SNV-only corpus:
        # every job takes the HD<=5 fast path, so no device DP dispatch
        # happens and JAX stays untouched.
        lr_refseq, lr_t, lr_n, lr_region = scenario("lr_snv", 1)
        lr_ref, lr_tp, lr_np = write_pair(tempfile.mkdtemp(dir=td),
                                          lr_refseq, "chr1", lr_t, lr_n)
        lcfg = Config(tumor_bam=lr_tp, normal_bam=lr_np, ref_fasta=lr_ref,
                      region=lr_region, lr_mode=True)
        from lancet_jax.engine.shardrun import run_shards
        lfa = open_fasta(lr_ref)
        lwins = generate_windows(lfa, [lr_region], lfa.lengths,
                                 lcfg.window_size, lcfg.padding)
        res = run_shards(lcfg, lwins, open_bam(lr_tp), open_bam(lr_np))
        assert res is not None, "LR native shard run failed"
        lr_vars = [v for vs in res.variants_by_window.values() for v in vs]
        assert lr_vars, "LR native run produced no variants"
        assert any(v.bx_alt_t not in (".", "") for v in lr_vars), \
            "LR native run produced no BX sets"

        # 5) libstdc++ map-order rank kernel (devgraph's host round trip)
        import numpy as np

        from lancet_jax.native import lmo_ranks_batch
        rng = np.random.default_rng(7)
        for k2, n2 in ((15, 2800), (31, 900), (63, 300)):
            vals = np.unique(rng.integers(
                0, 1 << min(2 * k2, 62), n2, dtype=np.uint64))
            hi = (rng.integers(0, 4, len(vals), dtype=np.uint64)
                  if k2 > 32 else np.zeros(len(vals), np.uint64))
            offs = np.array([0, len(vals) // 2, len(vals)], np.int64)
            r, sl = lmo_ranks_batch(hi, vals, offs, k2)
            for b, e in zip(offs[:-1], offs[1:]):
                seg = r[b:e]
                assert sorted(seg.tolist()) == list(range(e - b)), k2

        print(f"asan driver ok: records={nrec} windows={len(windows)} "
              f"jobs={len(ma.path_jobs)} lr_vars={len(lr_vars)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
