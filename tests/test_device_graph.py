"""Device graph engine (device.dbg) vs the oracle, stage by stage.

Validates the batched sort/unique DBG build (ref: src/Graph.cc:530-589
buildgraph + :2790-2827 removeLowCov + Ref.cc:173-250 computeCoverage)
against the oracle engine on the golden scenario families.
"""

import numpy as np
import pytest

from lancet_jax.config import Config
from lancet_jax.engine.fastbuild import _add_ref_read
from lancet_jax.engine.graph import Graph
from lancet_jax.engine.micro import Microassembler
from lancet_jax.engine.node import FF, FR, NML, RF, RR, TMR
from lancet_jax.io import open_bam, open_fasta
from lancet_jax.windows import generate_windows
from tests.goldengen import scenario
from tests.helpers import write_pair

DIRS = {FF: 0, FR: 1, RF: 2, RR: 3}


def window_graphs(name, seed, tmp):
    """Extraction-complete (Graph, Ref, Config) per active window."""
    refseq, tumor, normal, region = scenario(name, seed)
    ref_path, t_path, n_path = write_pair(tmp, refseq, "chr1", tumor, normal)
    cfg = Config(tumor_bam=t_path, normal_bam=n_path, ref_fasta=ref_path,
                 region=region)
    fasta = open_fasta(cfg.ref_fasta)
    tb, nb = open_bam(cfg.tumor_bam), open_bam(cfg.normal_bam)
    windows = generate_windows(fasta, [region], fasta.lengths,
                               cfg.window_size, cfg.padding)
    ma = Microassembler(cfg, readers=(tb, nb), engine="oracle")
    out = []
    for w in sorted(windows, key=lambda x: x.name):
        refinfo = w.make_ref(cfg.min_k)
        ta, na = ma._fetch(0, w), ma._fetch(1, w)
        if cfg.active_regions:
            if not (ma.is_active_region(ta, refinfo, TMR)
                    or ma.is_active_region(na, refinfo, NML)):
                continue
        g = Graph(cfg, cfg.filters, ma.vdb)
        if ma.extract_reads(ta, g, refinfo, TMR):
            continue
        if ma.extract_reads(na, g, refinfo, NML):
            continue
        out.append((g, refinfo, cfg))
    return out


def device_build(gs, K=11, N=1024, E=2560, D=10, Lraw=1152, R=600, L=104):
    from lancet_jax.device import dbg
    from lancet_jax.device.pack import WindowBatch, gathered_reads, pack_window

    W = len(gs)
    batch = WindowBatch(W, R, L, Lraw)
    for w, (g, refinfo, cfg) in enumerate(gs):
        _add_ref_read(g, refinfo)
        reads, tot = gathered_reads(g, refinfo)
        pack_window(batch, w, reads, refinfo.rawseq, 0,
                    len(refinfo.rawseq), tot)
    assert not batch.overflow.any()
    cfg = gs[0][2]
    out = dbg.build_k(
        K, batch.bases, batch.quals, batch.rlen, batch.rsample,
        batch.rstrand, batch.rfrag, batch.rorder, batch.raw, batch.rawlen,
        batch.seq_off, batch.seq_len, batch.totalreadbp, batch.window_ok,
        N=N, E=E, D=D, Lraw=Lraw, min_qual_call=cfg.min_qual_call,
        low_cov_threshold=cfg.low_cov_threshold,
        min_cov_ratio=cfg.min_cov_ratio)
    return {k: np.asarray(v) for k, v in out.items()}


def _mers_of(out, w, nn, K):
    """Decode creation-order mer strings from the multi-word packed
    output (k <= 63)."""
    from lancet_jax.device.pack import unpack_mers_words

    mw = out["mers_w"]

    def wd(i):
        return (mw[i][w][:nn].astype(np.uint64) if i < len(mw)
                else np.zeros(nn, np.uint64))

    lo64 = wd(0) | (wd(1) << np.uint64(32))
    hi64 = wd(2) | (wd(3) << np.uint64(32))
    return unpack_mers_words(hi64, lo64, K)


def check_build(gs, out, K):

    for w, (g, refinfo, cfg) in enumerate(gs):
        refinfo.set_k(K)
        g.buildgraph(refinfo)
        g.mark_ref_nodes()
        g.remove_low_cov(False, 0)
        nn = int(out["n_nodes"][w])
        mers = _mers_of(out, w, nn, K)
        dev_alive = [m for i, m in enumerate(mers) if out["alive"][w][i]]
        orc_alive = list(g.nodes._val.keys())  # python insertion order
        assert dev_alive == orc_alive, f"window {w}: node creation order"
        nid = {m: i for i, m in enumerate(mers)}
        for m in orc_alive:
            node = g.nodes[m]
            i = nid[m]
            assert tuple(out["counts"][w][i]) == (
                node.cov_tmr_fwd, node.cov_tmr_rev, node.cov_nml_fwd,
                node.cov_nml_rev), (w, m)
            assert int(out["mincov_qv"][w][i]) == node.mincov_qv, (w, m)
            assert bool(out["is_tumor"][w][i]) == node.is_tumor, (w, m)
            assert bool(out["is_normal"][w][i]) == node.is_normal, (w, m)
            assert bool(out["in_index"][w][i]) == node.touch_ref, (w, m)
            mq = out["mq"][w][i]
            cdt, cdn = node.cov_distr_tmr, node.cov_distr_nml
            assert np.array_equal(mq[:, 0], cdt[:, 2]), (w, m)
            assert np.array_equal(mq[:, 1], cdt[:, 3]), (w, m)
            assert np.array_equal(mq[:, 2], cdn[:, 2]), (w, m)
            assert np.array_equal(mq[:, 3], cdn[:, 3]), (w, m)
            oe = [(e.nodeid, DIRS[e.dir]) for e in node.edges]
            de = []
            for s in range(out["adj"].shape[2]):
                ei = out["adj"][w][i][s]
                if ei < 0:
                    continue
                dst = int(out["edge_dst"][w][ei])
                de.append((mers[dst], int(out["edge_dir"][w][ei])))
            de_alive = [(mm, dd) for mm, dd in de
                        if out["alive"][w][nid[mm]]]
            assert oe == de_alive, (w, m)
        rc = out["refcov"][w][: len(refinfo.rawseq)]
        assert np.array_equal(rc[:, 0], refinfo.tumor_coverage[:, 0])
        assert np.array_equal(rc[:, 1], refinfo.tumor_coverage[:, 1])
        assert np.array_equal(rc[:, 2], refinfo.normal_coverage[:, 0])
        assert np.array_equal(rc[:, 3], refinfo.normal_coverage[:, 1])


@pytest.mark.parametrize("name,k", [
    ("somatic_snv", 11), ("somatic_ins", 11), ("somatic_del", 21),
    ("two_snvs", 11), ("adjacent_complex", 11), ("str_indel", 11),
    ("quality_trimmed", 11), ("random_storm", 21), ("shared_snv", 11),
    # k > 31: multi-word packed mers (3-4 uint32 words; the reference
    # ladder region the hard corpus actually reaches, k=37-41)
    ("somatic_snv", 37), ("somatic_del", 41), ("random_storm", 51),
])
def test_build_matches_oracle(tmp_path, name, k):
    gs = window_graphs(name, 1, str(tmp_path))
    assert gs
    for g, refinfo, _ in gs:
        g.set_k(k)
        refinfo.set_k(k)
    out = device_build(gs, K=k)
    assert not out["fallback"].any()
    check_build(gs, out, k)


def test_mate_overlap_candidates_fall_back(tmp_path):
    gs = window_graphs("paired_overlap", 1, str(tmp_path))
    assert gs
    out = device_build(gs, K=11)
    assert out["mate_cand"].all()
    assert out["fallback"].all()


def test_short_link_guard_cap_holds_every_device_k():
    """The STR guard's string buffer holds the longest short-link unitig
    (merlen < K//2 mers) at every k of the device ladder, so no base
    position is clipped onto another's cell."""
    from lancet_jax.device.pipeline import _sl_cap

    for K in range(11, 64, 2):
        assert _sl_cap(K) >= K // 2 - 1 + K - 1, K
        assert _sl_cap(K) % 32 == 0
