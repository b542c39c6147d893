"""Device per-k assembly pipeline: glues device.dbg.build_k node/edge
tables and the host map-order ranks through the cleanup stages
(device.stages) and the path cover into PathJob tensors.

Per k attempt (one jit per shape bucket):
  components -> per-comp anchoring/clip/wiring -> cycle gate #1 ->
  compress -> removeLowCov(true) -> compress -> removeTips fixpoint ->
  removeShortLinks (STR-guarded) -> cycle gate #2 -> best-new-edge path
  cover (bounded BFS frontier) -> path/coverage materialization.

Reference flow: Microassembler.cc:73-249 processGraph; the per-component
sequential loop is component-parallel here (components share no nodes or
edges; the first failing component still aborts the window exactly like
the reference because later components' jobs are dropped on the host).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import stages
from .stages import BIG, _wid, destbit, fliplink, startbit

# compact-state caps (stages.compact_state): regular items / edges the
# post-compress graph may hold before the lane replays natively
NCR_DEFAULT = 512
ECR_DEFAULT = 1536


def _extend_items(b, ranks, W, N, Cmax, K):
    """jit1 node tables -> item/edge/mer state dict (item axis NI)."""
    NI = N + 2 * Cmax
    pad = NI - N

    def ext(a, fill):
        z = jnp.full((W, pad) + a.shape[2:], fill, a.dtype)
        return jnp.concatenate([a, z], axis=1)

    status_T = b["is_tumor"] & ~b["is_normal"]
    counts = b["counts"]
    totq = b["totq"]
    st = dict(
        alive=ext(b["alive"], False),
        special=jnp.zeros((W, NI), bool),
        rank=ext(ranks, jnp.int32(1 << 28)) if ranks.shape[1] == N
        else ranks,
        merlen=ext(jnp.where(b["alive"], 1, 0).astype(jnp.int32), 0),
        csum=ext(counts, 0),
        n_t=ext(status_T.astype(jnp.int32), 0),
        is_tumor=ext(b["is_tumor"], False),
        is_normal=ext(b["is_normal"], False),
        mer_item=jnp.broadcast_to(
            jnp.arange(N, dtype=jnp.int32)[None], (W, N)) + 0,
        mer_flip=jnp.zeros((W, N), bool),
        mer_pos=jnp.zeros((W, N), jnp.int32),
        keep_lo=jnp.zeros((W, N), jnp.int32),
        mer_tot=counts.sum(axis=-1),
        mer_totq=totq,
        mer_base=_mer_bases(b["mers_w"], K),
    )
    return st, NI


def _mer_bases(words, K):
    """Packed word list -> [W, N, K] canonical base codes (2-bit fields
    never straddle a word boundary: shifts are even)."""
    outs = []
    for j in range(K):
        sh = 2 * (K - 1 - j)
        b = (words[sh // 32] >> (sh % 32)) & 3
        outs.append(b.astype(jnp.int8))
    return jnp.stack(outs, axis=-1)


def _extend_edges(st, b, W, E, N, Cmax, K):
    EE = E + 4 * Cmax
    pad = EE - E

    def ext(a, fill):
        z = jnp.full((W, pad), fill, a.dtype)
        return jnp.concatenate([a, z], axis=1)

    alive_n = b["alive"]
    es, ed = b["edge_src"], b["edge_dst"]
    ea = (b["edge_exists"]
          & jnp.take_along_axis(alive_n, jnp.clip(es, 0, N - 1), 1)
          & jnp.take_along_axis(alive_n, jnp.clip(ed, 0, N - 1), 1))
    st["e_src"] = ext(jnp.where(ea, es, 0), 0)
    st["e_dst"] = ext(jnp.where(ea, ed, 0), 0)
    st["e_dir"] = ext(b["edge_dir"], 0)
    st["e_alive"] = ext(ea, False)
    st["e_okey"] = ext(jnp.broadcast_to(
        jnp.arange(E, dtype=jnp.int32)[None], (W, E)) + 0, BIG)
    st["keep_hi"] = jnp.full((W, N), K, jnp.int32)
    return st, EE


def cleanup(st, K, N, NI, cfg_s, avgcov, U=256, D2=24, TIP_ROUNDS=6,
            pre_fb=None):
    """lowcov(true) -> compress -> tips fixpoint -> short links ->
    compress (ref: Microassembler.cc:184-198). Returns (st, fallback).

    `st` must already be compressed once (compress #1 after cycle gate
    #1, Graph.cc:2712) — run_attempt computes that compress ONCE and
    shares it between the cycle screen and this cleanup (compress_round
    is pure, so the result is identical; the reuse removes one ~15%
    stage from every attempt). `pre_fb` is that compress's fallback."""
    fallback = jnp.zeros((st["alive"].shape[0],), bool)
    if pre_fb is not None:
        fallback |= pre_fb

    # removeLowCov(true, c) + compress
    st, _removed = stages.low_cov_pass(
        st, K, N, NI, cfg_s["low_cov_threshold"], cfg_s["min_cov_ratio"],
        avgcov)
    st, fb = stages.compress_round(st, K, NI, N)
    fallback |= fb

    # removeTips fixpoint (Graph.cc:2885-2926). Early-exit while_loop:
    # once a round removes nothing in any lane the remaining rounds are
    # identity (a removal-free sweep leaves st unchanged and compressing
    # an already-compressed graph is idempotent), so converged batches
    # skip straight to the convergence check. The loop CARRY holds only
    # the arrays the round mutates — rank/special/comp and the K-wide
    # mer payload tables are loop-invariant and live in the closure
    # (carried buffers are double-buffer-copied at every iteration
    # boundary; the invariant tables were most of that traffic).
    max_tip = cfg_s["max_tip_len"]
    _VKEYS = ("alive", "merlen", "csum", "n_t", "is_tumor", "is_normal",
              "e_src", "e_dst", "e_dir", "e_alive", "e_okey",
              "mer_item", "mer_flip", "mer_pos", "keep_lo", "keep_hi")
    st_base = dict(st)

    def _unpack(tup):
        out = dict(st_base)
        out.update(zip(_VKEYS, tup))
        return out

    def tip_cond(st):
        merlen = st["merlen"]

        def cond(items, deg):
            ml = jnp.take_along_axis(merlen, items[:, None], 1)[:, 0]
            return (deg <= 1) & (ml < max_tip)

        return cond

    def tip_body(carry):
        r, tup, fallback, _any = carry
        st_l = _unpack(tup)
        st_l, removed_any, over = stages._seq_removal_pass(
            st_l, tip_cond(st_l), U, D2)
        fallback = fallback | over
        hit = jnp.any(removed_any)
        # a removal-free round leaves the graph compressed already —
        # the compress would be identity, so it only runs on a hit
        st_l, fb = jax.lax.cond(
            hit,
            lambda s: stages.compress_round(s, K, NI, N),
            lambda s: (s, jnp.zeros_like(fallback)), st_l)
        fallback = fallback | fb
        return (r + 1, tuple(st_l[k] for k in _VKEYS), fallback, hit)

    r, tup, fallback, last_hit = jax.lax.while_loop(
        lambda c: (c[0] < TIP_ROUNDS) & ((c[0] == 0) | c[3]),
        tip_body, (jnp.int32(0), tuple(st[k] for k in _VKEYS), fallback,
                   jnp.bool_(True)))
    st = _unpack(tup)
    # non-convergence check: one more pass must remove nothing. When the
    # loop exited because its last round removed nothing, that round WAS
    # the verification — skip the extra sweep.
    W0 = st["alive"].shape[0]

    def verify(st):
        _st2, removed_any, over = stages._seq_removal_pass(
            st, tip_cond(st), U, D2)
        return removed_any | over

    fallback |= jax.lax.cond(
        last_hit, verify, lambda st: jnp.zeros((W0,), bool), st)

    # removeShortLinks (Graph.cc:2833-2880)
    mincov, _ = stages.item_mincovs(st, K, N, NI)
    thr = jnp.floor(jnp.sqrt(avgcov)).astype(jnp.int32)
    max_link = cfg_s["max_link_len"]
    # STR guard candidates: materialize short strings and probe pos K-1.
    # The guard only gates kills, and a kill needs initial degree >= 2
    # (the sequential pass only decrements) with mincov <= thr — when no
    # item in the batch satisfies that, the whole tandem probe is
    # skipped (short links are rare: an SNV bubble branch is ~K mers,
    # never < K/2).
    merlen = st["merlen"]
    cand = (st["alive"] & ~st["special"] & (merlen < max_link)
            & (merlen > 0))
    W = cand.shape[0]
    EE = st["e_src"].shape[1]
    deg0 = jnp.zeros((W, NI + 1), jnp.int32).at[
        stages._wid(W, EE),
        jnp.where(st["e_alive"], st["e_src"], NI)].add(
        jnp.where(st["e_alive"], 1, 0))[:, :NI]
    pre = cand & (deg0 >= 2) & (mincov <= thr[:, None])
    guard = jax.lax.cond(
        pre.any(),
        lambda: _short_link_str_guard(st, cand, K, N, NI,
                                      cfg_s["max_unit_len"],
                                      cfg_s["min_report_units"],
                                      cfg_s["min_report_len"],
                                      cfg_s["dist_from_str"]),
        lambda: jnp.zeros((W, NI), bool))

    def sl_cond(items, deg):
        ml = jnp.take_along_axis(merlen, items[:, None], 1)[:, 0]
        mc = jnp.take_along_axis(mincov, items[:, None], 1)[:, 0]
        gu = jnp.take_along_axis(guard, items[:, None], 1)[:, 0]
        return (deg >= 2) & (ml < max_link) & (mc <= thr) & ~gu

    # no possible kill -> the removal sweep is a no-op and the graph is
    # already compressed (post-tips), so the whole stage is skipped
    def do_sl(st):
        st2, _removed, over = stages._seq_removal_pass(st, sl_cond, U, D2)
        st3, fb = stages.compress_round(st2, K, NI, N)
        return st3, over | fb

    st, fb_sl = jax.lax.cond(
        pre.any(), do_sl,
        lambda st: (st, jnp.zeros((W,), bool)), st)
    fallback |= fb_sl
    return st, fallback


def run_attempt(b, ranks, K, N, E, Cmax, cfg_s, PC=192, NCR=NCR_DEFAULT,
                ECR=ECR_DEFAULT):
    """One k attempt past the build: components through cycle gate #2.

    b = build_k outputs (device); ranks [W, N] host map-order ranks.
    Returns (st, res): st is the COMPACT post-cleanup state (item axis
    NCR + 2*Cmax, anchors at slots NCR+2c/NCR+2c+1 — pass N=NCR to
    path_cover / the cycle helpers), res carries per-comp flags and
    anchor data. Lanes whose post-compress survivor counts exceed the
    compact caps are folded into res["fallback"] (native replay).
    """
    W = b["alive"].shape[0]
    st, NI = _extend_items(b, ranks, W, N, Cmax, K)
    st, EE = _extend_edges(st, b, W, E, N, Cmax, K)

    comp, numcomp, over_c = stages.components(
        st["alive"], st["e_src"], st["e_dst"], st["e_alive"], st["rank"],
        Cmax)
    ends = stages.ref_ends(
        b["nid_proj"], b["proj_isF"], b["rawlen_dev"], K, comp,
        st["alive"], st["csum"], st["merlen"], cfg_s["cov_threshold"],
        Cmax)
    (st["e_src"], st["e_dst"], st["e_dir"], st["e_alive"], st["e_okey"],
     st["special"], st["alive"], comp) = stages.wire_anchors(
        ends, N, Cmax, st["e_src"], st["e_dst"], st["e_dir"],
        st["e_alive"], st["e_okey"], st["special"], st["alive"], comp)
    st["comp"] = comp

    # source/sink anchored at the same node: the reference's sequential
    # clip/wire interplay is replicated, but the subsequent compress
    # tandem dance is not — rare; route to native
    same_anchor = (ends["anchored"]
                   & (ends["src_nid"] == ends["snk_nid"])).any(axis=1)

    # cycle gates: a parallel screen proves the common case (acyclic,
    # orientation-consistent) clean, so the exact sequential DFS replay
    # only walks the rare flagged lanes. The pre-cleanup graph has long
    # raw-mer chains (slow fixpoints), so the screen runs on a compressed
    # copy — compression preserves walk cycles and dual-orientation
    # reachability, the only two things the quirky node-colored DFS can
    # flag. That compressed state IS cleanup's compress #1 (identical
    # pure call), so it is computed once and passed along.
    st_c1, fb_c1 = stages.compress_round(dict(st), K, NI, N)
    # compact the survivors: every stage past compress #1 runs at
    # [W, NCR+2*Cmax]-sized item / [W, ECR+4*Cmax]-sized edge axes
    # (the round-5 profile put the wall in per-op overhead on the full
    # [W, ~3.5k] shapes; post-compress graphs hold tens of unitigs)
    st_cp, over_cp = stages.compact_state(st_c1, N, NI, Cmax, NCR, ECR)
    NIc = NCR + 2 * Cmax
    scr1 = stages.cycle_screen(
        st_cp["e_src"], st_cp["e_dst"], st_cp["e_dir"],
        st_cp["e_alive"], st_cp["alive"], st_cp["special"],
        st_cp["comp"], NCR, NIc, Cmax) | (fb_c1 | over_cp)[:, None]
    cyc1, over_p1 = stages.has_cycle_seq(
        st["e_src"], st["e_dst"], st["e_dir"], st["e_alive"],
        st["e_okey"], st["alive"], st["special"], N, NI, Cmax,
        lane_mask=scr1)

    avgcov = b["avgcov"]
    st, fb_clean = cleanup(st_cp, K, N, NIc, cfg_s, avgcov, pre_fb=fb_c1)

    scr2 = stages.cycle_screen(
        st["e_src"], st["e_dst"], st["e_dir"], st["e_alive"],
        st["alive"], st["special"], st["comp"], NCR, NIc, Cmax)
    cyc2, over_p2 = stages.has_cycle_seq(
        st["e_src"], st["e_dst"], st["e_dir"], st["e_alive"],
        st["e_okey"], st["alive"], st["special"], NCR, NIc, Cmax, D2=24,
        lane_mask=scr2)

    fallback = (b["fallback"] | over_c | over_p1 | over_p2 | fb_clean
                | over_cp | same_anchor)
    res = dict(cyc1=cyc1, cyc2=cyc2, ends=ends, numcomp=numcomp,
               fallback=fallback)
    return st, res


def path_cover(st, res, K, N, NI, Cmax, reflens, dfs_limit, max_indel,
               Q=512, POPMAX=1024, JMAX=8, PN=24, D2=24):
    """Best-new-edge path cover (ref: Graph.cc:1299-1501 bfs/eka) as a
    lockstep frontier loop. Per window, components are walked in order;
    each eka round re-runs the BFS with the live covered-edge set (later
    rounds can pass through the sink exactly like the reference), keeps
    the first-found best-scoring complete path, and marks its edges.

    Returns dict: sel_edges [W, JMAX, PN] (edge ids, source-first),
    sel_hops, sel_comp [W, JMAX], n_sel [W], fallback [W]."""
    W = st["alive"].shape[0]
    EE = st["e_src"].shape[1]
    e_src, e_dst, e_dir, e_alive = (st["e_src"], st["e_dst"], st["e_dir"],
                                    st["e_alive"])
    merlen, special = st["merlen"], st["special"]
    ends = res["ends"]
    runnable = (ends["anchored"] & ~res["cyc1"] & ~res["cyc2"])  # [W,Cmax]

    # adjacency in okey order (one packed-key sort, shared helper)
    adj, over_d = stages.okey_adjacency(
        e_src, st["e_dst"], e_dir, e_alive, st["e_okey"], NI, D2)

    wrow = jnp.arange(W, dtype=jnp.int32)
    sb_all = startbit(e_dir).astype(jnp.int32)

    def bfs(carry):
        """One eka round of BFS for all active lanes."""
        (c_w, covered, lane_on, *_rest) = carry
        src_item = N + 2 * (c_w - 1)
        sink_item = src_item + 1
        reflen = jnp.take_along_axis(
            reflens, jnp.clip(c_w - 1, 0, Cmax - 1)[:, None], 1)[:, 0]

        q_item = jnp.zeros((W, Q), jnp.int32).at[:, 0].set(src_item)
        q_dir = jnp.zeros((W, Q), jnp.int32)
        q_parent = jnp.full((W, Q), -1, jnp.int32)
        q_edge = jnp.full((W, Q), -1, jnp.int32)
        q_len = jnp.zeros((W, Q), jnp.int32).at[:, 0].set(K)
        q_flag = jnp.zeros((W, Q), bool).at[:, 0].set(True)
        q_score = jnp.zeros((W, Q), jnp.int32)
        head = jnp.zeros((W,), jnp.int32)
        tail = jnp.ones((W,), jnp.int32)
        visits = jnp.zeros((W,), jnp.int32)
        best_idx = jnp.full((W,), -1, jnp.int32)
        best_score = jnp.zeros((W,), jnp.int32)
        over_q = jnp.zeros((W,), bool)
        bfs_on = lane_on

        def cond(s):
            (qi, qd, qp, qe, ql, qf, qs, head, tail, visits, bi, bs,
             over_q, on, pops) = s
            return jnp.any(on & (head < tail)) & (pops < POPMAX)

        def body(s):
            (qi, qd, qp, qe, ql, qf, qs, head, tail, visits, bi, bs,
             over_q, on, pops) = s
            act = on & (head < tail)
            visits = visits + act
            lim = act & (visits > dfs_limit)
            on = on & ~lim
            act = act & ~lim
            hs = jnp.clip(head, 0, Q - 1)
            it = qi[wrow, hs]
            dr = qd[wrow, hs]
            ln = ql[wrow, hs]
            fl = qf[wrow, hs]
            sc = qs[wrow, hs]
            at_sink = act & (it == sink_item) & ~fl
            better = at_sink & ((bi < 0) | (sc > bs))
            bi = jnp.where(better, head, bi)
            bs = jnp.where(better, sc, bs)
            expand = act & ~at_sink & ~(ln > reflen + max_indel)
            its = jnp.clip(it, 0, NI - 1)
            # all D2 adjacency slots expanded in ONE batched scatter per
            # queue array (FIFO slot order = cumulative position among
            # valid expansions, identical to the slot-sequential writes)
            w2 = wrow[:, None]
            e = adj[wrow, its, :]  # [W, D2]
            es = jnp.clip(e, 0, EE - 1)
            okc = expand[:, None] & (e >= 0) & (sb_all[w2, es]
                                                == dr[:, None])
            dst = e_dst[w2, es]
            dsts = jnp.clip(dst, 0, NI - 1)
            spec = special[w2, dsts]
            nlen = ln[:, None] + jnp.where(spec, 1 - K, merlen[w2, dsts])
            cov_e = covered[w2, es]
            pos = jnp.cumsum(okc.astype(jnp.int32), axis=1) - okc
            tgt = tail[:, None] + pos
            wr = okc & (tgt < Q)
            over_q = over_q | jnp.any(okc & (tgt >= Q), axis=1)
            tgt_w = jnp.where(wr, tgt, Q)  # out-of-range -> dropped
            qi = qi.at[w2, tgt_w].set(dst, mode="drop")
            qd = qd.at[w2, tgt_w].set(
                destbit(e_dir[w2, es]).astype(jnp.int32), mode="drop")
            qp = qp.at[w2, tgt_w].set(
                jnp.broadcast_to(head[:, None], tgt_w.shape), mode="drop")
            qe = qe.at[w2, tgt_w].set(e, mode="drop")
            ql = ql.at[w2, tgt_w].set(nlen, mode="drop")
            qf = qf.at[w2, tgt_w].set(fl[:, None] & cov_e, mode="drop")
            qs = qs.at[w2, tgt_w].set(
                sc[:, None] + (~cov_e).astype(jnp.int32), mode="drop")
            tail = tail + jnp.sum(wr, axis=1)
            head = head + act
            return (qi, qd, qp, qe, ql, qf, qs, head, tail, visits, bi,
                    bs, over_q, on, pops + 1)

        s0 = (q_item, q_dir, q_parent, q_edge, q_len, q_flag, q_score,
              head, tail, visits, best_idx, best_score, over_q, bfs_on,
              jnp.int32(0))
        (qi, qd, qp, qe, ql, qf, qs, head, tail, visits, bi, bs, over_q,
         on, pops) = jax.lax.while_loop(cond, body, s0)
        # POPMAX hit with work left = unfaithful enumeration -> fallback
        over_q = over_q | (on & (head < tail))
        return qi, qp, qe, bi, over_q

    # outer loop over (comp advance | eka round)
    sel_edges = jnp.full((W, JMAX, PN), -1, jnp.int32)
    sel_hops = jnp.zeros((W, JMAX), jnp.int32)
    sel_comp = jnp.zeros((W, JMAX), jnp.int32)
    n_sel = jnp.zeros((W,), jnp.int32)
    covered = jnp.zeros((W, EE), bool)
    fallback = over_d
    c_w = jnp.ones((W,), jnp.int32)
    OUTER = Cmax + JMAX + 2

    def outer_body(o, carry):
        (c_w, covered, sel_edges, sel_hops, sel_comp, n_sel,
         fallback) = carry
        in_range = c_w <= res["numcomp"]
        can = jnp.take_along_axis(
            runnable, jnp.clip(c_w - 1, 0, Cmax - 1)[:, None], 1)[:, 0]
        lane_on = in_range & can
        qi, qp, qe, bi, over_q = bfs(
            (c_w, covered, lane_on))
        fallback = fallback | over_q
        has = lane_on & (bi >= 0) & ~over_q
        # walk parents of the best entry, marking covered and recording
        cur = jnp.where(has, bi, -1)
        hopbuf = jnp.full((W, PN), -1, jnp.int32)
        nh = jnp.zeros((W,), jnp.int32)

        def walk(p, wc):
            cur, covered, hopbuf, nh = wc
            okw = cur >= 0
            cs = jnp.clip(cur, 0, Q - 1)
            e = qe[wrow, cs]
            oke = okw & (e >= 0)
            covered = covered.at[
                wrow, jnp.clip(e, 0, EE - 1)].set(
                jnp.where(oke, True,
                          covered[wrow, jnp.clip(e, 0, EE - 1)]))
            hopbuf = hopbuf.at[wrow, jnp.minimum(p, PN - 1)].set(
                jnp.where(oke, e, -1))
            nh = nh + oke
            cur = jnp.where(oke, qp[wrow, cs], -1)
            return cur, covered, hopbuf, nh

        cur, covered, hopbuf, nh = jax.lax.fori_loop(
            0, PN, walk, (cur, covered, hopbuf, nh))
        fallback = fallback | (cur >= 0)  # path longer than PN
        over_j = has & (n_sel >= JMAX)
        fallback = fallback | over_j
        slot = jnp.clip(n_sel, 0, JMAX - 1)
        put = has & ~over_j
        # reverse hop order (walk collected sink-first)
        rev = jnp.arange(PN, dtype=jnp.int32)[None, :]
        src_pos = nh[:, None] - 1 - rev
        rbuf = jnp.where(
            (src_pos >= 0),
            jnp.take_along_axis(hopbuf, jnp.clip(src_pos, 0, PN - 1), 1),
            -1)
        sel_edges = sel_edges.at[wrow, slot].set(
            jnp.where(put[:, None], rbuf, sel_edges[wrow, slot]))
        sel_hops = sel_hops.at[wrow, slot].set(
            jnp.where(put, nh, sel_hops[wrow, slot]))
        sel_comp = sel_comp.at[wrow, slot].set(
            jnp.where(put, c_w, sel_comp[wrow, slot]))
        n_sel = n_sel + put
        # no path (or skipped comp) -> advance to next comp
        c_w = jnp.where(lane_on & has, c_w, c_w + 1)
        return (c_w, covered, sel_edges, sel_hops, sel_comp, n_sel,
                fallback)

    carry = (c_w, covered, sel_edges, sel_hops, sel_comp, n_sel, fallback)
    carry = jax.lax.fori_loop(0, OUTER, outer_body, carry)
    (c_w, covered, sel_edges, sel_hops, sel_comp, n_sel,
     fallback) = carry
    # windows still mid-walk after OUTER rounds: over budget
    fallback = fallback | (c_w <= res["numcomp"])
    return dict(sel_edges=sel_edges, sel_hops=sel_hops,
                sel_comp=sel_comp, n_sel=n_sel, fallback=fallback)


def _donor_tables(st, K, N, NI, US, LU):
    """Per-unitig base->donor maps: donor_mer/donor_ci [W, US, LU] and
    slot_of_item [W, NI] (-1 = not alive / over cap).

    Donor intervals partition each unitig's bases contiguously (the
    compress junction trims drop exactly the K-1 overlap), so instead
    of K scatters (one per in-mer offset) the map is built by ONE
    scatter of each mer's packed (id, pos, flip) record at its interval
    START, followed by a last-valid forward fill along the base axis."""
    W = st["alive"].shape[0]
    alive = st["alive"] & ~st["special"]
    key = jnp.where(alive, jnp.arange(NI, dtype=jnp.int32)[None], BIG)
    order = jnp.argsort(key, axis=1)[:, :US]
    n_alive = alive.sum(axis=1)
    slot_ok = jnp.arange(US, dtype=jnp.int32)[None] < n_alive[:, None]
    over = n_alive > US
    slot_of_item = jnp.full((W, NI), -1, jnp.int32)
    slot_of_item = slot_of_item.at[
        _wid(W, US), jnp.where(slot_ok, order, NI)].set(
        jnp.where(slot_ok, jnp.broadcast_to(
            jnp.arange(US, dtype=jnp.int32)[None], (W, US)), -1),
        mode="drop")
    mi = jnp.clip(st["mer_item"], 0, NI - 1)
    mslot = jnp.take_along_axis(slot_of_item, mi, 1)
    klo, khi = st["keep_lo"], st["keep_hi"]
    flip, pos = st["mer_flip"], st["mer_pos"]
    NM = mi.shape[1]
    midx = jnp.broadcast_to(jnp.arange(NM, dtype=jnp.int32)[None], (W, NM))
    keep = (khi > klo) & (mslot >= 0)
    start = pos + klo  # first donated base in unitig coords
    endp = pos + khi
    over_lu = (keep & (endp > LU)).any(axis=1)
    wr = keep & (start < LU)
    # packed record: mer id (12b) | flip (1b) | pos+8 (12b): pos can be
    # -K+1..LU-1 for fully-trimmed edge mers; +8 keeps the field small
    # and non-negative isn't required for kept mers (klo>=0 => start>=pos
    # => pos >= start-K+1 > -K). NM <= 4096, LU <= 1536 + K < 4096-8.
    assert NM <= 4096 and LU + 8 < 4096
    rec = (midx << 13) | (flip.astype(jnp.int32) << 12) | (pos + 8)
    starts = jnp.full((W, US, LU), -1, jnp.int32)
    starts = starts.at[
        _wid(W, NM), jnp.where(wr, mslot, US),
        jnp.clip(start, 0, LU - 1)].set(jnp.where(wr, rec, -1),
                                        mode="drop")
    # last-valid forward fill (associative: picks the rightmost valid).
    # Returned PACKED — materialize gathers the one packed table and
    # unpacks (mer id = >>13, flip = bit 12, pos = low 12 bits - 8);
    # three separate gathers of [W, J, LP] from [W, US, LU] were the
    # cost, not the unpack arithmetic.
    filled = jax.lax.associative_scan(
        lambda a, b: jnp.where(b >= 0, b, a), starts, axis=2)
    return filled, slot_of_item, over | over_lu


def materialize_jobs(st, b, paths, res, K, N, NI, Cmax, raw, max_mismatch,
                     LP=1728, US=96, LU=1536, PN=24):
    """Selected paths -> job tensors: pathseq codes, covT/covN [LP,4],
    tumor_span [LP+1], needs_dp, is_rep (the find_repeats gate probes
    the same selection sequence; ref Graph.cc:686-730, util.cc:317-360),
    per-path comp and the comp's trim data."""
    W, JMAX, _ = paths["sel_edges"].shape
    donor_packed, slot_of_item, over_dt = _donor_tables(
        st, K, N, NI, US, LU)
    fallback = paths["fallback"] | over_dt

    e_dst, e_dir = st["e_dst"], st["e_dir"]
    merlen, special = st["merlen"], st["special"]
    wrow3 = jnp.arange(W, dtype=jnp.int32)[:, None, None]
    hops = paths["sel_edges"]  # [W, J, PN]
    hsafe = jnp.clip(hops, 0, e_dst.shape[1] - 1)
    hvalid = hops >= 0
    nd = jnp.where(hvalid, e_dst[wrow3, hsafe], 0)  # node per hop
    nori = jnp.where(hvalid,
                     destbit(e_dir[wrow3, hsafe]).astype(jnp.int32), 0)
    nds = jnp.clip(nd, 0, NI - 1)
    nspec = special[wrow3, nds] | ~hvalid
    nml = merlen[wrow3, nds]
    Lh = jnp.where(nspec, 0, nml + K - 1)
    nonspec_rank = jnp.cumsum((~nspec).astype(jnp.int32), axis=2)
    first_ns = (~nspec) & (nonspec_rank == 1)
    contrib = jnp.where(nspec, 0,
                        jnp.where(first_ns, Lh, Lh - (K - 1)))
    cum = jnp.cumsum(contrib, axis=2)  # [W, J, PN] == pathcontig his
    Lp = cum[:, :, -1]
    over_lp = (Lp > LP).any(axis=1)
    fallback = fallback | over_lp

    # per-position node lookup
    p = jnp.arange(LP, dtype=jnp.int32)[None, None, :]
    # hidx[p] = #hops with cum <= p == max(h+1 : cum[h] <= p): scatter
    # (h+1) at position cum[h] (ties -> max wins, matching the count of
    # a sorted list) and forward-fill with a running max — replaces the
    # [W, J, LP, PN] compare-reduce with one scatter + one scan
    hop1 = jnp.broadcast_to(
        jnp.arange(1, PN + 1, dtype=jnp.int32)[None, None, :],
        (W, JMAX, PN))
    wid3 = jnp.broadcast_to(
        jnp.arange(W, dtype=jnp.int32)[:, None, None], (W, JMAX, PN))
    jid3 = jnp.broadcast_to(
        jnp.arange(JMAX, dtype=jnp.int32)[None, :, None], (W, JMAX, PN))
    hseed = jnp.zeros((W, JMAX, LP), jnp.int32).at[
        wid3, jid3, jnp.where(cum < LP, cum, LP)].max(
        hop1, mode="drop")
    hidx = jax.lax.associative_scan(jnp.maximum, hseed, axis=2)
    hclip = jnp.clip(hidx, 0, PN - 1)
    cumbefore = jnp.where(hidx > 0, jnp.take_along_axis(
        cum, jnp.clip(hidx - 1, 0, PN - 1), 2), 0)
    nd_p = jnp.take_along_axis(nd, hclip, 2)
    ori_p = jnp.take_along_axis(nori, hclip, 2)
    first_p = jnp.take_along_axis(first_ns, hclip, 2)
    Lh_p = jnp.take_along_axis(Lh, hclip, 2)
    off = p - cumbefore + jnp.where(first_p, 0, K - 1)
    uidx = jnp.where(ori_p == 1, Lh_p - 1 - off, off)
    slot_p = slot_of_item[wrow3, jnp.clip(nd_p, 0, NI - 1)]
    pvalid = (p < Lp[:, :, None]) & (slot_p >= 0)
    ls = jnp.clip(slot_p, 0, US - 1)
    lu = jnp.clip(uidx, 0, LU - 1)
    # ONE gather of the packed donor record, then unpack (the three
    # separate [W, J, LP] table gathers were the cost, not arithmetic)
    fp = donor_packed[wrow3, ls, lu]
    dm = jnp.where(fp >= 0, fp >> 13, -1)
    dfl = ((fp >> 12) & 1) == 1
    dpos = (fp & 0xFFF) - 8
    dci = jnp.where(dfl, K - 1 - (lu - dpos), lu - dpos)
    dm_ok = pvalid & (dm >= 0)
    dms = jnp.clip(dm, 0, N - 1)
    dcis = jnp.clip(dci, 0, K - 1)
    mb = st["mer_base"]  # [W, N, K]
    ch = mb[wrow3, dms, dcis].astype(jnp.int32)
    comp_flip = (dfl & (dm >= 0)) ^ (ori_p == 1)
    pathseq = jnp.where(dm_ok, jnp.where(comp_flip, ch ^ 3, ch), 4)
    # cnt/mq gathered once with all 4 class lanes riding the minor axis
    cnt = b["counts"]  # [W, N, 4] per-mer counts
    mq = b["mq"].astype(jnp.int32)  # [W, N, K, 4]
    cnt_g = jnp.where(dm_ok[..., None], cnt[wrow3, dms], 0)  # [W,J,LP,4]
    mq_g = jnp.where(dm_ok[..., None], mq[wrow3, dms, dcis], 0)
    covT = jnp.stack([cnt_g[..., 0], cnt_g[..., 1],
                      mq_g[..., 0], mq_g[..., 1]], axis=-1)
    covN = jnp.stack([cnt_g[..., 2], cnt_g[..., 3],
                      mq_g[..., 2], mq_g[..., 3]], axis=-1)

    # tumor_span [W, J, LP+1]: first node with hi >= pos; is_T per node
    n_t = st["n_t"]
    isT_item = (5 * n_t) > (4 * jnp.maximum(merlen, 1))  # frac > 0.8
    isT = isT_item[wrow3, nds] & ~nspec
    # hspan[p] = #hops with cum < p == hidx[p-1] (hspan[0] = 0)
    ps = jnp.arange(LP + 1, dtype=jnp.int32)[None, None, :]
    hspan = jnp.concatenate(
        [jnp.zeros((W, JMAX, 1), jnp.int32), hidx], axis=2)
    span = jnp.take_along_axis(isT, jnp.clip(hspan, 0, PN - 1), 2)
    span = span & (hspan < PN) & (ps <= Lp[:, :, None])

    # needs_dp: hamming vs the comp's trimmed ref slice
    comp_j = paths["sel_comp"]  # [W, J] 1-based
    ends = res["ends"]
    src_pos = jnp.take_along_axis(
        ends["src_pos"], jnp.clip(comp_j - 1, 0, Cmax - 1), 1)
    dist = jnp.take_along_axis(
        ends["dist"], jnp.clip(comp_j - 1, 0, Cmax - 1), 1)
    trim5 = src_pos
    rp = jnp.clip(src_pos[:, :, None] + p, 0, raw.shape[1] - 1)
    refch = raw.astype(jnp.int32)[wrow3, rp]
    mis = ((refch != pathseq) & (p < dist[:, :, None])).sum(axis=2)
    needs_dp = (Lp != dist) | (mis > 5)

    is_rep = _is_almost_repeat_paths(pathseq, Lp, K, max_mismatch, LP)

    # cov counts are bounded by the read cap (R <= 768), so int16
    # halves the largest D2H payloads
    return dict(pathseq=pathseq.astype(jnp.int8), lp=Lp,
                covT=covT.astype(jnp.int16), covN=covN.astype(jnp.int16),
                span=span, needs_dp=needs_dp, is_rep=is_rep,
                trim5=trim5, src_pos=src_pos, dist=dist,
                n_sel=paths["n_sel"], sel_comp=comp_j,
                fallback=fallback)


def _is_almost_repeat_paths(seq, lens, K, max_mismatch, LP):
    """isAlmostRepeat on path strings (ref: util.cc:317-360, mirrored by
    engine.seqs.is_almost_repeat): any two (K+1)-windows at offsets
    p < p+d (both <= L-K-1) with <= max_mismatch mismatches. Streamed
    over the shift axis d with O(B*L) state."""
    W, J, _ = seq.shape
    B = W * J
    s = seq.reshape(B, LP)
    ln = lens.reshape(B)
    # index-unique pad codes so OOB never matches
    posi = jnp.arange(LP, dtype=jnp.int32)[None, :]
    eff = jnp.where(posi < ln[:, None], s.astype(jnp.int32),
                    50 + posi % 37)
    w = K + 1
    maxp = ln - K - 1  # both pattern and candidate offsets bounded

    def body(d, hit):
        shifted = jnp.roll(eff, -d, axis=1)
        # roll wraps; wrapped tail positions exceed maxp checks anyway,
        # and index-unique pads keep them mismatched
        mneq = (shifted != eff).astype(jnp.int32)
        cs = jnp.cumsum(mneq, axis=1)
        zero = jnp.zeros((B, 1), jnp.int32)
        csp = jnp.concatenate([zero, cs], axis=1)
        # sums[p] = mismatches over window p..p+K (w wide)
        sums = csp[:, w:] - csp[:, :-w]  # [B, LP-w+1]
        pidx = jnp.arange(LP - w + 1, dtype=jnp.int32)[None, :]
        valid = (pidx <= maxp[:, None] - d) & (pidx <= maxp[:, None]) \
            & (d <= maxp[:, None])
        return hit | (valid & (sums <= max_mismatch)).any(axis=1)

    hit0 = jnp.zeros((B,), bool)
    # shifts beyond the longest path's maxp can't match: a dynamic
    # fori_loop bound cuts ~2/3 of the LP-sized static sweep for
    # typical ~600bp paths in the LP=1728 buffer
    d_hi = jnp.minimum(jnp.maximum(jnp.max(maxp) + 1, 1), LP)
    hit = jax.lax.fori_loop(1, d_hi, body, hit0)
    return hit.reshape(W, J)


# probed short-link items per window
_SL_ITEMS = 64


def _sl_cap(K):
    """Unitig string cap for the short-link STR guard: merlen < K//2 mers
    -> base length < K//2 + K - 1 (64 up to k=43, 96 at k=63). A cap
    below that would clip positions onto one cell: a truncated guard
    string, and duplicate scatter indices whose winner the GPU does not
    define."""
    return max(64, -(-(K // 2 + K - 1) // 32) * 32)


def _short_link_str_guard(st, cand, K, N, NI, max_unit_len,
                          min_report_units, min_report_len,
                          dist_from_str):
    """Per-item STR-guard flags: find_tandems(str, ..., K-1) reported a
    tandem near position K-1 (Graph.cc:2863-2870). Candidate strings are
    < 1.5K bases; up to _SL_ITEMS per window are probed (more than that
    many short branch nodes does not occur in practice — such windows
    have already overflowed other caps)."""
    W = cand.shape[0]
    # compact candidate items
    key = jnp.where(cand, jnp.arange(NI, dtype=jnp.int32)[None], BIG)
    order = jnp.argsort(key, axis=1)[:, :_SL_ITEMS]  # item ids
    n_cand = cand.sum(axis=1)
    slot_ok = (jnp.arange(_SL_ITEMS, dtype=jnp.int32)[None]
               < n_cand[:, None])
    slot_of_item = jnp.full((W, NI), -1, jnp.int32)
    slot_of_item = slot_of_item.at[
        _wid(W, _SL_ITEMS), jnp.where(slot_ok, order, NI)].set(
        jnp.where(slot_ok,
                  jnp.broadcast_to(
                      jnp.arange(_SL_ITEMS, dtype=jnp.int32)[None],
                      (W, _SL_ITEMS)), -1), mode="drop")

    # scatter candidate unitig bases: [W, _SL_ITEMS, cap]
    cap = _sl_cap(K)
    seqs = jnp.full((W, _SL_ITEMS, cap), 99, jnp.int32)
    mi = jnp.clip(st["mer_item"], 0, NI - 1)
    mslot = jnp.take_along_axis(slot_of_item, mi, 1)  # [W, N]
    base = st["mer_base"]  # [W, N, K] canonical base codes
    klo, khi = st["keep_lo"], st["keep_hi"]
    flip = st["mer_flip"]
    pos = st["mer_pos"]
    NM = mi.shape[1]
    for j in range(K):
        keep = (j >= klo) & (j < khi) & (mslot >= 0)
        ci = jnp.where(flip, K - 1 - j, j)
        bj = jnp.take_along_axis(base, jnp.clip(ci, 0, K - 1)[:, :, None],
                                 2)[:, :, 0].astype(jnp.int32)
        bj = jnp.where(flip, bj ^ 3, bj)
        tgt = jnp.clip(pos + j, 0, cap - 1)
        seqs = seqs.at[
            _wid(W, NM), jnp.where(keep, mslot, _SL_ITEMS), tgt].set(
            jnp.where(keep, bj, 99), mode="drop")
    item_len = st["merlen"] + K - 1
    lens = jnp.where(slot_ok, jnp.take_along_axis(
        item_len, jnp.clip(order, 0, NI - 1), 1), 0)
    ans = stages.tandem_at(
        seqs.reshape(W * _SL_ITEMS, cap),
        lens.reshape(W * _SL_ITEMS), K - 1, max_unit_len,
        min_report_units, min_report_len, dist_from_str
    ).reshape(W, _SL_ITEMS)
    guard = jnp.zeros((W, NI), bool)
    guard = guard.at[
        _wid(W, _SL_ITEMS), jnp.where(slot_ok, order, NI - 1)].max(
        jnp.where(slot_ok, ans, False), mode="drop")
    return guard
