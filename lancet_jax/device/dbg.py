"""Batched device-side colored-DBG engine (SURVEY.md §7 core representation).

Implements the reference's per-k window assembly stage as fixed-shape JAX
over a window batch axis [W, ...]:

- ``build_k`` (jit, static k/caps): mer-instance generation from padded
  read tensors, canonicalization via 2-bit packed integers, sort/unique
  node dedup, segment-sum coverage/quality aggregates, first-occurrence
  edge tables, the fused markRefNodes + removeLowCov prune, and the
  reference-window coverage projection
  (ref: src/Graph.cc:119-589, :2233-2248, :2790-2827; src/Ref.cc:173-250).

Semantics are defined by the oracle engine (`engine.graph` /
`engine.fastbuild`); equality is asserted by tests/test_device_graph.py.

Conventions:
- base codes: A=0 C=1 G=2 T=3, N/invalid=4, pad>=4.
- mers are packed 2 bits/base into (hi, lo) uint32 pairs (k <= 31), first
  base in the highest bits so integer order == lexicographic base order.
- node axis is *creation order* (first-occurrence in the reference's
  visit stream), which is the map-insertion order the host-side
  libstdc++-order rank simulation consumes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# sample codes used on device (host maps TMR=4/NML=5/REF=3 onto these)
S_TMR = 0
S_NML = 1
S_REF = 2

# direction codes (FF=0 FR=1 RF=2 RR=3), matching engine.fastbuild
DIR_FF, DIR_FR, DIR_RF, DIR_RR = 0, 1, 2, 3

I32_MAX = np.int32(2**31 - 1)


def fliplink_code(d):
    """Edge reversal (ref: Edge.hh:103-111): FF<->RR, FR/RF fixed."""
    return ((d & 1) ^ 1) * 2 + ((d >> 1) ^ 1)


def _nwords(K):
    """uint32 words needed for a 2-bit-packed k-mer (k <= 101 -> 7)."""
    return (2 * K + 31) // 32


def _pack_mers(bases, K):
    """[..., L] base codes -> (fwd_words, rc_words, valid) packed k-mers
    at every offset m in [0, L-K]: mer m packs bases[m..m+K-1] MSB-first
    into a little-endian list of uint32 words (words[0] = least
    significant; lexicographic base order == multi-word integer order),
    and the reverse complement packed likewise; valid = all bases < 4.

    Word arrays have shape [..., M], M = L-K+1. The reference's Mer is a
    std::string (Mer.hh:45-120); 2x uint64 packing is the SURVEY.md §7
    tensor analog, here as 32-bit words (the device's native lane width).
    """
    L = bases.shape[-1]
    M = L - K + 1
    NW = _nwords(K)
    b = bases[..., :].astype(jnp.uint32)
    shape = bases.shape[:-1] + (M,)
    fw = [jnp.zeros(shape, jnp.uint32) for _ in range(NW)]
    rw = [jnp.zeros(shape, jnp.uint32) for _ in range(NW)]
    bad = jnp.zeros(shape, bool)
    U32 = jnp.uint32(0xFFFFFFFF)
    for j in range(K):
        bj = jax.lax.dynamic_slice_in_dim(b, j, M, axis=-1)
        bad = bad | (bj >= 4)
        bjc = bj & 3
        # fwd: shift the multi-word value left by 2 and or-in base j.
        # Words above bit 2j+1 are still zero and need no shift.
        for i in range(min(NW - 1, (2 * j + 1) // 32), 0, -1):
            fw[i] = ((fw[i] << 2) | (fw[i - 1] >> 30)) & U32
        fw[0] = ((fw[0] << 2) | bjc) & U32
        # rc: complemented base j goes to bit position 2j (little end of
        # the rc mer is base 0 of fwd) -> set bits directly
        comp = bjc ^ 3
        rw[(2 * j) // 32] = rw[(2 * j) // 32] | (comp << (2 * j % 32))
    return fw, rw, ~bad


def _lex_less(aw, bw):
    """Multi-word packed comparison == lexicographic base comparison.

    Both operands are little-endian uint32 word lists of equal length."""
    lt = jnp.zeros(aw[0].shape, bool)
    eq = jnp.ones(aw[0].shape, bool)
    for i in range(len(aw) - 1, -1, -1):
        lt = lt | (eq & (aw[i] < bw[i]))
        eq = eq & (aw[i] == bw[i])
    return lt


def _words_eq_adjacent(words):
    """[..., I] word list -> mask of positions where row i equals row i-1
    (along the last axis), for group-boundary detection after a sort."""
    eq = None
    for wd in words:
        e = wd[..., 1:] == wd[..., :-1]
        eq = e if eq is None else (eq & e)
    return eq


def _cummax(x, axis):
    return jax.lax.associative_scan(jnp.maximum, x, axis=axis)


@functools.partial(
    jax.jit,
    static_argnames=("K", "N", "E", "D", "Lraw", "low_cov_threshold",
                     "min_cov_ratio"))
def build_k(K, bases, quals, rlen, rsample, rstrand, rfrag, rorder,
            raw, rawlen, seq_off, seq_len, totalreadbp, window_ok,
            *, N, E, D, Lraw, min_qual_call,
            low_cov_threshold, min_cov_ratio):
    """One k attempt's graph build for a window batch.

    bases/quals: [W, R, L] uint8 (post-trim, junk reads removed; the ref
      pseudo-read is the last valid row with sample=S_REF and all quals
      'K'); rlen [W, R] int32 (0 = absent row).
    rsample [W, R] int8 (S_TMR/S_NML/S_REF); rstrand [W, R] int8 (0=fwd).
    rfrag [W, R] int32 fragment id (paired reads only, else -1);
    rorder [W, R] int8 mate order (0 unpaired, 1/2 mates): a node where
      both orders of one fragment meet is a hasOverlappingMate candidate
      (ref: Graph.cc:232-317) -> the window falls back to the native
      engine, which replays the std::binary_search quirk exactly.
    raw [W, Lraw] uint8 base codes; rawlen [W] int32.
    seq_off/seq_len [W] int32: current trimmed-seq state (stale-trim
      quirk: the mer index for this k uses the *previous* attempt's trim).
    totalreadbp [W] int32; window_ok [W] bool (lanes to compute).

    Returns a dict of node/edge tables in creation order (see module
    docstring) plus refcov and per-window fallback flags.
    """
    W, R, L = bases.shape
    M = L - K + 1
    Mraw = Lraw - K + 1
    # The ref pseudo-read (rawseq, all-'K' quals, untrimmed — oracle
    # add_read without trim, fastbuild._add_ref_read) is its own stream;
    # windows whose rawseq contains non-ACGT fall back on the host side.

    # ---- read-mer instances --------------------------------------------
    NW = _nwords(K)
    fw, rw, bvalid = _pack_mers(bases, K)  # [W, R, M] per word
    isF = _lex_less(fw, rw)
    mw = [jnp.where(isF, fw[i], rw[i]) for i in range(NW)]

    n_mers = jnp.maximum(rlen - K + 1, 0)  # per read
    use_read = (rlen - K) > 0  # reads with a single mer are skipped
    moff = jnp.arange(M, dtype=jnp.int32)[None, None, :]
    inst_valid = use_read[:, :, None] & (moff < n_mers[:, :, None]) & bvalid

    # per-pair quality gate: all K+1 quals >= minq (gap-free per read)
    qbad = (quals < min_qual_call).astype(jnp.int32)
    cq = jnp.cumsum(qbad, axis=-1)
    cq = jnp.concatenate([jnp.zeros((W, R, 1), jnp.int32), cq], axis=-1)
    # pair at offset m spans quals m..m+K (needs m+K <= L-1)
    MP = L - K  # pair offsets 0..MP-1
    pairq = (cq[..., K + 1 : K + 1 + MP] - cq[..., :MP]) == 0  # [W,R,MP]
    pairq = jnp.pad(pairq, ((0, 0), (0, 0), (0, M - MP)))

    # per-base qual-ok of the canonical-oriented mer: qok[m, j] =
    # q[m + (j if F else K-1-j)] >= minq -> packed as K bits (bit j of
    # word j//32; multi-word for k > 32)
    NQ = (K + 31) // 32
    qge = (quals >= min_qual_call)
    qok_f = [jnp.zeros((W, R, M), jnp.uint32) for _ in range(NQ)]
    qok_r = [jnp.zeros((W, R, M), jnp.uint32) for _ in range(NQ)]
    for j in range(K):
        col = jax.lax.dynamic_slice_in_dim(qge, j, M, axis=-1)
        cu = col.astype(jnp.uint32)
        qok_f[j // 32] = qok_f[j // 32] | (cu << (j % 32))  # fwd: base j
        jr = K - 1 - j  # rev orientation
        qok_r[jr // 32] = qok_r[jr // 32] | (cu << (jr % 32))
    qok_bits = [jnp.where(isF, qok_f[i], qok_r[i]) for i in range(NQ)]

    # stream position of each instance: g = running count of valid
    # instances in (read, offset) order within the window; the ref
    # pseudo-read comes last (oracle appends it after the alignments)
    flat_valid = inst_valid.reshape(W, R * M)
    g = jnp.cumsum(flat_valid.astype(jnp.int32), axis=1) - 1  # [W, R*M]
    g = g.reshape(W, R, M)
    pos0 = moff == 0
    is_last = moff == (n_mers[:, :, None] - 1)
    t_read = 2 * g - (~pos0).astype(jnp.int32)  # 2g for first, 2g-1 else
    n_read_inst = flat_valid.sum(axis=1).astype(jnp.int32)  # [W]

    # ---- ref-read / proj / index instances -----------------------------
    p_fw, p_rw, p_ok = _pack_mers(raw, K)  # [W, Mraw] per word
    p_isF = _lex_less(p_fw, p_rw)
    p_w = [jnp.where(p_isF, p_fw[i], p_rw[i]) for i in range(NW)]
    roff = jnp.arange(Mraw, dtype=jnp.int32)[None, :]
    # ref read: mers 0..rawlen-K (the full window, final mer included)
    ref_nmers = jnp.maximum(rawlen - K + 1, 0)
    ref_use = (rawlen - K) > 0
    ref_valid = (roff < ref_nmers[:, None]) & p_ok & ref_use[:, None]
    ref_g = n_read_inst[:, None] + roff
    ref_pos0 = roff == 0
    ref_last = roff == (ref_nmers[:, None] - 1)
    t_ref = 2 * ref_g - (~ref_pos0).astype(jnp.int32)
    # proj: every full-K rawseq mer 0..rawlen-K. The coverage projection
    # excludes the final mer (Ref.cc:51) via its own mask below, but the
    # source/sink anchor scan (Graph.cc:2028-2228) does consult it.
    proj_valid = (roff < (rawlen[:, None] - K + 1)) & p_ok
    # index: seq mers 0..seqlen-K-1, seq = raw[seq_off : seq_off+seq_len]
    idx_pos = seq_off[:, None] + roff
    idx_valid = (roff < (seq_len[:, None] - K)) & (idx_pos < Mraw)
    ip = jnp.clip(idx_pos, 0, Mraw - 1)
    i_w = [jnp.take_along_axis(p_w[i], ip, axis=1) for i in range(NW)]
    i_ok = jnp.take_along_axis(p_ok, ip, axis=1)
    idx_valid = idx_valid & i_ok

    # ---- combined instance table ---------------------------------------
    # order: read part, ref-read part, proj part, index part
    I = R * M + 3 * Mraw
    wid = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[:, None], (W, I))

    def cat(a_read, a_ref, a_proj, a_idx):
        return jnp.concatenate(
            [a_read.reshape(W, R * M), a_ref, a_proj, a_idx], axis=1)

    okW = window_ok[:, None]
    zero_rm = jnp.zeros((W, Mraw), bool)
    a_w = [cat(mw[i], p_w[i], p_w[i], i_w[i]) for i in range(NW)]
    a_valid = cat(inst_valid, ref_valid, proj_valid, idx_valid) & okW
    a_isread = cat(inst_valid, ref_valid, zero_rm, zero_rm) & okW
    a_isidx = cat(jnp.zeros((W, R, M), bool), zero_rm, zero_rm,
                  idx_valid) & okW
    big = jnp.int32(1 << 30)
    a_time = cat(t_read, t_ref, jnp.full((W, Mraw), big),
                 jnp.full((W, Mraw), big))
    samp = jnp.broadcast_to(rsample[:, :, None].astype(jnp.int8), (W, R, M))
    ref_s = jnp.full((W, Mraw), S_REF, jnp.int8)
    pad_s = jnp.full((W, Mraw), 7, jnp.int8)
    a_samp = cat(samp, ref_s, pad_s, pad_s)
    strd = jnp.broadcast_to(rstrand[:, :, None].astype(jnp.int8), (W, R, M))
    zero_s = jnp.zeros((W, Mraw), jnp.int8)
    a_strand = cat(strd, zero_s, zero_s, zero_s)
    zero_u = jnp.zeros((W, Mraw), jnp.uint32)
    a_qok = [cat(qok_bits[i], zero_u, zero_u, zero_u) for i in range(NQ)]
    # tumor-status flag: instance participates in a quality-clean tumor
    # pair as u (pair m) or v (pair m-1)
    pair_ok = pairq & (samp == S_TMR) & ~is_last & inst_valid
    prev_pair_ok = jnp.pad(pair_ok[:, :, :-1], ((0, 0), (0, 0), (1, 0)))
    a_tflag = cat(pair_ok | prev_pair_ok, zero_rm, zero_rm, zero_rm)

    # invalid instances sort to the end of their window segment
    key_w = [jnp.where(a_valid, a_w[i], jnp.uint32(0xFFFFFFFF))
             for i in range(NW)]
    src_idx = jnp.broadcast_to(
        jnp.arange(I, dtype=jnp.int32)[None, :], (W, I))
    # K <= 15 (97% of attempts): NW == 1 and the packed mer fits one word
    # (the 0xFFFFFFFF invalid sentinel exceeds any 30-bit mer) — a 1-key
    # sort is cheaper than the lexicographic multi-key form. Higher k adds
    # one sort key per 16 bases.
    sorted_ops = jax.lax.sort(tuple(reversed(key_w)) + (src_idx,),
                              num_keys=NW, dimension=1, is_stable=True)
    perm = sorted_ops[-1]

    def gather(a):
        return jnp.take_along_axis(a, perm, axis=1)

    s_w = list(reversed(sorted_ops[:NW]))  # back to little-endian order
    # payload flags ride ONE packed gather (one dynamic-index op instead
    # of six):
    # bit0 valid, bit1 isread, bit2 isidx, bits3-5 samp, bit6 strand,
    # bit7 tflag
    a_flags = (a_valid.astype(jnp.int32)
               | (a_isread.astype(jnp.int32) << 1)
               | (a_isidx.astype(jnp.int32) << 2)
               | (a_samp.astype(jnp.int32) << 3)
               | ((a_strand != 0).astype(jnp.int32) << 6)
               | (a_tflag.astype(jnp.int32) << 7))
    s_flags = gather(a_flags)
    s_valid = (s_flags & 1) != 0
    s_isread = (s_flags & 2) != 0
    s_isidx = (s_flags & 4) != 0
    s_samp = ((s_flags >> 3) & 7).astype(jnp.int8)
    s_strand = ((s_flags >> 6) & 1).astype(jnp.int8)
    s_tflag = (s_flags & 128) != 0
    s_time = gather(a_time)
    s_qok = [gather(a_qok[i]) for i in range(NQ)]

    # group boundaries per window (invalid tail forms its own groups that
    # we drop via s_valid)
    newg = jnp.ones((W, I), bool)
    newg = newg.at[:, 1:].set(~_words_eq_adjacent(s_w))
    newg = newg & s_valid
    gid_in_w = jnp.cumsum(newg.astype(jnp.int32), axis=1) - 1  # [W, I]
    n_groups = jnp.max(jnp.where(s_valid, gid_in_w + 1, 0), axis=1)  # [W]
    over_n = n_groups > N

    # aggregate per group with segment ops over [W, N+1]; slot N is the
    # dump segment for invalid/overflow instances so slot N-1 stays clean
    NS = N + 1
    seg = jnp.where(s_valid, jnp.minimum(gid_in_w, N), N)
    seg_full = (wid * NS + seg).reshape(-1)

    def seg_sum_lanes(vals):
        """[W, I, L] -> [W, N, L]: one fused segment op for L lanes."""
        v = vals.astype(jnp.int32).reshape(W * I, vals.shape[2])
        return jax.ops.segment_sum(
            v, seg_full, num_segments=W * NS).reshape(
                W, NS, vals.shape[2])[:, :N]

    is_cov = s_isread & (s_samp != S_REF)  # coverage visits (no dedup skip)
    # class 0..3 = (tmr fwd, tmr rev, nml fwd, nml rev); one fused
    # class-partitioned segment op replaces four (seg*4+class)
    cls = (jnp.where(s_samp == S_TMR, 0, 2)
           + (s_strand != 0).astype(jnp.int32))
    seg4 = jnp.where(is_cov & (gid_in_w < N) & s_valid,
                     gid_in_w * 4 + cls, 4 * N)
    seg4_full = (wid * (4 * N + 1) + seg4).reshape(-1)
    cnt4 = jax.ops.segment_sum(
        jnp.ones((W * I,), jnp.int32), seg4_full,
        num_segments=W * (4 * N + 1)).reshape(W, 4 * N + 1)
    cnt4 = cnt4[:, : 4 * N].reshape(W, N, 4)
    cnt_tf, cnt_tr, cnt_nf, cnt_nr = (cnt4[..., 0], cnt4[..., 1],
                                      cnt4[..., 2], cnt4[..., 3])

    # per-base qual-ok counts [W, N, K] per class — one fused op
    qbase = jnp.concatenate(
        [((s_qok[i][:, :, None]
           >> jnp.arange(min(32, K - 32 * i), dtype=jnp.uint32)) & 1
          ).astype(jnp.int16) for i in range(NQ)], axis=-1)  # [W, I, K]
    mq4 = jax.ops.segment_sum(
        qbase.astype(jnp.int32).reshape(W * I, K), seg4_full,
        num_segments=W * (4 * N + 1)).reshape(W, 4 * N + 1, K)
    mq4 = mq4[:, : 4 * N].reshape(W, N, 4, K)
    mq_tf, mq_tr, mq_nf, mq_nr = (mq4[:, :, 0], mq4[:, :, 1],
                                  mq4[:, :, 2], mq4[:, :, 3])

    # boolean aggregates: 4 lanes, one fused op
    any4 = seg_sum_lanes(jnp.stack(
        [s_isread.astype(jnp.int8), s_isidx.astype(jnp.int8),
         (s_isread & (s_samp == S_NML)).astype(jnp.int8),
         s_tflag.astype(jnp.int8)], axis=-1)) > 0
    has_node, in_index, is_normal, is_tumor = (
        any4[..., 0], any4[..., 1], any4[..., 2], any4[..., 3])

    # min-aggregates: time is monotone within a group (the stable sort
    # preserves instance order, and t_read/t_ref/proj/index times are
    # nondecreasing along it), so the group's first element carries the
    # min — but only over READ instances, which need not come first; use
    # one segment_min for time. Mer words are constant within a group —
    # one fused segment_min over NW lanes.
    first_time = jax.ops.segment_min(
        jnp.where(s_isread, s_time, big).reshape(-1), seg_full,
        num_segments=W * NS).reshape(W, NS)[:, :N]
    gw_st = jnp.stack(s_w, axis=-1)  # [W, I, NW] uint32
    gw_min = jax.ops.segment_min(
        gw_st.reshape(W * I, NW), seg_full,
        num_segments=W * NS).reshape(W, NS, NW)[:, :N]
    g_w = [gw_min[..., i] for i in range(NW)]
    # (all values in a group are equal)
    # ---- creation order ------------------------------------------------
    # node index = rank of first_time among this window's node groups
    node_key = jnp.where(has_node, first_time, big)
    order = jnp.argsort(node_key, axis=1)  # [W, crea] -> group slot
    # inverse permutation by scatter (an argsort would be a second sort)
    crea_of_group = jnp.zeros((W, N), jnp.int32)
    crea_of_group = crea_of_group.at[
        jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[:, None], (W, N)),
        order].set(jnp.broadcast_to(
            jnp.arange(N, dtype=jnp.int32)[None, :], (W, N)))
    n_nodes = has_node.sum(axis=1).astype(jnp.int32)

    def to_crea(a):
        idx = jnp.broadcast_to(
            order.reshape((W, N) + (1,) * (a.ndim - 2)), a.shape)
        return jnp.take_along_axis(a, idx, axis=1)

    mers_w = tuple(to_crea(g_w[i]) for i in range(NW))
    counts = jnp.stack([to_crea(cnt_tf), to_crea(cnt_tr),
                        to_crea(cnt_nf), to_crea(cnt_nr)], axis=-1)
    mq = jnp.stack([to_crea(mq_tf), to_crea(mq_tr),
                    to_crea(mq_nf), to_crea(mq_nr)], axis=-1)  # [W,N,K,4]
    n_in_index = to_crea(in_index)
    n_is_normal = to_crea(is_normal)
    n_is_tumor = to_crea(is_tumor)
    n_exists = to_crea(has_node)

    # ---- prune (fused markRefNodes + removeLowCov(False, 0)) ----------
    totq = mq.sum(axis=-1)  # [W, N, K]
    mincov_qv = jnp.where(n_exists, totq.min(axis=-1), 0)
    tot_t = counts[..., 0] + counts[..., 1]
    tot_n = counts[..., 2] + counts[..., 3]
    avgcov = totalreadbp.astype(jnp.float32) / jnp.maximum(
        rawlen.astype(jnp.float32), 1.0)
    low = ((mincov_qv <= low_cov_threshold)
           | (mincov_qv.astype(jnp.float32)
              <= min_cov_ratio * avgcov[:, None])
           | ((tot_t == 1) & (tot_n == 1)))
    alive = n_exists & ~low

    # ---- edges ---------------------------------------------------------
    # pair p at read instance offset m: u = inst m, v = inst m+1.
    # crea node id per instance: group slot -> crea index
    crea_inst = jnp.take_along_axis(
        crea_of_group, jnp.minimum(gid_in_w, N - 1), axis=1)
    crea_inst = jnp.where(s_valid & (gid_in_w < N), crea_inst, -1)
    # nid_orig[w, i] = crea id of instance i (original instance order):
    # scatter the sorted values back through perm (no inverse argsort)
    nid_orig = jnp.full((W, I), -1, jnp.int32).at[
        wid, perm].set(crea_inst)

    nid_read = nid_orig[:, : R * M].reshape(W, R, M)
    nid_ref = nid_orig[:, R * M : R * M + Mraw]
    nid_proj = nid_orig[:, R * M + Mraw : R * M + 2 * Mraw]

    pair_mask = inst_valid & ~is_last  # u side of pair m; v = m+1
    u = nid_read.reshape(W, R * M)
    v = jnp.pad(nid_read[:, :, 1:], ((0, 0), (0, 0), (0, 1)),
                constant_values=-1).reshape(W, R * M)
    uF = isF.reshape(W, R * M)
    vF = jnp.pad(isF[:, :, 1:], ((0, 0), (0, 0), (0, 1))).reshape(W, R * M)
    tpair = (2 * g).reshape(W, R * M)  # u->v at 2p, v->u at 2p+1
    pm = pair_mask.reshape(W, R * M)

    # ref-read pairs
    ref_pm = ref_valid & ~ref_last
    ru = nid_ref
    rv = jnp.pad(nid_ref[:, 1:], ((0, 0), (0, 1)), constant_values=-1)
    ruF = p_isF
    rvF = jnp.pad(p_isF[:, 1:], ((0, 0), (0, 1)))
    rtpair = 2 * ref_g

    PU = R * M + Mraw
    pu_src = jnp.concatenate([u, ru], axis=1)
    pu_dst = jnp.concatenate([v, rv], axis=1)
    pu_uF = jnp.concatenate([uF, ruF], axis=1)
    pu_vF = jnp.concatenate([vF, rvF], axis=1)
    pu_t = jnp.concatenate([tpair, rtpair], axis=1)
    pu_m = jnp.concatenate([pm, ref_pm], axis=1) & okW
    fdir = (1 - pu_uF.astype(jnp.int32)) * 2 + (1 - pu_vF.astype(jnp.int32))
    rdir = fliplink_code(fdir)

    # Each pair implies a directed edge (src,dst,fdir) at time 2p and
    # its twin (dst,src,rdir) at 2p+1 (ref: Graph.cc:320-347). Instead
    # of materializing and sorting BOTH directions (2*PU rows — the old
    # dominant build cost), dedup the CANONICAL form (lexicographic min
    # of the triple and its twin) at PU scale, carrying two time lanes
    # (seen-canonically vs seen-as-twin), then emit the two directed
    # rows per canonical group at E scale.
    use_tw = (pu_dst < pu_src) | ((pu_dst == pu_src) & (rdir < fdir))
    ck_s = jnp.where(use_tw, pu_dst, pu_src)
    ck_d = jnp.where(use_tw, pu_src, pu_dst)
    ck_r = jnp.where(use_tw, rdir, fdir)
    NODECAP = N + 64  # > any node id incl. fake anchors
    ckey = jnp.where(pu_m, (ck_s * NODECAP + ck_d) * 4 + ck_r, I32_MAX)
    tA = jnp.where(pu_m & ~use_tw, pu_t, big)
    tB = jnp.where(pu_m & use_tw, pu_t, big)
    ck, sA, sB = jax.lax.sort((ckey, tA, tB), num_keys=1, dimension=1,
                              is_stable=False)
    enew = jnp.ones((W, PU), bool)
    enew = enew.at[:, 1:].set(ck[:, 1:] != ck[:, :-1])
    ev = ck != I32_MAX
    enew = enew & ev
    egid = jnp.cumsum(enew.astype(jnp.int32), axis=1) - 1
    n_canon = jnp.max(jnp.where(ev, egid + 1, 0), axis=1)
    EC = E  # canonical-group cap (n_canon <= n_edges)
    wid_p = jnp.broadcast_to(
        jnp.arange(W, dtype=jnp.int32)[:, None], (W, PU))
    eseg = (wid_p * (EC + 1)
            + jnp.where(ev, jnp.minimum(egid, EC), EC)).reshape(-1)
    # one fused segment-min: (ckey, tA, tB) — ckey constant per group
    emin = jax.ops.segment_min(
        jnp.stack([ck, sA, sB], axis=-1).reshape(W * PU, 3), eseg,
        num_segments=W * (EC + 1)).reshape(W, EC + 1, 3)[:, :EC]
    g_ck, g_tA, g_tB = emin[..., 0], emin[..., 1], emin[..., 2]
    g_exists = g_ck != I32_MAX
    g_dir = jnp.where(g_exists, g_ck % 4, 0)
    g_dst = jnp.where(g_exists, (g_ck // 4) % NODECAP, 0)
    g_srcn = jnp.where(g_exists, g_ck // (4 * NODECAP), 0)
    t_canon = jnp.minimum(g_tA, jnp.minimum(g_tB, big - 1) + 1)
    t_twin = jnp.minimum(g_tB, jnp.minimum(g_tA, big - 1) + 1)
    # palindromic self-loops (src==dst, dir FR/RF) are their own twin:
    # the reference's fwd and twin rows dedup to ONE directed edge
    selftw = g_exists & (g_srcn == g_dst) & ((g_dir == 1) | (g_dir == 2))
    cat = lambda a, b: jnp.concatenate([a, b], axis=1)  # noqa: E731
    de_src = cat(g_srcn, g_dst)
    de_dst = cat(g_dst, g_srcn)
    de_dir = cat(g_dir, fliplink_code(g_dir))
    de_time = cat(t_canon, t_twin)
    de_exists = cat(g_exists, g_exists & ~selftw)
    n_edges = (2 * jnp.minimum(n_canon, EC)
               - selftw.sum(axis=1).astype(jnp.int32))
    over_e = (n_edges > E) | (n_canon > EC)

    # order the directed rows by first-occurrence time (the oracle's
    # eorder) and truncate to E columns (n_edges > E lanes fall back)
    et_key = jnp.where(de_exists, de_time, big)
    eorder = jnp.argsort(et_key, axis=1)[:, :E]

    def e_to_time_order(a, fill):
        out = jnp.take_along_axis(a, eorder, axis=1)
        return jnp.where(
            jnp.take_along_axis(de_exists, eorder, axis=1), out, fill)

    edge_src = e_to_time_order(de_src, -1)
    edge_dst = e_to_time_order(de_dst, -1)
    edge_dir = e_to_time_order(de_dir, 0).astype(jnp.int8)
    edge_exists = edge_src >= 0

    # ---- per-node out-edge adjacency (time-ordered slots) -------------
    # rank of each edge within its source node by time
    adj_rank_key1 = jnp.where(edge_exists, edge_src, I32_MAX)
    aidx = jnp.broadcast_to(
        jnp.arange(E, dtype=jnp.int32)[None, :], (W, E))
    ak1, aperm = jax.lax.sort((adj_rank_key1, aidx), num_keys=1,
                              dimension=1, is_stable=True)
    # edges already time-ordered, so a stable sort by src keeps time order
    anew = jnp.ones((W, E), bool)
    anew = anew.at[:, 1:].set(ak1[:, 1:] != ak1[:, :-1])
    run_start = _cummax(jnp.where(anew, aidx, 0), axis=1)
    slot = aidx - run_start  # position within the node's edge run
    a_exists = jnp.take_along_axis(edge_exists, aperm, axis=1)
    over_d = jnp.max(jnp.where(a_exists, slot + 1, 0), axis=1) > D
    # adjacency [W, N, D] of edge ids (index into time-ordered edge table)
    wid_a = jnp.broadcast_to(
        jnp.arange(W, dtype=jnp.int32)[:, None], (W, E))
    srcs = jnp.where(a_exists & (slot < D), ak1, N)  # N = dropped
    adj = jnp.full((W, N, D), -1, jnp.int32)
    adj = adj.at[wid_a, srcs, jnp.minimum(slot, D - 1)].set(
        aperm, mode="drop")
    deg = jax.ops.segment_sum(
        a_exists.astype(jnp.int32).reshape(-1),
        (wid_a * NS + jnp.where(a_exists, ak1, N)).reshape(-1),
        num_segments=W * NS).reshape(W, NS)[:, :N]

    # ---- reference coverage projection (Ref.cc:173-250) ---------------
    # per node per sample: seen_f/seen_r -> value = count if in_index
    def proj_val(cnt, seen_col):
        val = jnp.where(n_in_index & (seen_col > 0), cnt, 0)  # [W, N]
        safe = jnp.clip(nid_proj, 0, N - 1)
        pv = jnp.take_along_axis(val, safe, axis=1)
        return jnp.where(nid_proj >= 0, pv, 0)  # [W, Mraw]

    pv_tf = proj_val(counts[..., 0], counts[..., 0])
    pv_tr = proj_val(counts[..., 1], counts[..., 1])
    pv_nf = proj_val(counts[..., 2], counts[..., 2])
    pv_nr = proj_val(counts[..., 3], counts[..., 3])
    # mer i covers base i+K-1; mer 0 covers bases 0..K-1
    refcov = jnp.zeros((W, Lraw, 4), jnp.int32)
    pvals = jnp.stack([pv_tf, pv_tr, pv_nf, pv_nr], axis=-1)  # [W,Mraw,4]
    n_proj = jnp.maximum(rawlen - K, 0)
    pvalid = roff < n_proj[:, None]
    pv_masked = jnp.where(pvalid[:, :, None], pvals, 0)
    refcov = refcov.at[:, K - 1 :, :].set(
        pv_masked[:, : Lraw - K + 1, :])
    first_row = jnp.where((n_proj > 0)[:, None], pvals[:, 0, :], 0)
    refcov = refcov.at[:, : K - 1, :].set(
        jnp.broadcast_to(first_row[:, None, :], (W, K - 1, 4)))

    # ---- mate-overlap candidate detection ------------------------------
    # second sort keyed (mer, frag): a run holding both mate orders of one
    # fragment is a hasOverlappingMate candidate -> window fallback
    frag = jnp.broadcast_to(rfrag[:, :, None], (W, R, M)).reshape(W, R * M)
    order_r = jnp.broadcast_to(
        rorder[:, :, None], (W, R, M)).reshape(W, R * M)
    paired = (order_r > 0) & flat_valid
    IP = R * M
    fkey_w = [jnp.where(paired, mw[i].reshape(W, IP),
                        jnp.uint32(0xFFFFFFFF)) for i in range(NW)]
    fkey_fr = jnp.where(paired, frag, I32_MAX)
    fo = jnp.where(paired, order_r.astype(jnp.int32), 0)
    f_ops = jax.lax.sort(tuple(reversed(fkey_w)) + (fkey_fr, fo),
                         num_keys=NW + 1, dimension=1, is_stable=False)
    ff, ford = f_ops[-2], f_ops[-1]
    same = (_words_eq_adjacent(f_ops[:NW]) & (ff[:, 1:] == ff[:, :-1])
            & (ff[:, 1:] != I32_MAX))
    cand = same & (ford[:, 1:] != ford[:, :-1]) & (ford[:, 1:] > 0) \
        & (ford[:, :-1] > 0)
    mate_cand = cand.any(axis=1) & window_ok

    fallback = (over_n | over_e | over_d | mate_cand) & window_ok

    zero_n = jnp.zeros((W, N), jnp.uint32)
    return {
        "mers_w": mers_w,
        # hi/lo aliases for k <= 31 consumers (unpack_mers, tests)
        "mers_hi": mers_w[1] if NW >= 2 else zero_n,
        "mers_lo": mers_w[0],
        "counts": counts, "mq": mq.astype(jnp.int16), "totq": totq,
        "mincov_qv": mincov_qv,
        "exists": n_exists, "alive": alive, "low": low,
        "in_index": n_in_index, "is_tumor": n_is_tumor,
        "is_normal": n_is_normal,
        "n_nodes": n_nodes, "n_edges": n_edges,
        "edge_src": edge_src, "edge_dst": edge_dst, "edge_dir": edge_dir,
        "edge_exists": edge_exists,
        "adj": adj, "deg": deg,
        "nid_proj": nid_proj, "proj_isF": p_isF, "refcov": refcov,
        "avgcov": avgcov, "rawlen_dev": rawlen,
        "mate_cand": mate_cand,
        "fallback": fallback,
    }
