"""Device-side graph cleanup stages over the jit1 (device.dbg.build_k) node
and edge tables: connected components, source/sink anchoring with
CLIP_REF_ENDS, the cycle gate as an exact lockstep DFS replay (the
reference's node-colored DFS is edge-order dependent), and unitig
compression as pointer-jumping over mutual-buddy chains with
donor-interval bookkeeping (ref: src/Graph.cc:2028-2336, :593-681,
:2486-2732).

State layout (all [W, ...], item axis NI = N + 2*Cmax where slots
N+2c / N+2c+1 are component c+1's fake source/sink):

- items: alive, special, rank (libstdc++ map-order rank from the host
  sim; survivor choice and component numbering replay it), comp,
  merlen, csum [NI,4] (summed per-mer counts; node coverage =
  csum/merlen exactly, replacing the reference's float cascade),
  n_t_status (count of status-'T' mers), is_tumor/is_normal.
- edges: e_src, e_dst, e_dir (FF=0 FR=1 RF=2 RR=3), e_alive, e_okey
  (per-source list order; renormalized to dense ranks each round).
- mers (fixed axis [N] from build): mer_item, mer_flip, mer_pos (mer
  offset within its item, unitig orientation), keep_lo/keep_hi (kept
  donor interval within the mer's K bases, unitig-oriented — the
  compressNode concatenation drops K-1 overlap bases at each junction
  on the absorbed side, Graph.cc:2563-2651).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

BIG = jnp.int32(1 << 30)

# okey packing for single-key edge sorts: real okeys are either edge
# creation indices (< E <= 10240) or Dcap-augmented renorm slots
# (< 192); the two BIG-2/BIG-1 anchor sentinels map to the top two
# codes. 14 bits holds them all, and (NI << 14) stays < 2^31 for every
# shape bucket (NI <= 4112).
_OKB = 14
_OKMAX = (1 << _OKB) - 1


def _pack_src_okey(e_src, e_okey, e_alive, NI):
    """[W, EE] single int32 key ordering (alive, src, okey) with dead
    rows last — replaces a 2-key variadic sort (one packed key halves
    the sort's operands and comparator stages)."""
    ok2 = jnp.where(e_okey >= BIG - 2,
                    jnp.minimum(e_okey - (BIG - 2) + (_OKMAX - 1), _OKMAX),
                    jnp.minimum(e_okey, _OKMAX - 2))
    return jnp.where(e_alive, (e_src << _OKB) | ok2, NI << _OKB)


def startbit(d):
    return d >> 1


def destbit(d):
    return d & 1


def fliplink(d):
    """(a,b) -> (!b,!a) (ref: Edge.hh:103-111)."""
    return ((d & 1) ^ 1) * 2 + ((d >> 1) ^ 1)


def _wid(W, n):
    return jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[:, None], (W, n))


# ---------------------------------------------------------------------------
# connected components (ref: Graph.cc:2252-2336)
# ---------------------------------------------------------------------------

def components(alive, e_src, e_dst, e_alive, rank, Cmax):
    """Labels connected components over alive items; numbers them 1.. in
    the order the reference's map iteration first reaches them
    (ascending min map-rank). Returns (comp [W,NI] int32 0=none,
    numcomp [W], over_c [W])."""
    W, NI = alive.shape
    E = e_src.shape[1]
    wid_e = _wid(W, E)
    idx = jnp.broadcast_to(jnp.arange(NI, dtype=jnp.int32)[None], (W, NI))
    label = jnp.where(alive, idx, BIG)
    ea = e_alive

    def body(state):
        label, _ = state
        m = jnp.minimum(
            jnp.take_along_axis(label, jnp.clip(e_src, 0, NI - 1), 1),
            jnp.take_along_axis(label, jnp.clip(e_dst, 0, NI - 1), 1))
        m = jnp.where(ea, m, BIG)
        new = label.at[wid_e, jnp.where(ea, e_src, 0)].min(
            jnp.where(ea, m, BIG))
        new = new.at[wid_e, jnp.where(ea, e_dst, 0)].min(
            jnp.where(ea, m, BIG))
        # pointer jumping (3 jumps/round ~ halves round count vs 2 for
        # the ~600-mer pre-compress chains; each jump is one cheap
        # [W, NI] gather while a round re-pays the edge relaxation)
        for _ in range(3):
            new = jnp.minimum(
                new, jnp.take_along_axis(new, jnp.clip(new, 0, NI - 1), 1))
        return new, jnp.any(new != label)

    label, _ = jax.lax.while_loop(
        lambda s: s[1], body, body((label, jnp.bool_(True))))

    # component numbering: ascending min map-rank per root
    lab_minrank = jnp.full((W, NI), BIG, jnp.int32)
    lab_minrank = lab_minrank.at[
        _wid(W, NI), jnp.clip(label, 0, NI - 1)].min(
        jnp.where(alive, rank, BIG))
    is_root = alive & (label == idx)
    root_key = jnp.where(is_root, lab_minrank, BIG)
    order = jnp.argsort(root_key, axis=1)  # [W, compidx] -> root item
    comp_of_root = jnp.zeros((W, NI), jnp.int32)
    comp_of_root = comp_of_root.at[
        _wid(W, NI), order].set(
        jnp.broadcast_to(
            jnp.arange(1, NI + 1, dtype=jnp.int32)[None], (W, NI)))
    comp = jnp.where(
        alive,
        jnp.take_along_axis(comp_of_root, jnp.clip(label, 0, NI - 1), 1), 0)
    numcomp = is_root.sum(axis=1).astype(jnp.int32)
    return comp, numcomp, numcomp > Cmax


# ---------------------------------------------------------------------------
# source/sink anchoring (ref: Graph.cc:2028-2228)
# ---------------------------------------------------------------------------

def ref_ends(nid_proj, proj_isF, rawlen, K, comp, alive, csum, merlen,
             cov_threshold, Cmax):
    """Per-component anchor scan over the rawseq mers. Returns per
    (window, comp 0..Cmax-1): anchored, src_pos/snk_pos, src_nid/snk_nid,
    src_ori/snk_ori (True=F), trims."""
    W, Mraw = nid_proj.shape
    roff = jnp.broadcast_to(
        jnp.arange(Mraw, dtype=jnp.int32)[None], (W, Mraw))
    valid = (nid_proj >= 0) & (roff <= rawlen[:, None] - K)
    safe = jnp.clip(nid_proj, 0, alive.shape[1] - 1)
    tot = csum.sum(axis=-1)  # node tot_cov * merlen; merlen==1 pre-compress
    nd_ok = alive & (tot >= cov_threshold)
    q = valid & jnp.take_along_axis(nd_ok, safe, 1)
    pcomp = jnp.where(q, jnp.take_along_axis(comp, safe, 1), 0)

    out = {}
    srcs = []
    for c in range(1, Cmax + 1):
        mc = q & (pcomp == c)
        has = mc.any(axis=1)
        src_pos = jnp.argmax(mc, axis=1).astype(jnp.int32)
        snk_pos = (Mraw - 1
                   - jnp.argmax(mc[:, ::-1], axis=1)).astype(jnp.int32)
        src_nid = jnp.take_along_axis(
            nid_proj, src_pos[:, None], 1)[:, 0]
        snk_nid = jnp.take_along_axis(
            nid_proj, snk_pos[:, None], 1)[:, 0]
        amb_src = (mc & (nid_proj == src_nid[:, None])).sum(axis=1) >= 2
        amb_snk = (mc & (nid_proj == snk_nid[:, None])).sum(axis=1) >= 2
        anchored = has & ~amb_src & ~amb_snk
        src_ori = jnp.take_along_axis(proj_isF, src_pos[:, None], 1)[:, 0]
        snk_ori = jnp.take_along_axis(proj_isF, snk_pos[:, None], 1)[:, 0]
        srcs.append((anchored, src_pos, snk_pos, src_nid, snk_nid,
                     src_ori, snk_ori))
    for name, i in (("anchored", 0), ("src_pos", 1), ("snk_pos", 2),
                    ("src_nid", 3), ("snk_nid", 4), ("src_ori", 5),
                    ("snk_ori", 6)):
        out[name] = jnp.stack([s[i] for s in srcs], axis=1)  # [W, Cmax]
    out["trim5"] = out["src_pos"]
    out["dist"] = out["snk_pos"] - out["src_pos"] + K
    out["trim3"] = rawlen[:, None] - out["snk_pos"] - K
    return out


def wire_anchors(ends, N, Cmax, e_src, e_dst, e_dir, e_alive, e_okey,
                 special, alive, comp):
    """CLIP_REF_ENDS + fake source/sink wiring (ref: Graph.cc:2156-2227).

    Edge rows E..E+4*Cmax-1 (pre-padded dead) become, per comp c:
    [fake_src->anchor, anchor->fake_src, fake_snk->anchor,
    anchor->fake_snk]. Returns updated edge arrays + item arrays."""
    W, EE = e_src.shape
    E = EE - 4 * Cmax
    anch = ends["anchored"]
    wid1 = jnp.arange(W, dtype=jnp.int32)

    sb = startbit(e_dir)
    db = destbit(e_dir)
    for c in range(Cmax):
        on = anch[:, c]
        sn = ends["src_nid"][:, c]
        so = ends["src_ori"][:, c]  # True = F
        kn = ends["snk_nid"][:, c]
        ko = ends["snk_ori"][:, c]
        # source clip (Graph.cc:2165-2191): edges from the source node
        # with startdir == (R if so==F else F), non-self; and their twins
        # (dst == source node, destbit == !clipdir). Bits: F=0, R=1.
        clip_sb = so.astype(jnp.int32)  # so==F(True) -> clip R(1)
        kill = (on[:, None] & e_alive
                & (((e_src == sn[:, None]) & (sb == clip_sb[:, None])
                    & (e_dst != sn[:, None]))
                   | ((e_dst == sn[:, None]) & (e_src != sn[:, None])
                      & (db == (~so).astype(jnp.int32)[:, None]))))
        e_alive = e_alive & ~kill
        # wire fake source: sourcedir = FF if so else FR
        fs = N + 2 * c
        sdir = jnp.where(so, 0, 1).astype(jnp.int8)  # FF=0 / FR=1
        row = E + 4 * c
        e_src = e_src.at[:, row].set(jnp.where(on, fs, e_src[:, row]))
        e_dst = e_dst.at[:, row].set(jnp.where(on, sn, e_dst[:, row]))
        e_dir = e_dir.at[:, row].set(
            jnp.where(on, sdir, e_dir[:, row]))
        e_alive = e_alive.at[:, row].set(on | e_alive[:, row])
        e_okey = e_okey.at[:, row].set(0)
        row = E + 4 * c + 1
        e_src = e_src.at[:, row].set(jnp.where(on, sn, e_src[:, row]))
        e_dst = e_dst.at[:, row].set(jnp.where(on, fs, e_dst[:, row]))
        e_dir = e_dir.at[:, row].set(
            jnp.where(on, fliplink(sdir), e_dir[:, row]).astype(jnp.int8))
        e_alive = e_alive.at[:, row].set(on | e_alive[:, row])
        e_okey = e_okey.at[:, row].set(BIG - 2)  # appended last
        special = special.at[:, fs].set(on | special[:, fs])
        alive = alive.at[:, fs].set(on | alive[:, fs])
        comp = comp.at[:, fs].set(jnp.where(on, c + 1, comp[:, fs]))

        # sink clip AFTER source wiring (the fresh fake edges are fair
        # game when source_node == sink_node, exactly like the reference)
        sb = startbit(e_dir)
        db = destbit(e_dir)
        clip_sb2 = (~ko).astype(jnp.int32)  # clip startdir == sink_ori
        kill = (on[:, None] & e_alive
                & (((e_src == kn[:, None]) & (sb == clip_sb2[:, None])
                    & (e_dst != kn[:, None]))
                   | ((e_dst == kn[:, None]) & (e_src != kn[:, None])
                      & (db == ko.astype(jnp.int32)[:, None]))))
        e_alive = e_alive & ~kill
        fk = N + 2 * c + 1
        kdir = jnp.where(ko, 3, 0).astype(jnp.int8)  # RR=3 / FF=0
        row = E + 4 * c + 2
        e_src = e_src.at[:, row].set(jnp.where(on, fk, e_src[:, row]))
        e_dst = e_dst.at[:, row].set(jnp.where(on, kn, e_dst[:, row]))
        e_dir = e_dir.at[:, row].set(jnp.where(on, kdir, e_dir[:, row]))
        e_alive = e_alive.at[:, row].set(on | e_alive[:, row])
        e_okey = e_okey.at[:, row].set(0)
        row = E + 4 * c + 3
        e_src = e_src.at[:, row].set(jnp.where(on, kn, e_src[:, row]))
        e_dst = e_dst.at[:, row].set(jnp.where(on, fk, e_dst[:, row]))
        e_dir = e_dir.at[:, row].set(
            jnp.where(on, fliplink(kdir), e_dir[:, row]).astype(jnp.int8))
        e_alive = e_alive.at[:, row].set(on | e_alive[:, row])
        e_okey = e_okey.at[:, row].set(BIG - 1)
        special = special.at[:, fk].set(on | special[:, fk])
        alive = alive.at[:, fk].set(on | alive[:, fk])
        comp = comp.at[:, fk].set(jnp.where(on, c + 1, comp[:, fk]))
        sb = startbit(e_dir)
        db = destbit(e_dir)
    return e_src, e_dst, e_dir, e_alive, e_okey, special, alive, comp


# ---------------------------------------------------------------------------
# buddy / chain machinery (ref: Node.cc:235-266 getBuddy)
# ---------------------------------------------------------------------------

def edge_renorm(e_src, e_okey, e_alive, NI):
    """Dense per-source okey ranks (stable in current okey order)."""
    W, EE = e_src.shape
    eidx = jnp.broadcast_to(
        jnp.arange(EE, dtype=jnp.int32)[None], (W, EE))
    packed = _pack_src_okey(e_src, e_okey, e_alive, NI)
    k1, perm = jax.lax.sort((packed, eidx), num_keys=1,
                            dimension=1, is_stable=True)
    k1 = k1 >> _OKB  # src runs
    newrun = jnp.ones((W, EE), bool)
    newrun = newrun.at[:, 1:].set(k1[:, 1:] != k1[:, :-1])
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(newrun, eidx, 0), axis=1)
    slot = eidx - run_start
    out = jnp.zeros((W, EE), jnp.int32)
    out = out.at[_wid(W, EE), perm].set(slot)
    return jnp.where(e_alive, out, BIG)


def links(e_src, e_dst, e_dir, e_alive, e_okey, alive, special, NI):
    """Mutual-buddy chain links. Returns dict with per-(item, bit):
    lnk_valid [W,NI,2], lnk_to (dst item), lnk_bit (continuation bit),
    tandem [W,NI], cnt [W,NI,2] (alive out-degree per direction)."""
    W, EE = e_src.shape
    wid_e = _wid(W, EE)
    sb = startbit(e_dir).astype(jnp.int32)
    seg = jnp.where(e_alive, e_src * 2 + sb, NI * 2)
    cnt = jnp.zeros((W, NI * 2 + 1), jnp.int32).at[wid_e, seg].add(
        jnp.where(e_alive, 1, 0))[:, :-1].reshape(W, NI, 2)
    # (dst, destbit) ride ONE packed scatter-min: only cnt==1 segments
    # are consumed, where the segment min IS the single edge's pair
    pk = jnp.full((W, NI * 2 + 1), BIG, jnp.int32).at[
        wid_e, seg].min(jnp.where(
            e_alive, e_dst * 2 + destbit(e_dir).astype(jnp.int32),
            BIG))[:, :-1]
    one_dst = jnp.where(pk == BIG, BIG, pk >> 1).reshape(W, NI, 2)
    one_db = jnp.where(pk == BIG, BIG, pk & 1).reshape(W, NI, 2)
    tandem = jnp.zeros((W, NI), bool).at[
        wid_e, jnp.where(e_alive & (e_src == e_dst), e_src, NI - 1)].max(
        e_alive & (e_src == e_dst))
    # unique edge in dir
    uniq = cnt == 1
    v = one_dst
    b = one_db
    idx = jnp.broadcast_to(
        jnp.arange(NI, dtype=jnp.int32)[None, :, None], (W, NI, 2))
    base = (uniq & (v != idx) & alive[:, :, None]
            & ~special[:, :, None] & ~tandem[:, :, None])
    vsafe = jnp.clip(v, 0, NI - 1)
    v_special = jnp.take_along_axis(
        special[:, :, None].repeat(2, 2), vsafe, 1)
    v_tandem = jnp.take_along_axis(
        tandem[:, :, None].repeat(2, 2), vsafe, 1)
    base = base & ~v_special & ~v_tandem
    # mutuality: v's unique edge in dir (!b) points back to u
    bdir = 1 - b  # bit of v pointing back toward u
    gather_i = vsafe * 2 + jnp.clip(bdir, 0, 1)
    cnt_f = cnt.reshape(W, NI * 2)
    dst_f = one_dst.reshape(W, NI * 2)
    gi = jnp.clip(gather_i, 0, NI * 2 - 1)
    back_uniq = jnp.take_along_axis(cnt_f, gi.reshape(W, -1),
                                    1).reshape(W, NI, 2) == 1
    back_dst = jnp.take_along_axis(dst_f, gi.reshape(W, -1),
                                   1).reshape(W, NI, 2)
    valid = base & back_uniq & (back_dst == idx)
    return {"lnk_valid": valid, "lnk_to": jnp.where(valid, v, idx),
            "lnk_bit": jnp.where(valid, b, 0), "tandem": tandem,
            "cnt": cnt}


def chain_jump(lnk, NI, rounds=None):
    """Pointer jumping over the link state graph (state = item*2+bit).
    Returns end_state [W, 2NI], dist [W, 2NI], cyc [W] (unterminated
    chain = mutual-buddy cycle -> window fallback).

    (nxt, dist) are packed into one int32 so each round costs ONE
    minor-axis gather, and the loop exits as soon as every lane's jumps are
    stable — post-compress graphs converge in 2-3 rounds while the
    static bound covers the longest legal chain (< NI items). dist
    saturates at DCAP > NI-1; a mutual-buddy cycle keeps doubling dist
    past that, which is the cycle verdict."""
    W = lnk["lnk_valid"].shape[0]
    S = NI * 2
    if rounds is None:
        # 2^rounds must reach DCAP so a cycle's doubling dist saturates
        # (and is seen as > NI-1) before the static bound cuts the loop
        rounds = max(2, int(NI + 8).bit_length())
    DBITS = 13
    assert S < (1 << (31 - DBITS)), "state id overflows the packed word"
    DCAP = jnp.int32(min(NI + 8, (1 << DBITS) - 1))
    valid = lnk["lnk_valid"].reshape(W, S)
    to = (lnk["lnk_to"] * 2 + lnk["lnk_bit"]).reshape(W, S)
    sid = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (W, S))
    nxt0 = jnp.where(valid, to, sid)
    d0 = jnp.where(valid, 1, 0).astype(jnp.int32)
    p0 = (nxt0 << DBITS) | d0

    def body(c):
        i, p, _ = c
        q = jnp.take_along_axis(p, p >> DBITS, 1)
        d2 = jnp.minimum((p & ((1 << DBITS) - 1))
                         + (q & ((1 << DBITS) - 1)), DCAP)
        p2 = (q & ~((1 << DBITS) - 1)) | d2
        return i + 1, p2, jnp.any(p2 != p)

    _, p, _ = jax.lax.while_loop(
        lambda c: (c[0] < rounds) & c[2], body,
        (jnp.int32(0), p0, jnp.bool_(True)))
    nxt = p >> DBITS
    dist = p & ((1 << DBITS) - 1)
    cyc = (dist > NI - 1).any(axis=1)
    return nxt, dist, cyc


# ---------------------------------------------------------------------------
# cleanup sweeps (ref: Graph.cc:2790-2926)
# ---------------------------------------------------------------------------

def item_mincovs(st, K, N, NI):
    """Per-item (mincov, mincov_qv) over the donor structure: a fully
    trimmed mer no longer donates bases (Node.cc:600-615 computed over
    the concatenated cov arrays)."""
    totq = st["mer_totq"]  # [W, N, K] per-mer per-base total qual counts
    tot = st["mer_tot"]  # [W, N] per-mer total coverage
    klo, khi = st["keep_lo"], st["keep_hi"]
    flip = st["mer_flip"]
    W, NM = tot.shape
    # canonical-coordinate kept interval
    clo = jnp.where(flip, K - khi, klo)
    chi = jnp.where(flip, K - klo, khi)
    j = jnp.arange(K, dtype=jnp.int32)[None, None, :]
    inside = (j >= clo[:, :, None]) & (j < chi[:, :, None])
    mq_min = jnp.where(inside, totq, BIG).min(axis=-1)  # [W, N]
    width = khi - klo
    mi = jnp.where(width > 0, jnp.clip(st["mer_item"], 0, NI - 1), NI - 1)
    mincov = jnp.full((W, NI), BIG, jnp.int32).at[
        _wid(W, NM), mi].min(jnp.where(width > 0, tot, BIG))
    mincov_qv = jnp.full((W, NI), BIG, jnp.int32).at[
        _wid(W, NM), mi].min(jnp.where(width > 0, mq_min, BIG))
    return mincov, mincov_qv


def compact_state(st, N, NI, Cmax, NCR, ECR):
    """Gather the post-compress survivors into a compact item/edge space.

    After compress #1 the graph has tens of live unitigs, but every
    later stage still paid gathers/scatters/sorts over the full
    [W, NI ~ 3.5k] axes — per-op overhead on those shapes was the
    measured devgraph wall (DESIGN.md round-5 profile). Regular items
    are packed (in item-id order) into slots [0, NCR); the fake
    source/sink anchors move to FIXED slots NCR+2c / NCR+2c+1 so the
    static anchor-slot arithmetic in the cycle gates and path cover
    keeps working with N=NCR. Edges pack into ECR rows. mer_item is
    remapped through the survivor map; mers of dead items get an empty
    donor interval (dead items never revive). Lanes whose live counts
    exceed the compact caps are flagged `over` and replay natively.

    Returns (compact_st, over [W]). Item axis NC = NCR + 2*Cmax; edge
    axis EC = ECR + 4*Cmax (anchor wiring rows live anywhere in the
    pack — only okey VALUES order them)."""
    W = st["alive"].shape[0]
    NC = NCR + 2 * Cmax
    EC = ECR + 4 * Cmax
    alive, special = st["alive"], st["special"]
    idx = jnp.broadcast_to(jnp.arange(NI, dtype=jnp.int32)[None], (W, NI))

    # --- old -> new item map -------------------------------------------
    reg = alive & ~special
    # pack regular items in id order: new slot = rank among regular alive
    pos = jnp.cumsum(reg.astype(jnp.int32), axis=1) - 1
    n_reg = reg.sum(axis=1)
    over = n_reg > NCR
    new_of = jnp.full((W, NI), -1, jnp.int32)
    new_of = jnp.where(reg, jnp.minimum(pos, NCR - 1), new_of)
    # anchors at fixed compact slots (alive or not)
    for c in range(Cmax):
        for j in range(2):
            new_of = new_of.at[:, N + 2 * c + j].set(NCR + 2 * c + j)

    # inverse: compact slot -> old item (dead slots -> NI sentinel);
    # non-regular rows scatter out of range (dropped) so they can never
    # collide with a real slot's write
    old_of = jnp.full((W, NC), NI, jnp.int32)
    old_of = old_of.at[
        _wid(W, NI), jnp.where(reg & (pos < NCR), pos, NC)].set(
        idx, mode="drop")
    # anchor slots (unconditional copies)
    for c in range(Cmax):
        for j in range(2):
            old_of = old_of.at[:, NCR + 2 * c + j].set(N + 2 * c + j)

    def g_item(a, fill):
        safe = jnp.clip(old_of, 0, NI - 1)
        v = jnp.take_along_axis(a, safe, 1)
        return jnp.where(old_of < NI, v, fill)

    out = dict(st)
    out["alive"] = g_item(alive, False)
    out["special"] = g_item(special, False)
    out["rank"] = g_item(st["rank"], BIG)
    out["merlen"] = g_item(st["merlen"], 0)
    out["n_t"] = g_item(st["n_t"], 0)
    out["is_tumor"] = g_item(st["is_tumor"], False)
    out["is_normal"] = g_item(st["is_normal"], False)
    if "comp" in st:
        out["comp"] = g_item(st["comp"], 0)
    safe3 = jnp.clip(old_of, 0, NI - 1)[:, :, None]
    csum_g = jnp.take_along_axis(
        st["csum"], jnp.broadcast_to(safe3, (W, NC, 4)), 1)
    out["csum"] = jnp.where((old_of < NI)[:, :, None], csum_g, 0)

    # --- edges ----------------------------------------------------------
    ea = st["e_alive"]
    epos = jnp.cumsum(ea.astype(jnp.int32), axis=1) - 1
    n_e = ea.sum(axis=1)
    over = over | (n_e > EC)
    EEo = ea.shape[1]
    eold_of = jnp.full((W, EC), EEo, jnp.int32)
    eidx = jnp.broadcast_to(jnp.arange(EEo, dtype=jnp.int32)[None], (W, EEo))
    eold_of = eold_of.at[
        _wid(W, EEo), jnp.where(ea & (epos < EC), epos, EC)].set(
        eidx, mode="drop")

    def g_edge(a, fill):
        safe = jnp.clip(eold_of, 0, EEo - 1)
        v = jnp.take_along_axis(a, safe, 1)
        return jnp.where(eold_of < EEo, v, fill)

    e_src_o = g_edge(st["e_src"], 0)
    e_dst_o = g_edge(st["e_dst"], 0)
    e_alive_c = eold_of < EEo
    # remap endpoints through new_of; an alive edge touching a dropped
    # item (pos >= NCR overflow) keeps -1 -> clip + lane already `over`
    ns = jnp.take_along_axis(new_of, jnp.clip(e_src_o, 0, NI - 1), 1)
    nd = jnp.take_along_axis(new_of, jnp.clip(e_dst_o, 0, NI - 1), 1)
    over = over | (e_alive_c & ((ns < 0) | (nd < 0))).any(axis=1)
    out["e_src"] = jnp.where(e_alive_c, jnp.clip(ns, 0, NC - 1), 0)
    out["e_dst"] = jnp.where(e_alive_c, jnp.clip(nd, 0, NC - 1), 0)
    out["e_dir"] = g_edge(st["e_dir"], 0)
    out["e_alive"] = e_alive_c
    out["e_okey"] = g_edge(st["e_okey"], BIG)

    # --- mers -----------------------------------------------------------
    mi = jnp.clip(st["mer_item"], 0, NI - 1)
    nm = jnp.take_along_axis(new_of, mi, 1)
    dead_mer = nm < 0
    out["mer_item"] = jnp.where(dead_mer, NCR, nm)  # anchor slot: inert
    out["keep_lo"] = st["keep_lo"]
    out["keep_hi"] = jnp.where(dead_mer, st["keep_lo"], st["keep_hi"])
    return out, over


def remove_items(st, removed):
    """Kill items + every edge touching them (remove_node semantics)."""
    e_src, e_dst = st["e_src"], st["e_dst"]
    NI = st["alive"].shape[1]
    gone = (jnp.take_along_axis(removed, jnp.clip(e_src, 0, NI - 1), 1)
            | jnp.take_along_axis(removed, jnp.clip(e_dst, 0, NI - 1), 1))
    out = dict(st)
    out["alive"] = st["alive"] & ~removed
    out["e_alive"] = st["e_alive"] & ~gone
    return out


def low_cov_pass(st, K, N, NI, low_cov_threshold, min_cov_ratio, avgcov):
    """removeLowCov(true, c) for every component at once
    (Graph.cc:2790-2827); coverage==1 tests use the exact rational
    csum/merlen instead of the float cascade."""
    mincov, mincov_qv = item_mincovs(st, K, N, NI)
    csum, merlen = st["csum"], st["merlen"]
    tot_t = csum[..., 0] + csum[..., 1]
    tot_n = csum[..., 2] + csum[..., 3]
    low = (st["alive"] & ~st["special"]
           & ((mincov_qv <= low_cov_threshold)
              | (mincov_qv.astype(jnp.float32)
                 <= min_cov_ratio * avgcov[:, None])
              | ((tot_t == merlen) & (tot_n == merlen) & (merlen > 0))))
    return remove_items(st, low), low.any(axis=1)


def _rank_slots(st, U):
    """Alive non-special items in map-rank order -> [W, U] (id or -1)."""
    alive = st["alive"] & ~st["special"]
    key = jnp.where(alive, st["rank"], BIG)
    order = jnp.argsort(key, axis=1)[:, :U]
    n = alive.sum(axis=1)
    slot_ok = jnp.arange(U, dtype=jnp.int32)[None, :] < n[:, None]
    return jnp.where(slot_ok, order, -1), n > U


def _nbr_table(st, NI, D2):
    """[W, NI, D2] alive-edge dst per item (any okey order — only used
    for degree decrements) + deg [W, NI] + overflow flag."""
    e_src, e_dst, e_alive = st["e_src"], st["e_dst"], st["e_alive"]
    W, EE = e_src.shape
    key = jnp.where(e_alive, e_src, BIG)
    eidx = jnp.broadcast_to(jnp.arange(EE, dtype=jnp.int32)[None], (W, EE))
    k1, perm = jax.lax.sort((key, eidx), num_keys=1, dimension=1,
                            is_stable=True)
    newrun = jnp.ones((W, EE), bool)
    newrun = newrun.at[:, 1:].set(k1[:, 1:] != k1[:, :-1])
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(newrun, eidx, 0), axis=1)
    slot = eidx - run_start
    ea = jnp.take_along_axis(e_alive, perm, 1)
    over = jnp.max(jnp.where(ea, slot + 1, 0), axis=1) > D2
    nbr = jnp.full((W, NI, D2), -1, jnp.int32)
    srcs = jnp.where(ea & (slot < D2), k1, NI)
    nbr = nbr.at[_wid(W, EE), srcs, jnp.minimum(slot, D2 - 1)].set(
        jnp.take_along_axis(e_dst, perm, 1), mode="drop")
    dg = jnp.zeros((W, NI + 1), jnp.int32).at[
        _wid(W, EE), jnp.where(e_alive, e_src, NI)].add(
        jnp.where(e_alive, 1, 0))[:, :NI]
    return nbr, dg, over


def _seq_removal_pass(st, cond_fn, U, D2):
    """One sequential map-rank-order sweep: remove items satisfying
    cond_fn(item_state, live_deg), updating neighbor degrees as the
    reference's in-place edge surgery does (removeTips/removeShortLinks
    iterate the live map). Returns (updated st, removed_any [W])."""
    NI = st["alive"].shape[1]
    W = st["alive"].shape[0]
    slots, over = _rank_slots(st, U)
    nbr, deg, over2 = _nbr_table(st, NI, D2)
    wrow = jnp.arange(W, dtype=jnp.int32)

    # sweep bound: the widest lane's live-slot count (the scan over a
    # fixed U=256 slots made every sweep pay the worst case; post-compress
    # graphs have tens of live unitigs, so this is the wall-time lever for
    # the sequential-order replay)
    n_slots = jnp.minimum((slots >= 0).sum(axis=1), U)
    max_slots = jnp.max(n_slots)

    def body(s):
        i, deg, removed = s
        it = slots[:, jnp.clip(i, 0, U - 1)]
        safe = jnp.clip(it, 0, NI - 1)
        on = (it >= 0) & ~jnp.take_along_axis(
            removed, safe[:, None], 1)[:, 0]
        d = jnp.take_along_axis(deg, safe[:, None], 1)[:, 0]
        kill = on & cond_fn(safe, d)
        # decrement neighbor degrees once per alive edge row — one
        # batched scatter-add over all D2 slots (the decrements commute)
        nb = nbr[wrow, safe, :]  # [W, D2]
        nbs = jnp.clip(nb, 0, NI - 1)
        ok = (kill[:, None] & (nb >= 0) & (nb != safe[:, None])
              & ~jnp.take_along_axis(removed, nbs, 1))
        deg = deg.at[wrow[:, None], jnp.where(ok, nb, NI - 1)].add(
            jnp.where(ok, -1, 0))
        removed = removed.at[wrow, safe].set(
            jnp.take_along_axis(removed, safe[:, None], 1)[:, 0] | kill)
        return i + 1, deg, removed

    _, deg, removed = jax.lax.while_loop(
        lambda s: s[0] < max_slots, body,
        (jnp.int32(0), deg, jnp.zeros((W, NI), bool)))
    removed_any = removed.any(axis=1)
    return remove_items(st, removed), removed_any, over | over2


# ---------------------------------------------------------------------------
# findTandems position probe (ref: util.cc:574-758) for the short-link
# STR guard: is position K-1 within dist_from_str of a reported tandem?
# ---------------------------------------------------------------------------

def tandem_at(seqs, lens, pos, max_unit_len, min_report_units,
              min_report_len, dist_from_str):
    """Exact findTandems replay asking only whether `pos` lies within
    dist_from_str of a reported tandem (ref: util.cc:574-758, mirrored
    by engine.seqs.find_tandems incl. the offset-(-1) sentinel quirk).

    seqs [B, L] int32 codes (invalid >= 4), lens [B], pos scalar.
    Sequential lax.scan over i — callers pass short strings (the
    short-link guard's candidates are < 1.5K bases)."""
    B, L = seqs.shape
    # index-unique codes for positions beyond lens so padding never
    # matches (ml <= 4 apart comparisons)
    posi = jnp.arange(L, dtype=jnp.int32)[None, :]
    eff = jnp.where(posi < lens[:, None], seqs.astype(jnp.int32),
                    100 + (posi % 50))

    def gb(i):
        """base at i ([B] or scalar), index-unique sentinels OOB."""
        i = jnp.broadcast_to(jnp.asarray(i, jnp.int32), (B,))
        ic = jnp.clip(i, 0, L - 1)
        v = jnp.take_along_axis(eff, ic[:, None], 1)[:, 0]
        return jnp.where((i >= 0) & (i < L), v, 300 + jnp.abs(i) % 97)

    # per-ml mismatch prefix sums: mis_ml[i] = (eff[i] != eff[i+ml])
    csm = {}
    for ml in range(1, max_unit_len):
        mis = jnp.ones((B, L), jnp.int32)
        mis = mis.at[:, : L - ml].set(
            (eff[:, : L - ml] != eff[:, ml:]).astype(jnp.int32))
        csm[ml] = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), jnp.cumsum(mis, axis=1)], axis=1)

    def mis_range(ml, a, b):
        """# of ml-mismatches over positions [a, b) (b<=a -> 0)."""
        aa = jnp.clip(a, 0, L)
        bb = jnp.clip(b, 0, L)
        s = jnp.take_along_axis(csm[ml], bb[:, None], 1)[:, 0] \
            - jnp.take_along_axis(csm[ml], aa[:, None], 1)[:, 0]
        return jnp.where(b > a, s, 0)

    offs0 = jnp.zeros((B, max_unit_len + 1, max_unit_len), jnp.int32)
    for m in range(1, max_unit_len + 1):
        for p in range(m):
            offs0 = offs0.at[:, m, p].set(p)

    def body(carry, i):
        offs, ans = carry
        for m in range(1, max_unit_len + 1):
            p = i % m
            offset = jax.lax.dynamic_index_in_dim(
                offs[:, m, :], p, axis=1, keepdims=False)
            j = jnp.zeros((B,), jnp.int32)
            still = jnp.ones((B,), bool)
            for jj in range(m):
                okj = (still & (i + jj < lens)
                       & (gb(i + jj) == gb(offset + jj)))
                j = j + okj.astype(jnp.int32)
                still = okj
            brk = (j != m) | (i + j + 1 == lens)
            left = gb(offset - 1)
            lastu = gb(offset + m - 1)
            report = brk & (left != lastu)
            units_ok = ((i - offset) // m >= min_report_units) \
                & ((i - offset) >= min_report_len)
            prim = jnp.ones((B,), bool)
            for ml in range(1, m):
                units = (i - offset + j) // ml
                periodic = mis_range(ml, offset,
                                     offset + units * ml - ml) == 0
                prim = prim & ~periodic
            hit = report & units_ok & prim & (i < lens)
            inrange = (pos >= offset - dist_from_str) \
                & (pos <= i + j + dist_from_str)
            ans = ans | (hit & inrange)
            # the offset table advances only on a break — `offset` is the
            # start of the current run (util.cc's update sits inside the
            # break branch)
            offs = offs.at[:, m].set(
                jax.lax.dynamic_update_index_in_dim(
                    offs[:, m, :],
                    jnp.where(brk & (i < lens), i, offset), p, axis=1))
        return (offs, ans), None

    (_, ans), _ = jax.lax.scan(
        body, (offs0, jnp.zeros((B,), bool)),
        jnp.arange(L, dtype=jnp.int32))
    return ans


# ---------------------------------------------------------------------------
# cycle gate (ref: Graph.cc:593-681) — exact lockstep DFS replay.
# The reference colors NODES (not node-direction states): a GREY hit in
# either orientation reports a cycle, and a BLACK node is skipped even
# when re-reached in the opposite direction, so the verdict depends on
# edge-list order and is not expressible as a reachability closure.
# ---------------------------------------------------------------------------

def okey_adjacency(e_src, e_dst, e_dir, e_alive, e_okey, NI, D2):
    """[W, NI, D2] edge ids per source in edge-list (okey) order."""
    W, EE = e_src.shape
    eidx = jnp.broadcast_to(jnp.arange(EE, dtype=jnp.int32)[None], (W, EE))
    # okey clamps cannot reorder within a source: real okeys < E <=
    # 10240 < _OKMAX-2 and only the two anchor sentinels sit above
    packed = _pack_src_okey(e_src, e_okey, e_alive, NI)
    k1p, perm = jax.lax.sort((packed, eidx), num_keys=1,
                             dimension=1, is_stable=True)
    k1 = k1p >> _OKB
    newrun = jnp.ones((W, EE), bool)
    newrun = newrun.at[:, 1:].set(k1[:, 1:] != k1[:, :-1])
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(newrun, eidx, 0), axis=1)
    slot = eidx - run_start
    ea = jnp.take_along_axis(e_alive, perm, 1)
    over = jnp.max(jnp.where(ea, slot + 1, 0), axis=1) > D2
    adj = jnp.full((W, NI, D2), -1, jnp.int32)
    adj = adj.at[_wid(W, EE), jnp.where(ea & (slot < D2), k1, NI),
                 jnp.minimum(slot, D2 - 1)].set(perm, mode="drop")
    return adj, over


def cycle_screen(e_src, e_dst, e_dir, e_alive, alive, special, comp,
                 N, NI, Cmax, T=32):
    """Conservative parallel screen for the quirky node-colored cycle
    DFS: returns may_cycle [W, Cmax] — False is a PROOF that
    has_cycle_seq would report no cycle for that component, True routes
    the component to the exact sequential replay.

    The quirky DFS (ref Graph.cc hasCycleRec: node colors, not
    node-direction states) can flag a "cycle" in two ways only: a GREY
    hit via a genuine directed cycle in the (node, dir) walk digraph, or
    a GREY/colored hit on a node reached in BOTH orientations. So a
    component is provably clean when (a) its reachable walk digraph is
    acyclic — shown by a Kahn peel that fully drains in <= T layers —
    and (b) no non-special node is reachable in both orientations.
    Everything else (true cycles, palindromic dual-orientation reach,
    peel/reach not converged within T) is flagged. All checks are
    parallel fixpoints over the full edge list — no sequential walk."""
    W, EE = e_src.shape
    NS = 2 * NI
    wrow = jnp.arange(W, dtype=jnp.int32)[:, None]
    sb = startbit(e_dir).astype(jnp.int32)
    db = destbit(e_dir).astype(jnp.int32)
    srcs = jnp.clip(e_src, 0, NI - 1)
    dsts = jnp.clip(e_dst, 0, NI - 1)
    # walk edges (u, startbit) -> (v, destbit); the DFS never enters
    # special dsts, so those edges don't exist in the walk digraph
    eact = (e_alive & jnp.take_along_axis(alive, srcs, 1)
            & jnp.take_along_axis(alive, dsts, 1)
            & ~jnp.take_along_axis(special, dsts, 1))
    s_state = srcs * 2 + sb
    d_state = dsts * 2 + db

    # --- reachability from the source anchors (both orientations) ------
    reach = jnp.zeros((W, NS), bool)
    for c in range(Cmax):  # static Cmax roots
        item = N + 2 * c
        on = alive[:, item]
        reach = reach.at[:, 2 * item].max(on)
        reach = reach.at[:, 2 * item + 1].max(on)

    def relax(s):
        i, reach, changed = s
        m = jnp.take_along_axis(reach, s_state, 1) & eact
        new = reach.at[wrow, d_state].max(m)
        return i + 1, new, jnp.any(new != reach, axis=1)

    _, reach, r_unconv = jax.lax.while_loop(
        lambda s: (s[0] < T) & jnp.any(s[2]), relax,
        (jnp.int32(0), reach, jnp.ones((W,), bool)))

    # --- Kahn peel of the non-special walk digraph ---------------------
    # Edges OUT of special sources (the fake anchors) are excluded: a
    # special is never entered, so it can't sit on a cycle — and since
    # specials are not in `live` they would never peel, leaving the
    # anchor's indegree pinned >= 1 and the whole reachable component
    # "leftover" (that bug flagged every anchored lane, routing 100% of
    # windows to the sequential DFS replay).
    nonspec = ~jnp.repeat(special, 2, axis=1)
    live = nonspec & jnp.repeat(alive, 2, axis=1)
    eact_p = eact & ~jnp.take_along_axis(special, srcs, 1)
    indeg = jnp.zeros((W, NS), jnp.int32).at[wrow, d_state].add(
        eact_p.astype(jnp.int32))

    def peel(s):
        i, live, indeg, changed = s
        f = live & (indeg == 0)
        fsrc = jnp.take_along_axis(f, s_state, 1) & eact_p
        indeg = indeg.at[wrow, d_state].add(-fsrc.astype(jnp.int32))
        return i + 1, live & ~f, indeg, jnp.any(f)

    _, leftover, _, _ = jax.lax.while_loop(
        lambda s: (s[0] < T) & s[3], peel,
        (jnp.int32(0), live, indeg, jnp.bool_(True)))

    # --- flag states: un-peeled reachable, or dual-orientation reach ---
    reach2 = reach.reshape(W, NI, 2)
    dual = (reach2[:, :, 0] & reach2[:, :, 1]
            & alive & ~special)  # [W, NI]
    left_item = (leftover & reach).reshape(W, NI, 2).any(axis=2)
    flag_item = (left_item | dual) & alive & ~special
    flag_item = flag_item | r_unconv[..., None]  # reach under-approx

    # per-comp reduction via the component labels
    may = jnp.zeros((W, Cmax + 2), bool).at[
        _wid(W, NI), jnp.clip(comp, 0, Cmax + 1)].max(
        flag_item & (comp > 0))
    return may[:, 1 : Cmax + 1]


def has_cycle_seq(e_src, e_dst, e_dir, e_alive, e_okey, alive, special,
                  N, NI, Cmax, D2=16, lane_mask=None):
    """Per-comp cycle flags [W, Cmax] via an exact replay of
    hasCycleRec's iterative DFS (engine.graph._cycle_dfs): two rooted
    searches (source, F) then (source, R) sharing node colors, GREY-hit
    in any orientation = cycle, specials skipped. Lanes walk their
    components sequentially; all lanes run lockstep."""
    W = alive.shape[0]
    EE = e_src.shape[1]
    adj, over_d = okey_adjacency(e_src, e_dst, e_dir, e_alive, e_okey,
                                 NI, D2)
    sb_all = startbit(e_dir).astype(jnp.int32)
    db_all = destbit(e_dir).astype(jnp.int32)
    wrow = jnp.arange(W, dtype=jnp.int32)
    SD = NI + 2  # stack bound: each node pushed at most once per call

    flags = []
    for c in range(Cmax):
        src_item = N + 2 * c
        active0 = alive[:, src_item]
        if lane_mask is not None:
            # cycle_screen proved these comps DFS-clean: their lanes sit
            # out (the lockstep walk costs max-over-lanes, so a fully
            # screened batch pays ~zero iterations)
            active0 = active0 & lane_mask[:, c]

        def one_call(d0, color):
            """one _cycle_dfs(source, d0) call; returns (cyc, color)."""
            s_node = jnp.zeros((W, SD), jnp.int32).at[:, 0].set(src_item)
            s_dir = jnp.full((W, SD), d0, jnp.int32)
            s_ei = jnp.zeros((W, SD), jnp.int32)
            sp = jnp.where(active0, 1, 0)
            color = color.at[:, src_item].set(
                jnp.where(active0, 1, color[:, src_item]))
            cyc = jnp.zeros((W,), bool)

            def cond(s):
                s_node, s_dir, s_ei, sp, color, cyc = s
                return jnp.any((sp > 0) & ~cyc)

            def body(s):
                s_node, s_dir, s_ei, sp, color, cyc = s
                act = (sp > 0) & ~cyc
                tp = jnp.clip(sp - 1, 0, SD - 1)
                nd = s_node[wrow, tp]
                dr = s_dir[wrow, tp]
                ei = s_ei[wrow, tp]
                nds = jnp.clip(nd, 0, NI - 1)
                e = adj[wrow, nds, jnp.clip(ei, 0, D2 - 1)]
                exhausted = act & ((ei >= D2) | (e < 0))
                # pop: node -> BLACK
                color = color.at[wrow, nds].set(
                    jnp.where(exhausted, 2, color[wrow, nds]))
                sp = sp - exhausted
                step = act & ~exhausted
                s_ei = s_ei.at[wrow, tp].set(
                    jnp.where(step, ei + 1, s_ei[wrow, tp]))
                es = jnp.clip(e, 0, EE - 1)
                match = step & (sb_all[wrow, es] == dr)
                v = e_dst[wrow, es]
                vs = jnp.clip(v, 0, NI - 1)
                vspec = special[wrow, vs]
                probe = match & ~vspec
                vcol = color[wrow, vs]
                cyc = cyc | (probe & (vcol == 1))
                push = probe & (vcol == 0) & ~cyc
                color = color.at[wrow, vs].set(
                    jnp.where(push, 1, color[wrow, vs]))
                ns = jnp.clip(sp, 0, SD - 1)
                s_node = s_node.at[wrow, ns].set(
                    jnp.where(push, v, s_node[wrow, ns]))
                s_dir = s_dir.at[wrow, ns].set(
                    jnp.where(push, db_all[wrow, es], s_dir[wrow, ns]))
                s_ei = s_ei.at[wrow, ns].set(
                    jnp.where(push, 0, s_ei[wrow, ns]))
                sp = sp + push
                return (s_node, s_dir, s_ei, sp, color, cyc)

            s = (s_node, s_dir, s_ei, sp, color, cyc)
            s = jax.lax.while_loop(cond, body, s)
            return s[5], s[4]

        # colors init once per has_cycle call (both sub-searches share)
        color0 = jnp.zeros((W, NI), jnp.int8).astype(jnp.int32)
        cyc_f, color1 = one_call(0, color0)
        cyc_r, _ = one_call(1, color1)
        flags.append((cyc_f | cyc_r) & active0)
    return jnp.stack(flags, axis=1), over_d

def compress_round(st, K, NI, N, Dcap=64):
    """One graph-wide compression pass (ref: Graph.cc:2486-2732): merge
    every mutual-buddy chain into its lowest-map-rank member (the node
    the reference's iteration reaches first), rewiring edges with the
    orientation algebra and appending the terminals' outward edges in
    F-side-then-R-side order; per-mer donor intervals lose K-1 entries
    at each junction on the absorbed side.

    `st` holds item/edge/mer arrays (see module docstring); returns the
    updated dict plus a per-window fallback flag (mutual-buddy cycles
    and mid-compress self-loop formation, which the sequential reference
    handles with its tandem guard — rare; the native engine replays
    them)."""
    alive, special = st["alive"], st["special"]
    rank, comp = st["rank"], st["comp"]
    e_src, e_dst = st["e_src"], st["e_dst"]
    e_dir, e_alive, e_okey = st["e_dir"], st["e_alive"], st["e_okey"]
    W = alive.shape[0]
    idx = jnp.broadcast_to(jnp.arange(NI, dtype=jnp.int32)[None], (W, NI))

    e_okey = edge_renorm(e_src, e_okey, e_alive, NI)
    lnk = links(e_src, e_dst, e_dir, e_alive, e_okey, alive, special, NI)
    end_state, dist, chain_cyc = chain_jump(lnk, NI)
    fallback = chain_cyc

    endF = end_state.reshape(W, NI, 2)[:, :, 0] // 2
    endR = end_state.reshape(W, NI, 2)[:, :, 1] // 2
    distF = dist.reshape(W, NI, 2)[:, :, 0]
    distR = dist.reshape(W, NI, 2)[:, :, 1]
    label = jnp.minimum(endF, endR)
    t_hi = jnp.maximum(endF, endR)
    a_u = jnp.where(endF == t_hi, 0, 1)  # facing along walk t_lo -> t_hi
    a_u = jnp.where(endF == endR, 0, a_u)
    d_lo = jnp.where(endF == t_hi, distR, distF)

    # survivor = min map-rank member of the chain. Ranks are capped to N
    # (real node ranks < n_nodes <= N; specials carry a big sentinel that
    # would overflow rank*NI — they are always singleton chains, so the
    # cap cannot change a survivor choice).
    rk = jnp.minimum(rank, N)
    combo = jnp.where(alive, rk * NI + idx, BIG)
    cmin = jnp.full((W, NI), BIG, jnp.int32).at[
        _wid(W, NI), jnp.clip(label, 0, NI - 1)].min(combo)
    s_item = jnp.take_along_axis(
        cmin, jnp.clip(label, 0, NI - 1), 1) % NI
    s_item = jnp.where(alive, s_item, idx)
    a_s = jnp.take_along_axis(a_u, jnp.clip(s_item, 0, NI - 1), 1)
    flip = ((a_u ^ a_s) == 1) & alive  # member orientation vs survivor

    chain_items = jnp.zeros((W, NI), jnp.int32).at[
        _wid(W, NI), jnp.clip(label, 0, NI - 1)].max(
        jnp.where(alive, d_lo + 1, 0))
    n_items = jnp.take_along_axis(
        chain_items, jnp.clip(label, 0, NI - 1), 1)
    pos_u = jnp.where(a_s == 0, d_lo, n_items - 1 - d_lo)
    pos_s = jnp.take_along_axis(pos_u, jnp.clip(s_item, 0, NI - 1), 1)

    # mer-offset of each item within its new unitig: sort items by
    # (label, pos_u), run-prefix-sum merlen
    merlen = st["merlen"]
    iidx = jnp.broadcast_to(jnp.arange(NI, dtype=jnp.int32)[None], (W, NI))
    # single packed key (label, pos_u): label < NI <= 4112 and pos_u
    # saturates at DCAP <= NI+8 < 8192, so label*8192+pos_u < 2^31
    ipk = jnp.where(alive, (label << 13) | jnp.minimum(pos_u, 8191),
                    NI << 13)
    k1, perm = jax.lax.sort((ipk, iidx), num_keys=1, dimension=1,
                            is_stable=False)
    k1 = k1 >> 13
    ml_sorted = jnp.take_along_axis(merlen, perm, 1)
    csum_ml = jnp.cumsum(ml_sorted, axis=1)
    newrun = jnp.ones((W, NI), bool)
    newrun = newrun.at[:, 1:].set(k1[:, 1:] != k1[:, :-1])
    run_base = jax.lax.associative_scan(
        jnp.maximum, jnp.where(newrun, csum_ml - ml_sorted, 0), axis=1)
    start_sorted = csum_ml - ml_sorted - run_base
    start_off = jnp.zeros((W, NI), jnp.int32).at[
        _wid(W, NI), perm].set(start_sorted)

    # ---- mer-level composition ----------------------------------------
    mer_item = st["mer_item"]
    mi = jnp.clip(mer_item, 0, NI - 1)
    u_flip = jnp.take_along_axis(flip, mi, 1)
    u_start = jnp.take_along_axis(start_off, mi, 1)
    u_ml = jnp.take_along_axis(merlen, mi, 1)
    mer_pos = st["mer_pos"]
    new_pos = u_start + jnp.where(u_flip, u_ml - 1 - mer_pos, mer_pos)
    new_flip = st["mer_flip"] ^ u_flip
    klo, khi = st["keep_lo"], st["keep_hi"]
    klo2 = jnp.where(u_flip, K - khi, klo)
    khi2 = jnp.where(u_flip, K - klo, khi)

    # junction trims: non-survivor members lose K-1 donor entries at
    # their survivor-facing end (low side if the member sits after the
    # survivor, else high side), in new-unitig coords
    u_sitem = jnp.take_along_axis(s_item, mi, 1)
    u_pos = jnp.take_along_axis(pos_u, mi, 1)
    u_spos = jnp.take_along_axis(pos_s, mi, 1)
    is_member = (u_sitem != mi)  # mer belongs to an absorbed item
    facing_low = u_pos > u_spos
    width = (khi2 - klo2).astype(jnp.int32)
    # per-member donor prefix in new coords: sort mers by (item, new_pos)
    NM = mer_item.shape[1]
    midx = jnp.broadcast_to(jnp.arange(NM, dtype=jnp.int32)[None], (W, NM))
    # packed (item, new_pos): mi < NI <= 4112, new_pos < N <= 4096
    mpk = jnp.where(is_member,
                    (mi << 13) | jnp.minimum(new_pos, 8191), NI << 13)
    mk1, mperm = jax.lax.sort((mpk, midx), num_keys=1, dimension=1,
                              is_stable=False)
    mk1 = mk1 >> 13
    wsort = jnp.take_along_axis(width, mperm, 1)
    cw = jnp.cumsum(wsort, axis=1)
    mnew = jnp.ones((W, NM), bool)
    mnew = mnew.at[:, 1:].set(mk1[:, 1:] != mk1[:, :-1])
    mbase = jax.lax.associative_scan(
        jnp.maximum, jnp.where(mnew, cw - wsort, 0), axis=1)
    before_sorted = cw - wsort - mbase
    # member total widths
    mtot = jnp.zeros((W, NI), jnp.int32).at[
        _wid(W, NM), jnp.where(is_member, mi, NI - 1)].add(
        jnp.where(is_member, width, 0))
    before = jnp.zeros((W, NM), jnp.int32).at[
        _wid(W, NM), mperm].set(before_sorted)
    after = jnp.take_along_axis(mtot, mi, 1) - before - width
    cut_lo = jnp.clip(K - 1 - before, 0, width)
    cut_hi = jnp.clip(K - 1 - after, 0, width)
    klo3 = jnp.where(is_member & facing_low, klo2 + cut_lo, klo2)
    khi3 = jnp.where(is_member & ~facing_low, khi2 - cut_hi, khi2)

    # ---- edge updates --------------------------------------------------
    lv = lnk["lnk_valid"].reshape(W, NI * 2)
    sb = startbit(e_dir).astype(jnp.int32)
    db = destbit(e_dir).astype(jnp.int32)
    consumed = e_alive & jnp.take_along_axis(
        lv, jnp.clip(e_src * 2 + sb, 0, NI * 2 - 1), 1)
    es = jnp.clip(e_src, 0, NI - 1)
    ed = jnp.clip(e_dst, 0, NI - 1)
    fsrc = jnp.take_along_axis(flip, es, 1)
    fdst = jnp.take_along_axis(flip, ed, 1)
    nsb = sb ^ fsrc.astype(jnp.int32)
    ndb = db ^ fdst.astype(jnp.int32)
    nsrc = jnp.take_along_axis(s_item, es, 1)
    ndst = jnp.take_along_axis(s_item, ed, 1)
    ne_alive = e_alive & ~consumed
    loopback = ne_alive & (nsrc == ndst) & (e_src != e_dst)
    fallback = fallback | loopback.any(axis=1)
    moved = ne_alive & (nsrc != e_src)
    side_F = jnp.take_along_axis(pos_u, es, 1) > jnp.take_along_axis(
        pos_s, es, 1)
    nokey = jnp.where(moved,
                      Dcap * jnp.where(side_F, 1, 2) + e_okey, e_okey)

    # ---- item aggregate updates ---------------------------------------
    # all 8 per-item aggregates ride ONE multi-lane scatter-add + ONE
    # gather (separate scatters were ~1/3 of compress cost)
    lab = jnp.clip(label, 0, NI - 1)
    n_alive = alive & (s_item == idx)
    csum = st["csum"]
    vals = jnp.concatenate(
        [merlen[..., None], csum, st["n_t"][..., None],
         st["is_tumor"].astype(jnp.int32)[..., None],
         st["is_normal"].astype(jnp.int32)[..., None]], axis=-1)  # [W,NI,8]
    acc = jnp.zeros((W, NI, 8), jnp.int32).at[
        _wid(W, NI), jnp.where(alive, lab, NI - 1)].add(
        jnp.where(alive[..., None], vals, 0))
    summed = jnp.take_along_axis(
        acc, jnp.broadcast_to(lab[..., None], (W, NI, 8)), 1)
    new_merlen = jnp.where(n_alive, summed[..., 0], 0)
    new_csum = jnp.where(n_alive[..., None], summed[..., 1:5], 0)
    new_nt = jnp.where(n_alive, summed[..., 5], 0)
    new_tum = jnp.where(n_alive, summed[..., 6] > 0, False)
    new_nrm = jnp.where(n_alive, summed[..., 7] > 0, False)

    out = dict(st)
    out.update(
        alive=n_alive, merlen=new_merlen, csum=new_csum, n_t=new_nt,
        is_tumor=new_tum, is_normal=new_nrm,
        e_src=jnp.where(ne_alive, nsrc, 0),
        e_dst=jnp.where(ne_alive, ndst, 0),
        e_dir=jnp.where(ne_alive, nsb * 2 + ndb, 0).astype(jnp.int8),
        e_alive=ne_alive, e_okey=nokey,
        mer_item=jnp.take_along_axis(s_item, mi, 1),
        mer_flip=new_flip, mer_pos=new_pos,
        keep_lo=klo3, keep_hi=khi3)
    return out, fallback
