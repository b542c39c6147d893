"""Batched anti-diagonal (wavefront) Gotoh alignment on device.

Same recurrence, tie-breaking, and traceback semantics as the oracle
(`engine.align`, itself fuzz-verified bit-exact against the reference's
align.cc). The DP fills on device as a `lax.scan` over anti-diagonals with
the pair axis vectorized; the packed traceback planes stay on device in
diagonal layout and the O(n+m) traceback runs there too, so only the
per-pair op strings come back to the host. The arithmetic is int32 end
to end, so results are exact on every backend.

Parity with the oracle is asserted in tests/test_device_align.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..engine.align import GAP_EXTEND, GAP_OPEN, MATCH, MISMATCH

# traceback codes (match engine.align)
_STAR, _DIAG, _LEFT, _UP, _XEXT, _YEXT = 0, 1, 2, 3, 4, 5


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.partial(jax.jit, static_argnums=(4, 5))
def _dp_fill(S, T, n_len, m_len, N, M):
    """S:[P,N+1] uint8 (1-indexed), T:[P,M+1] uint8.
    Returns packed tb planes [D, P, N+1] uint8 where D = N+M-1 holds
    diagonals d=2..N+M; tb[i] at diag d corresponds to cell (i, d-i)."""
    P = S.shape[0]
    idx = jnp.arange(N + 1)

    # reversed T for diagonal gathers: TR[p, x] = T[p, M - x]; padded so
    # dynamic slices never clamp
    TR = jnp.concatenate([T[:, ::-1], jnp.zeros((P, N + 1), T.dtype)], axis=1)

    go = jnp.int32(GAP_OPEN)
    ge = jnp.int32(GAP_EXTEND)

    def boundary(d):
        return go + jnp.int32(d) * ge

    # diag d=1 state
    M1 = jnp.where(idx[None, :] <= 1, boundary(1), 0).astype(jnp.int32) * jnp.ones((P, 1), jnp.int32)
    X1 = jnp.where(idx[None, :] == 0, boundary(1), 0).astype(jnp.int32) * jnp.ones((P, 1), jnp.int32)
    Y1 = jnp.where(idx[None, :] == 1, boundary(1), 0).astype(jnp.int32) * jnp.ones((P, 1), jnp.int32)
    M0 = jnp.zeros((P, N + 1), jnp.int32)  # diag d=0: M[0][0]=0

    def step(carry, d):
        Mp, Xp, Yp, Mp2 = carry
        # shift by one: value at index i-1
        Mp_s = jnp.roll(Mp, 1, axis=1)
        Xp_s = jnp.roll(Xp, 1, axis=1)
        Mp2_s = jnp.roll(Mp2, 1, axis=1)

        # X (vertical, consumes S): tie -> open (_LEFT)
        ext = Xp_s + ge
        opn = Mp_s + go
        xgt = ext > opn
        Xc = jnp.where(xgt, ext, opn)
        xtb = xgt  # True = extend

        # Y (horizontal, consumes T): tie -> open (_UP)
        exty = Yp + ge
        opny = Mp + go
        ygt = exty > opny
        Yc = jnp.where(ygt, exty, opny)
        ytb = ygt

        # T char at j = d - i  ->  TR[p, M - d + i]
        start = jnp.maximum(M - d, 0)
        tc = jax.lax.dynamic_slice_in_dim(TR, start, N + 1, axis=1)
        # when M - d < 0 the start was clamped at 0; realign with roll
        # (wrapped lanes land in the invalid i<d-M region)
        shift = jnp.maximum(d - M, 0)
        tc = jnp.roll(tc, shift, axis=1)
        sc = S  # S char at i (1-indexed)
        sub = jnp.where(sc == tc, jnp.int32(MATCH), jnp.int32(MISMATCH))
        diagv = Mp2_s + sub

        best = diagv
        mtb = jnp.full((P, N + 1), _DIAG, jnp.uint8)
        xw = Xc > best
        best = jnp.where(xw, Xc, best)
        mtb = jnp.where(xw, jnp.uint8(_LEFT), mtb)
        yw = Yc > best
        best = jnp.where(yw, Yc, best)
        mtb = jnp.where(yw, jnp.uint8(_UP), mtb)
        Mc = best

        # boundary overwrites: i==0 (cell (0,d)) and i==d (cell (d,0))
        b = boundary(d)
        is0 = idx[None, :] == 0
        isd = idx[None, :] == d
        Mc = jnp.where(is0 | isd, b, Mc)
        Xc = jnp.where(is0, b, Xc)
        Yc = jnp.where(isd, b, Yc)

        tb = (mtb | (xtb.astype(jnp.uint8) << 2) | (ytb.astype(jnp.uint8) << 3))
        return (Mc, Xc, Yc, Mp), tb

    ds = jnp.arange(2, N + M + 1)
    _, tbs = jax.lax.scan(step, (M1, X1, Y1, M0), ds)
    return tbs


# traceback op codes
_OP_DIAG, _OP_SGAP, _OP_TGAP = 1, 2, 3


@functools.partial(jax.jit, static_argnums=(4, 5))
def _dp_and_traceback(S, T, n_len, m_len, N, M):
    """DP fill + on-device traceback. Returns (ops[P, N+M], count[P])
    where ops are emitted back-to-front (host reverses). Keeping the
    traceback on device avoids shipping the O(n*m) tb planes over the
    host link — only O(n+m) ops come back."""
    tbs = _dp_fill(S, T, n_len, m_len, N, M)  # [D, P, N+1]
    D = tbs.shape[0]
    LMAX = N + M
    Pn = S.shape[0]

    def step(st, _):
        i, j, fx, fy, k = st
        # gather tb byte per pair: tbs[clip(i+j-2), p, clip(i)]
        drow = jnp.clip(i + j - 2, 0, D - 1)
        icol = jnp.clip(i, 0, N)
        tb = tbs[drow, jnp.arange(Pn), icol]
        mtb = tb & 3
        xext = ((tb >> 2) & 1).astype(bool)
        yext = ((tb >> 3) & 1).astype(bool)
        done = (i == 0) & (j == 0)
        is_i0 = (i == 0) & ~done
        is_j0 = (~(i == 0)) & (j == 0)
        inner = (i > 0) & (j > 0)
        use_fx = inner & fx
        use_left = inner & (~fx) & (mtb == _LEFT)
        use_fy = inner & (~fx) & (mtb != _LEFT) & fy
        use_up = inner & (~fx) & (~fy) & (mtb != _LEFT) & (mtb == _UP)
        use_diag = inner & (~use_fx) & (~use_left) & (~use_fy) & (~use_up)
        sgap = is_j0 | use_fx | use_left
        tgap = is_i0 | use_fy | use_up
        op = jnp.where(done, 0,
                       jnp.where(use_diag, _OP_DIAG,
                                 jnp.where(sgap, _OP_SGAP, _OP_TGAP)))
        di = (sgap | use_diag).astype(jnp.int32)
        dj = (tgap | use_diag).astype(jnp.int32)
        fx_new = jnp.where(use_fx | use_left, xext, fx)
        fy_new = jnp.where(use_fy | use_up, yext, fy)
        k_new = jnp.where(done, k, k + 1)
        return (i - di, j - dj, fx_new, fy_new, k_new), op.astype(jnp.uint8)

    st0 = (n_len, m_len, jnp.zeros((Pn,), bool), jnp.zeros((Pn,), bool),
           jnp.zeros((Pn,), jnp.int32))
    (ii, jj, _, _, k), ops = jax.lax.scan(step, st0, None, length=LMAX)
    return jnp.moveaxis(ops, 0, 1), k  # [P, LMAX], [P]


def _decode(ops_rev: np.ndarray, k: int, S: str, T: str) -> tuple[str, str]:
    """Rebuild aligned strings from back-to-front op codes."""
    ops = ops_rev[:k][::-1]
    s_take = ops != _OP_TGAP
    t_take = ops != _OP_SGAP
    s_idx = np.cumsum(s_take) - 1
    t_idx = np.cumsum(t_take) - 1
    Sa = np.frombuffer(S.encode("latin-1"), np.uint8)
    Ta = np.frombuffer(T.encode("latin-1"), np.uint8)
    dash = np.uint8(ord("-"))
    s_chars = np.where(s_take, Sa[np.clip(s_idx, 0, max(len(S) - 1, 0))], dash)
    t_chars = np.where(t_take, Ta[np.clip(t_idx, 0, max(len(T) - 1, 0))], dash)
    return (s_chars.tobytes().decode("latin-1"),
            t_chars.tobytes().decode("latin-1"))


def pack_pairs(pairs: list[tuple[str, str]], multiple: int = 1):
    """Pad [(S, T), ...] into the DP's shape buckets: (S, T, n_len, m_len,
    N, M) with S/T 1-indexed uint8 rows. Lengths round up to 128
    multiples (few distinct executables, little padded DP area; pow2
    buckets nearly double the work at ~1100 bp), the pair axis to a
    power of two that `multiple` divides (a mesh's device count)."""
    P = len(pairs)
    N = _round_up(max(128, max(len(s) for s, _ in pairs)), 128)
    M = _round_up(max(128, max(len(t) for _, t in pairs)), 128)
    P_pad = 1 << max(3, (P - 1).bit_length())
    while P_pad % multiple:
        P_pad <<= 1
    S = np.zeros((P_pad, N + 1), dtype=np.uint8)
    T = np.zeros((P_pad, M + 1), dtype=np.uint8)
    n_len = np.zeros(P_pad, np.int32)
    m_len = np.zeros(P_pad, np.int32)
    for p, (s, t) in enumerate(pairs):
        S[p, 1 : len(s) + 1] = np.frombuffer(s.encode("latin-1"), np.uint8)
        T[p, 1 : len(t) + 1] = np.frombuffer(t.encode("latin-1"), np.uint8)
        n_len[p] = len(s)
        m_len[p] = len(t)
    for a in (S, T, n_len, m_len):  # pad rows repeat the last pair
        a[P:] = a[P - 1]
    return S, T, n_len, m_len, N, M


def batch_align_async(pairs: list[tuple[str, str]]):
    """Dispatch the device DP for [(S, T), ...] without blocking (jax async
    dispatch): returns an opaque state for batch_align_wait. Lets callers
    overlap device alignment with host work."""
    if not pairs:
        return None
    S, T, n_len, m_len, N, M = pack_pairs(pairs)
    ops, counts = _dp_and_traceback(jnp.asarray(S), jnp.asarray(T),
                                    jnp.asarray(n_len), jnp.asarray(m_len),
                                    N, M)
    # enqueue the D2H copies now (they start as soon as the computation
    # finishes) so batch_align_wait finds the bytes already on host
    ops.copy_to_host_async()
    counts.copy_to_host_async()
    return ops, counts, pairs


def batch_align_wait(state) -> list[tuple[str, str]]:
    """Block on a batch_align_async dispatch and decode the alignments."""
    if state is None:
        return []
    ops, counts, pairs = state
    ops = np.asarray(ops)
    counts = np.asarray(counts)
    return [_decode(ops[p], int(counts[p]), s, t)
            for p, (s, t) in enumerate(pairs)]


def batch_align(pairs: list[tuple[str, str]]) -> list[tuple[str, str]]:
    """Align [(S, T), ...] with global affine Gotoh; returns aligned string
    pairs identical to engine.align.global_align_aff."""
    return batch_align_wait(batch_align_async(pairs))
