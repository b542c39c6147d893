"""Affine-gap global alignment, Gotoh three-matrix M/X/Y
(ref: src/align.cc:235-364 `global_align_aff`).

Scores MATCH=2 MISMATCH=-4 GAP_OPEN=-8 GAP_EXTEND=-1 (align.cc:28-31); a gap
of length L costs GAP_OPEN + (L-1)*GAP_EXTEND. Tie-breaking and the
forced-gap traceback replicate the reference exactly (this defines indel
placement, hence variant positions). Host oracle is a numpy anti-diagonal
wavefront; the device engine runs the same recurrence batched over pairs
(device.align_batch).
"""

from __future__ import annotations

import numpy as np

MATCH = 2
MISMATCH = -4
GAP_OPEN = -8
GAP_EXTEND = -1

# traceback codes
_STAR, _DIAG, _LEFT, _UP, _XEXT, _YEXT = 0, 1, 2, 3, 4, 5
# '*'    '\\'   '<'    '^'    '-'    '|'


def global_align_aff(S: str, T: str, endfree: bool = False) -> tuple[str, str]:
    """Return (S_aln, T_aln) with '-' gap characters."""
    n = len(S)
    m = len(T)
    NEG = np.int32(-(10**8))

    M = np.zeros((n + 2, m + 2), dtype=np.int32)
    X = np.zeros((n + 2, m + 2), dtype=np.int32)
    Y = np.zeros((n + 2, m + 2), dtype=np.int32)
    Mtb = np.zeros((n + 2, m + 2), dtype=np.int8)
    Xtb = np.zeros((n + 2, m + 2), dtype=np.int8)
    Ytb = np.zeros((n + 2, m + 2), dtype=np.int8)

    j0 = np.arange(m + 1)
    X[0, : m + 1] = GAP_OPEN + j0 * GAP_EXTEND
    Xtb[0, : m + 1] = _UP
    M[0, : m + 1] = X[0, : m + 1]
    Mtb[0, : m + 1] = _UP
    i0 = np.arange(n + 1)
    Y[: n + 1, 0] = GAP_OPEN + i0 * GAP_EXTEND
    Ytb[: n + 1, 0] = _LEFT
    M[: n + 1, 0] = Y[: n + 1, 0]
    Mtb[: n + 1, 0] = _LEFT
    M[0, 0] = 0
    Mtb[0, 0] = _STAR

    Sa = np.frombuffer(S.encode("latin-1"), dtype=np.uint8)
    Ta = np.frombuffer(T.encode("latin-1"), dtype=np.uint8)

    for d in range(2, n + m + 1):
        lo = max(1, d - m)
        hi = min(n, d - 1)
        if lo > hi:
            continue
        ii = np.arange(lo, hi + 1)
        jj = d - ii
        # X: vertical gap (consumes S) — tie goes to open '<' (align.cc:85-89)
        ext = X[ii - 1, jj] + GAP_EXTEND
        opn = M[ii - 1, jj] + GAP_OPEN
        xgt = ext > opn
        X[ii, jj] = np.where(xgt, ext, opn)
        Xtb[ii, jj] = np.where(xgt, _XEXT, _LEFT)
        # Y: horizontal gap (consumes T) — tie goes to open '^' (align.cc:91-95)
        exty = Y[ii, jj - 1] + GAP_EXTEND
        opny = M[ii, jj - 1] + GAP_OPEN
        ygt = exty > opny
        Y[ii, jj] = np.where(ygt, exty, opny)
        Ytb[ii, jj] = np.where(ygt, _YEXT, _UP)
        # M: diag default; strict > for X then Y (align.cc:97-105)
        sub = np.where(Sa[ii - 1] == Ta[jj - 1], MATCH, MISMATCH)
        diag = M[ii - 1, jj - 1] + sub
        best = diag
        tb = np.full(ii.shape, _DIAG, dtype=np.int8)
        xw = X[ii, jj] > best
        best = np.where(xw, X[ii, jj], best)
        tb = np.where(xw, _LEFT, tb)
        yw = Y[ii, jj] > best
        best = np.where(yw, Y[ii, jj], best)
        tb = np.where(yw, _UP, tb)
        M[ii, jj] = best
        Mtb[ii, jj] = tb

    # traceback (ref: align.cc:287-336)
    i, j = n, m
    if endfree:
        maxval = M[0, m]
        i = 0
        for q in range(n):
            if M[q, m] > maxval:
                i = q
                maxval = M[q, m]

    s_out: list[str] = []
    t_out: list[str] = []
    forcex = forcey = False
    while i > 0 or j > 0:
        # Boundary rows/cols: emit the remaining leading gap. The reference
        # relies on its init tb codes here and is UB if a forced-gap state
        # reaches the boundary (never happens for lancet's anchored
        # alignments); we make it well-defined.
        if i == 0:
            s_out.append("-")
            t_out.append(T[j - 1])
            j -= 1
            continue
        if j == 0:
            s_out.append(S[i - 1])
            t_out.append("-")
            i -= 1
            continue
        t = Mtb[i, j]
        if t == _STAR:
            break
        if forcex:
            s_out.append(S[i - 1])
            t_out.append("-")
            if Xtb[i, j] == _LEFT:
                forcex = False
            i -= 1
        elif t == _LEFT:
            s_out.append(S[i - 1])
            t_out.append("-")
            if Xtb[i, j] == _XEXT:
                forcex = True
            i -= 1
        elif forcey:
            s_out.append("-")
            t_out.append(T[j - 1])
            if Ytb[i, j] == _UP:
                forcey = False
            j -= 1
        elif t == _UP:
            s_out.append("-")
            t_out.append(T[j - 1])
            if Ytb[i, j] == _YEXT:
                forcey = True
            j -= 1
        elif t == _DIAG:
            s_out.append(S[i - 1])
            t_out.append(T[j - 1])
            i -= 1
            j -= 1
        else:  # pragma: no cover - unreachable by construction
            raise AssertionError("bad traceback state")

    return "".join(reversed(s_out)), "".join(reversed(t_out))
