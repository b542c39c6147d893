"""Batched repeat gates: isRepeat / isAlmostRepeat over all windows and all
k values in one device pass.

The reference runs an O(L^2*K) CPU scan per (window, k) retry
(util.cc:295-360, called at Microassembler.cc:118-131, 799-800). Here all
shifted self-comparisons are computed once per window ([W, L, L] mismatch
prefix sums) and every k's verdict is a masked windowed reduction —
shared across k since prefix sums are k-independent.

Semantics preserved exactly, including the reference's quirks: the final
k-mer offset L-k is excluded, and the "almost" window is K+1 long.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def gates_impl(seq, lens, ks: tuple, max_mismatch: int):
    """seq: [W, L] uint8; lens: [W] int32.
    Returns bool [W, len(ks)]: True if k is gated (repeat or near-repeat).

    lax.scan over the shift axis d with only [W, L]-shaped state per step
    (the naive formulation materializes a [W, L, L] mismatch tensor —
    hundreds of MB of HBM traffic per chunk; this streams it)."""
    W, L = seq.shape
    p_idx = jnp.arange(L)
    o_full = jnp.arange(L + 1)
    ks_arr = jnp.asarray(ks, jnp.int32)  # [nk]
    # per-k window-end gather indices [nk, L+1] and validity masks
    hi_k = jnp.minimum(o_full[None, :] + ks_arr[:, None], L)
    hi_k1 = jnp.minimum(o_full[None, :] + ks_arr[:, None] + 1, L)

    def per_d(carry, d):
        gates_acc, exact_acc = carry  # [W, nk] bool
        idx = jnp.minimum(p_idx + d + 1, L - 1)
        neq = (seq[:, idx] != seq).astype(jnp.int32)  # [W, L]
        neq = jnp.where((p_idx + d + 1)[None, :] < lens[:, None], neq, 0)
        pref = jnp.concatenate(
            [jnp.zeros((W, 1), jnp.int32), jnp.cumsum(neq, axis=1)], axis=1)
        cnt_k = pref[:, hi_k] - pref[:, None, :]    # [W, nk, L+1]
        cnt_k1 = pref[:, hi_k1] - pref[:, None, :]
        # valid offsets: o <= len - k - 1 - (d+1)
        lim = lens[:, None, None] - ks_arr[None, :, None] - 1 - (d + 1)
        mask = o_full[None, None, :] <= lim
        exact = jnp.any(mask & (cnt_k == 0), axis=2)        # [W, nk]
        almost = jnp.any(mask & (cnt_k1 <= max_mismatch), axis=2)
        return (gates_acc | exact | almost, exact_acc | exact), None

    init = (jnp.zeros((W, len(ks)), bool), jnp.zeros((W, len(ks)), bool))
    (gates, exact), _ = jax.lax.scan(per_d, init, jnp.arange(L - 1))
    return gates, exact


_gates = functools.partial(jax.jit, static_argnums=(2, 3))(gates_impl)


def repeat_gates(windows: list[str], ks: list[int], max_mismatch: int,
                 with_exact: bool = False):
    """Per-window, per-k gate verdicts (True = skip this k); optionally
    also the exact-repeat matrix (used for the maxK window skip)."""
    if not windows:
        z = np.zeros((0, len(ks)), bool)
        return (z, z) if with_exact else z
    nw = len(windows)
    # stable shape buckets: L to a 128 multiple, W to a 2-size ladder —
    # the per-k retry loop calls this with every pending-count in a run,
    # and each distinct W is its own XLA executable, so small/large is
    # the whole ladder
    L = ((max(8, max(len(w) for w in windows)) + 127) // 128) * 128
    if nw <= 256:
        W = 256
    elif nw <= 2048:
        W = 2048
    else:
        W = 1 << (nw - 1).bit_length()
    seq = np.zeros((W, L), np.uint8)
    lens = np.zeros(W, np.int32)  # pad rows: len 0 -> never gated
    for i, w in enumerate(windows):
        seq[i, : len(w)] = np.frombuffer(w.encode("latin-1"), np.uint8)
        lens[i] = len(w)
    gates, exact = _gates(jnp.asarray(seq), jnp.asarray(lens),
                          tuple(ks), max_mismatch)
    gates = np.asarray(gates)[:nw]
    exact = np.asarray(exact)[:nw]
    if with_exact:
        return gates, exact
    return gates
