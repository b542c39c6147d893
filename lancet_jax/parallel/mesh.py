"""Device mesh + sharded batched step.

The reference's parallelism is share-nothing windows over pthreads with a
serial merge (Lancet.cc:844-959). The device equivalent: a 1-D mesh over
the window/pair axis; each device runs the batched kernels on its shard;
per-step counters are reduced with a single psum (NCCL on GPUs). Every
card reaches every other at the same rate, so the mesh needs no topology.

Deadlock discipline: every compiled program here contains AT MOST ONE
collective. Multi-collective programs
let XLA:CPU's thunk executor interleave independent rendezvous in
different orders per partition — a cross-rendezvous deadlock. We use
shard_map with per-shard control flow (each device's while-loops exit on
its own shard's predicate — the true share-nothing analog of the
reference's threads) and keep outputs SHARDED on the window axis; the
host assembles shards when it consumes them, so no output-resharding
all_gathers are emitted. The one collective left is the counter psum in
shard_windows_jit — a single collective cannot be reordered against
anything.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("w",))


def make_local_mesh(n_devices: int | None = None) -> Mesh:
    """Mesh over THIS process's addressable devices — the multi-host
    composition: each process shards its own window shards over its own
    chips (share-nothing between processes, like the reference's qsub
    fan-out README.md:70-88); the cross-process merge is the fixed-width
    gather in parallel.multihost, not a compute-path collective."""
    devs = jax.local_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("w",))


def mesh_key(mesh: Mesh | None):
    """Executable-cache key for a mesh: the device-id tuple. (id(mesh) is
    a stale-reuse hazard — a GC'd Mesh's address can be recycled by a
    different-size mesh and silently fetch an executable compiled for the
    wrong device set.)"""
    if mesh is None:
        return None
    return tuple(int(d.id) for d in mesh.devices.flat)


def _shard_map(fn, mesh, in_specs, out_specs):
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     check_vma=False)


def shard_windows_jit(impl, mesh: Mesh):
    """Production window-axis data parallelism: shard_map `impl` (a pure
    batched pipeline step whose every input/output leaf has the window
    batch as its leading axis) with that axis split over `mesh`.

    This is the device analog of the reference's round-robin windows
    over worker threads (Lancet.cc:305-310, 844-928; SURVEY.md §2.3 row
    1): each device runs build/cleanup/path-cover on its window shard
    with fully LOCAL control flow (a device's cleanup fixpoint loops exit
    when ITS windows converge — no cross-device predicate all_reduces),
    and outputs stay sharded on the window axis (the host gathers shards
    on consumption; per-window results are independent of the sharding,
    so the VCF is device-count invariant by construction). The region/
    abort counters are reduced with one psum — the only collective in the
    program, the merge of Lancet.cc:930-970."""

    def local(*args):
        out = impl(*args)
        counters = jnp.stack([
            jnp.sum(out["numcomp"].astype(jnp.int32)),
            jnp.sum(out["n_sel"].astype(jnp.int32)),
            jnp.sum(out["fallback"].astype(jnp.int32)),
        ])
        counters = jax.lax.psum(counters, "w")
        return out, counters

    sm = _shard_map(local, mesh, in_specs=P("w"), out_specs=(P("w"), P()))

    def wrapped(*args):
        out, counters = sm(*args)
        out = dict(out)
        out["mesh_counters"] = counters
        return out

    return jax.jit(wrapped)


_BUILD_CACHE: dict = {}


def shard_build_k(mesh: Mesh, K: int, statics: tuple):
    """Cached shard-mapped colored-DBG build for one (mesh, k, shapes)
    combination: each device builds its window shard's graphs; no
    collectives (build_k is batch-parallel along the window axis)."""
    key = (mesh_key(mesh), K, statics)
    fn = _BUILD_CACHE.get(key)
    if fn is not None:
        return fn
    from ..device.dbg import build_k

    N, E, D, Lraw, min_qual_call, low_cov_threshold, min_cov_ratio = statics

    def local(*arrs):
        return build_k(K, *arrs, N=N, E=E, D=D, Lraw=Lraw,
                       min_qual_call=min_qual_call,
                       low_cov_threshold=low_cov_threshold,
                       min_cov_ratio=min_cov_ratio)

    fn = jax.jit(_shard_map(local, mesh, in_specs=P("w"),
                            out_specs=P("w")))
    _BUILD_CACHE[key] = fn
    return fn


# ---------------------------------------------------------------------------
# Production path: the real batched Gotoh fill + traceback sharded over the
# mesh. Each device fills its slice of the pair axis; the packed traceback
# ops stay sharded on that axis (fixed-width per-pair records the host
# decodes shard-by-shard) — the device analog of the reference's
# per-thread VariantDB merge (Lancet.cc:938-959; SURVEY.md §2.3).
# ---------------------------------------------------------------------------

_MESH_DP_CACHE: dict = {}


def _mesh_dp_fn(mesh: Mesh, N: int, M: int):
    key = (mesh_key(mesh), N, M)
    fn = _MESH_DP_CACHE.get(key)
    if fn is not None:
        return fn
    from ..device.align_batch import _dp_and_traceback

    def local(S, T, n_len, m_len):
        # outputs stay sharded on the pair axis: no collectives at all
        return _dp_and_traceback(S, T, n_len, m_len, N, M)

    fn = jax.jit(_shard_map(
        local, mesh, in_specs=(P("w", None), P("w", None), P("w"), P("w")),
        out_specs=(P("w", None), P("w"))))
    _MESH_DP_CACHE[key] = fn
    return fn


def mesh_batch_align_async(pairs: list, mesh: Mesh):
    """Dispatch the batched Gotoh DP sharded over `mesh` (pair axis).
    Returns the same state contract as device.align_batch.batch_align_async —
    decode with batch_align_wait. Per-pair results are independent of the
    sharding, so any mesh size yields identical alignments (the VCF is
    device-count invariant; mirrors the reference's thread-count
    invariance, Lancet.cc:305-310)."""
    if not pairs:
        return None
    from ..device.align_batch import pack_pairs

    S, T, n_len, m_len, N, M = pack_pairs(pairs, int(mesh.devices.size))
    fn = _mesh_dp_fn(mesh, N, M)
    ops, counts = fn(jnp.asarray(S), jnp.asarray(T), jnp.asarray(n_len),
                     jnp.asarray(m_len))
    return ops, counts, pairs
