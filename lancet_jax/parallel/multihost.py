"""Multi-host execution: jax.distributed processes over window shards.

The reference scales past one machine with a qsub fan-out — one lancet
job per region chunk plus a VCF merge script (README.md:70-88). The
device-native replacement: N processes (one per host) initialize
jax.distributed, every process computes the identical global shard
decomposition, runs the full pipeline (host C++ plane + its local
devices) on the shards it owns, and the per-shard variant DBs are
gathered to every process over the distributed runtime (gloo on CPU
hosts; not yet verified across GPU hosts). Process 0 merges in global shard
order — the same order a single-process run uses (Lancet.cc:938-959) —
so the VCF is process-count invariant by construction.

Per-host input stays host-local: each process opens its own BAM/FASTA
readers and touches only the file regions its shards cover (the BAI
index makes the per-shard reads local seeks, not a broadcast).
"""

from __future__ import annotations

import pickle

import numpy as np


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int) -> None:
    """Initialize the JAX distributed runtime (idempotent per process)."""
    import jax

    jax.distributed.initialize(coordinator, num_processes=num_processes,
                               process_id=process_id)


def _allgather_bytes(blob: bytes) -> list[bytes]:
    """Gather one bytes payload per process to every process. Lengths are
    exchanged first so the uint8 payload tensor is fixed-width — the
    framework's record-merge collectives always ride fixed shapes."""
    import jax
    from jax.experimental import multihost_utils

    n = jax.process_count()
    if n == 1:
        return [blob]
    ln = np.array([len(blob)], np.int64)
    lens = multihost_utils.process_allgather(ln).reshape(-1)
    width = int(lens.max())
    buf = np.zeros(width, np.uint8)
    buf[: len(blob)] = np.frombuffer(blob, np.uint8)
    allbuf = multihost_utils.process_allgather(buf)
    return [allbuf[i, : int(lens[i])].tobytes() for i in range(n)]


def run_multihost(cfg, command_line: str = "lancet-jax",
                  date: str | None = None, engine: str = "device",
                  mesh=None, stats: dict | None = None) -> str | None:
    """Run the caller across all initialized processes; returns the VCF
    text on process 0 and None elsewhere. Requires init_distributed()
    (or single-process, where it degenerates to runner.run)."""
    import jax

    from ..engine.vardb import VariantDB
    from ..runner import LANCET_VERSION, run
    from ..io import open_bam

    p, n = jax.process_index(), jax.process_count()
    collect: dict = {}
    run(cfg, command_line=command_line, date=date, engine=engine,
        stats=stats, mesh=mesh,
        shard_filter=(lambda si: si % n == p), collect=collect)

    blobs = _allgather_bytes(pickle.dumps(collect["shard_dbs"], protocol=4))
    if p != 0:
        return None

    shard_dbs = sorted((s for b in blobs for s in pickle.loads(b)),
                       key=lambda t: t[0])
    merged = VariantDB(cfg.lr_mode)
    for _, db in shard_dbs:
        vdb = VariantDB(cfg.lr_mode)
        vdb.db = db
        merged.merge_from(vdb)

    import time as _time

    if date is None:
        date = _time.asctime() + "\n"
    tumor = open_bam(cfg.tumor_bam)
    normal = open_bam(cfg.normal_bam)
    return merged.to_vcf(LANCET_VERSION, cfg.ref_fasta, date, cfg.filters,
                         normal.sample_name(), tumor.sample_name(),
                         command_line)
