"""End-to-end run orchestration (host pipeline; ref: src/Lancet.cc main).

Shards windows round-robin (reference thread semantics), processes each
shard (oracle engine or device-batched engine), merges shard variant DBs in
shard order, and renders the VCF.
"""

from __future__ import annotations

import time

from . import __version__
from .config import Config
from .engine.micro import Microassembler
from .engine.vardb import VariantDB
from .io import open_bam, open_fasta
from .windows import generate_windows, shard_windows

LANCET_VERSION = "1.1.0, October 18 2019"  # reference version string emulated


def _print_summary(counters, num_windows: int) -> None:
    """End-of-run region-class counters to stderr
    (ref: Lancet.cc:930-970)."""
    import sys

    def tot(field):
        return sum(getattr(c, field) for c in counters)

    skip = tot("num_skip")
    pct = 100.0 * skip / num_windows if num_windows else 0.0
    print(f"Total # of skipped windows: {skip} ({pct:g}%)", file=sys.stderr)
    print(f"- # of windows with SNVs only: {tot('num_snv_only')}",
          file=sys.stderr)
    print(f"- # of windows with indels only: {tot('num_indel_only')}",
          file=sys.stderr)
    print(f"- # of windows with softclips only: {tot('num_softclip_only')}",
          file=sys.stderr)
    print("- # of windows with indels or softclips: "
          f"{tot('num_indel_or_softclip')}", file=sys.stderr)
    print(f"- # of windows with SNVs or indels: {tot('num_snv_or_indel')}",
          file=sys.stderr)
    print("- # of windows with SNVs or softclips: "
          f"{tot('num_snv_or_softclip')}", file=sys.stderr)
    print("- # of windows with SNVs or indels or softclips: "
          f"{tot('num_snv_or_indel_or_softclip')}", file=sys.stderr)


def _run_shard(cfg, tumor_path, normal_path, shard, engine, shard_idx=0,
               resume_state=None, gates=None, defer=False, test_kill=False):
    """Process-pool worker: open its own readers (share-nothing) and
    return (VariantDB, window_times, counters, path_jobs).

    Two-phase mode (defer=True + parent-precomputed gates): the worker is
    pure host code — it never imports JAX — and returns its deferred
    PathJobs for the parent to align on the device and finish, so N
    workers saturate host cores while one process owns the device. Otherwise
    the worker pins JAX to CPU and flushes its own jobs."""
    import multiprocessing as _mp

    if test_kill and _mp.parent_process() is not None:
        import os as _os

        _os._exit(1)  # failure-injection hook: simulate a died worker
    if not defer:
        try:
            import jax

            jax.config.update("jax_platforms", "cpu")
        except Exception:
            pass
    tumor = open_bam(tumor_path)
    normal = open_bam(normal_path)
    ma = Microassembler(cfg, readers=(tumor, normal), engine=engine)
    if gates is not None:
        ma.precomputed_gates = gates
    ma.defer_flush = defer
    _process_shard(ma, cfg, shard, shard_idx, resume_state)
    return ma.vdb, ma.window_times, ma.counters, (ma.path_jobs if defer
                                                  else [])


def _process_shard(ma, cfg, shard, shard_idx, resume_state) -> None:
    """Run one shard with optional resume logging / window tracing."""
    trace = bool(cfg.trace_file)
    if cfg.resume_dir:
        from .checkpoint import ShardLog, shard_log_path

        done, replay = (resume_state if resume_state is not None
                        else (set(), []))
        for v in replay:
            ma.vdb.add_var(v)
        log = ShardLog(shard_log_path(cfg.resume_dir, shard_idx))
        try:
            ma.process_windows(shard, skip_names=done,
                               chunk_cb=log.append_chunk, trace=trace)
        finally:
            log.close()
    else:
        ma.process_windows(shard, chunk_cb=None, trace=trace)


def run(cfg: Config, command_line: str = "lancet-jax", date: str | None = None,
        engine: str = "oracle", processes: bool = False,
        stats: dict | None = None, mesh=None, shard_filter=None,
        collect: dict | None = None) -> str:
    """Run the caller; returns the VCF text. `processes=True` fans shards
    out to a process pool (host parallelism; device work still batches
    per shard). `stats`, if given, is filled with per-stage wall seconds
    (gates / host graph stage / device DP / finish) and counts.
    `shard_filter(global_shard_idx) -> bool` keeps a subset of shards
    (multi-host fan-out); `collect`, if given, receives the per-shard
    variant DBs instead of a merged VCF (the caller merges in global
    shard order — parallel.multihost does this across processes)."""
    if stats is None:
        stats = {}
    t_start = time.perf_counter()
    if engine == "device":
        # persistent XLA compile cache (devicepipe.compile_cache_dir says
        # where, and why CPU runs go without)
        from .engine.devicepipe import _enable_compile_cache

        _enable_compile_cache()
    fasta = open_fasta(cfg.ref_fasta)
    tumor = open_bam(cfg.tumor_bam)
    normal = open_bam(cfg.normal_bam)

    # MD-tag availability check disables active regions like the reference
    # (Lancet.cc:817-825): probe the first record of each BAM.
    cfg_eff = cfg
    if cfg.active_regions:
        def first_has_md(rdr):
            al = rdr.first_record()
            return True if al is None else "MD" in al.tags
        if not (first_has_md(tumor) or first_has_md(normal)):
            import dataclasses
            cfg_eff = dataclasses.replace(cfg, active_regions=False)

    regions = []
    if cfg.bed_file:
        with open(cfg.bed_file) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                toks = line.rstrip("\n").split("\t")
                if len(toks) < 3:
                    continue
                sp = int(toks[1]) - cfg.padding
                if sp < 1:
                    sp = 1
                ep = int(toks[2]) + cfg.padding
                # NOTE: loadRefs pads again -> BED rows get 2x padding,
                # replicating the reference (Lancet.cc:345-352)
                regions.append(f"{toks[0]}:{sp}-{ep}")
    if cfg.region:
        regions.append(cfg.region)

    windows = generate_windows(fasta, regions, fasta.lengths,
                               cfg.window_size, cfg.padding)
    shards = shard_windows(windows, cfg.num_threads)

    # Multi-host fan-out: every process computes the identical global
    # shard decomposition, keeps only the shards `shard_filter` selects,
    # and (via `collect`) hands back per-shard DBs for the coordinator's
    # shard-order merge — the device analog of the reference's qsub
    # cluster fan-out + VCF merge (README.md:70-88, Lancet.cc:938-959).
    shard_ids = list(range(len(shards)))
    if shard_filter is not None:
        shard_ids = [i for i in shard_ids if shard_filter(i)]
        shards = [shards[i] for i in shard_ids]
        windows_local = [w for s in shards for w in s]
    else:
        windows_local = windows

    if cfg.print_config_file:
        # reference writes config.txt in the working directory
        # (Lancet.cc:829-834, 118-185)
        from .config import print_configuration

        with open("config.txt", "w") as f:
            f.write(print_configuration(cfg_eff))

    resume_state = [None] * len(shards)
    if cfg.resume_dir:
        import os

        from .checkpoint import load_resume_state

        os.makedirs(cfg.resume_dir, exist_ok=True)
        resume_state = load_resume_state(cfg.resume_dir, len(shards))

    merged = VariantDB(cfg.lr_mode)
    all_times: list = []
    counters = []

    def _absorb(si_local: int, vdb) -> None:
        if collect is not None:
            collect.setdefault("shard_dbs", []).append(
                (shard_ids[si_local], vdb.db))
        else:
            merged.merge_from(vdb)

    # Native batched shard runner: the whole host stage (fetch, triage,
    # filters, per-k graph) runs in C++ threads; Python does the device DP
    # batch and variant-object construction. Falls back to the per-window
    # engines when unavailable or for modes it doesn't cover.
    import os

    use_native = (engine == "device" and not cfg.kmer_recovery
                  and not cfg.print_graph
                  and not os.environ.get("LANCET_NO_SHARDRUN"))
    if use_native:
        from .engine.shardrun import (device_graph_enabled, run_shards,
                                      run_shards_device)

        # per-shard window lists; with --resume-dir the run is split into
        # chunked rounds, each followed by an fsync'd per-shard log append
        # (windows + their variant records), so a crash resumes mid-run
        # on the SAME fast path (round-1 gap: resume used to drop to the
        # per-window python engine)
        shard_wins = [sorted(shard, key=lambda w: w.name)
                      for shard in shards]
        logs = None
        chunk = None
        if cfg.resume_dir:
            from .checkpoint import ShardLog, shard_log_path

            logs = [ShardLog(shard_log_path(cfg.resume_dir, i))
                    for i in range(len(shards))]
            todo = [[w for w in sw if w.name not in resume_state[i][0]]
                    for i, sw in enumerate(shard_wins)]
            chunk = int(os.environ.get("LANCET_RESUME_CHUNK", "256"))
        else:
            todo = shard_wins

        shard_vdbs = [VariantDB(cfg.lr_mode) for _ in shards]
        if cfg.resume_dir:
            for i, (_, replay) in enumerate(resume_state):
                for v in replay:
                    shard_vdbs[i].add_var(v)

        from .engine.micro import ShardCounters

        ctr = ShardCounters()
        fb_ma = None
        trace = bool(cfg.trace_file)
        n_fallback = 0
        failed = False
        n_rounds = (1 if chunk is None else
                    max([(len(t) + chunk - 1) // chunk for t in todo] or [1])
                    or 1)

        def acc_stats(rs):
            for k, v in rs.items():
                if isinstance(v, float):
                    stats[k] = stats.get(k, 0.0) + v
                elif isinstance(v, int):
                    stats[k] = stats.get(k, 0) + v
                elif k == "k_histogram":
                    h = stats.setdefault("k_histogram", {})
                    for kk, vv in v.items():
                        h[kk] = h.get(kk, 0) + vv
                else:
                    stats[k] = v

        for rnd in range(n_rounds):
            ordered = []
            shard_of = []
            for si, t in enumerate(todo):
                sub = t if chunk is None else t[rnd * chunk:(rnd + 1) * chunk]
                ordered.extend(sub)
                shard_of.extend([si] * len(sub))
            if not ordered:
                continue
            rstats: dict = {}
            # the device graph engine carries no BX/HP payloads; LR runs
            # stay on the fully-native plane (still device-batched DP)
            if device_graph_enabled() and not cfg.lr_mode:
                res = run_shards_device(cfg_eff, ordered, tumor, normal,
                                        stats=rstats, mesh=mesh)
            else:
                res = run_shards(cfg_eff, ordered, tumor, normal,
                                 stats=rstats, mesh=mesh)
            if res is None:
                failed = True
                break
            acc_stats(rstats)
            pos = 0
            for si in range(len(shards)):
                vdb = shard_vdbs[si]
                win_names: list = []
                if logs is not None:
                    vdb.record_sink = []
                while pos < len(ordered) and shard_of[pos] == si:
                    wi = pos
                    w = ordered[wi]
                    if wi in res.fallback:
                        if fb_ma is None:
                            fb_ma = Microassembler(cfg_eff,
                                                   readers=(tumor, normal),
                                                   engine="device")
                        fb_ma.vdb = vdb
                        r0 = fb_ma.counters.total_reads
                        t0 = time.perf_counter()
                        fb_ma.process_window(w)
                        fb_ma.flush_path_jobs()
                        if trace:
                            all_times.append(
                                (w.name, (time.perf_counter() - t0) * 1e3,
                                 fb_ma.counters.total_reads - r0))
                    else:
                        for v in res.variants_by_window.get(wi, ()):  # noqa
                            vdb.add_var(v)
                        c = res.counters[wi]
                        ctr.num_skip += int(c[0])
                        ctr.num_snv_only += int(c[1])
                        ctr.num_indel_only += int(c[2])
                        ctr.num_softclip_only += int(c[3])
                        ctr.num_indel_or_softclip += int(c[4])
                        ctr.num_snv_or_indel += int(c[5])
                        ctr.num_snv_or_softclip += int(c[6])
                        ctr.num_snv_or_indel_or_softclip += int(c[7])
                        ctr.total_reads += int(res.reads[wi])
                        ctr.windows_done += int(c[8])
                        if trace:
                            all_times.append((w.name, float(res.times[wi]),
                                              int(res.reads[wi])))
                    win_names.append(w.name)
                    pos += 1
                if logs is not None:
                    if win_names:
                        logs[si].append_chunk(win_names, vdb.record_sink)
                    vdb.record_sink = None
            n_fallback += len(res.fallback)
            if res.fallback:
                import sys as _sys
                print(f"WARNING: {len(res.fallback)} windows replayed on "
                      "the python engine (native shard runner fallback)",
                      file=_sys.stderr)

        if logs is not None:
            for lg in logs:
                lg.close()
        if not failed:
            for si in range(len(shards)):
                _absorb(si, shard_vdbs[si])
            if fb_ma is not None:
                counters.append(fb_ma.counters)
            counters.append(ctr)
            # surface native->python replays: a silent 100%-fallback
            # regression must look like an error, not a perf mystery
            stats["n_fallback"] = n_fallback
        else:
            use_native = False

    if use_native:
        pass
    elif cfg.num_threads > 1 and processes:
        # share-nothing shard workers (reference pthread model,
        # Lancet.cc:844-928); shard DBs merged in shard order so the
        # result is process-count invariant
        import concurrent.futures as cf
        import multiprocessing as mp

        # two-phase: parent precomputes the repeat gates on device, workers
        # do pure-host graph work, parent aligns all deferred jobs on
        # device and finishes them in shard order (identical add order to
        # the single-process run). Resume logging needs in-worker flushes,
        # so it falls back to self-contained workers.
        defer = engine == "device" and not cfg.resume_dir
        gates_by_shard = [None] * len(shards)
        if defer:
            from .engine.micro import Microassembler as _MA

            t0 = time.perf_counter()
            planner = _MA(cfg_eff, readers=None, engine=engine)
            planner._precompute_gates(sorted(windows, key=lambda w: w.name))
            for i, shard in enumerate(shards):
                names = {w.name for w in shard}
                gates_by_shard[i] = (
                    {n: g for n, g in planner._gates.items() if n in names},
                    planner._gate_kidx)
            stats["t_gates"] = time.perf_counter() - t0

        # forkserver: the server boots once via exec (no inherited device
        # client — never plain-fork a process with a live device runtime)
        # and each worker forks from it in milliseconds; interpreter boot
        # costs ~2s on this host, so spawn-per-worker would dominate small
        # runs. Preload the worker's import graph into the server.
        try:
            ctx = mp.get_context("forkserver")
            ctx.set_forkserver_preload(
                ["lancet_jax.runner", "lancet_jax.engine.micro",
                 "lancet_jax.io.bam", "lancet_jax.native"])
        except (ValueError, AttributeError):
            ctx = mp.get_context("spawn")
        import os as _os

        # workers beyond the physical cores only add fork + pickle + context
        # switch overhead; shard count stays num_threads (result-identical)
        n_workers = max(1, min(cfg.num_threads, _os.cpu_count() or 8))
        t0 = time.perf_counter()
        with cf.ProcessPoolExecutor(max_workers=n_workers,
                                    mp_context=ctx) as ex:
            kill_env = os.environ.get("LANCET_TEST_KILL_SHARD")
            futs = [ex.submit(_run_shard, cfg_eff, cfg.tumor_bam,
                              cfg.normal_bam, shard, engine, i,
                              resume_state[i], gates_by_shard[i], defer,
                              kill_env is not None and int(kill_env) == i)
                    for i, shard in enumerate(shards)]
            results = []
            dead: list[int] = []
            for i, fut in enumerate(futs):
                try:
                    results.append(fut.result())
                except Exception:
                    # worker died (OOM/segv/kill): its shard is
                    # re-enqueued in-parent below — the share-nothing
                    # shard model makes the replay result-identical
                    dead.append(i)
                    results.append(None)
        if dead:
            import sys as _sys
            print(f"WARNING: {len(dead)} worker(s) died; re-running "
                  f"{sum(len(shards[i]) for i in dead)} windows in-parent",
                  file=_sys.stderr)
            for i in dead:
                results[i] = _run_shard(cfg_eff, cfg.tumor_bam,
                                        cfg.normal_bam, shards[i], engine,
                                        i, resume_state[i],
                                        gates_by_shard[i], defer)
            stats["n_dead_workers"] = len(dead)
        stats["t_host"] = time.perf_counter() - t0
        if defer:
            from .engine.extract import finish_path

            all_jobs = [j for (_, _, _, jobs) in results for j in jobs]
            dp_jobs = [j for j in all_jobs if j.needs_dp]
            stats["n_jobs"] = len(all_jobs)
            stats["n_dp"] = len(dp_jobs)
            aligned = {}
            t0 = time.perf_counter()
            if dp_jobs:
                from .device.align_batch import batch_align

                out = batch_align([(j.refseq, j.pathseq) for j in dp_jobs])
                aligned = {id(j): r for j, r in zip(dp_jobs, out)}
            stats["t_dp"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for si, (vdb, times, ctr, jobs) in enumerate(results):
                for j in jobs:
                    ra, pa = (aligned[id(j)] if j.needs_dp
                              else (j.refseq, j.pathseq))
                    finish_path(j, ra, pa, cfg_eff, vdb)
                _absorb(si, vdb)
                all_times.extend(times)
                counters.append(ctr)
            stats["t_finish"] = time.perf_counter() - t0
        else:
            for si, (vdb, times, ctr, _) in enumerate(results):
                _absorb(si, vdb)
                all_times.extend(times)
                counters.append(ctr)
    else:
        for i, shard in enumerate(shards):
            ma = Microassembler(cfg_eff, readers=(tumor, normal), engine=engine)
            _process_shard(ma, cfg_eff, shard, i, resume_state[i])
            _absorb(i, ma.vdb)
            all_times.extend(ma.window_times)
            counters.append(ma.counters)

    if cfg.trace_file:
        import json as _json

        with open(cfg.trace_file, "w") as f:
            for name, ms, reads in all_times:
                f.write(_json.dumps({"window": name, "ms": round(ms, 3),
                                     "reads": reads}) + "\n")

    _print_summary(counters, len(windows_local))

    stats["t_total"] = time.perf_counter() - t_start
    stats["n_windows"] = len(windows_local)

    if collect is not None:
        collect.setdefault("shard_dbs", [])
        collect["lr_mode"] = cfg.lr_mode
        return ""

    if date is None:
        date = time.asctime() + "\n"
    sample_t = tumor.sample_name()
    sample_n = normal.sample_name()
    t0 = time.perf_counter()
    vcf = merged.to_vcf(LANCET_VERSION, cfg.ref_fasta, date, cfg.filters,
                        sample_n, sample_t, command_line)
    # FET/SB Fisher scoring + filters + text render, per PASS candidate
    stats["t_render"] = time.perf_counter() - t0
    return vcf
