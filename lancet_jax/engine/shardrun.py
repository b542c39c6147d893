"""Native batched shard runner glue (lancet_native.cc lsr_*).

One native call processes every window of the run — BAM fetch with shared
per-chunk caches, active-region triage, the read-extraction filter chain,
and the per-k graph stage — in C++ threads; reads never enter Python
(replaces the per-window Python orchestration that dominated a profile of
the first engine). Python's remaining role per run: the device-batched
Gotoh alignment for the jobs that need DP (device.align_batch), one lsr_finish call that replays the transcript state
machine natively, and Variant object construction from the packed records.

Windows that hit a native-side inconsistency are replayed with the Python
engine (identical semantics, deterministic), preserving the all-or-nothing
per-window fallback contract of engine.fastpipe.
"""

from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

STATUS_OK = 0

_LSR = None


def _lib():
    global _LSR
    if _LSR is None:
        try:
            from ..native import load_library

            lib = load_library()
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            f64p = ctypes.POINTER(ctypes.c_double)
            lib.lsr_run.restype = ctypes.c_void_p
            lib.lsr_run.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, i32p, i32p,
                i64p, i64p, u8p, i64p, u8p, u8p, ctypes.c_int, i64p, f64p,
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, u8p]
            lib.lsr_x_info.argtypes = [ctypes.c_void_p, u8p, i64p, i64p]
            lib.lsr_x_data.restype = u8p
            lib.lsr_x_data.argtypes = [ctypes.c_void_p, ctypes.c_long]
            lib.lsx_scan_batch.restype = ctypes.c_void_p
            lib.lsx_scan_batch.argtypes = [
                ctypes.c_int64, i64p, u8p, i64p, u8p, i64p, u8p, i64p,
                i32p, i32p, i64p, u8p, i64p, i32p, i64p]
            lib.lsx_varbuf_size.restype = ctypes.c_long
            lib.lsx_varbuf_size.argtypes = [ctypes.c_void_p]
            lib.lsx_varbuf.restype = u8p
            lib.lsx_varbuf.argtypes = [ctypes.c_void_p]
            lib.lsx_free.argtypes = [ctypes.c_void_p]
            lib.lsr_status.restype = ctypes.c_int
            lib.lsr_status.argtypes = [ctypes.c_void_p]
            lib.lsr_n_jobs.restype = ctypes.c_long
            lib.lsr_n_jobs.argtypes = [ctypes.c_void_p]
            lib.lsr_job_meta.argtypes = [ctypes.c_void_p, i64p]
            lib.lsr_job_path.restype = ctypes.c_char_p
            lib.lsr_job_path.argtypes = [ctypes.c_void_p, ctypes.c_long]
            lib.lsr_win_out.argtypes = [ctypes.c_void_p, u8p, i64p, f64p,
                                        i64p]
            lib.lsr_finish.argtypes = [ctypes.c_void_p, u8p, i64p, u8p, i64p]
            lib.lsr_n_vars.restype = ctypes.c_long
            lib.lsr_n_vars.argtypes = [ctypes.c_void_p]
            lib.lsr_varbuf_size.restype = ctypes.c_long
            lib.lsr_varbuf_size.argtypes = [ctypes.c_void_p]
            lib.lsr_varbuf.restype = u8p
            lib.lsr_varbuf.argtypes = [ctypes.c_void_p]
            lib.lsr_free.argtypes = [ctypes.c_void_p]
            lib.lsr_stage_ns.argtypes = [i64p]
            lib.lsr_stage_reset.argtypes = []
            _LSR = lib
        except Exception:
            _LSR = 0
    return _LSR


def available() -> bool:
    return bool(_lib())


def _blob(strings: list[bytes]):
    off = np.zeros(len(strings) + 1, np.int64)
    np.cumsum([len(s) for s in strings], out=off[1:])
    blob = (np.frombuffer(b"".join(strings), np.uint8) if strings
            else np.zeros(0, np.uint8))
    return blob, off


class ShardRunResult:
    """Per-run native results: per-window Variant lists (constructor-arg
    records), fallback window indices, counters, and trace rows."""

    def __init__(self, variants_by_window, fallback, counters, times, reads,
                 n_jobs, n_dp):
        self.variants_by_window = variants_by_window
        self.fallback = fallback  # set of window indices needing replay
        self.counters = counters  # np [n_windows, 9]
        self.times = times
        self.reads = reads
        self.n_jobs = n_jobs
        self.n_dp = n_dp


def device_graph_enabled() -> bool:
    """Device graph engine switch (LANCET_DEVGRAPH=1/0).

    Default OFF: the native plane + device DP is the default path; the
    device graph engine is the scale-out path (the mesh tests and
    chip_smoke.py --devices 4 run it sharded over the window axis).
    Which engine wins on one card is not measured yet (DESIGN.md)."""
    v = os.environ.get("LANCET_DEVGRAPH")
    return v is not None and v != "0"


def run_shards_device(cfg, windows, tumor, normal,
                      stats: dict | None = None, mesh=None):
    """Device-graph-engine run: the native plane does fetch/triage/
    extract and exports post-trim reads; the device pipeline assembles
    (build -> cleanup -> path cover); the native scan_batch finishes
    transcripts. Windows the device flags (caps / quirk corners) are
    replayed by a second, fully-native lsr_run pass. VCF-identical to
    run_shards by construction; see tests/test_devgraph.py."""
    import time as _time

    lib = _lib()
    if not lib:
        return None
    from .devicepipe import WindowTask, run_device_graph
    from .variant import Variant

    n = len(windows)
    tmap = {nm: i for i, (nm, _) in enumerate(tumor.references)}
    nmap = {nm: i for i, (nm, _) in enumerate(normal.references)}
    refid_t = np.array([tmap.get(w.chrom, -1) for w in windows], np.int32)
    refid_n = np.array([nmap.get(w.chrom, -1) for w in windows], np.int32)
    starts = np.array([w.refstart for w in windows], np.int64)
    ends = np.array([w.refend for w in windows], np.int64)

    icfg = np.array([
        cfg.min_k, cfg.max_k, cfg.min_qual_trim, cfg.min_qual_call,
        cfg.min_map_qual, cfg.max_avg_cov, cfg.max_delta_as_xs,
        int(cfg.xa_filter), int(cfg.primary_alignment_only),
        int(cfg.active_regions), cfg.filters.min_alt_cnt_tumor,
        cfg.low_cov_threshold, cfg.max_tip_len, cfg.dfs_limit,
        cfg.max_indel_len, cfg.max_mismatch, cfg.max_unit_len,
        cfg.min_report_units, cfg.min_report_len, cfg.dist_from_str,
        int(cfg.lr_mode)],
        np.int64)
    dcfg = np.array([cfg.min_cov_ratio, float(cfg.cov_threshold)],
                    np.float64)
    rgs = b""
    if getattr(cfg, "rg_file", ""):
        with open(cfg.rg_file) as f:
            toks = f.read().split()
        if toks:
            rgs = "\n".join(toks).encode()

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)

    def p(a, t):
        return a.ctypes.data_as(t) if a.size else ctypes.cast(None, t)

    n_threads = max(1, os.cpu_count() or 1)
    cache_span = int(os.environ.get("LANCET_CACHE_SPAN", 8 << 20))

    def native_pass(idxs, device: bool):
        g = np.asarray(idxs, np.int64)
        sub_raw, sub_off = _blob([windows[i].rawseq.encode("latin-1")
                                  for i in idxs])
        rt = np.ascontiguousarray(refid_t[g])
        rn = np.ascontiguousarray(refid_n[g])
        st_ = np.ascontiguousarray(starts[g])
        en = np.ascontiguousarray(ends[g])
        mask = (np.ones(len(idxs), np.uint8) if device
                else np.zeros(0, np.uint8))
        h = lib.lsr_run(
            cfg.tumor_bam.encode(), cfg.normal_bam.encode(), len(idxs),
            p(rt, i32p), p(rn, i32p), p(st_, i64p), p(en, i64p),
            p(sub_raw, u8p), p(sub_off, i64p), ctypes.cast(None, u8p),
            ctypes.cast(None, u8p), 0, p(icfg, i64p), p(dcfg, f64p), rgs,
            n_threads, cache_span,
            p(mask, u8p) if device else ctypes.cast(None, u8p))
        if lib.lsr_status(h) != STATUS_OK:
            lib.lsr_free(h)
            return None
        return h

    lib.lsr_stage_reset()
    t_all = _time.perf_counter()
    all_idx = list(range(n))
    t0 = _time.perf_counter()
    h = native_pass(all_idx, device=True)
    if h is None:
        return None
    t_host = _time.perf_counter() - t0

    # collect exports + per-window outputs
    exported = np.zeros(n, np.uint8)
    nbytes = np.zeros(n, np.int64)
    xbp = np.zeros(n, np.int64)
    lib.lsr_x_info(h, p(exported, u8p), p(nbytes, i64p), p(xbp, i64p))
    cls = np.zeros((n, 9), np.int64)
    times = np.zeros(n, np.float64)
    reads_n = np.zeros(n, np.int64)
    gflags = np.zeros(n, np.uint8)
    lib.lsr_win_out(h, p(gflags, u8p), p(reads_n, i64p), p(times, f64p),
                    p(cls.reshape(-1), i64p))

    t0 = _time.perf_counter()
    tasks = []
    for i in range(n):
        if not exported[i]:
            continue
        buf = ctypes.string_at(lib.lsr_x_data(h, i), int(nbytes[i]))
        reads = []
        off = 0
        while off < len(buf):
            (ln,) = struct.unpack_from("<i", buf, off)
            label = buf[off + 4]
            strand = buf[off + 5]
            mate = buf[off + 6]
            (frag,) = struct.unpack_from("<i", buf, off + 8)
            seq = buf[off + 12 : off + 12 + ln]
            qual = buf[off + 12 + ln : off + 12 + 2 * ln]
            off += 12 + 2 * ln
            reads.append((seq, qual, int(label), int(strand), int(frag),
                          int(mate)))
        w = windows[i]
        tasks.append(WindowTask(
            widx=i, reads=reads, rawseq=w.rawseq, totalreadbp=int(xbp[i]),
            refchr=w.chrom, refstart=w.refstart))
    lib.lsr_free(h)
    t_unpack = _time.perf_counter() - t0

    t0 = _time.perf_counter()
    # a device fault (compile error, out of memory) propagates: only the
    # cause-counted semantic corners replay natively
    run_device_graph(tasks, cfg, stats=stats, mesh=mesh)
    t_dev = _time.perf_counter() - t0

    # device DP for the jobs that need it
    t0 = _time.perf_counter()
    all_jobs = [(t, j) for t in tasks if not t.fallback for j in t.jobs]
    dp_jobs = [(t, j) for t, j in all_jobs if j.needs_dp]
    if stats is not None and dp_jobs:
        # sample real DP jobs for the on-card parity check against the
        # oracle aligner (chip_smoke.py; real shape/length buckets)
        step = max(1, len(dp_jobs) // 64)
        stats["dp_samples"] = [(j.refseq, j.pathseq)
                               for _, j in dp_jobs[::step]][:64]
    aligned = {}
    if dp_jobs:
        if mesh is not None:
            from ..parallel.mesh import mesh_batch_align_async

            state = mesh_batch_align_async(
                [(j.refseq, j.pathseq) for _, j in dp_jobs], mesh)
        else:
            from ..device.align_batch import batch_align_async

            state = batch_align_async(
                [(j.refseq, j.pathseq) for _, j in dp_jobs])
        from ..device.align_batch import batch_align_wait

        out = batch_align_wait(state)
        aligned = {id(j): r for (_, j), r in zip(dp_jobs, out)}
    t_dp = _time.perf_counter() - t0

    # native batch transcript finish
    t0 = _time.perf_counter()
    variants_by_window: dict[int, list] = {}
    if all_jobs:
        metas = np.zeros((len(all_jobs), 8), np.int64)
        paths, ras, pas, spans = [], [], [], []
        covT_parts, covN_parts = [], []
        cov_off = np.zeros(len(all_jobs) + 1, np.int64)
        rc_blobs = []
        rc_off_of_task: dict[int, int] = {}
        rc_total = 0
        for k_, (t, j) in enumerate(all_jobs):
            if id(t) not in rc_off_of_task:
                rc_off_of_task[id(t)] = rc_total
                rc4 = np.concatenate([
                    j.ref_cov_tmr[:, 0], j.ref_cov_tmr[:, 1],
                    j.ref_cov_nml[:, 0], j.ref_cov_nml[:, 1]]).astype(
                        np.int32)
                rc_blobs.append(rc4)
                rc_total += rc4.size
            ra, pa = (aligned[id(j)] if j.needs_dp
                      else (j.refseq, j.pathseq))
            metas[k_] = (j.K, j.trim5, t.refstart, 0, 0,
                         len(t.rawseq), t.widx, rc_off_of_task[id(t)])
            paths.append(j.pathseq.encode("latin-1"))
            ras.append(ra.encode("latin-1"))
            pas.append(pa.encode("latin-1"))
            spans.append(np.ascontiguousarray(
                j.tumor_span.astype(np.uint8)))
            covT_parts.append(np.ascontiguousarray(
                j.covT[:, :4].astype(np.int32)).reshape(-1))
            covN_parts.append(np.ascontiguousarray(
                j.covN[:, :4].astype(np.int32)).reshape(-1))
            cov_off[k_ + 1] = cov_off[k_] + covT_parts[-1].size
        path_blob, path_off = _blob(paths)
        ra_blob, ra_off = _blob(ras)
        pa_blob, pa_off = _blob(pas)
        span_blob, span_off = _blob([s.tobytes() for s in spans])
        covT_blob = (np.concatenate(covT_parts) if covT_parts
                     else np.zeros(0, np.int32))
        covN_blob = (np.concatenate(covN_parts) if covN_parts
                     else np.zeros(0, np.int32))
        rc_blob = (np.concatenate(rc_blobs) if rc_blobs
                   else np.zeros(0, np.int32))
        icfg4 = np.array([cfg.max_unit_len, cfg.min_report_units,
                          cfg.min_report_len, cfg.dist_from_str], np.int64)
        hx = lib.lsx_scan_batch(
            len(all_jobs), p(metas.reshape(-1), i64p),
            p(path_blob, u8p), p(path_off, i64p),
            p(ra_blob, u8p), p(ra_off, i64p),
            p(pa_blob, u8p), p(pa_off, i64p),
            p(covT_blob, i32p), p(covN_blob, i32p), p(cov_off, i64p),
            p(span_blob, u8p), p(span_off, i64p),
            p(rc_blob, i32p), p(icfg4, i64p))
        nv = lib.lsx_varbuf_size(hx)
        buf = ctypes.string_at(lib.lsx_varbuf(hx), nv) if nv else b""
        lib.lsx_free(hx)
        _parse_varbuf(buf, windows, lambda wi: wi, variants_by_window)
    t_fin = _time.perf_counter() - t0

    # second pass: fully-native replay of device-fallback windows
    fb_idx = sorted([t.widx for t in tasks if t.fallback]
                    + [i for i in range(n) if gflags[i]])
    fallback: set[int] = set()
    tot_jobs, tot_dp = len(all_jobs), len(dp_jobs)
    if fb_idx:
        h2 = native_pass(fb_idx, device=False)
        if h2 is None:
            return None
        n_jobs2 = lib.lsr_n_jobs(h2)
        meta2 = np.zeros((n_jobs2, 6), np.int64)
        if n_jobs2:
            lib.lsr_job_meta(h2, p(meta2.reshape(-1), i64p))
        dp_idx = np.nonzero(meta2[:, 4])[0] if n_jobs2 else np.zeros(0, int)
        pairs = []
        for i in dp_idx:
            w = windows[fb_idx[int(meta2[i, 0])]]
            src, dist = int(meta2[i, 1]), int(meta2[i, 2])
            pathseq = ctypes.string_at(
                lib.lsr_job_path(h2, int(i)), int(meta2[i, 3])).decode(
                "latin-1")
            pairs.append((w.rawseq[src : src + dist], pathseq))
        al2 = []
        if pairs:
            from ..device.align_batch import batch_align

            al2 = batch_align(pairs)
        ra_blob, ra_off = _blob([a.encode("latin-1") for a, _ in al2])
        pa_blob, pa_off = _blob([b2.encode("latin-1") for _, b2 in al2])
        lib.lsr_finish(h2, p(ra_blob, u8p), p(ra_off, i64p),
                       p(pa_blob, u8p), p(pa_off, i64p))
        nv = lib.lsr_varbuf_size(h2)
        buf = ctypes.string_at(lib.lsr_varbuf(h2), nv) if nv else b""
        _parse_varbuf(buf, windows, lambda wi: fb_idx[wi],
                      variants_by_window)
        m = len(fb_idx)
        g2 = np.zeros(m, np.uint8)
        r2 = np.zeros(m, np.int64)
        t2 = np.zeros(m, np.float64)
        c2 = np.zeros((m, 9), np.int64)
        lib.lsr_win_out(h2, p(g2, u8p), p(r2, i64p), p(t2, f64p),
                        p(c2.reshape(-1), i64p))
        ga = np.asarray(fb_idx, np.int64)
        cls[ga] = c2
        times[ga] += t2
        reads_n[ga] = r2
        for li in np.nonzero(g2)[0]:
            fallback.add(int(fb_idx[int(li)]))
        tot_jobs += int(n_jobs2)
        tot_dp += len(pairs)
        lib.lsr_free(h2)

    if stats is not None:
        stats["t_host"] = t_host
        stats["t_pipeline"] = _time.perf_counter() - t_all
        stats["t_unpack"] = t_unpack
        stats["t_devgraph"] = t_dev
        stats["t_dp"] = t_dp
        stats["t_finish"] = t_fin
        stats["n_jobs"] = tot_jobs
        stats["n_dp"] = tot_dp
        stats["n_dev_windows"] = len(tasks)
        stats["n_dev_fallback"] = len(fb_idx)
        # per-k success histogram
        hist: dict[int, int] = {}
        for t in tasks:
            if t.done:
                hist[t.k_done] = hist.get(t.k_done, 0) + 1
        stats["k_histogram"] = dict(sorted(hist.items()))
        ns = np.zeros(16, np.int64)
        lib.lsr_stage_ns(p(ns, i64p))
        for k_, v in zip(("t_c_fetch", "t_c_triage", "t_c_extract",
                          "t_c_kloop", "t_c_scan", "t_c_build",
                          "t_c_refcov", "t_c_mat", "t_c_stages",
                          "t_c_eka", "t_c_comps", "t_c_refends",
                          "t_c_cyc", "t_c_compress", "t_c_cleanup",
                          "t_c_findrep"), ns):
            stats[k_] = float(v) / 1e9
    return ShardRunResult(variants_by_window, fallback, cls, times,
                          reads_n, tot_jobs, tot_dp)


def _parse_varbuf(buf: bytes, windows, map_win, variants_by_window,
                  lr_mode: bool = False) -> None:
    """Unpack the packed Var wire format (v1: 128-byte header with HP
    triples + BX set lengths; lancet_native.cc pack_vars) into Variant
    objects."""
    from .variant import Variant

    off = 0
    nv = len(buf)
    while off < nv:
        (win, pos, code, prev_ref, prev_alt, _ver, kmer, l_ref, l_alt,
         l_str) = struct.unpack_from("<iqBBBBiiii", buf, off)
        cov = struct.unpack_from("<8i", buf, off + 32)
        hp = struct.unpack_from("<12i", buf, off + 64)
        bl = struct.unpack_from("<4i", buf, off + 112)
        off += 128
        ref = buf[off : off + l_ref].decode("latin-1")
        off += l_ref
        alt = buf[off : off + l_alt].decode("latin-1")
        off += l_alt
        str_tag = buf[off : off + l_str].decode("latin-1")
        off += l_str
        bxs = []
        for q in range(4):
            bxs.append(buf[off : off + bl[q]].decode("latin-1"))
            off += bl[q]
        gwin = map_win(win)
        v = Variant(
            lr_mode=lr_mode, chrom=windows[gwin].chrom, pos=pos,
            ref_str=ref, alt_str=alt,
            rcn=(cov[0], cov[1]), rct=(cov[2], cov[3]),
            acn=(cov[4], cov[5]), act=(cov[6], cov[7]),
            hprn=hp[0:3], hprt=hp[3:6], hpan=hp[6:9], hpat=hp[9:12],
            prev_bp_ref=chr(prev_ref), prev_bp_alt=chr(prev_alt),
            kmer=kmer, str_tag=str_tag, code=chr(code),
            bx_ref_n=bxs[0], bx_ref_t=bxs[1], bx_alt_n=bxs[2],
            bx_alt_t=bxs[3])
        variants_by_window.setdefault(gwin, []).append(v)


def run_shards(cfg, windows, tumor, normal, stats: dict | None = None,
               mesh=None):
    """Run every window natively. `windows` is the full ordered list
    (shard-concatenated, lexicographic within shard) — the VariantDB add
    order. `tumor`/`normal` are open readers (for refid lookup only).
    `mesh`, if given, shards the device DP batches over that
    jax.sharding.Mesh (parallel.mesh.mesh_batch_align_async).
    Returns ShardRunResult or None when the native plane is unavailable.
    """
    import time as _time

    lib = _lib()
    if not lib:
        return None

    n = len(windows)
    tmap = {nm: i for i, (nm, _) in enumerate(tumor.references)}
    nmap = {nm: i for i, (nm, _) in enumerate(normal.references)}
    refid_t = np.array([tmap.get(w.chrom, -1) for w in windows], np.int32)
    refid_n = np.array([nmap.get(w.chrom, -1) for w in windows], np.int32)
    starts = np.array([w.refstart for w in windows], np.int64)
    ends = np.array([w.refend for w in windows], np.int64)
    raw_blob, raw_off = _blob([w.rawseq.encode("latin-1") for w in windows])

    # Device repeat gates (micro._precompute_gates) are OFF by default for
    # the native runner: the eager [windows x ks] device sweep computes
    # ~46 gates per window, while the native k-loop consults them lazily —
    # one cheap hash scan per *attempted* k of an *active* window (most
    # windows never reach the k loop; most active windows succeed at
    # min_k). Profiling on the 5,195-window bench corpus: 6.2s eager
    # device sweep vs <0.1s lazy native scans. On the device graph path
    # (run_shards_device) the device gates DO win — they run lazily per
    # pending k inside devicepipe.run_device_graph. LANCET_GATES=1
    # re-enables the eager sweep here for A/B measurement only.
    t0 = _time.perf_counter()
    gates_arr = np.zeros(0, np.uint8)
    exact_arr = np.zeros(0, np.uint8)
    n_k = 0
    use_gates = bool(os.environ.get("LANCET_GATES"))
    if use_gates:
        from ..device.repeats import repeat_gates

        ks = list(range(cfg.min_k, cfg.max_k + 1, 2))
        n_k = len(ks)
        gates_arr = np.zeros((n, n_k), np.uint8)
        exact_arr = np.zeros(n, np.uint8)
        CH = 512
        for i in range(0, n, CH):
            chunk = windows[i : i + CH]
            g, e = repeat_gates([w.rawseq for w in chunk], ks,
                                cfg.max_mismatch, with_exact=True)
            gates_arr[i : i + len(chunk)] = np.asarray(g, np.uint8)
            exact_arr[i : i + len(chunk)] = np.asarray(e, np.uint8)[:, n_k - 1]
        gates_arr = np.ascontiguousarray(gates_arr.reshape(-1))
    if stats is not None:
        stats["t_gates"] = _time.perf_counter() - t0

    icfg = np.array([
        cfg.min_k, cfg.max_k, cfg.min_qual_trim, cfg.min_qual_call,
        cfg.min_map_qual, cfg.max_avg_cov, cfg.max_delta_as_xs,
        int(cfg.xa_filter), int(cfg.primary_alignment_only),
        int(cfg.active_regions), cfg.filters.min_alt_cnt_tumor,
        cfg.low_cov_threshold, cfg.max_tip_len, cfg.dfs_limit,
        cfg.max_indel_len, cfg.max_mismatch, cfg.max_unit_len,
        cfg.min_report_units, cfg.min_report_len, cfg.dist_from_str,
        int(cfg.lr_mode)],
        np.int64)
    dcfg = np.array([cfg.min_cov_ratio, float(cfg.cov_threshold)], np.float64)

    rgs = b""
    if getattr(cfg, "rg_file", ""):
        with open(cfg.rg_file) as f:
            toks = f.read().split()
        if toks:
            rgs = "\n".join(toks).encode()

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)

    def p(a, t):
        return a.ctypes.data_as(t) if a.size else ctypes.cast(None, t)

    n_threads = max(1, os.cpu_count() or 1)
    cache_span = int(os.environ.get("LANCET_CACHE_SPAN", 8 << 20))

    # Genomic groups for the host/device pipeline: while the device aligns
    # group g's DP batch (GIL released in jax waits), the next group's
    # native host stage runs in a background thread (GIL released in
    # ctypes). Groups are genomically contiguous so each lsr_run call keeps
    # the shared-cache locality; output indices are global, so reassembly
    # is order-exact regardless of grouping.
    order = sorted(range(n), key=lambda i: (int(refid_t[i]), int(starts[i])))
    group_span = int(os.environ.get(
        "LANCET_GROUP_SPAN",
        max(64 << 10, (int(ends.max()) - int(starts.min())) // 8 + 1
            if n else 64 << 10)))
    groups: list[list[int]] = []
    for i in order:
        if (groups and int(refid_t[groups[-1][0]]) == int(refid_t[i])
                and int(ends[i]) - int(starts[groups[-1][0]]) <= group_span):
            groups[-1].append(i)
        else:
            groups.append([i])

    class _NativeFailed(Exception):
        pass

    def native_stage(idxs):
        """lsr_run for one group (GIL released during the C++ call)."""
        g = np.asarray(idxs, np.int64)
        sub_raw, sub_off = _blob([windows[i].rawseq.encode("latin-1")
                                  for i in idxs])
        sub_gates = (np.ascontiguousarray(
            gates_arr.reshape(n, n_k)[g].reshape(-1)) if n_k
            else np.zeros(0, np.uint8))
        sub_exact = exact_arr[g] if n_k else np.zeros(0, np.uint8)
        rt = np.ascontiguousarray(refid_t[g])
        rn = np.ascontiguousarray(refid_n[g])
        st = np.ascontiguousarray(starts[g])
        en = np.ascontiguousarray(ends[g])
        h = lib.lsr_run(
            cfg.tumor_bam.encode(), cfg.normal_bam.encode(), len(idxs),
            p(rt, i32p), p(rn, i32p), p(st, i64p), p(en, i64p),
            p(sub_raw, u8p), p(sub_off, i64p),
            p(sub_gates, u8p) if n_k else ctypes.cast(None, u8p),
            p(sub_exact, u8p) if n_k else ctypes.cast(None, u8p), n_k,
            p(icfg, i64p), p(dcfg, f64p), rgs, n_threads, cache_span,
            ctypes.cast(None, u8p))
        return h

    from .variant import Variant

    variants_by_window: dict[int, list] = {}
    fallback: set[int] = set()
    cls = np.zeros((n, 9), np.int64)
    times = np.zeros(n, np.float64)
    reads = np.zeros(n, np.int64)
    tot_jobs = 0
    tot_dp = 0
    t_host = t_dp = t_fin = t_dp_wait = 0.0
    t_dp_prep = t_dp_send = 0.0
    zero3 = (0, 0, 0)

    def dispatch_dp(h, idxs):
        """Extract DP pairs and enqueue the device fill without blocking
        (the device computes while the next group's host stage runs)."""
        nonlocal tot_jobs, tot_dp, t_dp
        if lib.lsr_status(h) != STATUS_OK:
            raise _NativeFailed()
        n_jobs = lib.lsr_n_jobs(h)
        meta = np.zeros((n_jobs, 6), np.int64)
        if n_jobs:
            lib.lsr_job_meta(h, p(meta.reshape(-1), i64p))
        dp_idx = np.nonzero(meta[:, 4])[0] if n_jobs else np.zeros(0, int)

        t0 = _time.perf_counter()
        pairs = []
        for i in dp_idx:
            w = windows[idxs[int(meta[i, 0])]]
            src, dist = int(meta[i, 1]), int(meta[i, 2])
            pathseq = ctypes.string_at(
                lib.lsr_job_path(h, int(i)), int(meta[i, 3])).decode(
                "latin-1")
            pairs.append((w.rawseq[src : src + dist], pathseq))
        t_mid = _time.perf_counter()
        if stats is not None and pairs:
            # sample real DP jobs for the on-card parity check
            samples = stats.setdefault("dp_samples", [])
            if len(samples) < 64:
                step = max(1, len(pairs) // (64 - len(samples)))
                samples.extend(pairs[::step][: 64 - len(samples)])
        state = None
        if pairs:
            if mesh is not None:
                from ..parallel.mesh import mesh_batch_align_async

                state = mesh_batch_align_async(pairs, mesh)
            else:
                from ..device.align_batch import batch_align_async

                state = batch_align_async(pairs)
        nonlocal t_dp_prep, t_dp_send
        t1 = _time.perf_counter()
        t_dp_prep += t_mid - t0
        t_dp_send += t1 - t_mid
        t_dp += t1 - t0
        tot_jobs += int(n_jobs)
        tot_dp += len(pairs)
        return state

    def finish(h, idxs, dp_state):
        nonlocal t_dp, t_fin, t_dp_wait
        t0 = _time.perf_counter()
        from ..device.align_batch import batch_align_wait

        aligned = batch_align_wait(dp_state)
        t_dp_wait += _time.perf_counter() - t0
        t_dp += _time.perf_counter() - t0

        t0 = _time.perf_counter()
        ra_blob, ra_off = _blob([a.encode("latin-1") for a, _ in aligned])
        pa_blob, pa_off = _blob([b.encode("latin-1") for _, b in aligned])
        lib.lsr_finish(h, p(ra_blob, u8p), p(ra_off, i64p), p(pa_blob, u8p),
                       p(pa_off, i64p))

        nv = lib.lsr_varbuf_size(h)
        buf = ctypes.string_at(lib.lsr_varbuf(h), nv) if nv else b""
        _parse_varbuf(buf, windows, lambda wi: idxs[wi],
                      variants_by_window, lr_mode=cfg.lr_mode)

        m = len(idxs)
        gflags = np.zeros(m, np.uint8)
        greads = np.zeros(m, np.int64)
        gtimes = np.zeros(m, np.float64)
        gcls = np.zeros((m, 9), np.int64)
        lib.lsr_win_out(h, p(gflags, u8p), p(greads, i64p), p(gtimes, f64p),
                        p(gcls.reshape(-1), i64p))
        ga = np.asarray(idxs, np.int64)
        cls[ga] = gcls
        times[ga] = gtimes
        reads[ga] = greads
        for li in np.nonzero(gflags)[0]:
            fallback.add(int(idxs[int(li)]))
        t_fin += _time.perf_counter() - t0

    import concurrent.futures as _cf

    handles: list = []
    try:
        lib.lsr_stage_reset()
        t_all = _time.perf_counter()
        with _cf.ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(native_stage, groups[0]) if groups else None
            pending = []  # (handle, idxs, dp_state): device DP in flight
            for gi in range(len(groups)):
                t0 = _time.perf_counter()
                h = fut.result()
                handles.append(h)
                t_host += _time.perf_counter() - t0
                if gi + 1 < len(groups):
                    fut = ex.submit(native_stage, groups[gi + 1])
                # enqueue this group's DP; the device drains the queue
                # while later groups' host stages run
                pending.append((h, groups[gi], dispatch_dp(h, groups[gi])))
            for h, idxs, dp_state in pending:
                finish(h, idxs, dp_state)
                handles.remove(h)
                lib.lsr_free(h)
    except _NativeFailed:
        for h in handles:
            lib.lsr_free(h)
        return None

    if stats is not None:
        stats["t_host"] = t_host  # blocked-on-native time (overlap hides it)
        stats["t_pipeline"] = _time.perf_counter() - t_all
        stats["t_dp"] = t_dp
        stats["t_dp_wait"] = t_dp_wait
        stats["t_dp_prep"] = t_dp_prep
        stats["t_dp_send"] = t_dp_send
        stats["t_finish"] = t_fin
        stats["n_jobs"] = tot_jobs
        stats["n_dp"] = tot_dp
        stats["n_groups"] = len(groups)
        ns = np.zeros(16, np.int64)
        lib.lsr_stage_ns(p(ns, i64p))
        for k, v in zip(("t_c_fetch", "t_c_triage", "t_c_extract",
                         "t_c_kloop", "t_c_scan", "t_c_build",
                         "t_c_refcov", "t_c_mat", "t_c_stages",
                         "t_c_eka", "t_c_comps", "t_c_refends", "t_c_cyc",
                         "t_c_compress", "t_c_cleanup", "t_c_findrep"), ns):
            stats[k] = float(v) / 1e9
    return ShardRunResult(variants_by_window, fallback, cls, times,
                          reads, tot_jobs, tot_dp)
