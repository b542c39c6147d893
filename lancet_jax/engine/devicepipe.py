"""Device graph-engine driver: batches windows through the device per-k
assembly pipeline (device.dbg + device.pipeline) and assembles PathJobs.

Replaces the native C++ k-loop for the common case — the colored-DBG
build, cleanup, and path cover run on the device as fixed-shape batched
kernels (SURVEY.md §7); windows that exceed the shape caps or hit the
reference's irregular corners (mate-overlap dedup, k > 63, compress
loop-backs, map-rehash hazards) fall back to the native engine, which
replays them exactly.

Reference flow: Microassembler.cc:73-249 (processGraph k-retry loop).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..device.dbg import S_NML, S_REF, S_TMR
from .extract import PathJob

_BASES = np.frombuffer(b"ACGTN", np.uint8)

# Persistent XLA compile cache: one fixed directory inside the checkout
# (listed in .gitignore). The path is part of JAX's cache key, so it must
# not move between runs.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")

_CACHE_SET = False


def compile_cache_dir(backend: str) -> str | None:
    """Directory of the persistent compile cache for `backend`.

    JAX_COMPILATION_CACHE_DIR wins when set (JAX reads it itself; nothing
    else is set in code). Otherwise GPU runs use CACHE_DIR. CPU runs keep
    in-memory jit caches only: XLA:CPU AOT cache writes have aborted
    (inside put_executable_and_time) on hosts whose CPU features differ
    from the AOT target, and CPU runs are tests, which gain little."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return CACHE_DIR if backend == "gpu" else None


def _enable_compile_cache():
    """Point JAX's persistent compilation cache at compile_cache_dir():
    the per-k pipeline executables are large, and cached ones make every
    rerun skip compilation."""
    global _CACHE_SET
    if _CACHE_SET:
        return
    _CACHE_SET = True

    # XLA:CPU's LLVM passes recurse deeply on the large graph programs;
    # the default 8 MB stack intermittently overflows (SIGSEGV inside
    # backend_compile_and_load). Linux grows the main-thread stack on
    # demand up to RLIMIT_STACK, so raise it before compiles run.
    try:
        import resource

        resource.setrlimit(
            resource.RLIMIT_STACK,
            (resource.RLIM_INFINITY, resource.RLIM_INFINITY))
    except (ValueError, OSError):
        pass

    import jax

    d = compile_cache_dir(jax.default_backend())
    if d is not None and not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)


@dataclass
class WindowTask:
    """One window's inputs + evolving per-k state."""

    widx: int  # caller's window index
    reads: list  # [(seq, qual, sample, strand, frag, order)] post-trim
    rawseq: str
    totalreadbp: int
    refchr: str = ""
    refstart: int = 0
    # evolving trim state (stale-trim quirk: the k's index uses the
    # previous attempt's trim)
    seq_off: int = 0
    seq_len: int = 0
    done: bool = False
    fallback: bool = False
    jobs: list | None = None  # emitted PathJobs (in order)
    k_done: int = 0
    min_bucket: int = 0  # shape-bucket floor (raised by cap promotion)

    def __post_init__(self):
        self.seq_len = len(self.rawseq)
        self.jobs = []


# shape buckets: (R, L, N, E). Lraw/W fixed per run. The first bucket
# carries the common case (low-coverage windows) with a ~3x smaller
# sort/segment problem via the read cap R; N must clear ~Mraw (a full
# window's ref pseudo-read alone contributes ~1100 distinct mers, so
# N < 1100 would promote EVERY window). Cap overflows promote to the
# next bucket at the same k (run_device_graph) instead of falling back
# to the native plane.
_BUCKETS = (
    (48, 160, 1536, 3840),
    (192, 160, 1536, 3840),
    (512, 112, 4096, 10240),
    (768, 160, 4096, 10240),
)
_CMAX = 8
_D = 12


def _cfg_scalars(cfg, K):
    return dict(cov_threshold=float(cfg.cov_threshold),
                low_cov_threshold=int(cfg.low_cov_threshold),
                min_cov_ratio=float(cfg.min_cov_ratio),
                max_tip_len=int(cfg.max_tip_len),
                max_link_len=int(cfg.max_link_len(K)),
                max_unit_len=int(cfg.max_unit_len),
                min_report_units=int(cfg.min_report_units),
                min_report_len=int(cfg.min_report_len),
                dist_from_str=int(cfg.dist_from_str))


def _bucket_for(task, Lraw):
    if len(task.rawseq) > Lraw:
        return None
    need_r = len(task.reads)
    need_l = max((len(s) for s, *_ in task.reads), default=0)
    for bi, (R, L, N, E) in enumerate(_BUCKETS):
        if need_r <= R and need_l <= L:
            return bi
    return None


def run_device_graph(tasks: list[WindowTask], cfg, stats: dict | None = None,
                     W: int | None = None, Lraw: int = 1152,
                     mesh=None) -> None:
    """Process tasks in place: fills .jobs/.done/.fallback per window.

    Jobs carry everything engine.extract.finish_path needs; callers
    align + finish them in task order. `mesh` shards the window batch
    axis of every pipeline step over a jax.sharding.Mesh.

    Structure (one k at a time, the reference's retry ladder,
    Microassembler.cc:109-235):
    - windows are grouped into shape buckets by read count; a window
      that overflows its bucket's node/edge caps is PROMOTED to the next
      bucket and re-attempted at the same k (only semantic corners --
      mate-overlap candidates, map-rehash hazards, fixed-cap overflows --
      replay natively);
    - chunks are depth-1 pipelined: chunk i+1's build is dispatched
      before chunk i's host work (rank round trip, job finish) runs, so
      the device computes while the host packs/finishes (the overlap
      lesson of run_shards, shardrun.py)."""
    _enable_compile_cache()
    if W is None:
        # windows per chunk; LANCET_DEVGRAPH_W overrides for A/B runs
        W = int(os.environ.get("LANCET_DEVGRAPH_W", "32"))
    if mesh is not None:
        ndev = int(mesh.devices.size)
        W = max(ndev, W // ndev * ndev)  # shardable on the window axis
    from ..device.repeats import repeat_gates

    # device k ladder: multi-word packed mers carry k <= 63 (4x uint32
    # words; the native rank kernel's 128-bit limit). The reference
    # ladder tops at 101 (Lancet.hh:52-73); windows still cycling past
    # 63 replay natively (and on the hard corpus none succeed below 101
    # that need k > 63 -- BENCH k_histogram tops at 41).
    ks = [k for k in range(cfg.min_k, cfg.max_k + 1, 2) if k <= 63]

    causes = None
    if stats is not None:
        causes = stats.setdefault("dev_fallback_causes", {})

    def _cause(key, n=1):
        if causes is not None and n:
            causes[key] = causes.get(key, 0) + n

    # host-side shape screening: initial bucket floor per task
    pending: list[WindowTask] = []
    for t in tasks:
        bi = _bucket_for(t, Lraw)
        if bi is None:
            t.fallback = True
            _cause("shape_screen")
        else:
            t.min_bucket = bi
            pending.append(t)

    import sys as _sys
    import time as _time
    progress = bool(os.environ.get("LANCET_PROGRESS"))

    n_attempts = 0
    for K in ks:
        if not pending:
            break
        if progress:
            print(f"[devgraph] k={K} pending={len(pending)}"
                  f" t={_time.strftime('%H:%M:%S')}",
                  file=_sys.stderr, flush=True)
        # reference-repeat gate for this k, batched on device
        # (Microassembler.cc:118-131): gated windows skip to next k
        gates = np.asarray(repeat_gates(
            [t.rawseq for t in pending], [K], cfg.max_mismatch))[:, 0]
        attempt = [t for t, g in zip(pending, gates) if not g]
        next_pending = [t for t, g in zip(pending, gates) if g]
        while attempt:  # promotion rounds (bounded by len(_BUCKETS))
            # chunks are filled ACROSS bucket boundaries (sorted by
            # bucket, each chunk built at its max member's shapes):
            # per-bucket grouping left most chunks partially filled and
            # multiplied dispatches — the pack waste of a small-bucket
            # window riding a bigger bucket is far cheaper than an extra
            # ~0.5s chunk dispatch
            attempt.sort(key=lambda t: t.min_bucket)
            promoted: list[WindowTask] = []
            inflight = None
            for lo in range(0, len(attempt), W):
                chunk = attempt[lo : lo + W]
                # tail chunks (higher-k retries shrink fast) run at a
                # small W tier: chunk cost scales with W, so an 8-wide
                # executable beats padding 3 windows into 32 lanes
                Wc = W
                if mesh is None and len(chunk) <= 8 <= W:
                    Wc = 8
                # smallest bucket that satisfies every member: >= each
                # member's min_bucket (its N/E promotion floor; N/E/R
                # grow with the index) AND fits the chunk's read
                # count/length (L is NOT monotone across buckets)
                bi_floor = max(t.min_bucket for t in chunk)
                need_r = max(len(t.reads) for t in chunk)
                need_l = max((len(s) for t in chunk
                              for s, *_ in t.reads), default=0)
                bi = next(i for i in range(bi_floor, len(_BUCKETS))
                          if _BUCKETS[i][0] >= need_r
                          and _BUCKETS[i][1] >= need_l)
                n_attempts += 1
                st = _dispatch_chunk(chunk, cfg, K, Wc, bi, Lraw,
                                     mesh, stats)
                if inflight is not None:
                    _complete_chunk(inflight, cfg, K, mesh, stats,
                                    promoted, next_pending)
                inflight = st
            if inflight is not None:
                _complete_chunk(inflight, cfg, K, mesh, stats,
                                promoted, next_pending)
            attempt = promoted
        pending = next_pending
    for t in pending:
        t.fallback = True  # ran out of device ks (k > 63): native ladder
    _cause("k_gt_63", len(pending))
    if stats is not None:
        stats["n_dev_attempts"] = stats.get("n_dev_attempts", 0) \
            + n_attempts


def _dispatch_chunk(chunk, cfg, K, W, bi, Lraw, mesh, stats=None):
    """Pack one chunk and dispatch its (async) build. Returns the
    in-flight state consumed by _complete_chunk."""
    import time as _time

    from ..device.dbg import build_k
    from ..device.pack import WindowBatch, pack_chunk

    R, L, N, E = _BUCKETS[bi]
    t0 = _time.perf_counter()
    batch = WindowBatch(W, R, L, Lraw)
    pack_chunk(batch, chunk)

    # under a mesh, the build is shard_mapped on the window axis (each
    # device builds its window shard's graphs; no collectives -- see
    # parallel.mesh deadlock discipline)
    arrs = (batch.bases, batch.quals, batch.rlen, batch.rsample,
            batch.rstrand, batch.rfrag, batch.rorder, batch.raw,
            batch.rawlen, batch.seq_off, batch.seq_len, batch.totalreadbp,
            batch.window_ok)
    if mesh is None:
        b = build_k(
            K, *arrs,
            N=N, E=E, D=_D, Lraw=Lraw, min_qual_call=cfg.min_qual_call,
            low_cov_threshold=cfg.low_cov_threshold,
            min_cov_ratio=cfg.min_cov_ratio)
    else:
        from ..parallel.mesh import shard_build_k

        bfn = shard_build_k(mesh, K, (N, E, _D, Lraw, cfg.min_qual_call,
                                      cfg.low_cov_threshold,
                                      cfg.min_cov_ratio))
        b = bfn(*arrs)
    if stats is not None:
        stats["t_dg_pack"] = stats.get("t_dg_pack", 0.0) \
            + (_time.perf_counter() - t0)
    return dict(chunk=chunk, batch=batch, b=b, bi=bi, W=W)


def _complete_chunk(st_if, cfg, K, mesh, stats, promoted, retry):
    """Finish an in-flight chunk: rank round trip, assemble, classify.
    Shape-cap overflows go to `promoted` (same k, next bucket); cycle/
    repeat aborts go to `retry` (next k); semantic corners mark
    .fallback for the native replay."""
    import time as _time

    import jax.numpy as jnp

    chunk, batch, b = st_if["chunk"], st_if["batch"], st_if["b"]
    bi, W = st_if["bi"], st_if["W"]
    R, L, N, E = _BUCKETS[bi]

    def mark(key, t0):
        t1 = _time.perf_counter()
        if stats is not None:
            stats[key] = stats.get(key, 0.0) + (t1 - t0)
        return t1

    # host round trip: creation-order packed mers -> map-order ranks
    t0 = _time.perf_counter()
    mers_w = [np.asarray(x) for x in b["mers_w"]]
    n_nodes = np.asarray(b["n_nodes"])
    n_edges = np.asarray(b["n_edges"])
    b_fallback = np.asarray(b["fallback"])
    mate_cand = np.asarray(b["mate_cand"])
    t0 = mark("t_dg_build", t0)  # build exec + D2H of the mer tables

    # slice-to-fit: node/edge tables are creation-order dense, so when
    # every live lane's graph fits a smaller tier the assemble runs at
    # those shapes via free in-graph slicing — the cleanup fixpoints'
    # cost is dominated by minor-axis gathers over [W, NI], which shrink
    # proportionally. (The shape buckets pick N by READ count; a 40x
    # window has ~450 reads but only ~1.2k distinct mers.)
    live = np.asarray(batch.window_ok) & ~b_fallback
    Nc, Ec = N, E
    if live.any():
        nn_max = int(n_nodes[live].max())
        ne_max = int(n_edges[live].max())
        for tn, te in _TIERS:
            if tn < N and te < E and nn_max <= tn and ne_max <= te:
                Nc, Ec = tn, te
                break
    ranks, rank_bad = _map_ranks_batch(
        [m[:, :Nc] for m in mers_w], n_nodes, batch.window_ok, K, W, Nc)
    t0 = mark("t_dg_ranks", t0)

    tA = _time.perf_counter()
    out = _assemble(b, jnp.asarray(ranks), K, N, E, Nc, Ec,
                    jnp.asarray(batch.raw), _cfg_scalars(cfg, K),
                    int(cfg.dfs_limit) or (1 << 30),
                    int(cfg.max_indel_len), int(cfg.max_mismatch), mesh)
    tB = _time.perf_counter()
    # two-phase fetch: the job tensors (pathseq/covT/covN/span) are
    # [W, JMAX, LP]-shaped but most windows emit 1-4 jobs of ~600bp —
    # fetch the small fields first, then only the used [*, :jmax, :lmax]
    # corner of the big ones (the full cov payload is ~10 MB per chunk,
    # the used corner ~1 MB)
    big = ("pathseq", "covT", "covN", "span")
    res = {k: np.asarray(v) for k, v in out.items() if k not in big}
    tC = _time.perf_counter()
    ok_lane = (np.asarray(batch.window_ok) & ~b_fallback & ~mate_cand
               & ~rank_bad & ~res["fallback"])
    nsel = np.where(ok_lane, res["n_sel"], 0)
    jmax = int(nsel.max()) if len(nsel) else 0
    if jmax > 0:
        JMAX = out["pathseq"].shape[1]
        LP = out["pathseq"].shape[2]
        jm = min(JMAX, -(-jmax // 2) * 2)
        jcols = np.arange(JMAX)[None, :jm]
        lp_used = np.where((jcols < nsel[:, None]), res["lp"][:, :jm], 0)
        lmax = int(lp_used.max())  # <= LP (over_lp lanes are fallback)
        lm = min(LP, -(-max(lmax, 1) // 256) * 256)
        for k2 in big:
            lw = lm + 1 if k2 == "span" else lm
            res[k2] = np.asarray(out[k2][:, :jm, :lw])
    if stats is not None:
        tD = _time.perf_counter()
        stats["t_dg_a_dispatch"] = stats.get("t_dg_a_dispatch", 0.0) \
            + (tB - tA)
        stats["t_dg_a_exec"] = stats.get("t_dg_a_exec", 0.0) + (tC - tB)
        stats["t_dg_a_fetch"] = stats.get("t_dg_a_fetch", 0.0) + (tD - tC)
    t0 = mark("t_dg_assemble", t0)

    # node/edge/degree cap overflow (not the mate-overlap corner): the
    # next bucket's caps may fit -- promote instead of losing the window
    # to the native plane
    shape_over = b_fallback & ~mate_cand
    last_bucket = bi + 1 >= len(_BUCKETS)
    causes = (stats.setdefault("dev_fallback_causes", {})
              if stats is not None else None)

    def _cause(key):
        if causes is not None:
            causes[key] = causes.get(key, 0) + 1

    for w, t in enumerate(chunk):
        if not batch.window_ok[w] or rank_bad[w] or mate_cand[w]:
            t.fallback = True
            _cause("mate_overlap" if mate_cand[w] else
                   "rank_rehash" if rank_bad[w] else "non_acgt")
            continue
        if res["fallback"][w]:
            if shape_over[w] and not last_bucket:
                t.min_bucket = bi + 1
                promoted.append(t)
            else:
                t.fallback = True
                _cause("shape_caps" if shape_over[w] else "pipeline_caps")
            continue
        _finish_window(t, w, res, K, cfg)
        if not t.done:
            retry.append(t)
    mark("t_dg_finish", t0)


def _map_ranks_batch(mers_w, n_nodes, window_ok, K, W, N):
    """Creation-order packed mers -> libstdc++ map-order ranks plus
    rehash-headroom flags for the whole chunk in one native call (no
    Python string materialization; lancet_native.cc lmo_ranks_batch).
    Falls back to the pure-Python CppUnorderedMap emulation when the
    toolchain is unavailable. A window whose slack cannot absorb the
    fake source/sink inserts (Graph.cc:2156-2227) is flagged rank_bad
    (iteration order could change via a rehash) and replays natively."""
    ranks = np.full((W, N), 1 << 28, np.int32)
    rank_bad = np.zeros(W, bool)
    ok = np.asarray(window_ok, bool)
    nn = np.where(ok, np.minimum(n_nodes, N), 0).astype(np.int64)
    if not nn.any():
        return ranks, rank_bad
    mask = np.arange(N)[None, :] < nn[:, None]
    offs = np.zeros(W + 1, np.int64)
    np.cumsum(nn, out=offs[1:])
    # assemble 64-bit halves from the little-endian uint32 words
    def word(i):
        return (mers_w[i].astype(np.uint64) if i < len(mers_w)
                else np.uint64(0))

    lo64 = word(0) | (word(1) << np.uint64(32))
    hi64 = word(2) | (word(3) << np.uint64(32))
    try:
        from ..native import lmo_ranks_batch

        flat_r, slack = lmo_ranks_batch(
            np.broadcast_to(hi64, lo64.shape)[mask], lo64[mask], offs, K)
        ranks[mask] = flat_r
        rank_bad = ok & (nn > 0) & (slack < 2 * _CMAX)
    except Exception:
        from ..device.pack import map_ranks, unpack_mers_words

        for w in range(W):
            if not ok[w]:
                continue
            mers = unpack_mers_words(
                np.broadcast_to(hi64, lo64.shape)[w][: nn[w]],
                lo64[w][: nn[w]], K)
            r, slack = map_ranks(mers)
            ranks[w, : nn[w]] = r
            if slack < 2 * _CMAX:
                rank_bad[w] = True
    return ranks, rank_bad


_ASSEMBLE_CACHE: dict = {}

# assemble shape tiers (ascending): the graph-size shapes the jitted
# attempt tail can run at after slice-to-fit, independent of the read-
# count bucket that sized the build
_TIERS = ((1536, 3840),)


def _assemble(b, ranks, K, N, E, Nc, Ec, raw, cfg_s, dfs_limit,
              max_indel, max_mismatch, mesh):
    """Jitted tail of the attempt: stages + path cover + materialize.
    One executable per (K, shapes, config scalars) — cached. (Nc, Ec)
    <= (N, E) are the slice-to-fit shapes the attempt runs at."""
    import jax

    from ..parallel.mesh import mesh_key

    key = (K, N, E, Nc, Ec, tuple(sorted(cfg_s.items())), dfs_limit,
           max_indel, max_mismatch, mesh_key(mesh))
    fn = _ASSEMBLE_CACHE.get(key)
    if fn is None:
        import jax.numpy as jnp

        from ..device import pipeline

        def impl(b, ranks, raw):
            if Nc < N:
                b = dict(b)
                for key2 in ("counts", "totq", "mq", "alive",
                             "is_tumor", "is_normal"):
                    b[key2] = b[key2][:, :Nc]
                b["mers_w"] = tuple(m[:, :Nc] for m in b["mers_w"])
                for key2 in ("edge_src", "edge_dst", "edge_dir",
                             "edge_exists"):
                    b[key2] = b[key2][:, :Ec]
                # dead lanes may project node ids past the tier; live
                # lanes have all ids < n_nodes <= Nc
                b["nid_proj"] = jnp.where(b["nid_proj"] < Nc,
                                          b["nid_proj"], -1)
            st, res = pipeline.run_attempt(b, ranks, K, Nc, Ec, _CMAX,
                                           cfg_s)
            # run_attempt returns the COMPACT post-cleanup state:
            # regular items in [0, NCR), anchors at NCR+2c / NCR+2c+1
            NCR = pipeline.NCR_DEFAULT
            NIc = NCR + 2 * _CMAX
            paths = pipeline.path_cover(
                st, res, K, NCR, NIc, _CMAX, res["ends"]["dist"],
                dfs_limit, max_indel)
            jobs = pipeline.materialize_jobs(
                st, b, paths, res, K, Nc, NIc, _CMAX, raw, max_mismatch)
            out = dict(jobs)
            out["cyc1"] = res["cyc1"]
            out["cyc2"] = res["cyc2"]
            out["anchored"] = res["ends"]["anchored"]
            out["numcomp"] = res["numcomp"]
            out["asrc"] = res["ends"]["src_pos"]
            out["adist"] = res["ends"]["dist"]
            out["fallback"] = res["fallback"] | jobs["fallback"]
            out["refcov"] = b["refcov"].astype(jnp.int16)  # cov <= R
            return out

        if mesh is not None:
            from ..parallel.mesh import shard_windows_jit

            fn = shard_windows_jit(impl, mesh)
        else:
            fn = jax.jit(impl)
        _ASSEMBLE_CACHE[key] = fn
    return fn(b, ranks, raw)


def _finish_window(t: WindowTask, w: int, res, K, cfg):
    """Replay the per-component abort logic and emit PathJobs."""
    numcomp = int(res["numcomp"][w])
    n_sel = int(res["n_sel"][w])
    sel_comp = res["sel_comp"][w]
    raw_n = len(t.rawseq)
    refcov = res["refcov"][w][:raw_n]
    tumor_cov = np.zeros((raw_n, 10), np.int32)
    normal_cov = np.zeros((raw_n, 10), np.int32)
    tumor_cov[:, 0] = refcov[:, 0]
    tumor_cov[:, 1] = refcov[:, 1]
    normal_cov[:, 0] = refcov[:, 2]
    normal_cov[:, 1] = refcov[:, 3]

    abort_comp = 0  # 0 = none
    for c in range(1, min(numcomp, _CMAX) + 1):
        anch = bool(res["anchored"][w][c - 1])
        if anch and bool(res["cyc1"][w][c - 1]):
            abort_comp = c
            break
        if anch and bool(res["cyc2"][w][c - 1]):
            abort_comp = c
            break
        # repeat gate: first selected path of this comp with is_rep
        if anch:
            hit = False
            for j in range(n_sel):
                if int(sel_comp[j]) == c and bool(res["is_rep"][w][j]):
                    hit = True
                    break
            if hit:
                abort_comp = c
                break

    emit_before = abort_comp if abort_comp else min(numcomp, _CMAX) + 1

    # trim state: last anchored comp among the processed ones
    last_anch = 0
    processed = abort_comp if abort_comp else min(numcomp, _CMAX)
    for c in range(1, processed + 1):
        if bool(res["anchored"][w][c - 1]):
            last_anch = c
    if last_anch:
        t.seq_off = int(res["asrc"][w][last_anch - 1])
        t.seq_len = int(res["adist"][w][last_anch - 1])

    for j in range(n_sel):
        c = int(sel_comp[j])
        if c >= emit_before:
            continue
        lp = int(res["lp"][w][j])
        seq = _BASES[np.clip(res["pathseq"][w][j][:lp], 0, 4)].tobytes()
        covT = np.zeros((lp, 10), np.int32)
        covN = np.zeros((lp, 10), np.int32)
        covT[:, :4] = res["covT"][w][j][:lp]
        covN[:, :4] = res["covN"][w][j][:lp]
        src = int(res["src_pos"][w][j])
        dist = int(res["dist"][w][j])
        job = PathJob(
            refchr=t.refchr, refstart=t.refstart,
            trim5=int(res["trim5"][w][j]),
            refseq=t.rawseq[src : src + dist],
            pathseq=seq.decode("latin-1"), K=K,
            covN=covN, covT=covT,
            tumor_span=res["span"][w][j][: lp + 1].copy(),
            ref_cov_nml=normal_cov, ref_cov_tmr=tumor_cov,
            needs_dp=bool(res["needs_dp"][w][j]), lr_mode=False)
        t.jobs.append(job)

    t.done = not abort_comp
    t.k_done = K if t.done else 0
