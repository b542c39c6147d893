"""Per-shard window worker: triage, read extraction, and the self-tuning-k
assembly driver (ref: src/Microassembler.{hh,cc})."""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

from .graph import CODE_BASTARD, CODE_MAPPED, Graph
from .node import FWD, NML, REV, TMR
from .seqs import is_almost_repeat, is_n_seq, is_repeat, parse_md
from .vardb import VariantDB

CLIP_PRC = 0.5
MIN_XM = 5


@dataclass
class Aln:
    """One BAM alignment record (the fields lancet consumes)."""

    name: str
    pos: int  # 0-based leftmost
    mapq: int
    flag: int
    seq: str
    qual: str  # phred+33 chars
    cigar: list  # [(op_char, length)]
    tags: dict  # tag -> (type_char, value)

    @property
    def is_paired(self) -> bool:
        return bool(self.flag & 0x1)

    @property
    def is_mapped(self) -> bool:
        return not (self.flag & 0x4)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 0x10)

    @property
    def is_first_mate(self) -> bool:
        return bool(self.flag & 0x1) and bool(self.flag & 0x40)

    @property
    def is_second_mate(self) -> bool:
        return bool(self.flag & 0x1) and bool(self.flag & 0x80)

    @property
    def is_duplicate(self) -> bool:
        return bool(self.flag & 0x400)

    @property
    def is_primary(self) -> bool:
        return not (self.flag & 0x100)

    def end_position(self) -> int:
        """Half-open end: pos + sum of M/D/N/X/= lengths (bamtools
        GetEndPosition with closedInterval=false)."""
        ln = 0
        for op, n in self.cigar:
            if op in "MDNX=":
                ln += n
        return self.pos + ln

    def get_numeric_tag(self, tag: str) -> float:
        """-1.0 when missing or non-numeric (ref: util.cc:486-560)."""
        tv = self.tags.get(tag)
        if tv is None:
            return -1.0
        t, v = tv
        if t in "cCsSiIf":
            return float(v)
        return -1.0

    def get_string_tag(self, tag: str) -> str:
        tv = self.tags.get(tag)
        if tv is None:
            return ""
        t, v = tv
        if t in ("Z", "A", "H"):
            return str(v)
        return ""

    def soft_clips(self):
        """(clip_sizes, read_positions, genome_positions) with bamtools
        GetSoftClips semantics (BamAlignment.cpp:536-600)."""
        ref_pos = self.pos
        read_pos = 0
        clip_sizes, read_positions, genome_positions = [], [], []
        first = True
        for op, n in self.cigar:
            if op in "DMXN=":
                ref_pos += n
                read_pos += n
            elif op == "I":
                read_pos += n
            elif op == "S":
                if first:
                    read_pos += n
                clip_sizes.append(n)
                read_positions.append(read_pos)
                genome_positions.append(ref_pos)
            first = False
        return clip_sizes, read_positions, genome_positions


@dataclass
class ShardCounters:
    num_skip: int = 0
    num_snv_only: int = 0
    num_indel_only: int = 0
    num_softclip_only: int = 0
    num_indel_or_softclip: int = 0
    num_snv_or_indel: int = 0
    num_snv_or_softclip: int = 0
    num_snv_or_indel_or_softclip: int = 0
    total_reads: int = 0
    windows_done: int = 0


class Microassembler:
    """One shard's worker (thread equivalent)."""

    def __init__(self, cfg, readers=None, engine: str = "oracle"):
        self.cfg = cfg
        self.filters = cfg.filters
        self.vdb = VariantDB(cfg.lr_mode)
        self.counters = ShardCounters()
        self.readers = readers  # (tumor_reader, normal_reader)
        # read-group allowlist (ref: Microassembler.cc:29-48 loadRG;
        # the sentinel "null" admits every read)
        self.readgroups: set[str] = {"null"}
        if getattr(cfg, "rg_file", ""):
            with open(cfg.rg_file) as f:
                toks = f.read().split()
            self.readgroups = set(toks) if toks else {"null"}
        self.window_times: list[tuple[str, float, int]] = []
        # (window name, wall ms, reads) — W_ELAPSED_TIME equivalent
        # (ref: Microassembler.cc:770-777, 848-857)
        self._read_cache: list[dict] = [{}, {}]  # per reader: chrom -> cache
        self.graph_cnt = 0
        self.engine = engine
        self.path_jobs = []  # deferred PathJobs (device engine)
        self._gates: dict | None = None  # window name -> (gate_row, exact_row)
        self._gate_kidx: dict[int, int] = {}
        # two-phase mode: leave path_jobs for the parent process to align
        # on device and finish (runner.run(processes=True))
        self.defer_flush = False
        # precomputed (gates, kidx) shipped by the parent so workers never
        # touch a device
        self.precomputed_gates: tuple[dict, dict] | None = None

    # ------------------------------------------------------------------
    def _fetch(self, which: int, window):
        """Window read fetch through the shard-span cache. Consecutive
        windows overlap 5:1 (600bp window / 100bp stride), so fetching the
        shard's whole span once and serving windows by bisect removes ~6x
        redundant BAM decode. Exact: the cache superset is served with the
        same (pos <= right, end >= left, file-order) contract as a direct
        reader.fetch."""
        cache = self._read_cache[which].get(window.chrom)
        if cache is None:
            return list(self.readers[which].fetch(
                window.chrom, window.refstart, window.refend))
        import bisect

        pos, ends, maxspan, alns = cache
        left, right = window.refstart, window.refend
        i_hi = bisect.bisect_right(pos, right)
        i_lo = bisect.bisect_left(pos, left - maxspan)
        return [a for a, e in zip(alns[i_lo:i_hi], ends[i_lo:i_hi])
                if e >= left]

    def _prefetch(self, windows) -> None:
        """Build per-chromosome read caches covering the shard's windows
        (span-capped; larger jobs fall back to per-window indexed jumps)."""
        import os

        cap = int(os.environ.get("LANCET_CACHE_SPAN", 2_000_000))
        spans: dict[str, list[int]] = {}
        for w in windows:
            s = spans.setdefault(w.chrom, [w.refstart, w.refend])
            s[0] = min(s[0], w.refstart)
            s[1] = max(s[1], w.refend)
        for which in (0, 1):
            if self.readers is None:
                break
            for chrom, (lo, hi) in spans.items():
                if hi - lo > cap:
                    continue
                alns = list(self.readers[which].fetch(chrom, lo, hi))
                pos = [a.pos for a in alns]
                ends = [a.end_position() for a in alns]
                maxspan = max((e - p for p, e in zip(pos, ends)), default=0)
                self._read_cache[which][chrom] = (pos, ends, maxspan, alns)

    # ------------------------------------------------------------------
    def is_active_region(self, alns, refinfo, code: int) -> bool:
        """Pre-scan for mutation evidence (ref: Microassembler.cc:255-432)."""
        fs = self.filters
        min_evidence = fs.min_alt_cnt_tumor
        mq = 0 if code == NML else self.cfg.min_map_qual
        map_x: dict[int, int] = {}
        map_i: dict[int, int] = {}
        map_d: dict[int, int] = {}
        map_sc: dict[int, int] = {}

        for al in alns:
            alstart = al.pos
            alend = al.end_position()
            if alstart < refinfo.refstart or alend > refinfo.refend:
                continue
            if al.mapq < mq or al.is_duplicate:
                continue
            if not al.seq or not al.qual:
                continue
            rg = al.get_string_tag("RG") or "null"
            if not ("null" in self.readgroups or rg in self.readgroups):
                continue
            md = al.get_string_tag("MD")
            if md:
                parse_md(md, map_x, alstart, al.qual, self.cfg.min_qual_call)
            # CIGAR walk: pos advances for every non-I op (incl. S),
            # events recorded at the post-advance position (reference quirk,
            # Microassembler.cc:316-346)
            pos = alstart
            for op, ln in al.cigar:
                if op != "I":
                    pos += ln
                if op == "X":
                    map_x[pos] = map_x.get(pos, 0) + 1
                if op == "I":
                    map_i[pos] = map_i.get(pos, 0) + 1
                if op == "D":
                    map_d[pos] = map_d.get(pos, 0) + 1
            _, _, gps = al.soft_clips()
            for gp in gps:
                map_sc[gp] = map_sc.get(gp, 0) + 1

        snv = any(v >= min_evidence for v in map_x.values())
        indel = any(v >= min_evidence for v in map_i.values()) or \
            any(v >= min_evidence for v in map_d.values())
        softclip = any(v >= min_evidence for v in map_sc.values())

        c = self.counters
        if code == TMR:
            if snv and not indel and not softclip:
                c.num_snv_only += 1
            if not snv and indel and not softclip:
                c.num_indel_only += 1
            if not snv and not indel and softclip:
                c.num_softclip_only += 1
            if not snv and (indel or softclip):
                c.num_indel_or_softclip += 1
            if (snv or indel) and not softclip:
                c.num_snv_or_indel += 1
            if (snv or softclip) and not indel:
                c.num_snv_or_softclip += 1
            if snv or indel or softclip:
                c.num_snv_or_indel_or_softclip += 1

        return snv or indel or softclip

    # ------------------------------------------------------------------
    def extract_reads(self, alns, g: Graph, refinfo, code: int) -> bool:
        """Filter chain feeding the graph; True means skip window
        (ref: Microassembler.cc:436-655)."""
        cfg = self.cfg
        mq = 0 if code == NML else cfg.min_map_qual
        min_delta = -1 if code == NML else cfg.max_delta_as_xs
        sample_type = "tumor" if code == TMR else "normal"
        totalreadbp = 0
        skip = False
        if cfg.verbose:
            print("Extract reads from "
                  + ("tumor" if code == TMR else "normal"), file=sys.stderr)
        # per-call filter counters (ref: Microassembler.cc:465-473)
        num_xt_r = num_xt_m = num_xa = 0
        num_high_softclip = num_high_xm = num_equal_as_xs = 0
        tot_reads_window = 0

        for al in alns:
            avgcov = totalreadbp / len(refinfo.rawseq) if refinfo.rawseq else 0.0
            if avgcov > cfg.max_avg_cov:
                skip = True
                break
            alstart = al.pos
            alend = al.end_position()
            if alstart < refinfo.refstart or alend > refinfo.refend:
                continue
            if cfg.primary_alignment_only and not al.is_primary:
                continue
            if al.mapq < mq or al.is_duplicate:
                continue

            mate = 0
            if al.is_first_mate:
                mate = 1
            if al.is_second_mate:
                mate = 2
            strand = REV if al.is_reverse else FWD

            as_ = al.get_numeric_tag("AS")
            xs_ = al.get_numeric_tag("XS")
            delta = abs(as_ - xs_)
            if delta <= min_delta and as_ != -1 and xs_ != -1:
                num_equal_as_xs += 1
                continue

            if al.get_numeric_tag("XM") >= MIN_XM:
                num_high_xm += 1  # counted, not skipped (Micro.cc:541)

            xt = al.get_string_tag("XT") or "null"
            if xt == "R":
                num_xt_r += 1
                if code != NML:
                    continue
            if xt == "M":
                num_xt_m += 1
            xa = al.get_string_tag("XA") or "null"
            if xa != "null":
                num_xa += 1
                if code != NML and cfg.xa_filter:
                    continue

            bx = "null"
            hp = 0
            if cfg.lr_mode:
                bx = al.get_string_tag("BX") or "null"
                hp = int(al.get_numeric_tag("HP"))
                if hp == -1:
                    hp = 0

            sc_bases = sum(ln for op, ln in al.cigar if op == "S")
            if sc_bases and len(al.seq) and sc_bases / len(al.seq) >= CLIP_PRC:
                num_high_softclip += 1  # counted, not skipped (Micro.cc:608)

            rg = al.get_string_tag("RG") or "null"
            if "null" in self.readgroups or rg in self.readgroups:
                if not al.is_mapped:
                    g.add_alignment(sample_type, al.name, al.seq, al.qual,
                                    mate, CODE_BASTARD, code, strand, bx, hp)
                else:
                    g.add_alignment(sample_type, al.name, al.seq, al.qual,
                                    mate, CODE_MAPPED, code, strand, bx, hp)
                self.counters.total_reads += 1
                tot_reads_window += 1
                totalreadbp += len(al.seq)

        if cfg.verbose:
            # ref: Microassembler.cc:641-652 (prc is C++ default %g; the
            # 0/0 window case prints -nan on x86 like the reference)
            # reference cerr is globally fixed/precision(1) (Lancet.cc:623)
            prc = (100.0 * num_high_softclip / tot_reads_window
                   if tot_reads_window else float("nan"))
            prcs = "-nan" if tot_reads_window == 0 else f"{prc:.1f}"
            md = int(min_delta) if float(min_delta).is_integer() else min_delta
            print(f"Num reads marked as repeat (XT:A:R tag): {num_xt_r}\n"
                  f"Num reads marked as Mate-sw (XT:A:M tag): {num_xt_m}\n"
                  f"Num reads with alternative hits (XA tag): {num_xa}\n"
                  f"Num reads with >={100 * CLIP_PRC:.1f}% soft-clipping: "
                  f"{num_high_softclip}({prcs}%)\n"
                  f"Num reads with >={MIN_XM} mis-matches: {num_high_xm}\n"
                  f"Num reads with |AS-XS|<={md}: {num_equal_as_xs}",
                  file=sys.stderr)
        return skip

    # ------------------------------------------------------------------
    def process_graph(self, g: Graph, refinfo, minkmer: int, maxkmer: int) -> int:
        """Self-tuning-k assembly of one window
        (ref: Microassembler.cc:73-249)."""
        self.graph_cnt += 1
        if g.count_mapped_reads() <= 0:
            return 0
        numreads = len(g.readid2info)
        verbose = self.cfg.verbose
        if verbose:
            print(f"== Processing {self.graph_cnt}: {refinfo.hdr} "
                  f"numsequences: {numreads} "
                  f"mapped: {g.count_mapped_reads()} "
                  f"bastards: {g.count_bastard_reads()}", file=sys.stderr)
            print("=====================================================",
                  file=sys.stderr)

        # verbose is a per-window debugging mode: run the oracle engine so
        # the reference's stderr counter lines can be emitted faithfully
        use_fast = (self.engine == "device" and not self.cfg.lr_mode
                    and not self.cfg.kmer_recovery and not verbose)
        # full native per-k pipeline (build through path cover in C++);
        # DOT export needs live Python graph objects, so it opts out
        use_pipe = False
        if use_fast and not self.cfg.print_graph:
            from .fastpipe import available
            use_pipe = available()

        rpt_in_ref = False
        rpt_in_qry = False
        cycle_in_graph = False
        for k in range(minkmer, maxkmer + 1, 2):
            g.set_k(k)
            refinfo.set_k(k)
            rpt_in_ref = False
            rpt_in_qry = False
            cycle_in_graph = False

            grow = self._gates.get(refinfo.hdr) if self._gates else None
            if grow is not None and k in self._gate_kidx and not verbose:
                if grow[0][self._gate_kidx[k]]:
                    continue
            else:
                if is_repeat(refinfo.rawseq, k):
                    if verbose:
                        print(f"Repeat in reference sequence for kmer {k}",
                              file=sys.stderr)
                    rpt_in_ref = True
                    continue
                if is_almost_repeat(refinfo.rawseq, k, self.cfg.max_mismatch):
                    if verbose:
                        print("Near-perfect repeat in reference sequence "
                              f"for kmer {k}", file=sys.stderr)
                    rpt_in_ref = True
                    continue

            if use_pipe:
                from .fastpipe import (STATUS_CYCLE, STATUS_REPEAT,
                                       run_k_native)
                st = run_k_native(g, refinfo, self.cfg)
                if st is not None:
                    if st in (STATUS_CYCLE, STATUS_REPEAT):
                        g.clear(False)
                        continue
                    break
                use_pipe = False  # native error: python path from this k on

            if use_fast:
                # fuses markRefNodes + low-cov prune; C++ kernel when the
                # toolchain is available, numpy otherwise (identical state)
                from .fastbuild import build_graph_fast, build_graph_native
                if not build_graph_native(g, refinfo):
                    build_graph_fast(g, refinfo)
            else:
                g.buildgraph(refinfo)
                if self.cfg.kmer_recovery:
                    from .error_corrector import mers_recovery
                    mers_recovery(g, 2, self.cfg.min_qual_call)
                if verbose:  # ref: Microassembler.cc:143-150
                    avgcov = g.totalreadbp / len(refinfo.rawseq)
                    print(f"reads: {len(g.readid2info)} "
                          f"reflen: {len(refinfo.rawseq)} "
                          f"readlen: {g.totalreadbp} cov: {avgcov:.1f}",
                          file=sys.stderr)
                    g.print_stats(0)
                g.mark_ref_nodes()
                g.remove_low_cov(False, 0)
            numcomp = g.mark_connected_components()

            dot = None
            if self.cfg.print_graph:
                from . import dot as dot_mod
                dot = dot_mod
                prefix = "./" + refinfo.hdr
                dot.print_dot(g, f"{prefix}.0.dot", 0, self.cfg.node_strlen)

            for c in range(1, numcomp + 1):
                if verbose:
                    g.print_stats(c)  # ref: Microassembler.cc:168
                g.mark_ref_ends(refinfo, c)
                if dot:
                    dot.print_dot(g, f"{prefix}.1l.c{c}.dot", c, self.cfg.node_strlen)
                if g.has_cycle():
                    g.clear(False)
                    cycle_in_graph = True
                    break
                g.check_read_starts(c)  # ref: Microassembler.cc:181
                g.compress(c)
                if verbose:
                    g.print_stats(c)  # ref: Microassembler.cc:185
                if dot:
                    dot.print_dot(g, f"{prefix}.2c.c{c}.dot", c, self.cfg.node_strlen)
                g.remove_low_cov(True, c)
                if dot:
                    dot.print_dot(g, f"{prefix}.3l.c{c}.dot", c, self.cfg.node_strlen)
                g.remove_tips(c)
                if dot:
                    dot.print_dot(g, f"{prefix}.4t.c{c}.dot", c, self.cfg.node_strlen)
                g.remove_short_links(c)
                if dot:
                    dot.print_dot(g, f"{prefix}.5s.c{c}.dot", c, self.cfg.node_strlen)
                if g.has_cycle():
                    g.clear(False)
                    cycle_in_graph = True
                    break
                if g.has_repeats_in_graph_paths(refinfo):
                    g.clear(False)
                    rpt_in_qry = True
                    break
                g.count_ref_path()
                if dot:
                    dot.print_dot(g, f"{prefix}.final.c{c}.dot", c, self.cfg.node_strlen)

            if rpt_in_qry or cycle_in_graph:
                continue
            break

        g.clear(True)
        if verbose:
            if rpt_in_ref:
                print(" Found repeat in reference", file=sys.stderr)
            if rpt_in_qry:
                print(" Found repeat in assembly", file=sys.stderr)
            if cycle_in_graph:
                print(" Found cycle in assembly", file=sys.stderr)
            print("FINISHED", file=sys.stderr)
        return numreads

    # ------------------------------------------------------------------
    def process_window(self, window, tumor_alns=None, normal_alns=None) -> None:
        """One window end-to-end. Alignment lists may be passed directly
        (testing) or fetched from the shard's readers."""
        cfg = self.cfg
        refinfo = window.make_ref(cfg.min_k)

        if is_n_seq(refinfo.rawseq):
            return
        grow = self._gates.get(refinfo.hdr) if self._gates else None
        if grow is not None and cfg.max_k in self._gate_kidx:
            if grow[1][self._gate_kidx[cfg.max_k]]:
                return
        elif is_repeat(refinfo.rawseq, cfg.max_k):
            return

        if tumor_alns is None:
            tumor_alns = self._fetch(0, window)
        if normal_alns is None:
            normal_alns = self._fetch(1, window)

        active_t = active_n = True
        if cfg.active_regions:
            active_t = self.is_active_region(tumor_alns, refinfo, TMR)
            active_n = self.is_active_region(normal_alns, refinfo, NML)

        if active_t or active_n:
            g = Graph(cfg, self.filters, self.vdb)
            if self.engine == "device":
                g.path_sink = self.path_jobs.append
            skip_t = self.extract_reads(tumor_alns, g, refinfo, TMR)
            skip_n = self.extract_reads(normal_alns, g, refinfo, NML)
            if not skip_t and not skip_n:
                self.process_graph(g, refinfo, cfg.min_k, cfg.max_k)
            else:
                self.counters.num_skip += 1
                g.clear(True)
        else:
            self.counters.num_skip += 1
        self.counters.windows_done += 1

    def process_windows(self, windows, skip_names=None, chunk_cb=None,
                        chunk_size: int = 64, trace: bool = False) -> None:
        """Process a shard's windows in lexicographic name order (reference
        std::map reftable order, Microassembler.cc:779).

        skip_names: already-completed windows (resume) to drop up front.
        chunk_cb(names, variants): called after each chunk_size-window
        chunk is fully flushed, with the variant records that chunk added
        (checkpoint logging). trace: record per-window wall time.
        """
        import time as _time

        ws = sorted(windows, key=lambda w: w.name)
        if skip_names:
            ws = [w for w in ws if w.name not in skip_names]
        if ws and self.readers is not None:
            self._prefetch(ws)
        if self.engine == "device" and ws:
            self._precompute_gates(ws)
        if chunk_cb is None and not trace:
            for w in ws:
                self.process_window(w)
            if self.engine == "device" and not self.defer_flush:
                self.flush_path_jobs()
            return
        sink: list = []
        if chunk_cb is not None:
            self.vdb.record_sink = sink
        try:
            for i in range(0, len(ws), chunk_size):
                chunk = ws[i : i + chunk_size]
                for w in chunk:
                    if trace:
                        r0 = self.counters.total_reads
                        t0 = _time.perf_counter()
                        self.process_window(w)
                        self.window_times.append(
                            (w.name, (_time.perf_counter() - t0) * 1e3,
                             self.counters.total_reads - r0))
                    else:
                        self.process_window(w)
                if self.engine == "device" and not self.defer_flush:
                    self.flush_path_jobs()
                if chunk_cb is not None:
                    chunk_cb([w.name for w in chunk], list(sink))
                    sink.clear()
        finally:
            self.vdb.record_sink = None

    def _precompute_gates(self, ws) -> None:
        """Batched device evaluation of the per-(window, k) repeat gates
        for the whole shard (replaces the reference's O(L^2*K) host scans
        per retry, Microassembler.cc:118-131)."""
        from ..device.repeats import repeat_gates

        cfg = self.cfg
        if self.precomputed_gates is not None:
            self._gates, self._gate_kidx = self.precomputed_gates
            return
        ks = list(range(cfg.min_k, cfg.max_k + 1, 2))
        self._gate_kidx = {k: i for i, k in enumerate(ks)}
        self._gates = {}
        # one device pass for the whole shard (the streamed kernel keeps
        # only [W, L] state per scan step, so W is not memory-bound);
        # chunk merely to cap the padded-batch size
        CH = 512
        for i in range(0, len(ws), CH):
            chunk = ws[i : i + CH]
            g, e = repeat_gates([w.rawseq for w in chunk], ks,
                                cfg.max_mismatch, with_exact=True)
            for j, w in enumerate(chunk):
                self._gates[w.name] = (g[j], e[j])

    def flush_path_jobs(self) -> None:
        """Batch-align deferred paths on device, then extract variants in
        the original (window, path) order so the order-sensitive dedup
        matches the oracle exactly."""
        from .extract import finish_path

        jobs = self.path_jobs
        self.path_jobs = []
        dp_jobs = [j for j in jobs if j.needs_dp]
        aligned = {}
        if dp_jobs:
            from ..device.align_batch import batch_align

            results = batch_align([(j.refseq, j.pathseq) for j in dp_jobs])
            aligned = {id(j): r for j, r in zip(dp_jobs, results)}
        for j in jobs:
            if j.needs_dp:
                ref_aln, path_aln = aligned[id(j)]
            else:
                ref_aln, path_aln = j.refseq, j.pathseq
            finish_path(j, ref_aln, path_aln, self.cfg, self.vdb)
