"""Colored de Bruijn graph: build, cleanup, anchoring, path cover, and
per-path variant extraction (ref: src/Graph.{hh,cc}).

This is the oracle implementation — behavior-exact with the reference,
including its quirks (noted inline). The device engine mirrors these stages
as batched kernels and is validated against this module.
"""

from __future__ import annotations

import sys
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..cpp_hash import CppUnorderedMap
from .align import global_align_aff
from .mer import F, R, canonical
from .node import (FF, FR, RF, RR, FWD, REV, NML, TMR, Edge, Node,
                   edgedir_dest, edgedir_start, fliplink, flipme)
from .path import Path
from .seqs import (find_tandems, hamming_distance, is_almost_repeat, is_dna,
                   rc_str, seq_above_qual)
from .transcript import Transcript
from .variant import Variant

CODE_MAPPED = "M"
CODE_BASTARD = "B"
REF_LABEL = 3  # ref pseudo-read label (ref: Graph.hh:58 `#define REF 3`)

_DNA_TABLE = np.zeros(256, bool)
for _c in b"ACGTacgt":
    _DNA_TABLE[_c] = True

WHITE, GREY, BLACK = 1, 2, 3


@dataclass
class ReadInfo:
    """(ref: src/ReadInfo.hh)"""

    label: int
    set_name: str
    readname: str
    seq: str
    qv: str
    code: str
    strand: int
    mate_order: int
    bx: str
    hp: int
    mateid: int = -1
    trm5: int = 0
    trm3: int = 0
    isjunk: bool = False


class Graph:
    def __init__(self, cfg, filters, vdb):
        self.cfg = cfg
        self.filters = filters
        self.vdb = vdb
        self.K = cfg.min_k
        self.MAX_LINK_LEN = cfg.max_link_len(self.K)
        self.LR_MODE = cfg.lr_mode
        self.MIN_QUAL_TRIM = cfg.min_qual_trim
        self.MIN_QUAL_CALL = cfg.min_qual_call
        self.DFS_LIMIT = cfg.dfs_limit
        self.COV_THRESHOLD = cfg.cov_threshold
        self.MIN_COV_RATIO = cfg.min_cov_ratio
        self.LOW_COV_THRESHOLD = cfg.low_cov_threshold
        self.MAX_TIP_LEN = cfg.max_tip_len
        self.MAX_INDEL_LEN = cfg.max_indel_len
        self.MAX_MISMATCH = cfg.max_mismatch
        self.verbose = cfg.verbose

        self.nodes: CppUnorderedMap = CppUnorderedMap()
        self.totalreadbp = 0
        self.source: Node | None = None
        self.sink: Node | None = None
        self.ref = None
        self.is_ref_added = False
        self.readid2info: list[ReadInfo] = []
        self.read_cycles = 0
        self.bx_table_tmr: dict[str, set[str]] = {}
        self.bx_table_nml: dict[str, set[str]] = {}
        # when set, process_path defers alignment+extraction to the caller
        # (device batch mode); None = align/extract inline (oracle mode)
        self.path_sink = None

    # ------------------------------------------------------------------
    def set_k(self, k: int) -> None:
        self.K = k
        self.MAX_LINK_LEN = self.cfg.max_link_len(k)

    def clear(self, full: bool) -> None:
        """(ref: Graph.cc:29-60)"""
        if full:
            self.readid2info = []
            self.is_ref_added = False
        self.totalreadbp = 0
        self.nodes = CppUnorderedMap()
        self.bx_table_tmr = {}
        self.bx_table_nml = {}
        self.source = None
        self.sink = None
        if self.ref is not None and full:
            self.ref.clear()
            self.ref = None

    def node_iter(self):
        """Node visitation order: bit-exact libstdc++ unordered_map
        iteration (see lancet_jax.cpp_hash) — compression survivor choice
        and per-base coverage row donation depend on it."""
        return self.nodes.values()

    def get_node(self, nodeid: str) -> Node | None:
        return self.nodes.get(nodeid)

    def get_edge_node(self, edge: Edge) -> Node | None:
        return self.nodes.get(edge.nodeid)

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------
    def add_read(self, set_name, readname, seq, qv, code, label, strand,
                 mate_order, bx, hp) -> int:
        rid = len(self.readid2info)
        self.readid2info.append(ReadInfo(label, set_name, readname, seq, qv,
                                         code, strand, mate_order, bx, hp))
        return rid

    def add_alignment(self, set_name, readname, seq, qv, mate_id, code, label,
                      strand, bx, hp) -> None:
        rid = self.add_read(set_name, readname, seq, qv, code, label, strand,
                            mate_id, bx, hp)
        self.trim(rid, seq, qv)

    def trim(self, readid: int, seq: str, qv: str) -> None:
        """5'/3' low-quality/non-DNA trim points (ref: Graph.cc:355-384)."""
        info = self.readid2info[readid]
        ln = len(seq)
        s = np.frombuffer(seq.encode("latin-1"), np.uint8)
        q = np.frombuffer(qv.encode("latin-1"), np.uint8)
        dna = _DNA_TABLE[s]
        good = dna & (q >= self.MIN_QUAL_TRIM)
        if good.any():
            trim5 = int(good.argmax())
            trim3 = int(good[::-1].argmax())
            info.isjunk = not dna[trim5 : ln - trim3].all()
        else:
            trim5 = ln
            trim3 = 0
            info.isjunk = True
        info.trm5 = trim5
        info.trm3 = trim3

    def count_mapped_reads(self) -> int:
        return sum(1 for r in self.readid2info if r.code == CODE_MAPPED)

    def count_bastard_reads(self) -> int:
        return sum(1 for r in self.readid2info if r.code == CODE_BASTARD)

    # ------------------------------------------------------------------
    # build (ref: Graph.cc:119-349, 530-589)
    # ------------------------------------------------------------------
    def add_bx_table(self, bx: str, mer: str, sample: int) -> None:
        table = self.bx_table_tmr if sample == TMR else self.bx_table_nml
        table.setdefault(mer, set()).add(bx)

    def get_bx_set_at(self, start: int, end: int, seq: str, sample: int) -> str:
        if start < 0 or end >= len(seq):
            # C++ substr(pos>size) throws out_of_range, caught by processPath
            raise IndexError("getBXsetAt out of range")
        table = self.bx_table_tmr if sample == TMR else self.bx_table_nml
        out: set[str] = set()
        for i in range(start, end + 1):
            cmer, _ = canonical(seq[i : i + self.K])
            if cmer in table:
                out |= table[cmer]
        return ";".join(sorted(out)) if out else "."

    def load_sequence(self, readid: int, seq: str, qv: str, is_ref: bool,
                      trim5: int, strand: int) -> None:
        """Stream consecutive canonical mer pairs into nodes/edges
        (ref: Graph.cc:119-349)."""
        K = self.K
        if not is_ref:
            self.totalreadbp += len(seq)

        info = self.readid2info[readid]
        sample = info.label
        readmers: set[str] = set()

        end = len(seq) - K
        if end <= 0:
            return

        uc = vc = None
        uc_ori = vc_ori = F
        uc_qv = vc_qv = ""
        unode = vnode = None

        for offset in range(end):
            if offset == 0:
                uc, uc_ori = canonical(seq[0:K])
                vc, vc_ori = canonical(seq[1 : 1 + K])
                uc_qv = qv[0:K]
                vc_qv = qv[1 : 1 + K]
                if uc_ori == R:
                    uc_qv = uc_qv[::-1]
                if vc_ori == R:
                    vc_qv = vc_qv[::-1]
                unode = self.nodes.get(uc)
                vnode = self.nodes.get(vc)
            else:
                uc, uc_ori, uc_qv, unode = vc, vc_ori, vc_qv, vnode
                vc, vc_ori = canonical(seq[offset + 1 : offset + 1 + K])
                vc_qv = qv[offset + 1 : offset + 1 + K]
                if vc_ori == R:
                    vc_qv = vc_qv[::-1]
                vnode = self.nodes.get(vc)

            if unode is None:
                unode = Node(uc)
                unode.min_qual = self.MIN_QUAL_CALL
                unode.K = K
                self.nodes[uc] = unode
            if vnode is None:
                vnode = Node(vc)
                vnode.min_qual = self.MIN_QUAL_CALL
                vnode.K = K
                self.nodes[vc] = vnode

            if sample == NML:
                unode.is_normal = True
                vnode.is_normal = True
                unode.update_cov_status(ord("N"))
                vnode.update_cov_status(ord("N"))

            if seq_above_qual(uc_qv, self.MIN_QUAL_CALL) and seq_above_qual(vc_qv, self.MIN_QUAL_CALL):
                if sample == TMR:
                    unode.is_tumor = True
                    vnode.is_tumor = True
                    unode.update_cov_status(ord("T"))
                    vnode.update_cov_status(ord("T"))

            unode.add_mate_name(info.readname, info.mate_order)
            vnode.add_mate_name(info.readname, info.mate_order)

            if self.LR_MODE:
                if offset == 0:
                    if info.bx != "null":
                        self.add_bx_table(info.bx, uc, sample)
                        self.ref.add_bx(info.bx, uc, sample)
                    if not unode.has_bx(info.bx, sample):
                        unode.add_bx(info.bx, strand, sample)
                        unode.add_hp(info.hp, sample)
                if info.bx != "null":
                    self.add_bx_table(info.bx, vc, sample)
                    self.ref.add_bx(info.bx, vc, sample)
                if not vnode.has_bx(info.bx, sample):
                    vnode.add_bx(info.bx, strand, sample)
                    vnode.add_hp(info.hp, sample)

            if not is_ref:
                if offset == 0:
                    if not unode.has_overlapping_mate(info.readname, info.mate_order):
                        unode.inc_cov(strand, sample)
                        if self.LR_MODE:
                            unode.update_cov_distr(unode.bx_cnt(strand, sample), uc_qv, strand, sample)
                            unode.update_hp_cov_distr(unode.hp_cnt(0, sample), unode.hp_cnt(1, sample), unode.hp_cnt(2, sample), uc_qv, sample)
                            self.ref.update_coverage(uc, unode.bx_cnt(strand, sample), strand, sample)
                            self.ref.update_hp_coverage(uc, unode.hp_cnt(0, sample), unode.hp_cnt(1, sample), unode.hp_cnt(2, sample), sample)
                        else:
                            unode.update_cov_distr(int(unode.get_cov(strand, sample)), uc_qv, strand, sample)
                            self.ref.update_coverage(uc, int(unode.get_cov(strand, sample)), strand, sample)
                        if uc_ori == F:
                            unode.add_read_start(readid, 0, trim5, F)
                        else:
                            unode.add_read_start(readid, K - 1, trim5, R)
                if not vnode.has_overlapping_mate(info.readname, info.mate_order):
                    vnode.inc_cov(strand, sample)
                    if self.LR_MODE:
                        vnode.update_cov_distr(vnode.bx_cnt(strand, sample), vc_qv, strand, sample)
                        vnode.update_hp_cov_distr(vnode.hp_cnt(0, sample), vnode.hp_cnt(1, sample), vnode.hp_cnt(2, sample), vc_qv, sample)
                        self.ref.update_coverage(vc, vnode.bx_cnt(strand, sample), strand, sample)
                        self.ref.update_hp_coverage(vc, vnode.hp_cnt(0, sample), vnode.hp_cnt(1, sample), vnode.hp_cnt(2, sample), sample)
                    else:
                        vnode.update_cov_distr(int(vnode.get_cov(strand, sample)), vc_qv, strand, sample)
                        self.ref.update_coverage(vc, int(vnode.get_cov(strand, sample)), strand, sample)

            if uc_ori == F and vc_ori == F:
                fdir, rdir = FF, RR
            elif uc_ori == F and vc_ori == R:
                fdir, rdir = FR, FR
            elif uc_ori == R and vc_ori == F:
                fdir, rdir = RF, RF
            else:
                fdir, rdir = RR, FF

            readmers.add(uc)
            if vc in readmers:
                if readid > -1:
                    self.read_cycles += 1

            unode.add_edge(vc, fdir, readid)
            vnode.add_edge(uc, rdir, readid)

    def buildgraph(self, refinfo) -> None:
        """(ref: Graph.cc:530-589)"""
        self.ref = refinfo
        if not self.is_ref_added:
            qv = "K" * len(self.ref.rawseq)
            self.add_read("ref", self.ref.hdr, self.ref.rawseq, qv, "R",
                          REF_LABEL, FWD, 0, "null", 0)
            self.is_ref_added = True

        for i, info in enumerate(self.readid2info):
            if info.isjunk:
                continue
            ln = len(info.seq)
            t5, t3 = info.trm5, info.trm3
            if t5 or t3:
                seq = info.seq[t5 : ln - t3]
                qv = info.qv[t5 : ln - t3]
            else:
                seq = info.seq
                qv = info.qv
            self.load_sequence(i, seq, qv, info.label == REF_LABEL, t5, info.strand)

        for n in self.node_iter():
            n.compute_min_cov()
            n.mate1_name = sorted(set(n.mate1_name))
            n.mate2_name = sorted(set(n.mate2_name))

        self.ref.compute_coverage(TMR)
        self.ref.compute_coverage(NML)

    # ------------------------------------------------------------------
    # per-stage graph stats (ref: Graph.cc:3674-3691): total node count,
    # component-local edge count and base span.
    # ------------------------------------------------------------------
    def print_stats(self, compid: int) -> None:
        edgecnt = 0
        span = 0
        total = 0
        for n in self.node_iter():
            total += 1
            if n.component == compid:
                edgecnt += len(n.edges)
                span += n.strlen()
        print(f"  {compid}: nodes: {total} edges: {edgecnt} span: {span}",
              file=sys.stderr)

    # ------------------------------------------------------------------
    # read-start audit (ref: Graph.cc:3388-3450, called per component at
    # Microassembler.cc:181): every readstart record must still point at
    # the k-mer of its read — compare the read's k-mer at trim5 against
    # the node k-mer at the recorded offset (revcomp'd for R orientation).
    # Returns (bad, all) so callers/tests can assert bad == 0.
    # ------------------------------------------------------------------
    def check_read_starts(self, compid: int) -> tuple[int, int]:
        nbad = 0
        nall = 0
        K = self.K
        for node in self.node_iter():
            if node.component != compid:
                continue
            for readid, nodeoffset, trim5, ori in node.readstarts:
                info = self.readid2info[readid]
                rkmer = info.seq[trim5 : trim5 + K]
                nall += 1
                if ori == R:
                    ckmer = rc_str(node.str_m[nodeoffset - K + 1 : nodeoffset + 1])
                else:
                    ckmer = node.str_m[nodeoffset : nodeoffset + K]
                if rkmer != ckmer:
                    nbad += 1
                    print(f"Checking {readid} {info.readname} {ori} "
                          f"offset:{nodeoffset} trim5:{trim5}", file=sys.stderr)
                    print(f"  {rkmer}\n  {ckmer}", file=sys.stderr)
                    print(f"mismatch: {node.str_m}", file=sys.stderr)
        if self.verbose:
            print(f"checking read starts....  found {nbad} bad starts "
                  f"out of {nall}", file=sys.stderr)
        return nbad, nall

    # ------------------------------------------------------------------
    # cycle detection (ref: Graph.cc:593-681)
    # ------------------------------------------------------------------
    def has_cycle(self) -> bool:
        if self.source is None or self.sink is None:
            return False
        for n in self.node_iter():
            if n.is_special():
                continue
            n.color = WHITE
        return self._cycle_dfs(self.source, F) or self._cycle_dfs(self.source, R)

    def _cycle_dfs(self, start: Node, d: str) -> bool:
        """Iterative emulation of hasCycleRec's recursion (Graph.cc:651-681)."""
        # stack entries: (node, dir, edge index)
        stack = [(start, d, 0)]
        start.color = GREY
        while stack:
            node, nd, ei = stack[-1]
            if ei >= len(node.edges):
                node.color = BLACK
                stack.pop()
                continue
            stack[-1] = (node, nd, ei + 1)
            edge = node.edges[ei]
            if not edge.isdir(nd):
                continue
            other = self.get_edge_node(edge)
            if other is None or other.is_special():
                continue
            if other.color == GREY:
                # unwind like the recursion would: remaining nodes keep color
                for n2, _, _ in stack:
                    n2.color = BLACK
                return True
            if other.color == WHITE:
                other.color = GREY
                stack.append((other, edge.destdir(), 0))
        return False

    def has_tumor_only_kmer(self) -> bool:
        if self.source is None or self.sink is None:
            return False
        return any(n.is_tumor and not n.is_normal for n in self.node_iter())

    # ------------------------------------------------------------------
    # marking (ref: Graph.cc:2233-2336)
    # ------------------------------------------------------------------
    def mark_ref_nodes(self) -> None:
        if self.verbose:
            print("\nmark refnodes", file=sys.stderr)
        nodes = 0
        refnodes = 0
        for n in self.node_iter():
            nodes += 1
            refnodes += n.mark_ref(self.ref, self.K)
            n.component = 0
        if self.verbose:
            print(f" nodes: {nodes} refnodes: {refnodes}", file=sys.stderr)

    def mark_connected_components(self) -> int:
        if self.verbose:
            print("\nconnected components", file=sys.stderr)
        self.ref.refcompids = set()
        nnodes = 0
        for n in self.node_iter():
            nnodes += 1
            n.component = 0
        comp = 0
        refcomp = 0
        for n in self.node_iter():
            if n.component != 0:
                continue
            comp += 1
            q = deque([n])
            touches = 0
            while q:
                cur = q.popleft()
                if cur is None:
                    continue
                if cur.component == 0:
                    cur.component = comp
                    if cur.touch_ref:
                        touches += 1
                    for e in cur.edges:
                        q.append(self.get_edge_node(e))
            if touches:
                refcomp += 1
                self.ref.refcompids.add(comp)
        # reference quirk: its local `refnodes` is never incremented in
        # markConnectedComponents, so ref->refnodes is stored as 0 here
        # (Graph.cc:2256, :2316) and eka later prints refnodes-2 == -2.
        self.ref.refnodes = 0
        self.ref.refcomp = refcomp
        self.ref.allcomp = comp
        if self.verbose:
            ids = "".join(f" {i}" for i in sorted(self.ref.refcompids))
            print(f" nodes: {nnodes} refnodes: 0 comp: {comp} "
                  f"refcomp: {refcomp} refcompids: {ids}", file=sys.stderr)
        return comp

    # ------------------------------------------------------------------
    # source/sink anchoring (ref: Graph.cc:2028-2228)
    # ------------------------------------------------------------------
    def mark_ref_ends(self, refinfo, compid: int) -> None:
        K = self.K
        refid = 0
        if not self.is_ref_added:
            qv = "K" * len(self.ref.rawseq)
            refid = self.add_read("ref", self.ref.hdr, self.ref.rawseq, qv,
                                  "R", REF_LABEL, FWD, 0, "null", 0)
            self.is_ref_added = True

        self.ref.trim5 = -1
        self.ref.trim3 = -1
        self.source = None
        self.sink = None
        rawseq = self.ref.rawseq

        # first qualifying mer left->right; abort if the SAME node matches twice
        source_node = None
        source_mer = source_ori = None
        source_offset = -1
        for offset in range(len(rawseq)):
            cmer, ori = canonical(rawseq[offset : offset + K])
            cand = self.nodes.get(cmer)
            if cand is not None and cand.tot_cov() >= self.COV_THRESHOLD and cand.component == compid:
                if source_node is None:
                    source_node, source_mer, source_ori = cand, cmer, ori
                    source_offset = offset
                elif source_node is cand:
                    return  # ambiguous
        if source_node is None:
            return

        sink_node = None
        sink_mer = sink_ori = None
        sink_offset = -1
        for offset in range(len(rawseq) - K, -1, -1):
            cmer, ori = canonical(rawseq[offset : offset + K])
            cand = self.nodes.get(cmer)
            if cand is not None and cand.tot_cov() >= self.COV_THRESHOLD and cand.component == compid:
                if sink_node is None:
                    sink_node, sink_mer, sink_ori = cand, cmer, ori
                    sink_offset = offset
                elif sink_node is cand:
                    return  # ambiguous
        if sink_node is None:
            return

        ref_dist = sink_offset - source_offset + K
        sink_offset = len(rawseq) - sink_offset - K
        self.ref.seq = rawseq[source_offset : source_offset + ref_dist]
        self.ref.trim5 = source_offset
        self.ref.trim3 = sink_offset
        # NOTE: the mer index is NOT invalidated here — the reference keeps
        # the pre-trim index for the rest of this k iteration and only
        # re-indexes (over the now-trimmed seq) after the next setK
        # (Ref.hh:109, Ref.cc:42) — stale-trim quirk preserved.

        # fake source node wiring (ref: Graph.cc:2156-2191)
        newsource = Node(f"source{compid}")
        newsource.component = compid
        sourcedir = FF if source_ori == F else FR
        # CLIP_REF_ENDS: cut edges entering the source from upstream
        for i in range(len(source_node.edges) - 1, -1, -1):
            e = source_node.edges[i]
            if edgedir_start(e.dir) == (R if source_ori == F else F):
                other = self.get_edge_node(e)
                if other is not None and other is not source_node:
                    other.remove_edge(source_node.nodeid, fliplink(e.dir))
                    del source_node.edges[i]
        newsource.add_edge(source_mer, sourcedir, refid)
        newsource.is_source = True
        source_node.add_edge(newsource.nodeid, fliplink(sourcedir), refid)
        self.source = newsource
        self.nodes[newsource.nodeid] = newsource

        newsink = Node(f"sink{compid}")
        newsink.component = compid
        sinkdir = RR if sink_ori == F else FF
        for i in range(len(sink_node.edges) - 1, -1, -1):
            e = sink_node.edges[i]
            if edgedir_start(e.dir) == sink_ori:
                other = self.get_edge_node(e)
                if other is not None and other is not sink_node:
                    other.remove_edge(sink_node.nodeid, fliplink(e.dir))
                    del sink_node.edges[i]
        newsink.add_edge(sink_mer, sinkdir, refid)
        newsink.is_sink = True
        sink_node.add_edge(newsink.nodeid, fliplink(sinkdir), refid)
        self.sink = newsink
        self.nodes[newsink.nodeid] = newsink

    # ------------------------------------------------------------------
    # cleanup (ref: Graph.cc:2486-2926)
    # ------------------------------------------------------------------
    def compress_node(self, node: Node, d: str) -> None:
        """Unitig chain merge (ref: Graph.cc:2486-2706).

        Implemented with deferred segment concatenation: the per-step
        array growth of the reference (O(chain^2) copying) is replaced by
        collecting segments and materializing once, while producing the
        exact same final state — including the dir==R
        reverse/append/re-reverse dance (net effect: reversed segments
        prepend) and the never-reversed cov_status append order."""
        K = self.K
        # deferred state: logical cov arrays = concat of cov_segs (dir F
        # appends at tail; dir R prepends reversed segments at head)
        cov_segs_t = [node.cov_distr_tmr]
        cov_segs_n = [node.cov_distr_nml]
        str_segs = [node.str_m]
        status_tail: list = []  # appended in merge order, never reversed
        cur_len = len(node.str_m)
        merged = False

        while True:
            uniqueid = node.get_buddy(d)
            if uniqueid == -1:
                break
            if node.is_tandem():
                break
            edir = node.edges[uniqueid].dir
            bdir = R if edir in (FF, RF) else F
            buddy = self.get_edge_node(node.edges[uniqueid])
            assert buddy is not None and not buddy.dead
            if buddy.is_tandem():
                break
            buniqueid = buddy.get_buddy(bdir)
            if buniqueid == -1:
                break
            assert buddy.edges[buniqueid].nodeid == node.nodeid

            merged = True
            dest_r = edgedir_dest(edir) == R
            bstr = rc_str(buddy.str_m) if dest_r else buddy.str_m
            bcov_t = buddy.cov_distr_tmr[::-1] if dest_r else buddy.cov_distr_tmr
            bcov_n = buddy.cov_distr_nml[::-1] if dest_r else buddy.cov_distr_nml

            amerlen = cur_len - K + 1
            bmerlen = len(bstr) - K + 1

            if d == R:
                # node reversed, segment appended, reversed back ==
                # reversed segment prepends
                str_segs.insert(0, rc_str(bstr[K - 1 :]))
                cov_segs_t.insert(0, bcov_t[K - 1 :][::-1])
                cov_segs_n.insert(0, bcov_n[K - 1 :][::-1])
            else:
                str_segs.append(bstr[K - 1 :])
                cov_segs_t.append(bcov_t[K - 1 :])
                cov_segs_n.append(bcov_n[K - 1 :])
            status_tail.append(buddy.cov_status[K - 1 :])

            # readstarts: replicate the per-step reversal/shift exactly
            if node.readstarts or buddy.readstarts:
                new_len = cur_len + len(bstr) - K + 1
                if d == R:
                    for rs in node.readstarts:
                        rs[1] = cur_len - 1 - rs[1]
                        rs[3] = F if rs[3] == R else R
                brs = buddy.readstarts
                if dest_r:
                    blen = len(buddy.str_m)
                    brs = [[r[0], blen - 1 - r[1], r[2], F if r[3] == R else R]
                           for r in brs]
                for rs in brs:
                    node.readstarts.append([rs[0], rs[1] + amerlen, rs[2], rs[3]])
                if d == R:
                    for rs in node.readstarts:
                        rs[1] = new_len - 1 - rs[1]
                        rs[3] = F if rs[3] == R else R

            node.bx_tmr_fwd |= buddy.bx_tmr_fwd
            node.bx_tmr_rev |= buddy.bx_tmr_rev
            node.bx_nml_fwd |= buddy.bx_nml_fwd
            node.bx_nml_rev |= buddy.bx_nml_rev

            tot = amerlen + bmerlen
            node.cov_tmr_fwd = (node.cov_tmr_fwd * amerlen + buddy.cov_tmr_fwd * bmerlen) / tot
            node.cov_nml_fwd = (node.cov_nml_fwd * amerlen + buddy.cov_nml_fwd * bmerlen) / tot
            node.cov_tmr_rev = (node.cov_tmr_rev * amerlen + buddy.cov_tmr_rev * bmerlen) / tot
            node.cov_nml_rev = (node.cov_nml_rev * amerlen + buddy.cov_nml_rev * bmerlen) / tot

            node.reads |= buddy.reads
            cur_len = cur_len + len(bstr) - K + 1

            buddy.dead = True
            if buddy.is_ref:
                node.is_ref = True
            if buddy.is_normal:
                node.is_normal = True
            if buddy.is_tumor:
                node.is_tumor = True

            del node.edges[uniqueid]
            for i, be in enumerate(buddy.edges):
                if i == buniqueid:
                    continue
                ne = Edge(be.nodeid, be.dir)
                ne.flag = be.flag
                ne.readids = list(be.readids)
                if edir in (FR, RF):
                    ne.dir = flipme(ne.dir)
                other = self.get_edge_node(ne)
                if other is buddy:
                    ne.nodeid = node.nodeid
                    node.edges.append(ne)
                else:
                    node.edges.append(ne)
                    other.update_edge(buddy.nodeid, fliplink(be.dir),
                                      node.nodeid, fliplink(ne.dir))

        if merged:
            node.str_m = "".join(str_segs)
            node.cov_distr_tmr = np.concatenate(cov_segs_t, axis=0)
            node.cov_distr_nml = np.concatenate(cov_segs_n, axis=0)
            for seg in status_tail:
                node.cov_status.extend(seg)
            node.compute_min_cov()
            node.sort_read_starts()

    def compress(self, compid: int) -> None:
        if self.verbose:
            print("compressing graph:", end="", file=sys.stderr)
        for n in self.node_iter():
            if n.component == compid:
                if n.dead or n.is_special():
                    continue
                self.compress_node(n, F)
                self.compress_node(n, R)
        self.clean_dead()

    def clean_dead(self) -> None:
        dead = [k for k, n in self.nodes.items() if n.dead]
        if self.verbose:
            print(f"  removing {len(dead)} dead nodes", file=sys.stderr)
        for k in sorted(dead):  # reference collects into std::set (sorted)
            del self.nodes[k]

    def remove_node(self, node: Node) -> None:
        assert not node.dead
        node.dead = True
        for e in node.edges:
            nn = self.get_edge_node(e)
            if nn is not None and nn is not node:
                nn.remove_edge(node.nodeid, fliplink(e.dir))

    def remove_low_cov(self, docompression: bool, compid: int) -> None:
        """(ref: Graph.cc:2790-2827) — prune on min quality-gated coverage."""
        if self.verbose:
            print("\nremoving low coverage:", end="", file=sys.stderr)
        lowcovnodes = 0
        avgcov = self.totalreadbp / len(self.ref.rawseq)
        for node in self.node_iter():
            if node.component != compid or node.dead:
                continue
            if node.is_special():
                continue
            if (node.mincov_qv <= self.LOW_COV_THRESHOLD
                    or node.mincov_qv <= self.MIN_COV_RATIO * avgcov
                    or (node.tot_tmr_cov() == 1 and node.tot_nml_cov() == 1)):
                lowcovnodes += 1
                self.remove_node(node)
        if self.verbose:
            print(f" found {lowcovnodes}", end="", file=sys.stderr)
        self.clean_dead()
        if docompression:
            self.compress(compid)
        if self.verbose:
            self.print_stats(compid)

    def remove_tips(self, compid: int) -> None:
        """(ref: Graph.cc:2885-2926)"""
        rnd = 0
        while True:
            tips = 0
            rnd += 1
            if self.verbose:
                print(f"\nremove tips round: {rnd}", end="", file=sys.stderr)
            for cur in self.node_iter():
                if cur.component != compid or cur.dead:
                    continue
                if cur.is_special():
                    continue
                deg = len(cur.edges)
                ln = cur.strlen() - self.K + 1
                if deg <= 1 and ln < self.MAX_TIP_LEN:
                    self.remove_node(cur)
                    tips += 1
            if self.verbose:
                print(f" removed: {tips}", file=sys.stderr)
            if tips:
                # reference calls compress() which also cleans dead nodes
                self.compress(compid)
            else:
                break
        if self.verbose:
            self.print_stats(compid)

    def remove_short_links(self, compid: int) -> None:
        """(ref: Graph.cc:2833-2880)"""
        import math

        links = 0
        if self.verbose:
            print("\nremove short links: ", end="", file=sys.stderr)
        avgcov = self.totalreadbp / len(self.ref.rawseq)
        thr = math.floor(math.sqrt(avgcov))
        for cur in self.node_iter():
            if cur.component != compid or cur.dead:
                continue
            if cur.is_special():
                continue
            deg = len(cur.edges)
            ln = cur.get_size()
            if deg >= 2 and ln < self.MAX_LINK_LEN and cur.mincov <= thr:
                _, L, _ = find_tandems(cur.str_m, self.cfg.max_unit_len,
                                       self.cfg.min_report_units,
                                       self.cfg.min_report_len,
                                       self.cfg.dist_from_str, self.K - 1)
                if L == 0:
                    self.remove_node(cur)
                    links += 1
        if self.verbose:
            print(f" removed links: {links}", file=sys.stderr)
        if links:
            self.compress(compid)
        if self.verbose:
            self.print_stats(compid)

    # ------------------------------------------------------------------
    # path enumeration (ref: Graph.cc:1299-1501)
    # ------------------------------------------------------------------
    def bfs(self, source: Node, sink: Node, d: str) -> Path | None:
        reflen = len(self.ref.seq)
        visit = 0
        complete = 0
        q: deque[Path] = deque()
        path = Path(self.K)
        path.nodes.append(source)
        path.dir = d
        path.len_m = self.K
        best: Path | None = None
        q.append(path)
        while q:
            visit += 1
            if self.DFS_LIMIT and visit > self.DFS_LIMIT:
                break
            path = q.popleft()
            cur = path.cur_node()
            if cur is sink and path.flag == 0:
                complete += 1
                if best is None or path.score > best.score:
                    best = Path(self.K, path)
            elif path.len_m > reflen + self.MAX_INDEL_LEN:
                pass  # too long
            else:
                tried = 0
                for edge in cur.edges:
                    if edge.isdir(path.dir):
                        tried += 1
                        other = self.get_edge_node(edge)
                        if not path.has_cycle_m:
                            path.has_cycle(other)
                        newpath = Path(self.K, path)
                        newpath.nodes.append(other)
                        newpath.edges.append(edge)
                        newpath.edgedir.append(edge.dir)
                        newpath.dir = edge.destdir()
                        newpath.len_m = path.len_m + other.strlen() - self.K + 1
                        newpath.flag = path.flag * edge.flag
                        if edge.flag == 0:
                            newpath.score = path.score + 1
                        q.append(newpath)
        if complete == 0:
            best = None
        return best

    def eka(self, source: Node, sink: Node, d: str) -> None:
        """Edmonds–Karp-style edge-covering path enumeration feeding
        process_path (ref: Graph.cc:1430-1501). Under verbose, prints the
        reference's path-class counters (perfect/withsnps/withindel/
        withmix, Graph.cc:1481-1493); classification mirrors the
        reference quirk that snp/ins/del bp are only tallied under
        verbose (inside printVerticalAlignment, Graph.cc:749-766)."""
        if self.verbose:
            print(f"\nsearching from {source.nodeid} to {sink.nodeid} "
                  f"dir: {d}", file=sys.stderr)
        complete = 0
        allcycles = 0
        perfect = withsnps = withindel = withmix = 0
        while True:
            path = self.bfs(source, sink, d)
            if path is None:
                break
            if path.has_cycle_m:
                allcycles += 1
            complete += 1
            cls = self.process_path(path, self.ref, complete)
            if cls is not None:
                snp, ins, dele = cls
                if snp + ins + dele == 0:
                    perfect += 1
                elif snp == 0:
                    withindel += 1
                elif ins + dele == 0:
                    withsnps += 1
                else:
                    withmix += 1
            for e in path.edges:
                e.flag = 1
        if self.verbose:
            print(f" refcomp: {self.ref.refcomp} "
                  f"refnodes: {self.ref.refnodes - 2} "
                  f"complete: {complete} allcycles: {allcycles}",
                  file=sys.stderr)
            print(f" perfect: {perfect} withsnps: {withsnps} "
                  f"withindel: {withindel} withmix: {withmix} "
                  f"withmixindel: {withmix + withindel}", file=sys.stderr)

    def find_repeats_in_graph_paths(self, ref) -> bool:
        """(ref: Graph.cc:686-730)"""
        if self.verbose:
            print("\nlooking for near-perfect repeats:", file=sys.stderr)
        if self.source is None or self.sink is None:
            if self.verbose:
                print("Missing source or sink", file=sys.stderr)
            return False
        if self.verbose:
            print(f"\nsearching from {self.source.nodeid} to "
                  f"{self.sink.nodeid} dir: {F}", file=sys.stderr)
        answer = False
        touched: list[Edge] = []
        while True:
            path = self.bfs(self.source, self.sink, F)
            if path is None:
                break
            if is_almost_repeat(path.str(), self.K, self.MAX_MISMATCH):
                answer = True
                if self.verbose:
                    print("Near-perfect repeat in assembled sequence for "
                          f"kmer {self.K}", file=sys.stderr)
                break
            for e in path.edges:
                e.flag = 1
                touched.append(e)
        for e in touched:
            e.flag = 0
        return answer

    def has_repeats_in_graph_paths(self, ref) -> bool:
        return self.find_repeats_in_graph_paths(ref)

    def count_ref_path(self) -> None:
        """(ref: Graph.cc:2420-2445)"""
        if self.source is not None:
            if self.sink is not None:
                self.eka(self.source, self.sink, F)
            if self.verbose:  # alignRefNodes (ref: Graph.cc:2400-2415)
                refpathnodes = sum(1 for n in self.node_iter()
                                   if n.on_ref_path)
                print(f" Found {refpathnodes} on ref path", file=sys.stderr)

    # ------------------------------------------------------------------
    # path -> variants (ref: Graph.cc:788-1220)
    # ------------------------------------------------------------------
    def process_path(self, path: Path, ref, complete: int) -> None:
        """Capture the path as an array-based job, align (immediately in
        oracle mode, deferred to a device batch when `path_sink` is set),
        and extract variants (engine.extract)."""
        from .extract import finish_path, make_path_job

        job = make_path_job(self, path, ref)
        cls = None
        if self.path_sink is not None:
            self.path_sink(job)
        else:
            if job.needs_dp:
                ref_aln, path_aln = global_align_aff(job.refseq, job.pathseq)
            else:
                ref_aln, path_aln = job.refseq, job.pathseq
            finish_path(job, ref_aln, path_aln, self.cfg, self.vdb)
            if self.verbose:
                snp = ins = dele = 0
                for a, b in zip(ref_aln, path_aln):
                    if a == b:
                        pass
                    elif a == "-":
                        ins += 1
                    elif b == "-":
                        dele += 1
                    else:
                        snp += 1
                cls = (snp, ins, dele)

        for n in path.nodes:
            n.on_ref_path += 1
        return cls
