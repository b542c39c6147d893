"""Path -> variants: array-based transcript extraction, decoupled from live
graph objects (ref: Graph.cc:788-1220 `processPath`).

`make_path_job` captures everything the column-scan state machine needs as
plain arrays, so alignment can run batched on device across windows and
extraction can be replayed later in the original order (preserving the
reference's order-sensitive dedup). Both engines share this code: the
oracle aligns immediately, the device engine defers to a batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .mer import canonical
from .node import NML, TMR
from .seqs import find_tandems, hamming_distance
from .transcript import Transcript
from .variant import Variant

HD_CUTOFF = 5


@dataclass
class PathJob:
    refchr: str
    refstart: int
    trim5: int
    refseq: str
    pathseq: str
    K: int
    covN: np.ndarray  # [L, 10]
    covT: np.ndarray
    tumor_span: np.ndarray  # bool [L+1]: pathcontig(pos).is_status_cnt('T')
    ref_cov_nml: np.ndarray  # [raw_len, 10]
    ref_cov_tmr: np.ndarray
    needs_dp: bool = False
    lr_mode: bool = False
    # LR-mode barcode lookups (captured dict references)
    bx_graph_tmr: dict | None = None
    bx_graph_nml: dict | None = None
    bx_ref_tmr: dict | None = None
    bx_ref_nml: dict | None = None


def make_path_job(graph, path, ref) -> PathJob:
    pathseq = path.str()
    covN = path.cov_distr("N")
    covT = path.cov_distr("T")
    L = covN.shape[0]
    # tumor_span[pos] = pathcontig(pos).is_status_cnt('T'); pathcontig
    # returns the first node with curpos+span >= pos, so node i covers
    # (hi_{i-1}, hi_i] with hi strictly increasing — fill by ranges.
    tumor_span = np.zeros(L + 1, dtype=bool)
    cur = 0
    prev_hi = -1
    status_cache: dict[int, bool] = {}
    for n in path.nodes:
        if n.is_special():
            continue
        span = len(n.str_m)
        hi = cur + span
        lo = max(prev_hi + 1, 0)
        if lo <= min(hi, L):
            key = id(n)
            st = status_cache.get(key)
            if st is None:
                st = n.is_status_cnt(ord("T"))
                status_cache[key] = st
            if st:
                tumor_span[lo : min(hi, L) + 1] = True
        prev_hi = hi
        cur += span - graph.K + 1
        if prev_hi >= L:
            break
    hd = hamming_distance(ref.seq, pathseq)
    return PathJob(
        refchr=ref.refchr, refstart=ref.refstart, trim5=ref.trim5,
        refseq=ref.seq, pathseq=pathseq, K=graph.K,
        covN=covN, covT=covT, tumor_span=tumor_span,
        ref_cov_nml=ref.normal_coverage, ref_cov_tmr=ref.tumor_coverage,
        needs_dp=(hd == -1 or hd > HD_CUTOFF),
        lr_mode=graph.LR_MODE,
        bx_graph_tmr=graph.bx_table_tmr, bx_graph_nml=graph.bx_table_nml,
        bx_ref_tmr=ref.bx_table_tmr, bx_ref_nml=ref.bx_table_nml)


_ZERO_ROW = np.zeros(10, dtype=np.int32)


def _ref_cov_at(job: PathJob, pos: int, sample: int) -> np.ndarray:
    cov = job.ref_cov_nml if sample == NML else job.ref_cov_tmr
    if cov is not None and 0 <= pos < cov.shape[0]:
        return cov[pos]
    return _ZERO_ROW


def _bx_set(table: dict, start: int, end: int, seq: str, k: int) -> str:
    # C++ substr throws out_of_range for pos > size (negative int -> huge
    # size_type); the exception aborts this path's remaining transcripts
    if start < 0 or end > len(seq):
        raise IndexError("BX lookup out of range")
    out: set[str] = set()
    for i in range(start, end + 1):
        cmer, _ = canonical(seq[i : i + k])
        if cmer in table:
            out |= table[cmer]
    return ";".join(sorted(out)) if out else "."


def finish_path(job: PathJob, ref_aln: str, path_aln: str, cfg, vdb) -> None:
    """Column-scan state machine -> transcripts -> variants (exact
    reference semantics; see engine.graph docstrings for quirk notes)."""
    try:
        _scan(job, ref_aln, path_aln, cfg, vdb)
    except (IndexError, ValueError):
        # mirrors the reference's catch(std::out_of_range) swallow
        pass


def _scan(job: PathJob, ref_aln: str, path_aln: str, cfg, vdb) -> None:
    K = job.K
    covN, covT = job.covN, job.covT
    pos_in_ref = 0
    refpos = 0
    pathpos = 0
    code = "?"
    transcripts: list[Transcript] = []

    for i in range(len(ref_aln)):
        prev_code = code
        if ref_aln[i] == "-":
            code = "^"
            pos_in_ref = refpos
            pathpos += 1
        elif path_aln[i] == "-":
            code = "v"
            pos_in_ref = refpos
            refpos += 1
        else:
            code = "=" if ref_aln[i] == path_aln[i] else "x"
            pos_in_ref = refpos
            refpos += 1
            pathpos += 1

        if pathpos > len(job.tumor_span) - 1:
            break
        within_tumor_node = bool(job.tumor_span[pathpos])

        P = pathpos - 1
        COVn = covN[P]
        COVt = covT[P]
        REFn = _ref_cov_at(job, pos_in_ref + job.trim5, NML)
        REFt = _ref_cov_at(job, pos_in_ref + job.trim5, TMR)

        if code != "=":
            rrpos = pos_in_ref + job.refstart + job.trim5
            ts = len(transcripts)
            pr = i - 1
            while pr >= 0 and ref_aln[pr] not in "ACGT":
                pr -= 1
            pa = i - 1
            while pa >= 0 and path_aln[pa] not in "ACGT":
                pa -= 1
            if pr < 0 or pa < 0:
                raise IndexError("leading-gap alignment")

            if ts > 0 and prev_code != "=":
                t = transcripts[ts - 1]
                if within_tumor_node:
                    t.is_somatic = True
                t.ref += ref_aln[i]
                t.qry += path_aln[i]
                t.end_pos = P
                t.ref_end_pos = pos_in_ref
                if code == "^" and t.code == code and t.pos == rrpos:
                    t.add_alt_cov_nml(COVn)
                    t.add_alt_cov_tmr(COVt)
                elif code == "v" and t.code == code and (t.pos + len(t.ref)) == rrpos:
                    t.add_ref_cov_nml(REFn)
                    t.add_ref_cov_tmr(REFt)
                elif code == "x" or t.code != code:
                    t.code = "c"
                    t.add_alt_cov_nml(COVn)
                    t.add_alt_cov_tmr(COVt)
                    t.add_ref_cov_nml(REFn)
                    t.add_ref_cov_tmr(REFt)
            else:
                transcripts.append(Transcript(
                    rrpos, pos_in_ref, P + 1, code, ref_aln[i], path_aln[i],
                    COVn, COVt, REFn, REFt, ref_aln[pr], path_aln[pa],
                    P, pos_in_ref, within_tumor_node))

    for t in transcripts:
        if t.code != "x":
            for j in range(K + 1):
                idx1 = t.end_pos + j
                if idx1 < covN.shape[0]:
                    if bool(job.tumor_span[idx1]):
                        t.is_somatic = True
                    t.add_alt_cov_nml(covN[idx1])
                    t.add_alt_cov_tmr(covT[idx1])
                idx2 = t.ref_end_pos + job.trim5 + j
                t.add_ref_cov_nml(_ref_cov_at(job, idx2, NML))
                t.add_ref_cov_tmr(_ref_cov_at(job, idx2, TMR))

        t.update_stats()

        RCNF, RCNR = t.min_ref_cov_N[0], t.min_ref_cov_N[1]
        RCTF, RCTR = t.min_ref_cov_T[0], t.min_ref_cov_T[1]
        ACNF = t.get_min_cov_N_fwd()
        ACNR = t.get_min_cov_N_rev()
        if t.code != "x":
            ACNF = t.get_min_non0_cov_N_fwd()
            ACNR = t.get_min_non0_cov_N_rev()
        ACTF = t.get_min_cov_T_fwd()
        ACTR = t.get_min_cov_T_rev()

        HP0RN, HP1RN, HP2RN = t.min_ref_cov_N[4], t.min_ref_cov_N[5], t.min_ref_cov_N[6]
        HP0RT, HP1RT, HP2RT = t.min_ref_cov_T[4], t.min_ref_cov_T[5], t.min_ref_cov_T[6]
        HP0AN = t.get_min_cov_N_hp(0)
        HP1AN = t.get_min_cov_N_hp(1)
        HP2AN = t.get_min_cov_N_hp(2)
        HP0AT = t.get_min_cov_T_hp(0)
        HP1AT = t.get_min_cov_T_hp(1)
        HP2AT = t.get_min_cov_T_hp(2)

        if t.is_somatic:
            RCNF, RCNR = t.mean_ref_cov_N[0], t.mean_ref_cov_N[1]
            RCTF, RCTR = t.mean_ref_cov_T[0], t.mean_ref_cov_T[1]
            ACNF = ACNR = 0
            HP0RT, HP1RT, HP2RT = t.mean_ref_cov_T[4], t.mean_ref_cov_T[5], t.mean_ref_cov_T[6]
            HP0RN, HP1RN, HP2RN = t.mean_ref_cov_N[4], t.mean_ref_cov_N[5], t.mean_ref_cov_N[6]
            HP0AN = HP1AN = HP2AN = 0

        if ACNF > 0 or ACNR > 0 or ACTF > 0 or ACTR > 0:
            ans, L, MOTIF = find_tandems(
                job.pathseq, cfg.max_unit_len, cfg.min_report_units,
                cfg.min_report_len, cfg.dist_from_str, t.start_pos)
            STR = f"{L}{MOTIF}" if ans else ""

            bx_ref_N = bx_ref_T = bx_alt_N = bx_alt_T = ""
            if job.lr_mode:
                bx_ref_N = _bx_set(job.bx_ref_nml, t.ref_pos - 1,
                                   t.ref_end_pos - 1, job.refseq, K)
                bx_ref_T = _bx_set(job.bx_ref_tmr, t.ref_pos - 1,
                                   t.ref_end_pos - 1, job.refseq, K)
                bx_alt_N = _bx_set(job.bx_graph_nml, t.start_pos - 2,
                                   t.end_pos - 1, job.pathseq, K)
                bx_alt_T = _bx_set(job.bx_graph_tmr, t.start_pos - 2,
                                   t.end_pos - 1, job.pathseq, K)

            v = Variant(
                lr_mode=job.lr_mode, chrom=job.refchr, pos=t.pos - 1,
                ref_str=t.ref, alt_str=t.qry,
                rcn=(RCNF, RCNR), rct=(RCTF, RCTR),
                acn=(ACNF, ACNR), act=(ACTF, ACTR),
                hprn=(HP1RN, HP2RN, HP0RN), hprt=(HP1RT, HP2RT, HP0RT),
                hpan=(HP1AN, HP2AN, HP0AN), hpat=(HP1AT, HP2AT, HP0AT),
                prev_bp_ref=t.prev_bp_ref, prev_bp_alt=t.prev_bp_alt,
                kmer=K, str_tag=STR, code=t.code,
                bx_ref_n=bx_ref_N, bx_ref_t=bx_ref_T,
                bx_alt_n=bx_alt_N, bx_alt_t=bx_alt_T)
            vdb.add_var(v)
