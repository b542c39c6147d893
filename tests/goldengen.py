"""Golden-test scenario generation: synthetic tumor/normal pairs with
known events, consumable by both engines and by compiled reference lancet."""

from __future__ import annotations

import random

from lancet_jax.engine.micro import Aln

try:
    from tests.helpers import make_reference, md_for, write_pair
except ModuleNotFoundError:  # an installed package named `tests` shadows
    # this directory's namespace package; bench.py puts tests/ on sys.path
    from helpers import make_reference, md_for, write_pair

BASES = "ACGT"


def _md_from_cigar(refseq: str, pos0: int, cigar, readseq: str) -> str:
    """MD tag from CIGAR + sequences (M/I/D only)."""
    out = []
    run = 0
    rp = pos0
    qp = 0
    for op, ln in cigar:
        if op == "M":
            for i in range(ln):
                if refseq[rp + i] == readseq[qp + i]:
                    run += 1
                else:
                    out.append(str(run))
                    out.append(refseq[rp + i])
                    run = 0
            rp += ln
            qp += ln
        elif op == "I":
            qp += ln
        elif op == "D":
            out.append(str(run))
            out.append("^" + refseq[rp : rp + ln])
            run = 0
            rp += ln
    out.append(str(run))
    return "".join(out)


def hap_reads(refseq: str, edit, start0: int, end0: int, readlen: int,
              step: int, prefix: str, frac: float, seed: int,
              qual_char: str = "I", mapq: int = 60) -> list[Aln]:
    """Tile reads over [start0, end0); a `frac` fraction carries `edit`
    (('s', pos, base) | ('i', pos, seq) | ('d', pos, dellen)); reads not
    fully spanning the event fall back to reference reads."""
    rng = random.Random(seed)
    out = []
    i = 0
    for pos in range(start0, end0 - readlen + 1, step):
        flag = 0x10 if i % 2 else 0x0
        use_hap = edit is not None and rng.random() < frac
        name = f"{prefix}{i}"
        al = None
        if use_hap:
            kind, p, payload = edit
            if kind == "s":
                if pos <= p < pos + readlen:
                    seq = refseq[pos : pos + readlen]
                    seq = seq[: p - pos] + payload + seq[p - pos + 1 :]
                    cigar = [("M", readlen)]
                    al = Aln(name=name, pos=pos, mapq=mapq, flag=flag, seq=seq,
                             qual=qual_char * readlen, cigar=cigar,
                             tags={"MD": ("Z", md_for(refseq[pos : pos + readlen], seq)),
                                   "RG": ("Z", "rg1")})
            elif kind == "i":
                ins = payload
                if pos < p and pos + readlen >= p + len(ins) + 1:
                    a = p - pos
                    seq = refseq[pos:p] + ins + refseq[p : p + readlen - a - len(ins)]
                    cigar = [("M", a), ("I", len(ins)), ("M", readlen - a - len(ins))]
                    al = Aln(name=name, pos=pos, mapq=mapq, flag=flag, seq=seq,
                             qual=qual_char * readlen, cigar=cigar,
                             tags={"MD": ("Z", _md_from_cigar(refseq, pos, cigar, seq)),
                                   "RG": ("Z", "rg1")})
            elif kind == "d":
                dl = payload
                if pos < p and pos + readlen > p:
                    a = p - pos
                    seq = refseq[pos:p] + refseq[p + dl : p + dl + readlen - a]
                    cigar = [("M", a), ("D", dl), ("M", readlen - a)]
                    al = Aln(name=name, pos=pos, mapq=mapq, flag=flag, seq=seq,
                             qual=qual_char * readlen, cigar=cigar,
                             tags={"MD": ("Z", _md_from_cigar(refseq, pos, cigar, seq)),
                                   "RG": ("Z", "rg1")})
        if al is None:
            seq = refseq[pos : pos + readlen]
            al = Aln(name=name, pos=pos, mapq=mapq, flag=flag, seq=seq,
                     qual=qual_char * readlen, cigar=[("M", readlen)],
                     tags={"MD": ("Z", str(readlen)), "RG": ("Z", "rg1")})
        out.append(al)
        i += 1
    return out


def scenario(name: str, seed: int = 0):
    """-> (refseq, tumor_reads, normal_reads, region). Scenario families
    cover the reference's event types and filter paths."""
    rng = random.Random(seed * 9973 + 17)
    L = 2000
    refseq = make_reference(L, seed=seed + 100)
    c = L // 2
    region = f"chr1:{c - 50}-{c + 50}"
    rl, step = 100, 5
    lo, hi = c - 300, c + 300

    def other(b):
        return {"A": "C", "C": "G", "G": "T", "T": "A"}[b]

    if name == "somatic_snv":
        edit = ("s", c, other(refseq[c]))
        t = hap_reads(refseq, edit, lo, hi, rl, step, "t", 0.5, seed + 1)
        n = hap_reads(refseq, None, lo, hi, rl, step, "n", 0, seed + 2)
    elif name == "shared_snv":
        edit = ("s", c, other(refseq[c]))
        t = hap_reads(refseq, edit, lo, hi, rl, step, "t", 0.5, seed + 1)
        n = hap_reads(refseq, edit, lo, hi, rl, step, "n", 0.5, seed + 2)
    elif name == "normal_only_snv":
        edit = ("s", c, other(refseq[c]))
        t = hap_reads(refseq, None, lo, hi, rl, step, "t", 0, seed + 1)
        n = hap_reads(refseq, edit, lo, hi, rl, step, "n", 0.5, seed + 2)
    elif name == "somatic_ins":
        ins = "".join(rng.choice(BASES) for _ in range(rng.randint(1, 8)))
        edit = ("i", c, ins)
        t = hap_reads(refseq, edit, lo, hi, rl, step, "t", 0.6, seed + 1)
        n = hap_reads(refseq, None, lo, hi, rl, step, "n", 0, seed + 2)
    elif name == "somatic_del":
        edit = ("d", c, rng.randint(1, 10))
        t = hap_reads(refseq, edit, lo, hi, rl, step, "t", 0.6, seed + 1)
        n = hap_reads(refseq, None, lo, hi, rl, step, "n", 0, seed + 2)
    elif name == "low_vaf_snv":
        edit = ("s", c, other(refseq[c]))
        t = hap_reads(refseq, edit, lo, hi, rl, step, "t", 0.08, seed + 1)
        n = hap_reads(refseq, None, lo, hi, rl, step, "n", 0, seed + 2)
    elif name == "two_snvs":
        e1 = ("s", c - 20, other(refseq[c - 20]))
        e2 = ("s", c + 17, other(refseq[c + 17]))
        t = (hap_reads(refseq, e1, lo, c, rl, step, "ta", 0.5, seed + 1)
             + hap_reads(refseq, e2, c - 290, hi, rl, step, "tb", 0.5, seed + 3))
        n = hap_reads(refseq, None, lo, hi, rl, step, "n", 0, seed + 2)
    elif name == "adjacent_complex":
        # two adjacent substitutions -> complex event
        seq2 = refseq
        e1 = ("s", c, other(refseq[c]))
        t = hap_reads(seq2, e1, lo, hi, rl, step, "t", 0.5, seed + 1)
        # overwrite: apply second sub on top by editing seqs directly
        for al in t:
            p2 = c + 1
            if al.pos <= p2 < al.pos + rl and al.seq[p2 - al.pos] == refseq[p2] and al.seq[c - al.pos] != refseq[c]:
                s = al.seq
                al.seq = s[: p2 - al.pos] + other(refseq[p2]) + s[p2 - al.pos + 1 :]
                al.tags["MD"] = ("Z", md_for(refseq[al.pos : al.pos + rl], al.seq))
        n = hap_reads(refseq, None, lo, hi, rl, step, "n", 0, seed + 2)
    elif name == "str_indel":
        # homopolymer run with a 1bp somatic expansion
        run_start = c - 6
        refseq = refseq[:run_start] + "A" * 12 + refseq[run_start + 12 :]
        edit = ("i", run_start + 6, "A")
        t = hap_reads(refseq, edit, lo, hi, rl, step, "t", 0.6, seed + 1)
        n = hap_reads(refseq, None, lo, hi, rl, step, "n", 0, seed + 2)
    elif name == "quality_trimmed":
        edit = ("s", c, other(refseq[c]))
        t = hap_reads(refseq, edit, lo, hi, rl, step, "t", 0.5, seed + 1)
        n = hap_reads(refseq, None, lo, hi, rl, step, "n", 0, seed + 2)
        for al in t + n:
            # low-quality 10bp tails -> exercises the 5'/3' trim path
            al.qual = "#" * 10 + "I" * (len(al.seq) - 20) + "#" * 10
    elif name == "paired_overlap":
        # overlapping mate pairs (fragment 160bp, 100bp reads -> 40bp
        # overlap) exercise the mate-dedup binary_search quirk
        edit = ("s", c, other(refseq[c]))
        t = []
        n = []
        frag = 160
        i = 0
        for pos in range(lo, hi - frag, step):
            for sample, reads, carry in (("t", t, rng.random() < 0.5),
                                         ("n", n, False)):
                e = edit if (sample == "t" and carry) else None
                r1 = hap_reads(refseq, e, pos, pos + rl, rl, rl, f"frag{i}_x",
                               1.0 if e else 0, seed + i)[0]
                r2 = hap_reads(refseq, e, pos + frag - rl, pos + frag, rl, rl,
                               f"frag{i}_x", 1.0 if e else 0, seed + i)[0]
                r1.name = r2.name = f"{sample}frag{i}"
                r1.flag = 0x1 | 0x40 | (r1.flag & 0x10)
                r2.flag = 0x1 | 0x80 | 0x10
                reads += [r1, r2]
            i += 1
    elif name == "lr_snv":
        # linked-reads: BX barcodes + HP haplotypes on every read
        edit = ("s", c, other(refseq[c]))
        t = hap_reads(refseq, edit, lo, hi, rl, step, "t", 0.5, seed + 1)
        n = hap_reads(refseq, None, lo, hi, rl, step, "n", 0, seed + 2)
        for al in t + n:
            has_alt = c - al.pos >= 0 and c - al.pos < rl and al.seq[c - al.pos] != refseq[c]
            bc = rng.randrange(6)
            al.tags["BX"] = ("Z", f"BX{bc:03d}-1")
            al.tags["HP"] = ("i", (2 if has_alt else 1) if rng.random() < 0.8 else 0)
    elif name == "lr_indel":
        # linked reads on an insertion: exercises the non-SNV HP column
        # selection (cols 4-6) and BX span lookups over gapped alignments
        ins = "".join(rng.choice("ACGT") for _ in range(4))
        edit = ("i", c, ins)
        t = hap_reads(refseq, edit, lo, hi, rl, step, "t", 0.5, seed + 1)
        n = hap_reads(refseq, None, lo, hi, rl, step, "n", 0, seed + 2)
        for al in t + n:
            has_alt = any(op == "I" for op, _ in al.cigar)
            bc = rng.randrange(4)
            al.tags["BX"] = ("Z", f"BX{bc:03d}-1")
            al.tags["HP"] = ("i", (2 if has_alt else 1)
                             if rng.random() < 0.7 else 0)
    elif name == "lr_mixed":
        # some reads without BX/HP tags (the "null" barcode path: add_hp
        # still fires per visit — oracle quirk) + a shared SNV
        edit = ("s", c, other(refseq[c]))
        t = hap_reads(refseq, edit, lo, hi, rl, step, "t", 0.6, seed + 1)
        n = hap_reads(refseq, edit, lo, hi, rl, step, "n", 0.4, seed + 2)
        for al in t + n:
            if rng.random() < 0.6:
                al.tags["BX"] = ("Z", f"BX{rng.randrange(8):03d}-1")
            if rng.random() < 0.5:
                al.tags["HP"] = ("i", rng.randrange(3))
    elif name == "tag_filters":
        # BWA aux-tag filter chain (Microassembler.cc:524-559): AS/XS
        # score-gap drop, XT:A:R repeat drop (tumor only), XM counting
        edit = ("s", c, other(refseq[c]))
        t = hap_reads(refseq, edit, lo, hi, rl, step, "t", 0.6, seed + 1)
        n = hap_reads(refseq, None, lo, hi, rl, step, "n", 0, seed + 2)
        for i, al in enumerate(t):
            al.tags["AS"] = ("i", 100)
            if i % 3 == 0:
                al.tags["XS"] = ("i", 97)  # |AS-XS|=3 <= 5: dropped (tumor)
            elif i % 3 == 1:
                al.tags["XS"] = ("i", 80)  # gap 20: kept
                if i % 6 == 1:
                    al.tags["XT"] = ("A", "R")  # repeat-marked: dropped
            else:
                al.tags["XM"] = ("i", 6)  # counted, not dropped
        for i, al in enumerate(n):
            if i % 4 == 0:
                al.tags["XT"] = ("A", "R")  # normal keeps XT:A:R reads
            if i % 5 == 0:
                al.tags["AS"] = ("i", 60)
                al.tags["XS"] = ("i", 60)  # normal skips the AS-XS drop
    elif name == "xa_filtered":
        # XA alternative-hit filter under -O (Microassembler.cc:570-579):
        # tumor XA reads dropped, normal XA reads kept (counted)
        edit = ("s", c, other(refseq[c]))
        t = hap_reads(refseq, edit, lo, hi, rl, step, "t", 0.6, seed + 1)
        n = hap_reads(refseq, None, lo, hi, rl, step, "n", 0, seed + 2)
        for i, al in enumerate(t):
            if i % 2 == 0:
                al.tags["XA"] = ("Z", "chr1,+100,100M,1;")
        for i, al in enumerate(n):
            if i % 3 == 0:
                al.tags["XA"] = ("Z", "chr1,+100,100M,1;")
    elif name == "duplicates":
        # duplicate-flagged reads are dropped in both samples
        # (Microassembler.cc:504)
        edit = ("s", c, other(refseq[c]))
        t = hap_reads(refseq, edit, lo, hi, rl, step, "t", 0.6, seed + 1)
        n = hap_reads(refseq, None, lo, hi, rl, step, "n", 0, seed + 2)
        for i, al in enumerate(t):
            if i % 3 == 0:
                al.flag |= 0x400
        for i, al in enumerate(n):
            if i % 5 == 0:
                al.flag |= 0x400
    elif name == "bastard_mates":
        # placed-unmapped mates (flag 0x4, CIGAR '*', MAPQ 0): the normal
        # scan (MAPQ cutoff 0) admits them as BASTARD reads
        # (Microassembler.cc:618-626, Graph addAlignment code UNMAPPED);
        # the tumor MAPQ>=15 cut drops its own. The alt-carrying unmapped
        # normal reads add normal support: mishandling them flips the
        # call's SOMATIC/SHARED state.
        edit = ("s", c, other(refseq[c]))
        t = hap_reads(refseq, edit, lo, hi, rl, step, "t", 0.5, seed + 1)
        n = hap_reads(refseq, None, lo, hi, rl, step, "n", 0, seed + 2)
        n_alt = hap_reads(refseq, edit, c - 200, c + 200, rl, 15, "nu",
                          1.0, seed + 3)
        for al in n_alt:
            al.flag = (al.flag & 0x10) | 0x1 | 0x4 | 0x40
            al.mapq = 0
            al.cigar = []
            al.tags.pop("MD", None)
        n += n_alt
        t_un = hap_reads(refseq, edit, c - 200, c + 200, rl, 21, "tu",
                         1.0, seed + 4)
        for al in t_un:
            al.flag = (al.flag & 0x10) | 0x1 | 0x4 | 0x40
            al.mapq = 0
            al.cigar = []
            al.tags.pop("MD", None)
        t += t_un
    elif name == "rg_allowlist":
        # --rg-file allowlist (Microassembler.cc:29-44, 616): reads in
        # unlisted read groups are excluded from the graph
        edit = ("s", c, other(refseq[c]))
        t = hap_reads(refseq, edit, lo, hi, rl, step, "t", 0.6, seed + 1)
        n = hap_reads(refseq, None, lo, hi, rl, step, "n", 0, seed + 2)
        for i, al in enumerate(t):
            if i % 2:
                al.tags["RG"] = ("Z", "rg2")
        for i, al in enumerate(n):
            if i % 4 == 0:
                al.tags["RG"] = ("Z", "rg2")
    elif name == "k75_dup":
        # exact 70bp tandem duplication upstream of the event: isRepeat/
        # isAlmostRepeat gate every k <= 73, so the retry ladder must
        # reach k=75 (higher than the device engine's k<=63 packing) for
        # a PASS somatic call — KMERSIZE=75 in the emitted record
        # (ref: Microassembler.cc:109-235, util.cc:295-360)
        base = list(refseq)
        seg = base[c - 150 : c - 80]
        base[c - 80 : c - 10] = seg
        refseq = "".join(base)
        edit = ("s", c + 40, other(refseq[c + 40]))
        t = hap_reads(refseq, edit, c - 500, c + 500, rl, 2, "t", 0.6,
                      seed + 1)
        n = hap_reads(refseq, None, c - 500, c + 500, rl, 2, "n", 0,
                      seed + 2)
        region = f"chr1:{c - 50}-{c + 90}"
    elif name == "random_storm":
        edits = []
        for _ in range(6):
            p = rng.randint(c - 250, c + 250)
            edits.append(("s", p, other(refseq[p])))
        t = []
        n = []
        for idx, e in enumerate(edits):
            t += hap_reads(refseq, e, max(0, e[1] - 150), min(L, e[1] + 150),
                           rl, 25, f"t{idx}_", rng.random(), seed + idx)
            n += hap_reads(refseq, e if rng.random() < 0.3 else None,
                           max(0, e[1] - 150), min(L, e[1] + 150),
                           rl, 25, f"n{idx}_", rng.random() * 0.5, seed + 50 + idx)
        region = f"chr1:{c - 260}-{c + 260}"
    else:
        raise ValueError(name)
    return refseq, t, n, region


ALL_SCENARIOS = [
    "somatic_snv", "shared_snv", "normal_only_snv", "somatic_ins",
    "somatic_del", "low_vaf_snv", "two_snvs", "adjacent_complex",
    "str_indel", "quality_trimmed", "paired_overlap", "random_storm",
    "tag_filters", "xa_filtered", "duplicates", "bastard_mates",
    "rg_allowlist", "k75_dup",
]

LR_SCENARIOS = ["lr_snv", "lr_indel", "lr_mixed"]


def scenario_extras(name: str, tmpdir: str):
    """Extra reference-binary argv + Config overrides some scenarios
    need (written into `tmpdir` when they require a side file)."""
    if name == "xa_filtered":
        return ["-O"], {"xa_filter": True}
    if name == "rg_allowlist":
        path = f"{tmpdir}/rg.txt"
        with open(path, "w") as f:
            f.write("rg1\n")
        return ["--rg-file", path], {"rg_file": path}
    return [], {}


def fuzz_corpus(seed: int, n_events: int = 50, spacing: int = 1200):
    """One chromosome with `n_events` randomized event sites (mixed SNV /
    ins / del / adjacent-complex, random VAFs, shared-with-normal mix-ins,
    quality-tail and soft-clip noise) -> (refseq, tumor, normal, region).
    Exercises the same filter/event paths as the reference across many
    windows in a single run."""
    rng = random.Random(seed * 7919 + 3)
    margin = 600
    L = n_events * spacing + 2 * margin
    refseq = make_reference(L, seed=seed + 5000)
    other = {"A": "C", "C": "G", "G": "T", "T": "A"}
    tumor: list[Aln] = []
    normal: list[Aln] = []
    rl, step = 100, 5
    for idx in range(n_events):
        c = margin + idx * spacing + spacing // 2
        lo, hi = c - 160, c + 160
        kind = rng.choice(["s", "s", "s", "i", "d", "cx"])
        if kind == "s":
            edit = ("s", c, other[refseq[c]])
        elif kind == "i":
            edit = ("i", c, "".join(rng.choice(BASES)
                                    for _ in range(rng.randint(1, 8))))
        elif kind == "d":
            edit = ("d", c, rng.randint(1, 8))
        else:  # adjacent double substitution -> complex record
            edit = ("s", c, other[refseq[c]])
        vaf = rng.uniform(0.15, 0.9)
        t = hap_reads(refseq, edit, lo, hi, rl, step, f"ft{idx}_",
                      vaf, seed * 101 + idx)
        shared = rng.random() < 0.25
        n = hap_reads(refseq, edit if shared else None, lo, hi, rl, step,
                      f"fn{idx}_", 0.5 if shared else 0, seed * 103 + idx)
        if kind == "cx":
            # second substitution on top of the first (same haplotype)
            p2 = c + 1
            for al in t + (n if shared else []):
                off = p2 - al.pos
                if (0 <= off < len(al.seq) and al.seq[off] == refseq[p2]
                        and al.seq[c - al.pos] != refseq[c]
                        and al.cigar == [("M", rl)]):
                    al.seq = (al.seq[:off] + other[refseq[p2]]
                              + al.seq[off + 1:])
                    al.tags["MD"] = ("Z", md_for(refseq[al.pos:al.pos + rl],
                                                 al.seq))
        noise = rng.random()
        if noise < 0.2:
            # low-quality 8bp tails on every read -> 5'/3' trim path
            for al in t + n:
                al.qual = "#" * 8 + al.qual[8:-8] + "#" * 8
        elif noise < 0.4:
            # soft-clip noise: a few extra all-M reads re-marked with a
            # 12bp clip (alignment content unchanged -> parity-safe)
            for j, al in enumerate(t):
                if j % 7 == 0 and al.cigar == [("M", rl)]:
                    al.cigar = [("S", 12), ("M", rl - 12)]
                    al.pos += 12
                    al.tags["MD"] = ("Z", str(rl - 12))
        elif noise < 0.5:
            # MAPQ noise: every 9th tumor read below MIN_MAP_QUAL
            for j, al in enumerate(t):
                if j % 9 == 0:
                    al.mapq = 7
    # keep reads sorted by position for the BAM writer/index
        tumor += t
        normal += n
    tumor.sort(key=lambda a: a.pos)
    normal.sort(key=lambda a: a.pos)
    return refseq, tumor, normal, f"chr1:{margin}-{L - margin}"
