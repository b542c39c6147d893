"""BAM reader/writer + BAI index writer (own implementation from the
SAM/BAM spec; replaces the reference's vendored bamtools for reads-in and
provides test-data generation the reference binary can also consume).
"""

from __future__ import annotations

import struct

from ..engine.micro import Aln
from .bgzf import BgzfWriter, read_bgzf

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_NT = "=ACMGRSVTWYHKDBN"
_NT_CODE = {c: i for i, c in enumerate(_SEQ_NT)}


def _parse_tags(buf: bytes) -> dict:
    tags = {}
    p = 0
    n = len(buf)
    while p < n - 2:
        tag = buf[p : p + 2].decode("ascii")
        t = chr(buf[p + 2])
        p += 3
        if t == "A":
            tags[tag] = ("A", chr(buf[p])); p += 1
        elif t == "c":
            tags[tag] = ("c", struct.unpack_from("<b", buf, p)[0]); p += 1
        elif t == "C":
            tags[tag] = ("C", struct.unpack_from("<B", buf, p)[0]); p += 1
        elif t == "s":
            tags[tag] = ("s", struct.unpack_from("<h", buf, p)[0]); p += 2
        elif t == "S":
            tags[tag] = ("S", struct.unpack_from("<H", buf, p)[0]); p += 2
        elif t == "i":
            tags[tag] = ("i", struct.unpack_from("<i", buf, p)[0]); p += 4
        elif t == "I":
            tags[tag] = ("I", struct.unpack_from("<I", buf, p)[0]); p += 4
        elif t == "f":
            tags[tag] = ("f", struct.unpack_from("<f", buf, p)[0]); p += 4
        elif t in ("Z", "H"):
            end = buf.index(b"\0", p)
            tags[tag] = (t, buf[p:end].decode("ascii")); p = end + 1
        elif t == "B":
            sub = chr(buf[p]); cnt = struct.unpack_from("<I", buf, p + 1)[0]
            sz = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            p += 5 + cnt * sz
            tags[tag] = ("B", None)
        else:
            break
    return tags


class BamReader:
    """Whole-file in-memory BAM reader with region fetch.

    Suits window-scale test data; the native C++ streaming reader
    (lancet_jax/native) is the production path for full-genome BAMs.
    """

    def __init__(self, path: str):
        data = read_bgzf(path)
        if data[:4] != b"BAM\x01":
            raise ValueError("not a BAM file")
        l_text = struct.unpack_from("<i", data, 4)[0]
        self.header_text = data[8 : 8 + l_text].decode("ascii", "replace").rstrip("\0")
        p = 8 + l_text
        n_ref = struct.unpack_from("<i", data, p)[0]
        p += 4
        self.references: list[tuple[str, int]] = []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", data, p)[0]
            name = data[p + 4 : p + 4 + l_name - 1].decode("ascii")
            l_ref = struct.unpack_from("<i", data, p + 4 + l_name)[0]
            self.references.append((name, l_ref))
            p += 8 + l_name
        self._by_ref: dict[int, list[Aln]] = {}
        n = len(data)
        while p < n:
            block_size = struct.unpack_from("<i", data, p)[0]
            rec = data[p + 4 : p + 4 + block_size]
            p += 4 + block_size
            al, refid = self._parse_record(rec)
            self._by_ref.setdefault(refid, []).append(al)
        self._name_to_id = {nm: i for i, (nm, _) in enumerate(self.references)}

    @staticmethod
    def _parse_record(rec: bytes) -> tuple[Aln, int]:
        (refid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
         _next_refid, _next_pos, _tlen) = struct.unpack_from("<iiBBHHHiiii", rec, 0)
        q = 32
        name = rec[q : q + l_read_name - 1].decode("ascii")
        q += l_read_name
        cigar = []
        for _ in range(n_cigar):
            v = struct.unpack_from("<I", rec, q)[0]
            cigar.append((_CIGAR_OPS[v & 0xF], v >> 4))
            q += 4
        nbytes = (l_seq + 1) // 2
        seq_chars = []
        for i in range(l_seq):
            b = rec[q + (i >> 1)]
            code = (b >> 4) if (i & 1) == 0 else (b & 0xF)
            seq_chars.append(_SEQ_NT[code])
        q += nbytes
        qual = rec[q : q + l_seq]
        q += l_seq
        if l_seq and qual[0] == 0xFF:
            qual_s = ""
        else:
            qual_s = "".join(chr(c + 33) for c in qual)
        tags = _parse_tags(rec[q:])
        al = Aln(name=name, pos=pos, mapq=mapq, flag=flag,
                 seq="".join(seq_chars), qual=qual_s, cigar=cigar, tags=tags)
        return al, refid

    def sample_name(self) -> str:
        """First @RG SM field, 'NA' if absent (ref: Microassembler.cc:52-67)."""
        for line in self.header_text.splitlines():
            if line.startswith("@RG"):
                for fld in line.split("\t")[1:]:
                    if fld.startswith("SM:"):
                        return fld[3:]
        return "NA"

    def fetch(self, chrom: str, left: int, right: int):
        """Alignments potentially overlapping [left, right] in file order
        (bamtools SetRegion-iteration superset; lancet filters containment
        itself, Microassembler.cc:498-500)."""
        rid = self._name_to_id.get(chrom)
        if rid is None:
            return
        for al in self._by_ref.get(rid, []):
            if al.pos > right:
                break
            if al.end_position() >= left:
                yield al

    def first_record(self):
        """First alignment in file order (tag-presence probes)."""
        for rid in self._by_ref:
            for al in self._by_ref[rid]:
                return al
        return None


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _encode_tags(tags: dict) -> bytes:
    out = bytearray()
    for tag, (t, v) in tags.items():
        out += tag.encode("ascii") + t.encode("ascii")
        if t == "A":
            out += v.encode("ascii")
        elif t == "i":
            out += struct.pack("<i", v)
        elif t == "f":
            out += struct.pack("<f", v)
        elif t == "Z":
            out += v.encode("ascii") + b"\0"
        else:
            raise ValueError(f"unsupported tag type {t}")
    return bytes(out)


def write_bam(path: str, references: list[tuple[str, int]],
              records: list[tuple[int, Aln]], sample: str = "sample",
              write_index: bool = True) -> None:
    """Write a coordinate-sorted BAM (+.bai). `records` is a list of
    (refid, Aln) already sorted by (refid, pos)."""
    w = BgzfWriter(path)
    sq = "".join(f"@SQ\tSN:{nm}\tLN:{ln}\n" for nm, ln in references)
    text = f"@HD\tVN:1.6\tSO:coordinate\n{sq}@RG\tID:rg1\tSM:{sample}\n"
    hdr = b"BAM\x01" + struct.pack("<i", len(text)) + text.encode("ascii")
    hdr += struct.pack("<i", len(references))
    for nm, ln in references:
        nb = nm.encode("ascii") + b"\0"
        hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    w.write(hdr)
    w.flush()

    voffsets = []
    for refid, al in records:
        voffsets.append(w.tell_virtual())
        w.write(_encode_record(refid, al))
        w.flush()  # one record per block -> trivial virtual offsets
    end_voffset = w.tell_virtual()
    w.close()

    if write_index:
        _write_bai(path + ".bai", references, records, voffsets, end_voffset)


def _encode_record(refid: int, al: Aln) -> bytes:
    name = al.name.encode("ascii") + b"\0"
    cigar = b"".join(struct.pack("<I", (n << 4) | _CIGAR_OPS.index(op))
                     for op, n in al.cigar)
    l_seq = len(al.seq)
    seq4 = bytearray((l_seq + 1) // 2)
    for i, ch in enumerate(al.seq):
        code = _NT_CODE.get(ch.upper(), 15)
        if i & 1:
            seq4[i >> 1] |= code
        else:
            seq4[i >> 1] |= code << 4
    qual = bytes((ord(c) - 33) for c in al.qual) if al.qual else b"\xff" * l_seq
    tags = _encode_tags(al.tags)
    end = al.end_position()
    bin_ = _reg2bin(al.pos, end if end > al.pos else al.pos + 1)
    body = struct.pack("<iiBBHHHiiii", refid, al.pos, len(name), al.mapq,
                       bin_, len(al.cigar), al.flag, l_seq, -1, -1, 0)
    body += name + cigar + bytes(seq4) + qual + tags
    return struct.pack("<i", len(body)) + body


def _write_bai(path: str, references, records, voffsets, end_voffset) -> None:
    per_ref_bins: list[dict[int, list[tuple[int, int]]]] = [dict() for _ in references]
    per_ref_intv: list[dict[int, int]] = [dict() for _ in references]
    for idx, (refid, al) in enumerate(records):
        beg = al.pos
        end = al.end_position()
        if end <= beg:
            end = beg + 1
        b = _reg2bin(beg, end)
        vbeg = voffsets[idx]
        vend = voffsets[idx + 1] if idx + 1 < len(voffsets) else end_voffset
        per_ref_bins[refid].setdefault(b, []).append((vbeg, vend))
        for k in range(beg >> 14, ((end - 1) >> 14) + 1):
            cur = per_ref_intv[refid].get(k)
            if cur is None or vbeg < cur:
                per_ref_intv[refid][k] = vbeg
    out = bytearray(b"BAI\x01" + struct.pack("<i", len(references)))
    for refid in range(len(references)):
        bins = per_ref_bins[refid]
        out += struct.pack("<i", len(bins))
        for b, chunks in bins.items():
            # merge adjacent chunks
            merged: list[list[int]] = []
            for beg, end in chunks:
                if merged and merged[-1][1] == beg:
                    merged[-1][1] = end
                else:
                    merged.append([beg, end])
            out += struct.pack("<I", b) + struct.pack("<i", len(merged))
            for beg, end in merged:
                out += struct.pack("<QQ", beg, end)
        intv = per_ref_intv[refid]
        n_intv = (max(intv.keys()) + 1) if intv else 0
        out += struct.pack("<i", n_intv)
        last = 0
        for k in range(n_intv):
            if k in intv:
                last = intv[k]
            out += struct.pack("<Q", last)
    with open(path, "wb") as f:
        f.write(bytes(out))
