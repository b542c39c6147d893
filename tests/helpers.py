"""Synthetic read/BAM generation for tests and benchmarks."""

from __future__ import annotations

import random

from lancet_jax.engine.micro import Aln
from lancet_jax.io.bam import write_bam
from lancet_jax.io.fasta import write_fasta

BASES = "ACGT"


def make_reference(length: int, seed: int = 7) -> str:
    rng = random.Random(seed)
    return "".join(rng.choice(BASES) for _ in range(length))


def md_for(refseg: str, readseq: str) -> str:
    """MD tag for an all-M alignment."""
    out = []
    run = 0
    for r, q in zip(refseg, readseq):
        if r == q:
            run += 1
        else:
            out.append(str(run))
            out.append(r)
            run = 0
    out.append(str(run))
    return "".join(out)


def make_read(name: str, refseq: str, pos0: int, length: int, flag: int,
              mutations: dict[int, str] | None = None, mapq: int = 60,
              qual_char: str = "I", extra_tags: dict | None = None) -> Aln:
    """A fully-aligned (all-M) read at 0-based pos0 over refseq, with
    optional {refpos0: altbase} substitutions."""
    refseg = refseq[pos0 : pos0 + length]
    seq = list(refseg)
    if mutations:
        for p, b in mutations.items():
            if pos0 <= p < pos0 + length:
                seq[p - pos0] = b
    seq = "".join(seq)
    tags = {"MD": ("Z", md_for(refseg, seq)), "RG": ("Z", "rg1")}
    if extra_tags:
        tags.update(extra_tags)
    return Aln(name=name, pos=pos0, mapq=mapq, flag=flag, seq=seq,
               qual=qual_char * length, cigar=[("M", length)], tags=tags)


def tiled_reads(refseq: str, start0: int, end0: int, readlen: int, step: int,
                prefix: str, mutations: dict[int, str] | None = None,
                frac_mut: float = 1.0, seed: int = 1) -> list[Aln]:
    """Tile reads across [start0, end0); alternating strands; optionally a
    fraction of reads carries the mutations (deterministic by index)."""
    rng = random.Random(seed)
    out = []
    i = 0
    pos = start0
    while pos + readlen <= end0:
        flag = 0x10 if (i % 2) else 0x0
        mut = mutations if (mutations and rng.random() < frac_mut) else None
        out.append(make_read(f"{prefix}{i}", refseq, pos, readlen, flag, mut))
        i += 1
        pos += step
    return out


def write_pair(tmpdir: str, refseq: str, chrom: str, tumor: list[Aln],
               normal: list[Aln]):
    """Write reference FASTA + tumor/normal BAMs; returns paths."""
    ref_path = f"{tmpdir}/ref.fa"
    write_fasta(ref_path, {chrom: refseq})
    t_path = f"{tmpdir}/tumor.bam"
    n_path = f"{tmpdir}/normal.bam"
    write_bam(t_path, [(chrom, len(refseq))],
              [(0, a) for a in sorted(tumor, key=lambda a: a.pos)], sample="TUMOR")
    write_bam(n_path, [(chrom, len(refseq))],
              [(0, a) for a in sorted(normal, key=lambda a: a.pos)], sample="NORMAL")
    return ref_path, t_path, n_path
