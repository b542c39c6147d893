"""Native C++ I/O plane vs pure-Python readers: record-for-record equality
on generated corpora (the Python readers are themselves golden-validated
against the reference binary via tests/test_golden.py)."""

import random

import pytest

from helpers import make_reference, make_read, tiled_reads, write_pair
from lancet_jax.io.bam import BamReader
from lancet_jax.io.fasta import FastaFile

native = pytest.importorskip("lancet_jax.native")

try:
    native.load_library()
except native.NativeUnavailable as e:  # pragma: no cover
    pytest.skip(f"native toolchain unavailable: {e}", allow_module_level=True)


def _aln_key(a):
    return (a.name, a.pos, a.mapq, a.flag, a.seq, a.qual, tuple(a.cigar),
            tuple(sorted(a.tags.items())))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_io")
    refseq = make_reference(5000, seed=3)
    alt = {"A": "C", "C": "G", "G": "T", "T": "A"}[refseq[2500]]
    tumor = tiled_reads(refseq, 2100, 2900, 100, 7, "t", {2500: alt}, 0.5)
    # add soft clips, indels via cigar variety, tag variety
    extra = make_read("x1", refseq, 1000, 100, 0x10,
                      extra_tags={"AS": ("i", 90), "XS": ("i", 10),
                                  "BX": ("Z", "AAC-1"),
                                  "XT": ("A", "U"), "NM": ("i", 2)})
    extra.cigar = [("S", 5), ("M", 60), ("I", 3), ("M", 20), ("D", 2),
                   ("M", 12)]
    extra.seq = extra.seq[:100]
    tumor.append(extra)
    normal = tiled_reads(refseq, 2100, 2900, 100, 9, "n")
    write_pair(str(d), refseq, "chr9", tumor, normal)
    return str(d), refseq


def test_bam_reader_equivalence(corpus):
    d, _ = corpus
    py = BamReader(f"{d}/tumor.bam")
    nat = native.NativeBamReader(f"{d}/tumor.bam")
    assert nat.references == py.references
    assert nat.header_text == py.header_text
    assert nat.sample_name() == py.sample_name()
    for left, right in [(0, 5000), (2000, 2200), (2500, 2500), (4990, 5000),
                        (0, 0), (1000, 1099)]:
        a = [_aln_key(x) for x in py.fetch("chr9", left, right)]
        b = [_aln_key(x) for x in nat.fetch("chr9", left, right)]
        assert a == b, f"region {left}-{right}: {len(a)} vs {len(b)}"
    assert list(nat.fetch("chrMISSING", 0, 10)) == []
    fr_py = py.first_record()
    fr_nat = nat.first_record()
    assert _aln_key(fr_py) == _aln_key(fr_nat)


def test_bam_reader_no_index_full_scan(corpus, tmp_path):
    """Without a .bai the native reader falls back to a full scan and must
    return identical results."""
    import shutil

    d, _ = corpus
    shutil.copy(f"{d}/normal.bam", tmp_path / "n.bam")
    py = BamReader(f"{d}/normal.bam")
    nat = native.NativeBamReader(str(tmp_path / "n.bam"))
    a = [_aln_key(x) for x in py.fetch("chr9", 2200, 2600)]
    b = [_aln_key(x) for x in nat.fetch("chr9", 2200, 2600)]
    assert a == b and len(a) > 0


def test_fasta_equivalence(corpus):
    d, refseq = corpus
    py = FastaFile(f"{d}/ref.fa")
    nat = native.NativeFastaFile(f"{d}/ref.fa")
    assert nat.lengths == py.lengths
    rng = random.Random(0)
    for _ in range(25):
        s = rng.randint(-50, 5000)
        e = rng.randint(-50, 5100)
        assert nat.fetch("chr9", s, e) == py.fetch("chr9", s, e), (s, e)
    assert nat.fetch("chr9", 1, 5000) == refseq


def test_native_end_to_end_vcf(corpus):
    """runner.run with native readers == with Python readers."""
    import os

    from lancet_jax.config import Config
    from lancet_jax.runner import run

    d, _ = corpus
    cfg = Config(tumor_bam=f"{d}/tumor.bam", normal_bam=f"{d}/normal.bam",
                 ref_fasta=f"{d}/ref.fa", region="chr9:2400-2600")
    v_native = run(cfg, date="D\n")
    os.environ["LANCET_NO_NATIVE"] = "1"
    try:
        v_py = run(cfg, date="D\n")
    finally:
        del os.environ["LANCET_NO_NATIVE"]
    assert v_native == v_py
    assert "2501" in v_native  # the somatic SNV at 0-based 2500
