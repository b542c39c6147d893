"""End-to-end pipeline tests on synthetic tumor/normal pairs."""

import pytest

from lancet_jax.config import Config
from lancet_jax.runner import run
from tests.helpers import make_reference, tiled_reads, write_pair


def _call(tmp_path, refseq, tumor, normal, region, **cfg_kw):
    ref_path, t_path, n_path = write_pair(str(tmp_path), refseq, "chr1",
                                          tumor, normal)
    cfg = Config(tumor_bam=t_path, normal_bam=n_path, ref_fasta=ref_path,
                 region=region, **cfg_kw)
    return run(cfg, command_line="test", date="TESTDATE\n")


def _records(vcf: str):
    return [l for l in vcf.splitlines() if l and not l.startswith("#")]


def test_somatic_snv_called(tmp_path):
    refseq = make_reference(1400, seed=11)
    mut_pos = 700  # 0-based
    alt = {"A": "C", "C": "G", "G": "T", "T": "A"}[refseq[mut_pos]]
    tumor = tiled_reads(refseq, 450, 950, 100, 5, "t", {mut_pos: alt}, 0.5)
    normal = tiled_reads(refseq, 450, 950, 100, 5, "n")
    vcf = _call(tmp_path, refseq, tumor, normal, "chr1:650-750")
    recs = _records(vcf)
    assert recs, "expected at least one variant"
    snv = [r for r in recs if "TYPE=snv" in r]
    assert len(snv) >= 1
    fields = snv[0].split("\t")
    assert fields[0] == "chr1"
    assert int(fields[1]) == mut_pos + 1  # VCF 1-based
    assert fields[3] == refseq[mut_pos]
    assert fields[4] == alt
    assert "SOMATIC" in fields[7]
    assert fields[6] == "PASS"


def test_no_variants_on_identical_reads(tmp_path):
    refseq = make_reference(1400, seed=12)
    tumor = tiled_reads(refseq, 450, 950, 100, 5, "t")
    normal = tiled_reads(refseq, 450, 950, 100, 5, "n")
    vcf = _call(tmp_path, refseq, tumor, normal, "chr1:650-750")
    assert _records(vcf) == []


def test_somatic_insertion_called(tmp_path):
    refseq = make_reference(1400, seed=13)
    pos = 700
    ins = "TTCG"
    # build tumor reads from a mutated reference, mapped naively: use reads
    # carrying the insertion as soft-padded M alignments is complex; instead
    # synthesize reads from the mutated haplotype with correct placement.
    mutseq = refseq[:pos] + ins + refseq[pos:]
    from tests.helpers import make_read
    tumor = []
    i = 0
    for start in range(450, 860, 5):
        # read sequence from mutated haplotype; alignment pos maps to refseq
        seq = mutseq[start : start + 100]
        flag = 0x10 if i % 2 else 0
        if i % 2 == 0:
            al = make_read(f"ti{i}", refseq, start, 100, flag)
            if start + 100 > pos - 10:  # ensure half the reads carry the event
                al.seq = seq
                # CIGAR: M up to pos, I, M rest (only approximately right for
                # reads spanning the insertion; lancet only uses seq + pos)
                if start < pos and start + 100 > pos + 10:
                    ml = pos - start
                    al.cigar = [("M", ml), ("I", len(ins)), ("M", 100 - ml - len(ins))]
                    al.tags["MD"] = ("Z", str(100 - len(ins)))
        else:
            al = make_read(f"ti{i}", refseq, start, 100, flag)
        tumor.append(al)
        i += 1
    normal = tiled_reads(refseq, 450, 950, 100, 5, "n")
    vcf = _call(tmp_path, refseq, tumor, normal, "chr1:650-750")
    recs = [r for r in _records(vcf) if "TYPE=ins" in r]
    assert recs, f"expected insertion call, got: {_records(vcf)}"
    f = recs[0].split("\t")
    assert "SOMATIC" in f[7]
    assert len(f[4]) - len(f[3]) == len(ins)


def test_thread_count_invariance(tmp_path):
    refseq = make_reference(2000, seed=14)
    muts = {600: "A" if refseq[600] != "A" else "C",
            1300: "G" if refseq[1300] != "G" else "T"}
    tumor = tiled_reads(refseq, 300, 1700, 100, 4, "t", muts, 0.5)
    normal = tiled_reads(refseq, 300, 1700, 100, 4, "n")
    vcf1 = _call(tmp_path, refseq, tumor, normal, "chr1:400-1600",
                 num_threads=1)
    vcf4 = _call(tmp_path, refseq, tumor, normal, "chr1:400-1600",
                 num_threads=4)
    assert vcf1 == vcf4
