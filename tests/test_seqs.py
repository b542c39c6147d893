import random

from lancet_jax.engine import seqs


def brute_is_almost_repeat(s, k, mx):
    L = len(s)
    w = k + 1
    for off in range(0, L - k):
        i = off + 1
        while i < L - w + 1:
            mism = sum(1 for j in range(w) if s[i + j] != s[off + j])
            if mism <= mx:
                return True
            i += 1
    return False


def test_is_repeat_excludes_final_kmer():
    # duplicate only via the final k-mer -> reference misses it
    s = "ACGTTACGT"  # ACGT at 0 and at 5 (final 4-mer)
    assert seqs.is_repeat(s, 4) is False
    s2 = "ACGTACGTAA"  # ACGT at 0 and 4, both before final offset
    assert seqs.is_repeat(s2, 4) is True


def test_is_almost_repeat_matches_bruteforce():
    rng = random.Random(42)
    for _ in range(50):
        L = rng.randint(10, 40)
        s = "".join(rng.choice("ACGT") for _ in range(L))
        for k in (4, 6, 8):
            assert seqs.is_almost_repeat(s, k, 2) == brute_is_almost_repeat(s, k, 2), (s, k)


def test_hamming():
    assert seqs.hamming_distance("ACGT", "ACGA") == 1
    assert seqs.hamming_distance("ACGT", "ACG") == -1


def test_is_n_seq_always_false():
    assert seqs.is_n_seq("NNNN") is False  # reference bug preserved


def test_find_tandems_homopolymer():
    # 23-A homopolymer flanked by c/t
    s = "C" + "A" * 23 + "T"
    hit, ln, motif = seqs.find_tandems(s, 4, 3, 7, 1, 5)
    assert hit and motif == "A" and ln >= 20


def test_find_tandems_dinucleotide():
    s = "GGC" + "AT" * 6 + "GGC"
    hit, ln, motif = seqs.find_tandems(s, 4, 3, 7, 1, 6)
    assert hit and motif == "AT" and ln == 12
    # position far from the STR -> no hit
    hit2, _, _ = seqs.find_tandems(s, 4, 3, 7, 1, 0)
    assert not hit2


def test_parse_md_counts():
    counts = {}
    # 5 matches, mismatch, 4 matches  (MD: 5G4), start=100
    seqs.parse_md("5G4", counts, 100, "I" * 10, 50)
    assert counts == {106: 1}
    counts = {}
    seqs.parse_md("3^ACG7", counts, 10, "I" * 10, 50)
    assert counts == {}


def test_rc():
    assert seqs.rc_str("ACGTN") == "NACGT"
