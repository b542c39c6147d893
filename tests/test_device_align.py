"""Batched device aligner vs oracle aligner: exact equality."""

import random

import pytest

from lancet_jax.device.align_batch import batch_align, pack_pairs
from lancet_jax.engine.align import global_align_aff


def _random_pairs(rng, n_pairs, edits=True):
    pairs = []
    for _ in range(n_pairs):
        n = rng.randint(30, 250)
        S = "".join(rng.choice("ACGT") for _ in range(n))
        if edits:
            T = list(S)
            for _ in range(rng.randint(1, 5)):
                op = rng.choice("sid")
                p = rng.randint(5, len(T) - 5)
                if op == "s":
                    T[p] = rng.choice("ACGT")
                elif op == "i":
                    T.insert(p, rng.choice("ACGT"))
                else:
                    del T[p]
            T = "".join(T)
        else:
            T = "".join(rng.choice("ACGT") for _ in range(rng.randint(30, 250)))
        pairs.append((S, T))
    return pairs


def test_batch_matches_oracle_edit_pairs():
    rng = random.Random(7)
    pairs = _random_pairs(rng, 24, edits=True)
    got = batch_align(pairs)
    for (S, T), (sa, ta) in zip(pairs, got):
        esa, eta = global_align_aff(S, T)
        assert (sa, ta) == (esa, eta), (S, T)


def test_batch_matches_oracle_divergent_pairs():
    rng = random.Random(8)
    pairs = _random_pairs(rng, 12, edits=False)
    got = batch_align(pairs)
    for (S, T), (sa, ta) in zip(pairs, got):
        esa, eta = global_align_aff(S, T)
        assert (sa, ta) == (esa, eta), (S, T)


def test_batch_mixed_lengths():
    pairs = [("ACGT", "ACGT"), ("A" * 200, "A" * 190 + "C" * 10),
             ("ACGTACGTAC", "ACG")]
    got = batch_align(pairs)
    for (S, T), (sa, ta) in zip(pairs, got):
        assert (sa, ta) == global_align_aff(S, T)


def _window_pair(rng, n):
    """A window-scale (ref, path) pair: the path carries a few SNVs and
    one indel, as the assembler's DP jobs do."""
    S = "".join(rng.choice("ACGT") for _ in range(n))
    T = list(S)
    for _ in range(rng.randint(1, 6)):
        T[rng.randrange(len(T))] = rng.choice("ACGT")
    p = rng.randrange(len(T) - 10)
    if rng.random() < 0.5:
        T[p:p] = [rng.choice("ACGT") for _ in range(rng.randint(1, 6))]
    else:
        del T[p : p + rng.randint(1, 6)]
    return S, "".join(T)


@pytest.mark.parametrize("width", [600, 900, 1200])
def test_batch_matches_oracle_window_widths(width):
    """Real window widths (600-1,200 bp; N and M bucket up to 1,280)."""
    rng = random.Random(width)
    pairs = [_window_pair(rng, width + rng.randint(-40, 40))
             for _ in range(3)]
    got = batch_align(pairs)
    for (S, T), res in zip(pairs, got):
        assert res == global_align_aff(S, T)


def test_pack_pairs_buckets_and_padding():
    pairs = [("ACGT" * 150, "ACGT" * 149), ("AC", "ACG"), ("A" * 700, "C")]
    S, T, n_len, m_len, N, M = pack_pairs(pairs, multiple=16)
    assert (N, M) == (768, 640)  # 128-multiples covering the longest
    assert S.shape == (16, N + 1) and T.shape == (16, M + 1)
    assert list(n_len[:3]) == [600, 2, 700]
    assert list(m_len[:3]) == [596, 3, 1]
    assert (n_len[3:] == 700).all()  # pad rows repeat the last pair
    assert bytes(S[1, 1:3]) == b"AC" and S[1, 0] == 0
