"""CppUnorderedMap unit tests (probe-based fuzzing lives in
tools/; these check internal consistency)."""

import random

from lancet_jax.cpp_hash import CppUnorderedMap, hash_bytes


def test_hash_bytes_known_values():
    # validated against libstdc++ std::hash<std::string> on this toolchain
    assert hash_bytes(b"A") == 6919333181322027406
    assert hash_bytes(b"AB") == 2424659001560506831
    assert hash_bytes(b"ACGTACGTACGT") == 15288115528345806449
    assert hash_bytes(b"aVeryLongStringKeyForHashing123456") == 13920939327457267594


def test_map_basic_ops():
    m = CppUnorderedMap()
    for i in range(100):
        m[f"k{i}"] = i
    assert len(m) == 100
    assert m["k42"] == 42
    assert set(m.keys()) == {f"k{i}" for i in range(100)}
    del m["k42"]
    assert "k42" not in m
    assert len(m) == 99
    # deterministic order
    m2 = CppUnorderedMap()
    for i in range(100):
        m2[f"k{i}"] = i
    del m2["k42"]
    assert m.keys() == m2.keys()


def test_map_bucket_growth_matches_libstdcxx():
    m = CppUnorderedMap()
    growth = []
    last = 1
    for i in range(300):
        m[f"key{i:04d}"] = i
        if m._nbkt != last:
            growth.append((i + 1, m._nbkt))
            last = m._nbkt
    assert growth == [(1, 13), (14, 29), (30, 59), (60, 127), (128, 257),
                      (258, 541)]


def test_update_does_not_reorder():
    m = CppUnorderedMap()
    for i in range(50):
        m[f"k{i}"] = i
    order = m.keys()
    m["k10"] = 999
    assert m.keys() == order
    assert m["k10"] == 999
