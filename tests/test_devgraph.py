"""Integrated device graph engine (runner -> shardrun.run_shards_device
-> device pipeline -> native scan finish) must be VCF-identical to the
fully-native shard runner on golden scenarios, including k-retry and
fallback-window paths."""

import os

import pytest

from lancet_jax.config import Config
from lancet_jax.runner import run
from tests.goldengen import scenario
from tests.helpers import write_pair


@pytest.fixture(autouse=True)
def _clear_jax_caches_per_test():
    """This module's tests each compile several large executables;
    XLA:CPU compiles crash once too many live in one process (see
    conftest). Clearing per test keeps the count bounded."""
    yield
    import jax

    jax.clear_caches()


def _native_available() -> bool:
    try:
        from lancet_jax.native import load_library

        load_library()
        return True
    except Exception:
        return False


@pytest.mark.skipif(not _native_available(), reason="no native toolchain")
@pytest.mark.parametrize("name", [
    "somatic_snv", "somatic_del", "str_indel", "paired_overlap",
    "adjacent_complex",
])
def test_devgraph_matches_native(tmp_path, name, monkeypatch):
    refseq, tumor, normal, region = scenario(name, 1)
    ref_path, t_path, n_path = write_pair(str(tmp_path), refseq, "chr1",
                                          tumor, normal)
    cfg = Config(tumor_bam=t_path, normal_bam=n_path, ref_fasta=ref_path,
                 region=region)
    monkeypatch.setenv("LANCET_DEVGRAPH", "1")
    stats: dict = {}
    v_dev = run(cfg, command_line="x", date="D\n", engine="device",
                stats=stats)
    monkeypatch.setenv("LANCET_DEVGRAPH", "0")
    v_nat = run(cfg, command_line="x", date="D\n", engine="device")
    assert v_dev == v_nat
    if name == "paired_overlap":
        # mate-overlap candidates must route through the native replay
        assert stats.get("n_dev_fallback", 0) > 0


@pytest.mark.skipif(not _native_available(), reason="no native toolchain")
def test_devgraph_adversarial_windows(tmp_path, monkeypatch):
    """Hard-corpus-style content (STR runs, near-repeat duplications,
    homopolymers, dense het SNVs): exercises the cycle screen's flagged
    lanes, deep k-retries, and the >k-cap native fallback, asserting the
    device path stays VCF-identical to the native plane."""
    import random

    from tests.goldengen import hap_reads
    from tests.helpers import make_reference

    rng = random.Random(4242)
    other = {"A": "C", "C": "G", "G": "T", "T": "A"}
    base = list(make_reference(12_000, seed=77))
    centers = list(range(1000, 11_000, 2000))
    for idx, c in enumerate(centers):
        fam = idx % 5
        if fam == 0:  # STR
            base[c - 60 : c - 60 + 36] = "AC" * 18
            base[c + 20 : c + 20 + 30] = "AGC" * 10
        elif fam == 1:  # near-repeat 24bp dup, 1 mismatch
            seg = list(base[c - 30 : c - 6])
            seg[11] = other[seg[11]]
            base[c + 30 : c + 54] = seg
        elif fam == 2:  # homopolymer
            base[c - 40 : c - 16] = "A" * 24
    refseq = "".join(base)
    tumor, normal = [], []
    for idx, c in enumerate(centers):
        fam = idx % 5
        if fam == 0:
            edit = ("i", c + 21, "AGC")
        elif fam == 2:
            edit = ("d", c - 30, 1)
        else:
            edit = ("s", c, other[refseq[c]])
        tumor += hap_reads(refseq, edit, c - 700, c + 700, 100, 5,
                           f"t{idx}_", 0.5, 100 + idx)
        normal += hap_reads(refseq, None, c - 700, c + 700, 100, 5,
                            f"n{idx}_", 0, 200 + idx)
        if fam == 3:  # dense germline hets -> bubbles at every k
            for j, off in enumerate((-90, -33, 54)):
                e = ("s", c + off, other[refseq[c + off]])
                tumor += hap_reads(refseq, e, c + off - 140, c + off + 140,
                                   100, 11, f"tx{idx}_{j}_", 0.5, 300 + j)
                normal += hap_reads(refseq, e, c + off - 140, c + off + 140,
                                    100, 11, f"nx{idx}_{j}_", 0.5, 400 + j)
    ref_path, t_path, n_path = write_pair(str(tmp_path), refseq, "chr1",
                                          tumor, normal)
    cfg = Config(tumor_bam=t_path, normal_bam=n_path, ref_fasta=ref_path,
                 region="chr1:400-11600", num_threads=2)
    monkeypatch.setenv("LANCET_DEVGRAPH", "1")
    stats: dict = {}
    v_dev = run(cfg, command_line="x", date="D\n", engine="device",
                stats=stats)
    monkeypatch.setenv("LANCET_DEVGRAPH", "0")
    v_nat = run(cfg, command_line="x", date="D\n", engine="device")
    assert v_dev == v_nat
    assert stats.get("n_dev_windows", 0) > 0
    # the adversarial families must actually push the k ladder
    khist = stats.get("k_histogram", {})
    assert any(int(k) > 11 for k in khist), khist


@pytest.mark.skipif(not _native_available(), reason="no native toolchain")
def test_devgraph_bucket_promotion(tmp_path, monkeypatch):
    """A window that overflows its shape bucket's node/edge caps is
    PROMOTED to the next bucket at the same k (devicepipe
    run_device_graph) instead of being lost to the native replay: with
    the first bucket's caps shrunk to force overflow, the VCF still
    matches native and the shape_caps fallback cause stays zero."""
    from lancet_jax.engine import devicepipe

    refseq, tumor, normal, region = scenario("somatic_snv", 1)
    ref_path, t_path, n_path = write_pair(str(tmp_path), refseq, "chr1",
                                          tumor, normal)
    cfg = Config(tumor_bam=t_path, normal_bam=n_path, ref_fasta=ref_path,
                 region=region)
    # tiny first bucket: node/edge caps overflow on any real window
    monkeypatch.setattr(devicepipe, "_BUCKETS",
                        ((48, 160, 64, 160),) + devicepipe._BUCKETS[1:])
    monkeypatch.setenv("LANCET_DEVGRAPH", "1")
    stats: dict = {}
    v_dev = run(cfg, command_line="x", date="D\n", engine="device",
                stats=stats)
    monkeypatch.setenv("LANCET_DEVGRAPH", "0")
    v_nat = run(cfg, command_line="x", date="D\n", engine="device")
    assert v_dev == v_nat
    causes = stats.get("dev_fallback_causes", {})
    assert causes.get("shape_caps", 0) == 0, causes
    assert stats.get("n_dev_windows", 0) > 0


@pytest.mark.skipif(not _native_available(), reason="no native toolchain")
def test_devgraph_engine_error_falls_back(tmp_path, monkeypatch):
    """A device fault mid-run (compile error, out of memory) must surface
    as an error from the runner: no silent replay of every window on the
    native plane, and no engine_error cause."""
    from lancet_jax.engine import shardrun

    refseq, tumor, normal, region = scenario("somatic_snv", 1)
    ref_path, t_path, n_path = write_pair(str(tmp_path), refseq, "chr1",
                                          tumor, normal)
    cfg = Config(tumor_bam=t_path, normal_bam=n_path, ref_fasta=ref_path,
                 region=region)

    def boom(*a, **k):
        raise RuntimeError("RESOURCE_EXHAUSTED: out of device memory")

    monkeypatch.setattr("lancet_jax.engine.devicepipe.run_device_graph",
                        boom)
    monkeypatch.setenv("LANCET_DEVGRAPH", "1")
    assert shardrun.device_graph_enabled()
    stats: dict = {}
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        run(cfg, command_line="x", date="D\n", engine="device", stats=stats)
    assert "engine_error" not in stats.get("dev_fallback_causes", {})
