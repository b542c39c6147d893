"""Window-axis mesh sharding: device-count invariance of the full
pipeline (the device analog of the reference's thread-count-invariant
output, Lancet.cc:305-310, 938-959; SURVEY.md §2.3)."""

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _clear_jax_caches_per_test():
    """This module's tests each compile several large executables;
    XLA:CPU compiles crash once too many live in one process (see
    conftest). Clearing per test keeps the count bounded."""
    yield
    import jax

    jax.clear_caches()


@pytest.mark.parametrize("ndev", [2, 8])
def test_vcf_device_count_invariant(tmp_path, ndev):
    """The full pipeline's VCF must not depend on the mesh size. Runs
    windows -> VCF with the device DP sharded over 1 vs `ndev` virtual
    devices."""
    from test_shardrun import _mixed_corpus

    from lancet_jax.config import Config
    from lancet_jax.parallel.mesh import make_mesh
    from lancet_jax.runner import run

    chrom_len = _mixed_corpus(tmp_path, seed=21, chrom_len=9000)
    cfg = Config(tumor_bam=f"{tmp_path}/tumor.bam",
                 normal_bam=f"{tmp_path}/normal.bam",
                 ref_fasta=f"{tmp_path}/ref.fa",
                 region=f"chr1:300-{chrom_len - 300}", num_threads=3)
    vcf_1 = run(cfg, command_line="t", date="D\n", engine="device",
                mesh=make_mesh(1))
    vcf_n = run(cfg, command_line="t", date="D\n", engine="device",
                mesh=make_mesh(ndev))
    vcf_plain = run(cfg, command_line="t", date="D\n", engine="device")
    assert vcf_1 == vcf_n
    assert vcf_plain == vcf_n
    assert sum(1 for l in vcf_n.splitlines() if not l.startswith("#")) > 0


def test_devgraph_vcf_device_count_invariant(tmp_path, monkeypatch):
    """Same invariance with the device graph engine on: the colored-DBG
    build/cleanup/path-cover runs with its window batch axis sharded over
    the mesh (mesh.shard_windows_jit), exercising the production SPMD path
    (per-device window shards; psum'd counters; all_gather'd outputs)."""
    from test_shardrun import _mixed_corpus

    from lancet_jax.config import Config
    from lancet_jax.parallel.mesh import make_mesh
    from lancet_jax.runner import run

    monkeypatch.setenv("LANCET_DEVGRAPH", "1")
    chrom_len = _mixed_corpus(tmp_path, seed=23, chrom_len=9000)
    cfg = Config(tumor_bam=f"{tmp_path}/tumor.bam",
                 normal_bam=f"{tmp_path}/normal.bam",
                 ref_fasta=f"{tmp_path}/ref.fa",
                 region=f"chr1:300-{chrom_len - 300}", num_threads=3)
    stats_n = {}
    vcf_n = run(cfg, command_line="t", date="D\n", engine="device",
                mesh=make_mesh(8), stats=stats_n)
    vcf_1 = run(cfg, command_line="t", date="D\n", engine="device",
                mesh=make_mesh(1))
    monkeypatch.setenv("LANCET_DEVGRAPH", "0")
    vcf_native = run(cfg, command_line="t", date="D\n", engine="device")
    assert vcf_n == vcf_1
    assert vcf_n == vcf_native
    assert stats_n.get("n_dev_windows", 0) > 0
    assert sum(1 for l in vcf_n.splitlines() if not l.startswith("#")) > 0
