"""Device-batched engine must produce byte-identical VCFs to the oracle."""

from lancet_jax.config import Config
from lancet_jax.runner import run
from tests.goldengen import scenario
from tests.helpers import write_pair


def test_device_engine_matches_oracle(tmp_path):
    refseq, tumor, normal, region = scenario("somatic_del", 1)
    ref_path, t_path, n_path = write_pair(str(tmp_path), refseq, "chr1",
                                          tumor, normal)
    cfg = Config(tumor_bam=t_path, normal_bam=n_path, ref_fasta=ref_path,
                 region=region)
    v_oracle = run(cfg, command_line="x", date="D\n", engine="oracle")
    v_dev = run(cfg, command_line="x", date="D\n", engine="device")
    assert v_oracle == v_dev
    assert any(l for l in v_oracle.splitlines() if not l.startswith("#"))
