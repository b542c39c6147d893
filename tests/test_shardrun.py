"""Native batched shard runner (engine/shardrun.py + lancet_native.cc lsr_*)
vs the per-window engines: byte-identical VCF and identical counters.
"""

import io
import os
import random
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from helpers import make_reference, write_pair  # noqa: E402
from goldengen import hap_reads  # noqa: E402

from lancet_jax.config import Config  # noqa: E402
from lancet_jax.runner import run  # noqa: E402


def _mixed_corpus(tmp_path, seed=5, chrom_len=12000, spacing=1500):
    rng = random.Random(seed)
    refseq = make_reference(chrom_len, seed=seed + 70)
    other = {"A": "C", "C": "G", "G": "T", "T": "A"}
    tumor, normal = [], []
    idx = 0
    half = spacing // 2
    for c in range(half, chrom_len - half, spacing):
        kind = rng.choice(["s", "s", "i", "d"])
        if kind == "s":
            edit = ("s", c, other[refseq[c]])
        elif kind == "i":
            edit = ("i", c, "".join(rng.choice("ACGT")
                                    for _ in range(rng.randint(1, 5))))
        else:
            edit = ("d", c, rng.randint(1, 5))
        tumor += hap_reads(refseq, edit, c - half, c + half, 100, 6,
                           f"t{idx}_", 0.5, 100 + idx)
        normal += hap_reads(refseq, None, c - half, c + half, 100, 6,
                            f"n{idx}_", 0, 200 + idx)
        idx += 1
    write_pair(str(tmp_path), refseq, "chr1", tumor, normal)
    return chrom_len


def _run(tmp_path, region, engine, native, threads=3):
    cfg = Config(tumor_bam=f"{tmp_path}/tumor.bam",
                 normal_bam=f"{tmp_path}/normal.bam",
                 ref_fasta=f"{tmp_path}/ref.fa", region=region,
                 num_threads=threads)
    old = os.environ.pop("LANCET_NO_SHARDRUN", None)
    if not native:
        os.environ["LANCET_NO_SHARDRUN"] = "1"
    err = io.StringIO()
    stderr, sys.stderr = sys.stderr, err
    try:
        vcf = run(cfg, command_line="t", date="D\n", engine=engine)
    finally:
        sys.stderr = stderr
        os.environ.pop("LANCET_NO_SHARDRUN", None)
        if old is not None:
            os.environ["LANCET_NO_SHARDRUN"] = old
    return vcf, err.getvalue()


@pytest.mark.parametrize("threads", [1, 3])
def test_shardrun_matches_oracle(tmp_path, threads):
    from lancet_jax.engine import shardrun

    if not shardrun.available():
        pytest.skip("native toolchain unavailable")
    chrom_len = _mixed_corpus(tmp_path)
    region = f"chr1:300-{chrom_len - 300}"
    vcf_n, err_n = _run(tmp_path, region, "device", native=True,
                        threads=threads)
    vcf_o, err_o = _run(tmp_path, region, "oracle", native=False,
                        threads=threads)
    assert vcf_n == vcf_o
    assert err_n == err_o  # summary counters byte-equal


def test_shardrun_matches_python_device_engine(tmp_path):
    from lancet_jax.engine import shardrun

    if not shardrun.available():
        pytest.skip("native toolchain unavailable")
    chrom_len = _mixed_corpus(tmp_path, seed=9, chrom_len=9000)
    region = f"chr1:300-{chrom_len - 300}"
    vcf_n, err_n = _run(tmp_path, region, "device", native=True)
    vcf_p, err_p = _run(tmp_path, region, "device", native=False)
    assert vcf_n == vcf_p
    assert err_n == err_p


def test_shardrun_device_gates_equal(tmp_path):
    """Device repeat gates (LANCET_GATES=1) and native lazy scans gate
    identically."""
    from lancet_jax.engine import shardrun

    if not shardrun.available():
        pytest.skip("native toolchain unavailable")
    chrom_len = _mixed_corpus(tmp_path, seed=13, chrom_len=8000)
    region = f"chr1:300-{chrom_len - 300}"
    vcf_scan, _ = _run(tmp_path, region, "device", native=True)
    os.environ["LANCET_GATES"] = "1"
    try:
        vcf_dev, _ = _run(tmp_path, region, "device", native=True)
    finally:
        del os.environ["LANCET_GATES"]
    assert vcf_scan == vcf_dev
