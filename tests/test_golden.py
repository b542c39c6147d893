"""Golden-record tests vs compiled reference lancet (skipped when the
binary is absent; see .claude/skills/verify/SKILL.md to build it).

Coverage: every scenario family in goldengen.ALL_SCENARIOS (+ linked-read
mode) across 3 seeds, a subset re-run on the fast (device) engine, and a
50-event randomized fuzz chromosome (mixed events, quality/clip/MAPQ
noise) compared in a single run.
"""

import os
import subprocess
import sys
import tempfile

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.golden_compare import compare_one  # noqa: E402
from tests.goldengen import ALL_SCENARIOS, LR_SCENARIOS, fuzz_corpus  # noqa: E402

BIN = os.environ.get("LANCET_REF_BIN", "/tmp/refbuild/src/lancet")

pytestmark = pytest.mark.skipif(not os.path.exists(BIN),
                                reason="reference lancet binary not built")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ALL_SCENARIOS + LR_SCENARIOS)
def test_golden_record_equal(name, seed):
    good, msg = compare_one(name, seed, BIN)
    assert good, msg


@pytest.mark.parametrize("name", ["somatic_del", "paired_overlap",
                                  "adjacent_complex", "random_storm"])
def test_golden_record_equal_fast_engine(name):
    good, msg = compare_one(name, 0, BIN, engine="device")
    assert good, msg


def test_golden_fuzz_battery():
    """50 randomized event windows on one chromosome, record-equal in a
    single run (ref: thread-pool merge semantics, Lancet.cc:938-959)."""
    from lancet_jax.config import Config
    from lancet_jax.runner import run
    from tests.helpers import write_pair

    refseq, tumor, normal, region = fuzz_corpus(7, n_events=50)
    with tempfile.TemporaryDirectory() as td:
        ref_path, t_path, n_path = write_pair(td, refseq, "chr1",
                                              tumor, normal)
        r = subprocess.run([BIN, "--tumor", t_path, "--normal", n_path,
                            "--ref", ref_path, "--reg", region],
                           capture_output=True, text=True, timeout=900)
        assert r.returncode == 0, r.stderr[-2000:]
        ref_recs = [l for l in r.stdout.splitlines()
                    if l and not l.startswith("#")]
        cfg = Config(tumor_bam=t_path, normal_bam=n_path,
                     ref_fasta=ref_path, region=region)
        ours = run(cfg, command_line="x", date="D\n")
        our_recs = [l for l in ours.splitlines()
                    if l and not l.startswith("#")]
    assert len(ref_recs) >= 30, "fuzz corpus produced too few records"
    assert ref_recs == our_recs, (
        f"{len(ref_recs)} ref vs {len(our_recs)} ours; "
        f"ref-only={[x for x in ref_recs if x not in our_recs][:5]} "
        f"ours-only={[x for x in our_recs if x not in ref_recs][:5]}")
