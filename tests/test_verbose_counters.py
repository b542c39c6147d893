"""Verbose (-v) observability counters must match the reference's stderr
counter lines byte-for-byte: extraction-filter counts
(Microassembler.cc:644-652), path-class counters (Graph.cc:1481-1493),
per-stage graph stats (printStats, Graph.cc:3674-3691), and the cleanup/
component/refpath stat lines around them."""

import os
import re
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tests.goldengen import scenario  # noqa: E402
from tests.helpers import write_pair  # noqa: E402

BIN = os.environ.get("LANCET_REF_BIN", "/tmp/refbuild/src/lancet")

pytestmark = pytest.mark.skipif(not os.path.exists(BIN),
                                reason="reference lancet binary not built")

COUNTER_PAT = re.compile(
    r"^(Num reads |"
    r" (perfect|refcomp): |"
    r"  [0-9]+: nodes: |"
    r"reads: |"
    r"remove |removing low| found | Found [0-9]+ on ref|"
    r"checking read|compressing|  removing |"
    r"mark refnodes| nodes: |connected components|"
    r"searching from |looking for|"
    r"== Processing |FINISHED|"
    r"Repeat in reference|Near-perfect)")


def counter_lines(text: str) -> list[str]:
    return [l for l in text.splitlines() if COUNTER_PAT.match(l)]


@pytest.mark.parametrize("name", ["somatic_snv", "somatic_del",
                                  "adjacent_complex", "str_indel"])
def test_verbose_counter_lines_match(name, tmp_path):
    refseq, tumor, normal, region = scenario(name, 0)
    ref_path, t_path, n_path = write_pair(str(tmp_path), refseq, "chr1",
                                          tumor, normal)
    r = subprocess.run([BIN, "--tumor", t_path, "--normal", n_path,
                        "--ref", ref_path, "--reg", region, "-v"],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0
    ours = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[4])\n"
         "import jax; jax.config.update('jax_platforms', 'cpu')\n"
         "from lancet_jax.config import Config\n"
         "from lancet_jax.runner import run\n"
         "run(Config(tumor_bam=sys.argv[1], normal_bam=sys.argv[2],"
         " ref_fasta=sys.argv[3], region=sys.argv[5], verbose=True))",
         t_path, n_path, ref_path,
         os.path.join(os.path.dirname(__file__), ".."), region],
        capture_output=True, text=True, timeout=600)
    assert ours.returncode == 0, ours.stderr[-2000:]
    ref_lines = counter_lines(r.stderr)
    our_lines = counter_lines(ours.stderr)
    assert len(ref_lines) > 20, "reference produced too few counter lines"
    assert ref_lines == our_lines
