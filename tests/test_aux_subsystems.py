"""Aux subsystems: checkpoint/resume, per-window tracing, RG allowlist,
config dump, summary counters (SURVEY.md §5)."""

import json
import os

import pytest

from helpers import make_reference, tiled_reads, write_pair
from lancet_jax.config import Config, print_configuration
from lancet_jax.runner import run


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("aux"))
    refseq = make_reference(6000, seed=21)
    other = {"A": "C", "C": "G", "G": "T", "T": "A"}
    tumor, normal = [], []
    for i, c in enumerate((1500, 3000, 4500)):
        tumor += tiled_reads(refseq, c - 400, c + 400, 100, 5, f"t{i}_",
                             {c: other[refseq[c]]}, 0.5, seed=10 + i)
        normal += tiled_reads(refseq, c - 400, c + 400, 100, 5, f"n{i}_",
                              seed=20 + i)
    write_pair(d, refseq, "chr1", tumor, normal)
    return d


def _cfg(d, **kw):
    return Config(tumor_bam=f"{d}/tumor.bam", normal_bam=f"{d}/normal.bam",
                  ref_fasta=f"{d}/ref.fa", region="chr1:1200-4800", **kw)


def test_resume_produces_identical_vcf(corpus, tmp_path):
    fresh = run(_cfg(corpus), date="D\n")

    # first pass writes the checkpoint log
    rdir = str(tmp_path / "ckpt")
    cfg = _cfg(corpus, resume_dir=rdir)
    first = run(cfg, date="D\n", engine="device")
    assert first == fresh
    logs = sorted(os.listdir(rdir))
    assert logs, "no shard logs written"

    # simulate a crash: drop the tail of the log (some windows lost)
    p = os.path.join(rdir, logs[0])
    lines = open(p).read().splitlines(True)
    assert lines
    kept = lines[: max(1, len(lines) // 2)]
    with open(p, "w") as f:
        f.writelines(kept)
    resumed = run(cfg, date="D\n", engine="device")
    assert resumed == fresh

    # a second resume over a complete log skips all windows, same VCF
    again = run(cfg, date="D\n", engine="device")
    assert again == fresh


def test_resume_tolerates_torn_tail(corpus, tmp_path):
    rdir = str(tmp_path / "ckpt2")
    cfg = _cfg(corpus, resume_dir=rdir)
    fresh = run(cfg, date="D\n")
    p = os.path.join(rdir, sorted(os.listdir(rdir))[0])
    with open(p, "a") as f:
        f.write('{"windows": ["chr1:1-600"], "vari')  # torn write
    assert run(cfg, date="D\n") == fresh


def test_trace_file(corpus, tmp_path):
    tf = str(tmp_path / "trace.jsonl")
    run(_cfg(corpus, trace_file=tf), date="D\n")
    recs = [json.loads(l) for l in open(tf)]
    assert recs and all("window" in r and "ms" in r and "reads" in r
                        for r in recs)
    assert any(r["reads"] > 0 for r in recs)


def test_rg_allowlist(corpus, tmp_path):
    # all reads carry RG "rg1" (helpers write_bam); an allowlist naming a
    # different group must drop every read -> no variants
    rgf = tmp_path / "rg.txt"
    rgf.write_text("someothergroup\n")
    v = run(_cfg(corpus, rg_file=str(rgf)), date="D\n")
    assert not [l for l in v.splitlines() if not l.startswith("#")]
    # allowlist naming rg1 keeps them
    rgf.write_text("rg1\n")
    v2 = run(_cfg(corpus, rg_file=str(rgf)), date="D\n")
    assert v2 == run(_cfg(corpus), date="D\n")
    # empty file -> sentinel "null" -> keep all (ref Microassembler.cc:43-46)
    rgf.write_text("")
    assert run(_cfg(corpus, rg_file=str(rgf)), date="D\n") == v2


def test_print_configuration_format():
    txt = print_configuration(Config(tumor_bam="t.bam"))
    assert txt.startswith("tumor-BAM: t.bam\n")
    assert "cov-ratio: 0.01\n" in txt
    assert "more-verbose: false\n" in txt
    assert txt.endswith("\n\n")


def test_summary_counters_stderr(corpus, capsys):
    run(_cfg(corpus), date="D\n")
    err = capsys.readouterr().err
    assert "Total # of skipped windows:" in err
    assert "- # of windows with SNVs only:" in err


def test_died_worker_windows_reenqueued(tmp_path, monkeypatch):
    """A worker process that dies mid-run must have its shard replayed
    in-parent with identical output (SURVEY §5 failure detection; the
    reference's analog is rerunning the failed chromosome job)."""
    import dataclasses

    from tests.goldengen import scenario
    from tests.helpers import write_pair

    refseq, tumor, normal, region = scenario("two_snvs", 1)
    ref_path, t_path, n_path = write_pair(str(tmp_path), refseq, "chr1",
                                          tumor, normal)
    cfg = Config(tumor_bam=t_path, normal_bam=n_path, ref_fasta=ref_path,
                 region=region, num_threads=2)
    # force the process-pool path (the native shard runner is in-process
    # threaded C++ — no workers to die there)
    monkeypatch.setenv("LANCET_NO_SHARDRUN", "1")
    v_ok = run(cfg, command_line="x", date="D\n", engine="device",
               processes=True)
    monkeypatch.setenv("LANCET_TEST_KILL_SHARD", "1")
    stats = {}
    v_dead = run(cfg, command_line="x", date="D\n", engine="device",
                 processes=True, stats=stats)
    # a killed worker can break the whole pool (BrokenProcessPool makes
    # every pending future raise), so under load BOTH shards may count
    # as dead and get re-enqueued — >= 1 is the invariant
    assert stats.get("n_dead_workers", 0) >= 1, "kill hook never fired"
    assert v_dead == v_ok
