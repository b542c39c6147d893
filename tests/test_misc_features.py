"""Feature-completeness tests: DOT export, process-pool sharding, CLI,
config dump, kmer recovery."""

import os

from lancet_jax.cli import build_parser, config_from_args
from lancet_jax.config import Config
from lancet_jax.runner import run
from tests.goldengen import scenario
from tests.helpers import write_pair


def _setup(tmp_path, name="somatic_snv", seed=0):
    refseq, tumor, normal, region = scenario(name, seed)
    ref_path, t_path, n_path = write_pair(str(tmp_path), refseq, "chr1",
                                          tumor, normal)
    return Config(tumor_bam=t_path, normal_bam=n_path, ref_fasta=ref_path,
                  region=region), region


def test_dot_export(tmp_path, monkeypatch):
    cfg, region = _setup(tmp_path)
    import dataclasses
    cfg = dataclasses.replace(cfg, print_graph=True)
    monkeypatch.chdir(tmp_path)
    run(cfg, command_line="x", date="D\n")
    dots = [f for f in os.listdir(tmp_path) if f.endswith(".dot")]
    assert dots, "expected DOT stage exports"
    text = open(os.path.join(tmp_path, sorted(dots)[0])).read()
    assert text.startswith("//") or text.startswith("digraph")
    assert "digraph structs{" in text


def test_process_pool_matches_serial(tmp_path):
    cfg, region = _setup(tmp_path, "two_snvs", 1)
    import dataclasses
    cfg4 = dataclasses.replace(cfg, num_threads=4)
    v_serial = run(cfg, command_line="x", date="D\n", engine="device")
    v_pool = run(cfg4, command_line="x", date="D\n", engine="device",
                 processes=True)
    # num_threads alters shard assignment only; records must agree
    recs = lambda v: [l for l in v.splitlines() if not l.startswith("#")]
    assert recs(v_serial) == recs(v_pool)


def test_cli_parses_reference_flags(tmp_path):
    p = build_parser()
    a = p.parse_args(["--tumor", "t.bam", "--normal", "n.bam", "--ref", "r.fa",
                      "--reg", "chr1:1-100", "--min-k", "13", "--max-k", "51",
                      "--min-alt-count-tumor", "5", "--linked-reads",
                      "--active-region-off", "--num-threads", "4"])
    cfg = config_from_args(a)
    assert cfg.min_k == 13 and cfg.max_k == 51
    assert cfg.filters.min_alt_cnt_tumor == 5
    assert cfg.lr_mode and not cfg.active_regions
    assert cfg.num_threads == 4


def test_kmer_recovery_runs(tmp_path):
    cfg, region = _setup(tmp_path, "somatic_snv", 2)
    import dataclasses
    cfg = dataclasses.replace(cfg, kmer_recovery=True)
    vcf = run(cfg, command_line="x", date="D\n", engine="oracle")
    assert "##fileformat=VCFv4.2" in vcf


def test_print_pairs_export(tmp_path):
    """print_pairs (ref: Graph.cc:1963-2022): neighboring-contig pairs +
    isolated contigs as FASTA, with the reference's pair de-dup rule."""
    from lancet_jax.engine import dot as dot_mod
    from lancet_jax.engine.graph import Graph
    from lancet_jax.engine.micro import Microassembler
    from lancet_jax.io import open_bam, open_fasta
    from lancet_jax.windows import generate_windows

    cfg, region = _setup(tmp_path, "somatic_del", 0)
    captured = []
    orig = Graph.compress

    def spy(self, compid):
        if not captured:
            out = str(tmp_path / "pairs.fa")
            dot_mod.print_pairs(self, out)
            captured.append(out)
        return orig(self, compid)

    Graph.compress = spy
    try:
        fa = open_fasta(cfg.ref_fasta)
        windows = generate_windows(fa, [region], fa.lengths,
                                   cfg.window_size, cfg.padding)
        ma = Microassembler(cfg, readers=(open_bam(cfg.tumor_bam),
                                          open_bam(cfg.normal_bam)))
        for w in windows:
            ma.process_window(w)
    finally:
        Graph.compress = orig
    assert captured
    text = open(captured[0]).read()
    recs = [l for l in text.splitlines() if l.startswith(">")]
    assert recs, "no pair records"
    # pair records name both nodes and the edge direction
    assert any(l.count(":") >= 3 for l in recs)
    # sequences are DNA
    seqs = [l for l in text.splitlines() if not l.startswith(">")]
    assert all(set(s) <= set("ACGTN") for s in seqs)
