"""check_read_starts audit (ref: Graph.cc:3388-3450, Microassembler.cc:181):
every readstart record must still point at its read's k-mer. The audit is
on the active oracle path per component; here we also assert it never
fires (bad == 0) and actually inspects records (all > 0) on real windows.
"""

from lancet_jax.config import Config
from lancet_jax.engine.graph import Graph
from lancet_jax.runner import run
from tests.goldengen import scenario
from tests.helpers import write_pair


def test_audit_clean_on_real_windows(tmp_path, monkeypatch):
    results = []
    orig = Graph.check_read_starts

    def spy(self, compid):
        out = orig(self, compid)
        results.append(out)
        return out

    monkeypatch.setattr(Graph, "check_read_starts", spy)
    for name in ("somatic_snv", "somatic_del", "adjacent_complex"):
        refseq, tumor, normal, region = scenario(name, 0)
        d = tmp_path / name
        d.mkdir()
        ref_path, t_path, n_path = write_pair(str(d), refseq, "chr1",
                                              tumor, normal)
        cfg = Config(tumor_bam=t_path, normal_bam=n_path,
                     ref_fasta=ref_path, region=region)
        run(cfg, command_line="x", date="D\n", engine="oracle")
    assert results, "audit never ran"
    assert sum(nall for _, nall in results) > 0, "audit saw no readstarts"
    assert all(nbad == 0 for nbad, _ in results), f"bad readstarts: {results}"
