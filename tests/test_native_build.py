"""The native fast paths must be interchangeable with the numpy fast path:
(a) the full C++ per-k pipeline (fastpipe.run_k_native), (b) the C++ build
kernel + Python stages (fastbuild.build_graph_native), and (c) pure numpy —
identical VCFs end-to-end on every scenario family (all already proven
equal to the oracle engine by test_engine_equiv and the golden corpus)."""

import pytest

import lancet_jax.engine.fastbuild as fb
import lancet_jax.engine.fastpipe as fp
from lancet_jax.config import Config
from lancet_jax.runner import run
from tests.goldengen import ALL_SCENARIOS, scenario
from tests.helpers import write_pair


def _native_available() -> bool:
    try:
        from lancet_jax.native import load_library

        load_library()
        return True
    except Exception:
        return False


@pytest.mark.skipif(not _native_available(), reason="no native toolchain")
@pytest.mark.parametrize("name", ALL_SCENARIOS)
def test_native_modes_match(tmp_path, monkeypatch, name):
    refseq, tumor, normal, region = scenario(name, 3)
    ref_path, t_path, n_path = write_pair(str(tmp_path), refseq, "chr1",
                                          tumor, normal)
    cfg = Config(tumor_bam=t_path, normal_bam=n_path, ref_fasta=ref_path,
                 region=region)
    v_pipeline = run(cfg, command_line="x", date="D\n", engine="device")

    monkeypatch.setattr(fp, "available", lambda: False)
    v_buildonly = run(cfg, command_line="x", date="D\n", engine="device")

    monkeypatch.setattr(fb, "build_graph_native", lambda g, r: False)
    v_numpy = run(cfg, command_line="x", date="D\n", engine="device")

    assert v_pipeline == v_buildonly
    assert v_buildonly == v_numpy


def test_library_built_from_source_into_ignored_dir(tmp_path, monkeypatch):
    """The library is built from the committed source into the git-ignored
    _build/ directory, under a name keyed on the source's hash (so an
    edited source rebuilds; mtimes play no part)."""
    import hashlib
    import os
    import shutil

    import lancet_jax.native as nat

    with open(nat._SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = nat.library_path()
    assert so == os.path.join(nat.BUILD_DIR, f"lancet_native-{digest}.so")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(nat.__file__)))
    with open(os.path.join(repo, ".gitignore")) as f:
        assert "lancet_jax/native/_build/" in f.read().split()
    if _native_available():
        assert os.path.exists(so)
    edited = tmp_path / "lancet_native.cc"
    shutil.copy(nat._SRC, edited)
    with open(edited, "a") as f:
        f.write("// edited\n")
    monkeypatch.setattr(nat, "_SRC", str(edited))
    assert nat.library_path() != so
