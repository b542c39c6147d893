"""Placement of the persistent XLA compile cache."""

import os

from lancet_jax.engine import devicepipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_from_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins on every backend."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert devicepipe.compile_cache_dir("gpu") == str(tmp_path)
    assert devicepipe.compile_cache_dir("cpu") == str(tmp_path)


def test_cache_dir_default_in_checkout(monkeypatch):
    """Unset: one fixed, git-ignored directory of the checkout on the
    GPU; none on the CPU."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = devicepipe.compile_cache_dir("gpu")
    assert d == os.path.join(REPO, ".jax_cache")
    assert d == devicepipe.compile_cache_dir("gpu")  # stable across calls
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    assert devicepipe.compile_cache_dir("cpu") is None


def test_package_import_leaves_xla_flags():
    """Importing the package sets no XLA option for the caller's process."""
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run(
        [sys.executable, "-c", "import os, lancet_jax, lancet_jax.runner; "
         "print(os.environ.get('XLA_FLAGS'))"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "None"
