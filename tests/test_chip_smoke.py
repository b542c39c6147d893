"""chip_smoke.py: refuses to run without a GPU, and passes on one."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On the CPU it exits non-zero and prints no result, both from the
    repository and as a lone copy of the script."""
    script = SCRIPT
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SCRIPT, script)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_corpora_in_checkout():
    """The smoke run and the bench generate their corpora inside the
    checkout, under a git-ignored directory, never in a shared /tmp."""
    sys.path.insert(0, REPO)
    import bench
    import chip_smoke

    root = os.path.join(REPO, ".corpus")
    for d in (chip_smoke.CORPUS, bench.CORPUS_DIR, bench.HARD_DIR,
              bench.LR_DIR):
        assert os.path.dirname(d) == root
    assert chip_smoke.CORPUS == bench.CORPUS_DIR
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".corpus/" in f.read().split()


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    """The whole smoke run on the card, in a child that owns it."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, SCRIPT], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
