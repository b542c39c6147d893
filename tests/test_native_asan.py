"""Sanitizer pass over the native plane (SURVEY §5: add the sanitizers
the reference lacks): rebuild lancet_native.cc with ASan+UBSan and run
tests/asan_driver.py — which exercises every native entry point (BAM/BAI
reader, faidx, sequence scans, lgb_build, lgp_run) — in a subprocess
with libasan preloaded. JAX is deliberately kept out of that process:
XLA's compiler aborts under an injected ASan runtime through no fault
of the code under test."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(REPO, "lancet_jax", "native", "lancet_native.cc")


def _libasan() -> str | None:
    r = subprocess.run(["g++", "-print-file-name=libasan.so"],
                       capture_output=True, text=True)
    path = r.stdout.strip()
    return path if r.returncode == 0 and os.path.sep in path else None


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_native_under_asan_ubsan(tmp_path):
    libasan = _libasan()
    if libasan is None:
        pytest.skip("libasan not available")
    so = str(tmp_path / "_lancet_native_asan.so")
    r = subprocess.run(
        ["g++", "-O1", "-g", "-std=c++17", "-shared", "-fPIC",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
         "-o", so, SRC, "-lz", "-lpthread"],
        capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        pytest.skip(f"ASan build unavailable: {r.stderr[-500:]}")
    env = dict(os.environ)
    env.update({
        "LD_PRELOAD": libasan,
        "LANCET_NATIVE_SO": so,
        # Python's allocator is not leak-clean; we're after memory errors
        "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
        "UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1",
        "JAX_PLATFORMS": "cpu",
    })
    p = subprocess.run(
        [sys.executable, os.path.join("tests", "asan_driver.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, (
        f"sanitizer run failed:\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    assert "asan driver ok" in p.stdout
