import os
import resource
import sys

# XLA:CPU's LLVM passes recurse deeply on this build's large graph
# programs; with the default 8 MB stack the compiler intermittently
# SIGSEGVs (observed in backend_compile_and_load and in the cache
# serializer's AOT re-compile). The main-thread stack grows on demand up
# to RLIMIT_STACK, so raise it before jax initializes.
try:
    resource.setrlimit(resource.RLIMIT_STACK,
                       (resource.RLIM_INFINITY, resource.RLIM_INFINITY))
except (ValueError, OSError):
    pass

# Tests run on a virtual 8-device CPU mesh so sharding paths are exercised
# without a GPU (chip_smoke.py runs the same paths on the card). The
# platform is forced through jax.config before any backend use.
os.environ.setdefault(
    "XLA_FLAGS",
    (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip(),
)
# XLA:CPU's parallel LLVM codegen intermittently SIGSEGVs inside
# backend_compile_and_load on this host (nondeterministic crash sites on
# deterministic inputs = a codegen-thread race); serial codegen is stable.
if "--xla_cpu_parallel_codegen_split_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ["XLA_FLAGS"]
                               + " --xla_cpu_parallel_codegen_split_count=1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """XLA:CPU compiles start crashing (SIGSEGV/SIGABRT inside
    backend_compile_and_load or the cache serializer) once a process
    accumulates many large live executables — verified by bisection: the
    same compile that dies at test 6 of a full module run passes in
    isolation. Dropping the jit caches at module boundaries bounds the
    live-executable count. (The persistent DISK cache stays disabled on
    CPU backends — its AOT writes crash too; see
    devicepipe._enable_compile_cache — so modules recompile their own
    shapes. Slower, but the only stable arrangement found on this
    host.)"""
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere; the test "
        "drives chip_smoke.py, which owns the card)")


@pytest.fixture
def gpu():
    """Skip unless this machine has an NVIDIA GPU. Decided at run time by
    nvidia-smi, never through JAX: the test process stays on the CPU so
    that the one process it starts can own the card."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")
