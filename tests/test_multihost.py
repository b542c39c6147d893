"""Multi-host fan-out: 2 jax.distributed processes over window shards
produce a VCF byte-identical to the single-process run (the device-native
replacement for the reference's qsub cluster fan-out + merge,
README.md:70-88)."""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
os.environ.pop("XLA_FLAGS", None)  # 1 local CPU device per process
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
from lancet_jax.config import Config
from lancet_jax.parallel.multihost import init_distributed, run_multihost

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
init_distributed("127.0.0.1:" + port, nproc, pid)
cfg = Config(tumor_bam={tumor!r}, normal_bam={normal!r},
             ref_fasta={ref!r}, region={region!r}, num_threads=3)
vcf = run_multihost(cfg, command_line="mh", date="D\n", engine="device")
if pid == 0:
    open({out!r}, "w").write(vcf)
"""


def test_two_process_vcf_matches_single(tmp_path):
    from test_shardrun import _mixed_corpus

    from lancet_jax.config import Config
    from lancet_jax.runner import run

    chrom_len = _mixed_corpus(tmp_path, seed=31, chrom_len=9000)
    region = f"chr1:300-{chrom_len - 300}"
    cfg = Config(tumor_bam=f"{tmp_path}/tumor.bam",
                 normal_bam=f"{tmp_path}/normal.bam",
                 ref_fasta=f"{tmp_path}/ref.fa", region=region,
                 num_threads=3)
    want = run(cfg, command_line="mh", date="D\n", engine="device")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    out = str(tmp_path / "mh.vcf")
    script = _WORKER.format(repo=REPO, tumor=cfg.tumor_bam,
                            normal=cfg.normal_bam, ref=cfg.ref_fasta,
                            region=region, out=out)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("LANCET_DEVGRAPH", None)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i), "2",
                               port], env=env, cwd=REPO)
             for i in range(2)]
    for pr in procs:
        assert pr.wait(timeout=600) == 0
    got = open(out).read()
    assert got == want
    assert sum(1 for l in got.splitlines() if not l.startswith("#")) > 0


def test_shard_filter_collect_partition(tmp_path):
    """In-process sanity: the two half-runs' shard DBs merged in global
    shard order equal the full run's VCF (the invariant multi-host relies
    on, without spawning processes)."""
    from test_shardrun import _mixed_corpus

    from lancet_jax.config import Config
    from lancet_jax.engine.vardb import VariantDB
    from lancet_jax.runner import LANCET_VERSION, run
    from lancet_jax.io import open_bam

    chrom_len = _mixed_corpus(tmp_path, seed=33, chrom_len=9000)
    cfg = Config(tumor_bam=f"{tmp_path}/tumor.bam",
                 normal_bam=f"{tmp_path}/normal.bam",
                 ref_fasta=f"{tmp_path}/ref.fa",
                 region=f"chr1:300-{chrom_len - 300}", num_threads=3)
    want = run(cfg, command_line="mh", date="D\n", engine="device")

    parts = []
    for p in range(2):
        collect = {}
        run(cfg, command_line="mh", date="D\n", engine="device",
            shard_filter=lambda si, p=p: si % 2 == p, collect=collect)
        parts.extend(collect["shard_dbs"])
    merged = VariantDB(cfg.lr_mode)
    for _, db in sorted(parts, key=lambda t: t[0]):
        vdb = VariantDB(cfg.lr_mode)
        vdb.db = db
        merged.merge_from(vdb)
    tumor = open_bam(cfg.tumor_bam)
    normal = open_bam(cfg.normal_bam)
    got = merged.to_vcf(LANCET_VERSION, cfg.ref_fasta, "D\n", cfg.filters,
                        normal.sample_name(), tumor.sample_name(), "mh")
    assert got == want


_WORKER_DEVGRAPH = r"""
import os, sys
os.environ.pop("XLA_FLAGS", None)  # 1 local CPU device per process
os.environ["LANCET_DEVGRAPH"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
from lancet_jax.config import Config
from lancet_jax.parallel.mesh import make_local_mesh
from lancet_jax.parallel.multihost import init_distributed, run_multihost

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
init_distributed("127.0.0.1:" + port, nproc, pid)
stats = {{}}
cfg = Config(tumor_bam={tumor!r}, normal_bam={normal!r},
             ref_fasta={ref!r}, region={region!r}, num_threads=3)
vcf = run_multihost(cfg, command_line="mh", date="D\n", engine="device",
                    mesh=make_local_mesh(), stats=stats)
assert stats.get("n_dev_windows", 0) > 0, "device graph engine idle"
if pid == 0:
    open({out!r}, "w").write(vcf)
"""


def test_two_process_devgraph_matches_single(tmp_path):
    """Multi-host x device-graph composition (the multi-host story): 2
    jax.distributed processes, each running the DEVICE graph engine over
    a per-process local mesh on its window shards, must produce a VCF
    byte-identical to the single-process native run (ref thread/process
    invariance: Lancet.cc:305-310, 938-959; README.md:70-88)."""
    import os as _os

    from test_shardrun import _mixed_corpus

    from lancet_jax.config import Config
    from lancet_jax.runner import run

    chrom_len = _mixed_corpus(tmp_path, seed=37, chrom_len=9000)
    region = f"chr1:300-{chrom_len - 300}"
    cfg = Config(tumor_bam=f"{tmp_path}/tumor.bam",
                 normal_bam=f"{tmp_path}/normal.bam",
                 ref_fasta=f"{tmp_path}/ref.fa", region=region,
                 num_threads=3)
    want = run(cfg, command_line="mh", date="D\n", engine="device")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    out = str(tmp_path / "mh_dev.vcf")
    script = _WORKER_DEVGRAPH.format(repo=REPO, tumor=cfg.tumor_bam,
                                     normal=cfg.normal_bam,
                                     ref=cfg.ref_fasta,
                                     region=region, out=out)
    env = dict(_os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i), "2",
                               port], env=env, cwd=REPO)
             for i in range(2)]
    for pr in procs:
        assert pr.wait(timeout=1200) == 0
    got = open(out).read()
    assert got == want
    assert sum(1 for l in got.splitlines() if not l.startswith("#")) > 0
