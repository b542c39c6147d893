#!/usr/bin/env python
"""Smoke test of the caller on an NVIDIA GPU: both engines end to end.

Drives the caller through its normal entry points on a tumor/normal
corpus generated from fixed seeds and checks every result exactly:

  phase 0  refuse to run without a GPU; print the card's name and limit
  phase 1  generate the corpus (bench.build_corpus: 520 kb chromosome,
           tumor and normal at 40x, 100 bp reads, one event per 2 kb)
  phase 2  default path (native host plane + device DP) on the whole
           region through the CLI entry, warm-up then timed; no window
           may fall back, the native plane must be in use, and the VCF
           records must equal those of the same command run in a child
           process on the CPU
  phase 3  the run's own sampled DP jobs through the device aligner and
           the oracle aligner (engine.align): exact equality
  phase 4  device graph engine (LANCET_DEVGRAPH=1) on a 30 kb slice
           (301 windows), twice: both VCFs identical to each other and
           to the default path's; device repeat gates equal to the
           oracle's
  phase 5  per-phase figures (wall, windows/s, compiles, stage split,
           peak device memory) beside the card's name and power limit
  phase 6  (--devices 4 only) the device graph engine on a 4-card mesh
           on the phase-4 slice, twice, against the default path on one
           card in the same process, both with the k ladder cut at 15

  python chip_smoke.py                 # one card, phases 0-5
  python chip_smoke.py --devices 4     # phase 6 only
  python chip_smoke.py --profile DIR   # also trace phases 2 and 4, time
                                       # the DP fill on its own, and
                                       # write summaries to DIR

The last line of stdout is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
with N the number of cards the phases used, printed only when every
check passed. Without a GPU, or run outside the
repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(REPO, ".corpus", "bench_v2")  # bench.CORPUS_DIR
REGION = "chr1:300-519700"  # the bench region: ~5,200 windows of 600 bp
# the device graph slice: 301 windows. Every k the engine reaches costs a
# set of cold XLA:GPU compiles (~2 min per k on one H100 host), and the
# 1,198-window slice chr1:300-120000 took 795 s of the 1,200 s budget.
SLICE = "chr1:300-30300"
DEVICE_KS = list(range(11, 64, 2))  # the device engine's k ladder
# Phase 6 compiles a second, sharded set of executables, each k its own.
# To fit the cold compiles into one call it stops the k ladder at 15
# (k 17 and 19 hold 7 of the slice's 88 device windows; both engines then
# leave those windows unassembled alike) and splits each executable's
# LLVM module over the host's cores, for this process only.
PHASE6_MAX_K = 15
PHASE6_XLA_FLAGS = (
    "--xla_gpu_enable_llvm_module_compilation_parallelism=true",
    f"--xla_gpu_force_compilation_parallelism={os.cpu_count() or 1}",
    "--xla_gpu_autotune_level=0",
)


def card_info() -> list[str]:
    """Name and power limit of each card, read by nvidia-smi in a child
    process (never through JAX)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


class Compiles:
    """Counts XLA backend compiles and their seconds (JAX monitoring)."""

    def __init__(self):
        import jax

        self.n = 0
        self.secs = 0.0
        self.cache_hits = 0
        jax.monitoring.register_event_duration_secs_listener(self._dur)
        jax.monitoring.register_event_listener(self._event)

    def _dur(self, event, secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.n += 1
            self.secs += secs

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.cache_hits += 1

    def snapshot(self):
        return self.n, self.secs, self.cache_hits


def cli_args(region: str, out: str) -> list[str]:
    return ["--tumor", os.path.join(CORPUS, "tumor.bam"),
            "--normal", os.path.join(CORPUS, "normal.bam"),
            "--ref", os.path.join(CORPUS, "ref.fa"),
            "--reg", region, "--num-threads", "8", "--out", out]


def records(path: str) -> list[str]:
    with open(path) as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith("#")]


def run_cli(region: str, tag: str) -> tuple[list[str], dict, float]:
    """One caller run through the CLI entry; returns (VCF records, stats,
    wall seconds)."""
    from lancet_jax import cli

    out = os.path.join(CORPUS, f"{tag}.vcf")
    stats: dict = {}
    t0 = time.perf_counter()
    rc = cli.main(cli_args(region, out), stats=stats)
    wall = time.perf_counter() - t0
    assert rc == 0, f"{tag}: cli exited {rc}"
    return records(out), stats, wall


def peak_bytes() -> int:
    import jax

    return max(int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
               for d in jax.local_devices())


def report(phase: str, n_windows: int, wall: float, stats: dict,
           compiles: tuple, cards: list[str]) -> None:
    """Phase-5 figures: observations on this card, not claims."""
    n_comp, comp_s, hits = compiles
    split = {k: round(v, 4) for k, v in sorted(stats.items())
             if isinstance(v, float) and (k == "t_dp" or k.startswith(
                 ("t_dg_", "t_dp_")) or k in ("t_host", "t_devgraph",
                                              "t_total"))}
    print(f"[{phase}] windows={n_windows} wall_s={wall:.4f} "
          f"windows_per_s={n_windows / wall:.3f} compiles={n_comp} "
          f"compile_s={comp_s:.3f} cache_hits={hits} "
          f"peak_bytes_in_use={peak_bytes()} card={' | '.join(cards)}",
          flush=True)
    print(f"[{phase}] split {json.dumps(split)}", flush=True)


def cpu_child_records(region: str) -> list[str]:
    """The same CLI command in a child process pinned to the CPU (the
    child never opens the card)."""
    out = os.path.join(CORPUS, "cpu_child.vcf")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    env.pop("LANCET_DEVGRAPH", None)
    r = subprocess.run(
        [sys.executable, "-m", "lancet_jax.cli", *cli_args(region, out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"cpu child failed:\n{r.stderr[-4000:]}"
    return records(out)


def check_native_plane(stats: dict) -> None:
    """The run stayed on the native plane: native readers, the native
    shard runner, and no window replayed on the Python engine."""
    from lancet_jax.engine import shardrun
    from lancet_jax.io import open_bam, open_fasta
    from lancet_jax.native import NativeBamReader, NativeFastaFile

    assert shardrun.available(), "native shard runner unavailable"
    assert isinstance(open_bam(os.path.join(CORPUS, "tumor.bam")),
                      NativeBamReader), "pure-Python BAM reader in use"
    assert isinstance(open_fasta(os.path.join(CORPUS, "ref.fa")),
                      NativeFastaFile), "pure-Python FASTA reader in use"
    assert stats.get("n_fallback") == 0, stats.get("n_fallback")


def check_dp(samples: list) -> None:
    """Phase 3: device DP vs the oracle aligner, exact."""
    from lancet_jax.device.align_batch import batch_align, pack_pairs
    from lancet_jax.engine.align import global_align_aff

    assert len(samples) >= 64, f"only {len(samples)} DP samples"
    ls = [len(s) for s, _ in samples] + [len(t) for _, t in samples]
    _, _, _, _, N, M = pack_pairs(samples)
    t0 = time.perf_counter()
    got = batch_align(samples)
    t_dev = time.perf_counter() - t0
    want = [global_align_aff(s, t) for s, t in samples]
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    assert not bad, f"DP mismatch on pairs {bad[:8]}"
    print(f"[phase3] dp pairs={len(samples)} len_min={min(ls)} "
          f"len_max={max(ls)} bucket N={N} M={M} device_s={t_dev:.4f}: "
          "int32 DP, aligned strings exactly equal to engine.align",
          flush=True)


def check_gates(region: str) -> None:
    """Phase 4: device repeat gates on the slice's windows vs the
    oracle's is_repeat / is_almost_repeat, exact."""
    import numpy as np

    from lancet_jax.device.repeats import repeat_gates
    from lancet_jax.engine.seqs import is_almost_repeat, is_repeat
    from lancet_jax.io import open_fasta
    from lancet_jax.windows import generate_windows

    fa = open_fasta(os.path.join(CORPUS, "ref.fa"))
    seqs = [w.rawseq for w in
            generate_windows(fa, [region], fa.lengths, 600, 250)]
    g, e = repeat_gates(seqs, DEVICE_KS, 2, with_exact=True)
    g, e = np.asarray(g), np.asarray(e)
    n_bad = 0
    for wi, s in enumerate(seqs):
        for ki, k in enumerate(DEVICE_KS):
            rep = is_repeat(s, k)
            n_bad += (bool(e[wi, ki]) != rep) + (
                bool(g[wi, ki]) != (rep or is_almost_repeat(s, k, 2)))
    assert n_bad == 0, f"{n_bad} gate verdicts differ from the oracle"
    print(f"[phase4] gates windows={len(seqs)} ks={len(DEVICE_KS)} "
          f"gated={int(g.sum())}: equal to engine.seqs", flush=True)


def trace_summary(trace_dir: str) -> dict:
    """Device busy time and top kernels from a jax.profiler trace: per
    GPU plane and line, the union of event intervals and the ten
    longest event names by total duration."""
    import glob

    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = ProfileData.from_file(path)
    lo, hi, out = None, None, {}
    for plane in pd.planes:
        for line in plane.lines:
            evs = sorted((e.start_ns, e.end_ns, e.name) for e in line.events)
            if not evs:
                continue
            lo = evs[0][0] if lo is None else min(lo, evs[0][0])
            hi = max(hi or 0, max(e[1] for e in evs))
            if "GPU" not in plane.name:
                continue
            busy, cur_s, cur_e = 0, None, None
            by_name: dict = {}
            for s, e, nm in evs:
                by_name[nm] = by_name.get(nm, 0) + (e - s)
                if cur_e is None or s > cur_e:
                    busy += 0 if cur_e is None else cur_e - cur_s
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            busy += cur_e - cur_s
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
            out[f"{plane.name}/{line.name}"] = {
                "busy_s": busy / 1e9, "n_events": len(evs),
                "top_s": {k: v / 1e9 for k, v in top}}
    return {"window_s": (hi - lo) / 1e9 if lo is not None else 0.0,
            "lines": out}


def profiled(region: str, tag: str, prof_dir: str) -> None:
    """--profile: rerun `region` under a jax.profiler trace, recording
    each DP batch; then time the DP fill alone and fill + traceback on
    those batches (warm, block_until_ready)."""
    import jax
    import jax.numpy as jnp

    from lancet_jax.device import align_batch as ab

    batches: list = []
    orig = ab.batch_align_async

    def record(pairs):
        batches.append(list(pairs))
        return orig(pairs)

    ab.batch_align_async = record
    tdir = os.path.join(prof_dir, tag)
    try:
        with jax.profiler.trace(tdir):
            _, stats, wall = run_cli(region, f"{tag}_prof")
    finally:
        ab.batch_align_async = orig
    t_fill = t_both = 0.0
    for pairs in batches:
        S, T, n, m, N, M = (jnp.asarray(a) if not isinstance(a, int) else a
                            for a in ab.pack_pairs(pairs))
        ab._dp_fill(S, T, n, m, N, M).block_until_ready()  # compile
        ab._dp_and_traceback(S, T, n, m, N, M)[0].block_until_ready()
        t0 = time.perf_counter()
        ab._dp_fill(S, T, n, m, N, M).block_until_ready()
        t1 = time.perf_counter()
        ab._dp_and_traceback(S, T, n, m, N, M)[0].block_until_ready()
        t_fill += t1 - t0
        t_both += time.perf_counter() - t1
    summ = trace_summary(tdir)
    summ.update(wall_traced_s=wall, t_dp=stats.get("t_dp"),
                n_dp_batches=len(batches),
                n_dp_pairs=sum(len(b) for b in batches),
                dp_fill_alone_s=t_fill, dp_fill_traceback_alone_s=t_both)
    with open(os.path.join(prof_dir, f"profile_{tag}.json"), "w") as f:
        json.dump(summ, f, indent=1)
    print(f"[profile {tag}] traced_wall_s={wall:.4f} t_dp={stats.get('t_dp')}"
          f" dp_batches={len(batches)} fill_alone_s={t_fill:.4f} "
          f"fill+traceback_alone_s={t_both:.4f} "
          f"trace_window_s={summ['window_s']:.4f}", flush=True)
    for name, ln in summ["lines"].items():
        print(f"[profile {tag}] {name} busy_s={ln['busy_s']:.4f} "
              f"events={ln['n_events']}", flush=True)


def one_card(cards: list[str], comp: Compiles, prof_dir: str | None):
    import bench
    from lancet_jax.io import open_fasta
    from lancet_jax.windows import generate_windows

    # phase 1: corpus from fixed seeds
    t0 = time.perf_counter()
    bench.build_corpus(CORPUS)
    fa = open_fasta(os.path.join(CORPUS, "ref.fa"))
    n_win = len(generate_windows(fa, [REGION], fa.lengths, 600, 250))
    n_slice = len(generate_windows(fa, [SLICE], fa.lengths, 600, 250))
    print(f"[phase1] corpus_s={time.perf_counter() - t0:.2f} "
          f"windows={n_win} slice_windows={n_slice}", flush=True)

    # phase 2: default path, warm-up then timed
    c0 = comp.snapshot()
    warm, _, w_wall = run_cli(REGION, "default_warm")
    c1 = comp.snapshot()
    report("phase2 warm-up", n_win, w_wall, {}, _diff(c1, c0), cards)
    recs, stats, wall = run_cli(REGION, "default")
    report("phase2", n_win, wall, stats, _diff(comp.snapshot(), c1), cards)
    assert recs == warm, "default path VCF differs between two runs"
    assert recs, "default path called no variants"
    check_native_plane(stats)
    t0 = time.perf_counter()
    cpu_recs = cpu_child_records(REGION)
    assert recs == cpu_recs, (
        f"GPU vs CPU records differ ({len(recs)} vs {len(cpu_recs)})")
    print(f"[phase2] records={len(recs)} n_fallback=0 native plane in use; "
          f"equal to the CPU child's ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    # phase 3: the run's sampled DP jobs vs the oracle aligner
    check_dp(stats.get("dp_samples", []))

    # phase 4: device graph engine, twice, vs the default path
    _, _, d_wall = run_cli(SLICE, "slice_default")
    default_slice = records(os.path.join(CORPUS, "slice_default.vcf"))
    os.environ["LANCET_DEVGRAPH"] = "1"
    try:
        c0 = comp.snapshot()
        dg_a, st_a, wall_a = run_cli(SLICE, "devgraph_a")
        c1 = comp.snapshot()
        dg_b, st_b, wall_b = run_cli(SLICE, "devgraph_b")
        c2 = comp.snapshot()
    finally:
        del os.environ["LANCET_DEVGRAPH"]
    report("phase4 default", n_slice, d_wall, {}, (0, 0.0, 0), cards)
    report("phase4 devgraph pass 1", n_slice, wall_a, st_a, _diff(c1, c0),
           cards)
    report("phase4 devgraph pass 2", n_slice, wall_b, st_b, _diff(c2, c1),
           cards)
    causes = st_b.get("dev_fallback_causes", {})
    print(f"[phase4] n_dev_windows={st_b.get('n_dev_windows')} "
          f"n_dev_fallback={st_b.get('n_dev_fallback')} "
          f"fallback_causes={json.dumps(causes)} "
          f"k_histogram={json.dumps(st_b.get('k_histogram', {}))}",
          flush=True)
    for st in (st_a, st_b):
        assert st.get("n_dev_windows", 0) > 0, "no window ran on the device"
        assert "engine_error" not in st.get("dev_fallback_causes", {})
    assert dg_a == dg_b, "device graph VCF differs between two passes"
    assert dg_a == default_slice, "device graph VCF differs from default"
    print(f"[phase4] records={len(dg_a)}: both passes identical and equal "
          "to the default path. The only float arithmetic on this path is "
          "the float32 avgcov comparison (no matmul, no TF32); the VCF "
          "equality covers it.", flush=True)
    check_gates(SLICE)

    if prof_dir:
        profiled(REGION, "phase2", prof_dir)
        os.environ["LANCET_DEVGRAPH"] = "1"
        try:
            profiled(SLICE, "phase4", prof_dir)
        finally:
            del os.environ["LANCET_DEVGRAPH"]


def four_cards(cards: list[str], comp: Compiles, n_dev: int) -> None:
    """Phase 6: the device graph engine on an n_dev-card mesh, in one
    process, on the phase-4 slice, against the default path on one card
    (phase 4 holds the engine on one card to the default path's VCF)."""
    import jax

    import bench
    from lancet_jax import cli
    from lancet_jax.io import open_fasta
    from lancet_jax.parallel.mesh import make_mesh
    from lancet_jax.runner import run
    from lancet_jax.windows import generate_windows

    assert len(jax.devices()) >= n_dev, jax.devices()
    bench.build_corpus(CORPUS)
    fa = open_fasta(os.path.join(CORPUS, "ref.fa"))
    n_slice = len(generate_windows(fa, [SLICE], fa.lengths, 600, 250))
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        [*cli_args(SLICE, "-"), "--max-k", str(PHASE6_MAX_K)]))

    def call(tag, mesh):
        stats: dict = {}
        c0 = comp.snapshot()
        t0 = time.perf_counter()
        vcf = run(cfg, command_line="chip_smoke", date="D\n",
                  engine="device", mesh=mesh, stats=stats)
        wall = time.perf_counter() - t0
        report(f"phase6 {tag}", n_slice, wall, stats,
               _diff(comp.snapshot(), c0), cards)
        return [ln for ln in vcf.splitlines() if not ln.startswith("#")], \
            stats

    ref, _ = call("default path, 1 card, warm-up", None)
    ref2, _ = call("default path, 1 card", None)
    os.environ["LANCET_DEVGRAPH"] = "1"
    try:
        mesh = make_mesh(n_dev)
        cold, _ = call(f"devgraph mesh={n_dev} cold", mesh)
        warm, st = call(f"devgraph mesh={n_dev}", mesh)
    finally:
        del os.environ["LANCET_DEVGRAPH"]
    print(f"[phase6] n_dev_windows={st.get('n_dev_windows')} "
          f"fallback_causes={json.dumps(st.get('dev_fallback_causes', {}))} "
          f"k_histogram={json.dumps(st.get('k_histogram', {}))}", flush=True)
    assert st.get("n_dev_windows", 0) > 0, "no window ran on the device"
    assert "engine_error" not in st.get("dev_fallback_causes", {})
    assert ref == ref2, "default path VCF differs between two runs"
    assert cold == warm, "mesh VCF differs between two passes"
    assert warm == ref, (
        f"{n_dev}-card VCF differs from one card's ({len(warm)} vs "
        f"{len(ref)} records)")
    print(f"[phase6] records={len(warm)}: the device graph VCF on "
          f"{n_dev} cards equals the default path's on one card",
          flush=True)


def _diff(a: tuple, b: tuple) -> tuple:
    return tuple(x - y for x, y in zip(a, b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the 4-card mesh phase")
    ap.add_argument("--profile", default="",
                    help="directory for jax.profiler traces of phases 2 "
                         "and 4 and their summaries")
    args = ap.parse_args()

    # phase 0: a GPU or nothing. XLA reads XLA_FLAGS when JAX starts its
    # backend, so the phase-6 options go in before JAX is imported.
    if args.devices > 1:
        os.environ["XLA_FLAGS"] = " ".join(
            [os.environ.get("XLA_FLAGS", ""), *PHASE6_XLA_FLAGS]).strip()
    else:
        # one card: keep JAX from reserving memory on any other
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import lancet_jax  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from the repository (no lancet_jax)",
              file=sys.stderr)
        return 3
    cards = card_info()[:args.devices]
    print(f"[phase0] jax {jax.__version__} devices={len(jax.devices())} "
          f"kind={dev.device_kind} XLA_FLAGS={os.environ.get('XLA_FLAGS')}",
          flush=True)

    comp = Compiles()
    t0 = time.perf_counter()
    if args.devices == 1:
        one_card(cards, comp, args.profile)
    else:
        four_cards(cards, comp, args.devices)
    n, secs, hits = comp.snapshot()
    print(f"[total] wall_s={time.perf_counter() - t0:.2f} compiles={n} "
          f"compile_s={secs:.2f} cache_hits={hits}", flush=True)
    for c in cards:
        print(c, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": args.devices}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
