#!/usr/bin/env python
"""Benchmark: assembled windows/s on the current device vs 8-thread
reference CPU lancet on the identical corpus.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
vs_baseline is our windows/s divided by the reference binary's windows/s
measured in the SAME run (8 threads, this host). If the binary is missing
it is built from /root/reference (verify-skill recipe); if that fails the
last recorded anchor is used and the JSON is marked "anchor": "stale" —
a stale-anchor speedup is not a result, only a fallback so the driver
still gets a number.

Extra keys: anchor_wps, concordance {matched, ref_total, ours_total},
breakdown (per-stage seconds from the runner).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))

# generated corpora live in the checkout (.corpus/ is git-ignored), so two
# checkouts never share one and its `ok` marker
CORPUS_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           ".corpus")
CORPUS_DIR = os.path.join(CORPUS_ROOT, "bench_v2")
HARD_DIR = os.path.join(CORPUS_ROOT, "bench_hard_v2")
REF_BIN = os.environ.get("LANCET_REF_BIN", "/tmp/refbuild/src/lancet")
ANCHOR_FILE = os.path.join(CORPUS_DIR, "anchor_wps.txt")
HARD_ANCHOR_FILE = os.path.join(HARD_DIR, "anchor_wps.txt")

CHROM_LEN = 520_000
EVENT_SPACING = 2000
READ_LEN = 100
STEP = 5  # ~40x coverage, continuous over the chromosome


def build_corpus(out_dir: str = CORPUS_DIR):
    import random

    from helpers import make_reference, write_pair
    from goldengen import hap_reads

    os.makedirs(out_dir, exist_ok=True)
    marker = os.path.join(out_dir, "ok")
    if os.path.exists(marker):
        return
    rng = random.Random(2024)
    refseq = make_reference(CHROM_LEN, seed=99)
    tumor = []
    normal = []
    other = {"A": "C", "C": "G", "G": "T", "T": "A"}
    idx = 0
    half = EVENT_SPACING // 2
    for c in range(half, CHROM_LEN - half, EVENT_SPACING):
        kind = rng.choice(["s", "s", "i", "d"])
        if kind == "s":
            edit = ("s", c, other[refseq[c]])
        elif kind == "i":
            edit = ("i", c, "".join(rng.choice("ACGT") for _ in range(rng.randint(1, 6))))
        else:
            edit = ("d", c, rng.randint(1, 6))
        # contiguous segments -> continuous ~40x coverage chromosome-wide
        lo, hi = c - half, c + half
        tumor += hap_reads(refseq, edit, lo, hi, READ_LEN, STEP, f"t{idx}_",
                           0.5, 1000 + idx)
        normal += hap_reads(refseq, None, lo, hi, READ_LEN, STEP, f"n{idx}_",
                            0, 2000 + idx)
        idx += 1
    write_pair(out_dir, refseq, "chr1", tumor, normal)
    with open(marker, "w") as f:
        f.write("ok")


HARD_CHROM_LEN = 200_000
HARD_SPACING = 2000


def build_hard_corpus():
    """Adversarial corpus: window families that exercise the reference's
    expensive behaviors — STR-dense (findTandems + near-STR filters,
    util.cc:574-758), near-repeat segments (isAlmostRepeat gates forcing
    k>min_k, util.cc:317-360), homopolymer runs (HPS/HPSN/HPST), dense
    het SNV clusters (bubble/path pressure, Microassembler.cc:109-235),
    and high-coverage spikes. The k-retry tail carries real weight here:
    the per-k success histogram in the bench breakdown shows it."""
    import random

    from helpers import make_reference, write_pair
    from goldengen import hap_reads

    os.makedirs(HARD_DIR, exist_ok=True)
    marker = os.path.join(HARD_DIR, "ok")
    if os.path.exists(marker):
        return
    base = list(make_reference(HARD_CHROM_LEN, seed=555))
    half = HARD_SPACING // 2
    other = {"A": "C", "C": "G", "G": "T", "T": "A"}

    # plant adversarial sequence content around each event site
    centers = list(range(half, HARD_CHROM_LEN - half, HARD_SPACING))
    fams = []
    for idx, c in enumerate(centers):
        fam = ["str", "nearrep", "homopoly", "dense", "highcov",
               "plain", "dup70"][idx % 7]
        fams.append(fam)
        if fam == "str":
            # (AC)x18 + (AGC)x10 microsatellites flanking the event: exact
            # k-mer repeats gate k up to the run length
            run1 = "AC" * 18
            run2 = "AGC" * 10
            base[c - 60 : c - 60 + len(run1)] = run1
            base[c + 20 : c + 20 + len(run2)] = run2
        elif fam == "nearrep":
            # duplicate a 24bp block 60bp downstream with 1 mismatch:
            # isAlmostRepeat gates k<=23 -> the k loop must climb
            seg = base[c - 30 : c - 6]
            seg2 = list(seg)
            seg2[11] = other[seg2[11]]
            base[c + 30 : c + 30 + 24] = seg2
        elif fam == "homopoly":
            base[c - 40 : c - 16] = "A" * 24
        elif fam == "dup70":
            # exact 70bp tandem duplication: isRepeat/isAlmostRepeat gate
            # every k <= 73, forcing the retry ladder to k=75 — past the
            # device engine's k<=63 packing, so these windows measure the
            # native-replay cost of the k>63 corner (util.cc:295-360)
            base[c - 80 : c - 10] = base[c - 150 : c - 80]
    refseq = "".join(base)

    tumor, normal = [], []
    for idx, c in enumerate(centers):
        fam = fams[idx]
        lo, hi = c - half, c + half
        step, extra_edits = STEP, []
        if fam == "str":
            edit = ("i", c + 21, "AGC")  # unit-length indel inside the STR
        elif fam == "dup70":
            edit = ("s", c + 40, other[refseq[c + 40]])
            step = 2  # dense: the alt branch must survive pruning at k=75
        elif fam == "nearrep":
            edit = ("s", c + 60, other[refseq[c + 60]])
        elif fam == "homopoly":
            edit = ("d", c - 30, 1)  # 1bp del inside the homopolymer
        elif fam == "dense":
            edit = ("s", c, other[refseq[c]])
            # het SNV forest around the event: bubbles at every k
            extra_edits = [("s", c + off, other[refseq[c + off]])
                           for off in (-90, -60, -33, 27, 54, 81)]
        elif fam == "highcov":
            edit = ("s", c, other[refseq[c]])
            step = 2  # ~100x spike
        else:
            edit = ("s", c, other[refseq[c]])
        tumor += hap_reads(refseq, edit, lo, hi, READ_LEN, step,
                           f"t{idx}_", 0.5, 3000 + idx)
        for j, e in enumerate(extra_edits):
            # germline hets: present in BOTH samples (no somatic call)
            tumor += hap_reads(refseq, e, max(lo, e[1] - 140),
                               min(hi, e[1] + 140), READ_LEN, 11,
                               f"tx{idx}_{j}_", 0.5, 4000 + 7 * idx + j)
            normal += hap_reads(refseq, e, max(lo, e[1] - 140),
                                min(hi, e[1] + 140), READ_LEN, 11,
                                f"nx{idx}_{j}_", 0.5, 5000 + 7 * idx + j)
        normal += hap_reads(refseq, None, lo, hi, READ_LEN, step,
                            f"n{idx}_", 0, 6000 + idx)
    write_pair(HARD_DIR, refseq, "chr1", tumor, normal)
    with open(marker, "w") as f:
        f.write("ok")


LR_DIR = os.path.join(CORPUS_ROOT, "bench_lr_v1")
LR_CHROM_LEN = 60_000


def build_lr_corpus():
    """Linked-reads corpus: BX barcodes + HP haplotypes on every read
    (ref: Microassembler.cc:582-593, Variant.cc:53-60). Used for the
    measured LR-mode number — LR runs on the python engine path (the
    native plane doesn't carry BX/HP payloads yet; see PARITY.md)."""
    import random

    from helpers import make_reference, write_pair
    from goldengen import hap_reads

    os.makedirs(LR_DIR, exist_ok=True)
    marker = os.path.join(LR_DIR, "ok")
    if os.path.exists(marker):
        return
    rng = random.Random(909)
    refseq = make_reference(LR_CHROM_LEN, seed=808)
    other = {"A": "C", "C": "G", "G": "T", "T": "A"}
    tumor, normal = [], []
    half = EVENT_SPACING // 2
    for idx, c in enumerate(range(half, LR_CHROM_LEN - half,
                                  EVENT_SPACING)):
        edit = ("s", c, other[refseq[c]])
        t = hap_reads(refseq, edit, c - half, c + half, READ_LEN, STEP,
                      f"t{idx}_", 0.5, 7000 + idx)
        n = hap_reads(refseq, None, c - half, c + half, READ_LEN, STEP,
                      f"n{idx}_", 0, 8000 + idx)
        for al in t + n:
            off = c - al.pos
            has_alt = 0 <= off < READ_LEN and al.seq[off] != refseq[c]
            bc = rng.randrange(6)
            al.tags["BX"] = ("Z", f"BX{bc:03d}-1")
            al.tags["HP"] = ("i", (2 if has_alt else 1)
                             if rng.random() < 0.8 else 0)
        tumor += t
        normal += n
    write_pair(LR_DIR, refseq, "chr1", tumor, normal)
    with open(marker, "w") as f:
        f.write("ok")


def ensure_ref_binary() -> bool:
    """Build the reference lancet out-of-repo if missing (recipe from the
    verify skill). Returns True when REF_BIN exists afterwards."""
    if os.path.exists(REF_BIN):
        return True
    build_root = os.path.dirname(os.path.dirname(REF_BIN))  # /tmp/refbuild
    if os.path.basename(build_root) != "refbuild":
        return False
    src = "/root/reference"
    if not os.path.isdir(src):
        return False
    try:
        print("# building reference binary (one-time)...", file=sys.stderr)
        if not os.path.isdir(build_root):
            subprocess.run(["cp", "-r", src, build_root], check=True)
        bt = os.path.join(build_root, "bamtools-2.5.2")
        os.makedirs(os.path.join(bt, "build"), exist_ok=True)
        subprocess.run(["cmake", "-DCMAKE_INSTALL_PREFIX=../", ".."],
                       cwd=os.path.join(bt, "build"), check=True,
                       capture_output=True)
        subprocess.run(["make", "-j2"], cwd=os.path.join(bt, "build"),
                       check=True, capture_output=True)
        subprocess.run(["make", "install"], cwd=os.path.join(bt, "build"),
                       check=True, capture_output=True)
        hts = os.path.join(build_root, "htslib-1.15.1")
        subprocess.run(["./configure", "--disable-bz2", "--disable-lzma",
                        "--disable-libcurl", "--disable-gcs", "--disable-s3",
                        "--without-libdeflate"], cwd=hts, check=True,
                       capture_output=True)
        subprocess.run(["make", "-j2"], cwd=hts, check=True,
                       capture_output=True)
        sdir = os.path.join(build_root, "src")
        subprocess.run(["sed", "-i",
                        "s/-llzma -lbz2 -lz -ldl -lpthread -lcurl -lcrypto "
                        "-lbamtools/-lz -ldl -lpthread -lbamtools/",
                        "Makefile"], cwd=sdir, check=True)
        subprocess.run(["make"], cwd=sdir, check=True, capture_output=True)
    except subprocess.CalledProcessError as e:
        print(f"# reference build failed: {e}", file=sys.stderr)
    return os.path.exists(REF_BIN)


def count_windows(region: str, corpus: str = CORPUS_DIR) -> int:
    from lancet_jax.io.fasta import FastaFile
    from lancet_jax.windows import generate_windows

    fa = FastaFile(os.path.join(corpus, "ref.fa"))
    return len(generate_windows(fa, [region], fa.lengths, 600, 250))


def run_ours(region: str, stats: dict | None = None,
             corpus: str = CORPUS_DIR) -> tuple[float, str]:
    from lancet_jax.config import Config
    from lancet_jax.runner import run

    cfg = Config(tumor_bam=os.path.join(corpus, "tumor.bam"),
                 normal_bam=os.path.join(corpus, "normal.bam"),
                 ref_fasta=os.path.join(corpus, "ref.fa"),
                 region=region, num_threads=8)
    t0 = time.time()
    vcf = run(cfg, command_line="bench", date="D\n", engine="device",
              processes=True, stats=stats)
    return time.time() - t0, vcf


def run_reference(region: str,
                  corpus: str = CORPUS_DIR) -> tuple[float, str] | None:
    if not os.path.exists(REF_BIN):
        return None
    t0 = time.time()
    r = subprocess.run(
        [REF_BIN, "--tumor", os.path.join(corpus, "tumor.bam"),
         "--normal", os.path.join(corpus, "normal.bam"),
         "--ref", os.path.join(corpus, "ref.fa"),
         "--reg", region, "--num-threads", "8"],
        capture_output=True, text=True, timeout=7200)
    if r.returncode != 0:
        return None
    return time.time() - t0, r.stdout


def main():
    build_corpus()
    region = f"chr1:300-{CHROM_LEN - 300}"
    nwin = count_windows(region)

    # Warmup (untimed): XLA compiles (persistent-cached) and first
    # device<->host transfer; warm on a slice covering every shape bucket.
    # Its summary lines are suppressed so the driver tail holds only the
    # timed run's counters.
    import contextlib
    import io

    with contextlib.redirect_stderr(io.StringIO()):
        run_ours("chr1:300-30000")

    # two timed passes: pass 1 may still pay first-touch costs (page
    # cache, any shape bucket the warmup slice missed); pass 2 is the
    # steady state a long-running service sees. Both are reported; the
    # headline value is pass 2 (identical VCFs asserted).
    stats1: dict = {}
    elapsed1, vcf1 = run_ours(region, stats1)
    stats: dict = {}
    elapsed, vcf = run_ours(region, stats)
    assert vcf == vcf1, "non-deterministic VCF between timed passes"
    wps = nwin / elapsed
    wps_cold = nwin / elapsed1

    # ---- device graph engine configuration (LANCET_DEVGRAPH=1):
    # the full colored-DBG build/cleanup/path-cover on the device. Measured
    # every run beside the default so the engine-selection decision
    # (DESIGN.md 'Measured crossover') stays backed by current numbers.
    devgraph = None
    if not os.environ.get("LANCET_BENCH_SKIP_DEVGRAPH"):
        # >=1,000 windows so the crossover number is converged and the
        # k>63 / cap fallback costs are visible in the cause breakdown
        dg_region = f"chr1:300-{min(CHROM_LEN - 300, 120_000)}"
        nwin_dg = count_windows(dg_region)
        os.environ["LANCET_DEVGRAPH"] = "1"
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                run_ours(dg_region)  # warm (XLA compiles are cached)
            dgstats: dict = {}
            dg_elapsed, dg_vcf = run_ours(dg_region, dgstats)
        finally:
            del os.environ["LANCET_DEVGRAPH"]
        base_vcf = run_ours(dg_region)[1]  # default engine, env cleared
        t_dev = sum(dgstats.get(k, 0.0) for k in
                    ("t_dg_build", "t_dg_assemble", "t_dp"))
        devgraph = {
            "windows": nwin_dg,
            "wps": round(nwin_dg / dg_elapsed, 3),
            "vcf_equal_to_default": dg_vcf == base_vcf,
            "n_dev_windows": dgstats.get("n_dev_windows"),
            "n_dev_fallback": dgstats.get("n_dev_fallback"),
            "fallback_causes": dgstats.get("dev_fallback_causes"),
            "device_share_of_wall": round(t_dev / dg_elapsed, 4),
            "k_histogram": {str(k): v for k, v in
                            dgstats.get("k_histogram", {}).items()},
            "phases": {k: round(dgstats[k], 3) for k in
                       ("t_dg_pack", "t_dg_build", "t_dg_ranks",
                        "t_dg_assemble", "t_dg_finish")
                       if k in dgstats},
        }

    have_ref = ensure_ref_binary()
    ref = run_reference(region) if have_ref else None
    concordance = None
    anchor_state = "live"
    if ref is not None:
        ref_elapsed, ref_vcf = ref
        anchor = nwin / ref_elapsed
        with open(ANCHOR_FILE, "w") as f:
            f.write(str(anchor))
        ours_recs = sorted(l for l in vcf.splitlines() if not l.startswith("#"))
        ref_recs = sorted(l for l in ref_vcf.splitlines() if not l.startswith("#"))
        same = sum(1 for r in ref_recs if r in ours_recs)
        concordance = {"matched": same, "ref_total": len(ref_recs),
                       "ours_total": len(ours_recs)}
    elif os.path.exists(ANCHOR_FILE):
        anchor = float(open(ANCHOR_FILE).read())
        anchor_state = "stale"
    else:
        anchor = None
        anchor_state = "unavailable"

    breakdown = {k: round(v, 3) for k, v in stats.items()
                 if isinstance(v, float)}
    breakdown.update({k: v for k, v in stats.items() if isinstance(v, int)})
    if "k_histogram" in stats:  # per-k success counts (device graph path)
        breakdown["k_histogram"] = {str(k): v for k, v
                                    in stats["k_histogram"].items()}
    breakdown["n_dp_samples"] = len(stats.get("dp_samples", ()))

    # ---- adversarial corpus: STR/near-repeat/homopolymer/dense/high-cov
    # families where the k-retry tail carries real weight --------------
    hard = None
    if not os.environ.get("LANCET_BENCH_SKIP_HARD"):
        build_hard_corpus()
        hregion = f"chr1:300-{HARD_CHROM_LEN - 300}"
        nwin_h = count_windows(hregion, HARD_DIR)
        hstats: dict = {}
        with contextlib.redirect_stderr(io.StringIO()):
            run_ours(hregion, corpus=HARD_DIR)  # warm
        h_elapsed, h_vcf = run_ours(hregion, hstats, corpus=HARD_DIR)
        h_wps = nwin_h / h_elapsed
        href = run_reference(hregion, HARD_DIR) if have_ref else None
        h_anchor, h_conc, h_state = None, None, "unavailable"
        if href is not None:
            h_ref_elapsed, h_ref_vcf = href
            h_anchor = nwin_h / h_ref_elapsed
            h_state = "live"
            with open(HARD_ANCHOR_FILE, "w") as f:
                f.write(str(h_anchor))
            ours_h = sorted(l for l in h_vcf.splitlines()
                            if not l.startswith("#"))
            ref_h = sorted(l for l in h_ref_vcf.splitlines()
                           if not l.startswith("#"))
            h_conc = {"matched": sum(1 for r in ref_h if r in ours_h),
                      "ref_total": len(ref_h), "ours_total": len(ours_h)}
        elif os.path.exists(HARD_ANCHOR_FILE):
            h_anchor = float(open(HARD_ANCHOR_FILE).read())
            h_state = "stale"
        # per-k histogram: the native plane doesn't export per-window
        # success k, but every emitted record carries KMERSIZE — the k
        # that won that window's retry loop (devgraph runs also feed
        # stats["k_histogram"] per window; merged here)
        khist = {str(k): v for k, v in hstats.get("k_histogram", {}).items()}
        if not khist:
            import re as _re

            for line in h_vcf.splitlines():
                if line.startswith("#"):
                    continue
                m = _re.search(r"KMERSIZE=(\d+)", line)
                if m:
                    khist[m.group(1)] = khist.get(m.group(1), 0) + 1
            khist = dict(sorted(khist.items(), key=lambda kv: int(kv[0])))
        n_done = sum(khist.values()) or 1
        hard = {
            "windows": nwin_h,
            "wps": round(h_wps, 3),
            "vs_baseline": round(h_wps / h_anchor, 4) if h_anchor else None,
            "anchor": h_state,
            "anchor_wps": round(h_anchor, 3) if h_anchor else None,
            "concordance": h_conc,
            "k_histogram": khist,
            "frac_k_gt_min": round(
                sum(v for k, v in khist.items() if int(k) > 11) / n_done, 4),
            "n_dev_windows": hstats.get("n_dev_windows"),
            "n_dev_fallback": hstats.get("n_dev_fallback"),
        }

    # ---- LR (linked-reads) mode: native-plane path (BX/HP payloads,
    # LR coverage rows, HP/BX variant fields) + device-batched DP ------
    lr = None
    if not os.environ.get("LANCET_BENCH_SKIP_LR"):
        from lancet_jax.config import Config as _Cfg
        from lancet_jax.runner import run as _run

        build_lr_corpus()
        lregion = f"chr1:300-{LR_CHROM_LEN - 300}"
        nwin_l = count_windows(lregion, LR_DIR)
        lcfg = _Cfg(tumor_bam=os.path.join(LR_DIR, "tumor.bam"),
                    normal_bam=os.path.join(LR_DIR, "normal.bam"),
                    ref_fasta=os.path.join(LR_DIR, "ref.fa"),
                    region=lregion, num_threads=8, lr_mode=True,
                    active_regions=False)  # matches ref -l invocations
        # same methodology as the default corpus: one warm pass (jit
        # caches + process pool spin-up), then the timed steady-state
        # pass with a recorded breakdown
        lstats: dict = {}
        with contextlib.redirect_stderr(io.StringIO()):
            _run(lcfg, command_line="bench", date="D\n",
                 engine="device", processes=True)
            t0 = time.time()
            l_vcf = _run(lcfg, command_line="bench", date="D\n",
                         engine="device", processes=True, stats=lstats)
        l_wps = nwin_l / (time.time() - t0)
        l_anchor, l_conc = None, None
        if have_ref:
            t0 = time.time()
            r = subprocess.run(
                [REF_BIN, "--tumor", lcfg.tumor_bam, "--normal",
                 lcfg.normal_bam, "--ref", lcfg.ref_fasta, "--reg",
                 lregion, "--num-threads", "8", "--linked-reads",
                 "--active-region-off"],
                capture_output=True, text=True, timeout=7200)
            if r.returncode == 0:
                l_anchor = nwin_l / (time.time() - t0)
                ours_l = sorted(x for x in l_vcf.splitlines()
                                if not x.startswith("#"))
                ref_l = sorted(x for x in r.stdout.splitlines()
                               if not x.startswith("#"))
                l_conc = {"matched": sum(1 for x in ref_l if x in ours_l),
                          "ref_total": len(ref_l),
                          "ours_total": len(ours_l)}
        lr = {"windows": nwin_l, "wps": round(l_wps, 3),
              "vs_baseline": (round(l_wps / l_anchor, 4)
                              if l_anchor else None),
              "anchor_wps": round(l_anchor, 3) if l_anchor else None,
              "concordance": l_conc,
              "breakdown": {k: round(v, 3) for k, v in sorted(
                  lstats.items()) if isinstance(v, (int, float))},
              "engine": "native (LR plane: BX/HP payloads + device DP)"}

    print(f"# windows={nwin} elapsed={elapsed:.2f}s "
          f"anchor_wps={anchor} ({anchor_state}) concordance={concordance} "
          f"breakdown={breakdown}",
          file=sys.stderr)
    print(json.dumps({
        "metric": "windows_per_second_per_chip",
        "value": round(wps, 3),
        "unit": "windows/s",
        "vs_baseline": round(wps / anchor, 4) if anchor else None,
        "anchor": anchor_state,
        "anchor_wps": round(anchor, 3) if anchor else None,
        "first_pass_wps": round(wps_cold, 3),
        "concordance": concordance,
        "breakdown": breakdown,
        "devgraph": devgraph,
        "hard": hard,
        "lr": lr,
    }))


if __name__ == "__main__":
    main()
