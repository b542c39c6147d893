#!/usr/bin/env python
"""Golden comparison: our caller vs compiled reference lancet, record-level.

Usage: python tools/golden_compare.py [--bin /tmp/refbuild/src/lancet]
                                      [--seeds N] [--scenarios a,b,...]

Builds synthetic tumor/normal pairs (tests/goldengen.py), runs both
callers on identical inputs, and diffs the VCF records (headers carry a
timestamp and are compared structurally elsewhere).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

try:  # pin to CPU: golden comparison is correctness-only (the int
    # kernels are platform-deterministic)
    import jax

    jax.config.update("jax_platforms", "cpu")
except Exception:
    pass

from lancet_jax.config import Config  # noqa: E402
from lancet_jax.runner import run  # noqa: E402
from tests.goldengen import ALL_SCENARIOS, scenario  # noqa: E402
from tests.helpers import write_pair  # noqa: E402


def records(vcf_text: str) -> list[str]:
    return [l for l in vcf_text.splitlines() if l and not l.startswith("#")]


def compare_one(name: str, seed: int, binary: str, engine: str = "oracle",
                verbose: bool = True):
    from tests.goldengen import scenario_extras

    lr_mode = name.startswith("lr_")
    refseq, tumor, normal, region = scenario(name, seed)
    with tempfile.TemporaryDirectory() as td:
        ref_path, t_path, n_path = write_pair(td, refseq, "chr1", tumor, normal)
        extra_argv, extra_cfg = scenario_extras(name, td)
        argv = [binary, "--tumor", t_path, "--normal", n_path,
                "--ref", ref_path, "--reg", region] + extra_argv
        if lr_mode:
            argv.append("--linked-reads")
        r = subprocess.run(argv, capture_output=True, text=True, timeout=600)
        ref_recs = records(r.stdout)
        if r.returncode != 0:
            return None, f"reference crashed rc={r.returncode}"
        cfg = Config(tumor_bam=t_path, normal_bam=n_path, ref_fasta=ref_path,
                     region=region, lr_mode=lr_mode, **extra_cfg)
        ours = run(cfg, command_line="golden", date="D\n", engine=engine)
        our_recs = records(ours)
    if ref_recs == our_recs:
        return True, f"{len(ref_recs)} records identical"
    msg = [f"MISMATCH ({len(ref_recs)} ref vs {len(our_recs)} ours)"]
    for a in ref_recs:
        if a not in our_recs:
            msg.append(f"  ref only: {a}")
    for b in our_recs:
        if b not in ref_recs:
            msg.append(f"  ours only: {b}")
    return False, "\n".join(msg)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bin", default="/tmp/refbuild/src/lancet")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--scenarios", default=",".join(ALL_SCENARIOS))
    ap.add_argument("--engine", default="oracle")
    args = ap.parse_args()

    if not os.path.exists(args.bin):
        print(f"reference binary not found at {args.bin}; see "
              ".claude/skills/verify/SKILL.md to build it")
        sys.exit(2)

    total = ok = crash = 0
    failed = []
    for name in args.scenarios.split(","):
        for seed in range(args.seeds):
            total += 1
            good, msg = compare_one(name, seed, args.bin, args.engine)
            tag = "OK" if good else ("CRASH" if good is None else "FAIL")
            print(f"[{tag}] {name} seed={seed}: {msg.splitlines()[0]}")
            if good:
                ok += 1
            elif good is None:
                crash += 1
            else:
                failed.append((name, seed, msg))
    for name, seed, msg in failed:
        print(f"\n=== {name} seed={seed} ===\n{msg}")
    print(f"\n{ok}/{total} identical, {crash} reference crashes, "
          f"{len(failed)} mismatches")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
