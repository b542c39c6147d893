#!/usr/bin/env python
"""Fuzz our Gotoh aligner against the compiled reference's aligner.

Requires a harness built from the reference's align.cc (out-of-repo):

    cat > /tmp/alntest/main.cc <<'EOF'
    #include <iostream>
    #include <string>
    #include "align.hh"
    using namespace std;
    int main() { string S, T;
      while (cin >> S >> T) { string sa, ta;
        global_align_aff(S, T, sa, ta, 0, 0);
        cout << sa << "\n" << ta << "\n"; } return 0; }
    EOF
    g++ -O2 -I<ref>/src main.cc <ref>/src/align.cc -o /tmp/alntest/alntest

Run: python tools/check_align_parity.py [harness_path]
"""

import random
import subprocess
import sys

sys.path.insert(0, ".")
from lancet_jax.engine.align import global_align_aff  # noqa: E402


def main():
    harness = sys.argv[1] if len(sys.argv) > 1 else "/tmp/alntest/alntest"
    rng = random.Random(99)
    cases = []
    for _ in range(400):
        n = rng.randint(1, 80)
        m = rng.randint(1, 80)
        cases.append(("".join(rng.choice("ACGT") for _ in range(n)),
                      "".join(rng.choice("ACGT") for _ in range(m))))
    for _ in range(400):
        n = rng.randint(50, 300)
        S = "".join(rng.choice("ACGT") for _ in range(n))
        T = list(S)
        for _ in range(rng.randint(1, 4)):
            op = rng.choice("sid")
            p = rng.randint(10, len(T) - 10)
            if op == "s":
                T[p] = rng.choice("ACGT")
            elif op == "i":
                T.insert(p, rng.choice("ACGT"))
            else:
                del T[p]
        cases.append((S, "".join(T)))
    bad = crash = 0
    for S, T in cases:
        r = subprocess.run([harness], input=f"{S} {T}\n",
                           capture_output=True, text=True)
        lines = r.stdout.splitlines()
        if r.returncode != 0 or len(lines) < 2:
            crash += 1  # reference UB on divergent strings
            continue
        sa, ta = global_align_aff(S, T)
        if (sa, ta) != (lines[0], lines[1]):
            bad += 1
            print("MISMATCH", S, T)
    print(f"{bad} mismatches, {crash} reference crashes, {len(cases)} cases")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
