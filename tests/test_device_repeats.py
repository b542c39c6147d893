"""Repeat-gate kernel vs oracle scalar implementations."""

import random

from lancet_jax.engine.seqs import is_almost_repeat, is_repeat
from lancet_jax.device.repeats import repeat_gates


def test_repeat_gates_match_oracle():
    rng = random.Random(5)
    windows = []
    for _ in range(6):
        L = rng.randint(40, 90)
        s = "".join(rng.choice("ACGT") for _ in range(L))
        # some windows get planted repeats / near repeats
        if rng.random() < 0.5:
            p = rng.randint(0, L - 30)
            q = rng.randint(0, L - 30)
            s = s[:q] + s[p : p + 25] + s[q + 25 :]
        windows.append(s)
    ks = [11, 13, 17, 21, 25]
    got = repeat_gates(windows, ks, 2)
    for wi, w in enumerate(windows):
        for ki, k in enumerate(ks):
            expect = is_repeat(w, k) or is_almost_repeat(w, k, 2)
            assert bool(got[wi, ki]) == expect, (wi, k, w)
