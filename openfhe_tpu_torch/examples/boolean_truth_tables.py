"""Exhaustive truth tables for every 2-input gate (role of
``binfhe/examples/boolean-truth-tables.cpp``): AND/OR/NAND/NOR/XOR/XNOR
+ free NOT, each gate's 4 input rows bootstrapped in ONE batch."""

import numpy as np

from ..models import binfhe
from ._common import device_from_argv

TABLES = {
    "AND": lambda a, b: a & b, "OR": lambda a, b: a | b,
    "NAND": lambda a, b: 1 - (a & b), "NOR": lambda a, b: 1 - (a | b),
    "XOR": lambda a, b: a ^ b, "XNOR": lambda a, b: 1 - (a ^ b),
}


def main(device=None):
    rng = np.random.default_rng(41)

    ctx = binfhe.gen_context("TOY", device)
    sk = binfhe.keygen(ctx, rng)
    bk = binfhe.bootstrap_keygen(ctx, sk, rng)

    pairs = [(0, 0), (0, 1), (1, 0), (1, 1)]
    c1 = [binfhe.encrypt(ctx, sk, a, rng) for a, _ in pairs]
    c2 = [binfhe.encrypt(ctx, sk, b, rng) for _, b in pairs]

    for gate, fn in TABLES.items():
        outs = binfhe.eval_gate_batch(ctx, gate, bk, c1, c2)
        got = [binfhe.decrypt(ctx, sk, o) for o in outs]
        want = [fn(a, b) for a, b in pairs]
        print(f"{gate:5s}: {got}  (expected {want})")
        assert got == want

    nt = binfhe.eval_not(ctx, c1[3])
    print(f"NOT 1 = {binfhe.decrypt(ctx, sk, nt)}")
    assert binfhe.decrypt(ctx, sk, nt) == 0


if __name__ == "__main__":
    main(device_from_argv())
