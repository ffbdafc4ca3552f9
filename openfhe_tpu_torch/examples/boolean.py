"""Boolean FHEW/TFHE gates (role of ``src/binfhe/examples/boolean.cpp``)."""

import numpy as np

from ..models import binfhe
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(1)

    ctx = binfhe.gen_context("TOY", device)
    sk = binfhe.keygen(ctx, rng)
    bk = binfhe.bootstrap_keygen(ctx, sk, rng)

    ct1 = binfhe.encrypt(ctx, sk, 1, rng)
    ct2 = binfhe.encrypt(ctx, sk, 0, rng)

    for gate in ("AND", "OR", "NAND", "XOR"):
        out = binfhe.eval_gate(ctx, gate, bk, ct1, ct2)
        print(f"{gate}(1, 0) = {binfhe.decrypt(ctx, sk, out)}")
    print("NOT(1)    =", binfhe.decrypt(ctx, sk, binfhe.eval_not(ctx, ct1)))


if __name__ == "__main__":
    main(device_from_argv())
