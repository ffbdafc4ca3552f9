"""Deep BFV multiplication chains under the HPS variants
(role of ``pke/examples/depth-bfvrns.cpp``): x^(2^d) by repeated
squaring with relinearization, plus the HPSPOVERQ / HPSPOVERQLEVELED
multiplication techniques on the same chain."""

import numpy as np

from ..models import bfv
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(9)
    n = 128
    t = 65537

    ctx = bfv.gen_context(bfv.BFVParams(ring_dim=n, plaintext_modulus=t,
                                        num_towers=4, mod_size=55, dnum=2),
                          device)
    pk, sk = bfv.keygen(ctx, rng)
    evk = bfv.relin_keygen(ctx, sk, rng)

    msg = [3] * (n // 2)
    ct = bfv.encrypt(ctx, pk, msg, rng)

    # depth-3 squaring chain: 3 -> 9 -> 81 -> 6561, exact mod t
    cur = ct
    val = 3
    for d in range(1, 4):
        cur = bfv.relinearize(bfv.eval_mult(ctx, cur, cur), evk)
        val = val * val % t
        got = bfv.decrypt(ctx, sk, cur, num_slots=1)[0]
        print(f"HPS          depth {d}: 3^(2^{d}) = {got} (expected {val})")
        assert got == val

    # the POVQ variants on one multiplication
    for name, leveled in (("HPSPOVERQ", False), ("HPSPOVERQLEVELED", True)):
        prod = bfv.relinearize(
            bfv.eval_mult_povq(ctx, ct, ct, leveled=leveled), evk)
        got = bfv.decrypt(ctx, sk, prod, num_slots=1)[0]
        print(f"{name:12s} depth 1: 3^2 = {got} (expected 9)")
        assert got == 9


if __name__ == "__main__":
    main(device_from_argv())
