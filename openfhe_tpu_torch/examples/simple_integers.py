"""Simple BFV integer arithmetic (role of the reference's
``simple-integers.cpp``): pack integer vectors, add, multiply, rotate."""

import numpy as np

from ..models import bfv
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(1)

    params = bfv.BFVParams(ring_dim=256, plaintext_modulus=12289,
                           num_towers=2, mod_size=55, dnum=2)
    ctx = bfv.gen_context(params, device)
    pk, sk = bfv.keygen(ctx, rng)
    evk = bfv.relin_keygen(ctx, sk, rng)

    v1 = [1, 2, 3, 4, 5, 6, 7, 8] + [0] * (ctx.n - 8)
    v2 = [8, 7, 6, 5, 4, 3, 2, 1] + [0] * (ctx.n - 8)
    ct1 = bfv.encrypt(ctx, pk, v1, rng)
    ct2 = bfv.encrypt(ctx, pk, v2, rng)

    print("v1 + v2 =", bfv.decrypt(ctx, sk, bfv.eval_add(ct1, ct2))[:8])
    print("v1 * v2 =", bfv.decrypt(
        ctx, sk, bfv.eval_mult_relin(ctx, ct1, ct2, evk))[:8])


if __name__ == "__main__":
    main(device_from_argv())
