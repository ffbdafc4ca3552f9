"""Simple BGV integer arithmetic (role of ``simple-integers-bgvrns.cpp``)."""

import numpy as np

from ..models import bgv
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(1)

    params = bgv.BGVParams(ring_dim=256, mult_depth=2,
                           plaintext_modulus=12289, mod_size=55, dnum=2)
    ctx = bgv.gen_context(params, device)
    pk, sk = bgv.keygen(ctx, rng)
    evk = bgv.relin_keygen(ctx, sk, rng)

    v1 = [1, 2, 3, 4, 5, 6, 7, 8] + [0] * (ctx.n - 8)
    v2 = [8, 7, 6, 5, 4, 3, 2, 1] + [0] * (ctx.n - 8)
    ct1 = bgv.encrypt(ctx, pk, v1, rng)
    ct2 = bgv.encrypt(ctx, pk, v2, rng)

    print("v1 + v2 =", bgv.decrypt(ctx, sk, bgv.eval_add(ct1, ct2))[:8])
    ctm = bgv.mod_reduce(ctx, bgv.eval_mult_relin(ct1, ct2, evk))
    print("v1 * v2 =", bgv.decrypt(ctx, sk, ctm)[:8])


if __name__ == "__main__":
    main(device_from_argv())
