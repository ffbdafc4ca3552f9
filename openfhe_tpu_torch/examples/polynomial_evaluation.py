"""Homomorphic polynomial / Chebyshev evaluation (role of
``polynomial-evaluation.cpp`` and ``function-evaluation.cpp``)."""

import numpy as np

from ..models import ckks, ckks_advanced as adv
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(1)

    params = ckks.CKKSParams(ring_dim=256, mult_depth=6, scaling_mod_size=40,
                             first_mod_size=50, dnum=2)
    ctx = ckks.gen_context(params, device)
    pk, sk = ckks.keygen(ctx, rng)
    evk = ckks.relin_keygen(ctx, sk, rng)

    x = np.array([-0.8, -0.3, 0.1, 0.5, 0.9])
    ct = ckks.encrypt(ctx, pk, x, rng)

    # power-basis polynomial 1 + 2x - x^2 + 0.5 x^3
    out = adv.eval_poly(ctx, ct, [1.0, 2.0, -1.0, 0.5], evk)
    print("poly(x)   =", np.round(ckks.decrypt(ctx, sk, out,
                                               num_slots=5).real, 4))
    print("expected  =", np.round(1 + 2 * x - x**2 + 0.5 * x**3, 4))

    # exp(x) via Chebyshev interpolation
    coeffs = adv.chebyshev_coefficients(np.exp, -1, 1, 7)
    out = adv.eval_chebyshev(ctx, ct, coeffs, -1, 1, evk)
    print("exp(x)    =", np.round(ckks.decrypt(ctx, sk, out,
                                               num_slots=5).real, 4))
    print("expected  =", np.round(np.exp(x), 4))


if __name__ == "__main__":
    main(device_from_argv())
