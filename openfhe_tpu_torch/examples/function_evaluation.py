"""Smooth-function evaluation on CKKS via Chebyshev interpolation
(role of ``pke/examples/function-evaluation.cpp``): 1/x, logistic and
sqrt over encrypted inputs."""

import numpy as np

from ..models import ckks, ckks_advanced as adv
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(25)
    n = 256

    ctx = ckks.gen_context(ckks.CKKSParams(ring_dim=n, mult_depth=8,
                                           scaling_mod_size=40,
                                           first_mod_size=50, dnum=3),
                           device)
    pk, sk = ckks.keygen(ctx, rng)
    evk = ckks.relin_keygen(ctx, sk, rng)

    x = np.array([1.0, 2.0, 3.0, 4.0])
    xv = np.tile(x, n // 8)
    ct = ckks.encrypt(ctx, pk, xv, rng)

    inv = adv.eval_divide(ctx, ct, 1.0, 5.0, 32, evk)
    got = ckks.decrypt(ctx, sk, inv, num_slots=4).real
    print("1/x      =", np.round(got, 4), "(expected", np.round(1 / x, 4),
          ")")
    assert np.max(np.abs(got - 1 / x)) < 1e-2

    sq = adv.eval_sqrt(ctx, ct, 0.5, 5.0, 32, evk)
    got = ckks.decrypt(ctx, sk, sq, num_slots=4).real
    print("sqrt(x)  =", np.round(got, 4), "(expected",
          np.round(np.sqrt(x), 4), ")")
    assert np.max(np.abs(got - np.sqrt(x))) < 1e-2

    y = np.array([-2.0, -0.5, 0.5, 2.0])
    cty = ckks.encrypt(ctx, pk, np.tile(y, n // 8), rng)
    lg = adv.eval_logistic(ctx, cty, -4.0, 4.0, 32, evk)
    got = ckks.decrypt(ctx, sk, lg, num_slots=4).real
    want = 1 / (1 + np.exp(-y))
    print("logistic =", np.round(got, 4), "(expected", np.round(want, 4),
          ")")
    assert np.max(np.abs(got - want)) < 1e-2


if __name__ == "__main__":
    main(device_from_argv())
