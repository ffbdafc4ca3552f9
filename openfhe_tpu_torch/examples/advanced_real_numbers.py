"""Advanced CKKS techniques (role of
``pke/examples/advanced-real-numbers.cpp``): automatic scaling
techniques (FIXEDAUTO / FLEXIBLEAUTO), hoisted "fast" rotations that
share one digit decomposition across many indices, and EvalPoly."""

import dataclasses

import numpy as np

from ..models import ckks, ckks_advanced as adv
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(21)
    n = 256
    base = ckks.CKKSParams(ring_dim=n, mult_depth=4, scaling_mod_size=40,
                           first_mod_size=50, dnum=2)

    x = np.array([0.5, 0.25, -0.5, 1.0])
    xv = np.tile(x, n // 8)

    # ---- scaling techniques: the same product, three management styles ----
    for tech in ("FIXEDMANUAL", "FIXEDAUTO", "FLEXIBLEAUTO"):
        params = dataclasses.replace(base, scaling_technique=tech)
        ctx = ckks.gen_context(params, device)
        pk, sk = ckks.keygen(ctx, rng)
        evk = ckks.relin_keygen(ctx, sk, rng)
        ct = ckks.encrypt(ctx, pk, xv, rng)
        if tech == "FIXEDMANUAL":
            prod = ckks.rescale(ckks.eval_mult_relin(ct, ct, evk))
        else:
            prod = adv.eval_mult_auto(ctx, ct, ct, evk)
        got = ckks.decrypt(ctx, sk, prod, num_slots=4).real
        print(f"{tech:13s} x^2 =", np.round(got, 4))
        assert np.max(np.abs(got - x * x)) < 1e-3

    # ---- hoisted rotations: one precompute, many indices ----
    ctx = ckks.gen_context(base, device)
    pk, sk = ckks.keygen(ctx, rng)
    rot_keys = ckks.rot_keygen(ctx, sk, [1, 2, 3], rng)
    ct = ckks.encrypt(ctx, pk, xv, rng)
    pre = ckks.fast_rotation_precompute(ct, rot_keys[1])
    for r in (1, 2, 3):
        out = ckks.eval_fast_rotate(ct, r, rot_keys[r], pre)
        got = ckks.decrypt(ctx, sk, out, num_slots=4).real
        print(f"fast rot {r}:", np.round(got, 4))
        assert np.max(np.abs(got - np.roll(xv, -r)[:4])) < 1e-3

    # ---- EvalPoly: 2x^3 - x + 1 ----
    evk = ckks.relin_keygen(ctx, sk, rng)
    ctp = adv.eval_poly(ctx, ckks.encrypt(ctx, pk, xv, rng),
                        [1.0, -1.0, 0.0, 2.0], evk)
    got = ckks.decrypt(ctx, sk, ctp, num_slots=4).real
    want = 2 * x ** 3 - x + 1
    print("2x^3 - x + 1 =", np.round(got, 4), "(expected", np.round(want, 4),
          ")")
    assert np.max(np.abs(got - want)) < 1e-2


if __name__ == "__main__":
    main(device_from_argv())
