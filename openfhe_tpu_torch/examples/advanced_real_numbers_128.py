"""High-precision CKKS via composite scaling (role of
``pke/examples/advanced-real-numbers-128.cpp``): the reference reaches
scaling factors near 2^89 by rebuilding with 128-bit NativeInteger; here
each scaling factor 2^p is the product of d ~p/d-bit NTT primes, so
precision grows without widening the word. This demo runs the same
depth-4 pipeline at a modest single-prime scale and at a composite
high-precision scale and prints the achieved precision of each."""

import numpy as np

from ..models import ckks
from ._common import device_from_argv


def _run(params: ckks.CKKSParams, label: str, x, rng, device) -> float:
    ctx = ckks.gen_context(params, device)
    pk, sk = ckks.keygen(ctx, rng)
    evk = ckks.relin_keygen(ctx, sk, rng)
    v = np.concatenate([x, np.zeros(ctx.params.num_slots - 8)])
    ct = ckks.encrypt(ctx, pk, v, rng)
    # depth-4: ((x^2)^2) via two square+rescale rounds
    ct = ckks.rescale_ctx(ctx, ckks.eval_square_relin(ct, evk))
    ct = ckks.rescale_ctx(ctx, ckks.eval_square_relin(ct, evk))
    dec = ckks.decrypt(ctx, sk, ct).real[:8]
    err = float(np.max(np.abs(dec - x ** 4)))
    bits = -np.log2(max(err, 1e-30))
    print(f"{label}: x^4 max |err| = {err:.3e} (~{bits:.1f} bits)")
    return err


def main(device=None):
    rng = np.random.default_rng(61)
    x = np.linspace(-1.0, 1.0, 8)

    err_single = _run(ckks.CKKSParams(ring_dim=256, mult_depth=2,
                                      scaling_mod_size=28, first_mod_size=40,
                                      dnum=2),
                      "single-prime  (28-bit scale)   ", x, rng, device)
    err_comp = _run(ckks.CKKSParams(ring_dim=256, mult_depth=2,
                                    scaling_mod_size=56, first_mod_size=60,
                                    dnum=2, composite_degree=2),
                    "composite d=2 (56-bit scale, u32)", x, rng, device)
    assert err_comp < err_single / 2, (err_comp, err_single)
    print("composite scaling delivers the extra precision "
          f"({err_single / err_comp:.1e}x better)")


if __name__ == "__main__":
    main(device_from_argv())
