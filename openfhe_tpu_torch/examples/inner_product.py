"""Encrypted inner products: exact (BFV) and approximate (CKKS)
(role of ``pke/examples/inner-product.cpp``)."""

import numpy as np

from ..models import bfv, ckks, ckks_advanced as adv
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(5)
    n = 128

    # ---- BFV: exact integer inner product over all slots ----
    fctx = bfv.gen_context(bfv.BFVParams(ring_dim=n, num_towers=3,
                                         mod_size=55, dnum=2), device)
    fpk, fsk = bfv.keygen(fctx, rng)
    fevk = bfv.relin_keygen(fctx, fsk, rng)
    frk = bfv.rot_keygen(fctx, fsk, bfv.sum_galois_indices(n), rng)
    a = [1, 2, 3, 4, 5, 6, 7, 8] + [0] * (n // 2 - 8)
    b = [8, 7, 6, 5, 4, 3, 2, 1] + [0] * (n // 2 - 8)
    ct = bfv.eval_inner_product(fctx, bfv.encrypt(fctx, fpk, a, rng),
                                bfv.encrypt(fctx, fpk, b, rng), fevk, frk)
    got = bfv.decrypt(fctx, fsk, ct, num_slots=1)[0]
    want = sum(x * y for x, y in zip(a, b))
    print(f"BFV  <a, b> = {got} (expected {want})")
    assert got == want

    # ---- CKKS: approximate inner product over an 8-slot batch ----
    cctx = ckks.gen_context(ckks.CKKSParams(ring_dim=n, mult_depth=2,
                                            scaling_mod_size=40,
                                            first_mod_size=50, dnum=2),
                            device)
    cpk, csk = ckks.keygen(cctx, rng)
    cevk = ckks.relin_keygen(cctx, csk, rng)
    crk = ckks.rot_keygen(cctx, csk, adv.sum_rotation_indices(8), rng)
    xa = rng.normal(size=8)
    xb = rng.normal(size=8)
    va = np.concatenate([xa, np.zeros(n // 2 - 8)])
    vb = np.concatenate([xb, np.zeros(n // 2 - 8)])
    cct = adv.eval_inner_product(cctx, ckks.encrypt(cctx, cpk, va, rng),
                                 ckks.encrypt(cctx, cpk, vb, rng), 8, cevk,
                                 crk)
    got = ckks.decrypt(cctx, csk, cct, num_slots=1)[0].real
    print(f"CKKS <a, b> = {got:.6f} (expected {np.dot(xa, xb):.6f})")
    assert abs(got - np.dot(xa, xb)) < 1e-3


if __name__ == "__main__":
    main(device_from_argv())
