"""Slot rotations in BFV, BGV and CKKS, including negative indices
(role of ``pke/examples/rotation.cpp``)."""

import numpy as np

from ..models import bfv, bgv, ckks
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(3)
    n = 128

    # ---- BFV ----
    fctx = bfv.gen_context(bfv.BFVParams(ring_dim=n, num_towers=2,
                                         mod_size=55, dnum=2), device)
    fpk, fsk = bfv.keygen(fctx, rng)
    gal = [bfv.rotation_galois(n, r % (n // 2)) for r in (1, 2, -1)]
    frk = bfv.rot_keygen(fctx, fsk, gal, rng)
    msg = list(range(1, 9)) + [0] * (n // 2 - 8)
    ct = bfv.encrypt(fctx, fpk, msg, rng)
    for r in (1, 2, -1):
        k = bfv.rotation_galois(n, r % (n // 2))
        out = bfv.eval_rotate(ct, r % (n // 2), frk[k])
        print(f"BFV  rot {r:+d}:", bfv.decrypt(fctx, fsk, out, num_slots=8))

    # ---- BGV ----
    bctx = bgv.gen_context(bgv.BGVParams(ring_dim=n, mult_depth=1,
                                         mod_size=55, dnum=2), device)
    bpk, bsk = bgv.keygen(bctx, rng)
    k1 = bgv.rotation_galois(n, 1)
    brk = bgv.rot_keygen(bctx, bsk, [k1], rng)
    bct = bgv.encrypt(bctx, bpk, msg, rng)
    print("BGV  rot +1:", bgv.decrypt(bctx, bsk, bgv.eval_rotate(
        bct, 1, brk[k1]), num_slots=8))

    # ---- CKKS (positive and negative rotations) ----
    cctx = ckks.gen_context(ckks.CKKSParams(ring_dim=n, mult_depth=1,
                                            scaling_mod_size=40,
                                            first_mod_size=50, dnum=2),
                            device)
    cpk, csk = ckks.keygen(cctx, rng)
    crk = ckks.rot_keygen(cctx, csk, [1, -1], rng)
    x = np.arange(1.0, 9.0)
    xv = np.concatenate([x, np.zeros(n // 2 - 8)])
    cct = ckks.encrypt(cctx, cpk, xv, rng)
    for r in (1, -1):
        out = ckks.decrypt(cctx, csk, ckks.eval_rotate(cct, r, crk[r]),
                           num_slots=8)
        print(f"CKKS rot {r:+d}:", np.round(out.real, 3))


if __name__ == "__main__":
    main(device_from_argv())
