"""CKKS approximate real arithmetic (role of ``simple-real-numbers.cpp``):
encode, add, multiply, rescale, rotate."""

import numpy as np

from ..models import ckks
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(1)

    params = ckks.CKKSParams(ring_dim=256, mult_depth=3, scaling_mod_size=40,
                             first_mod_size=50, dnum=2)
    ctx = ckks.gen_context(params, device)
    pk, sk = ckks.keygen(ctx, rng)
    evk = ckks.relin_keygen(ctx, sk, rng)
    rot_keys = ckks.rot_keygen(ctx, sk, [1, 2], rng)

    x = np.array([0.25, 0.5, 0.75, 1.0, 2.0, 3.0, 4.0, 5.0])
    ct = ckks.encrypt(ctx, pk, x, rng)

    print("x + x      =", np.round(ckks.decrypt(
        ctx, sk, ckks.eval_add(ct, ct), num_slots=8).real, 4))
    sq = ckks.rescale(ckks.eval_square_relin(ct, evk))
    print("x^2        =", np.round(ckks.decrypt(ctx, sk, sq,
                                                num_slots=8).real, 4))
    rot = ckks.eval_rotate(ct, 1, rot_keys[1])
    print("rot(x, 1)  =", np.round(ckks.decrypt(
        ctx, sk, rot, num_slots=8).real, 4))


if __name__ == "__main__":
    main(device_from_argv())
