"""CKKS bootstrapping (role of ``simple-ckks-bootstrapping.cpp``):
an exhausted ciphertext is refreshed to a high level and keeps computing."""

import numpy as np

from ..models import ckks, ckks_bootstrap as boot
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(7)

    params = ckks.CKKSParams(ring_dim=512, mult_depth=14, scaling_mod_size=35,
                             first_mod_size=50, dnum=3, secret_hw=64)
    ctx = ckks.gen_context(params, device)
    pk, sk = ckks.keygen(ctx, rng)
    evk = ckks.relin_keygen(ctx, sk, rng)

    pre = boot.setup(ctx, slots=4, K=16, r=5, cheb_deg=28)
    keys = boot.keygen(ctx, sk, pre, rng)

    vals = np.array([0.25, -0.5, 0.75, 0.125])
    ct = ckks.encrypt(ctx, pk, np.tile(vals, ctx.params.num_slots // 4), rng)

    # burn the whole level budget
    ct_low = ckks.level_reduce(ct, len(ctx.q_moduli) - 1)
    print(f"before bootstrap: {ct_low.towers} tower(s) left (exhausted)")

    ct_fresh = boot.eval_bootstrap(ctx, keys, pre, ct_low)
    print(f"after bootstrap:  {ct_fresh.towers} towers available again")
    dec = ckks.decrypt(ctx, sk, ct_fresh, num_slots=4).real
    print("decrypted:", np.round(dec, 3), " expected:", vals)

    # ...and keep computing on the refreshed ciphertext
    sq = ckks.rescale(ckks.eval_square_relin(ct_fresh, evk))
    print("x^2 after refresh:", np.round(
        ckks.decrypt(ctx, sk, sq, num_slots=4).real, 3), " expected:",
        np.round(vals ** 2, 3))


if __name__ == "__main__":
    main(device_from_argv())
