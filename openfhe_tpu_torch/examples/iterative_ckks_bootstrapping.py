"""Iterative (two-pass) CKKS bootstrapping (role of
``pke/examples/iterative-ckks-bootstrapping.cpp``): the second pass
bootstraps the AMPLIFIED error of the first, gaining ~precision bits."""

import numpy as np

from ..models import ckks, ckks_bootstrap as boot
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(61)

    params = ckks.CKKSParams(ring_dim=512, mult_depth=14, scaling_mod_size=35,
                             first_mod_size=50, dnum=3, secret_hw=64)
    ctx = ckks.gen_context(params, device)
    pk, sk = ckks.keygen(ctx, rng)
    pre = boot.setup(ctx, slots=4, K=16, r=5, cheb_deg=28)
    keys = boot.keygen(ctx, sk, pre, rng)

    vals = np.array([0.25, -0.5, 0.75, 0.125])
    v_rep = np.tile(vals, ctx.params.num_slots // 4)
    ct = ckks.encrypt(ctx, pk, v_rep, rng)
    ct_low = ckks.level_reduce(ct, len(ctx.q_moduli) - 1)

    single = boot.eval_bootstrap(ctx, keys, pre, ct_low)
    err1 = np.max(np.abs(ckks.decrypt(ctx, sk, single,
                                      num_slots=4).real - vals))
    print(f"single-pass bootstrap error: {err1:.2e}")

    double = boot.eval_bootstrap_iterative(ctx, keys, pre, ct_low,
                                           precision=4)
    err2 = np.max(np.abs(ckks.decrypt(ctx, sk, double,
                                      num_slots=4).real - vals))
    print(f"two-pass bootstrap error:    {err2:.2e}")
    assert err2 < err1, "iterative pass must improve precision"
    print(f"precision gained: {np.log2(err1 / err2):.1f} bits")


if __name__ == "__main__":
    main(device_from_argv())
