"""Bootstrapping with CoeffsToSlots/SlotsToCoeffs LEVEL BUDGETS (role of
``pke/examples/advanced-ckks-bootstrapping.cpp``): instead of one dense
BSGS linear transform, the encoding FFT is collapsed into
level_budget[0] (resp. [1]) sparse factors, trading a level per factor
for asymptotically fewer rotations — the production configuration for
large slot counts."""

import numpy as np

from ..models import ckks, ckks_bootstrap as boot
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(67)

    params = ckks.CKKSParams(ring_dim=512, mult_depth=16, scaling_mod_size=35,
                             first_mod_size=50, dnum=3, secret_hw=64)
    ctx = ckks.gen_context(params, device)
    pk, sk = ckks.keygen(ctx, rng)

    # level budget (2, 2): CtS and StC each run as 2 collapsed FFT factors
    pre = boot.setup(ctx, slots=8, K=16, r=5, cheb_deg=28,
                     level_budget=(2, 2))
    keys = boot.keygen(ctx, sk, pre, rng)

    vals = np.array([0.25, -0.5, 0.75, 0.125, 0.0, 0.5, -0.25, 1.0])
    v_rep = np.tile(vals, ctx.params.num_slots // 8)
    ct = ckks.encrypt(ctx, pk, v_rep, rng)
    ct_low = ckks.level_reduce(ct, len(ctx.q_moduli) - 1)
    assert ct_low.towers == 1

    out = boot.eval_bootstrap(ctx, keys, pre, ct_low)
    dec = ckks.decrypt(ctx, sk, out, num_slots=8)
    err = np.max(np.abs(dec.real - vals))
    print(f"levels regained: {out.towers}, staged CtS/StC error: {err:.2e}")
    assert out.towers > 3 and err < 5e-2


if __name__ == "__main__":
    main(device_from_argv())
