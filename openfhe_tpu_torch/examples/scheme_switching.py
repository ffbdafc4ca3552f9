"""CKKS <-> FHEW scheme switching (role of ``scheme-switching.cpp``):
move packed values into the exact FHEW domain, compare them with one
programmable bootstrap each, and return the comparison bits to CKKS slots.
"""

import numpy as np

from ..models import binfhe, ckks, scheme_switch as ss
from ..utils import nbtheory
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(31)

    # small FHEW side so the sine interval stays narrow
    Q = nbtheory.first_prime(27, 2 * 256)
    fhew_params = binfhe.BinFHEParams(n_lwe=8, N=256, Q=Q, q_ks=1 << 14,
                                      log_bg=10, log_bks=5, sigma=3.19)
    bctx = binfhe.gen_context(fhew_params, device)
    sk_f = binfhe.keygen(bctx, rng)
    bk = binfhe.bootstrap_keygen(bctx, sk_f, rng)

    params = ckks.CKKSParams(ring_dim=512, mult_depth=13, scaling_mod_size=35,
                             first_mod_size=50, dnum=3, secret_hw=64)
    ctx = ckks.gen_context(params, device)
    pk, sk = ckks.keygen(ctx, rng)

    pre = ss.setup(ctx, bctx, slots=8, cheb_deg=56)
    keys = ss.keygen(ctx, bctx, pre, sk, sk_f, pk, rng)

    p_msg = 8
    msgs = [0, 1, 2, 3, 4, 5, 6, 7]
    tiled = np.tile(np.array(msgs, float), ctx.params.num_slots // len(msgs))
    ct = ckks.encrypt(ctx, pk, tiled, rng)

    # CKKS -> FHEW: one exact LWE ciphertext per slot value
    lwes = ss.eval_ckks_to_fhew(ctx, bctx, pre, keys, ct, len(msgs), p_msg)
    print("CKKS -> FHEW:", [binfhe.decrypt_zp(bctx, sk_f, c, p_msg)
                            for c in lwes], " expected:", msgs)

    # FHEW -> CKKS: gate-encoded bits back into slots
    bits = [0, 1, 1, 0, 1, 0, 0, 1]
    lwe_in = [binfhe.encrypt(bctx, sk_f, b, rng) for b in bits]
    back = ss.eval_fhew_to_ckks(ctx, bctx, pre, keys, lwe_in)
    print("FHEW -> CKKS:", np.round(ckks.decrypt(
        ctx, sk, back, num_slots=len(bits)).real, 2), " expected:", bits)

    # encrypted comparison through the switch (EvalCompareSchemeSwitching)
    v1 = [3, 1, 2, 0, 3, 2, 1, 1]
    v2 = [1, 3, 0, 2, 1, 3, 3, 2]
    ct1 = ckks.encrypt(ctx, pk, np.tile(np.array(v1, float), 32), rng)
    ct2 = ckks.encrypt(ctx, pk, np.tile(np.array(v2, float), 32), rng)
    cmp_ct = ss.eval_compare_scheme_switching(ctx, bctx, pre, keys, bk,
                                              ct1, ct2, len(v1), p_msg)
    print("v1 < v2:     ", np.round(ckks.decrypt(
        ctx, sk, cmp_ct, num_slots=len(v1)).real, 2))
    print("expected:    ", [1.0 if a < b else 0.0 for a, b in zip(v1, v2)])


if __name__ == "__main__":
    main(device_from_argv())
