"""Interactive multi-party bootstrapping of a CHEBYSHEV-evaluated
ciphertext with threshold CKKS (3 parties).

Mirrors the reference's tckks-interactive-mp-bootstrapping-Chebyshev.cpp:
3 parties evaluate a Chebyshev series (here exp(x) on [-4, 4]) on a
jointly-encrypted input until the level budget is nearly exhausted,
refresh the result with the one-round interactive bootstrap, keep
computing on the refreshed ciphertext, and finish with distributed
decryption."""

import numpy as np

from ..models import ckks, ckks_advanced as adv, multiparty as mp
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(19)

    params = ckks.CKKSParams(ring_dim=256, mult_depth=8, scaling_mod_size=40,
                             first_mod_size=60, dnum=3)
    ctx = ckks.gen_context(params, device)
    print(f"CKKS ring dim {ctx.n}, {len(ctx.q_moduli)} towers")

    # --- joint key generation (round robin), incl. the joint relin key ---
    pk1, sk1 = mp.keygen_lead(ctx, rng)
    pk2, sk2 = mp.keygen_join(ctx, pk1, rng)
    pk, sk3 = mp.keygen_join(ctx, pk2, rng)
    sks = [sk1, sk2, sk3]
    r1 = [mp.evalmult_round1(ctx, sks[0], rng)]
    r1 += [mp.evalmult_round1(ctx, s, rng, prev_key=r1[0]) for s in sks[1:]]
    joint_ab = mp.evalmult_accumulate_round1(r1)
    evk = mp.evalmult_finalize(
        [mp.evalmult_round2(ctx, s, joint_ab, rng) for s in sks])
    print("3-party joint public key + relin key generated")

    x = np.array([-4.0, -2.5, 0.0, 1.5])
    ct = ckks.encrypt(ctx, pk, x, rng)

    # --- Chebyshev series for exp(x) on [-4, 4] (burns most of the budget)
    a, b = -4.0, 4.0
    coeffs = adv.chebyshev_coefficients(np.exp, a, b, 12)
    ct = adv.eval_chebyshev(ctx, ct, coeffs, a, b, evk)
    print(f"after Chebyshev: {ct.towers} towers left")

    # --- one-round interactive bootstrap of the Chebyshev result ---
    small = mp.int_mp_boot_adjust_scale(ctx, ct)
    ar = mp.int_mp_boot_random_element_gen(ctx, rng)
    shares = [mp.int_mp_boot_decrypt(ctx, s, small, ar, rng) for s in sks]
    agg = mp.int_mp_boot_add(shares)
    fresh = mp.int_mp_boot_encrypt(ctx, agg, ar, small)
    print(f"after interactive bootstrap: {fresh.towers} towers (full chain)")

    # keep computing at the refreshed level: scale by 1/2 (encoded at the
    # full scale — an enc_scale of 1.0 would round 0.5 to the integer 0)
    half = ckks.rescale(adv.mult_const(ctx, fresh, 0.5, ctx.scale))

    # --- distributed decryption ---
    parts = [mp.decrypt_lead(ctx, sks[0], half, rng)]
    parts += [mp.decrypt_main(ctx, s, half, rng) for s in sks[1:]]
    dec = mp.combine(ctx, half, parts, 4)
    want = np.exp(x) / 2
    print("exp(x)/2 :", np.round(want, 4))
    print("decrypted:", np.round(dec.real, 4))
    assert np.max(np.abs(dec.real - want)) < 5e-2
    print("OK")


if __name__ == "__main__":
    main(device_from_argv())
