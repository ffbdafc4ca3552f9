"""Interactive multi-party bootstrapping with threshold CKKS (3 parties).

Mirrors the reference's tckks-interactive-mp-bootstrapping.cpp: encrypt
under a joint key, exhaust the level budget, refresh with the one-round
interactive protocol (secure against n-1 collusion), keep computing, and
finish with distributed decryption.
"""

import numpy as np

from ..models import ckks, multiparty as mp
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(7)

    params = ckks.CKKSParams(ring_dim=512, mult_depth=3, scaling_mod_size=40,
                             first_mod_size=60, dnum=2)
    ctx = ckks.gen_context(params, device)
    print(f"CKKS ring dim {ctx.n}, {len(ctx.q_moduli)} towers")

    # --- joint key generation (round robin) ---
    pk1, sk1 = mp.keygen_lead(ctx, rng)
    pk2, sk2 = mp.keygen_join(ctx, pk1, rng)
    pk, sk3 = mp.keygen_join(ctx, pk2, rng)
    sks = [sk1, sk2, sk3]
    print("3-party joint public key generated")

    v = np.array([-0.6, 3.2, 1.0, -2.25])
    ct = ckks.encrypt(ctx, pk, v, rng)

    # burn levels
    ct = ckks.rescale(ckks.eval_mult_plain(ctx, ct, np.ones(4)))
    ct = ckks.rescale(ckks.eval_mult_plain(ctx, ct, np.ones(4)))
    print(f"levels exhausted: {ct.towers} towers left")

    # --- one-round interactive bootstrap ---
    small = mp.int_mp_boot_adjust_scale(ctx, ct)
    a = mp.int_mp_boot_random_element_gen(ctx, rng)
    shares = [mp.int_mp_boot_decrypt(ctx, s, small, a, rng) for s in sks]
    agg = mp.int_mp_boot_add(shares)
    fresh = mp.int_mp_boot_encrypt(ctx, agg, a, small)
    print(f"after interactive bootstrap: {fresh.towers} towers (full chain)")

    # keep computing at the refreshed level
    sq = ckks.rescale(ckks.eval_mult_plain(ctx, fresh, v))

    # --- distributed decryption ---
    parts = [mp.decrypt_lead(ctx, sks[0], sq, rng)]
    parts += [mp.decrypt_main(ctx, s, sq, rng) for s in sks[1:]]
    dec = mp.combine(ctx, sq, parts, 4)
    print("v^2      :", np.round(v * v, 4))
    print("decrypted:", np.round(dec.real, 4))
    assert np.allclose(dec.real, v * v, atol=5e-3)
    print("OK")


if __name__ == "__main__":
    main(device_from_argv())
