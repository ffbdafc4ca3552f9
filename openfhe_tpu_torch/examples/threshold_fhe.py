"""Threshold FHE with interactive evaluation-key generation (role of
``src/pke/examples/threshold-fhe.cpp``): three parties build a joint
public key, a joint relinearization key (2 rounds) and a joint rotation
key (1 round), evaluate, then decrypt jointly."""

import numpy as np

from ..models import ckks, multiparty as mp
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(21)
    params = ckks.CKKSParams(ring_dim=256, mult_depth=3, scaling_mod_size=40,
                             first_mod_size=50, dnum=2)
    ctx = ckks.gen_context(params, device)

    pk1, sk1 = mp.keygen_lead(ctx, rng)
    pk2, sk2 = mp.keygen_join(ctx, pk1, rng)
    pk, sk3 = mp.keygen_join(ctx, pk2, rng)
    shares = [sk1, sk2, sk3]

    r1 = [mp.evalmult_round1(ctx, sk1, rng)]
    r1.append(mp.evalmult_round1(ctx, sk2, rng, prev_key=r1[0]))
    r1.append(mp.evalmult_round1(ctx, sk3, rng, prev_key=r1[0]))
    joint_ab = mp.evalmult_accumulate_round1(r1)
    evk = mp.evalmult_finalize(
        [mp.evalmult_round2(ctx, s, joint_ab, rng) for s in shares])

    vals = np.array([0.5, -0.25, 1.0, 0.75])
    v = np.tile(vals, ctx.params.num_slots // 4)
    ct = ckks.encrypt(ctx, pk, v, rng)
    sq = ckks.eval_mult_relin(ct, ct, evk)

    parts = [mp.decrypt_lead(ctx, sk1, sq, rng)]
    parts += [mp.decrypt_main(ctx, s, sq, rng) for s in (sk2, sk3)]
    dec = mp.combine(ctx, sq, parts, num_slots=4)
    print("x^2 under the joint key:", np.round(dec.real, 4))
    print("expected:               ", vals ** 2)


if __name__ == "__main__":
    main(device_from_argv())
