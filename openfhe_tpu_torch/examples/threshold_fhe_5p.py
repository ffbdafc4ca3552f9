"""5-party threshold BFV (role of ``pke/examples/threshold-fhe-5p.cpp``,
generalized beyond CKKS like the reference's Element-generic multiparty):
round-robin joint keygen across 5 parties, 2-round interactive
relinearization key, encrypted aggregation, and distributed decryption
where all 5 shares are required."""

import numpy as np

from ..models import bfv, multiparty as mp
from ._common import device_from_argv

PARTIES = 5


def main(device=None):
    rng = np.random.default_rng(55)
    n = 128

    ctx = bfv.gen_context(bfv.BFVParams(ring_dim=n, num_towers=3,
                                        mod_size=55, dnum=2), device)

    # round-robin joint public key
    pk, sk0 = mp.keygen_lead(ctx, rng)
    shares = [sk0]
    for i in range(1, PARTIES):
        pk, sk_i = mp.keygen_join(ctx, pk, rng)
        shares.append(sk_i)
    print(f"{PARTIES}-party joint public key built")

    # 2-round interactive relinearization key
    r1 = [mp.evalmult_round1(ctx, shares[0], rng)]
    for s in shares[1:]:
        r1.append(mp.evalmult_round1(ctx, s, rng, prev_key=r1[0]))
    joint_ab = mp.evalmult_accumulate_round1(r1)
    evk = mp.evalmult_finalize(
        [mp.evalmult_round2(ctx, s, joint_ab, rng) for s in shares])
    print("joint relinearization key built (2 rounds)")

    # each party contributes a private vector; we compute the product of sums
    m1 = [1, 2, 3, 4, 5, 6, 7, 8]
    m2 = [2, 2, 2, 2, 3, 3, 3, 3]
    ct1 = bfv.encrypt(ctx, pk, m1 + [0] * (n // 2 - 8), rng)
    ct2 = bfv.encrypt(ctx, pk, m2 + [0] * (n // 2 - 8), rng)
    prod = bfv.eval_mult_relin(ctx, ct1, ct2, evk)

    # distributed decryption: lead + 4 mains
    parts = [mp.decrypt_lead(ctx, shares[0], prod, rng)]
    parts += [mp.decrypt_main(ctx, s, prod, rng) for s in shares[1:]]
    got = mp.combine(ctx, prod, parts, num_slots=8)
    want = [a * b for a, b in zip(m1, m2)]
    print("5-party decrypt:", list(got), "(expected", want, ")")
    assert list(got) == want

    # fewer than 5 shares must NOT decrypt
    partial = mp.combine(ctx, prod, parts[:4], num_slots=8)
    assert list(partial) != want
    print("4 of 5 shares correctly fail to decrypt")


if __name__ == "__main__":
    main(device_from_argv())
