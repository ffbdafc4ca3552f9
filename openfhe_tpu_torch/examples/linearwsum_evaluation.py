"""Linear weighted sums of ciphertexts (role of
``pke/examples/linearwsum-evaluation.cpp``): sum_i w_i * ct_i in one
fused pass."""

import numpy as np

from ..models import ckks, ckks_advanced as adv
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(31)
    n = 128

    ctx = ckks.gen_context(ckks.CKKSParams(ring_dim=n, mult_depth=2,
                                           scaling_mod_size=40,
                                           first_mod_size=50, dnum=2),
                           device)
    pk, sk = ckks.keygen(ctx, rng)

    weights = [0.25, -1.5, 2.0]
    vecs = [rng.normal(size=n // 2) for _ in weights]
    cts = [ckks.encrypt(ctx, pk, v, rng) for v in vecs]

    out = adv.linear_wsum(ctx, cts, weights)
    got = ckks.decrypt(ctx, sk, out, num_slots=4).real
    want = sum(w * v for w, v in zip(weights, vecs))[:4]
    print("sum w_i x_i =", np.round(got, 4))
    print("expected    =", np.round(want, 4))
    assert np.max(np.abs(got - want)) < 1e-3


if __name__ == "__main__":
    main(device_from_argv())
