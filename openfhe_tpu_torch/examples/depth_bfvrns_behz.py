"""Deep BFV multiplication with the BEHZ RNS variant
(role of ``pke/examples/depth-bfvrns-behz.cpp``): the
Bajard-Eynard-Hasan-Zucca integer-only base conversions
(Montgomery m_tilde trick + Shenoy-Kumaresan) instead of HPS
fixed-point scaling."""

import numpy as np

from ..models import bfv
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(13)
    n = 128
    t = 65537

    ctx = bfv.gen_context(bfv.BFVParams(ring_dim=n, plaintext_modulus=t,
                                        num_towers=4, mod_size=55, dnum=2),
                          device)
    pk, sk = bfv.keygen(ctx, rng)
    evk = bfv.relin_keygen(ctx, sk, rng)

    msg = [7] * (n // 2)
    cur = bfv.encrypt(ctx, pk, msg, rng)
    val = 7
    for d in range(1, 3):
        cur = bfv.relinearize(bfv.eval_mult_behz(ctx, cur, cur), evk)
        val = val * val % t
        got = bfv.decrypt(ctx, sk, cur, num_slots=1)[0]
        print(f"BEHZ depth {d}: 7^(2^{d}) mod t = {got} (expected {val})")
        assert got == val
    print("BEHZ chain exact")


if __name__ == "__main__":
    main(device_from_argv())
