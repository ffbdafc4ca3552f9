"""Deep BGV multiplication chain with explicit modulus switching
(role of ``pke/examples/depth-bgvrns.cpp``): each level multiplies,
relinearizes, and ModReduces to control noise."""

import numpy as np

from ..models import bgv
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(17)
    n = 128
    t = 65537

    ctx = bgv.gen_context(bgv.BGVParams(ring_dim=n, plaintext_modulus=t,
                                        mult_depth=3, mod_size=55, dnum=2),
                          device)
    pk, sk = bgv.keygen(ctx, rng)
    evk = bgv.relin_keygen(ctx, sk, rng)

    cur = bgv.encrypt(ctx, pk, [5] * (n // 2), rng)
    val = 5
    for d in range(1, 4):
        cur = bgv.relinearize(bgv.eval_mult(cur, cur), evk)
        cur = bgv.mod_reduce(ctx, cur)
        val = val * val % t
        got = bgv.decrypt(ctx, sk, cur, num_slots=1)[0]
        print(f"BGV depth {d} ({cur.towers} towers left): 5^(2^{d}) = {got} "
              f"(expected {val})")
        assert got == val


if __name__ == "__main__":
    main(device_from_argv())
