"""Large-precision homomorphic sign evaluation (role of
``binfhe/examples/eval-sign.cpp``): decide whether a large-modulus LWE
phase is above or below Q/2 by flooring chunks away until one final
programmable bootstrap reads the sign bit."""

import numpy as np

from ..models import binfhe
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(53)

    ctx = binfhe.gen_context("TOY_LP", device)
    sk = binfhe.keygen(ctx, rng)
    bk = binfhe.bootstrap_keygen(ctx, sk, rng)

    mod = ctx.params.q_ks    # large input modulus Q
    beta = 64

    for value in (150, mod // 4, mod // 2 + 300, mod - 500):
        ct = binfhe.encrypt_phase(ctx, sk, value, mod, rng)
        signed = binfhe.eval_sign_large(ctx, bk, ct, beta)
        got = binfhe.decrypt_zp(ctx, sk, signed, 2)
        want = 0 if value < mod // 2 else 1
        print(f"sign({value} vs {mod // 2}) = {got} (expected {want})")
        assert got == want, (value, got, want)


if __name__ == "__main__":
    main(device_from_argv())
