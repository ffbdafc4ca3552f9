"""Large-precision sign and digit decomposition via repeated programmable
bootstrapping (role of ``src/binfhe/examples/eval-decomp.cpp`` and
``eval-sign.cpp``)."""

import numpy as np

from ..models import binfhe
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(7)

    ctx = binfhe.gen_context("TOY_LP", device)
    sk = binfhe.keygen(ctx, rng)
    bk = binfhe.bootstrap_keygen(ctx, sk, rng)

    mod = ctx.params.q_ks        # large input modulus (2^14)
    beta = 64

    for value in (937, 9871):
        ct = binfhe.encrypt_phase(ctx, sk, value, mod, rng)
        sign = binfhe.eval_sign_large(ctx, bk, ct, beta)
        print(f"sign({value})  -> {binfhe.decrypt_zp(ctx, sk, sign, 2)}"
              f"  (1 means >= {mod // 2})")

    value = 12345
    ct = binfhe.encrypt_phase(ctx, sk, value, mod, rng)
    digits = binfhe.eval_decomp(ctx, bk, ct, beta)
    print(f"decomp({value}) -> {len(digits)} digit ciphertexts; first digit "
          f"decrypts to {binfhe.decrypt_phase(ctx, sk, digits[0])} "
          f"(= {value} mod {2 * ctx.params.N}, up to noise)")


if __name__ == "__main__":
    main(device_from_argv())
