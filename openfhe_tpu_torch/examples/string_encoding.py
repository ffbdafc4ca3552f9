"""Coefficient-packed and string plaintexts (role of the reference's
CoefPackedEncoding / StringEncoding user paths)."""

import numpy as np

from ..models import bfv
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(4)
    params = bfv.BFVParams(ring_dim=256, plaintext_modulus=12289,
                           num_towers=2, mod_size=55, dnum=2)
    ctx = bfv.gen_context(params, device)
    pk, sk = bfv.keygen(ctx, rng)

    ct = bfv.encrypt_poly(ctx, pk, bfv.encode_string(ctx, "Hello, TPU FHE!"),
                          rng)
    print("decrypted string:", bfv.decrypt_string(ctx, sk, ct))

    c1 = bfv.encrypt_poly(ctx, pk, bfv.encode_coef(ctx, [5, -3, 100]), rng)
    c2 = bfv.encrypt_poly(ctx, pk, bfv.encode_coef(ctx, [1, 2, 3]), rng)
    print("coef-packed sum:", bfv.decrypt_coef(ctx, sk,
                                               bfv.eval_add(c1, c2), 3))


if __name__ == "__main__":
    main(device_from_argv())
