"""Serialization round-trip (role of ``simple-integers-serial.cpp``):
write the context, keys and ciphertexts to disk, reload them in a "second
process", and finish the computation on the deserialized objects."""

import os
import tempfile

import numpy as np

from ..models import bfv
from ..utils import serial
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(12)
    tmp = tempfile.mkdtemp(prefix="openfhe_tpu_serial_")

    # ---- "client": build everything and write it out -----------------------
    params = bfv.BFVParams(ring_dim=128, plaintext_modulus=12289,
                           num_towers=2, mod_size=55, dnum=2)
    ctx = bfv.gen_context(params, device)
    pk, sk = bfv.keygen(ctx, rng)
    evk = bfv.relin_keygen(ctx, sk, rng)

    v1 = [1, 2, 3, 4, 5, 6, 7, 8] + [0] * (ctx.n - 8)
    v2 = [3, 2, 1, 4, 2, 1, 2, 2] + [0] * (ctx.n - 8)
    ct1 = bfv.encrypt(ctx, pk, v1, rng)
    ct2 = bfv.encrypt(ctx, pk, v2, rng)

    for name, obj in [("cryptocontext", ctx), ("key-public", pk),
                      ("key-private", sk), ("key-eval-mult", evk),
                      ("ciphertext1", ct1), ("ciphertext2", ct2)]:
        serial.save(obj, os.path.join(tmp, name + ".npz"))
    print("serialized context, keys and ciphertexts to", tmp)

    # ---- "server": reload and compute --------------------------------------
    ctx2 = serial.load(os.path.join(tmp, "cryptocontext.npz"), device)
    evk2 = serial.load(os.path.join(tmp, "key-eval-mult.npz"), device)
    ca = serial.load(os.path.join(tmp, "ciphertext1.npz"), device)
    cb = serial.load(os.path.join(tmp, "ciphertext2.npz"), device)

    csum = bfv.eval_add(ca, cb)
    cprod = bfv.relinearize(bfv.eval_mult(ctx2, ca, cb), evk2)
    serial.save(csum, os.path.join(tmp, "ciphertext-sum.npz"))
    serial.save(cprod, os.path.join(tmp, "ciphertext-prod.npz"))

    # ---- "client" again: reload results and decrypt ------------------------
    sk2 = serial.load(os.path.join(tmp, "key-private.npz"), device)
    rsum = serial.load(os.path.join(tmp, "ciphertext-sum.npz"), device)
    rprod = serial.load(os.path.join(tmp, "ciphertext-prod.npz"), device)
    print("sum :", bfv.decrypt(ctx2, sk2, rsum)[:8],
          " expected:", [(a + b) % ctx.t for a, b in zip(v1[:8], v2[:8])])
    print("prod:", bfv.decrypt(ctx2, sk2, rprod)[:8],
          " expected:", [(a * b) % ctx.t for a, b in zip(v1[:8], v2[:8])])


if __name__ == "__main__":
    main(device_from_argv())
