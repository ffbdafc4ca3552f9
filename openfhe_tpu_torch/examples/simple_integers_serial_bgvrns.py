"""BGV serialization round-trip (role of
``pke/examples/simple-integers-serial-bgvrns.cpp``): the BGVrns analog of
simple-integers-serial — write context/keys/ciphertexts, reload, compute
sums and products on the deserialized objects, decrypt."""

import os
import tempfile

import numpy as np

from ..models import bgv
from ..utils import serial
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(13)
    tmp = tempfile.mkdtemp(prefix="openfhe_tpu_bgv_serial_")

    # ---- "client": build + serialize ---------------------------------------
    params = bgv.BGVParams(ring_dim=128, mult_depth=2,
                           plaintext_modulus=12289, mod_size=55, dnum=2)
    ctx = bgv.gen_context(params, device)
    pk, sk = bgv.keygen(ctx, rng)
    evk = bgv.relin_keygen(ctx, sk, rng)

    v1 = [1, 2, 3, 4, 5, 6, 7, 8]
    v2 = [3, 2, 1, 4, 2, 1, 2, 2]
    ct1 = bgv.encrypt(ctx, pk, v1 + [0] * (ctx.n - 8), rng)
    ct2 = bgv.encrypt(ctx, pk, v2 + [0] * (ctx.n - 8), rng)

    for name, obj in [("cryptocontext", ctx), ("key-public", pk),
                      ("key-private", sk), ("key-eval-mult", evk),
                      ("ciphertext1", ct1), ("ciphertext2", ct2)]:
        serial.save(obj, os.path.join(tmp, name + ".npz"))
    print("serialized BGV context, keys and ciphertexts to", tmp)

    # ---- "server": reload + compute ----------------------------------------
    ctx2 = serial.load(os.path.join(tmp, "cryptocontext.npz"), device)
    evk2 = serial.load(os.path.join(tmp, "key-eval-mult.npz"), device)
    ca = serial.load(os.path.join(tmp, "ciphertext1.npz"), device)
    cb = serial.load(os.path.join(tmp, "ciphertext2.npz"), device)

    csum = bgv.eval_add(ca, cb)
    cprod = bgv.relinearize(bgv.eval_mult(ca, cb), evk2)
    serial.save(csum, os.path.join(tmp, "ciphertext-sum.npz"))
    serial.save(cprod, os.path.join(tmp, "ciphertext-prod.npz"))

    # ---- "client" again: decrypt -------------------------------------------
    sk2 = serial.load(os.path.join(tmp, "key-private.npz"), device)
    rsum = serial.load(os.path.join(tmp, "ciphertext-sum.npz"), device)
    rprod = serial.load(os.path.join(tmp, "ciphertext-prod.npz"), device)
    got_sum = bgv.decrypt(ctx2, sk2, rsum)[:8]
    got_prod = bgv.decrypt(ctx2, sk2, rprod)[:8]
    t = ctx2.t
    print("sum :", got_sum, " expected:",
          [(a + b) % t for a, b in zip(v1, v2)])
    print("prod:", got_prod, " expected:",
          [(a * b) % t for a, b in zip(v1, v2)])
    assert got_sum == [(a + b) % t for a, b in zip(v1, v2)]
    assert got_prod == [(a * b) % t for a, b in zip(v1, v2)]


if __name__ == "__main__":
    main(device_from_argv())
