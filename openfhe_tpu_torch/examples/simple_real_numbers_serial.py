"""CKKS serialization round-trip (role of
``pke/examples/simple-real-numbers-serial.cpp``): client writes context,
keys and fresh ciphertexts to disk; a server reloads them, computes
add/mult-with-rescale/rotation, writes results back; the client decrypts
the deserialized results."""

import os
import tempfile

import numpy as np

from ..models import ckks
from ..utils import serial
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(41)
    tmp = tempfile.mkdtemp(prefix="openfhe_tpu_ckks_serial_")

    # ---- "client": build + serialize ---------------------------------------
    params = ckks.CKKSParams(ring_dim=256, mult_depth=2, scaling_mod_size=40,
                             first_mod_size=50, dnum=2)
    ctx = ckks.gen_context(params, device)
    pk, sk = ckks.keygen(ctx, rng)
    evk = ckks.relin_keygen(ctx, sk, rng)
    rot_keys = ckks.rot_keygen(ctx, sk, [1], rng)

    x1 = np.array([0.25, 0.5, 0.75, 1.0, 2.0, 3.0, 4.0, 5.0])
    x2 = np.array([5.0, 4.0, 3.0, 2.0, 1.0, 0.75, 0.5, 0.25])
    v1 = np.concatenate([x1, np.zeros(ctx.params.num_slots - 8)])
    v2 = np.concatenate([x2, np.zeros(ctx.params.num_slots - 8)])
    ct1 = ckks.encrypt(ctx, pk, v1, rng)
    ct2 = ckks.encrypt(ctx, pk, v2, rng)

    for name, obj in [("cryptocontext", ctx), ("key-public", pk),
                      ("key-private", sk), ("key-eval-mult", evk),
                      ("key-rot-1", rot_keys[1]),
                      ("ciphertext1", ct1), ("ciphertext2", ct2)]:
        serial.save(obj, os.path.join(tmp, name + ".npz"))
    print("serialized CKKS context, keys and ciphertexts to", tmp)

    # ---- "server": reload + compute ----------------------------------------
    ctx2 = serial.load(os.path.join(tmp, "cryptocontext.npz"), device)
    evk2 = serial.load(os.path.join(tmp, "key-eval-mult.npz"), device)
    rk2 = serial.load(os.path.join(tmp, "key-rot-1.npz"), device)
    ca = serial.load(os.path.join(tmp, "ciphertext1.npz"), device)
    cb = serial.load(os.path.join(tmp, "ciphertext2.npz"), device)

    c_add = ckks.eval_add(ca, cb)
    c_mul = ckks.rescale(ckks.eval_mult_relin(ca, cb, evk2))
    c_rot = ckks.eval_rotate(ca, 1, rk2)
    for name, obj in [("ct-add", c_add), ("ct-mul", c_mul),
                      ("ct-rot", c_rot)]:
        serial.save(obj, os.path.join(tmp, name + ".npz"))

    # ---- "client" again: decrypt the deserialized results ------------------
    sk2 = serial.load(os.path.join(tmp, "key-private.npz"), device)
    r_add = serial.load(os.path.join(tmp, "ct-add.npz"), device)
    r_mul = serial.load(os.path.join(tmp, "ct-mul.npz"), device)
    r_rot = serial.load(os.path.join(tmp, "ct-rot.npz"), device)
    print("x1 + x2 =", np.round(ckks.decrypt(ctx2, sk2, r_add).real[:8], 4))
    print("x1 * x2 =", np.round(ckks.decrypt(ctx2, sk2, r_mul).real[:8], 4))
    print("rot(x1) =", np.round(ckks.decrypt(ctx2, sk2, r_rot).real[:8], 4))
    assert np.max(np.abs(ckks.decrypt(ctx2, sk2, r_add).real[:8]
                         - (x1 + x2))) < 1e-3
    assert np.max(np.abs(ckks.decrypt(ctx2, sk2, r_mul).real[:8]
                         - x1 * x2)) < 1e-3


if __name__ == "__main__":
    main(device_from_argv())
