"""Boolean FHEW with BINARY serialization (role of
``binfhe/examples/boolean-serial-binary.cpp``): serialize the context,
bootstrapping keys, secret key and a ciphertext to disk, reload everything
in a "second process", run a gate on the deserialized objects, decrypt."""

import os
import tempfile

import numpy as np

from ..models import binfhe
from ..utils import serial
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(23)
    tmp = tempfile.mkdtemp(prefix="openfhe_tpu_boolser_")

    # ---- "client": build + serialize ---------------------------------------
    ctx1 = binfhe.gen_context("TOY", device)
    sk1 = binfhe.keygen(ctx1, rng)
    bk1 = binfhe.bootstrap_keygen(ctx1, sk1, rng)
    print("Done generating all keys.")
    ct1 = binfhe.encrypt(ctx1, sk1, 1, rng)

    serial.save(ctx1, os.path.join(tmp, "cryptoContext.npz"))
    serial.save(bk1, os.path.join(tmp, "refreshKey.npz"))  # refresh + ks keys
    serial.save(sk1, os.path.join(tmp, "sk1.npz"))
    serial.save(ct1, os.path.join(tmp, "ct1.npz"))
    print("Context, keys and a ciphertext have been serialized to", tmp)

    # ---- "server": deserialize + evaluate ----------------------------------
    ctx = serial.load(os.path.join(tmp, "cryptoContext.npz"), device)
    bk = serial.load(os.path.join(tmp, "refreshKey.npz"), device)
    sk = serial.load(os.path.join(tmp, "sk1.npz"), device)
    ct = serial.load(os.path.join(tmp, "ct1.npz"), device)
    print("Context, keys and the ciphertext have been deserialized.")

    ct2 = binfhe.encrypt(ctx, sk, 1, rng)
    ct_and = binfhe.eval_gate(ctx, "AND", bk, ct, ct2)
    result = binfhe.decrypt(ctx, sk, ct_and)
    print("Result of encrypted computation of AND(1, 1) =", result)
    assert result == 1


if __name__ == "__main__":
    main(device_from_argv())
