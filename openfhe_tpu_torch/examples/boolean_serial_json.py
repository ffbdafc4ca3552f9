"""Boolean FHEW with JSON serialization (role of
``binfhe/examples/boolean-serial-json.cpp``): same round trip as the
binary variant, but through the human-readable JSON flavor (the analog
of cereal's SerType::JSON)."""

import os
import tempfile

import numpy as np

from ..models import binfhe
from ..utils import serial
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(29)
    tmp = tempfile.mkdtemp(prefix="openfhe_tpu_boolser_json_")

    ctx1 = binfhe.gen_context("TOY", device)
    sk1 = binfhe.keygen(ctx1, rng)
    bk1 = binfhe.bootstrap_keygen(ctx1, sk1, rng)
    print("Done generating all keys.")
    ct1 = binfhe.encrypt(ctx1, sk1, 1, rng)

    serial.save(ctx1, os.path.join(tmp, "cryptoContext.json"), fmt="json")
    serial.save(bk1, os.path.join(tmp, "refreshKey.json"), fmt="json")
    serial.save(sk1, os.path.join(tmp, "sk1.json"), fmt="json")
    serial.save(ct1, os.path.join(tmp, "ct1.json"), fmt="json")
    print("Context, keys and a ciphertext serialized as JSON to", tmp)

    ctx = serial.load(os.path.join(tmp, "cryptoContext.json"), device)
    bk = serial.load(os.path.join(tmp, "refreshKey.json"), device)
    sk = serial.load(os.path.join(tmp, "sk1.json"), device)
    ct = serial.load(os.path.join(tmp, "ct1.json"), device)
    print("Context, keys and the ciphertext have been deserialized.")

    ct2 = binfhe.encrypt(ctx, sk, 1, rng)
    ct_and = binfhe.eval_gate(ctx, "AND", bk, ct, ct2)
    result = binfhe.decrypt(ctx, sk, ct_and)
    print("Result of encrypted computation of AND(1, 1) =", result)
    assert result == 1


if __name__ == "__main__":
    main(device_from_argv())
