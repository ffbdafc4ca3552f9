"""Boolean FHEW, dynamic large-precision, BINARY serialization (role of
``binfhe/examples/boolean-serial-binary-dynamic-large-precision.cpp``):
a large-precision context (phase modulus >> 2N) is serialized together
with its keys and a large-precision ciphertext; the deserialized objects
run a homomorphic floor — the op the dynamic large-precision pipeline
exists for. ``run(fmt, device)`` is the flow in either archive flavour."""

import os
import tempfile

import numpy as np

from ..models import binfhe
from ..utils import serial
from ._common import device_from_argv


def run(fmt, device=None):
    rng = np.random.default_rng(31)
    tmp = tempfile.mkdtemp(prefix=f"openfhe_tpu_boolser_lp_{fmt}_")
    ext = "npz" if fmt == "binary" else "json"

    ctx1 = binfhe.gen_context("TOY_LP", device)
    sk1 = binfhe.keygen(ctx1, rng)
    bk1 = binfhe.bootstrap_keygen(ctx1, sk1, rng)
    print("Done generating all keys.")

    mod = ctx1.params.q_ks      # large input modulus (the "dynamic" Q)
    value = 9871
    ct1 = binfhe.encrypt_phase(ctx1, sk1, value, mod, rng)

    for name, obj in [("cryptoContext", ctx1), ("refreshKey", bk1),
                      ("sk1", sk1), ("ct1", ct1)]:
        serial.save(obj, os.path.join(tmp, f"{name}.{ext}"), fmt=fmt)
    print(f"Large-precision context/keys/ciphertext serialized ({fmt}) to",
          tmp)

    ctx = serial.load(os.path.join(tmp, f"cryptoContext.{ext}"), device)
    bk = serial.load(os.path.join(tmp, f"refreshKey.{ext}"), device)
    sk = serial.load(os.path.join(tmp, f"sk1.{ext}"), device)
    ct = serial.load(os.path.join(tmp, f"ct1.{ext}"), device)
    print("Deserialized.")

    q = 2 * ctx.params.N
    beta = 64
    floored = binfhe.eval_floor(ctx, bk, ct, beta)
    got = binfhe.decrypt_phase(ctx, sk, floored)
    want = (value + beta) - ((value + beta) % q)
    print(f"EvalFloor({value}) -> {got} (expected {want} +- {q} + noise)")
    assert abs(got - want) <= 2 * q, (got, want)


def main(device=None):
    run("binary", device)


if __name__ == "__main__":
    main(device_from_argv())
