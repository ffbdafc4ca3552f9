"""Proxy re-encryption with serialization (role of ``pre-buffer.cpp``)."""

import tempfile

import numpy as np

from ..models import ckks, pre
from ..utils import serial
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(1)

    params = ckks.CKKSParams(ring_dim=128, mult_depth=2, scaling_mod_size=40,
                             first_mod_size=50, dnum=2)
    ctx = ckks.gen_context(params, device)
    pk_a, sk_a = ckks.keygen(ctx, rng)   # Alice
    pk_b, sk_b = ckks.keygen(ctx, rng)   # Bob

    v = np.array([1.5, -2.25, 3.0])
    ct = ckks.encrypt(ctx, pk_a, v, rng)

    rk = pre.rekey_gen(ctx, sk_a, sk_b, rng)
    with tempfile.NamedTemporaryFile(suffix=".npz") as f:
        serial.save(rk, f.name)          # ship the re-key to the proxy
        rk2 = serial.load(f.name, device)
    ct_b = pre.re_encrypt(ct, rk2)       # proxy transforms without decrypting

    print("Bob decrypts:  ",
          np.round(ckks.decrypt(ctx, sk_b, ct_b, num_slots=3).real, 4))


if __name__ == "__main__":
    main(device_from_argv())
