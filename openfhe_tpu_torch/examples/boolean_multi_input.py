"""Multi-input boolean gates (role of
``binfhe/examples/boolean-multi-input.cpp``): MAJORITY / AND3 / OR4 over
3-4 inputs in one bootstrap, plus CMUX. 3-input gates encrypt bits at
plaintext modulus 6, 4-input at 8 (the reference's convention)."""

import numpy as np

from ..models import binfhe
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(43)

    ctx = binfhe.gen_context("TOY", device)
    sk = binfhe.keygen(ctx, rng)
    bk = binfhe.bootstrap_keygen(ctx, sk, rng)

    def enc(bit, p):
        return binfhe.encrypt_zp(ctx, sk, bit, p, rng)

    for gate, bits, fn in [
        ("MAJORITY", (1, 0, 1), lambda b: int(sum(b) >= 2)),
        ("AND3", (1, 1, 1), lambda b: b[0] & b[1] & b[2]),
        ("OR4", (0, 0, 1, 0), lambda b: int(any(b))),
    ]:
        p = binfhe.MULTI_GATES[gate][1]
        cts = [enc(x, p) for x in bits]
        out = binfhe.eval_gate_vec(ctx, gate, bk, cts)
        got = binfhe.decrypt(ctx, sk, out)
        print(f"{gate}{bits} = {got} (expected {fn(bits)})")
        assert got == fn(bits)

    # CMUX(d0, d1, sel): standard q/4 bit encoding
    for d0, d1, s in [(1, 0, 0), (1, 0, 1)]:
        cts = [binfhe.encrypt(ctx, sk, v, rng) for v in (d0, d1, s)]
        out = binfhe.eval_cmux(ctx, bk, *cts)
        got = binfhe.decrypt(ctx, sk, out)
        print(f"CMUX(d0={d0}, d1={d1}, sel={s}) = {got}")
        assert got == (d1 if s else d0)


if __name__ == "__main__":
    main(device_from_argv())
