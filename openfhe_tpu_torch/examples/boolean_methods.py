"""The three blind-rotation methods side by side (role of
``binfhe/examples/boolean-ap.cpp`` and ``boolean-lmkcdey.cpp``):
the same NAND gate bootstrapped with GINX (CGGI), AP (DM) and LMKCDEY
accumulators."""

import numpy as np

from ..models import binfhe
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(47)

    for name in ("TOY", "TOY_AP", "TOY_LMKCDEY"):
        ctx = binfhe.gen_context(name, device)
        sk = binfhe.keygen(ctx, rng)
        bk = binfhe.bootstrap_keygen(ctx, sk, rng)
        ok = True
        for a, b in [(0, 0), (0, 1), (1, 1)]:
            c1 = binfhe.encrypt(ctx, sk, a, rng)
            c2 = binfhe.encrypt(ctx, sk, b, rng)
            out = binfhe.eval_gate(ctx, "NAND", bk, c1, c2)
            ok &= binfhe.decrypt(ctx, sk, out) == 1 - (a & b)
        print(f"{ctx.params.method:8s} ({name}): NAND truth table "
              f"{'exact' if ok else 'FAILED'}")
        assert ok


if __name__ == "__main__":
    main(device_from_argv())
