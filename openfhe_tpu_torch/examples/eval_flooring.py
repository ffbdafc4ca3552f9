"""Large-precision homomorphic flooring (role of
``binfhe/examples/eval-flooring.cpp``): clear the low log2(2N) bits of a
large-modulus LWE phase via two programmable bootstraps."""

import numpy as np

from ..models import binfhe
from ._common import device_from_argv


def main(device=None):
    rng = np.random.default_rng(51)

    ctx = binfhe.gen_context("TOY_LP", device)
    sk = binfhe.keygen(ctx, rng)
    bk = binfhe.bootstrap_keygen(ctx, sk, rng)

    mod = ctx.params.q_ks     # large input modulus
    q = 2 * ctx.params.N      # chunk size cleared per floor
    beta = 64

    for value in (937, 9871, 12300):
        ct = binfhe.encrypt_phase(ctx, sk, value, mod, rng)
        floored = binfhe.eval_floor(ctx, bk, ct, beta)
        got = binfhe.decrypt_phase(ctx, sk, floored)
        want = (value + beta) - ((value + beta) % q)
        # the cleared value lands on a multiple of q adjacent to the input
        # (inputs near a q/2 boundary may round to the neighbour), plus the
        # residual PBS noise — the slack the large-precision pipeline's
        # beta-offsets are designed to absorb (eval_sign/eval_decomp).
        print(f"floor({value}) -> {got} (expected {want} +- {q} + noise)")
        assert abs(got - want) <= 2 * q, (got, want)


if __name__ == "__main__":
    main(device_from_argv())
