"""CKKS INDCPA^D noise-flooding decryption (role of
``pke/examples/ckks-noise-flooding.cpp``): the two-phase protocol.

Phase 1 (EXEC_NOISE_ESTIMATION): run the whole encrypted computation once
with throwaway keys and measure the output's log-error from the imaginary
parts of the decoded slots. Phase 2 (EXEC_EVALUATION): rebuild the context
with that estimate and FRESH keys; decryption now floods the phase with
Gaussian noise of sigma = 2^(statSec/2 + log2(sqrt(12 numQueries)) +
noiseEstimate), hiding the evaluation noise from the decryption oracle.
"""

import dataclasses

import numpy as np

from ..models import ckks
from ._common import device_from_argv


def encrypted_computation(ctx, pk, evk, rng):
    """The computation under test: x*y + x (run identically in both
    phases, like the reference's EncryptedComputation)."""
    x = np.array([1.0, 1.01, 1.02, 1.03, 1.04, 1.05, 1.06, 1.07])
    y = np.array([0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0])
    ct_x = ckks.encrypt(ctx, pk, x, rng)
    ct_y = ckks.encrypt(ctx, pk, y, rng)
    prod = ckks.rescale(ckks.eval_mult_relin(ct_x, ct_y, evk))
    return ckks.eval_add(prod, ckks.level_reduce(ct_x, 1)), x * y + x


def main(device=None):
    base = ckks.CKKSParams(ring_dim=256, mult_depth=2, scaling_mod_size=50,
                           first_mod_size=60, dnum=2,
                           decryption_noise_mode="NOISE_FLOODING_DECRYPT")

    # ---------------- Phase 1: noise estimation ----------------
    print("---- PHASE 1: NOISE ESTIMATION ----")
    params1 = dataclasses.replace(base, execution_mode="NOISE_ESTIMATION")
    ctx1 = ckks.gen_context(params1, device)
    rng = np.random.default_rng(2024)
    pk1, sk1 = ckks.keygen(ctx1, rng)
    evk1 = ckks.relin_keygen(ctx1, sk1, rng)
    ct1, _ = encrypted_computation(ctx1, pk1, evk1, rng)
    slots1 = ckks.decrypt(ctx1, sk1, ct1, num_slots=ctx1.params.num_slots)
    noise = ckks.estimate_log_error(slots1, ct1.scale)
    print(f"measured log2 noise: {noise}")

    # ---------------- Phase 2: evaluation with flooding ----------------
    print("---- PHASE 2: EVALUATION ----")
    params2 = dataclasses.replace(base, execution_mode="EVALUATION",
                                  noise_estimate=noise)
    ctx2 = ckks.gen_context(params2, device)
    print(f"flooding sigma: 2^{np.log2(ctx2.params.flood_decrypt_sigma):.1f}")
    # IMPORTANT: fresh keys for the flooding security guarantee
    pk2, sk2 = ckks.keygen(ctx2, rng)
    evk2 = ckks.relin_keygen(ctx2, sk2, rng)
    ct2, expected = encrypted_computation(ctx2, pk2, evk2, rng)
    out = ckks.decrypt(ctx2, sk2, ct2, num_slots=8, rng=rng)
    print("result  :", np.round(out.real, 3))
    print("expected:", np.round(expected, 3))
    assert np.max(np.abs(out.real - expected)) < 1e-2
    print("flooded decryption within 1e-2 of the exact result")


if __name__ == "__main__":
    main(device_from_argv())
