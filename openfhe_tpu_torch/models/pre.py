"""Proxy re-encryption (PRE) for CKKS, BGV and BFV ciphertexts.

Counterpart of ``openfhe_tpu/models/pre.py``, the whole module (reference:
PREBase, ``pke/lib/schemebase/base-pre.cpp:40-74``). The re-encryption key
is a hybrid key-switch key from s_from to s_to, so ReEncrypt is one key
switch of c1, the same for every scheme.

Modes (reference: ProxyReEncryptionMode, ``constants.h:75-101``):

* ``INDCPA``: the plain key switch.
* ``FIXED_NOISE_HRA``: re-randomize with an encryption of zero under the
  SENDER's public key and flood c0 with Gaussian noise of deviation
  ``PRE_SD`` = 2^20.
* ``NOISE_FLOODING_HRA``: the same, with the deviation computed from the
  statistical security and the adversary's query budget
  (``flooding_sigma``).

Randomness is the caller's numpy Generator in the JAX package's order, so
keys and ciphertexts are bit-equal to its own for the same seed.
"""

from __future__ import annotations

import math

import numpy as np

from .. import dcrt, keyswitch
from ..utils import sampling

PRE_SD = 1 << 20   # NOISE_FLOODING::PRE_SD (constants.h:161)


def rekey_gen(ctx, sk_from, sk_to, rng: np.random.Generator,
              error_scale: int = 1) -> keyswitch.KSKey:
    """Key switching s_from -> s_to (the switching key generator takes the
    target secret first). ctx is a context of any of the three schemes; for
    BGV pass error_scale=ctx.t."""
    qp = ctx.full_qp_basis
    return keyswitch.keygen(ctx.ks_params, sk_to.poly(qp, ctx.device),
                            sk_from.poly(qp, ctx.device), rng,
                            ctx.params.sigma, error_scale=error_scale)


def flooding_sigma(ctx, mode: str, num_queries: int = 1,
                   stat_security: int = 30,
                   threshold_parties: int = 1) -> float:
    """Flooding distribution parameter (reference:
    ParameterGenerationBGVRNS::InitializeFloodingDgg,
    ``bgvrns-parametergeneration.cpp:281-344``, HYBRID branch), with the
    JAX package's float operations in its order."""
    if mode == "INDCPA":
        return 0.0
    if mode == "FIXED_NOISE_HRA":
        return float(PRE_SD)
    if mode != "NOISE_FLOODING_HRA":
        raise ValueError(f"unknown PRE mode {mode!r}")
    n = ctx.n
    sigma = ctx.params.sigma
    alpha = 36.0                      # assurance measure (OpenFHE default)
    B_e = math.sqrt(alpha) * sigma
    B_key = float(threshold_parties)  # ternary secrets
    ksp = ctx.ks_params
    dnum = ksp.dnum
    towers_per_digit = -(-len(ksp.q_moduli) // dnum)
    aux_bits = max(q.bit_length() for q in ksp.p_moduli)
    noise = towers_per_digit * dnum * math.sqrt(n) * B_e * (1 + 2 * B_key)
    noise += aux_bits * (1 + math.sqrt(n) * B_key)
    return math.sqrt(12 * num_queries) * (2 ** (stat_security / 2)) * noise


def _slice_poly(p: dcrt.RnsPoly, L: int) -> dcrt.RnsPoly:
    """First L towers of an RnsPoly (the ct may sit below the pk level)."""
    if p.basis.L == L:
        return p
    b = p.basis.drop_last(p.basis.L - L)
    return dcrt.make_poly(b, p.data[:L], p.fmt)


def encrypt_zero(ctx, pk, basis: dcrt.RnsBasis, rng: np.random.Generator,
                 error_scale: int = 1):
    """EncryptZeroCore under pk at a (possibly reduced) basis (reference:
    ``base-pke.cpp:145``): (pk_b v + t e0, pk_a v + t e1). Draws v, then
    e0, then e1."""
    L = basis.L
    v = dcrt.from_signed(basis, sampling.ternary_coeffs(ctx.n, rng),
                         ctx.device)

    def err():
        return dcrt.from_signed(basis, sampling.gaussian_coeffs(
            ctx.n, rng, ctx.params.sigma) * error_scale, ctx.device)

    e0 = err()
    e1 = err()
    return (dcrt.mul_add(_slice_poly(pk.b, L), v, e0),
            dcrt.mul_add(_slice_poly(pk.a, L), v, e1))


def re_encrypt(ct, rk: keyswitch.KSKey, ctx=None, pk=None,
               mode: str = "INDCPA", rng: np.random.Generator | None = None,
               noise_scale: int = 1, num_queries: int = 1):
    """ct(s_from) -> ct(s_to), for any 2-component ciphertext of the three
    schemes.

    HRA modes (reference ``base-pre.cpp:55-70``): pass ctx, pk (the
    SENDER's public key, so the zero-encryption is a valid sender ciphertext
    before the switch, as the reference's own UnitTestPRE passes it) and
    rng; the ciphertext is re-randomized with an encryption of zero and c0
    flooded with noise_scale * round(N(0, flooding_sigma)). For BGV pass
    noise_scale=ctx.t. The result is built as the JAX package builds it: a
    CKKS ciphertext keeps its scale, a BFV one gets the default noise
    degree 1."""
    assert len(ct.polys) == 2, "relinearize before re-encryption"
    c0, c1 = ct.polys
    if mode != "INDCPA":
        assert ctx is not None and pk is not None and rng is not None, \
            "HRA modes need ctx, the SENDER's public key, and an rng"
        z0, z1 = encrypt_zero(ctx, pk, c0.basis, rng,
                              error_scale=noise_scale)
        c0, c1 = dcrt.add(c0, z0), dcrt.add(c1, z1)
        sd = flooding_sigma(ctx, mode, num_queries)
        flood = np.rint(rng.normal(0.0, sd, size=ctx.n)).astype(np.int64)
        c0 = dcrt.add(c0, dcrt.from_signed(c0.basis, flood * noise_scale,
                                           ctx.device))
    d0, d1 = keyswitch.apply(rk, c1)
    new_polys = (dcrt.add(c0, d0), d1)
    if hasattr(ct, "scale"):
        return type(ct)(new_polys, ct.scale)
    return type(ct)(new_polys)
