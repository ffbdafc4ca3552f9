"""Threshold (multiparty) FHE over CKKS, BGV and BFV: additively shared
secrets, a round-robin joint public key, distributed decryption, the
interactive joint evaluation keys and CKKS's interactive bootstrapping.

Counterpart of ``openfhe_tpu/models/multiparty.py``, the whole module, with
the same names (reference: the Element-generic Multiparty capability,
``pke/lib/schemebase/base-multiparty.cpp:47``; examples threshold-fhe.cpp,
threshold-fhe-5p.cpp, tckks-interactive-mp-bootstrapping.cpp):

* ``keygen_lead`` / ``keygen_join``: party 1 samples (b1 = -a s1 + e1, a);
  each later party folds in its own share, b_i = b_{i-1} - a s_i + e_i, so
  the joint key encrypts under s = sum_i s_i. BGV scales every multiparty
  noise term by t (the reference's NoiseScale).
* ``decrypt_lead`` / ``decrypt_main`` / ``combine``: the lead computes
  c0 + c1 s_1 (+ flooding noise), every other party c1 s_i; the sum is the
  phase under the joint secret, finished by the scheme's own decode (CKKS
  canonical embedding, BGV centered CRT then mod t, BFV round(t x / Q)).
* ``evalmult_round1/round2/...`` and ``rot_keygen_share``: the two-round
  joint relinearization key and the one-round joint rotation key.
* ``int_mp_boot_*``: one round of masked decryption and re-encryption that
  gives a fresh full-level CKKS ciphertext.

Tensors live on the context's device. Randomness is the caller's numpy
Generator, drawn in the JAX package's order, so every share, joint key,
partial decryption and ciphertext is bit-equal to its own for the same seed.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Sequence

import numpy as np
import torch

from .. import dcrt, encoding, keyswitch
from ..dcrt import Format, RnsPoly
from ..ops import rns
from ..ops.modular import add_mod, int_tensor, sub_mod
from ..utils import sampling
from . import ckks
from .ckks import Ciphertext, CKKSContext, PublicKey, SecretKey


def _scheme(ctx):
    """(module, name) for a context of any of the three RNS schemes."""
    from . import bfv, bgv
    if isinstance(ctx, CKKSContext):
        return ckks, "ckks"
    if isinstance(ctx, bgv.BGVContext):
        return bgv, "bgv"
    if isinstance(ctx, bfv.BFVContext):
        return bfv, "bfv"
    raise TypeError(f"unsupported context type {type(ctx).__name__}")


def _noise_scale(ctx) -> int:
    """BGV pre-scales every noise term by t (reference: GetNoiseScale);
    BFV and CKKS use unscaled noise."""
    return ctx.t if _scheme(ctx)[1] == "bgv" else 1


def _error_poly(ctx, basis, rng) -> RnsPoly:
    return dcrt.from_signed(basis, sampling.gaussian_coeffs(
        ctx.n, rng, ctx.params.sigma) * _noise_scale(ctx), ctx.device)


def keygen_lead(ctx, rng: np.random.Generator):
    """Party 1: fresh share and the initial joint public key (any scheme)."""
    return _scheme(ctx)[0].keygen(ctx, rng)


def keygen_join(ctx, pk_prev: PublicKey, rng: np.random.Generator):
    """Party i >= 2: add its own share s_i into the joint public key
    (reference: MultipartyKeyGen with a prior public key). Draws the share
    (sparse ternary when the params set `secret_hw`), then the error."""
    basis = ctx.basis()
    hw = getattr(ctx.params, "secret_hw", 0)
    coeffs = sampling.sparse_ternary_coeffs(ctx.n, hw, rng) if hw else \
        sampling.ternary_coeffs(ctx.n, rng)
    sk_i = SecretKey(coeffs)
    s_i = sk_i.poly(basis, ctx.device)
    e = _error_poly(ctx, basis, rng)
    b = dcrt.add(dcrt.sub(e, dcrt.mul(pk_prev.a, s_i)), pk_prev.b)
    return PublicKey(b, pk_prev.a), sk_i


def joint_secret(ctx, shares: Sequence[SecretKey]) -> SecretKey:
    """Host-side sum of shares (FOR TESTS ONLY: it never exists in a real
    deployment)."""
    return SecretKey(np.sum([s.coeffs for s in shares], axis=0))


def decrypt_lead(ctx, sk_share: SecretKey, ct, rng: np.random.Generator,
                 flood_bits: int = 20) -> RnsPoly:
    """Lead partial decryption: c0 + c1 s_1 + e_smudge (reference:
    MultipartyDecryptLead; the smudge is t-scaled for BGV so it vanishes
    mod t)."""
    assert len(ct.polys) == 2
    basis = ct.basis
    part = dcrt.mul_add(ct.polys[1], sk_share.poly(basis, ctx.device),
                        ct.polys[0])
    return dcrt.add(part, _flood_noise(ctx, basis, rng, flood_bits))


def decrypt_main(ctx, sk_share: SecretKey, ct, rng: np.random.Generator,
                 flood_bits: int = 20) -> RnsPoly:
    """Non-lead partial decryption: c1 s_i + e_smudge (reference:
    MultipartyDecryptMain)."""
    basis = ct.basis
    part = dcrt.mul(ct.polys[1], sk_share.poly(basis, ctx.device))
    return dcrt.add(part, _flood_noise(ctx, basis, rng, flood_bits))


def _flood_noise(ctx, basis, rng, flood_bits: int) -> RnsPoly:
    mags = rng.integers(-(1 << flood_bits), 1 << flood_bits, size=ctx.n)
    return dcrt.from_signed(basis, mags * _noise_scale(ctx), ctx.device)


def combine(ctx, ct, partials: List[RnsPoly], num_slots: int | None = None):
    """Fuse partial decryptions into plaintext slots (reference:
    MultipartyDecryptFusion), finishing with the scheme's decode."""
    acc = partials[0]
    for p in partials[1:]:
        acc = dcrt.add(acc, p)
    module, name = _scheme(ctx)
    if name == "bfv":
        slots = encoding.packed_decode(module.phase_coeffs(ctx, acc), ctx.n,
                                       ctx.t)
        return slots[:num_slots] if num_slots else slots
    coeffs = ckks.crt_interpolate_centered(
        dcrt.to_int_rows(dcrt.to_coeff(acc)), ct.basis.moduli)
    if name == "bgv":
        slots = encoding.packed_decode([c % ctx.t for c in coeffs], ctx.n,
                                       ctx.t)
        return slots[:num_slots] if num_slots else slots
    return encoding.ckks_decode(coeffs, ctx.n, ct.scale, num_slots)


# ---------------------------------------------------------------------------
# Interactive joint evaluation keys (reference: threshold-fhe.cpp rounds;
# base-multiparty.cpp MultiKeySwitchGen / MultiAddEvalKeys /
# MultiMultEvalKey / MultiAddEvalMultKeys / MultiEvalAutomorphismKeyGen)
# ---------------------------------------------------------------------------


def _share_poly_qp(ctx, sk_i: SecretKey) -> RnsPoly:
    return sk_i.poly(ctx.full_qp_basis, ctx.device)


def _share_key(ctx, s_from: RnsPoly, s_to: RnsPoly, rng,
               prev_key: keyswitch.KSKey | None) -> keyswitch.KSKey:
    """A key-switch key share under fresh common randomness `a` (the lead)
    or under `prev_key`'s `a` (every other party)."""
    ks = ctx.ks_params
    if prev_key is None:
        return keyswitch.keygen(ks, s_from, s_to, rng, ctx.params.sigma,
                                error_scale=_noise_scale(ctx))
    return keyswitch.keygen_with_a(ks, s_from, s_to,
                                   keyswitch.key_a_datas(prev_key), rng,
                                   ctx.params.sigma,
                                   error_scale=_noise_scale(ctx))


def evalmult_round1(ctx, sk_i: SecretKey, rng: np.random.Generator,
                    prev_key: keyswitch.KSKey | None = None
                    ) -> keyswitch.KSKey:
    """Party i's round-1 share: the switching key s_i -> s_i under common
    randomness a (reference: KeySwitchGen + MultiKeySwitchGen)."""
    s_i = _share_poly_qp(ctx, sk_i)
    return _share_key(ctx, s_i, s_i, rng, prev_key)


def evalmult_accumulate_round1(shares: Sequence[keyswitch.KSKey]
                               ) -> keyswitch.KSKey:
    """Sum the b components: the joint key of s under s (reference:
    MultiAddEvalKeys)."""
    acc = shares[0]
    for k in shares[1:]:
        acc = keyswitch.add_keys_b(acc, k)
    return acc


def evalmult_round2(ctx, sk_i: SecretKey, joint_ab: keyswitch.KSKey,
                    rng: np.random.Generator) -> keyswitch.KSKey:
    """Party i's round-2 share: s_i * joint_ab plus fresh noise (reference:
    MultiMultEvalKey)."""
    return keyswitch.scale_key_by_share(joint_ab, _share_poly_qp(ctx, sk_i),
                                        rng, ctx.params.sigma,
                                        error_scale=_noise_scale(ctx))


def evalmult_finalize(shares: Sequence[keyswitch.KSKey]) -> keyswitch.KSKey:
    """Sum the round-2 shares into the joint relinearization key for
    s^2 -> s (reference: MultiAddEvalMultKeys)."""
    acc = shares[0]
    for k in shares[1:]:
        acc = keyswitch.add_keys_full(acc, k)
    return acc


def rot_keygen_share(ctx, sk_i: SecretKey, rot: int,
                     rng: np.random.Generator,
                     prev_key: keyswitch.KSKey | None = None
                     ) -> keyswitch.KSKey:
    """Party i's share of a joint rotation key, b_i = -a s_i + e +
    f * sigma_k(s_i); the sum of the shares is the joint automorphism key,
    in ONE round (reference: MultiEvalAutomorphismKeyGen)."""
    s_i = _share_poly_qp(ctx, sk_i)
    module, name = _scheme(ctx)
    k = ckks.rotation_indices_to_galois(ctx.n, rot) if name == "ckks" \
        else module.rotation_galois(ctx.n, rot)
    return _share_key(ctx, s_i, dcrt.automorphism(s_i, k), rng, prev_key)


def rot_keygen_finalize(shares: Sequence[keyswitch.KSKey]
                        ) -> keyswitch.KSKey:
    return evalmult_accumulate_round1(shares)


# ---------------------------------------------------------------------------
# Interactive multiparty bootstrapping (threshold CKKS). Reference:
# MultipartyCKKSRNS::IntMPBootAdjustScale / RandomElementGen / Decrypt /
# Add / Encrypt (ckksrns-multiparty.cpp:118-460).
#
# One round: every party masks its partial decryption of the compressed
# ciphertext with a fresh mask M_i (uniform over the first `mask_towers`
# moduli) and re-encrypts +M_i at FULL level under common randomness a:
#     h0_i = s_i * c1          - M_i   (mod q', no noise)
#     h1_i = -s_i * a + e_i    + M_i   (mod Q)
# The lead's final step lifts c0 + sum h0 from q' to Q, CENTERED, and adds
# sum h1: a fresh full-level encryption of the same message.
# ---------------------------------------------------------------------------


def int_mp_boot_adjust_scale(ctx: CKKSContext, ct: Ciphertext,
                             mask_towers: int = 1) -> Ciphertext:
    """Compress the ciphertext to its message towers plus `mask_towers`
    (reference: IntMPBootAdjustScale, FIXEDMANUAL branch)."""
    msg_towers = (ctx.params.scaling_mod_size //
                  ctx.params.first_mod_size + 1)
    keep = msg_towers + mask_towers
    assert ct.towers >= keep, "not enough towers left to bootstrap"
    return ckks.level_reduce(ct, ct.towers - keep)


def int_mp_boot_random_element_gen(ctx: CKKSContext,
                                   rng: np.random.Generator) -> RnsPoly:
    """Common random polynomial over the FULL chain (EVAL): the shared `a`
    of the output ciphertext (reference: IntMPBootRandomElementGen)."""
    basis = ctx.basis()
    return dcrt.from_int_rows(
        basis, sampling.uniform_rns_rows(ctx.n, basis.moduli, rng),
        Format.EVAL, ctx.device)


@lru_cache(maxsize=None)
def _half_consts(moduli: tuple, half: int, device: str) -> torch.Tensor:
    """[L, 1] residues of `half`, for the centered lift's shift."""
    return int_tensor([half % q for q in moduli], device).reshape(-1, 1)


def _expand_rows(x: torch.Tensor, from_moduli: tuple,
                 to_moduli: tuple) -> torch.Tensor:
    """Exact positive lift of coefficient rows over `from_moduli` to the
    superset basis `to_moduli` (which has from_moduli as a prefix)."""
    k = len(from_moduli)
    assert tuple(to_moduli[:k]) == tuple(from_moduli)
    if k == len(to_moduli):
        return x
    conv = rns.exact_switch_basis(x, from_moduli, tuple(to_moduli[k:]))
    return torch.cat([x, conv], dim=-2)


def int_mp_boot_decrypt(ctx: CKKSContext, sk_i: SecretKey, ct: Ciphertext,
                        a: RnsPoly, rng: np.random.Generator,
                        mask_towers: int = 1):
    """Party i's masked decryption and re-encryption share pair (reference:
    IntMPBootDecrypt). Draws the mask, then the error."""
    small = ct.basis
    full = ctx.basis()
    t_moduli = small.moduli[:mask_towers]
    m = dcrt.rows_tensor(sampling.uniform_rns_rows(ctx.n, t_moduli, rng),
                         ctx.device)
    m_small = dcrt.to_eval(dcrt.make_poly(
        small, _expand_rows(m, t_moduli, small.moduli), Format.COEFF))
    m_full = dcrt.to_eval(dcrt.make_poly(
        full, _expand_rows(m, t_moduli, full.moduli), Format.COEFF))

    # h0_i = s_i c1 - M_i over q' (no noise: reference IsZeroNoise=true)
    h0 = dcrt.sub(dcrt.mul(ct.polys[1], sk_i.poly(small, ctx.device)),
                  m_small)
    # h1_i = -s_i a + e_i + M_i over Q
    e = dcrt.from_signed(full, sampling.gaussian_coeffs(
        ctx.n, rng, ctx.params.sigma), ctx.device)
    h1 = dcrt.add(dcrt.sub(e, dcrt.mul(a, sk_i.poly(full, ctx.device))),
                  m_full)
    return h0, h1


def int_mp_boot_add(share_pairs):
    """Aggregate the parties' (h0_i, h1_i) pairs (reference:
    IntMPBootAdd)."""
    h0, h1 = share_pairs[0]
    for h0_i, h1_i in share_pairs[1:]:
        h0 = dcrt.add(h0, h0_i)
        h1 = dcrt.add(h1, h1_i)
    return h0, h1


def int_mp_boot_encrypt(ctx: CKKSContext, shares, a: RnsPoly,
                        ct: Ciphertext) -> Ciphertext:
    """The lead's final step: lift c0 + h0 to the full chain (CENTERED exact
    CRT expansion) and add the aggregated re-encryption share (reference:
    IntMPBootEncrypt). Output: a fresh full-level (c0'', a) with the same
    message and scale."""
    h0, h1 = shares
    small = ct.basis
    full = ctx.basis()
    x = dcrt.to_coeff(dcrt.add(ct.polys[0], h0))
    dev = str(x.device)
    # centered exact lift q' -> Q: shift by q'/2, positive lift, unshift
    half = math.prod(small.moduli) // 2
    shifted = add_mod(x.data, _half_consts(small.moduli, half, dev),
                      small.mod(x.device).q)
    lifted = _expand_rows(shifted, small.moduli, full.moduli)
    unshifted = sub_mod(lifted, _half_consts(full.moduli, half, dev),
                        full.mod(x.device).q)
    c0_full = dcrt.to_eval(dcrt.make_poly(full, unshifted, Format.COEFF))
    return Ciphertext((dcrt.add(c0_full, h1), a), ct.scale)
