"""BFV (scale-invariant) over RNS towers.

Counterpart of ``openfhe_tpu/models/bfv.py``, the whole module: messages
scaled by Delta = floor(Q/t) at encryption; multiplication by the HPS
pipeline (lift both ciphertexts to the extended basis S = Q∪R, tensor
there, scale by t/Q into R and switch exactly back to Q), by HPSPOVERQ and
its leveled variant (divide by R_l instead of Q), or by BEHZ (exact
Montgomery and Shenoy-Kumaresan conversions); packed, coefficient and string
encodings; rotations by hybrid key switching; compression.

Per multiplication the four lifts run as one [4, L, n] batch (one inverse
NTT, one basis switch, one forward NTT over S) and the three scale-backs as
one [3, |S|, n] batch: the JAX package lifts and scales each polynomial on
its own, with the same bits. The context carries its torch device;
randomness is the caller's numpy Generator in the JAX package's order.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .. import _build, dcrt, encoding, keyswitch
from ..dcrt import Format, RnsBasis, RnsPoly
from ..ops import elementwise, ntt, rns
from ..ops.modular import make_mod_consts, mul_mod, mul_mod_shoup
from ..utils import nbtheory, sampling, security
from .bgv import rotation_galois, sum_galois_indices  # noqa: F401
from .ckks import PublicKey, SecretKey


@dataclasses.dataclass(frozen=True)
class BFVParams:
    ring_dim: int = 1 << 12
    plaintext_modulus: int = 65537
    num_towers: int = 3
    mod_size: int = 60
    dnum: int = 3
    sigma: float = 3.19
    security_level: str = "HEStd_NotSet"


def _prod(vals) -> int:
    out = 1
    for v in vals:
        out *= v
    return out


@dataclasses.dataclass(frozen=True)
class BFVContext:
    params: BFVParams
    q_moduli: Tuple[int, ...]
    r_moduli: Tuple[int, ...]  # extension basis for multiplication
    p_moduli: Tuple[int, ...]  # keyswitch special primes
    device: torch.device

    @property
    def n(self) -> int:
        return self.params.ring_dim

    @property
    def t(self) -> int:
        return self.params.plaintext_modulus

    @property
    def Q(self) -> int:
        return _prod(self.q_moduli)

    @property
    def delta_rows(self) -> Tuple[int, ...]:
        """[Delta]_{q_i} with Delta = floor(Q/t)."""
        d = self.Q // self.t
        return tuple(d % q for q in self.q_moduli)

    @property
    def ks_params(self) -> keyswitch.KSParams:
        alpha = -(-len(self.q_moduli) // self.params.dnum)
        return keyswitch.KSParams(self.n, self.q_moduli, self.p_moduli, alpha)

    def basis(self) -> RnsBasis:
        return RnsBasis(self.n, self.q_moduli)

    @property
    def ext_basis(self) -> RnsBasis:
        return RnsBasis(self.n, self.q_moduli + self.r_moduli)

    @property
    def full_qp_basis(self) -> RnsBasis:
        return RnsBasis(self.n, self.q_moduli + self.p_moduli)


def gen_context(params: BFVParams, device=None) -> BFVContext:
    """Q, then R (one tower more), then P, each scanning down from
    2^mod_size past the primes already taken. The context lives on
    `device`; None means the current CUDA device, and without one this
    raises (pass device="cpu" to run on the CPU)."""
    device = _build.resolve_device(device)
    n, t = params.ring_dim, params.plaintext_modulus
    if (t - 1) % (2 * n):
        raise ValueError(f"t = {t} must be 1 mod 2n for packed slots")
    qs = tuple(nbtheory.generate_prime_chain(params.num_towers,
                                             params.mod_size, n))
    rs = tuple(nbtheory.generate_prime_chain(params.num_towers + 1,
                                             params.mod_size, n, list(qs)))
    alpha = -(-params.num_towers // params.dnum)
    ps = tuple(nbtheory.generate_prime_chain(alpha, params.mod_size, n,
                                             list(qs) + list(rs)))
    log_qp = sum(q.bit_length() for q in qs) + sum(p.bit_length() for p in ps)
    security.validate(n, log_qp, params.security_level)
    return BFVContext(params, qs, rs, ps, device)


@dataclasses.dataclass(frozen=True)
class Ciphertext:
    polys: Tuple[RnsPoly, ...]
    # the reference's noise scale degree: drives HPSPOVERQLEVELED's drop
    noise_deg: int = 1

    @property
    def basis(self) -> RnsBasis:
        return self.polys[0].basis


def _coeff_poly(ctx: BFVContext, coeffs) -> RnsPoly:
    """Signed integer coefficients -> EVAL poly over Q."""
    basis = ctx.basis()
    rows = sampling.signed_to_rns_rows(coeffs, basis.moduli)
    return dcrt.to_eval(dcrt.from_int_rows(basis, rows, Format.COEFF,
                                           ctx.device))


def _error_poly(ctx: BFVContext, rng: np.random.Generator) -> RnsPoly:
    return _coeff_poly(ctx, sampling.gaussian_coeffs(ctx.n, rng,
                                                     ctx.params.sigma))


def keygen(ctx: BFVContext, rng: np.random.Generator
           ) -> Tuple[PublicKey, SecretKey]:
    """Secret, then `a`, then the error."""
    sk = SecretKey(sampling.ternary_coeffs(ctx.n, rng))
    basis = ctx.basis()
    s = sk.poly(basis, ctx.device)
    a = dcrt.from_int_rows(basis, sampling.uniform_rns_rows(
        ctx.n, basis.moduli, rng), Format.EVAL, ctx.device)
    e = _error_poly(ctx, rng)
    return PublicKey(dcrt.sub(e, dcrt.mul(a, s)), a), sk


def relin_keygen(ctx: BFVContext, sk: SecretKey,
                 rng: np.random.Generator) -> keyswitch.KSKey:
    s = sk.poly(ctx.full_qp_basis, ctx.device)
    return keyswitch.keygen(ctx.ks_params, s, dcrt.mul(s, s), rng,
                            ctx.params.sigma)


def rot_keygen(ctx: BFVContext, sk: SecretKey, galois_elts: Sequence[int],
               rng: np.random.Generator) -> Dict[int, keyswitch.KSKey]:
    """Keys for sigma_k(s) -> s, one after the other in the order of
    `galois_elts`."""
    s = sk.poly(ctx.full_qp_basis, ctx.device)
    return {k: keyswitch.keygen(ctx.ks_params, s, dcrt.automorphism(s, k),
                                rng, ctx.params.sigma)
            for k in galois_elts}


# ---------------------------------------------------------------------------
# Encode / encrypt / decrypt
# ---------------------------------------------------------------------------


def _delta_scaled(ctx: BFVContext, coeffs) -> RnsPoly:
    return dcrt.mul_tower_const(_coeff_poly(ctx, coeffs), ctx.delta_rows)


def encode(ctx: BFVContext, values: Sequence[int]) -> RnsPoly:
    """Packed slots -> Delta-scaled EVAL plaintext poly over Q."""
    return _delta_scaled(ctx, encoding.packed_encode(values, ctx.n, ctx.t))


def encode_coef(ctx: BFVContext, values: Sequence[int]) -> RnsPoly:
    """Coefficient-packed plaintext (reference: CoefPackedEncoding): the
    integers as Delta-scaled coefficients, no slot NTT."""
    return _delta_scaled(ctx, encoding.coef_encode(values, ctx.n, ctx.t))


def encode_string(ctx: BFVContext, text: str) -> RnsPoly:
    """String plaintext (reference: StringEncoding); needs t >= 256."""
    if ctx.t < 256:
        raise ValueError("string encoding needs plaintext modulus >= 256")
    return _delta_scaled(ctx, encoding.string_encode(text, ctx.n))


def encrypt_poly(ctx: BFVContext, pk: PublicKey, mpoly: RnsPoly,
                 rng: np.random.Generator) -> Ciphertext:
    """Encrypt an encoded EVAL plaintext: draws v, then e0, then e1."""
    v = _coeff_poly(ctx, sampling.ternary_coeffs(ctx.n, rng))
    e0 = _error_poly(ctx, rng)
    e1 = _error_poly(ctx, rng)
    c0 = dcrt.add(dcrt.mul_add(pk.b, v, e0), mpoly)
    c1 = dcrt.mul_add(pk.a, v, e1)
    return Ciphertext((c0, c1))


def encrypt(ctx: BFVContext, pk: PublicKey, values: Sequence[int],
            rng: np.random.Generator) -> Ciphertext:
    return encrypt_poly(ctx, pk, encode(ctx, values), rng)


def phase_coeffs(ctx: BFVContext, phase: RnsPoly) -> list:
    """Plaintext coefficients round(t * phase / Q_l) mod t of an EVAL phase
    over its own basis (a compressed ciphertext's phase has fewer towers);
    the JAX package's ``_decrypt_scale(t, moduli)``. Shared by decryption
    and the multiparty fusion of partial decryptions."""
    coeff = dcrt.to_coeff(phase)
    moduli = phase.basis.moduli
    scaled = rns.scale_and_round(coeff.data, moduli, (ctx.t,), ctx.t, moduli)
    return scaled[0].cpu().tolist()


def _decrypt_coeffs(ctx: BFVContext, sk: SecretKey, ct: Ciphertext) -> list:
    """Plaintext coefficients round(t * (c0 + c1 s + ...) / Q_l) mod t over
    the ciphertext's basis."""
    s = sk.poly(ct.basis, ctx.device)
    acc, s_pow = ct.polys[0], s
    for c in ct.polys[1:]:
        acc = dcrt.mul_add(c, s_pow, acc)
        s_pow = dcrt.mul(s_pow, s)
    return phase_coeffs(ctx, acc)


def decrypt(ctx: BFVContext, sk: SecretKey, ct: Ciphertext,
            num_slots: int | None = None) -> list:
    slots = encoding.packed_decode(_decrypt_coeffs(ctx, sk, ct), ctx.n,
                                   ctx.t)
    return slots[:num_slots] if num_slots else slots


def decrypt_coef(ctx: BFVContext, sk: SecretKey, ct: Ciphertext,
                 length: int | None = None) -> list:
    return encoding.coef_decode(_decrypt_coeffs(ctx, sk, ct), ctx.n, ctx.t,
                                length)


def decrypt_string(ctx: BFVContext, sk: SecretKey, ct: Ciphertext) -> str:
    return encoding.string_decode(_decrypt_coeffs(ctx, sk, ct))


def _stack(ct: Ciphertext) -> torch.Tensor:
    return torch.stack([p.data for p in ct.polys])


def _wrap(data: torch.Tensor, basis: RnsBasis, noise_deg: int) -> Ciphertext:
    return Ciphertext(tuple(RnsPoly(d, basis, Format.EVAL) for d in data),
                      noise_deg=noise_deg)


def compress(ctx: BFVContext, ct: Ciphertext, towers_left: int = 1
             ) -> Ciphertext:
    """Shrink the ciphertext modulus before transmission or decryption:
    repeated DropLastElementAndScale (``rns.rescale_eval``) over both
    polynomials at once; Delta becomes Q_l/t."""
    assert len(ct.polys) == 2, "relinearize before compressing"
    data, basis = _stack(ct), ct.basis
    while basis.L > towers_left:
        data = rns.rescale_eval(data, basis.moduli)
        basis = basis.drop_last()
    return _wrap(data, basis, ct.noise_deg)


def eval_add(ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
    assert ct1.basis == ct2.basis
    return Ciphertext(tuple(dcrt.add(a, b)
                            for a, b in zip(ct1.polys, ct2.polys)),
                      noise_deg=max(ct1.noise_deg, ct2.noise_deg))


def eval_sub(ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
    assert ct1.basis == ct2.basis
    return Ciphertext(tuple(dcrt.sub(a, b)
                            for a, b in zip(ct1.polys, ct2.polys)),
                      noise_deg=max(ct1.noise_deg, ct2.noise_deg))


# ---------------------------------------------------------------------------
# Multiplication: the tensor over an extended basis and three pipelines
# ---------------------------------------------------------------------------


def _tensor(l1: torch.Tensor, l2: torch.Tensor, moduli) -> torch.Tensor:
    """[3, S, n]: (a0 b0, a0 b1 + a1 b0, a1 b1) of two lifted ciphertexts
    [2, S, n] over `moduli` (EVAL); the middle term's second product is
    added by the fused_mac_mod kernel."""
    mod = make_mod_consts(moduli, l1.device)
    d1 = elementwise.fused_mac_mod(l1[1], l2[0], mul_mod(l1[0], l2[1], mod),
                                   mod)
    return torch.stack([mul_mod(l1[0], l2[0], mod), d1,
                        mul_mod(l1[1], l2[1], mod)])


def _mult_inputs(ct1: Ciphertext, ct2: Ciphertext) -> torch.Tensor:
    assert len(ct1.polys) == 2 and len(ct2.polys) == 2
    assert ct1.basis == ct2.basis
    return torch.cat([_stack(ct1), _stack(ct2)])           # [4, L, n]


def eval_mult(ctx: BFVContext, ct1: Ciphertext, ct2: Ciphertext
              ) -> Ciphertext:
    """HPS multiplication (reference: BFVrns EvalMultCore ->
    ExpandCRTBasis -> ScaleAndRound).

    The lift to S is approximate (the spurious multiples of Q vanish in the
    t/Q scale-and-round). round(t*Y/Q) of the negacyclic tensor Y is a
    SIGNED value far below R/2, so the R -> Q switch is centered: without
    it every negative coefficient gains +R mod Q."""
    qm, rm = ctx.q_moduli, ctx.r_moduli
    sm = qm + rm
    x = ntt.inverse(_mult_inputs(ct1, ct2), qm)
    lifted = ntt.forward(torch.cat([x, rns.approx_switch_basis(x, qm, rm)],
                                   dim=-2), sm)            # [4, S, n]
    y = ntt.inverse(_tensor(lifted[:2], lifted[2:], sm), sm)
    y_r = rns.scale_and_round(y, sm, rm, ctx.t, qm)
    y_q = rns.exact_switch_basis(y_r, rm, qm, centered=True)
    return _wrap(ntt.forward(y_q, qm), ctx.basis(),
                 max(ct1.noise_deg, ct2.noise_deg) + 1)


# HPSPOVERQ / HPSPOVERQLEVELED (reference: MultiplicationTechnique,
# constants.h:127-128; bfvrns-leveledshe.cpp:193-306; Kim-Polyakov-Zucca
# eprint 2021/204). ct2 is switched Q_l -> R_l with the R/Q scaling folded
# in, so the scale-down after the tensor divides by R_l instead of Q. The
# LEVELED variant first drops towers the noise no longer needs and expands
# back by multiplying with Q/Q_l.


def find_levels_to_drop(ctx: BFVContext, mult_depth: int,
                        key_switch: bool = False) -> int:
    """Noise estimate of how many towers EvalMult can drop at this depth
    (reference: FindLevelsToDrop, bfvrns-leveledshe.cpp:77-166, HYBRID
    branch); the float operations in the JAX package's order."""
    sigma = ctx.params.sigma
    alpha = 36.0
    p = float(ctx.t)
    n = ctx.n
    dcrt_bits = ctx.params.mod_size
    num_part_q = ctx.params.dnum
    k = -(-len(ctx.q_moduli) // num_part_q)   # towers per digit
    b_key = 1.0                                # ternary secrets
    b_err = sigma * math.sqrt(alpha)
    delta = 2.0 * math.sqrt(n)
    v_norm = b_err * (1.0 + 2.0 * delta * b_key)

    def noise_ks():
        return k * (num_part_q * delta * b_err + delta * b_key + 1.0) / 2

    c1 = delta * delta * p * b_key
    c2 = delta * delta * b_key * b_key / 2.0 + noise_ks()

    def logq_bfv():
        if mult_depth > 0:
            return (math.log(4 * p) + (mult_depth - 1) * math.log(c1)
                    + math.log(c1 * v_norm + mult_depth * c2))
        return math.log(p * 4 * v_norm)

    logq = logq_bfv()
    loge = logq / math.log(2) - 2 - math.log2(p)
    log_extra = math.log2(noise_ks()) if key_switch else math.log2(delta)
    levels = math.floor((loge - 2 * mult_depth - 16 - log_extra) / dcrt_bits)
    return max(0, min(levels, len(ctx.q_moduli) - 1))


def mult_povq(ctx: BFVContext, x: torch.Tensor, drop: int) -> torch.Tensor:
    """HPSPOVERQ core at Q_l = q_0..q_{L-1-drop}: EVAL [4, L, n] (ct1's
    polynomials, then ct2's) -> the EVAL tensor [3, L, n] over Q."""
    L = len(ctx.q_moduli)
    ql = ctx.q_moduli[:L - drop]
    rl = ctx.r_moduli[:len(ql) + 1]
    sl = ql + rl
    x = ntt.inverse(x, ctx.q_moduli)
    if drop:
        # round(Q_l/Q * x): the leveled drop (bfvrns-leveledshe.cpp:249)
        x = rns.scale_and_round(x, ctx.q_moduli, ql, _prod(ql), ctx.q_moduli)
    # ct1: approximate mod-up into S_l
    l1 = torch.cat([x[:2], rns.approx_switch_basis(x[:2], ql, rl)], dim=-2)
    # ct2: round(R_l/Q_l * x) over R_l, switched exactly into Q_l
    y_r = rns.scale_and_round(x[2:], ql, rl, _prod(rl), ql)
    l2 = torch.cat([rns.exact_switch_basis(y_r, rl, ql), y_r], dim=-2)
    lifted = ntt.forward(torch.cat([l1, l2]), sl)          # [4, S_l, n]
    y = ntt.inverse(_tensor(lifted[:2], lifted[2:], sl), sl)
    y_ql = dcrt.ntt_forward_data(RnsBasis(ctx.n, ql),
                                 rns.scale_and_round(y, sl, ql, ctx.t, rl))
    if not drop:
        return y_ql
    # times Q/Q_l, which is 0 mod every dropped prime
    ql_basis = RnsBasis(ctx.n, ql)
    qlhat = _prod(ctx.q_moduli) // _prod(ql)
    c, c_pre = dcrt.tower_const(ql_basis, [qlhat % q for q in ql], y.device)
    y_ql = mul_mod_shoup(y_ql, c, c_pre, ql_basis.mod(y.device).q)
    zeros = y_ql.new_zeros(y_ql.shape[:-2] + (drop, ctx.n))
    return torch.cat([y_ql, zeros], dim=-2)


def eval_mult_povq(ctx: BFVContext, ct1: Ciphertext, ct2: Ciphertext,
                   leveled: bool = False) -> Ciphertext:
    """HPSPOVERQ (leveled=False) / HPSPOVERQLEVELED (leveled=True)
    multiplication (reference: bfvrns-leveledshe.cpp:208-306)."""
    deg = max(ct1.noise_deg, ct2.noise_deg)
    drop = find_levels_to_drop(ctx, deg - 1) if leveled else 0
    return _wrap(mult_povq(ctx, _mult_inputs(ct1, ct2), drop), ctx.basis(),
                 deg + 1)


# BEHZ (reference: FastBaseConvqToBskMontgomery / FastRNSFloorq /
# FastBaseConvSK, dcrtpoly-impl.h:2069-2380): exact integer base
# conversions instead of HPS's fixed-point fractions. B reuses R.


@lru_cache(maxsize=None)
def _behz_msk(ctx: BFVContext) -> int:
    """One more NTT-friendly prime m_sk below 2^59, not in Q, R or P."""
    used = set(ctx.q_moduli) | set(ctx.r_moduli) | set(ctx.p_moduli)
    cursor = nbtheory.first_prime(59, 2 * ctx.n)
    while cursor in used:
        cursor = nbtheory.previous_prime(cursor, 2 * ctx.n)
    return cursor


def eval_mult_behz(ctx: BFVContext, ct1: Ciphertext, ct2: Ciphertext
                   ) -> Ciphertext:
    """BEHZ multiplication: exact Montgomery lift Q -> Q+Bsk, the tensor
    there, floor(t*Y/Q) over Bsk, Shenoy-Kumaresan switch back to Q."""
    qm, bm = ctx.q_moduli, ctx.r_moduli
    m_sk = _behz_msk(ctx)
    bsk = bm + (m_sk,)
    full = qm + bsk
    L = len(qm)
    x = ntt.inverse(_mult_inputs(ct1, ct2), qm)
    conv = rns.base_conv_q_to_bsk_montgomery(x, qm, bsk)
    lifted = ntt.forward(torch.cat([x, conv], dim=-2), full)
    y = ntt.inverse(_tensor(lifted[:2], lifted[2:], full), full)
    full_basis = RnsBasis(ctx.n, full)
    tq, tq_pre = dcrt.tower_const(full_basis, [ctx.t % q for q in full],
                                  y.device)
    ty = mul_mod_shoup(y, tq, tq_pre, full_basis.mod(y.device).q)
    fl = rns.rns_floor_q(ty[..., :L, :], ty[..., L:, :], qm, bsk)
    out = ntt.forward(rns.base_conv_sk(fl, bm, m_sk, qm), qm)
    return _wrap(out, ctx.basis(), max(ct1.noise_deg, ct2.noise_deg) + 1)


def relinearize(ct: Ciphertext, evk: keyswitch.KSKey) -> Ciphertext:
    assert len(ct.polys) == 3
    d0, d1 = keyswitch.apply(evk, ct.polys[2])
    return Ciphertext((dcrt.add(ct.polys[0], d0),
                       dcrt.add(ct.polys[1], d1)), noise_deg=ct.noise_deg)


def eval_mult_relin(ctx: BFVContext, ct1: Ciphertext, ct2: Ciphertext,
                    evk: keyswitch.KSKey) -> Ciphertext:
    return relinearize(eval_mult(ctx, ct1, ct2), evk)


# ---------------------------------------------------------------------------
# Automorphisms and plaintext operands
# ---------------------------------------------------------------------------


def eval_automorphism(ct: Ciphertext, k: int,
                      rot_key: keyswitch.KSKey) -> Ciphertext:
    """sigma_k in the hoisted order (decompose, then permute the digit
    stack), as the JAX package does. The result has noise degree 1, as
    there."""
    assert len(ct.polys) == 2
    digits = keyswitch.hoist_decompose(rot_key.params, ct.polys[1])
    c0 = dcrt.automorphism(ct.polys[0], k)
    d0, d1 = keyswitch.hoist_rotate_apply(rot_key, digits, ct.basis, k)
    return Ciphertext((dcrt.add(c0, d0), d1))


def eval_add_plain(ctx: BFVContext, ct: Ciphertext,
                   values: Sequence[int]) -> Ciphertext:
    pt = encode(ctx, values)
    return Ciphertext((dcrt.add(ct.polys[0], pt),) + ct.polys[1:])


def eval_mult_plain(ctx: BFVContext, ct: Ciphertext,
                    values: Sequence[int]) -> Ciphertext:
    """Multiply by an UNSCALED packed plaintext (no Delta factor)."""
    pt = _coeff_poly(ctx, encoding.packed_encode(values, ctx.n, ctx.t))
    return Ciphertext(tuple(dcrt.mul(p, pt) for p in ct.polys))


def eval_rotate(ct: Ciphertext, r: int, rot_key: keyswitch.KSKey
                ) -> Ciphertext:
    """Rotate both packed rows left by r (reference: EvalAtIndex)."""
    return eval_automorphism(ct, rotation_galois(ct.basis.n, r), rot_key)


def eval_flip_rows(ct: Ciphertext, key: keyswitch.KSKey) -> Ciphertext:
    """Swap the two packed rows (sigma_{2n-1})."""
    return eval_automorphism(ct, 2 * ct.basis.n - 1, key)


def eval_sum(ct: Ciphertext, rot_keys) -> Ciphertext:
    """Every slot becomes the sum of all n slots."""
    n = ct.basis.n
    out = ct
    for i in range((n // 2).bit_length() - 1):
        k = rotation_galois(n, 1 << i)
        out = eval_add(out, eval_automorphism(out, k, rot_keys[k]))
    flip = 2 * n - 1
    return eval_add(out, eval_automorphism(out, flip, rot_keys[flip]))


def eval_inner_product(ctx: BFVContext, ct1: Ciphertext, ct2: Ciphertext,
                       evk: keyswitch.KSKey, rot_keys) -> Ciphertext:
    """<ct1, ct2> over all slots, replicated in every slot."""
    return eval_sum(eval_mult_relin(ctx, ct1, ct2, evk), rot_keys)
