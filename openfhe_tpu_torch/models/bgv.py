"""BGV over RNS towers.

Counterpart of ``openfhe_tpu/models/bgv.py``, the whole module: exact
arithmetic on packed Z_t slots, error scaled by the plaintext modulus t, and
a modulus switch that keeps the plaintext. Every ciphertext modulus is
chosen ≡ 1 (mod 2n·t), so q_l ≡ 1 (mod t) and ModReduce's division by q_l
leaves the slot values as they are, and all moduli stay NTT-friendly.

Keys, key switching and automorphisms are CKKS's (``ckks.PublicKey``,
``ckks.SecretKey``, ``keyswitch`` with the t-aware mod-down). The context
carries its torch device; randomness is the caller's numpy Generator, drawn
in the JAX package's order, so every key and ciphertext is bit-equal to its
own for the same seed.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .. import _build, dcrt, encoding, keyswitch
from ..dcrt import Format, RnsBasis, RnsPoly
from ..ops import ntt
from ..ops.modular import (add_mod, make_mod_consts, mul_mod_shoup,
                           shoup_consts, sub_mod, switch_modulus)
from ..utils import nbtheory, sampling, security
from .ckks import PublicKey, SecretKey, crt_interpolate_centered


@dataclasses.dataclass(frozen=True)
class BGVParams:
    ring_dim: int = 1 << 12
    mult_depth: int = 2
    plaintext_modulus: int = 65537
    mod_size: int = 60
    dnum: int = 3
    sigma: float = 3.19
    security_level: str = "HEStd_NotSet"

    @property
    def num_towers(self) -> int:
        return self.mult_depth + 1


@dataclasses.dataclass(frozen=True)
class BGVContext:
    params: BGVParams
    q_moduli: Tuple[int, ...]
    p_moduli: Tuple[int, ...]
    device: torch.device

    @property
    def n(self) -> int:
        return self.params.ring_dim

    @property
    def t(self) -> int:
        return self.params.plaintext_modulus

    @property
    def ks_params(self) -> keyswitch.KSParams:
        alpha = -(-len(self.q_moduli) // self.params.dnum)
        return keyswitch.KSParams(self.n, self.q_moduli, self.p_moduli, alpha,
                                  plaintext_correction=self.t)

    def basis(self, towers: int | None = None) -> RnsBasis:
        towers = len(self.q_moduli) if towers is None else towers
        return RnsBasis(self.n, self.q_moduli[:towers])

    @property
    def full_qp_basis(self) -> RnsBasis:
        return RnsBasis(self.n, self.q_moduli + self.p_moduli)


def gen_context(params: BGVParams, device=None) -> BGVContext:
    """Q and P primes scanning down from 2^mod_size, each ≡ 1 mod 2n·t (the
    special primes sit below the Q primes). The context lives on `device`;
    None means the current CUDA device, and without one this raises (pass
    device="cpu" to run on the CPU)."""
    device = _build.resolve_device(device)
    n, t = params.ring_dim, params.plaintext_modulus
    if t % 2 != 1 or not nbtheory.is_prime(t):
        raise ValueError(f"plaintext modulus {t} must be an odd prime")
    if (t - 1) % (2 * n):
        raise ValueError(f"t = {t} must be 1 mod 2n for packed slots")
    m = 2 * n * t
    qs = []
    cursor = 1 << params.mod_size
    while len(qs) < params.num_towers:
        cursor = nbtheory.prev_ntt_prime_below(cursor, m)
        qs.append(cursor)
    alpha = -(-params.num_towers // params.dnum)
    ps = []
    while len(ps) < alpha:
        cursor = nbtheory.prev_ntt_prime_below(cursor, m)
        ps.append(cursor)
    log_qp = sum(q.bit_length() for q in qs) + sum(p.bit_length() for p in ps)
    security.validate(n, log_qp, params.security_level)
    return BGVContext(params, tuple(qs), tuple(ps), device)


@dataclasses.dataclass(frozen=True)
class Ciphertext:
    polys: Tuple[RnsPoly, ...]

    @property
    def basis(self) -> RnsBasis:
        return self.polys[0].basis

    @property
    def towers(self) -> int:
        return self.basis.L


def _coeff_poly(ctx: BGVContext, basis: RnsBasis, coeffs) -> RnsPoly:
    """Signed integer coefficients -> EVAL poly over `basis`."""
    rows = sampling.signed_to_rns_rows(coeffs, basis.moduli)
    return dcrt.to_eval(dcrt.from_int_rows(basis, rows, Format.COEFF,
                                           ctx.device))


def _sample_scaled_error(ctx: BGVContext, basis: RnsBasis,
                         rng: np.random.Generator) -> RnsPoly:
    return _coeff_poly(ctx, basis, sampling.gaussian_coeffs(
        ctx.n, rng, ctx.params.sigma) * ctx.t)


def keygen(ctx: BGVContext, rng: np.random.Generator
           ) -> Tuple[PublicKey, SecretKey]:
    """pk = (-a s + t e, a): secret, then `a`, then the error."""
    sk = SecretKey(sampling.ternary_coeffs(ctx.n, rng))
    basis = ctx.basis()
    s = sk.poly(basis, ctx.device)
    a = dcrt.from_int_rows(basis, sampling.uniform_rns_rows(
        ctx.n, basis.moduli, rng), Format.EVAL, ctx.device)
    e = _sample_scaled_error(ctx, basis, rng)
    return PublicKey(dcrt.sub(e, dcrt.mul(a, s)), a), sk


def relin_keygen(ctx: BGVContext, sk: SecretKey,
                 rng: np.random.Generator) -> keyswitch.KSKey:
    s = sk.poly(ctx.full_qp_basis, ctx.device)
    return keyswitch.keygen(ctx.ks_params, s, dcrt.mul(s, s), rng,
                            ctx.params.sigma, error_scale=ctx.t)


def rot_keygen(ctx: BGVContext, sk: SecretKey, galois_elts: Sequence[int],
               rng: np.random.Generator) -> Dict[int, keyswitch.KSKey]:
    """Keys for sigma_k(s) -> s keyed by Galois element k, made one after
    the other in the order of `galois_elts` (the JAX package's draws)."""
    s = sk.poly(ctx.full_qp_basis, ctx.device)
    return {k: keyswitch.keygen(ctx.ks_params, s, dcrt.automorphism(s, k),
                                rng, ctx.params.sigma, error_scale=ctx.t)
            for k in galois_elts}


# ---------------------------------------------------------------------------
# Encrypt / decrypt
# ---------------------------------------------------------------------------


def encode(ctx: BGVContext, values: Sequence[int],
           towers: int | None = None) -> RnsPoly:
    return _coeff_poly(ctx, ctx.basis(towers),
                       encoding.packed_encode(values, ctx.n, ctx.t))


def encrypt(ctx: BGVContext, pk: PublicKey, values: Sequence[int],
            rng: np.random.Generator) -> Ciphertext:
    """Draws v (ternary), then e0, then e1."""
    basis = ctx.basis()
    mpoly = encode(ctx, values)
    v = _coeff_poly(ctx, basis, sampling.ternary_coeffs(ctx.n, rng))
    e0 = _sample_scaled_error(ctx, basis, rng)
    e1 = _sample_scaled_error(ctx, basis, rng)
    c0 = dcrt.add(dcrt.mul_add(pk.b, v, e0), mpoly)
    c1 = dcrt.mul_add(pk.a, v, e1)
    return Ciphertext((c0, c1))


def decrypt_poly(ctx: BGVContext, sk: SecretKey, ct: Ciphertext) -> RnsPoly:
    """sum_i c_i s^i over the ciphertext's basis (EVAL)."""
    s = sk.poly(ct.basis, ctx.device)
    acc, s_pow = ct.polys[0], s
    for c in ct.polys[1:]:
        acc = dcrt.mul_add(c, s_pow, acc)
        s_pow = dcrt.mul(s_pow, s)
    return acc


def decrypt(ctx: BGVContext, sk: SecretKey, ct: Ciphertext,
            num_slots: int | None = None) -> list:
    """Slots of the centered phase mod t (host CRT interpolation)."""
    rows = dcrt.to_int_rows(dcrt.to_coeff(decrypt_poly(ctx, sk, ct)))
    centered = crt_interpolate_centered(rows, ct.basis.moduli)
    slots = encoding.packed_decode([c % ctx.t for c in centered], ctx.n,
                                   ctx.t)
    return slots[:num_slots] if num_slots else slots


# ---------------------------------------------------------------------------
# Homomorphic ops
# ---------------------------------------------------------------------------


def _combine(ct1: Ciphertext, ct2: Ciphertext, op, lone) -> Ciphertext:
    assert ct1.basis == ct2.basis
    ps = []
    for i in range(max(len(ct1.polys), len(ct2.polys))):
        if i < len(ct1.polys) and i < len(ct2.polys):
            ps.append(op(ct1.polys[i], ct2.polys[i]))
        elif i < len(ct1.polys):
            ps.append(ct1.polys[i])
        else:
            ps.append(lone(ct2.polys[i]))
    return Ciphertext(tuple(ps))


def eval_add(ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
    return _combine(ct1, ct2, dcrt.add, lambda p: p)


def eval_sub(ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
    return _combine(ct1, ct2, dcrt.sub, dcrt.neg)


def eval_mult(ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
    """Tensor product without relinearization (degree grows)."""
    assert ct1.basis == ct2.basis
    d1, d2 = len(ct1.polys), len(ct2.polys)
    out = [None] * (d1 + d2 - 1)
    for i in range(d1):
        for j in range(d2):
            a, b = ct1.polys[i], ct2.polys[j]
            out[i + j] = dcrt.mul(a, b) if out[i + j] is None else \
                dcrt.mul_add(a, b, out[i + j])
    return Ciphertext(tuple(out))


def relinearize(ct: Ciphertext, evk: keyswitch.KSKey) -> Ciphertext:
    assert len(ct.polys) == 3
    d0, d1 = keyswitch.apply(evk, ct.polys[2])
    return Ciphertext((dcrt.add(ct.polys[0], d0),
                       dcrt.add(ct.polys[1], d1)))


def eval_mult_relin(ct1: Ciphertext, ct2: Ciphertext,
                    evk: keyswitch.KSKey) -> Ciphertext:
    return relinearize(eval_mult(ct1, ct2), evk)


def compress(ctx: BGVContext, ct: Ciphertext, towers_left: int = 1
             ) -> Ciphertext:
    """Shrink the ciphertext modulus before transmission or decryption:
    ModReduce tower by tower down to `towers_left`."""
    while ct.basis.L > towers_left:
        ct = mod_reduce(ctx, ct)
    return ct


@lru_cache(maxsize=None)
def _bgv_rescale_tables(t: int, moduli: Tuple[int, ...], device: str):
    """Constants of one level's BGV rescale: -q_last^{-1} mod t, and
    [q_last]_{q_i} and [q_last^{-1}]_{q_i} for the remaining towers (Shoup
    constants)."""
    *rest, q_last = moduli
    neg_qinv_t = shoup_consts([(-pow(q_last % t, -1, t)) % t], (t,), device)
    ql = shoup_consts([q_last % q for q in rest], rest, device)
    inv = shoup_consts([pow(q_last % q, -1, q) for q in rest], rest, device)
    return neg_qinv_t, ql, inv


def mod_reduce(ctx: BGVContext, ct: Ciphertext) -> Ciphertext:
    """BGV modulus switch: divide by q_last keeping the plaintext mod t.

    delta = centered(x_last) + q_last * centered(w), w ≡ -x_last/q_last
    (mod t); y_i = (x_i - delta) / q_last mod q_i. The polynomials are
    stacked: one single-tower inverse NTT and one forward NTT over the
    remaining towers for the whole ciphertext."""
    moduli = ct.basis.moduli
    *rest, q_last = moduli
    dev = ctx.device
    (nq, nq_pre), (ql, ql_pre), (inv, inv_pre) = _bgv_rescale_tables(
        ctx.t, moduli, str(dev))
    t_mod = make_mod_consts((ctx.t,), dev)
    old_mod = make_mod_consts((q_last,), dev)
    new_mod = make_mod_consts(rest, dev)
    x = torch.stack([p.data for p in ct.polys])            # [k, L, n]
    xl = ntt.inverse(x[:, -1:], (q_last,))                 # [k, 1, n]
    s = switch_modulus(xl, old_mod, new_mod)               # [k, L-1, n]
    w = mul_mod_shoup(switch_modulus(xl, old_mod, t_mod), nq, nq_pre,
                      t_mod.q)                             # [k, 1, n]
    w_q = switch_modulus(w, t_mod, new_mod)
    delta = add_mod(s, mul_mod_shoup(w_q, ql, ql_pre, new_mod.q), new_mod.q)
    diff = sub_mod(x[:, :-1], ntt.forward(delta, rest), new_mod.q)
    out = mul_mod_shoup(diff, inv, inv_pre, new_mod.q)
    basis = ct.basis.drop_last()
    return Ciphertext(tuple(RnsPoly(d, basis, Format.EVAL) for d in out))


def eval_automorphism(ct: Ciphertext, k: int,
                      rot_key: keyswitch.KSKey) -> Ciphertext:
    """sigma_k and a key switch back to s, in the hoisted order: decompose
    c1, then permute the digit stack (the JAX package's order, which fixes
    the bits)."""
    assert len(ct.polys) == 2
    digits = keyswitch.hoist_decompose(rot_key.params, ct.polys[1])
    c0 = dcrt.automorphism(ct.polys[0], k)
    d0, d1 = keyswitch.hoist_rotate_apply(rot_key, digits, ct.basis, k)
    return Ciphertext((dcrt.add(c0, d0), d1))


def eval_add_plain(ctx: BGVContext, ct: Ciphertext,
                   values: Sequence[int]) -> Ciphertext:
    pt = encode(ctx, values, towers=ct.towers)
    return Ciphertext((dcrt.add(ct.polys[0], pt),) + ct.polys[1:])


def eval_mult_plain(ctx: BGVContext, ct: Ciphertext,
                    values: Sequence[int]) -> Ciphertext:
    pt = encode(ctx, values, towers=ct.towers)
    return Ciphertext(tuple(dcrt.mul(p, pt) for p in ct.polys))


def rotation_galois(n: int, r: int) -> int:
    """Galois element of a packed-slot row rotation by r: 5^r mod 2n."""
    return pow(5, r % (n // 2), 2 * n)


def eval_rotate(ct: Ciphertext, r: int, rot_key: keyswitch.KSKey
                ) -> Ciphertext:
    """Rotate both packed rows left by r (reference: EvalAtIndex)."""
    return eval_automorphism(ct, rotation_galois(ct.basis.n, r), rot_key)


def eval_flip_rows(ct: Ciphertext, key: keyswitch.KSKey) -> Ciphertext:
    """Swap the two packed rows (sigma_{2n-1})."""
    return eval_automorphism(ct, 2 * ct.basis.n - 1, key)


def sum_galois_indices(n: int) -> list:
    """Galois elements of eval_sum's rotation tree and the row flip."""
    return [rotation_galois(n, 1 << i)
            for i in range((n // 2).bit_length() - 1)] + [2 * n - 1]


def eval_sum(ct: Ciphertext, rot_keys) -> Ciphertext:
    """Every slot becomes the sum of all n slots: log2(n/2) row rotations
    and one row flip."""
    n = ct.basis.n
    out = ct
    for i in range((n // 2).bit_length() - 1):
        k = rotation_galois(n, 1 << i)
        out = eval_add(out, eval_automorphism(out, k, rot_keys[k]))
    flip = 2 * n - 1
    return eval_add(out, eval_automorphism(out, flip, rot_keys[flip]))


def eval_inner_product(ctx: BGVContext, ct1: Ciphertext, ct2: Ciphertext,
                       evk: keyswitch.KSKey, rot_keys) -> Ciphertext:
    """<ct1, ct2> over all slots, replicated in every slot."""
    return eval_sum(eval_mult_relin(ct1, ct2, evk), rot_keys)
