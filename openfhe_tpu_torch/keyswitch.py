"""Hybrid (RNS-digit) key switching: relinearization and rotation.

Counterpart of ``openfhe_tpu/keyswitch.py``, hybrid and BV. The chain Q = q_0..q_{L-1} is split into
``dnum`` digits of ``alpha`` towers. A key for target secret s' holds, per
digit j, b_j = -a_j s + e_j + [P * QHat_j * (QHat_j^{-1} mod D_j)] * s' over
Q*P, so one key made at full level switches at every level.

Applying it to c over Q_l (EVAL): one inverse NTT, per digit a basis switch
into the complement and one batched forward NTT over Q_l*P
(``hoist_decompose``), the digit inner product with the key (the
``ks_inner_product`` kernel), then one mod-down by P over both outputs
(``hoist_inner_product``). These four NTTs go through
``dcrt.ntt_inverse_data``/``ntt_forward_data``, so a distributed NTT set
with ``dcrt.set_distributed_ntt`` takes them too.

BV switching (``bv_keygen``/``bv_apply``) needs no special primes: c is cut
per tower into base-2^r digits, and the digits' inner product with the key
runs on the same ``ks_inner_product`` kernel, at most ``MAX_DIGITS`` digits
a launch.

Randomness comes from the caller's numpy Generator in the JAX package's
order, so keys are bit-equal to its keys for the same seed.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from . import dcrt
from .dcrt import Format, RnsBasis, RnsPoly
from .ops import automorph, elementwise, ntt, rns
from .ops.modular import (add_mod, make_mod_consts, mul_mod, mul_mod_shoup,
                          shoup_consts, sub_mod)
from .utils import sampling


@dataclasses.dataclass(frozen=True)
class KSParams:
    """Static hybrid-keyswitch geometry (hashable)."""

    n: int
    q_moduli: Tuple[int, ...]
    p_moduli: Tuple[int, ...]
    alpha: int  # towers per digit
    plaintext_correction: int = 1  # t for BGV (mod-down lift = 0 mod t)

    @property
    def dnum(self) -> int:
        return -(-len(self.q_moduli) // self.alpha)

    def digit_range(self, j: int, level_towers: int) -> Tuple[int, int]:
        """Active tower range [start, end) of digit j at a level."""
        return j * self.alpha, min((j + 1) * self.alpha, level_towers)

    def num_digits(self, level_towers: int) -> int:
        return -(-level_towers // self.alpha)

    @property
    def P(self) -> int:
        prod = 1
        for p in self.p_moduli:
            prod *= p
        return prod


@dataclasses.dataclass(frozen=True, eq=False)
class KSKey:
    """Switching key: stacked digit pairs over Q*P, each [dnum, L+K, n]."""

    b: torch.Tensor
    a: torch.Tensor
    params: KSParams


@lru_cache(maxsize=None)
def _digit_factor_table(params: KSParams, device: str):
    """[dnum, L+K, 1] constants [P*QHat_j*(QHat_j^{-1} mod D_j)]_m and their
    Shoup precons."""
    qs, ps = params.q_moduli, params.p_moduli
    Q = 1
    for q in qs:
        Q *= q
    all_moduli = qs + ps
    facs, pres = [], []
    for j in range(params.dnum):
        s, e = params.digit_range(j, len(qs))
        D = 1
        for q in qs[s:e]:
            D *= q
        qhat = Q // D
        g = params.P * qhat * pow(qhat % D, -1, D)
        fac, pre = shoup_consts([g % m for m in all_moduli], all_moduli,
                                device)
        facs.append(fac)
        pres.append(pre)
    return torch.stack(facs), torch.stack(pres)


def ext_basis(params: KSParams, level_towers: int) -> RnsBasis:
    return RnsBasis(params.n, params.q_moduli[:level_towers] + params.p_moduli)


def full_basis(params: KSParams) -> RnsBasis:
    return ext_basis(params, len(params.q_moduli))


def _error_rows(n, moduli, rng, sigma, error_scale, count) -> np.ndarray:
    return np.stack([sampling.signed_to_rns_rows(
        sampling.gaussian_coeffs(n, rng, sigma) * error_scale, moduli)
        for _ in range(count)])


def _digit_b(basis: RnsBasis, a, e_rows, s_enc, s_target, factors, device):
    """b = f_j * s_enc + e - a * s_target over [..., digits, L, n]; factors:
    the [digits, L, 1] f_j and their Shoup precons."""
    mod = basis.mod(device)
    fac, fac_pre = factors
    e = ntt.forward(dcrt.rows_tensor(e_rows, device), basis.moduli)
    gterm = mul_mod_shoup(s_enc, fac, fac_pre, mod.q)
    return sub_mod(add_mod(gterm, e, mod.q), mul_mod(a, s_target, mod), mod.q)


def keygen(params: KSParams, s_from: RnsPoly, s_to: RnsPoly,
           rng: np.random.Generator, sigma: float = 3.19,
           error_scale: int = 1) -> KSKey:
    """Key switching s_to -> s_from; both secrets EVAL over the full Q*P.
    Draws every digit's `a`, then every digit's error."""
    basis = full_basis(params)
    a = np.stack([sampling.uniform_rns_rows(params.n, basis.moduli, rng)
                  for _ in range(params.dnum)])
    return keygen_with_a(params, s_from, s_to,
                         dcrt.rows_tensor(a, s_from.device), rng, sigma,
                         error_scale)


def keygen_with_a(params: KSParams, s_from: RnsPoly, s_to: RnsPoly,
                  a: torch.Tensor, rng: np.random.Generator,
                  sigma: float = 3.19, error_scale: int = 1) -> KSKey:
    """keygen against caller-provided per-digit `a` [dnum, L+K, n] (EVAL)."""
    basis = full_basis(params)
    assert s_from.basis == basis and s_to.basis == basis
    e_rows = _error_rows(params.n, basis.moduli, rng, sigma, error_scale,
                         params.dnum)
    b = _digit_b(basis, a, e_rows, s_to.data, s_from.data,
                 _digit_factor_table(params, str(s_from.device)),
                 s_from.device)
    return KSKey(b, a, params)


def keygen_batch(params: KSParams, s_from: RnsPoly, s_enc_list,
                 rng: np.random.Generator, sigma: float = 3.19,
                 error_scale: int = 1) -> list:
    """Keys for many encrypted secrets sharing one target secret s_from.
    Draws every `a` of every key, then every error."""
    basis = full_basis(params)
    assert s_from.basis == basis
    K, n, dnum, dev = len(s_enc_list), params.n, params.dnum, s_from.device
    a_np = np.stack([np.stack([
        sampling.uniform_rns_rows(n, basis.moduli, rng)
        for _ in range(dnum)]) for _ in range(K)])          # [K, dnum, L, n]
    e_np = np.stack([_error_rows(n, basis.moduli, rng, sigma, error_scale,
                                 dnum) for _ in range(K)])
    a = dcrt.rows_tensor(a_np, dev)
    s_enc = torch.stack([s.data for s in s_enc_list])[:, None]
    b = _digit_b(basis, a, e_np, s_enc, s_from.data,
                 _digit_factor_table(params, str(dev)), dev)
    return [KSKey(b[k], a[k], params) for k in range(K)]


# ---------------------------------------------------------------------------
# Joint keys (openfhe_tpu/keyswitch.py:234-278): the multiparty protocol's
# sums and share products of switching keys.
# ---------------------------------------------------------------------------


def key_a_datas(key: KSKey) -> torch.Tensor:
    """The per-digit `a` [dnum, L+K, n], for reuse by the next party (the
    JAX package returns it as a list of digits)."""
    return key.a


def add_keys_b(k1: KSKey, k2: KSKey) -> KSKey:
    """Sum the b components of two keys sharing the same a
    (reference: MultiAddEvalKeys)."""
    q = full_basis(k1.params).mod(k1.b.device).q
    return KSKey(add_mod(k1.b, k2.b, q), k1.a, k1.params)


def add_keys_full(k1: KSKey, k2: KSKey) -> KSKey:
    """Sum both components (reference: MultiAddEvalMultKeys)."""
    q = full_basis(k1.params).mod(k1.b.device).q
    return KSKey(add_mod(k1.b, k2.b, q), add_mod(k1.a, k2.a, q), k1.params)


def scale_key_by_share(key: KSKey, s_share: RnsPoly,
                       rng: np.random.Generator, sigma: float = 3.19,
                       error_scale: int = 1) -> KSKey:
    """(s_i * b_j + e0, s_i * a_j + e1) per digit: one party's contribution
    to the joint relinearization key (reference: MultiMultEvalKey). Draws
    every digit's error for b, then every digit's error for a; both halves
    then go through one forward NTT and one fused_mac_mod launch."""
    params = key.params
    basis = full_basis(params)
    assert s_share.basis == basis and s_share.fmt == Format.EVAL
    e_rows = np.concatenate([
        _error_rows(params.n, basis.moduli, rng, sigma, error_scale,
                    params.dnum) for _ in range(2)])    # [2*dnum, L+K, n]
    dev = s_share.device
    e = ntt.forward(dcrt.rows_tensor(e_rows, dev), basis.moduli)
    x = torch.cat([key.b, key.a])
    rows = x.shape[0] * basis.L
    out = elementwise.fused_mac_mod(
        x.reshape(rows, params.n),
        s_share.data.expand(x.shape[0], -1, -1).reshape(rows, params.n),
        e.reshape(rows, params.n),
        make_mod_consts(basis.moduli * x.shape[0], dev)).reshape(x.shape)
    return KSKey(out[:params.dnum], out[params.dnum:], params)


def hoist_decompose(params: KSParams, c: RnsPoly) -> torch.Tensor:
    """Digit decomposition and mod-up of EVAL c over Q_l: the digit stack
    [ndig, l+K, n] in EVAL form over Q_l*P, shareable across rotations."""
    assert c.fmt == Format.EVAL
    lvl = c.basis.L
    q_act = params.q_moduli[:lvl]
    assert c.basis.moduli == q_act, "ciphertext basis must be a Q prefix"
    c_coeff = dcrt.ntt_inverse_data(c.basis, c.data)       # [lvl, n]
    rows = []
    for j in range(params.num_digits(lvl)):
        s, e = params.digit_range(j, lvl)
        part = c_coeff[s:e]
        conv = rns.approx_switch_basis(
            part, q_act[s:e], q_act[:s] + q_act[e:] + params.p_moduli)
        # rows in basis order [q_0..q_{lvl-1}, P]
        rows.append(torch.cat([conv[:s], part, conv[s:]], dim=0))
    # one batched [ndig, lvl+K, n] forward NTT
    return dcrt.ntt_forward_data(ext_basis(params, lvl), torch.stack(rows))


def hoist_inner_product(key: KSKey, digits: torch.Tensor, basis: RnsBasis
                        ) -> Tuple[RnsPoly, RnsPoly]:
    """Inner product of a (possibly permuted) digit stack with the key, then
    mod-down by P; `basis` is the ciphertext's Q_l basis."""
    params = key.params
    lvl = basis.L
    q_act = params.q_moduli[:lvl]
    eb = ext_basis(params, lvl)
    Lfull = len(params.q_moduli)
    # active key rows: q_0..q_{lvl-1} then the P block
    rows = list(range(lvl)) + list(range(Lfull, Lfull + len(params.p_moduli)))
    acc = elementwise.ks_inner_product(digits, key.b, key.a, rows,
                                       eb.mod(digits.device))
    # both halves as one [2, l+K, n] batch: one inverse NTT, one basis
    # conversion and one forward NTT
    cc = dcrt.ntt_inverse_data(eb, acc)
    down = rns.approx_mod_down(cc[:, :lvl], cc[:, lvl:], q_act,
                               params.p_moduli, params.plaintext_correction)
    d = dcrt.ntt_forward_data(basis, down)
    return (RnsPoly(d[0], basis, Format.EVAL),
            RnsPoly(d[1], basis, Format.EVAL))


def apply(key: KSKey, c: RnsPoly) -> Tuple[RnsPoly, RnsPoly]:
    """Key-switch EVAL c over Q_l: (d0, d1) over Q_l with
    d0 + d1*s ~ c*s_to."""
    return hoist_inner_product(key, hoist_decompose(key.params, c), c.basis)


def hoist_rotate_apply(key: KSKey, digits: torch.Tensor, basis: RnsBasis,
                       galois_k: int) -> Tuple[RnsPoly, RnsPoly]:
    """Apply sigma_k to a hoisted digit stack (one slot gather) and
    inner-product it with the rotation key."""
    rotated = automorph.apply_eval(digits, basis.n, galois_k)
    return hoist_inner_product(key, rotated, basis)



# ---------------------------------------------------------------------------
# BV key switching (openfhe_tpu/keyswitch.py:455-567): digit decomposition
# per tower, no special primes (reference: KeySwitchBV, BaseDecompose).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BVKSParams:
    n: int
    q_moduli: Tuple[int, ...]
    log_base: int  # relinearization window r (digits in base 2^r)

    def num_digits(self, tower: int) -> int:
        return -(-self.q_moduli[tower].bit_length() // self.log_base)


@dataclasses.dataclass(frozen=True, eq=False)
class BVKSKey:
    """Per (tower i, digit d), in that order: an RLWE pair over the full Q
    encrypting B^d * delta_i * s_to; b and a are [sum of digits, L, n]."""

    b: torch.Tensor
    a: torch.Tensor
    params: BVKSParams


@lru_cache(maxsize=None)
def _bv_factor_table(params: BVKSParams, device: str):
    """[digits, L, 1]: B^d mod q_i in tower i and 0 elsewhere, per (i, d)."""
    B = 1 << params.log_base
    qs = params.q_moduli
    facs, pres = [], []
    for i in range(len(qs)):
        for d in range(params.num_digits(i)):
            fac, pre = shoup_consts(
                [pow(B, d, q) if j == i else 0 for j, q in enumerate(qs)],
                qs, device)
            facs.append(fac)
            pres.append(pre)
    return torch.stack(facs), torch.stack(pres)


def bv_keygen(params: BVKSParams, s_from: RnsPoly, s_to: RnsPoly,
              rng: np.random.Generator, sigma: float = 3.19,
              error_scale: int = 1) -> BVKSKey:
    """s_from/s_to are EVAL over the full Q basis (no extension). Draws, for
    each digit in turn, its `a` and then its error."""
    basis = RnsBasis(params.n, params.q_moduli)
    assert s_from.basis == basis and s_to.basis == basis
    dev = s_from.device
    factors = _bv_factor_table(params, str(dev))
    a_rows, e_rows = [], []
    for _ in range(factors[0].shape[0]):
        a_rows.append(sampling.uniform_rns_rows(params.n, basis.moduli, rng))
        e_rows.append(sampling.signed_to_rns_rows(
            sampling.gaussian_coeffs(params.n, rng, sigma) * error_scale,
            basis.moduli))
    a = dcrt.rows_tensor(np.stack(a_rows), dev)
    b = _digit_b(basis, a, np.stack(e_rows), s_to.data, s_from.data,
                 factors, dev)
    return BVKSKey(b, a, params)


def bv_apply(key: BVKSKey, c: RnsPoly) -> Tuple[RnsPoly, RnsPoly]:
    """Key-switch EVAL c over Q_l with the base-2^r digits of each tower
    residue (plain limbs, below every q_j, so each digit is one polynomial
    over all of Q_l): (d0, d1) = sum over digits of dig * (b, a)."""
    params = key.params
    assert c.fmt == Format.EVAL
    lvl = c.basis.L
    assert c.basis.moduli == params.q_moduli[:lvl]
    if params.log_base > 32:
        raise ValueError("BV digits wider than 32 bits are not supported")
    c_coeff = ntt.inverse(c.data, c.basis.moduli)          # [lvl, n]
    shifts = [(i, d * params.log_base) for i in range(lvl)
              for d in range(params.num_digits(i))]
    idx = elementwise._rows_tensor(tuple(i for i, _ in shifts),
                                   str(c.device))
    sh = elementwise._rows_tensor(tuple(s for _, s in shifts), str(c.device))
    dig = (c_coeff[idx] >> sh[:, None]) & ((1 << params.log_base) - 1)
    # the digits of towers below lvl are the key's first rows, in order
    digits = ntt.forward(dig[:, None, :].expand(-1, lvl, -1).contiguous(),
                         c.basis.moduli)                   # [D, lvl, n]
    mod = c.basis.mod(c.device)
    rows = list(range(lvl))
    acc = None
    for s in range(0, len(shifts), elementwise.MAX_DIGITS):
        e = min(s + elementwise.MAX_DIGITS, len(shifts))
        part = elementwise.ks_inner_product(digits[s:e], key.b[s:e],
                                            key.a[s:e], rows, mod)
        acc = part if acc is None else add_mod(acc, part, mod.q)
    return (RnsPoly(acc[0], c.basis, Format.EVAL),
            RnsPoly(acc[1], c.basis, Format.EVAL))

