"""CKKS <-> FHEW scheme switching.

Counterpart of ``openfhe_tpu/models/scheme_switch.py`` (the reference's
``ckksrns-schemeswitching.{h,cpp}``: ``EvalCKKStoFHEWSetup/KeyGen`` with
``EvalCKKStoFHEW`` and ``EvalFHEWtoCKKS``, and the comparison, minimum and
maximum built on them), with the same names, the same draws in the same
order and the same float64 host constants, so keys, LWE samples and CKKS
residues are bit-equal to the JAX package's for the same seed.

CKKS -> FHEW: one slots-to-coefficients linear transform (the bootstrap's
StC matrix with the q0/p coefficient scale folded in), a drop to the last
tower, one LWE sample per coefficient position under the CKKS secret
(dimension n), the rounding switch q0 -> q_sw, the batched LWE key switch
n -> n_lwe (``binfhe._lwe_keyswitch_batch``: its key gather runs on the card
in chunks) and the rounding switch to the FHEW gate modulus. Both switches
are exact: q0 * q_sw passes 2^63, so the JAX package rounds them in Python
ints, and ``binfhe._round_switch`` gives the same integers on the card.

FHEW -> CKKS: the LWE phases t_i = b_i/q - <a_i/q, s> by the diagonal method
against a CKKS encryption of the FHEW key, then sin(2 pi t) by a Chebyshev
series, so the unknown wraps of t vanish.

Compare, minimum and maximum switch the difference of two CKKS values to
FHEW, take its sign with one ``binfhe.eval_func`` each and switch the signs
back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import dcrt, keyswitch
from . import binfhe
from . import ckks
from . import ckks_advanced as adv
from . import ckks_bootstrap as boot
from .binfhe import LWECiphertext
from .ckks import Ciphertext, CKKSContext


@dataclasses.dataclass
class SchemeSwitchPrecomp:
    slots: int            # LT size s (power of two >= values per switch)
    D: np.ndarray         # StC matrix (ckks_bootstrap convention)
    B: int                # wrap bound of the FHEW->CKKS sine interval
    cheb_coeffs: np.ndarray


@dataclasses.dataclass
class SchemeSwitchKeys:
    conj: keyswitch.KSKey
    rot_stc: Dict[int, keyswitch.KSKey]      # the StC transform's rotations
    rot_f2c: Dict[int, keyswitch.KSKey]      # rotations 1..n_lwe-1
    evk: keyswitch.KSKey
    ct_s: Ciphertext                         # CKKS encryption of s_lwe
    lwe_ks_a: torch.Tensor                   # [n, d, B, n_lwe] mod q_sw
    lwe_ks_b: torch.Tensor                   # [n, d, B]
    q_sw: int


def setup(ctx: CKKSContext, bctx: binfhe.BinFHEContext, slots: int,
          cheb_deg: int = 80) -> SchemeSwitchPrecomp:
    """(role of EvalCKKStoFHEWSetup / EvalSchemeSwitchingSetup): host
    constants. The sine interval [-B, B] holds the phase t = b/q -
    <a/q, s> with about 3 sigma (the JAX package's bound, probabilistic as
    the reference's is)."""
    n = ctx.n
    s = slots
    assert s <= n // 4 and n % (2 * s) == 0
    n_lwe = bctx.params.n_lwe
    assert ctx.params.num_slots % n_lwe == 0, \
        "n_lwe must divide the CKKS slot count for the diagonal method"
    _, D = boot.stc_matrices(n, s)
    k_sigma = 3.0
    B = int(np.ceil(k_sigma * np.sqrt(n_lwe / 3.0))) + 2
    cheb = adv.chebyshev_coefficients(
        lambda u: np.sin(2.0 * np.pi * u), -B, B, cheb_deg)
    return SchemeSwitchPrecomp(s, D, B, cheb)


def keygen(ctx: CKKSContext, bctx: binfhe.BinFHEContext,
           pre: SchemeSwitchPrecomp, sk, sk_fhew: binfhe.BinFHESecret,
           pk, rng: np.random.Generator) -> SchemeSwitchKeys:
    """(role of EvalCKKStoFHEWKeyGen + EvalFHEWtoCKKSKeyGen). Draws, in
    order: conjugation, StC rotations, rotations 1..n_lwe-1, relinearization,
    the CKKS encryption of s_lwe tiled over the slots, then the n -> n_lwe
    LWE switching key (its a, then its errors) keyed by the CKKS secret's
    coefficients."""
    p = bctx.params
    conj = ckks.conj_keygen(ctx, sk, rng)
    rot_stc = ckks.rot_keygen(ctx, sk, boot.lt_rotation_indices(pre.slots),
                              rng)
    rot_f2c = ckks.rot_keygen(ctx, sk, range(1, p.n_lwe), rng)
    evk = ckks.relin_keygen(ctx, sk, rng)
    reps = ctx.params.num_slots // p.n_lwe
    ct_s = ckks.encrypt(ctx, pk, np.tile(sk_fhew.s_lwe.astype(float), reps),
                        rng)
    a_ks, b_ks = binfhe._lwe_keyswitch_keygen(bctx, sk.coeffs,
                                              sk_fhew.s_lwe, rng)
    return SchemeSwitchKeys(conj, rot_stc, rot_f2c, evk, ct_s, a_ks, b_ks,
                            p.q_ks)


# ---------------------------------------------------------------------------
# CKKS -> FHEW
# ---------------------------------------------------------------------------


def eval_ckks_to_fhew(ctx: CKKSContext, bctx: binfhe.BinFHEContext,
                      pre: SchemeSwitchPrecomp, keys: SchemeSwitchKeys,
                      ct: Ciphertext, num_values: int, p_msg: int
                      ) -> List[LWECiphertext]:
    """(role of EvalCKKStoFHEW, ckksrns-schemeswitching.h:83). ``ct``
    carries integer messages in its first ``num_values`` slots, tiled with
    period ``pre.slots``. Returns LWE ciphertexts under the FHEW key at the
    gate modulus with phase m * q/p_msg."""
    assert num_values <= pre.slots
    q0 = ctx.q_moduli[0]
    n = ctx.n
    gap = n // (2 * pre.slots)

    # 1. slots-to-coeffs with the q0/p coefficient scale folded in
    delta1 = ct.scale * adv.scale_at(ctx, 0) / ctx.q_moduli[ct.towers - 1]
    factor = q0 / (p_msg * delta1)
    bkeys = boot.BootstrapKeys(keys.evk, keys.conj, keys.rot_stc)
    poly_ct = boot._linear_transform(ctx, ct, pre.D * factor, bkeys)

    # 2. drop to the last tower, read the coefficients
    poly_ct = ckks.level_reduce(poly_ct, poly_ct.towers - 1)
    c0, c1 = (dcrt.to_coeff(p).data[0] for p in poly_ct.polys)

    # 3. one LWE sample per position under the CKKS coefficient key at q0:
    #    a_j[i] = c1[pos - i] for i <= pos, else -c1[n + pos - i]
    dev = c1.device
    pos = torch.arange(num_values, device=dev)[:, None] * gap        # [k, 1]
    src = pos - torch.arange(n, device=dev)[None, :]                 # [k, n]
    wrapped = c1[src % n]
    a = torch.where(src >= 0, wrapped, (q0 - wrapped) % q0)
    b = c0[pos[:, 0]]

    # 4. q0 -> q_sw, the key switch n -> n_lwe, q_sw -> the gate modulus
    q_sw, q_out = keys.q_sw, bctx.params.q
    a_acc, b_acc = binfhe._lwe_keyswitch_batch(
        bctx, keys.lwe_ks_a, keys.lwe_ks_b, binfhe._round_switch(a, q0, q_sw),
        binfhe._round_switch(b, q0, q_sw))
    a2 = binfhe._round_switch(a_acc, q_sw, q_out)
    b2 = binfhe._round_switch(b_acc, q_sw, q_out).tolist()
    return [LWECiphertext(a2[i], int(b2[i]), q_out)
            for i in range(num_values)]


# ---------------------------------------------------------------------------
# FHEW -> CKKS
# ---------------------------------------------------------------------------


def eval_fhew_to_ckks(ctx: CKKSContext, bctx: binfhe.BinFHEContext,
                      pre: SchemeSwitchPrecomp, keys: SchemeSwitchKeys,
                      cts: Sequence[LWECiphertext],
                      slot_map: np.ndarray | None = None) -> Ciphertext:
    """(role of EvalFHEWtoCKKS, ckksrns-schemeswitching.h:105). Packs the
    LWE ciphertexts' messages into CKKS slots; for the gate encoding (p = 4,
    m in {0, 1}) slot i reads m_i. ``slot_map`` (int [num_slots], -1 = zero)
    puts any ciphertext in any slot; by default ct i goes to slot i."""
    n_lwe = bctx.params.n_lwe
    k = len(cts)
    assert k <= n_lwe, "pack at most n_lwe values per call"
    q = cts[0].modulus
    n_half = ctx.params.num_slots
    if slot_map is None:
        slot_map = np.full(n_half, -1, dtype=np.int64)
        slot_map[:k] = np.arange(k)
    live = slot_map >= 0
    p_idx = np.arange(n_half)

    A = np.stack([c.a.cpu().numpy().astype(np.float64) for c in cts])
    b = np.array([float(c.b) for c in cts])

    # t = b/q - (A/q) s: slot p of rot(ct_s, d) holds s[(p + d) mod n_lwe],
    # so weight w[p] picks the matching coefficient of slot p's ciphertext
    acc = None
    for d in range(n_lwe):
        w = np.zeros(n_half)
        w[live] = -A[slot_map[live], (p_idx[live] + d) % n_lwe] / q
        if not np.any(w):
            continue
        rot = keys.ct_s if d == 0 else \
            ckks.eval_rotate(keys.ct_s, d, keys.rot_f2c[d])
        term = ckks.eval_mult_plain(ctx, rot, w)
        acc = term if acc is None else ckks.eval_add(acc, term)
    acc = ckks.rescale(acc)
    bvec = np.zeros(n_half)
    bvec[live] = b[slot_map[live]] / q
    t_ct = ckks.eval_add_plain(ctx, acc, bvec)
    # wrap-free message recovery: sin(2 pi t) = m for the gate encoding
    return adv.eval_chebyshev(ctx, t_ct, pre.cheb_coeffs, -pre.B, pre.B,
                              keys.evk)


# ---------------------------------------------------------------------------
# Comparison, minimum and maximum (EvalCompareSchemeSwitching,
# EvalMin/MaxSchemeSwitching, ckksrns-schemeswitching.cpp:1758-2074)
# ---------------------------------------------------------------------------


def _sign_q4_lut(p: int) -> list:
    """Negacyclic sign LUT of Z_p onto +-p/4 (so the FHEW->CKKS sine lands
    on +-1): +p/4 for m in (0, p/2), -p/4 above."""
    return ([0] + [p // 4] * (p // 2 - 1)
            + [0] + [p - p // 4] * (p // 2 - 1))


def _signs(bctx, bk, lwes, p_msg: int) -> list:
    lut = _sign_q4_lut(p_msg)
    return [binfhe.eval_func(bctx, bk, c, lut, p_msg) for c in lwes]


def _eval_signs(ctx, bctx, pre, keys, bk, diff_ct, num_values: int,
                p_msg: int):
    """CKKS difference -> FHEW signs -> CKKS slots in {-1, +1} (+1 where
    diff > 0): the shared core of compare, minimum and maximum."""
    lwes = eval_ckks_to_fhew(ctx, bctx, pre, keys, diff_ct, num_values,
                             p_msg)
    return eval_fhew_to_ckks(ctx, bctx, pre, keys,
                             _signs(bctx, bk, lwes, p_msg))


def eval_compare_scheme_switching(ctx, bctx, pre, keys, bk,
                                  ct1: Ciphertext, ct2: Ciphertext,
                                  num_values: int, p_msg: int
                                  ) -> Ciphertext:
    """(role of EvalCompareSchemeSwitching, ckksrns-schemeswitching.cpp:
    1779-1823). Slot i is ~1.0 where ct1_i < ct2_i, ~0.0 where ct1_i >
    ct2_i (~0.5 at ties); the values are integers within p_msg/2."""
    s = _eval_signs(ctx, bctx, pre, keys, bk, ckks.eval_sub(ct1, ct2),
                    num_values, p_msg)
    # (1 - s) / 2
    half = np.full(ctx.params.num_slots, 0.5)
    out = ckks.rescale(ckks.eval_mult_plain(ctx, s, -half))
    return ckks.eval_add_plain(ctx, out, half)


def _tile_full(ctx, block: np.ndarray) -> np.ndarray:
    """A length-s block tiled over every slot (the LT's period-s
    convention)."""
    return np.tile(block, ctx.params.num_slots // len(block))


def extremum_rotation_indices(ctx, num_values: int) -> list:
    """The rotation keys eval_min/max_scheme_switching consume: the pair
    strides num_values/2, num_values/4, ..., 1."""
    idx = set()
    m = 1
    while m < num_values:
        idx.add(num_values // (2 * m))
        m *= 2
    return sorted(idx)


def _one_ct(ctx, keys):
    """An encryption of all-ones without a public key: ct_s * 0 + 1."""
    zero = ckks.eval_mult_plain(ctx, keys.ct_s,
                                np.zeros(ctx.params.num_slots))
    zero = ckks.rescale(zero)
    return ckks.eval_add_plain(ctx, zero, np.ones(ctx.params.num_slots))


def _mult_plain_canonical(ctx, ct: Ciphertext, values) -> Ciphertext:
    """ct * values, rescaled onto the canonical scale of the next depth:
    the plaintext is encoded at adjust_depth's compensating scale, so
    mult_auto takes the result. (The JAX package multiplies at the
    context's scale here, which leaves the tournament's masks off the
    canonical chain: its mult_auto then fails its scale check.)"""
    k = adv.depth_of(ctx, ct)
    tau = adv.scale_at(ctx, k + 1) * ctx.q_moduli[ct.towers - 1] / ct.scale
    pt = ckks.encode(ctx, values, towers=ct.towers, scale=tau)
    return ckks.rescale(Ciphertext(tuple(dcrt.mul(p, pt) for p in ct.polys),
                                   ct.scale * tau))


def _indicator(ctx, pre, keys, num_values: int) -> Ciphertext:
    block0 = np.zeros(pre.slots)
    block0[:num_values] = 1.0
    return _mult_plain_canonical(ctx, _one_ct(ctx, keys),
                                 _tile_full(ctx, block0))


def _select_round(ctx, cur, ind, sel, stride, evk, rot_keys):
    """Keep what `sel` selects of each pair and fold the pair together."""
    cur = adv.mult_auto(ctx, cur, sel, evk)
    cur = adv.add_auto(ctx, cur,
                       ckks.eval_rotate(cur, stride, rot_keys[stride]))
    return cur, adv.mult_auto(ctx, ind, sel, evk)


def _eval_extremum(ctx, bctx, pre, keys, bk, evk, rot_keys, ct,
                   num_values: int, p_msg: int, minimum: bool):
    """Tournament of log2(num_values) rounds of compare and masked select
    (EvalMin/MaxSchemeSwitching, ckksrns-schemeswitching.cpp:1825-2074).
    The signs come back already tiled (eval_fhew_to_ckks's slot_map), and
    the select is one position-dependent plaintext affine. ct is s-periodic;
    returns (extremum, arg indicator), both s-periodic."""
    assert num_values & (num_values - 1) == 0, "numValues must be a power of 2"
    ns = ctx.params.num_slots
    p_idx = np.arange(ns)
    ind = _indicator(ctx, pre, keys, num_values)
    cur = ct
    m = 1
    while m < num_values:
        stride = num_values // (2 * m)
        diff = adv.sub_auto(ctx, cur,
                            ckks.eval_rotate(cur, stride, rot_keys[stride]))
        lwes = eval_ckks_to_fhew(ctx, bctx, pre, keys, diff, stride, p_msg)
        signs = _signs(bctx, bk, lwes, p_msg)
        # slots p and p + stride of every 2*stride block carry one pair's
        # sign (+1 where the first is larger)
        smap = (p_idx % (2 * stride)) % stride
        s = eval_fhew_to_ckks(ctx, bctx, pre, keys, signs, slot_map=smap)
        # (1 -+ s)/2: keep-first on the first half of each block, its
        # complement on the second
        first_half = (p_idx % (2 * stride)) < stride
        sign = np.where(first_half, -0.5, 0.5)
        if not minimum:
            sign = -sign
        sel = ckks.eval_add_plain(ctx, _mult_plain_canonical(ctx, s, sign),
                                  np.full(ns, 0.5))
        cur, ind = _select_round(ctx, cur, ind, sel, stride, evk, rot_keys)
        m *= 2
    return cur, ind


def eval_min_scheme_switching(ctx, bctx, pre, keys, bk, evk, rot_keys,
                              ct: Ciphertext, num_values: int, p_msg: int):
    """(role of EvalMinSchemeSwitching, ckksrns-schemeswitching.cpp:
    1825-1907): (minimum, one-hot argmin indicator)."""
    return _eval_extremum(ctx, bctx, pre, keys, bk, evk, rot_keys, ct,
                          num_values, p_msg, minimum=True)


def eval_max_scheme_switching(ctx, bctx, pre, keys, bk, evk, rot_keys,
                              ct: Ciphertext, num_values: int, p_msg: int):
    """(role of EvalMaxSchemeSwitching, ckksrns-schemeswitching.cpp:
    1990-2074): (maximum, one-hot argmax indicator)."""
    return _eval_extremum(ctx, bctx, pre, keys, bk, evk, rot_keys, ct,
                          num_values, p_msg, minimum=False)


def _eval_extremum_alt(ctx, bctx, pre, keys, bk, evk, rot_keys, ct,
                       num_values: int, p_msg: int, minimum: bool):
    """The Alt tournament (EvalMin/MaxSchemeSwitchingAlt,
    ckksrns-schemeswitching.cpp:1909-1988, 2075-2150): each round replicates
    the FHEW signs on the host into a num_values-long vector, odd blocks
    negated (the same LWE with b + q/2 flips the sine's +-1), so one
    constant affine (1 -+ s)/2 finishes the select."""
    assert num_values & (num_values - 1) == 0, "numValues must be a power of 2"
    ns = ctx.params.num_slots
    p_idx = np.arange(ns)
    ind = _indicator(ctx, pre, keys, num_values)
    cur = ct
    m = 1
    while m < num_values:
        stride = num_values // (2 * m)
        diff = adv.sub_auto(ctx, cur,
                            ckks.eval_rotate(cur, stride, rot_keys[stride]))
        lwes = eval_ckks_to_fhew(ctx, bctx, pre, keys, diff, stride, p_msg)
        full: list = [None] * num_values
        for j, s_j in enumerate(_signs(bctx, bk, lwes, p_msg)):
            q = s_j.modulus
            neg = LWECiphertext(s_j.a, (s_j.b + q // 2) % q, q)
            for i in range(2 * m):
                full[i * stride + j] = s_j if i % 2 == 0 else neg
        s = eval_fhew_to_ckks(ctx, bctx, pre, keys, full,
                              slot_map=p_idx % num_values)
        const = -0.5 if minimum else 0.5
        sel = ckks.eval_add_plain(
            ctx, _mult_plain_canonical(ctx, s, np.full(ns, const)),
            np.full(ns, 0.5))
        cur, ind = _select_round(ctx, cur, ind, sel, stride, evk, rot_keys)
        m *= 2
    return cur, ind


def eval_min_scheme_switching_alt(ctx, bctx, pre, keys, bk, evk, rot_keys,
                                  ct: Ciphertext, num_values: int,
                                  p_msg: int):
    """(role of EvalMinSchemeSwitchingAlt,
    ckksrns-schemeswitching.h:138)."""
    return _eval_extremum_alt(ctx, bctx, pre, keys, bk, evk, rot_keys, ct,
                              num_values, p_msg, minimum=True)


def eval_max_scheme_switching_alt(ctx, bctx, pre, keys, bk, evk, rot_keys,
                                  ct: Ciphertext, num_values: int,
                                  p_msg: int):
    """(role of EvalMaxSchemeSwitchingAlt,
    ckksrns-schemeswitching.h:148)."""
    return _eval_extremum_alt(ctx, bctx, pre, keys, bk, evk, rot_keys, ct,
                              num_values, p_msg, minimum=False)
