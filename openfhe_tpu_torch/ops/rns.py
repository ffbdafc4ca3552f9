"""RNS basis toolkit.

Counterpart of ``openfhe_tpu/ops/rns.py``: ApproxSwitchCRTBasis,
ApproxModDown (with BGV's t-aware lift), the evaluation-domain rescale and
DropLastElementAndScale (the CKKS main path), and BFV's exact machinery: the
HPS scale-and-round, the exact CRT basis switch with its overflow count, and
BEHZ's Montgomery, flooring and Shenoy-Kumaresan conversions, on int64
residue stacks.

Each term [x_i * QHatInv_i]_{q_i} * [QHat_i]_{p_j} is a Shoup constant
multiply with exact host tables, computed for every (source, target) tower
pair at once as [..., K, L, n], and the sum over i is a pairwise tree of
modular adds mod p_j (``mod_sum``). So every output is the unique
reduced residue, bit-equal to the JAX package's per-tower fold, its u32
path and its int8-matmul path (``rns_mxu``) alike. The JAX package's
128- and 192-bit fixed-point accumulations (64-bit limbs added with carry,
tower by tower) are here one ``modular.limb_sum`` over the tower axis: the
same integer modulo the same power of two, so the same rounding bit and the
same overflow count.

Tables are cached per (from basis, to basis, device).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import _build
from . import ntt
from .modular import (add_mod, barrett_word, int_tensor, join32,
                      limb_sum, make_mod_consts, mul64_full, mul_mod_shoup,
                      shoup_consts, shoup_precon_int, sub_mod,
                      switch_modulus)


def _dev(device) -> str:
    return str(torch.device(device))


@lru_cache(maxsize=None)
def _switch_basis_tables(from_moduli: tuple, to_moduli: tuple, device: str):
    Q = 1
    for q in from_moduli:
        Q *= q
    qhat = [Q // q for q in from_moduli]
    qhat_inv = [pow(h % q, -1, q) for h, q in zip(qhat, from_moduli)]
    qhi = shoup_consts(qhat_inv, from_moduli, device)
    # [K, L, 1]: [QHat_i]_{p_j} with precons mod p_j
    vals = int_tensor([[[h % p] for h in qhat] for p in to_moduli], device)
    pres = int_tensor([[[shoup_precon_int(h % p, p)] for h in qhat]
                       for p in to_moduli], device)
    return qhi, (vals, pres)


def switch_basis_tables(from_moduli, to_moduli, device=None):
    """((qhat_inv [L,1], precon), (qhat_mod_p [K,L,1], precon)) on `device`
    (None: the current CUDA device)."""
    return _switch_basis_tables(tuple(from_moduli), tuple(to_moduli),
                                str(_build.resolve_device(device)))


def mod_sum(terms: torch.Tensor, moduli) -> torch.Tensor:
    """Sum over axis -2 of reduced residues `terms` [..., K, L, n], mod the
    K `moduli` of axis -3: a pairwise tree of modular adds (both operands
    below q < 2^62, so no sum overflows), log2(L) rounds."""
    q = make_mod_consts(moduli, terms.device, trailing_dims=2).q
    x = terms
    while x.shape[-2] > 1:
        h = x.shape[-2] // 2
        s = add_mod(x[..., :h, :], x[..., h:2 * h, :], q)
        x = torch.cat([s, x[..., 2 * h:, :]], dim=-2) if x.shape[-2] % 2 \
            else s
    return x.squeeze(-2)


def _tower_products(y: torch.Tensor, c: torch.Tensor, c_pre: torch.Tensor,
                    moduli) -> torch.Tensor:
    """[..., K, L, n]: every source tower of y [..., L, n] times the [K, L, 1]
    constants, mod the K target moduli."""
    q = make_mod_consts(moduli, y.device, trailing_dims=2).q
    return mul_mod_shoup(y.unsqueeze(-3), c, c_pre, q)


def approx_switch_basis(x: torch.Tensor, from_moduli, to_moduli
                        ) -> torch.Tensor:
    """HPS approximate CRT basis switch of a COEFF residue stack x
    [..., L, n] over `from_moduli` to [..., K, n] over `to_moduli`:

        y_j = sum_i [x_i * QHatInv_i]_{q_i} * [QHat_i]_{p_j}  (mod p_j)

    A target modulus need not be prime (BEHZ converts into 2^16 too)."""
    (qhi, qhi_pre), (qh_p, qh_p_pre) = switch_basis_tables(
        from_moduli, to_moduli, x.device)
    qf = make_mod_consts(from_moduli, x.device).q
    y = mul_mod_shoup(x, qhi, qhi_pre, qf)             # [..., L, n]
    return mod_sum(_tower_products(y, qh_p, qh_p_pre, to_moduli), to_moduli)


@lru_cache(maxsize=None)
def _mod_down_tables(q_moduli: tuple, p_moduli: tuple, t: int, device: str):
    P = 1
    for p in p_moduli:
        P *= p
    pinv = shoup_consts([pow(P % q, -1, q) for q in q_moduli], q_moduli,
                        device)
    if t == 1:
        return pinv, None
    tinv_p = shoup_consts([pow(t % p, -1, p) for p in p_moduli], p_moduli,
                          device)
    t_q = shoup_consts([t % q for q in q_moduli], q_moduli, device)
    return pinv, (tinv_p, t_q)


def approx_mod_down(x_q: torch.Tensor, x_p: torch.Tensor, q_moduli, p_moduli,
                    t: int = 1) -> torch.Tensor:
    """Scale x over Q*P (its Q part [..., L, n] and P part [..., K, n],
    COEFF) by 1/P:
    out_i = (x_i - V_i) * P^{-1} mod q_i with V = x mod P; for t > 1 the lift
    is V = t * conv(t^{-1} * x_p), so it is also 0 mod t."""
    q_moduli, p_moduli = tuple(q_moduli), tuple(p_moduli)
    (pinv, pinv_pre), t_tabs = _mod_down_tables(q_moduli, p_moduli, t,
                                                _dev(x_q.device))
    qq = make_mod_consts(q_moduli, x_q.device).q
    if t_tabs is not None:
        (tinv, tinv_pre), (tq, tq_pre) = t_tabs
        x_p = mul_mod_shoup(x_p, tinv, tinv_pre,
                            make_mod_consts(p_moduli, x_p.device).q)
    conv = approx_switch_basis(x_p, p_moduli, q_moduli)
    if t_tabs is not None:
        conv = mul_mod_shoup(conv, tq, tq_pre, qq)
    return mul_mod_shoup(sub_mod(x_q, conv, qq), pinv, pinv_pre, qq)


@lru_cache(maxsize=None)
def _drop_scale_tables(moduli: tuple, device: str):
    *rest, q_last = moduli
    return shoup_consts([pow(q_last % q, -1, q) for q in rest], rest, device)


def _drop_last(x: torch.Tensor, x_last_coeff: torch.Tensor, moduli: tuple,
               to_eval: bool) -> torch.Tensor:
    """[q_last^{-1} * (x_i - centered(x_last))]_{q_i} for i < last, with the
    last tower's COEFF residues [..., 1, n] lifted into each remaining
    tower."""
    inv, inv_pre = _drop_scale_tables(moduli, _dev(x.device))
    new_mod = make_mod_consts(moduli[:-1], x.device)
    old_mod = make_mod_consts(moduli[-1:], x.device)
    s = switch_modulus(x_last_coeff, old_mod, new_mod)     # [..., L-1, n]
    if to_eval:
        s = ntt.forward(s, moduli[:-1])
    diff = sub_mod(x[..., :-1, :], s, new_mod.q)
    return mul_mod_shoup(diff, inv, inv_pre, new_mod.q)


def rescale_eval(x: torch.Tensor, moduli) -> torch.Tensor:
    """Divide-and-round by the last modulus of an EVAL stack [..., L, n]
    (leading dims: a batch of polynomials over one basis): only the last
    tower goes to the coefficient domain (one single-tower inverse NTT and
    one forward over the L-1 others, each over the whole batch)."""
    moduli = tuple(moduli)
    last = ntt.inverse(x[..., -1:, :], moduli[-1:])
    return _drop_last(x, last, moduli, True)


def drop_last_and_scale(x: torch.Tensor, moduli) -> torch.Tensor:
    """Exact divide-and-round by the last modulus of a COEFF stack
    [..., L, n]."""
    moduli = tuple(moduli)
    return _drop_last(x, x[..., -1:, :], moduli, False)


# ---------------------------------------------------------------------------
# BFV: HPS scale-and-round and the exact CRT basis switch
# (openfhe_tpu/ops/rns.py:262-451). Fractions are 64-bit (scale-and-round)
# or 128-bit (the overflow count's 1/r) fixed point, accumulated exactly.
# ---------------------------------------------------------------------------


def _prod(vals) -> int:
    out = 1
    for v in vals:
        out *= v
    return out


def _pair_table(rows, moduli, device):
    """[K, L, 1] constants rows[k][l] (each below moduli[k]) and their Shoup
    precons mod moduli[k]."""
    vals = [[[v] for v in row] for row in rows]
    pres = [[[shoup_precon_int(v, q)] for v in row]
            for row, q in zip(rows, moduli)]
    return int_tensor(vals, device), int_tensor(pres, device)


def _column(values, device):
    """[L, 1] unsigned 64-bit constants as int64 bit patterns."""
    return int_tensor([[int(v)] for v in values], device)


@lru_cache(maxsize=None)
def _scale_round_tables(s_moduli: tuple, r_moduli: tuple, t: int,
                        q_moduli: tuple, device: str):
    """Tables for round(t*X/Q) mod r_j, X over S, Q = prod(q_moduli) | S."""
    S, Q = _prod(s_moduli), _prod(q_moduli)
    if S % Q:
        raise ValueError("Q must divide the S-product")
    Rt = t * (S // Q)
    if any(Rt % r for r in r_moduli):
        raise ValueError("the overflow term t*S/Q must vanish mod each "
                         "target modulus")
    sinv = shoup_consts([pow((S // s) % s, -1, s) for s in s_moduli],
                        s_moduli, device)
    # t*Shat_s/Q = omega_s + theta_s; phi_s = theta_s * 2^64 rounded
    omegas, phis = [], []
    for s in s_moduli:
        num = t * (S // s)
        omega = num // Q
        frac_num = num - omega * Q
        phi = (frac_num << 64) // Q
        if 2 * ((frac_num << 64) % Q) >= Q:
            phi += 1
        omegas.append(omega)
        phis.append(phi)
    om = _pair_table([[w % r for w in omegas] for r in r_moduli], r_moduli,
                     device)
    return sinv, om, _column(phis, device)


def scale_and_round(x: torch.Tensor, s_moduli, r_moduli, t: int,
                    q_moduli) -> torch.Tensor:
    """round(t * X / Q) mod r_j for X given over basis S (COEFF) as
    [..., L, n], Q = prod(q_moduli) dividing prod(S); out [..., K, n] over
    `r_moduli`.

    out_j = sum_s xhat_s*[floor(t*Shat_s/Q)]_{r_j} + round(sum_s xhat_s *
    theta_s) with xhat_s = [x_s * Shat_s^{-1}]_s; the fraction sum is
    taken modulo 2^128 in 64-bit fixed point and rounded at bit 63, as the
    JAX package's 128-bit accumulation does."""
    s_moduli, r_moduli, q_moduli = map(tuple, (s_moduli, r_moduli, q_moduli))
    (sinv, sinv_pre), (om, om_pre), phi = _scale_round_tables(
        s_moduli, r_moduli, t, q_moduli, _dev(x.device))
    xhat = mul_mod_shoup(x, sinv, sinv_pre,
                         make_mod_consts(s_moduli, x.device).q)
    lo, hi = mul64_full(xhat, phi)
    # + 2^63 rounds to nearest: floor(A/2^64) + bit 63 of A
    limbs = limb_sum([(lo, 0), (hi, 2)], 4, bias=1 << 63)
    rt = join32(limbs[2], limbs[3]).unsqueeze(-2)          # [..., 1, n]
    r_mod = make_mod_consts(r_moduli, x.device)
    acc = mod_sum(_tower_products(xhat, om, om_pre, r_moduli), r_moduli)
    return add_mod(barrett_word(rt, r_mod.q, r_mod.mu), acc, r_mod.q)


@lru_cache(maxsize=None)
def _exact_switch_tables(from_moduli: tuple, to_moduli: tuple, device: str):
    R = _prod(from_moduli)
    rinv = shoup_consts([pow((R // r) % r, -1, r) for r in from_moduli],
                        from_moduli, device)
    # 1/r_j in base-2^64 fixed point with two fractional limbs: one limb of
    # floor(2^64/r) holds ~4 significant bits for a 60-bit r
    d1 = _column([(1 << 64) // r for r in from_moduli], device)
    d2 = _column([((1 << 128) // r) & ((1 << 64) - 1) for r in from_moduli],
                 device)
    rh = _pair_table([[(R // r) % q for r in from_moduli] for q in to_moduli],
                     to_moduli, device)
    rq = shoup_consts([R % q for q in to_moduli], to_moduli, device)
    return rinv, (d1, d2), rh, rq


def exact_switch_basis(x: torch.Tensor, from_moduli, to_moduli,
                       centered: bool = False) -> torch.Tensor:
    """EXACT CRT basis switch with the overflow count:
    out_i = sum_j xhat_j*[Rhat_j]_{q_i} - v*[R]_{q_i},
    v = floor(sum_j xhat_j / r_j) (the sum in 128-bit fixed point, counted
    modulo 2^192 as the JAX package does).

    ``centered=True`` rounds the count to nearest (+1/2 before the floor),
    so residues of a SIGNED value |v| < R/2 switch to that signed value."""
    from_moduli, to_moduli = tuple(from_moduli), tuple(to_moduli)
    (rinv, rinv_pre), (d1, d2), (rh, rh_pre), (rq, rq_pre) = \
        _exact_switch_tables(from_moduli, to_moduli, _dev(x.device))
    xhat = mul_mod_shoup(x, rinv, rinv_pre,
                         make_mod_consts(from_moduli, x.device).q)
    p1_lo, p1_hi = mul64_full(xhat, d2)      # weight 2^0
    p0_lo, p0_hi = mul64_full(xhat, d1)      # weight 2^64
    limbs = limb_sum([(p1_lo, 0), (p1_hi, 2), (p0_lo, 2), (p0_hi, 4)], 6,
                     bias=(1 << 127) if centered else 0)
    v = join32(limbs[4], limbs[5]).unsqueeze(-2)           # [..., 1, n]
    to_q = make_mod_consts(to_moduli, x.device).q
    acc = mod_sum(_tower_products(xhat, rh, rh_pre, to_moduli), to_moduli)
    return sub_mod(acc, mul_mod_shoup(v, rq, rq_pre, to_q), to_q)


# ---------------------------------------------------------------------------
# BEHZ (openfhe_tpu/ops/rns.py:454-584): exact integer base conversions
# (Montgomery, Shenoy-Kumaresan corrections), no fixed point.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _behz_mont_tables(q_moduli: tuple, bsk_moduli: tuple, m_tilde: int,
                      device: str):
    Q = _prod(q_moduli)
    mt = shoup_consts([m_tilde % q for q in q_moduli], q_moduli, device)
    # Q^{-1} mod m_tilde: the m_tilde channel recovers the overflow only
    # mod m_tilde, so the output is x or x - Q (the JAX package's contract)
    qinv_mt = shoup_consts([pow(Q % m_tilde, -1, m_tilde)], (m_tilde,),
                           device)
    q_b = shoup_consts([Q % b for b in bsk_moduli], bsk_moduli, device)
    mt_inv_b = shoup_consts([pow(m_tilde % b, -1, b) for b in bsk_moduli],
                            bsk_moduli, device)
    return mt, qinv_mt, q_b, mt_inv_b


def base_conv_q_to_bsk_montgomery(x: torch.Tensor, q_moduli, bsk_moduli,
                                  m_tilde: int = 1 << 16) -> torch.Tensor:
    """Base conversion of x [..., L, n] over Q to Bsk [..., k, n]: FastBConv
    of m_tilde*x into Bsk and into m_tilde (one conversion), then a small
    Montgomery reduction removes the alpha*Q overflow."""
    q_moduli, bsk_moduli = tuple(q_moduli), tuple(bsk_moduli)
    (mt, mt_pre), (qi, qi_pre), (qb, qb_pre), (mi, mi_pre) = \
        _behz_mont_tables(q_moduli, bsk_moduli, m_tilde, _dev(x.device))
    xm = mul_mod_shoup(x, mt, mt_pre, make_mod_consts(q_moduli, x.device).q)
    conv = approx_switch_basis(xm, q_moduli, bsk_moduli + (m_tilde,))
    k = len(bsk_moduli)
    y_bsk, y_mt = conv[..., :k, :], conv[..., k:, :]
    alpha = mul_mod_shoup(y_mt, qi, qi_pre,
                          make_mod_consts((m_tilde,), x.device).q)
    bq = make_mod_consts(bsk_moduli, x.device).q
    diff = sub_mod(y_bsk, mul_mod_shoup(alpha, qb, qb_pre, bq), bq)
    return mul_mod_shoup(diff, mi, mi_pre, bq)


@lru_cache(maxsize=None)
def _behz_floor_tables(q_moduli: tuple, bsk_moduli: tuple, device: str):
    Q = _prod(q_moduli)
    return shoup_consts([pow(Q % b, -1, b) for b in bsk_moduli], bsk_moduli,
                        device)


def rns_floor_q(tx_q: torch.Tensor, tx_bsk: torch.Tensor, q_moduli,
                bsk_moduli) -> torch.Tensor:
    """floor(tx / Q) over Bsk, up to an additive error below L:
    (tx_bsk - FastBConv(tx_q, Q -> Bsk)) * Q^{-1}."""
    q_moduli, bsk_moduli = tuple(q_moduli), tuple(bsk_moduli)
    qinv, qinv_pre = _behz_floor_tables(q_moduli, bsk_moduli,
                                        _dev(tx_q.device))
    bq = make_mod_consts(bsk_moduli, tx_q.device).q
    conv = approx_switch_basis(tx_q, q_moduli, bsk_moduli)
    return mul_mod_shoup(sub_mod(tx_bsk, conv, bq), qinv, qinv_pre, bq)


@lru_cache(maxsize=None)
def _behz_sk_tables(b_moduli: tuple, m_sk: int, q_moduli: tuple,
                    device: str):
    B = _prod(b_moduli)
    binv = shoup_consts([pow(B % m_sk, -1, m_sk)], (m_sk,), device)
    b_q = shoup_consts([B % q for q in q_moduli], q_moduli, device)
    msk_b = int_tensor([[(m_sk * B) % q] for q in q_moduli], device)
    return binv, b_q, msk_b


def base_conv_sk(y_bsk: torch.Tensor, b_moduli, m_sk: int, q_moduli
                 ) -> torch.Tensor:
    """Exact Shenoy-Kumaresan conversion Bsk = B + {m_sk} -> Q of
    [..., k+1, n]: the residue mod m_sk pins the FastBConv overflow alpha,
    read centered (alpha > (m_sk-1)/2 is negative)."""
    b_moduli, q_moduli = tuple(b_moduli), tuple(q_moduli)
    kb = len(b_moduli)
    (bi, bi_pre), (bq, bq_pre), msk_b = _behz_sk_tables(
        b_moduli, m_sk, q_moduli, _dev(y_bsk.device))
    y_b, y_msk = y_bsk[..., :kb, :], y_bsk[..., kb:, :]
    # one conversion into Q and m_sk
    conv = approx_switch_basis(y_b, b_moduli, q_moduli + (m_sk,))
    conv_q, conv_msk = conv[..., :-1, :], conv[..., -1:, :]
    msk = make_mod_consts((m_sk,), y_bsk.device).q
    alpha = mul_mod_shoup(sub_mod(conv_msk, y_msk, msk), bi, bi_pre, msk)
    qq = make_mod_consts(q_moduli, y_bsk.device).q
    pos = sub_mod(conv_q, mul_mod_shoup(alpha, bq, bq_pre, qq), qq)
    # alpha - m_sk instead: out = conv - (alpha - m_sk) * B = pos + m_sk*B
    neg = add_mod(pos, msk_b, qq)
    return torch.where(alpha > (m_sk - 1) // 2, neg, pos)
