"""RNS basis toolkit: the CKKS main-path part.

Counterpart of ``openfhe_tpu/ops/rns.py:1-255``: ApproxSwitchCRTBasis,
ApproxModDown (with BGV's t-aware lift), the evaluation-domain rescale and
DropLastElementAndScale, on int64 residue stacks. Each term
[x_i * QHatInv_i]_{q_i} * [QHat_i]_{p_j} is a Shoup constant multiply with
exact host tables and the sum over i is folded mod p_j, so every output is
the unique reduced residue — bit-equal to the JAX package's 64-bit path, its
u32 path and its int8-matmul path (``rns_mxu``) alike.

Tables are cached per (from basis, to basis, device).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import _build
from . import ntt
from .modular import (add_mod, int_tensor, make_mod_consts, mul_mod_shoup,
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


def approx_switch_basis(x: torch.Tensor, from_moduli, to_moduli
                        ) -> torch.Tensor:
    """HPS approximate CRT basis switch of a COEFF residue stack x
    [..., L, n] over `from_moduli` to [..., K, n] over `to_moduli`:

        y_j = sum_i [x_i * QHatInv_i]_{q_i} * [QHat_i]_{p_j}  (mod p_j)
    """
    (qhi, qhi_pre), (qh_p, qh_p_pre) = switch_basis_tables(
        from_moduli, to_moduli, x.device)
    qf = make_mod_consts(from_moduli, x.device).q
    qt = make_mod_consts(to_moduli, x.device).q
    y = mul_mod_shoup(x, qhi, qhi_pre, qf)             # [..., L, n]
    acc = None
    for i in range(len(from_moduli)):
        term = mul_mod_shoup(y[..., i:i + 1, :], qh_p[:, i], qh_p_pre[:, i],
                             qt)
        acc = term if acc is None else add_mod(acc, term, qt)
    return acc


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
