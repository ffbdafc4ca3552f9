"""Keyswitch multiply-accumulate: the digit inner product and its one-digit
step.

Counterpart of ``openfhe_tpu/ops/elementwise_pallas.py`` (``fused_mac_mod``)
and of the inner product loop of ``openfhe_tpu/keyswitch.py:368-396``.

* ``ks_inner_product(digits, key_b, key_a, rows, mod)``: for each output row
  r, acc[0, r] = sum_d digits[d, r] * key_b[d, rows[r]] mod q_r and acc[1]
  the same with key_a — the whole digit loop in one kernel pass, both halves
  in one [2, R, n] tensor so the mod-down that follows is one batch. With
  ``mono=, mono_rows=`` both halves of row r are then multiplied by
  mono[mono_rows[r]] mod q_r in the same pass (a CGGI blind-rotation step's
  monomial product); ``rows`` may be a device index instead of a host list
  (the AP blind rotation reads its key rows in place).
* ``fused_mac_mod(x, y, acc, mod)``: (acc + x*y) mod q over [R, n], the
  Pallas kernel's exact contract.

Both launch ``csrc/mac.cu`` for CUDA tensors and run the plain twins
(``*_plain``: ``mul_mod`` + ``add_mod`` chains) for CPU tensors.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Sequence, Union

import torch

from .. import _build
from .modular import ModConsts, add_mod, check_reduced, checking, mul_mod

# The kernels sum products < q^2 < 2^124 (q < 2^62) in 128 bits, lazily:
# up to 15 of them (plus an addend < q) cannot overflow.
MAX_DIGITS = 15
# a host row list up to this long goes to the kernel by value (csrc/mac.cu
# kMaxRowsByValue); a longer one as a device index
MAX_ROWS_BY_VALUE = 128


@lru_cache(maxsize=None)
def _rows_tensor(rows: tuple, device: str) -> torch.Tensor:
    """Key-row index on the device, cached: building it per call would be a
    synchronous host-to-device copy on every keyswitch."""
    return torch.tensor(rows, dtype=torch.int64, device=device)


@lru_cache(maxsize=None)
def _rows_by_value(rows: tuple) -> ctypes.Array:
    """A host row list as the C array the kernel copies into its
    parameters, cached (the cache keeps it alive)."""
    return (ctypes.c_int * len(rows))(*rows)


def _check_index(idx: torch.Tensor, R: int, bound: int, what: str) -> None:
    """An [R] int64 index, on the debug path (``checking()``) also in
    [0, bound): the kernel reads rows by it unchecked."""
    if idx.dtype != torch.int64 or tuple(idx.shape) != (R,):
        raise ValueError(f"ks_inner_product: {what} must be an int64 [{R}] "
                         f"tensor, got {idx.dtype} {tuple(idx.shape)}")
    if checking() and not bool(((idx >= 0) & (idx < bound)).all()):
        raise ValueError(f"ks_inner_product: {what} outside [0, {bound})")


def _row_consts(mod: ModConsts, R: int):
    """[R, 1] ModConsts -> four contiguous [R] tensors for the kernel."""
    out = [c.reshape(-1).contiguous() for c in mod]
    if out[0].numel() != R:
        raise ValueError(f"{out[0].numel()} moduli for {R} rows")
    return out


def fused_mac_plain(x, y, acc, mod: ModConsts):
    return add_mod(mul_mod(x, y, mod), acc, mod.q)


def fused_mac_mod(x: torch.Tensor, y: torch.Tensor, acc: torch.Tensor,
                  mod: ModConsts) -> torch.Tensor:
    """(acc + x*y) mod q for [R, n] stacks; mod fields are [R, 1]."""
    if x.dim() != 2 or x.shape != y.shape or x.shape != acc.shape:
        raise ValueError("fused_mac_mod takes three [R, n] tensors")
    for t in (x, y, acc):
        check_reduced(t, mod.q, "fused_mac_mod")
    if x.device.type == "cpu":
        return fused_mac_plain(x, y, acc, mod)
    R, n = x.shape
    consts = _row_consts(mod, R)
    x, y, acc = x.contiguous(), y.contiguous(), acc.contiguous()
    _build.require_cuda("fused_mac_mod", x, y, acc, *consts)
    out = torch.empty_like(x)
    _build.check("fused_mac_mod", _build.library().fused_mac_mod(
        x.data_ptr(), y.data_ptr(), acc.data_ptr(), R, n,
        *[c.data_ptr() for c in consts], out.data_ptr(), _build.stream()))
    fused_mac_mod.launches += 1
    return out


def ks_inner_product_plain(digits, key_b, key_a, rows, mod: ModConsts,
                           mono=None, mono_rows=None):
    # index_select, not key_b[:, rows]: on the CPU the advanced-indexing
    # gather along axis 1 takes milliseconds even for a few rows
    kb, ka = key_b.index_select(1, rows), key_a.index_select(1, rows)
    acc0 = acc1 = None
    for d in range(digits.shape[0]):
        t0 = mul_mod(digits[d], kb[d], mod)
        t1 = mul_mod(digits[d], ka[d], mod)
        if acc0 is None:
            acc0, acc1 = t0, t1
        else:
            acc0 = add_mod(acc0, t0, mod.q)
            acc1 = add_mod(acc1, t1, mod.q)
    out = torch.stack([acc0, acc1])
    if mono is not None:
        out = mul_mod(out, mono.index_select(0, mono_rows), mod)
    return out


def ks_inner_product(digits: torch.Tensor, key_b: torch.Tensor,
                     key_a: torch.Tensor,
                     rows: Union[Sequence[int], torch.Tensor],
                     mod: ModConsts, mono: Optional[torch.Tensor] = None,
                     mono_rows: Optional[torch.Tensor] = None):
    """[2, R, n]: sum_d digits[d] * key_b[d, rows] and sum_d digits[d] *
    key_a[d, rows], mod q per row, each row then times mono[mono_rows[r]]
    mod q_r when a table is given. digits: [ndig, R, n], ndig <=
    MAX_DIGITS; key_b, key_a: [dnum, key_rows, n] with dnum >= ndig; rows:
    the R active key rows, a host list or an int64 [R] tensor on the
    digits' device (checked against key_rows only on the debug path); mod:
    [R, 1] constants; mono: [M, n] reduced residues and mono_rows its int64
    [R] row index, both or neither. On a CUDA tensor the kernel also needs
    an even n (it reads two residues at once)."""
    ndig, R, n = digits.shape
    if key_b.shape != key_a.shape or key_b.dim() != 3 or \
            key_b.shape[0] < ndig or key_b.shape[2] != n:
        raise ValueError("ks_inner_product: digits [ndig, R, n] do not match "
                         "keys [dnum, rows, n]")
    if ndig > MAX_DIGITS:
        raise ValueError(f"{ndig} digits overflow the 128-bit accumulator")
    key_rows = key_b.shape[1]
    host_rows = None
    if isinstance(rows, torch.Tensor):
        _check_index(rows, R, key_rows, "rows")
        rows_t = rows
    else:
        host_rows = tuple(int(r) for r in rows)
        if len(host_rows) != R or \
                not all(0 <= r < key_rows for r in host_rows):
            raise ValueError("ks_inner_product: the row list does not match "
                             "the digits' R rows and the keys' rows")
        rows_t = _rows_tensor(host_rows, str(digits.device))
    if (mono is None) != (mono_rows is None):
        raise ValueError("ks_inner_product: mono and mono_rows come together")
    if mono is not None:
        if mono.dim() != 2 or mono.shape[1] != n:
            raise ValueError(f"ks_inner_product: the monomial table must be "
                             f"[M, {n}], got {tuple(mono.shape)}")
        _check_index(mono_rows, R, mono.shape[0], "mono_rows")
        if checking():
            check_reduced(mono.index_select(0, mono_rows), mod.q,
                          "ks_inner_product")
    check_reduced(digits, mod.q, "ks_inner_product")
    if digits.device.type == "cpu":
        return ks_inner_product_plain(digits, key_b, key_a, rows_t, mod,
                                      mono, mono_rows)
    consts = _row_consts(mod, R)
    digits, key_b, key_a = (digits.contiguous(), key_b.contiguous(),
                            key_a.contiguous())
    by_value = host_rows is not None and R <= MAX_ROWS_BY_VALUE
    index = [] if by_value else [rows_t.contiguous()]
    table = [] if mono is None else [mono.contiguous(),
                                     mono_rows.contiguous()]
    _build.require_cuda("ks_inner_product", digits, key_b, key_a, *index,
                        *table, *consts)
    out = torch.empty((2, R, n), dtype=torch.int64, device=digits.device)
    if n % 2 or any(t.data_ptr() % 16
                    for t in (digits, key_b, key_a, out, *table[:1])):
        raise ValueError("ks_inner_product: the kernel reads two residues at "
                         "once: n must be even and each tensor 16-byte "
                         "aligned")
    _build.check("ks_inner_product", _build.library().ks_inner_product(
        digits.data_ptr(), key_b.data_ptr(), key_a.data_ptr(),
        None if by_value else index[0].data_ptr(),
        ctypes.addressof(_rows_by_value(host_rows)) if by_value else None,
        ndig, R, key_rows, n, *[c.data_ptr() for c in consts],
        *([t.data_ptr() for t in table] if table else [None, None]),
        out[0].data_ptr(), out[1].data_ptr(), _build.stream()))
    ks_inner_product.launches += 1
    return out


fused_mac_mod.launches = 0
ks_inner_product.launches = 0
