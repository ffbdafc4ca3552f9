"""Keyswitch multiply-accumulate: the digit inner product and its one-digit
step.

Counterpart of ``openfhe_tpu/ops/elementwise_pallas.py`` (``fused_mac_mod``)
and of the inner product loop of ``openfhe_tpu/keyswitch.py:368-396``.

* ``ks_inner_product(digits, key_b, key_a, rows, mod)``: for each output row
  r, acc[0, r] = sum_d digits[d, r] * key_b[d, rows[r]] mod q_r and acc[1]
  the same with key_a — the whole digit loop in one kernel pass, both halves
  in one [2, R, n] tensor so the mod-down that follows is one batch.
* ``fused_mac_mod(x, y, acc, mod)``: (acc + x*y) mod q over [R, n], the
  Pallas kernel's exact contract.

Both launch ``csrc/mac.cu`` for CUDA tensors and run the plain twins
(``*_plain``: ``mul_mod`` + ``add_mod`` chains) for CPU tensors.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import torch

from .. import _build
from .modular import ModConsts, add_mod, check_reduced, mul_mod

# The kernels sum products < q^2 < 2^124 (q < 2^62) in 128 bits, lazily:
# up to 15 of them (plus an addend < q) cannot overflow.
MAX_DIGITS = 15


@lru_cache(maxsize=None)
def _rows_tensor(rows: tuple, device: str) -> torch.Tensor:
    """Key-row index on the device, cached: building it per call would be a
    synchronous host-to-device copy on every keyswitch."""
    return torch.tensor(rows, dtype=torch.int64, device=device)


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


def ks_inner_product_plain(digits, key_b, key_a, rows, mod: ModConsts):
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
    return torch.stack([acc0, acc1])


def ks_inner_product(digits: torch.Tensor, key_b: torch.Tensor,
                     key_a: torch.Tensor, rows: Sequence[int],
                     mod: ModConsts):
    """[2, R, n]: sum_d digits[d] * key_b[d, rows] and sum_d digits[d] *
    key_a[d, rows], mod q per row. digits: [ndig, R, n]; key_b, key_a:
    [dnum, Lfull+K, n] with dnum >= ndig; rows: the R active key rows; mod:
    [R, 1] constants."""
    ndig, R, n = digits.shape
    rows = tuple(int(r) for r in rows)
    if key_b.shape != key_a.shape or key_b.dim() != 3 or \
            key_b.shape[0] < ndig or key_b.shape[2] != n or len(rows) != R \
            or not all(0 <= r < key_b.shape[1] for r in rows):
        raise ValueError("ks_inner_product: digits [ndig, R, n] do not match "
                         "keys [dnum, rows, n] and the row list")
    rows_t = _rows_tensor(rows, str(digits.device))
    check_reduced(digits, mod.q, "ks_inner_product")
    if digits.device.type == "cpu":
        return ks_inner_product_plain(digits, key_b, key_a, rows_t, mod)
    if ndig > MAX_DIGITS:
        raise ValueError(f"{ndig} digits overflow the 128-bit accumulator")
    consts = _row_consts(mod, R)
    digits, key_b, key_a = (digits.contiguous(), key_b.contiguous(),
                            key_a.contiguous())
    _build.require_cuda("ks_inner_product", digits, key_b, key_a, rows_t,
                        *consts)
    out = torch.empty((2, R, n), dtype=torch.int64, device=digits.device)
    _build.check("ks_inner_product", _build.library().ks_inner_product(
        digits.data_ptr(), key_b.data_ptr(), key_a.data_ptr(),
        rows_t.data_ptr(), ndig, R, key_b.shape[1], n,
        *[c.data_ptr() for c in consts], out[0].data_ptr(),
        out[1].data_ptr(), _build.stream()))
    ks_inner_product.launches += 1
    return out


fused_mac_mod.launches = 0
ks_inner_product.launches = 0
