"""Modular arithmetic over prime moduli below 2^62, on int64 tensors.

Counterpart of ``openfhe_tpu/ops/modular.py``. A residue is one int64
value in [0, q), q < 2^62; the JAX package's uint32 lo/hi limb planes
(``ops/limb.py``) are not needed, and the same code serves the 30-bit
composite chain and the 60-bit chain. Every op returns the unique reduced
residue, so results are bit-equal to the JAX package's 64-bit and 32-bit
paths alike.

torch has no 64x64->128-bit product, so ``mulhi64`` builds the high word
from 32-bit limbs held in int64. Products wrap modulo 2^64 (two's
complement), which is exactly the unsigned low word; logical right shifts
are an arithmetic shift plus a mask. Shoup precons floor(c * 2^64 / q) can
reach 2^64 - 1: tables store their 64-bit pattern as a (possibly negative)
int64, and ``mulhi64`` reads it as unsigned.

These functions are also the plain twins of the CUDA kernels' arithmetic
(``csrc/*.cu`` use ``__umul64hi`` on the same bit patterns).
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import _build

MASK32 = 0xFFFFFFFF
MAX_MODULUS_BITS = 62  # 2q < 2^63: a sum of two residues stays positive


def u64_array(values) -> np.ndarray:
    """(Nested lists of) Python ints in [0, 2^64) -> int64 numpy array of
    their bit patterns (exact: never goes through float; numpy raises
    OverflowError outside the range)."""
    return np.asarray(values, dtype=np.uint64).view(np.int64)


def int_tensor(values, device=None) -> torch.Tensor:
    """``u64_array`` as a tensor on `device` (None: the current CUDA
    device)."""
    return torch.from_numpy(u64_array(values)).to(
        _build.resolve_device(device))


def shoup_precon_int(c: int, q: int) -> int:
    """Host: Shoup precomputation floor(c * 2^64 / q), c < q."""
    assert 0 <= c < q
    return (c << 64) // q


def shoup_consts(values: Sequence[int], moduli: Sequence[int], device
                 ) -> tuple:
    """Per-row constants [len, 1] (each value below its modulus) and their
    Shoup precons, for ``mul_mod_shoup`` against an [len, n] stack."""
    vals = [[int(v)] for v in values]
    pres = [[shoup_precon_int(v, q)] for (v,), q in zip(vals, moduli)]
    return int_tensor(vals, device), int_tensor(pres, device)


class ModConsts(NamedTuple):
    """Per-modulus constants as int64 tensors broadcastable against residue
    data (e.g. [L, 1] for an [L, n] stack)."""

    q: torch.Tensor        # the modulus
    mu: torch.Tensor       # floor(2^64 / q): single-word Barrett constant
    r64: torch.Tensor      # 2^64 mod q
    r64_pre: torch.Tensor  # floor(r64 * 2^64 / q), Shoup precon of r64


def check_modulus(q: int) -> None:
    if not 1 < q < (1 << MAX_MODULUS_BITS):
        raise ValueError(f"modulus {q} must be below 2^{MAX_MODULUS_BITS}")


@lru_cache(maxsize=None)
def _mod_consts(moduli: tuple, trailing_dims: int, device: str) -> ModConsts:
    for q in moduli:
        check_modulus(q)
    shape = (len(moduli),) + (1,) * trailing_dims

    def mk(vals):
        return int_tensor(list(vals), device).reshape(shape)

    mus = [(1 << 64) // q for q in moduli]
    r64s = [(1 << 64) % q for q in moduli]
    pres = [shoup_precon_int(r, q) for r, q in zip(r64s, moduli)]
    return ModConsts(mk(moduli), mk(mus), mk(r64s), mk(pres))


def make_mod_consts(moduli: Sequence[int], device=None,
                    trailing_dims: int = 1) -> ModConsts:
    """Host: ModConsts shaped [L] + [1]*trailing_dims, cached per device
    (None: the current CUDA device)."""
    return _mod_consts(tuple(int(q) for q in moduli), trailing_dims,
                       str(_build.resolve_device(device)))


def checking() -> bool:
    """Whether the debug checks of kernel inputs are on
    (OPENFHE_TPU_TORCH_CHECK=1). Off by default: each costs a
    device-to-host sync."""
    return os.environ.get("OPENFHE_TPU_TORCH_CHECK") == "1"


def check_reduced(x: torch.Tensor, q: torch.Tensor, what: str) -> None:
    """Debug check (``checking()``) that kernel inputs are reduced residues
    in [0, q): the kernels assume it and an unreduced value would silently
    give wrong bits."""
    if not checking():
        return
    if not bool(((x >= 0) & (x < q)).all()):
        raise ValueError(f"{what}: input residues are not reduced below q")


# ---------------------------------------------------------------------------
# 64-bit word arithmetic on int64 bit patterns
# ---------------------------------------------------------------------------


def shr32(x: torch.Tensor) -> torch.Tensor:
    """Logical right shift by 32 of a 64-bit pattern."""
    return (x >> 32) & MASK32


def mulhi64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """High 64 bits of the unsigned 128-bit product a*b (bit patterns)."""
    a0, a1 = a & MASK32, shr32(a)
    b0, b1 = b & MASK32, shr32(b)
    p01 = a0 * b1
    p10 = a1 * b0
    # three terms < 2^32 each: the sum cannot reach the sign bit
    mid = shr32(a0 * b0) + (p01 & MASK32) + (p10 & MASK32)
    return a1 * b1 + shr32(p01) + shr32(p10) + shr32(mid)


def mul64_full(a: torch.Tensor, b: torch.Tensor):
    """Full unsigned 64x64 -> 128-bit product of two bit patterns as
    (lo, hi): lo is the wrapping product, hi is ``mulhi64``."""
    return a * b, mulhi64(a, b)


def limb_sum(parts, limbs: int, bias: int = 0, dim: int = -2) -> list:
    """Exact sum over axis `dim` of unsigned 64-bit words placed at 32-bit
    limb weights, plus a constant `bias`, modulo 2^(32*limbs).

    parts: (tensor of 64-bit patterns, weight in 32-bit limbs) pairs, one
    of them at weight 0. Each word is split into its 32-bit halves, each half
    is summed over `dim` in int64 (fewer than 2^31 words cannot overflow),
    and one carry propagation gives the result as `limbs` int64 tensors of
    32 bits each, lowest first: the integer a chain of 64-bit adds with
    carry gives."""
    cols = [None] * limbs
    for x, w in parts:
        for k, half in ((w, x & MASK32), (w + 1, shr32(x))):
            if k < limbs:
                s = half.sum(dim=dim)
                cols[k] = s if cols[k] is None else cols[k] + s
    out, carry = [], 0
    for k, c in enumerate(cols):
        c = carry if c is None else c + carry
        c = c + ((bias >> (32 * k)) & MASK32)
        out.append(c & MASK32)
        carry = c >> 32
    return out


def join32(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The 64-bit pattern hi * 2^32 + lo of two 32-bit limbs."""
    return lo | (hi << 32)


# ---------------------------------------------------------------------------
# Core ops. Inputs reduced (< q) unless stated; outputs reduced.
# ---------------------------------------------------------------------------


def cond_sub(r: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """r - q if r >= q else r, for 0 <= r < 2q."""
    return torch.where(r >= q, r - q, r)


def add_mod(a, b, q):
    return cond_sub(a + b, q)


def sub_mod(a, b, q):
    d = a - b
    return torch.where(d < 0, d + q, d)


def neg_mod(a, q):
    return torch.where(a == 0, a, q - a)


def barrett_word(x, q, mu):
    """x mod q for ANY 64-bit pattern x, with mu = floor(2^64/q)."""
    h = mulhi64(x, mu)
    return cond_sub(x - h * q, q)


def mul_mod_shoup(x, c, c_pre, q):
    """(x * c) mod q for a constant c < q with Shoup precon c_pre; any
    64-bit x. x*c - h*q lies in [0, 2q) (exact modulo 2^64)."""
    h = mulhi64(x, c_pre)
    return cond_sub(x * c - h * q, q)


def mul_mod(x, y, m: ModConsts):
    """General (x * y) mod q: the 128-bit product H*2^64 + L reduced as
    H*(2^64 mod q) by Shoup plus L by Barrett."""
    t1 = mul_mod_shoup(mulhi64(x, y), m.r64, m.r64_pre, m.q)
    t2 = barrett_word(x * y, m.q, m.mu)
    return add_mod(t1, t2, m.q)


def switch_modulus(a, m_old: ModConsts, m_new: ModConsts):
    """Centered lift-and-reduce: read a in [-q/2, q/2), reduce mod q'
    (values above q/2 stand for negatives, as in the reference's
    NativeVector::SwitchModulus)."""
    big = a > (m_old.q >> 1)
    q_mod_new = barrett_word(m_old.q, m_new.q, m_new.mu)
    diff = neg_mod(q_mod_new, m_new.q)              # (q' - q) mod q'
    shifted = barrett_word(a + diff, m_new.q, m_new.mu)
    small = barrett_word(a, m_new.q, m_new.mu)
    return torch.where(big, shifted, small)
