"""Double-CRT (RNS) polynomials as int64 tensors.

Counterpart of ``openfhe_tpu/dcrt.py``. A polynomial over the basis
{q_0..q_{L-1}} at ring dimension n is one int64 tensor [L, n] of reduced
residues plus a hashable basis and a COEFF/EVAL format flag. Elementwise ops
broadcast over the tower axis; ``to_eval``/``to_coeff`` are the NTT
wrappers (CUDA kernel on the card, plain twin on the CPU), routed through the
distributed four-step NTT when ``set_distributed_ntt`` is given a mesh.
Constant tables are cached per (basis, device).
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from . import _build
from .ops import automorph, elementwise, modular, ntt
from .ops.modular import ModConsts
from .parallel import dntt
from .utils import sampling


class Format(str, Enum):
    COEFF = "coeff"
    EVAL = "eval"


@dataclasses.dataclass(frozen=True)
class RnsBasis:
    """Hashable descriptor of an RNS basis."""

    n: int
    moduli: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "moduli", tuple(int(q) for q in self.moduli))

    @property
    def L(self) -> int:
        return len(self.moduli)

    def mod(self, device) -> ModConsts:
        """[L, 1] modulus constants on `device`."""
        return modular.make_mod_consts(self.moduli, device)

    def drop_last(self, k: int = 1) -> "RnsBasis":
        return RnsBasis(self.n, self.moduli[:-k])


@dataclasses.dataclass(frozen=True, eq=False)
class RnsPoly:
    """A polynomial in Z_Q[x]/(x^n+1), RNS form: data is int64 [L, n]."""

    data: torch.Tensor
    basis: RnsBasis
    fmt: Format

    @property
    def device(self) -> torch.device:
        return self.data.device

    def with_data(self, data: torch.Tensor,
                  fmt: Format | None = None) -> "RnsPoly":
        return RnsPoly(data, self.basis, fmt or self.fmt)


def rows_tensor(rows, device) -> torch.Tensor:
    """Reduced residue rows (numpy uint64/int64 or nested Python ints, all
    below 2^62) -> int64 tensor on `device`."""
    return torch.from_numpy(np.asarray(rows, dtype=np.int64)).to(device)


def make_poly(basis: RnsBasis, data: torch.Tensor, fmt: Format) -> RnsPoly:
    """Wrap residues [L, n]; a tower slice of a stacked tensor is made
    contiguous here, since the kernels take contiguous tensors only."""
    assert tuple(data.shape) == (basis.L, basis.n), "shape is not [L, n]"
    return RnsPoly(data.contiguous(), basis, fmt)


def zero_poly(basis: RnsBasis, fmt: Format = Format.EVAL,
              device=None) -> RnsPoly:
    """The zero polynomial on `device` (None: the current CUDA device)."""
    return RnsPoly(torch.zeros((basis.L, basis.n), dtype=torch.int64,
                               device=_build.resolve_device(device)),
                   basis, fmt)


def from_int_rows(basis: RnsBasis, rows, fmt: Format, device) -> RnsPoly:
    return RnsPoly(rows_tensor(rows, device), basis, fmt)


def from_signed(basis: RnsBasis, coeffs, device) -> RnsPoly:
    """Signed integer coefficients (secrets, errors, floods) -> EVAL poly
    over `basis` on `device`."""
    rows = sampling.signed_to_rns_rows(coeffs, basis.moduli)
    return to_eval(from_int_rows(basis, rows, Format.COEFF, device))


def to_int_rows(p: RnsPoly) -> np.ndarray:
    return p.data.cpu().numpy()


# ---------------------------------------------------------------------------
# Elementwise algebra (either format; operands must match)
# ---------------------------------------------------------------------------


def _check(a: RnsPoly, b: RnsPoly):
    assert a.basis == b.basis, "RNS basis mismatch"
    assert a.fmt == b.fmt, "format mismatch"


def add(a: RnsPoly, b: RnsPoly) -> RnsPoly:
    _check(a, b)
    q = a.basis.mod(a.device).q
    return a.with_data(modular.add_mod(a.data, b.data, q))


def sub(a: RnsPoly, b: RnsPoly) -> RnsPoly:
    _check(a, b)
    q = a.basis.mod(a.device).q
    return a.with_data(modular.sub_mod(a.data, b.data, q))


def neg(a: RnsPoly) -> RnsPoly:
    return a.with_data(modular.neg_mod(a.data, a.basis.mod(a.device).q))


def mul(a: RnsPoly, b: RnsPoly) -> RnsPoly:
    """Elementwise product; the ring product only in EVAL format."""
    _check(a, b)
    return a.with_data(modular.mul_mod(a.data, b.data, a.basis.mod(a.device)))


def mul_add(a: RnsPoly, b: RnsPoly, acc: RnsPoly) -> RnsPoly:
    """acc + a*b in one pass (the fused_mac_mod kernel on the card)."""
    _check(a, b)
    _check(a, acc)
    return acc.with_data(elementwise.fused_mac_mod(
        a.data, b.data, acc.data, a.basis.mod(a.device)))


@lru_cache(maxsize=None)
def _tower_const(moduli: tuple, consts: tuple, device: str):
    return modular.shoup_consts(consts, moduli, device)


def tower_const(basis: RnsBasis, consts, device) -> tuple:
    """Per-tower constants (each below its modulus) as an [L, 1] tensor
    and its Shoup precons on `device`, cached."""
    return _tower_const(basis.moduli, tuple(int(c) for c in consts),
                        str(torch.device(device)))


def mul_tower_const(a: RnsPoly, consts) -> RnsPoly:
    """Multiply tower i by consts[i] (Shoup)."""
    cc, pre = tower_const(a.basis, consts, a.device)
    return a.with_data(modular.mul_mod_shoup(a.data, cc, pre,
                                             a.basis.mod(a.device).q))


def mul_scalar_int(a: RnsPoly, c: int) -> RnsPoly:
    """Multiply by a plain integer (reduced per tower, Shoup)."""
    return mul_tower_const(a, [int(c) % q for q in a.basis.moduli])


# ---------------------------------------------------------------------------
# Format switching and automorphisms
# ---------------------------------------------------------------------------


def to_eval(a: RnsPoly) -> RnsPoly:
    if a.fmt == Format.EVAL:
        return a
    return a.with_data(ntt_forward_data(a.basis, a.data), fmt=Format.EVAL)


def to_coeff(a: RnsPoly) -> RnsPoly:
    if a.fmt == Format.COEFF:
        return a
    return a.with_data(ntt_inverse_data(a.basis, a.data), fmt=Format.COEFF)


# --- distributed-NTT routing -------------------------------------------------
#
# Opt-in: set_distributed_ntt(mesh) makes every to_eval/to_coeff and every
# ntt_forward_data/ntt_inverse_data at ring dimension >= min_n run the
# four-step NTT split over the mesh's ranks (parallel/dntt.py: one
# all-to-all at the transpose, the whole result on every rank) instead of
# the one-launch transform. Both are bit-exact and share the slot-order
# contract, so the schemes need no change. With no mesh set the launches and
# bits are those of ops.ntt.

_DNTT_CFG = {"mesh": None, "min_n": 4096}


def set_distributed_ntt(mesh, min_n: int = 4096) -> None:
    """Route the NTTs of ring dimension >= min_n over a ("tower", "coeff")
    mesh (``parallel.mesh.make_mesh``; None resets). Every rank must make
    the same calls: each routed transform is a collective over the mesh,
    and it raises, rather than run locally, once the process group is gone.

    The answer to the butterfly-stage data dependence the reference
    handles only on the host (transformnat-impl.h:197-238; SURVEY §2.7
    "host is the interconnect")."""
    _DNTT_CFG["mesh"] = mesh
    _DNTT_CFG["min_n"] = min_n


def _routed_mesh(basis: RnsBasis):
    mesh = _DNTT_CFG["mesh"]
    return mesh if mesh is not None and basis.n >= _DNTT_CFG["min_n"] \
        else None


def ntt_forward_data(basis: RnsBasis, data: torch.Tensor) -> torch.Tensor:
    """Forward NTT of raw residues [..., L, n] over `basis`, through the
    distributed four-step when ``set_distributed_ntt`` routes this ring
    dimension, else the NTT kernel (its twin on the CPU)."""
    mesh = _routed_mesh(basis)
    if mesh is None:
        return ntt.forward(data, basis.moduli)
    n1, n2 = dntt.split_factors(basis.n)
    return dntt.four_step_forward(data, n1, n2, basis.moduli, mesh=mesh)


def ntt_inverse_data(basis: RnsBasis, data: torch.Tensor) -> torch.Tensor:
    """Inverse NTT of raw residues [..., L, n] (see ntt_forward_data)."""
    mesh = _routed_mesh(basis)
    if mesh is None:
        return ntt.inverse(data, basis.moduli)
    n1, n2 = dntt.split_factors(basis.n)
    return dntt.four_step_inverse(data, n1, n2, basis.moduli, mesh=mesh)


def automorphism(a: RnsPoly, k: int) -> RnsPoly:
    if a.fmt == Format.EVAL:
        return a.with_data(automorph.apply_eval(a.data, a.basis.n, k))
    return a.with_data(automorph.apply_coeff(
        a.data, a.basis.mod(a.device).q, a.basis.n, k))
