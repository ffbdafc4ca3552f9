"""Distributed (four-step) negacyclic NTT over a ("tower", "coeff") mesh.

Counterpart of ``openfhe_tpu/parallel/dntt.py``. The reference's only
parallelism for the NTT is OpenMP across towers (SURVEY §2.7/§5: "host is
the interconnect"). Here the coefficient axis itself is split: with
n = n1*n2,

  1. column NTTs of size n1 (local: each rank holds whole columns),
  2. an exact elementwise twist (precomputed [n1, n2] constants),
  3. a global transpose: ONE ``all_to_all_single`` over the mesh's coeff
     group re-blocks the columns onto rows,
  4. row NTTs of size n2 (local again).

Derivation: with e = e1 + 2*n1*u (odd exponents mod 2n), the inner sum over
j1 is itself a size-n1 negacyclic NTT (root psi^n2); the outer sum over j2
becomes a size-n2 negacyclic NTT (root psi^n1) after twisting by
psi^(e1(c1)*j2) * psi2^(-j2), using the identity cyclic_DFT(v)[rev(c)] =
negacyclic(v * psi2^(-j)).

Order contract: output slot (c1, c2) holds the transform value with exponent
e1(c1) + 2*n1*rev_n2(c2) = 2*rev_n(c1*n2 + c2) + 1, i.e. row-major four-step
output **is exactly** ``ntt.forward``'s bit-reversed order (verified by
``output_perm`` being the identity and by the bit-equality tests).
``four_step_forward`` / ``four_step_inverse`` are therefore drop-in
replacements for ``ops.ntt.forward`` / ``inverse``, bit-exact.

The size-n1 and size-n2 transforms are the port's NTT (the CUDA kernel for
a CUDA tensor, its plain twin for a CPU tensor); the twist is a plain torch
Shoup product. With no mesh the four steps run locally. With a mesh the data
comes in whole on every rank and goes out whole on every rank: each rank
transforms its n2/d columns (and its block of towers, where the tower count
divides the mesh's tower axis), the all-to-all moves the blocks, each rank
transforms its n1/d rows, and all-gathers over the coeff and then the tower
group return the whole output. So ``dcrt`` can route any transform through
it without the scheme code changing.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import ntt
from ..ops.modular import mul_mod_shoup, shoup_precon_int, u64_array
from ..ops.ntt import bit_reverse_perm, split_factors  # noqa: F401
from ..utils import nbtheory
from . import mesh as mesh_mod


@lru_cache(maxsize=None)
def _twist_ints(n1: int, n2: int, q: int):
    """(twist, precon, inverse twist, precon) of one modulus, each [n1][n2]
    Python ints."""
    n = n1 * n2
    rev1 = bit_reverse_perm(n1)
    psi = nbtheory.root_of_unity(2 * n, q)
    rows, prow, irows, iprow = [], [], [], []
    for c1 in range(n1):
        e1 = 2 * int(rev1[c1]) + 1
        base, pbase, ibase, ipbase = [], [], [], []
        step = pow(psi, (e1 - n1) % (2 * n), q)
        istep = pow(step, -1, q)
        v, vi = 1, 1
        for _ in range(n2):
            base.append(v)
            pbase.append(shoup_precon_int(v, q))
            ibase.append(vi)
            ipbase.append(shoup_precon_int(vi, q))
            v = v * step % q
            vi = vi * istep % q
        rows.append(base)
        prow.append(pbase)
        irows.append(ibase)
        iprow.append(ipbase)
    return rows, prow, irows, iprow


def twist_values(n1: int, n2: int, moduli: tuple):
    """Exact twist constants for the four-step factorization, as nested int
    lists laid out [L][n1][n2] (row c1, column j2):

        T[c1][j2] = psi^(e1(c1)*j2) * psi2^(-j2),   psi2 = psi^n1,

    with e1(c1) = 2*rev_n1(c1) + 1 (the order contract of the size-n1
    stage NTT, exponents of psi1 = psi^n2). Returns (twist, twist_precon,
    inv_twist, inv_twist_precon)."""
    per_q = [_twist_ints(n1, n2, int(q)) for q in moduli]
    return tuple([t[i] for t in per_q] for i in range(4))


@lru_cache(maxsize=None)
def _twist_array(n1: int, n2: int, q: int) -> np.ndarray:
    return u64_array(_twist_ints(n1, n2, q))          # [4, n1, n2]


@lru_cache(maxsize=None)
def _tables(n1: int, n2: int, moduli: tuple, device: str) -> torch.Tensor:
    """[4, n2, L, n1]: twist, precon, inverse twist, precon, laid out as
    the column blocks of steps 1-2."""
    arr = np.stack([_twist_array(n1, n2, q) for q in moduli], axis=1)
    return torch.from_numpy(
        np.ascontiguousarray(arr.transpose(0, 3, 1, 2))).to(device)


def tables(n1: int, n2: int, moduli, device) -> torch.Tensor:
    return _tables(n1, n2, tuple(int(q) for q in moduli),
                   str(torch.device(device)))


@lru_cache(maxsize=None)
def output_perm(n1: int, n2: int) -> np.ndarray:
    """Mapping from ntt.forward slot order to four-step row-major (c1, c2)
    order. This is the IDENTITY (see module docstring); kept as an
    executable proof used by the tests."""
    n = n1 * n2
    rev1 = bit_reverse_perm(n1)
    rev2 = bit_reverse_perm(n2)
    rev_n = bit_reverse_perm(n)
    # slot (c1, c2) holds exponent e1(c1) + 2*n1*rev2(c2)
    exp_to_pos = {}
    for c1 in range(n1):
        e1 = 2 * int(rev1[c1]) + 1
        for c2 in range(n2):
            e = (e1 + 2 * n1 * int(rev2[c2])) % (2 * n)
            exp_to_pos[e] = c1 * n2 + c2
    perm = np.zeros(n, dtype=np.int64)
    for j in range(n):
        e_j = 2 * int(rev_n[j]) + 1
        perm[j] = exp_to_pos[e_j]
    return perm


class Split(NamedTuple):
    """One mesh axis a four-step splits over: its group, this rank's
    coordinate on it, and its size."""

    group: object
    rank: int
    size: int


def axis_split(mesh, axis: str) -> Split:
    if not dist.is_initialized():
        raise RuntimeError(
            "the distributed NTT needs an initialised process group "
            "(torch.distributed.init_process_group); it does not fall back "
            "to the local NTT")
    return Split(mesh.get_group(axis), mesh.get_local_rank(axis),
                 mesh_mod.axis_size(mesh, axis))


def _mesh_splits(x: torch.Tensor, mesh):
    """The coeff split, and the tower split where the tower count divides
    the tower axis (else the towers are replicated)."""
    coeff = axis_split(mesh, "coeff")
    tower = axis_split(mesh, "tower")
    return coeff, (tower if x.shape[-2] % tower.size == 0 else None)


def _all_to_all(x: torch.Tensor, split: Split, blocks: int) -> torch.Tensor:
    """Split the last axis of x [b, ..., m] into `size` blocks, send block i
    to rank i of the group, and stack what comes back along axis 0:
    [size * b, ..., m / size] (sender s's rows first for s = 0, 1, ...)."""
    send = x.reshape(x.shape[:-1] + (split.size, blocks)).movedim(-2, 0)
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=split.group)
    return recv.reshape((-1,) + recv.shape[2:])


def _all_gather(x: torch.Tensor, split: Split, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(split.size)]
    dist.all_gather(parts, x.contiguous(), group=split.group)
    return torch.cat(parts, dim=dim)


def _expand(t: torch.Tensor, extra: int) -> torch.Tensor:
    """Twist table [b, L, n1] -> [b, 1…1, L, n1] for batch broadcasting."""
    return t.reshape(t.shape[:1] + (1,) * extra + t.shape[1:])


def _towers(x, moduli, tower: Split | None):
    if tower is None:
        return x, tuple(moduli), slice(None)
    b = x.shape[-2] // tower.size
    sl = slice(tower.rank * b, (tower.rank + 1) * b)
    return x[..., sl, :], tuple(moduli[sl]), sl


def _blocks(n1: int, n2: int, coeff: Split | None):
    """(this rank's coordinate, rows a rank, columns a rank)."""
    d, c = (coeff.size, coeff.rank) if coeff else (1, 0)
    if n1 % d or n2 % d:
        raise ValueError(f"n1 = {n1}, n2 = {n2} do not divide {d} ranks")
    return c, n1 // d, n2 // d


def forward_over(x: torch.Tensor, n1: int, n2: int, moduli,
                 coeff: Split | None, tower: Split | None) -> torch.Tensor:
    """The four-step forward NTT of the whole x [..., L, n] with the work
    split over `coeff` (columns, then rows) and `tower` (None: not split);
    every rank returns the whole result."""
    c, b1, b2 = _blocks(n1, n2, coeff)
    xs, mods, sl = _towers(x, moduli, tower)
    lead = xs.shape[:-1]
    extra = len(lead) - 1
    tw = tables(n1, n2, moduli, x.device)[:, c * b2:(c + 1) * b2, sl]
    q = tw.new_tensor(list(mods)).reshape(-1, 1)
    # [..., L, n1, n2] -> my columns [b2, ..., L, n1]
    g = xs.reshape(lead + (n1, n2))[..., c * b2:(c + 1) * b2]
    g = ntt.forward(g.movedim(-1, 0).contiguous(), mods)
    g = mul_mod_shoup(g, _expand(tw[0], extra), _expand(tw[1], extra), q)
    if coeff:                     # -> [n2, ..., L, b1]: my rows
        g = _all_to_all(g, coeff, b1)
    h = ntt.forward(g.transpose(0, -1).contiguous(), mods)   # [b1, ..., n2]
    if coeff:
        h = _all_gather(h, coeff, 0)
    out = h.movedim(0, -2).reshape(lead + (n1 * n2,))
    return _all_gather(out, tower, -2) if tower else out


def inverse_over(y: torch.Tensor, n1: int, n2: int, moduli,
                 coeff: Split | None, tower: Split | None) -> torch.Tensor:
    """Inverse of ``forward_over``: undo the row NTTs, transpose, untwist,
    undo the column NTTs. The 1/n scaling comes out of the two stage
    inverses (1/n2 * 1/n1)."""
    c, b1, b2 = _blocks(n1, n2, coeff)
    ys, mods, sl = _towers(y, moduli, tower)
    lead = ys.shape[:-1]
    extra = len(lead) - 1
    tw = tables(n1, n2, moduli, y.device)[:, c * b2:(c + 1) * b2, sl]
    q = tw.new_tensor(list(mods)).reshape(-1, 1)
    # [..., L, n1, n2] -> my rows [b1, ..., L, n2]
    h = ys.reshape(lead + (n1, n2))[..., c * b1:(c + 1) * b1, :]
    h = ntt.inverse(h.movedim(-2, 0).contiguous(), mods)
    if coeff:                     # -> [n1, ..., L, b2]: my columns
        h = _all_to_all(h, coeff, b2)
    g = h.transpose(0, -1)                                     # [b2, ..., n1]
    g = mul_mod_shoup(g, _expand(tw[2], extra), _expand(tw[3], extra), q)
    g = ntt.inverse(g.contiguous(), mods)
    if coeff:
        g = _all_gather(g, coeff, 0)
    out = g.movedim(0, -1).reshape(lead + (n1 * n2,))
    return _all_gather(out, tower, -2) if tower else out


def four_step_forward(x: torch.Tensor, n1: int, n2: int, moduli,
                      mesh=None) -> torch.Tensor:
    """x: [..., L, n] natural-order coefficients -> same shape, evaluations
    in ``ntt.forward``'s slot order (bit-exact). With a mesh, the work is
    split over it and the result comes back whole on every rank."""
    if mesh is None:
        return forward_over(x, n1, n2, moduli, None, None)
    four_step_forward.distributed_calls += 1
    return forward_over(x, n1, n2, moduli, *_mesh_splits(x, mesh))


def four_step_inverse(y: torch.Tensor, n1: int, n2: int, moduli,
                      mesh=None) -> torch.Tensor:
    """Exact inverse of four_step_forward (== ntt.inverse bit-exactly)."""
    if mesh is None:
        return inverse_over(y, n1, n2, moduli, None, None)
    four_step_inverse.distributed_calls += 1
    return inverse_over(y, n1, n2, moduli, *_mesh_splits(y, mesh))


four_step_forward.distributed_calls = 0
four_step_inverse.distributed_calls = 0


def standard_order(result: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """Identity passthrough kept for API compatibility: four-step row-major
    output already matches ntt.forward's slot order (output_perm proof)."""
    assert np.array_equal(output_perm(n1, n2), np.arange(n1 * n2))
    return result
