"""Explicit collectives: the four-step NTT over one mesh axis and the tower
reduction.

Counterpart of ``openfhe_tpu/parallel/collectives.py``, where ``dntt``
leaves the all-to-all to GSPMD and this module writes it out inside
``jax.shard_map``. In the port every collective is written out, so
``four_step_forward_shard_map`` is ``dntt``'s split four-step with the
coefficient blocks over one named axis and the towers whole: one
``all_to_all_single`` for the transpose, then an all-gather of the rows.
``tower_psum`` is an ``all_reduce`` over the tower group. Both are
bit-exact against the single-rank reference
(``tests/test_torch_parallel.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .dntt import axis_split, forward_over, split_factors


def four_step_forward_shard_map(x: torch.Tensor, moduli: tuple, mesh,
                                axis: str = "coeff") -> torch.Tensor:
    """[L, n] natural-order coefficients -> ntt.forward slot order, the
    columns and then the rows split over ``axis``; the whole result on
    every rank."""
    n1, n2 = split_factors(x.shape[-1])
    return forward_over(x, n1, n2, moduli, axis_split(mesh, axis), None)


def tower_psum(partials: torch.Tensor, mesh, axis: str = "tower"
               ) -> torch.Tensor:
    """Sum of partials [L, ...] over axis 0: each rank sums its block of
    the L rows and an ``all_reduce`` over ``axis`` adds the blocks (the
    reference's host-side gather+sum after per-DPU work, done on the
    interconnect). Every rank gets the total."""
    split = axis_split(mesh, axis)
    if partials.shape[0] % split.size:
        raise ValueError(f"{partials.shape[0]} rows do not divide mesh axis "
                         f"{axis} ({split.size})")
    b = partials.shape[0] // split.size
    out = partials[split.rank * b:(split.rank + 1) * b].sum(dim=0)
    dist.all_reduce(out, group=split.group)
    return out
