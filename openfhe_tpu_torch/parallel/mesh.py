"""Device mesh over ``torch.distributed`` for RNS-FHE workloads.

Counterpart of ``openfhe_tpu/parallel/mesh.py``. It replaces the reference's
two parallelism mechanisms (OpenMP tower loops and the host->DPU
scatter/gather offload, SURVEY §2.7) with a 2-D mesh of ranks, one process
per card (NCCL) or per CPU worker (gloo):

* axis "tower": RNS towers are embarrassingly parallel for elementwise ops
  and per-tower NTTs.
* axis "coeff": ring coefficients; elementwise ops split freely, and the
  four-step NTT (``dntt``) trades blocks of them in one all-to-all.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, which the caller initialises. A layout is a
tuple that names, for each dimension of a tensor, the mesh axis it is split
over (None: replicated), the role of JAX's ``PartitionSpec``. Residues are
one int64 tensor ``[..., L, n]``: there are no lo/hi planes, so the JAX
package's ``shard_limbs`` is ``shard_poly`` here. ``shard`` takes this
rank's block of a whole tensor and ``gather`` all-gathers the blocks back.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import torch
import torch.distributed as dist

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

AXES = ("tower", "coeff")


def make_mesh(n_devices: int | None = None,
              tower_par: int | None = None) -> DeviceMesh:
    """Build a ("tower", "coeff") mesh over the ranks of the initialised
    default process group (NCCL: the ranks' cards; gloo: CPU ranks).

    tower_par defaults to the largest power-of-two <= min(4, n_devices)
    that divides it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    nd = dist.get_world_size()
    if n_devices is not None and n_devices != nd:
        raise ValueError(f"the mesh spans every rank: {n_devices} devices "
                         f"asked for, world size {nd}")
    if tower_par is None:
        tower_par = 1
        while tower_par * 2 <= min(4, nd) and nd % (tower_par * 2) == 0:
            tower_par *= 2
    if nd % tower_par:
        raise ValueError(f"tower_par {tower_par} does not divide {nd} ranks")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (tower_par, nd // tower_par),
                            mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def poly_sharding(mesh: DeviceMesh, shape: Sequence[int] | None = None
                  ) -> tuple:
    """Layout of [..., L, n] tower-major polynomial residues.

    With a shape, axes that do not divide the mesh axis stay replicated
    (as ``shard_poly_pytree``, so helpers never fail on small tower
    counts)."""
    if shape is None:
        return ("tower", "coeff")
    spec = [None] * len(shape)
    if shape[-1] % axis_size(mesh, "coeff") == 0:
        spec[-1] = "coeff"
    if len(shape) >= 2 and shape[-2] % axis_size(mesh, "tower") == 0:
        spec[-2] = "tower"
    return tuple(spec)


def digit_sharding(mesh: DeviceMesh) -> tuple:
    """Layout of [dnum, L, n] stacked keyswitch keys."""
    return (None, "tower", "coeff")


def replicated(mesh: DeviceMesh) -> tuple:
    return ()


def _dims(x: torch.Tensor, spec: tuple):
    """(dim, axis) of each split dimension; spec aligns with the last
    dimensions of x."""
    off = x.dim() - len(spec)
    return [(off + i, ax) for i, ax in enumerate(spec) if ax is not None]


def shard(x: torch.Tensor, mesh: DeviceMesh, spec: tuple) -> torch.Tensor:
    """This rank's block of the whole tensor x under layout `spec`."""
    for dim, ax in _dims(x, spec):
        size = axis_size(mesh, ax)
        if x.shape[dim] % size:
            raise ValueError(f"dimension {dim} ({x.shape[dim]}) does not "
                             f"divide mesh axis {ax} ({size})")
        b = x.shape[dim] // size
        x = x.narrow(dim, mesh.get_local_rank(ax) * b, b)
    return x.contiguous()


def gather(block: torch.Tensor, mesh: DeviceMesh, spec: tuple
           ) -> torch.Tensor:
    """The whole tensor, on every rank, from each rank's block."""
    for dim, ax in _dims(block, spec):
        parts = [torch.empty_like(block)
                 for _ in range(axis_size(mesh, ax))]
        dist.all_gather(parts, block.contiguous(), group=mesh.get_group(ax))
        block = torch.cat(parts, dim=dim)
    return block


def shard_poly(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's tower/coeff block of [..., L, n] where the dimensions
    divide the mesh axes; non-divisible axes replicate."""
    return shard(x, mesh, poly_sharding(mesh, x.shape))


def gather_poly(block: torch.Tensor, mesh: DeviceMesh,
                shape: Sequence[int]) -> torch.Tensor:
    """Inverse of ``shard_poly`` for a whole tensor of `shape`."""
    return gather(block, mesh, poly_sharding(mesh, shape))


def shard_poly_pytree(tree, mesh: DeviceMesh):
    """``shard_poly`` on every tensor leaf of 2 or more dimensions in
    nested lists, tuples and dicts; other leaves are replicated as they
    are."""
    if isinstance(tree, torch.Tensor):
        return shard_poly(tree, mesh) if tree.dim() >= 2 else tree
    if isinstance(tree, dict):
        return {k: shard_poly_pytree(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [shard_poly_pytree(v, mesh) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return tree
