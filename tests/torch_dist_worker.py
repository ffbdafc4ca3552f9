"""One rank of the port's multi-rank checks, run as its own process by
``tests/test_torch_parallel.py`` (gloo on the CPU):

    python tests/torch_dist_worker.py RANK WORLD TOWER_PAR INIT_FILE OUT_DIR \
        [BACKEND]

BACKEND is gloo (the default: CPU tensors) or nccl (rank r on card r, so
WORLD cards); the saved tensors are on the CPU either way, so an NCCL run's
files compare with a gloo run's.

It imports the port and torch only, never jax, so the ranks start quickly
and stay independent of the JAX package. Each rank builds the same inputs
from fixed seeds, runs the distributed four-step NTT, the explicit
collectives, the mesh helpers and a CKKS MultRelin + rescale routed through
``dcrt.set_distributed_ntt``, and saves what it got to OUT_DIR/rank<R>.pt
for the test process to compare with the JAX package and the port's
single-rank functions.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from openfhe_tpu_torch import dcrt
from openfhe_tpu_torch.models import ckks
from openfhe_tpu_torch.parallel import collectives, dntt, mesh as mesh_mod
from openfhe_tpu_torch.utils import nbtheory

N1, N2 = 32, 16                     # n = 512: n1 = 32 columns, n2 = 16
N = N1 * N2
LEADS = ((), (3,))                  # [2, 512] and a batch [3, 2, 512]
CKKS = dict(ring_dim=N, mult_depth=2, scaling_mod_size=50,
            first_mod_size=55, dnum=2)
CKKS_SEED = 17


def moduli():
    return tuple(nbtheory.generate_prime_chain(2, 55, N))


def residues(mods, lead, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, q, size=lead + (N,), dtype=np.uint64)
            for q in mods]
    return torch.from_numpy(np.stack(cols, axis=-2).astype(np.int64))


def psum_partials():
    return torch.from_numpy(np.random.default_rng(2).integers(
        0, 1 << 20, size=(4, 64)).astype(np.int64))


def ckks_inputs(device="cpu"):
    """Context, relinearization key and two ciphertexts from CKKS_SEED."""
    rng = np.random.default_rng(CKKS_SEED)
    ctx = ckks.gen_context(ckks.CKKSParams(**CKKS), device)
    pk, sk = ckks.keygen(ctx, rng)
    evk = ckks.relin_keygen(ctx, sk, rng)
    ct1 = ckks.encrypt(ctx, pk, rng.uniform(-1, 1, N // 2), rng)
    ct2 = ckks.encrypt(ctx, pk, rng.uniform(-1, 1, N // 2), rng)
    return ctx, evk, ct1, ct2


def ckks_step(ctx, evk, ct1, ct2):
    return ckks.rescale_ctx(ctx, ckks.eval_mult_relin(ct1, ct2, evk))


def run(rank, world, tower_par, init_file, backend):
    device = torch.device("cpu")
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = compute(mesh_mod.make_mesh(tower_par=tower_par), device)
        return {k: [t.cpu() for t in v] if isinstance(v, list) else
                v.cpu() if isinstance(v, torch.Tensor) else v
                for k, v in out.items()}
    finally:
        dist.destroy_process_group()


def compute(mesh, device):
    mods = moduli()
    out = {"shape": tuple(mesh.shape)}
    for i, lead in enumerate(LEADS):
        x = residues(mods, lead, seed=i).to(device)
        y = dntt.four_step_forward(x, N1, N2, mods, mesh=mesh)
        out[f"forward{i}"] = y
        out[f"inverse{i}"] = dntt.four_step_inverse(y, N1, N2, mods,
                                                    mesh=mesh)
    x = residues(mods, (), seed=0).to(device)
    out["shard_map"] = collectives.four_step_forward_shard_map(x, mods, mesh)
    out["psum"] = collectives.tower_psum(psum_partials().to(device), mesh)
    block = mesh_mod.shard_poly(x, mesh)
    out["block"] = block
    out["gathered"] = mesh_mod.gather_poly(block, mesh, x.shape)
    digits = torch.stack([x, x + 1, x + 2])              # [dnum, L, n]
    spec = mesh_mod.digit_sharding(mesh)
    out["digits"] = mesh_mod.gather(mesh_mod.shard(digits, mesh, spec),
                                    mesh, spec)
    tree = mesh_mod.shard_poly_pytree({"p": [x, x[0]]}, mesh)
    out["tree"] = tree["p"]
    out["layouts"] = (mesh_mod.poly_sharding(mesh), mesh_mod.replicated(mesh))

    ctx, evk, ct1, ct2 = ckks_inputs(device)
    out["unrouted"] = [p.data for p in ckks_step(ctx, evk, ct1, ct2).polys]
    dcrt.set_distributed_ntt(mesh, min_n=N)
    try:
        out["routed"] = [p.data for p in ckks_step(ctx, evk, ct1, ct2).polys]
        calls = (dntt.four_step_forward.distributed_calls,
                 dntt.four_step_inverse.distributed_calls)
        ckks.eval_mult_relin(ct1, ct2, evk)   # one key switch, routed
        out["mult_relin_calls"] = (
            dntt.four_step_forward.distributed_calls - calls[0],
            dntt.four_step_inverse.distributed_calls - calls[1])
    finally:
        dcrt.set_distributed_ntt(None)
    return out


def main(argv):
    rank, world, tower_par = (int(a) for a in argv[1:4])
    init_file, out_dir = argv[4:6]
    backend = argv[6] if len(argv) > 6 else "gloo"
    torch.set_num_threads(1)
    torch.save(run(rank, world, tower_par, init_file, backend),
               f"{out_dir}/rank{rank}.pt")


if __name__ == "__main__":
    main(sys.argv)
