"""Driver entry points of the port.

entry(): the flagship step, CKKS EvalMult + hybrid-keyswitch
relinearization + rescale at n = 2^12, with its inputs.

dryrun_multichip(n): the same step at n = 256 on an n-rank ("tower",
"coeff") mesh, once with every NTT local and once routed through the
distributed four-step NTT (``dcrt.set_distributed_ntt``), asserting the two
bit-equal. Each rank is a process of its own: gloo ranks on the CPU
(``device="cpu"``) or NCCL ranks, rank r on card r.

    python -m openfhe_tpu_torch.entry [--device cpu] [--dryrun N]
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

from . import _build


def _build_inputs(ring_dim, mult_depth, scaling_mod_size, first_mod_size,
                  dnum, device):
    from .models import ckks

    params = ckks.CKKSParams(ring_dim=ring_dim, mult_depth=mult_depth,
                             scaling_mod_size=scaling_mod_size,
                             first_mod_size=first_mod_size, dnum=dnum)
    ctx = ckks.gen_context(params, device)
    rng = np.random.default_rng(7)
    pk, sk = ckks.keygen(ctx, rng)
    evk = ckks.relin_keygen(ctx, sk, rng)
    v1 = rng.normal(size=8)
    v2 = rng.normal(size=8)
    ct1 = ckks.encrypt(ctx, pk, v1, rng)
    ct2 = ckks.encrypt(ctx, pk, v2, rng)
    return ckks, ctx, ct1, ct2, evk


def entry(device=None):
    """Returns (fn, args): fn(a, b, key) is rescale(eval_mult_relin(a, b,
    key)), args two ciphertexts and the relinearization key on `device`
    (None: the current CUDA device)."""
    ckks, ctx, ct1, ct2, evk = _build_inputs(
        ring_dim=1 << 12, mult_depth=3, scaling_mod_size=50,
        first_mod_size=60, dnum=2, device=device)

    def step(a, b, key):
        return ckks.rescale(ckks.eval_mult_relin(a, b, key))

    return step, (ct1, ct2, evk)


DRYRUN = dict(ring_dim=256, mult_depth=3, scaling_mod_size=40,
              first_mod_size=50, dnum=2)
DRYRUN_TIMEOUT = 300   # seconds for all ranks together


def dryrun_rank(rank: int, world: int, init_file: str, backend: str) -> str:
    """One rank of dryrun_multichip; returns its summary line."""
    import torch
    import torch.distributed as dist

    from . import dcrt
    from .parallel import mesh as pmesh

    device = torch.device("cpu")
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        ckks, ctx, ct1, ct2, evk = _build_inputs(**DRYRUN, device=device)
        mesh = pmesh.make_mesh(world)

        def step(a, b, key):
            return ckks.rescale(ckks.eval_mult_relin(a, b, key))

        out = step(ct1, ct2, evk)
        # second pass: every SwitchFormat/keyswitch NTT through the four-step
        # coefficient-sharded path, bit-equal to the first
        dcrt.set_distributed_ntt(mesh, min_n=DRYRUN["ring_dim"])
        try:
            out_d = step(ct1, ct2, evk)
        finally:
            dcrt.set_distributed_ntt(None)
        if not all(torch.equal(pr.data, po.data)
                   for pr, po in zip(out.polys, out_d.polys)):
            raise AssertionError("the routed step differs from the unrouted "
                                 "one")
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        return (f"dryrun_multichip: ok on {world} devices (mesh {shape}); "
                f"out towers={out.towers}; four-step distributed NTT "
                f"bit-equal")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Runs the step over an n_devices mesh, unrouted and routed, in one
    process per rank, and raises unless every rank found the two equal."""
    import torch

    dev = _build.resolve_device(device)
    backend = "gloo" if dev.type == "cpu" else "nccl"
    if backend == "nccl" and n_devices > torch.cuda.device_count():
        raise ValueError(f"NCCL puts one rank on each card: {n_devices} "
                         f"ranks, {torch.cuda.device_count()} cards")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "openfhe_tpu_torch.entry", "--rank",
             str(r), str(n_devices), os.path.join(tmp, "init"), backend],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(n_devices)]
        try:
            logs = [p.communicate(timeout=DRYRUN_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun_multichip: rank {r} failed:\n{log}")
    print(logs[0].strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--dryrun", type=int, metavar="N")
    ap.add_argument("--rank", nargs=4,
                    metavar=("RANK", "WORLD", "INIT_FILE", "BACKEND"))
    a = ap.parse_args(argv)
    if a.rank:
        import torch
        torch.set_num_threads(1)
        print(dryrun_rank(int(a.rank[0]), int(a.rank[1]), *a.rank[2:]))
    elif a.dryrun:
        dryrun_multichip(a.dryrun, a.device)
    else:
        fn, args = entry(a.device)
        out = fn(*args)
        print(f"entry: rescale(eval_mult_relin) -> {out.towers} towers")


if __name__ == "__main__":
    main()
