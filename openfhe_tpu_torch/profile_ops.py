"""Where the time of the CKKS main path's evaluated ops goes, on one GPU.

    python3 -m openfhe_tpu_torch.profile_ops

For EvalMult+relinearize, rescale and EvalRotate at n = 2^16 on the 60-bit
chain (8 towers + 3 special primes) and on the composite chain (16 towers of
~30 bits), warm (every table built): the host-clock latency of 30 runs, each
ending in a synchronise (median and quartiles), then a ``torch.profiler``
trace of 10 more runs for the device time a run keeps the card busy, the
kernels it launches, and the share of the hand-written kernels by name.
Then the two passes of the NTT kernel on their own, on a cold L2 (a buffer
several times its size is rewritten before every call): device time of the
column and the row kernel in each direction, and the share of the card's
memory rate each reaches on the bytes it has to move (its tile read and
written once, the twist and its precon read by the pass that applies them).
Last, ``bench/butterfly.cu`` is built and run: the clocks an SM
partition takes to run one warp-wide lazy butterfly with everything in
registers, the integer pipe's real floor for the NTT.
Prints one line per op, per pass and per butterfly and a last line of JSON
with every number. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from . import _build
from .models import ckks
from .ops import ntt

RING_DIM = 1 << 16
TOWERS = 8
TIMED_RUNS = 30
PROFILED_RUNS = 10
HBM_BYTES_PER_S = 3.35e12   # published peak of one H100 SXM
FLUSH_BYTES = 192 << 20     # several times the 50 MB L2
# device kernels of csrc/ by the name the profiler shows
OURS = {"ntt": ("col_pass", "row_pass"),
        "mac": ("ks_inner_product_kernel", "fused_mac_kernel")}


def _host_times(fn) -> list:
    out = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def _profile(fn) -> dict:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_RUNS):
            fn()
        torch.cuda.synchronize()
    busy_us, launches = 0.0, 0
    ours = {k: 0.0 for k in OURS}
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        if not dev or ev.device_type.name != "CUDA":
            continue
        busy_us += dev
        launches += ev.count
        for group, names in OURS.items():
            if any(n in ev.key for n in names):
                ours[group] += dev
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return {"device_busy_us": busy_us / PROFILED_RUNS,
            "kernels_per_op": launches / PROFILED_RUNS,
            **{f"{k}_us": v / PROFILED_RUNS for k, v in ours.items()}}


def profile_chain(label: str, composite_degree: int, seed: int) -> list:
    params = ckks.CKKSParams(ring_dim=RING_DIM, mult_depth=TOWERS - 1,
                             scaling_mod_size=59, first_mod_size=60, dnum=3,
                             composite_degree=composite_degree)
    ctx = ckks.gen_context(params)
    rng = np.random.default_rng(seed)
    pk, sk = ckks.keygen(ctx, rng)
    evk = ckks.relin_keygen(ctx, sk, rng)
    rk = ckks.rot_keygen(ctx, sk, [1], rng)[1]
    n = ctx.n
    ct1 = ckks.encrypt(ctx, pk, rng.uniform(-1, 1, n // 2), rng)
    ct2 = ckks.encrypt(ctx, pk, rng.uniform(-1, 1, n // 2), rng)
    prod = ckks.eval_mult_relin(ct1, ct2, evk)
    res = ckks.rescale_ctx(ctx, prod)
    ops = {"MultRelin": lambda: ckks.eval_mult_relin(ct1, ct2, evk),
           "rescale": lambda: ckks.rescale_ctx(ctx, prod),
           "Rotate": lambda: ckks.eval_rotate(res, 1, rk)}
    rows = []
    for name, fn in ops.items():
        fn()                                   # tables built, caches filled
        ms = _host_times(fn)
        q1, med, q3 = np.percentile(ms, [25, 50, 75])
        row = {"chain": label, "op": name, "host_ms_median": float(med),
               "host_ms_q1": float(q1), "host_ms_q3": float(q3),
               **_profile(fn)}
        row["device_busy_share"] = row["device_busy_us"] / (1e3 * med)
        print(f"{label} {name}: host {med:.3f} ms ({q1:.3f}-{q3:.3f}), "
              f"device busy {row['device_busy_us']:.1f} us "
              f"({100 * row['device_busy_share']:.1f}%), "
              f"{row['kernels_per_op']:.0f} kernels, NTT "
              f"{row['ntt_us']:.1f} us, MAC {row['mac_us']:.1f} us",
              flush=True)
        rows.append(row)
    return rows


def profile_ntt_passes(label: str, moduli: tuple, lead: tuple) -> list:
    """Device time of each pass of forward and inverse at [*lead, L, n] on a
    cold L2, by the kernels' names."""
    from torch.profiler import ProfilerActivity, profile
    n, L = RING_DIM, len(moduli)
    rng = np.random.default_rng(3)
    cols = [rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
            for q in moduli]
    x = torch.from_numpy(np.stack(cols, axis=-2).astype(np.int64)).cuda()
    y = ntt.forward(x, moduli)
    flush = torch.zeros(FLUSH_BYTES // 8, dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_RUNS):
            flush.add_(1)
            ntt.forward(x, moduli)
            flush.add_(1)
            ntt.inverse(y, moduli)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        m = re.search(r"(col|row)_pass_fast<[^>]*(true|false)>", ev.key)
        if not m:
            continue
        us = ev.self_device_time_total / ev.count
        twisted = (m.group(1) == "row") == (m.group(2) == "true")
        nbytes = 16 * x.numel() + (16 * L * n if twisted else 0)
        row = {"shape": label, "pass": m.group(1),
               "direction": "forward" if m.group(2) == "true" else "inverse",
               "cold_us": us, "bytes": nbytes,
               "hbm_share": nbytes / (us * 1e-6) / HBM_BYTES_PER_S}
        print(f"NTT {label} {row['direction']} {row['pass']} pass, cold L2: "
              f"{us:.1f} us for {nbytes / 1e6:.1f} MB, "
              f"{100 * row['hbm_share']:.0f}% of the memory rate", flush=True)
        rows.append(row)
    if len(rows) != 4:
        raise RuntimeError(f"expected 4 NTT pass kernels, found {len(rows)}")
    return rows


def butterfly_clocks() -> dict:
    """Build and run bench/butterfly.cu; clocks per warp-wide butterfly
    on one SM partition, by variant."""
    src = _build.SRC_DIR.parent / "bench" / "butterfly.cu"
    exe = _build.BUILD_DIR / "butterfly"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.nvcc(), *flags, "-o", str(exe), str(src)],
                   check=True, capture_output=True, text=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True).stdout
    clocks = {}
    for line in out.splitlines():
        name, _ms, _, clk, _ = line.split()
        clocks[name] = float(clk)
        print(f"butterfly {name}: {clk} clocks per warp on an SM partition",
              flush=True)
    return clocks


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_ops: no CUDA device")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(gpu, flush=True)
    rows = profile_chain("60-bit", 1, seed=7) + \
        profile_chain("composite", 2, seed=11)
    ctx = ckks.gen_context(ckks.CKKSParams(
        ring_dim=RING_DIM, mult_depth=TOWERS - 1, scaling_mod_size=59,
        first_mod_size=60, dnum=3))
    qp = ctx.q_moduli + ctx.p_moduli
    passes = profile_ntt_passes("[8, 65536]", ctx.q_moduli, ()) + \
        profile_ntt_passes("[3, 11, 65536]", qp, (3,))
    print(json.dumps({"gpu": gpu, "ops": rows, "ntt_passes": passes,
                      "butterfly_clocks": butterfly_clocks()}),
          flush=True)


if __name__ == "__main__":
    main()
