"""Host time of one BINFHE AND gate, for a paired comparison.

    python3 openfhe_tpu_torch/bench/gate_host.py [RUNS] [SET]

``openfhe_tpu_torch`` is imported from PYTHONPATH, so one call can time two
trees of the package in turn (parent, change, change, parent). Builds the
context of SET (STD128 by default, STD128_AP or STD128_LMKCDEY) and its keys
on the card, runs two untimed AND gates (a batch of 4 through
``eval_gate_batch`` at STD128 and STD128_AP, as ``profile_ops binfhe`` times
them; one ciphertext through ``eval_gate`` at STD128_LMKCDEY, whose blind
rotation takes one at a time), then RUNS timed ones (default 10), each
ending in a synchronise, then one more under ``torch.profiler`` (as
``profile_ops`` traces) for the kernels a gate launches and the device
time they take. Prints the card's
name and power limit, the median and quartiles in milliseconds, the
kernels and device time, and a last line of JSON. Needs a CUDA device.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch


def main():
    if not torch.cuda.is_available():
        sys.exit("gate_host: no CUDA device")
    from openfhe_tpu_torch.models import binfhe
    from openfhe_tpu_torch.profile_ops import _profile

    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    name = sys.argv[2] if len(sys.argv) > 2 else "STD128"
    if name not in ("STD128", "STD128_AP", "STD128_LMKCDEY"):
        sys.exit("gate_host: SET is STD128, STD128_AP or STD128_LMKCDEY")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(gpu, flush=True)
    ctx = binfhe.gen_context(name)
    rng = np.random.default_rng(61)
    sk = binfhe.keygen(ctx, rng)
    bk = binfhe.bootstrap_keygen(ctx, sk, rng)
    cts = [binfhe.encrypt(ctx, sk, x, rng) for x in (0, 1)]

    if name == "STD128_LMKCDEY":
        def gate():
            return [binfhe.eval_gate(ctx, "AND", bk, *cts)]
        want, batch = [0], 1
    else:
        def gate():
            return binfhe.eval_gate_batch(ctx, "AND", bk, cts * 2,
                                          cts[::-1] + cts)
        want, batch = [x & y for x, y in zip((0, 1) * 2, (1, 0, 0, 1))], 4
    for _ in range(2):
        out = gate()
    got = [binfhe.decrypt(ctx, sk, c) for c in out]
    if got != want:
        sys.exit(f"gate_host: AND gave {got}, not {want}")
    ms = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gate()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    prof = _profile(gate, runs=1)
    kernels, busy_us = int(prof["kernels_per_op"]), prof["device_busy_us"]
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    print(f"{name} AND, B = {batch}: host {med:.3f} ms ({q1:.3f}-{q3:.3f}, "
          f"{runs} runs); {kernels} kernels, {busy_us / 1e3:.3f} ms of "
          f"device time a gate", flush=True)
    print(json.dumps({"gpu": gpu, "set": name, "batch": batch, "runs": runs,
                      "host_ms": ms, "median": med, "q1": q1, "q3": q3,
                      "kernels": kernels, "device_busy_us": busy_us}),
          flush=True)


if __name__ == "__main__":
    main()
