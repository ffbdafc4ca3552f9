"""Host time of one batched BINFHE gate at STD128, for a paired comparison.

    python3 openfhe_tpu_torch/bench/gate_host.py [RUNS]

``openfhe_tpu_torch`` is imported from PYTHONPATH, so one call can time two
trees of the package in turn (parent, change, change, parent). Builds the
STD128 context and keys on the card, runs two untimed AND gates over a
batch of 4 (``eval_gate_batch``, as ``profile_ops binfhe`` times them), then
RUNS timed ones (default 10), each ending in a synchronise. Prints the
card's name and power limit, the median and quartiles in milliseconds, and
a last line of JSON. Needs a CUDA device.
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

    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(gpu, flush=True)
    ctx = binfhe.gen_context("STD128")
    rng = np.random.default_rng(61)
    sk = binfhe.keygen(ctx, rng)
    bk = binfhe.bootstrap_keygen(ctx, sk, rng)
    cts = [binfhe.encrypt(ctx, sk, x, rng) for x in (0, 1)]

    def gate():
        return binfhe.eval_gate_batch(ctx, "AND", bk, cts * 2,
                                      cts[::-1] + cts)

    want = [x & y for x, y in zip((0, 1) * 2, (1, 0, 0, 1))]
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
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    print(f"STD128 AND, B = 4: host {med:.3f} ms ({q1:.3f}-{q3:.3f}, "
          f"{runs} runs)", flush=True)
    print(json.dumps({"gpu": gpu, "runs": runs, "host_ms": ms,
                      "median": med, "q1": q1, "q3": q3}), flush=True)


if __name__ == "__main__":
    main()
