"""Device time of the NTT wrappers at the small rings' shapes.

    python3 openfhe_tpu_torch/bench/ntt_times.py

``openfhe_tpu_torch`` is imported from PYTHONPATH, so one call can time two
trees of the package in turn (``PYTHONPATH=<tree> python3 <this file>``),
each building its own kernels. For every shape, ``ops.ntt.forward`` and
``inverse`` on L2-warm inputs: 20 calls captured in one CUDA graph, the
replay timed with CUDA events (``utils/profiling.graph_ms`` of the tree
this file sits in, whichever tree is timed; ``chip_smoke.py`` phase 2 times
kernels the same way).
A shape a tree refuses (a call over 65,535 rows before the small-ring
kernel) is reported as refused. Prints the card's name and power limit, one
line per shape and direction, and a last line of JSON. Needs a CUDA device.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPS = 20
# (lead, towers, bits, n): a blind-rotation step's digits and halves
# (STD128, STD128Q_3), key generation's error rows (GINX, AP), scheme
# switching's FHEW LUT, the four-step's columns at n = 2^16, the example
# programs' rings
SHAPES = [((r,), 1, 27, 1024) for r in (1, 2, 6, 24, 96, 6036, 65535,
                                        289728)] + \
    [((r,), 1, 50, 2048) for r in (1, 8, 16, 4600)] + \
    [((r,), 1, 28, 256) for r in (1, 6, 96)] + \
    [((256, 3), 11, 60, 256), ((256,), 11, 60, 256), ((3,), 1, 55, 16),
     ((2,), 3, 55, 128), ((2,), 3, 55, 512)]


def graph_ms_of_this_tree():
    """utils/profiling.graph_ms of the tree this file sits in, loaded by
    path, whichever tree of the package PYTHONPATH times."""
    path = Path(__file__).resolve().parent.parent / "utils" / "profiling.py"
    spec = importlib.util.spec_from_file_location("_ntt_times_timer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.graph_ms


def main():
    if not torch.cuda.is_available():
        sys.exit("ntt_times: no CUDA device")
    from openfhe_tpu_torch.ops import ntt
    from openfhe_tpu_torch.utils import nbtheory

    graph_ms = graph_ms_of_this_tree()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(gpu, flush=True)
    rng = np.random.default_rng(1)
    rows = []
    for lead, towers, bits, n in SHAPES:
        moduli = tuple(nbtheory.generate_prime_chain(towers, bits, n))
        cols = [rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
                for q in moduli]
        x = torch.from_numpy(np.stack(cols, axis=-2).astype(np.int64)).cuda()
        shape = list(x.shape)
        try:
            y = ntt.forward(x, moduli)
        except ValueError as err:
            print(f"{shape} {bits}-bit: refused ({err})", flush=True)
            rows.append({"shape": shape, "bits": bits, "refused": str(err)})
            continue
        for name, fn in (("forward", lambda: ntt.forward(x, moduli)),
                         ("inverse", lambda: ntt.inverse(y, moduli))):
            us = 1e3 * graph_ms(fn, REPS)
            print(f"{shape} {bits}-bit {name}: {us:.2f} us", flush=True)
            rows.append({"shape": shape, "bits": bits, "direction": name,
                         "us": us})
        del x, y
        torch.cuda.empty_cache()
    print(json.dumps({"gpu": gpu, "reps": REPS, "times": rows}), flush=True)


if __name__ == "__main__":
    main()
