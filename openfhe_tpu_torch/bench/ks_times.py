"""Device time of ``ks_inner_product`` at the blind rotations' and the key
switches' shapes, for a paired comparison of two trees.

    python3 openfhe_tpu_torch/bench/ks_times.py

``openfhe_tpu_torch`` is imported from PYTHONPATH, so one call can time two
trees of the package in turn (``PYTHONPATH=<tree> python3 <this file>``,
parent / change / change / parent), each building its own kernels. Every
time is ``utils/profiling.graph_ms`` of the tree this file sits in (20
calls replayed as one CUDA graph, L2-warm inputs), whichever tree is timed.

For each shape, on uniform residues from a fixed seed:

* ``inner product``: ``ks_inner_product`` alone, rows by value;
* ``step`` (GINX shapes): the digit inner product times the (X^c - 1) row
  of each batch element, as the blind rotation computes it: one call with
  the monomial epilogue where the tree's wrapper takes ``mono``, else the
  call, the row gather ``mono[exps]`` and the plain ``mul_mod``;
* ``step`` (AP): the step's key slab [2dg, B_r, N] read at each batch
  element's row: one call with the rows on the device where the wrapper
  takes a rows tensor, else ``index_select`` of the slab and the call;
* at the key switches' shapes, the copy ceiling beside the call: a
  device-to-device copy that reads and writes as many bytes as the call
  must move (its digits, both key halves and both outputs once).

Prints the card's name and power limit, one line per shape and a last line
of JSON. Needs a CUDA device.
"""

import inspect
import json
import subprocess
import sys

import numpy as np
import torch
from ntt_times import graph_ms_of_this_tree

REPS = 20
BINFHE_BATCHES = (1, 2, 4, 8, 16)
# (label, digits, towers, n) of the key switches: the CKKS main path, the
# bootstrap's mod-up at full depth, BGV at full level, a BV chunk of 15
# digits, scheme switching's CKKS side; 60-bit towers throughout (the
# kernel's time does not depend on the width)
KEY_SWITCHES = (("[3, 11, 65536] CKKS QP", 3, 11, 1 << 16),
                ("[3, 28, 65536] bootstrap QP", 3, 28, 1 << 16),
                ("[3, 14, 32768] BGV QP", 3, 14, 1 << 15),
                ("[15, 10, 32768] BV chunk", 15, 10, 1 << 15),
                ("[3, 19, 65536] scheme-switching QP", 3, 19, 1 << 16))


def _uniform(q, shape, rng):
    return torch.from_numpy(rng.integers(0, q, size=shape, dtype=np.uint64)
                            .astype(np.int64)).cuda()


def main():
    if not torch.cuda.is_available():
        sys.exit("ks_times: no CUDA device")
    from openfhe_tpu_torch.models import binfhe
    from openfhe_tpu_torch.ops import elementwise
    from openfhe_tpu_torch.ops.modular import make_mod_consts, mul_mod
    from openfhe_tpu_torch.utils import nbtheory

    graph_ms = graph_ms_of_this_tree()
    ks = elementwise.ks_inner_product
    fused = "mono" in inspect.signature(ks).parameters
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(gpu, flush=True)
    print(f"package: {elementwise.__file__}; epilogue and device rows "
          f"{'in the kernel' if fused else 'as separate calls'}", flush=True)
    rng = np.random.default_rng(1)
    rows_out = []

    def record(label, what, fn, **extra):
        us = 1e3 * graph_ms(fn, REPS)
        print(f"{label} {what}: {us:.2f} us"
              + "".join(f", {k} {v:.2f}" for k, v in extra.items()),
              flush=True)
        rows_out.append({"shape": label, "call": what, "us": us, **extra})

    def ginx(label, q, ndig, batch, n):
        mod = make_mod_consts((q,) * batch, "cuda")
        scalar = make_mod_consts((q,), "cuda", trailing_dims=0)
        digits = _uniform(q, (ndig, batch, n), rng)
        kb, ka = (_uniform(q, (ndig, 2, n), rng) for _ in range(2))
        mono = _uniform(q, (2 * n, n), rng)
        exps = torch.from_numpy(rng.integers(0, 2 * n, batch)).cuda()
        rows = (1,) * batch
        record(label, "inner product", lambda: ks(digits, kb, ka, rows, mod))
        if fused:
            record(label, "step", lambda: ks(digits, kb, ka, rows, mod,
                                             mono=mono, mono_rows=exps))
        else:
            record(label, "step", lambda: mul_mod(
                ks(digits, kb, ka, rows, mod), mono[exps], scalar))

    std = binfhe.reference_params("STD128")
    for b in BINFHE_BATCHES:
        ginx(f"[6, {b}, 1024] 27-bit STD128", std.Q, 6, b, 1024)
    ginx("[4, 4, 2048] 50-bit STD128Q_3",
         binfhe.reference_params("STD128Q_3").Q, 4, 4, 2048)
    ginx("[6, 1, 256] 28-bit scheme-switching FHEW",
         nbtheory.first_prime(27, 512), 6, 1, 256)

    ap = binfhe.reference_params("STD128_AP")
    mod = make_mod_consts((ap.Q,) * 4, "cuda")
    digits = _uniform(ap.Q, (6, 4, 1024), rng)
    slab = _uniform(ap.Q, (2, 6, ap.B_r, 1024), rng)
    dig = torch.from_numpy(rng.integers(0, ap.B_r, 4)).cuda()
    label = "[6, 4, 1024] 27-bit STD128_AP"
    if fused:
        record(label, "step", lambda: ks(digits, slab[0], slab[1], dig, mod))
    else:
        def gathered():
            key = slab.index_select(2, dig)
            return ks(digits, key[0], key[1], (0, 1, 2, 3), mod)
        record(label, "step", gathered)

    lmk = binfhe.reference_params("STD128_LMKCDEY")
    mod = make_mod_consts((lmk.Q,), "cuda")
    for d, what in ((6, "ek row"), (3, "automorphism key")):
        digits = _uniform(lmk.Q, (d, 1, 1024), rng)
        kb, ka = (_uniform(lmk.Q, (d, 1, 1024), rng) for _ in range(2))
        record(f"[{d}, 1, 1024] 28-bit STD128_LMKCDEY {what}",
               "inner product", lambda: ks(digits, kb, ka, (0,), mod))

    for label, ndig, towers, n in KEY_SWITCHES:
        moduli = tuple(nbtheory.generate_prime_chain(towers, 60, n))
        mod = make_mod_consts(moduli, "cuda")
        digits = torch.stack([torch.stack([_uniform(q, (n,), rng)
                                           for q in moduli])
                              for _ in range(ndig)])
        kb, ka = (digits.roll(k + 1, dims=0).clone() for k in range(2))
        rows = tuple(range(towers))
        moved = 8 * n * towers * (3 * ndig + 2)
        src = torch.empty(moved // 16, dtype=torch.int64, device="cuda")
        dst = torch.empty_like(src)
        copy_us = 1e3 * graph_ms(lambda: dst.copy_(src), REPS)
        record(label, "inner product", lambda: ks(digits, kb, ka, rows, mod),
               copy_ceiling_us=copy_us,
               copy_rate_tb_s=moved / (copy_us * 1e-6) / 1e12)
        del digits, kb, ka, src, dst
        torch.cuda.empty_cache()
    print(json.dumps({"gpu": gpu, "reps": REPS, "fused": fused,
                      "times": rows_out}), flush=True)


if __name__ == "__main__":
    main()
