"""Record every kernel call of ``chip_smoke.py``'s phases 23-24 on the CPU.

Runs the port's example programs, ``entry()``'s step and one rank of
``dryrun_multichip`` (a one-rank gloo group, the work of phase 24's NCCL
rank) under ``chip_smoke.CallLog`` and writes each distinct call of the
NTT, ``ks_inner_product`` and ``fused_mac_mod`` wrappers, with the programs
that make it, to ``tests/data/example_kernel_calls.json`` (a
``ks_inner_product`` call with its rows as a device tensor lists them as
"device", one with the monomial epilogue its table's shape). Phase 2 holds
each kernel against its twin at every one of them; phases 23-24 fail if the
card makes a call the file does not list. The calls do not depend on the
device, so a CPU run finds them.

    python tests/make_example_kernel_calls.py [--jobs 3]
"""

import argparse
import json
import os
import sys
import tempfile
from multiprocessing import get_context

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "example_kernel_calls.json")
sys.path.insert(0, ROOT)


def _calls(name):
    import torch
    import chip_smoke
    from openfhe_tpu_torch import entry
    from openfhe_tpu_torch.examples._common import run

    torch.set_num_threads(2)
    with chip_smoke.CallLog() as log:
        if name == "entry":
            fn, args = entry.entry("cpu")
            fn(*args)
        elif name == "dryrun_multichip":
            with tempfile.TemporaryDirectory() as tmp:
                entry.dryrun_rank(0, 1, os.path.join(tmp, "init"), "gloo")
        else:
            run(name, "cpu")
    return name, log.calls


def main():
    import chip_smoke

    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=3)
    jobs = ap.parse_args().jobs
    names = list(chip_smoke.EXAMPLES) + ["entry", "dryrun_multichip"]
    seen = {}
    with get_context("spawn").Pool(jobs) as pool:
        for name, calls in pool.imap_unordered(_calls, names):
            print(f"{name}: {len(calls)} calls", flush=True)
            for c in calls:
                seen.setdefault(c, []).append(name)
    out = []
    for c, programs in sorted(seen.items()):
        entry = {"kernel": c[0], "shape": list(c[1])}
        if c[0] == "ks_inner_product":
            # (kernel, shape, key shape, rows, rows on the device?, the
            # monomial table's shape or (), moduli): chip_smoke._ks_call
            entry.update(key_shape=list(c[2]),
                         rows="device" if c[4] else list(c[3]))
            if c[5]:
                entry.update(mono_shape=list(c[5]))
        entry.update(moduli=list(c[-1]),
                     programs=sorted(programs, key=names.index))
        out.append(entry)
    with open(OUT, "w") as f:
        f.write("[\n" + ",\n".join(json.dumps(e) for e in out) + "\n]\n")
    kinds = {k: sum(e["kernel"] == k for e in out)
             for k in ("ntt", "ks_inner_product", "fused_mac_mod")}
    print(f"{len(out)} distinct calls {kinds} -> {OUT}")


if __name__ == "__main__":
    main()
