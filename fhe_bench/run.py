"""Run one cell of the benchmark on the GPU and print its result line.

    python3 -m fhe_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up (imports, the CUDA context, loading the
port's kernels from ``openfhe_tpu_torch/build/``, the context's tables,
keys, inputs and the warm-up of the cell's own shapes) is ``setup_s``; then
one caller sends requests in a closed loop for ``--seconds`` (each request
ends in a synchronise), or, with ``--trace 1``, a profiled window of whole
requests gives the per-layer metrics. The outputs are then checked against
the plain reference in ``fhe_bench/reference``. Without a CUDA device, or
with fewer than the cell asks for, it exits with code 2 and prints no
result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fhe_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from fhe_bench import harness

    cell = harness.resolve(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA device(s); "
                    f"found {torch.cuda.device_count()}")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T0)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"the run loaded {', '.join(found)}: no result")
        return 3
    # the numbers compared come last on standard error, as in the result
    for k, v in result["compared"].items():
        harness.log(f"compared {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
