"""The benchmark's shared machinery: finding a cell's files by name, set-up
timing, the closed loop and its window, the traced run, the check, and the
result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name ``BENCHMARK.json``
gives it:

* a configuration: the ``file`` its entry names (``configs/<name>.json``);
* a traffic mix: ``traffic/<name>.json``;
* a cell's limits on the numbers compared: ``cells/<workload>.json``;
* a per-layer metric ``<base>.<split>`` (or ``<base>``): the reader
  ``metrics/<base>.py``, a function ``read(summary)`` that returns a number
  or None when the traced window holds nothing for it.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "openfhe_tpu")
NOTHING = 1e30  # a compared number where there was nothing to compare


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class CellSpec:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    control: dict = dataclasses.field(default_factory=dict)


def _in_cell(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def resolve(workload: str, root: Path = ROOT) -> CellSpec:
    """The cell named `workload` in root/BENCHMARK.json, with its files."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / "fhe_bench"
    own = load_json(bench / "cells" / f"{workload}.json")
    return CellSpec(
        name=workload, chips=w["chips"],
        config=load_json(root / configs[w["config"]]["file"]),
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=own["limits"], control=own.get("control", {}),
        end_to_end=[m for m in spec["end_to_end"] if _in_cell(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _in_cell(m, workload)])


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of the per-layer metric `metric`."""
    base = metric.split(".", 1)[0]
    path = root / "fhe_bench" / "metrics" / f"{base}.py"
    spec = importlib.util.spec_from_file_location(
        f"fhe_bench_metric_{base}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def scheme(config: dict):
    return importlib.import_module(f"fhe_bench.schemes.{config['scheme']}")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not hold."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class SetupParts:
    """Seconds of each named part of set-up, in order."""

    def __init__(self):
        self.seconds = {}

    @contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + \
                time.perf_counter() - t


class Reservoir:
    """A uniform sample of `k` of a stream of outputs, drawn from the seed
    (k = 0 keeps them all)."""

    def __init__(self, k: int, seed: int):
        self.k, self.kept, self.seen = k, [], 0
        self.rng = np.random.default_rng([seed, 1])

    def offer(self, item) -> None:
        self.seen += 1
        if not self.k or len(self.kept) < self.k:
            self.kept.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.kept[j] = item


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: CellSpec, seed: int, seconds: float, trace: bool,
             device, t0: float, root: Path = ROOT, control: bool = False):
    """One run: set-up, warm-up, the window (traced or not), the check.
    Returns the result object (without its forbidden-module check). With
    `control` the cell's control serves the requests (``control.py``; the
    benchmark's own runs never set it)."""
    import torch

    from . import tracing

    device = torch.device(device)
    parts = SetupParts()
    parts.seconds["start"] = time.perf_counter() - t0
    with parts("import"):
        from openfhe_tpu_torch import _build
    if device.type == "cuda":
        with parts("cuda_context"):
            torch.zeros(1, device=device)
            _sync(device)
        with parts("kernels"):
            _build.library()
    traffic = cell.traffic
    c = scheme(cell.config).Cell(cell.config, traffic, seed, device, parts,
                                 control=cell.control if control else None)
    with parts("warm_up"):
        for i in range(traffic["warmup"]):
            c.request(i)
        _sync(device)
    setup_s = time.perf_counter() - t0
    log("setup parts (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.seconds.items())
        + f"; total {setup_s:.3f}")
    launches0 = tracing.launch_counts()
    sample = Reservoir(traffic["check"], seed)
    lat, failed, attempted = [], 0, 0
    i = traffic["warmup"]
    summary = None

    def serve(limit_s, max_requests, on):
        nonlocal i, failed, attempted
        start = time.perf_counter()
        end = start
        while True:
            t = time.perf_counter()
            attempted += 1
            try:
                out = c.request(i, on)
                _sync(device)
            except Exception:  # a failed request is counted, not fatal
                failed += 1
                if failed == 1:
                    log(traceback.format_exc())
                out = None
            end = time.perf_counter()
            if out is not None:
                lat.append(end - t)
                sample.offer((i, out))
            i += 1
            if end - start >= limit_s or attempted >= max_requests:
                return end - start

    if trace:
        with tracing.WrapperSpans() as spans:
            with torch.profiler.profile(activities=_activities(device)) \
                    as prof:
                c.request(i, True)    # the profiler's own warm-up
                i += 1
                _sync(device)
                del spans.calls[:]
                launches0 = tracing.launch_counts()
                with torch.profiler.record_function(tracing.WINDOW):
                    window_s = serve(seconds, traffic["trace_requests"],
                                     True)
            t = time.perf_counter()
            summary = tracing.summarize(
                prof.profiler.kineto_results.events(), spans.calls,
                attempted - failed)
            linked = sum(1 for x in summary.calls if x.device_ops)
            log(f"trace: {summary.device_ops} device operations "
                f"({summary.linked} matched to their launch), "
                f"{len(summary.calls)} wrapper calls ({linked} with device "
                f"operations), wrapped "
                f"{sum(x.device_s for x in summary.calls):.6f} s of "
                f"{summary.device_s:.6f} s; read in "
                f"{time.perf_counter() - t:.1f} s")
    else:
        window_s = serve(seconds, float("inf"), False)
    launches = {k: v - launches0[k]
                for k, v in tracing.launch_counts().items()}
    done = len(lat)
    log(f"window: {attempted} requests, {failed} failed, {window_s:.3f} s; "
        f"wrapper launches a request: " + ", ".join(
            f"{k} {v / max(done, 1):.1f}" for k, v in launches.items()))
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = reader(m["name"], root)(summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = _end_to_end(m["name"], traffic, setup_s, lat, window_s,
                            c.work_per_request)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    kept = sample.kept
    del sample
    c.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = c.check(kept) if kept else {k: NOTHING for k in cell.limits}
    compared = {k: {"value": checks[k], "limit": cell.limits[k]}
                for k in cell.limits}
    correct = bool(kept) and failed == 0 and all(
        v["value"] <= v["limit"] for v in compared.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": _device(device, cell.chips,
                                                    peak)}
    if trace:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.top_ops,
                               "idle_gaps": summary.idle_gaps}
    result["compared"] = compared
    return result



def _activities(device):
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _end_to_end(name, traffic, setup_s, lat, window_s, work):
    if name == "setup_s":
        return setup_s
    kind = traffic["report"][name]
    if kind == "rate":
        return work * len(lat) / window_s
    if kind.startswith("p") and kind[1:].isdigit():
        return 1e3 * float(np.percentile(lat, int(kind[1:])))
    raise ValueError(f"unknown end-to-end kind {kind!r} for {name}")


def _device(device, chips, peak):
    import torch
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(peak)}
