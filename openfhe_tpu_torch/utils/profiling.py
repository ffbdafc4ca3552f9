"""Timing and profiling utilities.

Counterpart of ``openfhe_tpu/utils/profiling.py``. Role of the reference's
TIC/TOC + ``PROFILELOG`` macros (``utils/debug.h:94-130``) and its
google-benchmark harness, for PyTorch on the card: CUDA launches return
before the device has run them, so wall-clock timing without a synchronise
measures the enqueue rate, not device time. ``timed`` waits for the devices
of the tensors registered with ``block_on``, and ``trace`` runs
``torch.profiler`` (CPU and CUDA activities) and writes a Chrome trace,
viewable in Perfetto or ``chrome://tracing``. ``graph_ms`` times a short
call on the device alone, by replaying a CUDA graph of many calls.

Usage::

    from openfhe_tpu_torch.utils.profiling import TIC, TOC, timed, trace

    t = TIC()
    ...
    print(TOC(t))                      # wall seconds

    with timed("mult_relin") as r:     # waits for the card
        out = ckks.eval_mult_relin(ct, ct, evk)
        r.block_on(out)
    # r.seconds, plus a PROFILELOG-style line on stderr when enabled

    with trace("fhe_trace"):           # fhe_trace/trace.json
        run_workload()
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time

import torch

# PROFILELOG is compiled in when the reference defines PROFILE; here it is
# a runtime switch (env OPENFHE_TPU_TORCH_PROFILE=1 or set_profile(True)).
_PROFILE = os.environ.get("OPENFHE_TPU_TORCH_PROFILE", "0") == "1"

TRACE_FILE = "trace.json"


def set_profile(on: bool) -> None:
    global _PROFILE
    _PROFILE = on


def profile_log(label: str, seconds: float) -> None:
    """(role of PROFILELOG, debug.h:124-130)."""
    if _PROFILE:
        print(f"[openfhe_tpu_torch] {label}: {seconds * 1e3:.3f} ms",
              file=sys.stderr)


def TIC() -> float:
    """(role of the TIC macro, debug.h:94)."""
    return time.perf_counter()


def TOC(t: float) -> float:
    """(role of the TOC macro): seconds since TIC."""
    return time.perf_counter() - t


def _tensors(x):
    """Every tensor in x: a tensor, a dataclass (RnsPoly, Ciphertext, keys)
    or a list, tuple or dict of them."""
    if isinstance(x, torch.Tensor):
        yield x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _block(x) -> None:
    """Wait until the work producing every CUDA tensor in x has run."""
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class _TimedResult:
    def __init__(self, label: str):
        self.label = label
        self.seconds = 0.0
        self._targets = []

    def block_on(self, x) -> None:
        """Register device values the timer must wait for."""
        self._targets.append(x)


@contextlib.contextmanager
def timed(label: str):
    """Wall-clock a block, waiting for the registered device outputs so the
    measurement covers device execution, not just the launches."""
    r = _TimedResult(label)
    t0 = time.perf_counter()
    try:
        yield r
    finally:
        for x in r._targets:
            _block(x)
        r.seconds = time.perf_counter() - t0
        profile_log(label, r.seconds)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the enclosed block (CPU activity, and CUDA
    when a card is present), written to ``log_dir/trace.json``. Yields the
    profiler, whose ``key_averages()`` sum the time by kernel name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds of fn() (or of a tuple of functions called
    in turn) over `reps` calls. The calls are captured in one CUDA graph and
    the replay is timed with CUDA events, so the host's cost of each call
    (Python, ctypes) is not counted: for short kernels it exceeds the
    kernel's own time. A warm-up call first builds every table and cache
    outside the capture, and one untimed replay precedes the timed one.
    Raises on a time that is not positive."""
    calls = fn if isinstance(fn, tuple) else (fn,)
    for f in calls:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            for f in calls:
                f()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    if not ms > 0:
        raise RuntimeError(f"non-positive device time {ms} ms")
    return ms


class OpTimer:
    """Accumulate per-op wall times across a workload; print a breakdown
    (role of the reference's per-benchmark console reporter)."""

    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def op(self, name: str):
        with timed(name) as r:
            yield r
        self.totals[name] = self.totals.get(name, 0.0) + r.seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, file=sys.stderr) -> None:
        width = max((len(k) for k in self.totals), default=4)
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot, cnt = self.totals[name], self.counts[name]
            print(f"{name:<{width}}  {tot * 1e3:9.3f} ms total  "
                  f"{cnt:5d} calls  {tot / cnt * 1e3:9.3f} ms/call",
                  file=file)
