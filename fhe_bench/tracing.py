"""The traced run: spans around the calls into the kernel layer, one
profiler session over whole requests, and its reduction to the records the
per-layer metrics read.

Kernel time is attributed by the wrapper call that launched it, not by the
kernel's symbol: while ``WrapperSpans`` is entered, each call of the six
kernel wrappers runs inside a ``record_function`` span whose index points to
the call's shapes (the pattern of ``chip_smoke.CallLog``), and every device
operation the profiler links to that span counts against the call. A later
change that renames or replaces a kernel behind the same wrapper is read the
same way, against the same bound.
"""

from __future__ import annotations

import bisect
import dataclasses
from contextlib import contextmanager
from typing import List, Optional

import torch

from . import roofline
from .harness import log

SPAN = "fhe_bench."
WINDOW = SPAN + "window"


@dataclasses.dataclass
class Call:
    """One outermost call of a kernel wrapper."""

    kind: str            # "ntt", "ks_inner_product" or "fused_mac_mod"
    shape: tuple         # the main operand's shape
    towers: int = 0      # NTT: moduli
    key_rows: Optional[int] = None     # ks: distinct key rows read
    rows_on_device: bool = False       # ks: the rows go as a device index
    mono_rows: object = None           # ks: epilogue row index (a tensor)
    device_s: float = 0.0
    device_ops: int = 0

    def bound_s(self) -> float:
        if self.kind == "ntt":
            n = self.shape[-1]
            rows = 1
            for d in self.shape[:-1]:
                rows *= d
            return roofline.ntt_any_bound(rows, self.towers, n)
        if self.kind == "ks_inner_product":
            ndig, rows, n = self.shape
            mono = 0 if self.mono_rows is None else \
                int(torch.unique(self.mono_rows).numel())
            return roofline.ks_bound(ndig, rows, n, self.key_rows,
                                     self.rows_on_device, mono)
        raise ValueError(f"no roofline metric reads {self.kind}")


def _ntt_call(x, moduli, *a, **k):
    return Call("ntt", tuple(x.shape), towers=len(moduli))


def _ks_call(digits, key_b, key_a, rows, mod, mono=None, mono_rows=None):
    ndig, R, n = digits.shape
    if isinstance(rows, torch.Tensor):
        key_rows, on_device = None, True
    else:
        rows = tuple(int(r) for r in rows)
        # a host list longer than the kernel takes by value goes as an index
        key_rows, on_device = len(set(rows)), R > MAX_ROWS_BY_VALUE
    return Call("ks_inner_product", (ndig, R, n), key_rows=key_rows,
                rows_on_device=on_device, mono_rows=mono_rows)


def _mac_call(x, y, acc, mod):
    return Call("fused_mac_mod", tuple(x.shape))


MAX_ROWS_BY_VALUE = 128  # csrc/mac.cu kMaxRowsByValue


class WrapperSpans:
    """While entered, every outermost call of the kernel wrappers adds a
    ``Call`` to ``calls`` and runs inside the span ``fhe_bench.<kind>#<i>``.
    The wrappers are swapped for shims on their modules; each shim carries
    the wrapper's launch counter, which goes back to the wrapper on exit
    (the wrappers count through their module-level name)."""

    def __init__(self):
        self.calls: List[Call] = []
        self._swapped = []
        self._depth = 0

    def __enter__(self):
        from openfhe_tpu_torch.ops import elementwise, ntt
        for module, name, sig in (
                (ntt, "forward", _ntt_call), (ntt, "inverse", _ntt_call),
                (ntt, "forward_small", _ntt_call),
                (ntt, "inverse_small", _ntt_call),
                (elementwise, "ks_inner_product", _ks_call),
                (elementwise, "fused_mac_mod", _mac_call)):
            wrapper = getattr(module, name)

            def shim(*a, _wrapper=wrapper, _sig=sig, **k):
                if self._depth:
                    return _wrapper(*a, **k)
                call = _sig(*a, **k)
                self.calls.append(call)
                self._depth += 1
                try:
                    with torch.profiler.record_function(
                            f"{SPAN}{call.kind}#{len(self.calls) - 1}"):
                        return _wrapper(*a, **k)
                finally:
                    self._depth -= 1

            shim.launches = wrapper.launches
            setattr(module, name, shim)
            self._swapped.append((module, name, wrapper, shim))
        return self

    def __exit__(self, *exc):
        for module, name, wrapper, shim in self._swapped:
            wrapper.launches = shim.launches
            setattr(module, name, wrapper)
        self._swapped = []


def launch_counts() -> dict:
    """The wrappers' own launch counters."""
    from openfhe_tpu_torch.ops import elementwise, ntt
    return {"ntt_forward": ntt.forward.launches,
            "ntt_inverse": ntt.inverse.launches,
            "ntt_small_forward": ntt.forward_small.launches,
            "ntt_small_inverse": ntt.inverse_small.launches,
            "ks_inner_product": elementwise.ks_inner_product.launches,
            "fused_mac_mod": elementwise.fused_mac_mod.launches}


@contextmanager
def op_span(name: str, on: bool):
    """A span around one traffic operation, for labelling idle gaps."""
    if not on:
        yield
        return
    with torch.profiler.record_function(f"{SPAN}op.{name}"):
        yield


@dataclasses.dataclass
class TraceSummary:
    """What the per-layer metric readers read (``metrics/*.py``)."""

    requests: int
    window_s: float
    busy_s: float
    device_s: float          # the sum of every device operation's time
    device_ops: int
    calls: List[Call]
    top_ops: list            # [[name, seconds], ...] by total time
    idle_gaps: list          # [[host activity, seconds], ...] longest first
    linked: int = 0          # device operations matched to their launch


# host-side CUDA calls that put work on the device
_LAUNCHES = ("Launch", "Memcpy", "Memset")


def _is_device_op(e) -> bool:
    """A kernel, copy or fill on the device; not the device-side ranges the
    profiler draws for host annotations."""
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    kind = getattr(e, "activity_type", lambda: "")()
    return "annotation" not in str(kind) and not e.name().startswith(SPAN)


def summarize(events, calls: List[Call], requests: int) -> TraceSummary:
    """Reduce the profiler's raw events (``prof.profiler.kineto_results
    .events()``) to a TraceSummary over the window span. A device operation
    is matched to the host call that launched it by the CUDA correlation
    id, and counts against the wrapper span that call lies in."""
    host, dev, launch_at = [], [], {}
    for e in events:
        if _is_device_op(e):
            dev.append(e)
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append(e)
            if e.name().startswith("cu") and any(k in e.name()
                                                  for k in _LAUNCHES):
                launch_at[e.correlation_id()] = e.start_ns()
    windows = [e for e in host if e.name() == WINDOW]
    if not windows:
        raise RuntimeError("the profiler recorded no window span")
    w0 = windows[-1].start_ns()
    w1 = w0 + windows[-1].duration_ns()
    dev = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                   e.correlation_id()) for e in dev
                  if w0 <= e.start_ns() < w1), key=lambda t: t[0])
    if not dev:
        raise RuntimeError("the profiler recorded no device operation in "
                           "the window")
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                    int(e.name().rsplit("#", 1)[1])) for e in host
                   if e.name().startswith(SPAN) and "#" in e.name()
                   and w0 <= e.start_ns() < w1)
    starts = [s for s, _, _ in spans]
    busy, cur_s, cur_e, gaps, linked = 0, None, w0, [], 0
    per_name = {}
    for s, e, name, corr in dev:
        per_name[name] = per_name.get(name, 0) + (e - s)
        t = launch_at.get(corr)
        if t is not None:
            linked += 1
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t < spans[k][1] and spans[k][2] < len(calls):
                call = calls[spans[k][2]]
                call.device_s += (e - s) * 1e-9
                call.device_ops += 1
        if s > cur_e:
            gaps.append((s - cur_e, cur_e, s))
            if cur_s is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_s = s if cur_s is None else cur_s
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((w1 - cur_e, cur_e, w1))
    gaps.sort(reverse=True)
    inside = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in host if w0 <= e.start_ns() < w1
              and e.name() != WINDOW]
    labelled = [[_host_label(inside, (a + b) // 2), d * 1e-9]
                for d, a, b in gaps[:10]]
    if linked < len(dev) // 2:
        launches = [(e.name(), e.correlation_id()) for e in host
                    if e.name().startswith("cu")][:5]
        log(f"trace: few device operations matched; device "
            f"{[(n, c) for _, _, n, c in dev[:3]]}, host calls {launches}")
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        requests=requests, window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
        device_s=sum(e - s for s, e, _, _ in dev) * 1e-9,
        device_ops=len(dev), calls=calls,
        top_ops=[[n, t * 1e-9] for n, t in top], idle_gaps=labelled,
        linked=linked)


def _host_label(host, t: int) -> str:
    """The traffic operation running on the host at time t and the
    innermost other host event under it."""
    op, inner = None, None
    for s, e, name in host:
        if s <= t < e:
            if name.startswith(SPAN + "op."):
                op = name[len(SPAN) + 3:]
            elif inner is None or e - s < inner[1] - inner[0]:
                inner = (s, e, name)
    parts = [p for p in (op, inner[2] if inner else None) if p]
    return " / ".join(parts) if parts else "between requests"
