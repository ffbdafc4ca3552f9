"""The port's timing and profiling utilities on CPU tensors: the four cases
of ``tests/test_profiling.py`` (TIC/TOC, ``timed`` with ``block_on``,
``OpTimer``'s report, the PROFILELOG switch), ``trace`` writing a Chrome
trace that names the operations it saw, and ``graph_ms``'s bookkeeping
around stand-ins for the CUDA graph and events."""

import contextlib
import io
import json
import os

import pytest
import torch

from openfhe_tpu_torch.utils import profiling as prof


def test_tic_toc():
    t = prof.TIC()
    assert prof.TOC(t) >= 0.0


def test_timed_blocks_on_device_values():
    with prof.timed("matmul") as r:
        x = torch.ones((64, 64)) @ torch.ones((64, 64))
        r.block_on(x)
        r.block_on({"nested": [x, (x,)]})
    assert r.seconds > 0.0
    assert float(x[0, 0]) == 64.0


def test_op_timer_report():
    t = prof.OpTimer()
    for _ in range(3):
        with t.op("add") as r:
            r.block_on(torch.ones(8) + 1)
    with t.op("mul") as r:
        r.block_on(torch.ones(8) * 2)
    assert t.counts == {"add": 3, "mul": 1}
    buf = io.StringIO()
    t.report(file=buf)
    out = buf.getvalue()
    assert "add" in out and "mul" in out and "ms/call" in out


def test_profile_log_switch(capsys):
    prof.set_profile(True)
    try:
        prof.profile_log("unit", 0.001)
    finally:
        prof.set_profile(False)
    assert "unit: 1.000 ms" in capsys.readouterr().err
    prof.profile_log("silent", 0.001)
    assert "silent" not in capsys.readouterr().err


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with prof.trace(str(log_dir)) as p:
        torch.ones((32, 32)).matmul(torch.ones((32, 32)))
    path = log_dir / prof.TRACE_FILE
    assert os.path.getsize(path) > 0
    names = {e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"]}
    assert "aten::matmul" in names
    assert any(e.key == "aten::matmul" for e in p.key_averages())


class _FakeEvent:
    def __init__(self, elapsed):
        self.elapsed = elapsed

    def record(self):
        pass

    def elapsed_time(self, end):
        return self.elapsed


class _FakeGraph:
    def replay(self):
        pass


@contextlib.contextmanager
def _capture(graph):
    yield


def _fake_cuda(monkeypatch, elapsed):
    """torch.cuda's graph and event calls as stand-ins: the captured calls
    run once, every timed replay takes `elapsed` ms."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _capture)
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda enable_timing=False: _FakeEvent(elapsed))


def test_graph_ms_warms_up_captures_and_averages(monkeypatch):
    _fake_cuda(monkeypatch, 8.0)
    calls = {"f": 0, "g": 0}

    def f():
        calls["f"] += 1

    def g():
        calls["g"] += 1

    assert prof.graph_ms(f, reps=4) == 2.0
    assert calls == {"f": 5, "g": 0}      # one warm-up, four captured
    assert prof.graph_ms((f, g), reps=2) == 4.0
    assert calls == {"f": 8, "g": 3}


@pytest.mark.parametrize("elapsed", [0.0, -1.0])
def test_graph_ms_rejects_a_non_positive_time(monkeypatch, elapsed):
    _fake_cuda(monkeypatch, elapsed)
    with pytest.raises(RuntimeError):
        prof.graph_ms(lambda: None, reps=3)
