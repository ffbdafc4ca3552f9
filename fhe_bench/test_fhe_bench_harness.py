"""CPU tests of the benchmark harness (``python -m pytest fhe_bench``)."""

from __future__ import annotations

import ast
import copy
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fhe_bench import harness, roofline, toy, tracing
from fhe_bench.reference import binfhe as ref_binfhe
from fhe_bench.reference import ckks as ref_ckks
from fhe_bench.reference.modarith import NTT

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_its_files_by_name(workload):
    cell = harness.resolve(workload)
    assert cell.config["scheme"] == cell.traffic["scheme"]
    harness.scheme(cell.config).Cell
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names
    assert names - {"setup_s"} == set(cell.traffic["report"])
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] in names
    assert set(cell.limits)


# the keys the contract allows a configs entry, and no other: a
# configuration's ``assumed`` lives in its file alone
CONFIG_ENTRY_KEYS = {"name", "source", "file", "reduced", "why"}


def test_configs_and_paths_follow_the_contract():
    paths = SPEC["paths"]
    for c in SPEC["configs"]:
        assert set(c) == CONFIG_ENTRY_KEYS
        assert any(c["file"].startswith(p + "/") for p in paths)
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        # every key changed from the source is one the file states, and
        # the file says why beside the others it assumed
        assert isinstance(cfg["assumed"], dict)
        for key in cfg["reduced"]:
            assert key in cfg and key in cfg["assumed"], key
    assert {w["config"] for w in SPEC["workloads"]} == \
        {c["name"] for c in SPEC["configs"]}


def test_added_files_are_found_without_editing_the_harness(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "fhe_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench = root / "fhe_bench"
    (bench / "configs" / "ckks-toy.json").write_text(
        json.dumps({**toy.CKKS_CONFIG, "source": "toy", "reduced": []}))
    traffic = json.loads((bench / "traffic" /
                          "ckks-mult-relin-rescale-rotate.json").read_text())
    (bench / "traffic" / "ckks-toy-mix.json").write_text(
        json.dumps({**traffic, "pool": 2}))
    (bench / "cells" / "ckks-toy-cell.json").write_text(
        json.dumps({"limits": {"slot_rms_err": 1e-9}}))
    (bench / "metrics" / "toy_metric.py").write_text(
        "def read(summary):\n    return 1.0\n")
    spec["configs"].append({"name": "ckks-toy", "source": "toy",
                            "file": "fhe_bench/configs/ckks-toy.json",
                            "reduced": [], "why": "toy"})
    spec["workloads"].append({"name": "ckks-toy-cell", "config": "ckks-toy",
                              "traffic": "ckks-toy-mix", "chips": 1,
                              "why": "toy"})
    spec["per_layer"].append({"name": "toy_metric.ckks", "unit": "%",
                              "better": "higher", "source": "device_trace",
                              "layer": "kernels", "moves": "setup_s",
                              "workloads": ["ckks-toy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.resolve("ckks-toy-cell", root)
    assert cell.config["ring_dim"] == 4096 and cell.traffic["pool"] == 2
    assert [m["name"] for m in cell.per_layer] == ["toy_metric.ckks"]
    assert harness.reader("toy_metric.ckks", root)(None) == 1.0
    result = harness.run_cell(cell, 7, 0.5, False, "cpu",
                              time.perf_counter(), root)
    assert result["correct"]


# shapes of PERF.md's table of kernels (section 6)
NTT_SHAPES = [(8, 8, 65536), (16, 16, 65536), (1, 1, 65536), (22, 11, 65536),
              (33, 11, 65536), (84, 28, 65536), (21, 21, 32768),
              (84, 21, 32768), (42, 14, 32768), (66, 11, 65536),
              (84, 14, 32768), (57, 19, 65536), (1, 1, 8192),
              (8448, 33, 256)]
NTT_SMALL_SHAPES = [(r, 1, 1024) for r in (1, 2, 4, 6, 8, 12, 16, 24, 32, 48,
                                           96, 6036, 27588, 65535)] + \
    [(1, 1, 2048), (8, 1, 2048), (16, 1, 2048), (4600, 1, 2048),
     (2676, 1, 1024), (96, 1, 256), (24, 8, 2048)]
KS_SHAPES = [((3, 11, 65536), {}), ((3, 28, 65536), {}),
             ((3, 14, 32768), {}), ((15, 10, 32768), {}),
             ((3, 19, 65536), {}), ((3, 11, 65536), {"rows_on_device": True}),
             ((6, 4, 1024), {"key_rows": 1, "mono_rows": 4}),
             ((6, 130, 1024), {"key_rows": 1, "rows_on_device": True,
                               "mono_rows": 90}),
             ((4, 4, 2048), {"key_rows": 1, "mono_rows": 3}),
             ((6, 1, 1024), {"key_rows": 1}), ((6, 1, 256), {"key_rows": 1}),
             ((6, 2048, 1024), {"key_rows": 1, "rows_on_device": True,
                                "mono_rows": 1300})]


@pytest.fixture(scope="module")
def chip_smoke():
    import sys
    sys.path.insert(0, str(harness.ROOT))
    import chip_smoke as cs
    return cs


@pytest.mark.parametrize("rows,towers,n", NTT_SHAPES)
def test_ntt_bound_is_chip_smokes(chip_smoke, rows, towers, n):
    want = chip_smoke.ntt_bound(rows, towers, n)["bound_ms"] / 1e3
    assert roofline.ntt_bound(rows, towers, n) == pytest.approx(want,
                                                                rel=1e-12)


@pytest.mark.parametrize("rows,towers,n", NTT_SMALL_SHAPES)
def test_ntt_small_bound_is_chip_smokes(chip_smoke, rows, towers, n):
    want = chip_smoke.ntt_small_bound(rows, towers, n)["bound_ms"] / 1e3
    assert roofline.ntt_small_bound(rows, towers, n) == pytest.approx(
        want, rel=1e-12)
    assert roofline.ntt_any_bound(rows, towers, n) == pytest.approx(
        want, rel=1e-12)


@pytest.mark.parametrize("shape,kw", KS_SHAPES)
def test_ks_bound_is_chip_smokes(chip_smoke, shape, kw):
    want = chip_smoke.ks_bound(*shape, **kw)["bound_ms"] / 1e3
    assert roofline.ks_bound(*shape, **kw) == pytest.approx(want, rel=1e-12)


def _imports(path: Path) -> set:
    """Top-level names of every module a file imports, relative imports
    resolved inside fhe_bench."""
    rel = path.relative_to(harness.ROOT).with_suffix("").parts
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = rel[:len(rel) - node.level]
                mod = ".".join(base + ((node.module,) if node.module else ()))
                out.update(f"{mod}.{a.name}" for a in node.names)
            else:
                out.add(node.module)
    return out


SOURCES = sorted(harness.BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole():
    assert "openfhe_tpu_torch".split(".", 1)[0] not in harness.FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sorted((harness.BENCH_DIR / "reference").rglob("*.py")):
        for m in _imports(path):
            top = m.split(".", 1)[0]
            assert top != "openfhe_tpu_torch", (path, m)
            if top == "fhe_bench":
                assert m.startswith("fhe_bench.reference"), (path, m)


# ---------------------------------------------------------------------------
# The plain reference against the port, at toy sizes on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [14, 27, 45, 55, 59, 60])
def test_reference_mulmod_is_exact(bits):
    from openfhe_tpu_torch.utils import nbtheory
    from fhe_bench.reference.modarith import mulmod
    q = nbtheory.first_prime(bits, 2 ** 17)
    gen = torch.Generator().manual_seed(bits)
    a = torch.cat([torch.randint(0, q, (4000,), generator=gen),
                   torch.tensor([0, 1, q - 1, q - 1])])
    b = torch.cat([torch.randint(0, q, (4000,), generator=gen),
                   torch.tensor([q - 1, q - 1, 1, q - 1])])
    want = [x * y % q for x, y in zip(a.tolist(), b.tolist())]
    assert mulmod(a, b, torch.tensor(q)).tolist() == want


@pytest.mark.parametrize("n,bits", [(1024, 27), (4096, 45), (4096, 55),
                                    (4096, 59), (4096, 60)])
def test_reference_ntt_is_the_ports(n, bits):
    from openfhe_tpu_torch.ops import ntt
    from openfhe_tpu_torch.utils import nbtheory
    q = nbtheory.first_prime(bits, 2 * n)
    qs = (q, nbtheory.previous_prime(q, 2 * n))
    gen = torch.Generator().manual_seed(n + bits)
    x = torch.stack([torch.randint(0, q, (3, n), generator=gen)
                     for q in qs], 1)
    r = NTT(n, qs, "cpu")
    assert torch.equal(r.forward(x), ntt.forward(x, qs))
    assert torch.equal(r.inverse(x), ntt.inverse(x, qs))


def _toy_ckks():
    from openfhe_tpu_torch.models import ckks
    c = toy.CKKS_CONFIG
    params = ckks.CKKSParams(
        ring_dim=c["ring_dim"], mult_depth=c["mult_depth"],
        scaling_mod_size=c["scaling_mod_size"],
        first_mod_size=c["first_mod_size"], dnum=c["dnum"])
    ctx = ckks.gen_context(params, "cpu")
    assert list(ctx.q_moduli) == c["q_moduli"]
    assert list(ctx.p_moduli) == c["p_moduli"]
    return ckks, ctx


def test_reference_ckks_encrypt_decrypt_agree_with_the_port():
    from openfhe_tpu_torch import dcrt
    ckks, ctx = _toy_ckks()
    n = ctx.n
    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(3)
    secret = ref_ckks.ternary(n, rng)
    sk = ckks.SecretKey(secret)
    scheme = ref_ckks.Scheme(n, ctx.q_moduli, ctx.scale, secret, 3.19,
                             "cpu")
    z = ref_ckks.unit_disk(1, n // 2, gen, "cpu")
    c0, c1 = scheme.encrypt(z, gen)
    basis = ctx.basis()
    ct = ckks.Ciphertext((dcrt.RnsPoly(c0[0], basis, dcrt.Format.EVAL),
                          dcrt.RnsPoly(c1[0], basis, dcrt.Format.EVAL)),
                         ctx.scale)
    port = ckks.decrypt(ctx, sk, ct, num_slots=n // 2)
    assert np.abs(port - z[0].numpy()).max() < 1e-9
    pk, _ = ckks.keygen(ctx, np.random.default_rng(4))
    # the port's own encryption under the reference's secret
    pk_sk = ckks.SecretKey(secret)
    a = pk.a
    e = ckks._sample_error_poly(ctx, basis, rng)
    pk = ckks.PublicKey(dcrt.sub(e, dcrt.mul(a, pk_sk.poly(basis, "cpu"))),
                        a)
    v = rng.uniform(-1, 1, n // 2)
    ct2 = ckks.encrypt(ctx, pk, v, rng)
    centered = scheme.decrypt(ct2.polys[0].data, ct2.polys[1].data)
    assert bool((centered == centered[:1]).all())
    got = scheme.decode(centered[0], ct2.scale).numpy()
    assert np.abs(got - v).max() < 1e-6


def test_reference_follows_the_ports_operations():
    spec = toy.cell("ckks-d20-mult-rotate")
    from fhe_bench.schemes import ckks as scheme
    c = scheme.Cell(spec.config, spec.traffic, 5, torch.device("cpu"),
                    harness.SetupParts())
    outs = [(i, c.request(i)) for i in range(2)]
    checks = c.check(outs)
    assert checks["tower_mismatch"] == 0
    assert checks["slot_rms_err"] < spec.limits["slot_rms_err"]


def test_ckks_control_is_not_correct():
    """The reference in the program's place, its slots in complex64, run
    as control.py runs it: through the run's own check and limits."""
    spec = toy.cell("ckks-d20-mult-rotate")
    result = harness.run_cell(spec, 2 ** 31 + 5, 0.3, False, "cpu",
                              time.perf_counter(), control=True)
    compared = result["compared"]
    assert not result["correct"], compared
    assert result["failed"] == 0
    assert compared["tower_mismatch"]["value"] == 0
    assert compared["slot_rms_err"]["value"] > \
        compared["slot_rms_err"]["limit"]


def test_reference_lwe_agrees_with_the_port():
    from openfhe_tpu_torch.models import binfhe
    ctx = binfhe.gen_context("TOY", "cpu")
    p = ctx.params
    rng = np.random.default_rng(9)
    gen = torch.Generator().manual_seed(9)
    s = ref_binfhe.ternary(p.n_lwe, rng)
    sk = binfhe.BinFHESecret(s, ref_binfhe.ternary(p.N, rng))
    bits = torch.randint(0, 2, (64,), generator=gen)
    a, b = ref_binfhe.encrypt(bits, torch.from_numpy(s), p.q, p.sigma, gen)
    for k in range(64):
        ct = binfhe.LWECiphertext(a[k], int(b[k]), p.q)
        assert binfhe.decrypt(ctx, sk, ct) == int(bits[k])
    mine = [binfhe.encrypt(ctx, sk, int(x), rng) for x in bits]
    ph = ref_binfhe.phase(torch.stack([c.a for c in mine]),
                          torch.tensor([c.b for c in mine]),
                          torch.from_numpy(s), p.q)
    assert torch.equal(ref_binfhe.decode(ph, p.q), bits)


@pytest.mark.parametrize("workload", CELLS)
def test_toy_run_is_correct(workload):
    result = harness.run_cell(toy.cell(workload), 2 ** 31 + 17, 0.5, False,
                              "cpu", time.perf_counter())
    assert result["correct"], result
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in
                                      harness.resolve(workload).end_to_end}
    assert list(result)[-1] == "compared"


def test_binfhe_control_fails_the_limits():
    """The cell's own configuration with its control (a gadget one digit
    shorter) at a batch of 4, run as control.py runs it: through the run's
    own check and limits."""
    spec = copy.deepcopy(harness.resolve("binfhe-std128-and-b4096"))
    spec.traffic["batch"] = 4
    result = harness.run_cell(spec, 21, 0.0, False, "cpu",
                              time.perf_counter(), control=True)
    compared = result["compared"]
    assert not result["correct"], compared
    assert result["failed"] == 0
    assert any(v["value"] > v["limit"] for v in compared.values())


# ---------------------------------------------------------------------------
# The trace's reduction and the metric readers
# ---------------------------------------------------------------------------


class _Event:
    """The methods of a raw profiler event that the reduction reads."""

    def __init__(self, name, start, end, device=False, corr=0):
        self._name, self._start, self._end, self._corr = \
            name, start, end, corr
        self._device = device

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def correlation_id(self):
        return self._corr

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._device else \
            torch.autograd.DeviceType.CPU

    def activity_type(self):
        return "kernel" if self._device else "cpu_op"


def test_summarize_attributes_device_time_to_wrapper_calls():
    events = [
        _Event(tracing.WINDOW, 10, 110),
        _Event(tracing.SPAN + "op.rotate", 10, 100),
        _Event(tracing.SPAN + "ntt#0", 11, 14),
        _Event("cudaLaunchKernel", 12, 13, corr=5),
        _Event(tracing.SPAN + "ntt#0", 20, 50, device=True, corr=5),
        _Event("ntt_kernel", 20, 50, device=True, corr=5),
        _Event("aten::add", 55, 60),
        _Event("cudaLaunchKernel", 56, 57, corr=6),
        _Event("add_kernel", 60, 70, device=True, corr=6),
        _Event("copy_kernel", 65, 80, device=True, corr=7),
        _Event("early", 0, 5, device=True, corr=8),
    ]
    calls = [tracing.Call("ntt", (2, 4096), towers=2)]
    s = tracing.summarize(events, calls, requests=2)
    assert s.device_ops == 3 and s.linked == 2
    assert s.busy_s == pytest.approx(50e-9)
    assert s.window_s == pytest.approx(100e-9)
    assert s.device_s == pytest.approx(55e-9)
    assert calls[0].device_s == pytest.approx(30e-9)
    assert calls[0].device_ops == 1
    assert s.idle_gaps[0] == ["rotate", pytest.approx(30e-9)]
    assert s.idle_gaps[1] == ["rotate / aten::add", pytest.approx(10e-9)]
    assert s.top_ops[0] == ["ntt_kernel", pytest.approx(30e-9)]
    got = {m: harness.reader(m)(s) for m in
           ("ntt_roofline.ckks", "ks_roofline.ckks",
            "plain_torch_ms_per_req.ckks", "launches_per_req.ckks",
            "device_idle_pct.ckks")}
    assert got["ntt_roofline.ckks"] == pytest.approx(
        100 * roofline.ntt_bound(2, 2, 4096) / 30e-9)
    assert got["ks_roofline.ckks"] is None
    assert got["plain_torch_ms_per_req.ckks"] == pytest.approx(12.5e-6)
    assert got["launches_per_req.ckks"] == 1.5
    assert got["device_idle_pct.ckks"] == pytest.approx(50.0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_traced_toy_run_on_the_card(cuda_device, workload):
    result = harness.run_cell(toy.cell(workload), 11, 0.5, True,
                              cuda_device, time.perf_counter())
    assert result["correct"], result
    assert result["device"]["busy_s"] > 0
    for name in ("launches_per_req", "device_idle_pct"):
        assert any(k.startswith(name) for k in result["metrics"])
