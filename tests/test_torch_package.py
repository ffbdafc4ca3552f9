"""The port stands apart from JAX: no module of ``openfhe_tpu_torch`` imports
jax or anything of ``openfhe_tpu``, the slices (the CKKS main path, the
bootstrap, BGV and BFV, threshold FHE, PRE, the archives, BINFHE with
LMKCDEY, scheme switching, trapdoors, profiling and the four-step NTT) run on
the CPU (when asked to) without loading either, and the CUDA-only paths
raise instead of falling back when they get what they do not take or find
no card; the distributed NTT raises instead of running locally when its
process group is gone.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from openfhe_tpu_torch import _build, convert, entry
from openfhe_tpu_torch.models import (bfv, bgv, binfhe, ckks, multiparty,
                                      pre, scheme_switch)
from openfhe_tpu_torch.ops import modular, ntt, rns
from openfhe_tpu_torch.utils import serial

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "openfhe_tpu_torch"


def _imports(path: Path):
    """Absolute module names imported by one source file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            for alias in node.names:
                yield f"{node.module}.{alias.name}"


SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
SLICE_MODULES = ["ckks.py", "ckks_advanced.py", "ckks_bootstrap.py",
                 "ckks_fft.py", "bgv.py", "bfv.py", "rns.py", "keyswitch.py",
                 "encoding.py", "multiparty.py", "pre.py", "serial.py",
                 "binfhe.py", "scheme_switch.py", "trapdoor.py", "prng.py",
                 "field2n.py", "matrix.py", "profiling.py", "mesh.py",
                 "dntt.py", "collectives.py", "entry.py"]
EXAMPLE_NAMES = sorted(p.stem for p in (ROOT / "examples").glob("*.py")
                       if p.stem != "common")


def test_guard_covers_every_slice_module():
    assert set(SLICE_MODULES) <= {p.name for p in SOURCES}
    ported = {p.relative_to(PORT).as_posix() for p in SOURCES
              if p.is_relative_to(PORT)}
    assert {f"examples/{n}.py" for n in EXAMPLE_NAMES} | \
        {"examples/_common.py"} <= ported


def test_chip_smoke_runs_every_example():
    """Phase 23 of chip_smoke.py runs each example program on the card."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    listed = next(ast.literal_eval(node.value) for node in tree.body
                  if isinstance(node, ast.Assign)
                  and getattr(node.targets[0], "id", None) == "EXAMPLES")
    assert sorted(listed) == EXAMPLE_NAMES
    assert len(listed) == len(set(listed))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_and_only_shared_host_modules(path):
    """Nothing of jax and nothing of the JAX package, not even a module
    there that does not import jax (the port keeps its own copies)."""
    for name in _imports(path):
        assert name.split(".")[0] not in ("jax", "openfhe_tpu"), \
            f"{path} imports {name}"


SLICE = """
import sys
before = "jax" in sys.modules
import numpy as np
from openfhe_tpu_torch.models import ckks
params = ckks.CKKSParams(ring_dim=64, mult_depth=2, scaling_mod_size=50,
                         first_mod_size=60, dnum=2)
ctx = ckks.gen_context(params, "cpu")
rng = np.random.default_rng(1)
pk, sk = ckks.keygen(ctx, rng)
evk = ckks.relin_keygen(ctx, sk, rng)
rk = ckks.rot_keygen(ctx, sk, [1], rng)[1]
v1, v2 = rng.uniform(-1, 1, 32), rng.uniform(-1, 1, 32)
ct = ckks.eval_mult_relin(ckks.encrypt(ctx, pk, v1, rng),
                          ckks.encrypt(ctx, pk, v2, rng), evk)
out = ckks.decrypt(ctx, sk, ckks.eval_rotate(ckks.rescale(ct), 1, rk), 32)
print(float(np.max(np.abs(out.real - np.roll(v1 * v2, -1)))))
from openfhe_tpu_torch.models import ckks_bootstrap as boot
params = ckks.CKKSParams(ring_dim=64, mult_depth=18, scaling_mod_size=35,
                         first_mod_size=50, dnum=3, secret_hw=16)
ctx = ckks.gen_context(params, "cpu")
pk, sk = ckks.keygen(ctx, rng)
pre = boot.setup(ctx, slots=4)
keys = boot.keygen(ctx, sk, pre, rng)
vals = np.array([0.25, -0.5, 0.75, 0.125])
low = ckks.level_reduce(ckks.encrypt(ctx, pk, np.tile(vals, 8), rng), 18)
out = boot.eval_bootstrap(ctx, keys, pre, low)
staged = boot.setup(ctx, slots=4, level_budget=(2, 2))
print(out.towers, float(np.max(np.abs(ckks.decrypt(ctx, sk, out, 4).real
                                      - vals))), len(staged.cts))
from openfhe_tpu_torch.models import bfv, bgv
ctx = bgv.gen_context(bgv.BGVParams(ring_dim=64, mult_depth=2,
                                    plaintext_modulus=257, mod_size=50,
                                    dnum=2), "cpu")
pk, sk = bgv.keygen(ctx, rng)
evk = bgv.relin_keygen(ctx, sk, rng)
v = rng.integers(0, 257, 64)
ct = bgv.encrypt(ctx, pk, v.tolist(), rng)
ct = bgv.mod_reduce(ctx, bgv.eval_mult_relin(ct, ct, evk))
bgv_ok = bgv.decrypt(ctx, sk, ct) == (v * v % 257).tolist()
ctx = bfv.gen_context(bfv.BFVParams(ring_dim=64, plaintext_modulus=257,
                                    num_towers=2, mod_size=50, dnum=2), "cpu")
pk, sk = bfv.keygen(ctx, rng)
evk = bfv.relin_keygen(ctx, sk, rng)
ct = bfv.encrypt(ctx, pk, v.tolist(), rng)
prods = [bfv.relinearize(m(ctx, ct, ct), evk) for m in
         (bfv.eval_mult, bfv.eval_mult_povq, bfv.eval_mult_behz)]
bfv_ok = all(bfv.decrypt(ctx, sk, p) == (v * v % 257).tolist()
             for p in prods)
print(bgv_ok, bfv_ok)
import os, tempfile
from openfhe_tpu_torch.models import multiparty as mp, pre
from openfhe_tpu_torch.utils import serial
ctx = bfv.gen_context(bfv.BFVParams(ring_dim=64, plaintext_modulus=257,
                                    num_towers=2, mod_size=50, dnum=2), "cpu")
pk1, s1 = mp.keygen_lead(ctx, rng)
pk, s2 = mp.keygen_join(ctx, pk1, rng)
r1 = [mp.evalmult_round1(ctx, s1, rng)]
r1.append(mp.evalmult_round1(ctx, s2, rng, prev_key=r1[0]))
ab = mp.evalmult_accumulate_round1(r1)
evk = mp.evalmult_finalize([mp.evalmult_round2(ctx, s, ab, rng)
                            for s in (s1, s2)])
ct = bfv.eval_mult_relin(ctx, bfv.encrypt(ctx, pk, v.tolist(), rng),
                         bfv.encrypt(ctx, pk, v.tolist(), rng), evk)
with tempfile.TemporaryDirectory() as d:
    serial.save(ct, os.path.join(d, "ct"), "json")
    ct = serial.load(os.path.join(d, "ct"), "cpu")
parts = [mp.decrypt_lead(ctx, s1, ct, rng), mp.decrypt_main(ctx, s2, ct, rng)]
mp_ok = mp.combine(ctx, ct, parts) == (v * v % 257).tolist()
pk3, s3 = bfv.keygen(ctx, rng)
rk = pre.rekey_gen(ctx, mp.joint_secret(ctx, [s1, s2]), s3, rng)
moved = pre.re_encrypt(ct, rk, ctx=ctx, pk=pk, mode="FIXED_NOISE_HRA",
                       rng=rng)
print(mp_ok, bfv.decrypt(ctx, s3, moved) == (v * v % 257).tolist())
from openfhe_tpu_torch.models import binfhe
ctx = binfhe.gen_context("TOY", "cpu")
sk = binfhe.keygen(ctx, rng)
bk = binfhe.bootstrap_keygen(ctx, sk, rng)
cts = [binfhe.encrypt(ctx, sk, x, rng) for x in (0, 1)]
outs = binfhe.eval_gate_batch(ctx, "XOR", bk, cts * 2, cts[::-1] + cts)
print([binfhe.decrypt(ctx, sk, o) for o in outs])
ctx = binfhe.gen_context("TOY_LMKCDEY", "cpu")
sk = binfhe.keygen(ctx, rng)
bk = binfhe.bootstrap_keygen(ctx, sk, rng)
one = binfhe.encrypt(ctx, sk, 1, rng)
lmk = binfhe.decrypt(ctx, sk, binfhe.eval_gate(ctx, "AND", bk, one, one))
from openfhe_tpu_torch.models import scheme_switch as ss
from openfhe_tpu_torch.utils import nbtheory
fctx = binfhe.gen_context(binfhe.BinFHEParams(
    n_lwe=8, N=256, Q=nbtheory.first_prime(27, 512), q_ks=1 << 14,
    log_bg=10, log_bks=5), "cpu")
fsk = binfhe.keygen(fctx, rng)
ctx = ckks.gen_context(ckks.CKKSParams(ring_dim=64, mult_depth=13,
                                       scaling_mod_size=35, first_mod_size=50,
                                       dnum=3, secret_hw=16), "cpu")
pk, sk = ckks.keygen(ctx, rng)
sw = ss.setup(ctx, fctx, slots=8, cheb_deg=8)
keys = ss.keygen(ctx, fctx, sw, sk, fsk, pk, rng)
ct = ckks.encrypt(ctx, pk, np.tile(np.arange(8.0), 4), rng)
lwes = ss.eval_ckks_to_fhew(ctx, fctx, sw, keys, ct, 8, 8)
print(lmk, [binfhe.decrypt_zp(fctx, fsk, c, 8) for c in lwes])
from openfhe_tpu_torch import dcrt
from openfhe_tpu_torch.models import trapdoor as td
from openfhe_tpu_torch.ops import ntt
from openfhe_tpu_torch.parallel import dntt
from openfhe_tpu_torch.utils import prng, profiling
q = nbtheory.first_prime(24, 64)
A, T = td.trapdoor_gen(32, q, 2, td.SIGMA, prng.Blake2Engine(4), "cpu")
u = A[1]
with profiling.timed("gauss_samp_exact") as r:
    x = td.gauss_samp_exact(32, q, 2, A, T, u, rng)
    r.block_on(x)
y = dntt.four_step_forward(u.data, 8, 4, (q,))
print(bool((td.apply_A(A, x).data == u.data).all()),
      bool((y == ntt.forward(u.data, (q,))).all()))
print(before, "jax" in sys.modules)
print(sorted(m for m in sys.modules
             if m == "openfhe_tpu" or m.startswith("openfhe_tpu.")))
"""


def test_slice_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", SLICE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    err, booted, exact, threshold, gates, switched, trapdoor, flags, \
        jax_package = proc.stdout.strip().splitlines()[-9:]
    assert exact == "True True", "BGV or BFV did not decrypt exactly"
    assert threshold == "True True", "threshold or PRE did not decrypt"
    assert gates == "[1, 1, 0, 0]", "the BINFHE XOR gates did not decrypt"
    assert switched == "1 [0, 1, 2, 3, 4, 5, 6, 7]", \
        "the LMKCDEY AND or the CKKS -> FHEW switch did not decrypt"
    assert trapdoor == "True True", \
        "A.x != u, or the four-step NTT differs from the NTT"
    assert float(err) < 1e-6
    towers, boot_err, factors = booted.split()
    assert int(towers) > 3 and float(boot_err) < 5e-2 and factors == "2"
    before, after = flags.split()
    if before == "False":
        assert after == "False", "importing the port loaded jax"
    assert jax_package == "[]", "the port loaded modules of the JAX package"


def test_kernel_paths_refuse_cpu_tensors():
    """A CPU tensor handed to a kernel launch raises; it is never quietly
    sent to the twin."""
    t = ntt.tables(16, (97,), "cpu")
    x = torch.zeros((1, 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        ntt._launch("ntt_forward", x, t, True)
    with pytest.raises(ValueError, match="CUDA"):
        _build.require_cuda("fused_mac_mod", x)


def test_library_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the library loads")
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.library()


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    """With no device argument the entry points take the current CUDA
    device; without one they raise and name the remedy, and never fall back
    to the CPU by themselves. The threshold and PRE functions take the
    device of the context they are given."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    params = ckks.CKKSParams(ring_dim=64, mult_depth=1)
    zeros = np.zeros((1, 4), dtype=np.uint32)
    ctx = ckks.gen_context(params, "cpu")
    fctx = binfhe.gen_context("TOY", "cpu")
    rng = np.random.default_rng(3)
    pk, sk = multiparty.keygen_lead(ctx, rng)
    ct = ckks.encrypt(ctx, pk, [0.5], rng)
    serial.save(ct, tmp_path / "ct.npz")
    assert serial.load(tmp_path / "ct.npz", "cpu").polys[0].device == \
        ctx.device
    assert multiparty.keygen_join(ctx, pk, rng)[0].b.device == ctx.device
    assert multiparty.int_mp_boot_random_element_gen(ctx, rng).device == \
        ctx.device
    assert pre.rekey_gen(ctx, sk, sk, rng).b.device == ctx.device
    for call in (lambda: ckks.gen_context(params),
                 lambda: bgv.gen_context(bgv.BGVParams(ring_dim=64)),
                 lambda: bfv.gen_context(bfv.BFVParams(ring_dim=64)),
                 lambda: binfhe.gen_context("TOY"),
                 lambda: binfhe.gen_context("TOY_LMKCDEY"),
                 lambda: scheme_switch.setup(ckks.gen_context(params), fctx,
                                             slots=8),
                 lambda: scheme_switch.keygen(
                     ckks.gen_context(params), fctx, None, sk, None, pk,
                     rng),
                 lambda: convert.u64_to_tensor(zeros, zeros),
                 lambda: modular.int_tensor([1, 2]),
                 lambda: modular.make_mod_consts([97]),
                 lambda: rns.switch_basis_tables((97,), (193,)),
                 lambda: serial.load(tmp_path / "ct.npz"),
                 lambda: convert.ckks_context_from_jax(ctx),
                 lambda: entry.entry(),
                 lambda: entry.dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert ckks.gen_context(params, "cpu").device == torch.device("cpu")


def test_library_name_tracks_the_sources(tmp_path, monkeypatch):
    """An edited kernel source gets a new library name, so it is rebuilt."""
    for src in _build.SRC_DIR.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    before = _build.library_path()
    assert before.parent == PORT / "build"
    with open(tmp_path / "ntt.cu", "a") as f:
        f.write("// edited\n")
    assert _build.library_path() != before


def test_routed_ntt_needs_its_process_group(tmp_path):
    """With a mesh set, to_eval/to_coeff and the key switch's NTTs go
    through the distributed four-step (bit-equal on a one-rank gloo group);
    once the group is gone they raise rather than run the local NTT."""
    import torch.distributed as dist
    from openfhe_tpu_torch import dcrt, keyswitch
    from openfhe_tpu_torch.parallel import dntt, mesh

    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh()
    params = ckks.CKKSParams(ring_dim=128, mult_depth=2, dnum=2)
    ctx = ckks.gen_context(params, "cpu")
    rng = np.random.default_rng(8)
    pk, sk = ckks.keygen(ctx, rng)
    evk = ckks.relin_keygen(ctx, sk, rng)
    ct = ckks.encrypt(ctx, pk, [0.5, -0.25], rng)
    want = keyswitch.apply(evk, ct.polys[1])
    coeff = dcrt.to_coeff(pk.b)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        dcrt.set_distributed_ntt(mesh.make_mesh(), min_n=128)
        calls = dntt.four_step_inverse.distributed_calls
        assert torch.equal(dcrt.to_coeff(pk.b).data, coeff.data)
        assert dntt.four_step_inverse.distributed_calls == calls + 1
        got = keyswitch.apply(evk, ct.polys[1])
        assert all(torch.equal(g.data, w.data) for g, w in zip(got, want))
        dist.destroy_process_group()
        with pytest.raises(RuntimeError, match="process group"):
            dcrt.to_eval(coeff)
        with pytest.raises(RuntimeError, match="process group"):
            keyswitch.apply(evk, ct.polys[1])
    finally:
        dcrt.set_distributed_ntt(None)
        if dist.is_initialized():
            dist.destroy_process_group()
    assert torch.equal(dcrt.to_eval(coeff).data, pk.b.data)
