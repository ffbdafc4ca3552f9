"""The port's distributed four-step NTT, collectives, mesh helpers and routed
CKKS step against the JAX package and the port's single-rank functions.

The multi-rank checks run 4 gloo ranks on the CPU as a 2 x 2 and as a
1 x 4 ("tower", "coeff") mesh. The ranks are separate processes started
from ``tests/torch_dist_worker.py``, which imports no JAX; they meet through
a file under the test's temporary directory (no TCP port, so parallel test
workers cannot collide) and save what they computed for this process to
compare. The comparisons are equalities, not tolerances.
"""

import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import torch_dist_worker as worker
from openfhe_tpu.models import ckks as jckks
from openfhe_tpu.ops import limb
from openfhe_tpu.parallel import dntt as jdntt
from openfhe_tpu_torch import convert
from openfhe_tpu_torch.ops import ntt
from openfhe_tpu_torch.parallel import dntt
from openfhe_tpu_torch.utils import nbtheory

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MESHES = {"2x2": 2, "1x4": 1}     # tower_par of each mesh
TIMEOUT = 120                     # seconds for the 4 ranks together


def _start(tmp: Path, tower_par: int) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    script = str(Path(worker.__file__))
    return [subprocess.Popen(
        [sys.executable, script, str(r), str(WORLD), str(tower_par),
         str(tmp / "init"), str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]


def _collect(tmp: Path, procs: list) -> list:
    logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both meshes' ranks, started at once so that they run while this
    process compiles the JAX side."""
    runs = {}
    for name, tower_par in MESHES.items():
        tmp = tmp_path_factory.mktemp(f"mesh{name}")
        runs[name] = (tmp, _start(tmp, tower_par))
    yield runs
    for _, procs in runs.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, spawned, jax_step):
    return request.param, _collect(*spawned[request.param])


def _jax_rows(u64):
    return torch.from_numpy(np.asarray(limb.to_int_array(u64)).astype(
        np.int64))


@lru_cache(maxsize=None)
def _jitted(fn, mods):
    return jax.jit(lambda a: fn(a, worker.N1, worker.N2, mods))


def _jax_four_step(fn, x, mods):
    """A JAX four-step transform with no mesh, jitted as the JAX tests run
    it, on the same residues."""
    return _jax_rows(_jitted(fn, mods)(limb.from_int_array(x.numpy())))


def _jax_forward(x, mods):
    return _jax_four_step(jdntt.four_step_forward, x, mods)


@pytest.mark.parametrize("n1,n2", [(32, 16), (16, 16), (256, 256)])
def test_output_perm_is_identity(n1, n2):
    assert np.array_equal(dntt.output_perm(n1, n2), np.arange(n1 * n2))
    assert np.array_equal(dntt.output_perm(n1, n2),
                          jdntt.output_perm(n1, n2))


@pytest.mark.parametrize("n1,n2,bits", [(32, 16, 55), (256, 256, 60)])
def test_twist_values_equal_jax(n1, n2, bits):
    mods = tuple(nbtheory.generate_prime_chain(2, bits, n1 * n2))
    assert dntt.twist_values(n1, n2, mods) == \
        tuple(jdntt.twist_values(n1, n2, mods))
    # the forward twist is the single-card NTT's twist; its untwist is not
    # (ops/ntt.py folds 1/n into it)
    for q, t in zip(mods, ntt.tables(n1 * n2, mods, "cpu").tw[:2]
                    .transpose(0, 1)):
        assert np.array_equal(dntt._twist_array(n1, n2, q)[:2], t.numpy())


@pytest.mark.parametrize("lead", worker.LEADS, ids=str)
def test_four_step_local_equals_jax_and_ntt(lead):
    mods = worker.moduli()
    x = worker.residues(mods, lead, seed=3)
    y = dntt.four_step_forward(x, worker.N1, worker.N2, mods)
    assert torch.equal(y, _jax_forward(x, mods))
    assert torch.equal(y, ntt.forward(x, mods))
    assert torch.equal(dntt.standard_order(y, worker.N1, worker.N2), y)
    back = dntt.four_step_inverse(y, worker.N1, worker.N2, mods)
    assert torch.equal(back, x)
    assert torch.equal(back, ntt.inverse(y, mods))
    if not lead:
        jback = _jax_four_step(jdntt.four_step_inverse, y, mods)
        assert torch.equal(jback, back)


def test_four_step_over_the_mesh(ranks):
    shape, results = ranks
    mods = worker.moduli()
    for i, lead in enumerate(worker.LEADS):
        x = worker.residues(mods, lead, seed=i)
        want = _jax_forward(x, mods)
        assert torch.equal(want, ntt.forward(x, mods))
        for r, res in enumerate(results):
            assert torch.equal(res[f"forward{i}"], want), (shape, r, lead)
            assert torch.equal(res[f"inverse{i}"], x), (shape, r, lead)


def test_shard_map_four_step(ranks):
    _, results = ranks
    mods = worker.moduli()
    x = worker.residues(mods, (), seed=0)
    want = _jax_forward(x, mods)
    assert torch.equal(want, ntt.forward(x, mods))
    for res in results:
        assert torch.equal(res["shard_map"], want)


def test_tower_psum(ranks):
    _, results = ranks
    want = worker.psum_partials().sum(dim=0)
    for res in results:
        assert torch.equal(res["psum"], want)


def test_mesh_shape_and_blocks(ranks):
    shape, results = ranks
    tower_par = MESHES[shape]
    x = worker.residues(worker.moduli(), (), seed=0)
    blocks = []
    for res in results:
        assert res["shape"] == (tower_par, WORLD // tower_par)
        assert torch.equal(res["gathered"], x)
        blocks.append(res["block"])
    # rank r = t * coeff + c holds towers block t and coefficients block c
    coeff = WORLD // tower_par
    grid = [torch.cat(blocks[t * coeff:(t + 1) * coeff], dim=-1)
            for t in range(tower_par)]
    assert torch.equal(torch.cat(grid, dim=-2), x)
    digits = torch.stack([x, x + 1, x + 2])
    for res, block in zip(results, blocks):
        assert torch.equal(res["digits"], digits)
        assert torch.equal(res["tree"][0], block)     # split like shard_poly
        assert torch.equal(res["tree"][1], x[0])      # 1-D: replicated
        assert res["layouts"] == (("tower", "coeff"), ())


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's MultRelin + rescale from the workers' seed."""
    rng = np.random.default_rng(worker.CKKS_SEED)
    ctx = jckks.gen_context(jckks.CKKSParams(**worker.CKKS))
    pk, sk = jckks.keygen(ctx, rng)
    evk = jckks.relin_keygen(ctx, sk, rng)
    ct1 = jckks.encrypt(ctx, pk, rng.uniform(-1, 1, worker.N // 2), rng)
    ct2 = jckks.encrypt(ctx, pk, rng.uniform(-1, 1, worker.N // 2), rng)
    out = jckks.rescale_ctx(ctx, jckks.eval_mult_relin(ct1, ct2, evk))
    return [convert.poly_from_jax(p, "cpu").data for p in out.polys]


def test_routed_ckks_step_equals_unrouted_and_jax(ranks, jax_step):
    _, results = ranks
    for res in results:
        for got, unrouted, want in zip(res["routed"], res["unrouted"],
                                       jax_step):
            assert torch.equal(got, unrouted)
            assert torch.equal(got, want)
        # the hybrid key switch's four NTTs took the routed path
        assert res["mult_relin_calls"] == (2, 2)
