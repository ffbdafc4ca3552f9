"""The port's MP12 trapdoors against the JAX package's, bit for bit.

One module-scoped run per configuration of each package from the same numpy
seed, at the JAX tests' sizes (``tests/test_trapdoor.py``,
``test_trapdoor_stack.py``): trapdoor_gen -> a uniform u -> gauss_samp ->
zsample_sigma_p -> gauss_samp_exact. A and T, both samplers' preimages and
the perturbation are equal (not close); the port's preimages satisfy
A.x = u exactly and the JAX tests' shortness bounds. The host samplers
(``_g_preimage``, ``gauss_samp_gq``, ``_g_lattice_basis``) give the same
integers from the same draws. The JAX side is jitted, as its own tests run
it.
"""

import numpy as np
import pytest
import torch

from openfhe_tpu import dcrt as jdcrt
from openfhe_tpu.models import trapdoor as jtd
from openfhe_tpu.ops import limb
from openfhe_tpu.utils import sampling as jsampling
from openfhe_tpu_torch import convert, dcrt
from openfhe_tpu_torch.models import trapdoor as td
from openfhe_tpu_torch.utils import nbtheory, sampling

SEED = 42
# name -> (n, bits of q, base, sigma of trapdoor_gen and gauss_samp)
CONFIGS = {"n32-24bit-base2": (32, 24, 2, td.SIGMA),
           "n64-20bit-base2": (64, 20, 2, 3.19),
           "n128-28bit-base4": (128, 28, 4, 3.19)}


def _drive(tdm, dcrtm, samplingm, n, bits, base, sigma, where):
    """trapdoor_gen, u, gauss_samp, zsample_sigma_p and gauss_samp_exact
    through one package (`where`: the port's device argument)."""
    rng = np.random.default_rng(SEED)
    q = nbtheory.first_prime(bits, 2 * n)
    A, T = tdm.trapdoor_gen(n, q, base, sigma, rng, *where)
    basis = dcrtm.RnsBasis(n, (q,))
    u_rows = samplingm.uniform_rns_rows(n, basis.moduli, rng)
    if where:
        u = dcrtm.from_int_rows(basis, u_rows, dcrtm.Format.EVAL, *where)
    else:
        u = dcrtm.make_poly(basis, limb.from_int_array(u_rows),
                            dcrtm.Format.EVAL)
    x = tdm.gauss_samp(n, q, base, A, T, u, sigma, rng)
    k = len(T.r)
    s = tdm.spectral_bound(n, k, base)
    ps = tdm.zsample_sigma_p(n, q, s, (base + 1) * tdm.SIGMA, T, rng)
    x_exact = tdm.gauss_samp_exact(n, q, base, A, T, u, rng)
    return dict(q=q, A=A, T=T, u=u, x=x, ps=ps, x_exact=x_exact)


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request):
    cfg = CONFIGS[request.param]
    return (_drive(jtd, jdcrt, jsampling, *cfg, ()),
            _drive(td, dcrt, sampling, *cfg, ("cpu",)), cfg)


def _same_polys(jpolys, tpolys):
    return len(jpolys) == len(tpolys) and all(
        convert.poly_from_jax(j, "cpu").basis == t.basis
        and convert.poly_from_jax(j, "cpu").fmt == t.fmt
        and torch.equal(convert.poly_from_jax(j, "cpu").data, t.data)
        for j, t in zip(jpolys, tpolys))


def test_trapdoor_gen_equals_jax(runs):
    jr, tr, _ = runs
    A, T = convert.trapdoor_from_jax(jr["A"], jr["T"], "cpu")
    assert len(tr["A"]) == len(tr["T"].r) + 2
    assert _same_polys(jr["A"], tr["A"])
    assert _same_polys(jr["T"].r, tr["T"].r)
    assert _same_polys(jr["T"].e, tr["T"].e)
    assert all(torch.equal(a.data, b.data) for a, b in zip(A, tr["A"]))


@pytest.mark.parametrize("sampler", ["x", "ps", "x_exact"])
def test_samplers_equal_jax(runs, sampler):
    jr, tr, _ = runs
    assert _same_polys(jr[sampler], tr[sampler])


@pytest.mark.parametrize("sampler", ["x", "x_exact"])
def test_preimage_is_exact_and_short(runs, sampler):
    """A.x == u exactly; shortness as the JAX tests bound it: the exact
    sampler within 6 spectral bounds, gauss_samp below q / 1000 at the
    28-bit q where tests/test_trapdoor.py states that bound."""
    _, tr, (n, bits, base, _) = runs
    q, A, x = tr["q"], tr["A"], tr[sampler]
    assert torch.equal(td.apply_A(A, x).data, tr["u"].data)
    worst = max(float(np.abs(td._poly_to_reals(xi, q)).max()) for xi in x)
    if sampler == "x_exact":
        assert worst < 6 * td.spectral_bound(n, len(tr["T"].r), base)
    elif bits >= 28:
        assert worst < q / 1000.0


def test_port_state_runs_in_jax(runs):
    """The port's A and preimage, carried over as uint32 planes, satisfy
    the JAX package's apply_A."""
    jr, tr, _ = runs
    planes = convert.trapdoor_to_numpy(tr["A"], tr["T"])
    basis = jr["A"][0].basis
    fmt = jdcrt.Format.EVAL
    A = [jdcrt.RnsPoly(lo, hi, basis, fmt) for lo, hi in planes["A"]]
    x = [jdcrt.RnsPoly(*convert.poly_to_numpy(p), basis, fmt)
         for p in tr["x_exact"]]
    got = jdcrt.to_int_rows(jtd.apply_A(A, x))
    want = jdcrt.to_int_rows(jr["u"])
    assert [int(v) for v in got[0]] == [int(v) for v in want[0]]
    r = [jdcrt.RnsPoly(lo, hi, basis, fmt) for lo, hi in planes["r"]]
    assert _same_polys(r, tr["T"].r)


@pytest.mark.parametrize("q_bits,base", [(20, 4), (20, 2), (27, 4)])
def test_g_preimage_equals_jax(q_bits, base):
    q = nbtheory.first_prime(q_bits, 256)
    k = -(-q.bit_length() // int(np.log2(base)))
    v = np.random.default_rng(7).integers(0, q, size=64)
    z = td._g_preimage(v, q, base, k, 3.19, np.random.default_rng(8))
    want = jtd._g_preimage(v, q, base, k, 3.19, np.random.default_rng(8))
    assert z.dtype == want.dtype and np.array_equal(z, want)
    assert np.abs(z).max() < 10 * base
    assert np.array_equal(td._g_lattice_basis(q, base, k),
                          jtd._g_lattice_basis(q, base, k))


@pytest.mark.parametrize("n,base", [(64, 2), (128, 4)])
def test_gauss_samp_gq_equals_jax(n, base):
    q = nbtheory.first_prime(20, 2 * n)
    k = -(-q.bit_length() // int(np.log2(base)))
    v = np.random.default_rng(9).integers(0, q, size=n, dtype=np.int64)
    stddev = (base + 1) * td.SIGMA
    z = td.gauss_samp_gq(v, stddev, k, q, base, np.random.default_rng(10))
    want = jtd.gauss_samp_gq(v, stddev, k, q, base,
                             np.random.default_rng(10))
    assert z.dtype == want.dtype and np.array_equal(z, want)
    g = np.array([pow(base, i, q) for i in range(k)], dtype=object)
    assert np.all(np.tensordot(g, z.astype(object), axes=(0, 0)) % q
                  == v.astype(object) % q)


def test_constants_equal_jax():
    assert (td.DG_ERROR, td.N_MAX, td.SIGMA, td.SPECTRAL_CONSTANT) == \
        (jtd.DG_ERROR, jtd.N_MAX, jtd.SIGMA, jtd.SPECTRAL_CONSTANT)
    assert td.spectral_bound(128, 14, 4) == jtd.spectral_bound(128, 14, 4)
