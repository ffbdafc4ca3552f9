"""The port's copies of the Blake2 PRNG, the exact discrete Gaussian,
Field2n and Matrix against the JAX package's originals: the same draws from
the same seed, and the same floats and elements, compared with equality
(``np.array_equal``), never within a tolerance. The engine drops into the
port's samplers and keygen as the numpy Generator does
(``tests/test_prng.py:26`` asks that of the original).
"""

import numpy as np
import pytest
import torch

from openfhe_tpu.models import ckks as jckks
from openfhe_tpu.utils import field2n as jfield2n
from openfhe_tpu.utils import matrix as jmatrix
from openfhe_tpu.utils import prng as jprng
from openfhe_tpu.utils import sampling as jsampling
from openfhe_tpu_torch import convert
from openfhe_tpu_torch.models import ckks
from openfhe_tpu_torch.utils import field2n, matrix, prng, sampling


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


# each draw in turn from one engine: the pool carries over between them
DRAWS = [("random_u32", (100,), {}), ("random_u64", (33,), {}),
         ("random_bit", (), {}), ("integers", (0, 10), dict(size=500)),
         ("integers", (5, 12), dict(size=(7, 3))),
         ("integers", (1 << 40,), dict(size=9)),
         ("integers", (-3, 3), dict(endpoint=True, size=20)),
         ("integers", (0, 1000), {}), ("random", (), dict(size=17)),
         ("random", (), {}), ("normal", (0.0, 3.19), dict(size=101)),
         ("normal", (2.0, 1.0), {}),
         ("choice", (10,), dict(size=6, replace=False)),
         ("choice", ([-1, 1],), dict(size=8)), ("choice", (5,), {})]


@pytest.mark.parametrize("seed", [0, 42, b"\x01\x02"])
def test_blake2_engine_streams_equal(seed):
    mine, theirs = prng.Blake2Engine(seed), jprng.Blake2Engine(seed)
    for name, args, kw in DRAWS:
        assert _same(getattr(mine, name)(*args, **kw),
                     getattr(theirs, name)(*args, **kw)), name
    assert mine._counter == theirs._counter


MODULI = (1073479681, 1152921504606830593)
SAMPLERS = {"ternary": lambda m, r: m.ternary_coeffs(256, r),
            "gaussian": lambda m, r: m.gaussian_coeffs(256, r),
            "sparse": lambda m, r: m.sparse_ternary_coeffs(128, 32, r),
            "uniform_rns": lambda m, r: m.uniform_rns_rows(64, MODULI, r)}


def test_blake2_drops_into_the_samplers():
    """Every sampler of the port that takes an rng takes the engine and
    draws what the JAX package's draws."""
    mine, theirs = prng.Blake2Engine(99), jprng.Blake2Engine(99)
    for name, draw in SAMPLERS.items():
        assert _same(draw(sampling, mine), draw(jsampling, theirs)), name
    s = sampling.sparse_ternary_coeffs(128, 32, mine)
    assert int((s != 0).sum()) == 32


@pytest.mark.parametrize("method", ["inversion", "karney"])
@pytest.mark.parametrize("sigma", [3.19, 17.5])
def test_dgg_draws_equal(method, sigma):
    mine = prng.DiscreteGaussianGenerator(sigma)
    theirs = jprng.DiscreteGaussianGenerator(sigma)
    got = mine.generate(300, prng.Blake2Engine(5), method=method)
    want = theirs.generate(300, jprng.Blake2Engine(5), method=method)
    assert _same(got, want)
    assert abs(got.mean()) < sigma


def test_dgg_flooding_sigma_karney_equal():
    mine = prng.DiscreteGaussianGenerator(float(1 << 20), tail_factor=8.0)
    theirs = jprng.DiscreteGaussianGenerator(float(1 << 20),
                                             tail_factor=8.0)
    assert _same(mine.generate_karney(40, prng.Blake2Engine(3)),
                 theirs.generate_karney(40, jprng.Blake2Engine(3)))


def test_ckks_keygen_under_blake2_equals_jax():
    params = dict(ring_dim=128, mult_depth=2, scaling_mod_size=50,
                  first_mod_size=60, dnum=2)
    jctx = jckks.gen_context(jckks.CKKSParams(**params))
    ctx = ckks.gen_context(ckks.CKKSParams(**params), "cpu")
    jpk, jsk = jckks.keygen(jctx, jprng.Blake2Engine(11))
    pk, sk = ckks.keygen(ctx, prng.Blake2Engine(11))
    assert _same(sk.coeffs, np.asarray(jsk.coeffs))
    want = convert.public_key_from_jax(jpk, "cpu")
    assert torch.equal(pk.b.data, want.b.data)
    assert torch.equal(pk.a.data, want.a.data)


def _fields(mod, n, seed):
    rng = np.random.default_rng(seed)
    a = mod.Field2n(rng.normal(size=n).astype(np.complex128), mod.COEFF)
    b = mod.Field2n((rng.normal(size=n) + 1j * rng.normal(size=n)),
                    mod.COEFF)
    return a, b


FIELD_OPS = {
    "to_eval": lambda a, b: a.to_eval(),
    "to_coeff": lambda a, b: a.to_eval().to_coeff(),
    "set_format": lambda a, b: a.set_format("EVAL").set_format("COEFF"),
    "add": lambda a, b: a + b,
    "add_eval": lambda a, b: a.to_eval() + b.to_eval(),
    "add_scalar": lambda a, b: a + 2.5,
    "sub": lambda a, b: a - b,
    "sub_scalar_eval": lambda a, b: a.to_eval() - 1,
    "neg": lambda a, b: -a,
    "mul": lambda a, b: a.to_eval() * b.to_eval(),
    "plus_scalar": lambda a, b: a.plus_scalar(0.75),
    "plus_scalar_eval": lambda a, b: a.to_eval().plus_scalar(0.75),
    "scalar_mult": lambda a, b: b.scalar_mult(-1.5),
    "inverse": lambda a, b: a.inverse(),
    "inverse_eval": lambda a, b: b.to_eval().inverse(),
    "transpose": lambda a, b: a.transpose(),
    "transpose_eval": lambda a, b: a.to_eval().transpose(),
    "extract_even": lambda a, b: b.extract_even(),
    "extract_odd": lambda a, b: b.extract_odd(),
}


# a 1-coefficient element (the recursion's leaf) has no odd part to split
@pytest.mark.parametrize("op,n", [(op, n) for op in FIELD_OPS
                                  for n in (1, 16, 512)
                                  if n > 1 or not op.startswith("extract")])
def test_field2n_ops_equal(op, n):
    got = FIELD_OPS[op](*_fields(field2n, n, n))
    want = FIELD_OPS[op](*_fields(jfield2n, n, n))
    assert got.fmt == want.fmt and got.n == want.n == len(got)
    assert _same(got.data, want.data)


def test_field2n_from_ints():
    got = field2n.Field2n.from_ints([3, -1, 4, 1], field2n.EVAL)
    want = jfield2n.Field2n.from_ints([3, -1, 4, 1], jfield2n.EVAL)
    assert got.fmt == want.fmt and _same(got.data, want.data)


def _matrices(mod, size, seed):
    rng = np.random.default_rng(seed)
    A = mod.Matrix(None, 0, 0,
                   data=rng.integers(-50, 50, (size, size)).astype(object))
    B = mod.Matrix(None, 0, 0,
                   data=rng.integers(-50, 50, (size, size)).astype(object))
    return A, B


@pytest.mark.parametrize("size,cutoff", [(8, 2), (16, 4), (6, 2), (1, 2)])
def test_matrix_mult_strassen_equal(size, cutoff):
    A, B = _matrices(matrix, size, size)
    jA, jB = _matrices(jmatrix, size, size)
    got = A.mult(B, strassen_cutoff=cutoff)
    assert _same(got.data, jA.mult(jB, strassen_cutoff=cutoff).data)
    assert _same(got.data, A.data @ B.data)
    assert _same((A * B).data, (jA * jB).data)


def test_matrix_block_ops_equal():
    A, B = _matrices(matrix, 8, 3)
    jA, jB = _matrices(jmatrix, 8, 3)
    pairs = [(A + B, jA + jB), (A - B, jA - jB),
             (A.scalar_mult(3), jA.scalar_mult(3)),
             (A.transpose(), jA.transpose()),
             (A.extract_rows(2, 5), jA.extract_rows(2, 5)),
             (A.vstack(B), jA.vstack(jB)), (A.hstack(B), jA.hstack(jB))]
    for got, want in pairs:
        assert (got.rows, got.cols) == (want.rows, want.cols)
        assert _same(got.data, want.data)
    assert A.extract_rows(0, 3).vstack(A.extract_rows(4, 7)) == A
    assert A.transpose().transpose() == A
    m = matrix.Matrix.from_list([[1, 2], [3, 4]])
    m.set(0, 1, 7)
    assert m(0, 1) == 7 and m.rows == m.cols == 2
    z = matrix.Matrix(lambda: 0, 2, 3)
    assert (z.rows, z.cols) == (2, 3) and z(1, 2) == 0
