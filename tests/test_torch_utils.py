"""The port's own host modules (``openfhe_tpu_torch.utils`` and
``openfhe_tpu_torch.encoding``) against the JAX package's originals they were
copied from: same values, and for the samplers the same draws from the numpy
Generator in the same order, so keys and ciphertexts stay bit-equal.
"""

import numpy as np
import pytest

from openfhe_tpu import encoding as jencoding
from openfhe_tpu.utils import nbtheory as jnb
from openfhe_tpu.utils import sampling as jsampling
from openfhe_tpu.utils import security as jsecurity
from openfhe_tpu_torch import encoding
from openfhe_tpu_torch.utils import nbtheory, sampling, security

MODULI = (1073479681, 1152921504606830593, 2305843009213317121)


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


NBTHEORY = {
    "generate_prime_chain-30": ("generate_prime_chain", (5, 30, 1024)),
    "generate_prime_chain-59": ("generate_prime_chain", (4, 59, 1 << 16)),
    "generate_prime_chain-61": ("generate_prime_chain", (3, 61, 256)),
    "root_of_unity-small": ("root_of_unity", (32, 97)),
    "root_of_unity-30": ("root_of_unity", (2048, MODULI[0])),
    "root_of_unity-60": ("root_of_unity",
                         (1 << 17, jnb.first_prime(60, 1 << 17))),
    "first_prime-60": ("first_prime", (60, 1 << 17)),
    "first_prime-30": ("first_prime", (30, 512)),
    "previous_prime": ("previous_prime", (MODULI[1], 1 << 17)),
    "next_prime": ("next_prime", (MODULI[0], 2048)),
    "next_ntt_prime_above": ("next_ntt_prime_above", (1 << 59, 1 << 17)),
    "prev_ntt_prime_below": ("prev_ntt_prime_below", (1 << 59, 1 << 17)),
    "prev_ntt_prime_below-30": ("prev_ntt_prime_below", (1 << 30, 512)),
    "primitive_root": ("primitive_root", (MODULI[0],)),
    "mod_inverse": ("mod_inverse", (12345, MODULI[2])),
    "is_prime": ("is_prime", (MODULI[2],)),
    "is_prime-composite": ("is_prime", (MODULI[0] * 3,)),
    "factorize": ("factorize", (MODULI[0] - 1,)),
}


@pytest.mark.parametrize("case", list(NBTHEORY))
def test_nbtheory_copy(case):
    name, args = NBTHEORY[case]
    assert _same(getattr(nbtheory, name)(*args), getattr(jnb, name)(*args))


SAMPLING = {
    "ternary_coeffs": lambda m, rng: m.ternary_coeffs(300, rng),
    "sparse_ternary_coeffs": lambda m, rng: m.sparse_ternary_coeffs(
        256, 64, rng),
    "gaussian_coeffs": lambda m, rng: m.gaussian_coeffs(300, rng),
    "gaussian_coeffs-sigma": lambda m, rng: m.gaussian_coeffs(64, rng, 7.5),
    "uniform_rns_rows": lambda m, rng: m.uniform_rns_rows(128, MODULI, rng),
    "signed_to_rns_rows": lambda m, rng: m.signed_to_rns_rows(
        rng.integers(-(1 << 40), 1 << 40, size=50), MODULI),
    "signed_to_rns_rows-bigint": lambda m, rng: np.asarray(
        m.signed_to_rns_rows(np.asarray(
            [int(v) << 70 for v in rng.integers(-9, 9, size=20)],
            dtype=object), MODULI), dtype=object),
}


@pytest.mark.parametrize("case", list(SAMPLING))
@pytest.mark.parametrize("seed", [0, 12345])
def test_sampling_copy_draws_the_same(case, seed):
    """Same outputs, and the Generator left in the same state."""
    rng_port, rng_jax = np.random.default_rng(seed), np.random.default_rng(seed)
    got = SAMPLING[case](sampling, rng_port)
    want = SAMPLING[case](jsampling, rng_jax)
    assert _same(got, want)
    assert rng_port.bit_generator.state == rng_jax.bit_generator.state


def _verdict(mod, n, log_qp, level):
    try:
        mod.validate(n, log_qp, level)
        return "ok"
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("n,log_qp,level", [
    (1 << 16, 662, "HEStd_NotSet"),
    (1 << 15, 881, "HEStd_128_classic"),
    (1 << 15, 882, "HEStd_128_classic"),
    (1 << 14, 300, "HEStd_192_classic"),
    (1 << 14, 306, "HEStd_192_classic"),
    (1 << 13, 100, "HEStd_256_classic"),
    (1 << 12, 109, "HEStd_128_quantum"),
    (1 << 17, 100, "HEStd_128_classic"),       # no table row: refused
    (1000, 10, "HEStd_128_classic"),           # not a standard dimension
])
def test_security_copy(n, log_qp, level):
    assert _verdict(security, n, log_qp, level) == \
        _verdict(jsecurity, n, log_qp, level)
    if level != "HEStd_NotSet":
        lv = security.SecurityLevel(level)
        assert security.max_log_q(n, lv) == \
            jsecurity.max_log_q(n, jsecurity.SecurityLevel(level))
        assert security.min_ring_dim(log_qp, lv) == \
            jsecurity.min_ring_dim(log_qp, jsecurity.SecurityLevel(level))


def test_security_copy_refuses_and_accepts():
    """The pairs above are not all on one side of the limit."""
    assert _verdict(security, 1 << 15, 881, "HEStd_128_classic") == "ok"
    assert "insecure" in _verdict(security, 1 << 15, 882,
                                  "HEStd_128_classic")


@pytest.mark.parametrize("n,slots,scale", [(64, 32, 2.0 ** 40),
                                           (256, 100, 2.0 ** 50),
                                           (2048, 1024, 2.0 ** 59)])
def test_ckks_encoding_copy(n, slots, scale):
    rng = np.random.default_rng(n)
    vals = rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots)
    got = encoding.ckks_encode(vals, n, scale)
    want = jencoding.ckks_encode(vals, n, scale)
    assert got.dtype == want.dtype == object
    assert np.array_equal(got, want)
    dec = encoding.ckks_decode(got, n, scale, slots)
    assert np.array_equal(dec, jencoding.ckks_decode(want, n, scale, slots))
    assert np.max(np.abs(dec - vals)) < 1e-6
    assert np.array_equal(encoding.ckks_embed(np.arange(n, dtype=float), n),
                          jencoding.ckks_embed(np.arange(n, dtype=float), n))
