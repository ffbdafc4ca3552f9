"""The port's modular arithmetic (``openfhe_tpu_torch.ops.modular``) against
the JAX package's (``openfhe_tpu.ops.modular``), bit for bit, on 30-, 50-,
59-, 60- and 61-bit NTT primes. Inputs come from a fixed numpy seed and
include the residues 0, 1 and q-1.
"""

import jax
import numpy as np
import pytest
import torch

from openfhe_tpu.ops import limb
from openfhe_tpu.ops import modular as jmod
from openfhe_tpu.utils import nbtheory
from openfhe_tpu_torch import convert
from openfhe_tpu_torch.ops import modular

BITS = (30, 50, 59, 60, 61)
N = 256
# the largest NTT prime below 2^b: exactly b bits
MODULI = tuple(nbtheory.prev_ntt_prime_below(1 << b, 2 * N) for b in BITS)


def _residues(rng):
    """[5, N] reduced residues; the first three columns are 0, 1, q-1."""
    rows = []
    for q in MODULI:
        r = rng.integers(0, q, size=N, dtype=np.uint64)
        r[:3] = [0, 1, q - 1]
        rows.append(r)
    return np.stack(rows).astype(np.int64)


def _words(rng):
    """[5, N] arbitrary 64-bit patterns (as int64), including 0 and 2^64-1."""
    w = rng.integers(0, 1 << 63, size=(len(MODULI), N), dtype=np.uint64)
    w = (w << np.uint64(1)) | rng.integers(0, 2, size=w.shape,
                                           dtype=np.uint64)
    w[:, 0] = 0
    w[:, 1] = np.uint64((1 << 64) - 1)
    return w.view(np.int64)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(2024)
    a, b, w = _residues(rng), _residues(rng), _words(rng)
    c = [int(rng.integers(1, q)) for q in MODULI]
    return a, b, w, c


def _u64(x):
    return limb.from_int_array(np.asarray(x).view(np.uint64))


@pytest.fixture(scope="module")
def jax_out(case):
    """Every JAX op in one jitted program (one compile for the module)."""
    a, b, w, c = case
    m = jmod.make_mod_consts(MODULI)
    m_new = jmod.make_mod_consts(MODULI[1:] + MODULI[:1])
    cc = limb.from_int_array(np.asarray([[v] for v in c], dtype=object))
    cp = limb.from_int_array(np.asarray(
        [[jmod.shoup_precon_int(v, q)] for v, q in zip(c, MODULI)],
        dtype=object))

    @jax.jit
    def run(a, b, w):
        return {
            "add_mod": jmod.add_mod(a, b, m.q),
            "sub_mod": jmod.sub_mod(a, b, m.q),
            "neg_mod": jmod.neg_mod(a, m.q),
            "mul_mod": jmod.mul_mod(a, b, m),
            "mul_mod_words": jmod.mul_mod(w, b, m),
            "mul_mod_shoup": jmod.mul_mod_shoup(w, cc, cp, m.q),
            "barrett_word": jmod.barrett_word(w, m.q, m.mu),
            "switch_modulus": jmod.switch_modulus(a, m, m_new),
        }

    out = run(_u64(a), _u64(b), _u64(w))
    return {k: convert.u64_to_tensor(v.lo, v.hi, "cpu")
            for k, v in out.items()}


def _port(name, case):
    a, b, w, c = (torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                  for x in case)
    m = modular.make_mod_consts(MODULI, "cpu")
    m_new = modular.make_mod_consts(MODULI[1:] + MODULI[:1], "cpu")
    cc = modular.int_tensor([[v] for v in c], "cpu")
    cp = modular.int_tensor([[modular.shoup_precon_int(v, q)]
                             for v, q in zip(c, MODULI)], "cpu")
    ops = {
        "add_mod": lambda: modular.add_mod(a, b, m.q),
        "sub_mod": lambda: modular.sub_mod(a, b, m.q),
        "neg_mod": lambda: modular.neg_mod(a, m.q),
        "mul_mod": lambda: modular.mul_mod(a, b, m),
        "mul_mod_words": lambda: modular.mul_mod(w, b, m),
        "mul_mod_shoup": lambda: modular.mul_mod_shoup(w, cc, cp, m.q),
        "barrett_word": lambda: modular.barrett_word(w, m.q, m.mu),
        "switch_modulus": lambda: modular.switch_modulus(a, m, m_new),
    }
    return ops[name]()


@pytest.mark.parametrize("op", ["add_mod", "sub_mod", "neg_mod", "mul_mod",
                                "mul_mod_words", "mul_mod_shoup",
                                "barrett_word", "switch_modulus"])
def test_op_matches_jax(op, case, jax_out):
    got = _port(op, case)
    assert got.dtype == torch.int64
    assert torch.equal(got, jax_out[op])


def test_moduli_cover_the_widths():
    assert [q.bit_length() for q in MODULI] == list(BITS)


def test_mulhi64_matches_python_ints(case):
    _, _, w, _ = case
    x, y = w.reshape(-1), w[::-1].reshape(-1)
    got = modular.mulhi64(torch.from_numpy(x), torch.from_numpy(y))
    want = [(int(u) * int(v)) >> 64
            for u, v in zip(x.view(np.uint64), y.view(np.uint64))]
    assert [int(g) for g in got.numpy().view(np.uint64)] == want


@pytest.mark.parametrize("q", MODULI)
def test_precon_bit_patterns(q):
    """Shoup precons reach above 2^63; tables keep their bit pattern."""
    pre = modular.shoup_precon_int(q - 1, q)
    assert pre >= 1 << 63
    t = modular.int_tensor([pre], "cpu")
    assert int(t.numpy().view(np.uint64)[0]) == pre


def test_rejects_moduli_above_2_62():
    with pytest.raises(ValueError):
        modular.make_mod_consts([(1 << 62) + 1], "cpu")
