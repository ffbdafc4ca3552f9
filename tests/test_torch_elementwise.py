"""The port's keyswitch multiply-accumulate (``openfhe_tpu_torch.ops.
elementwise``) against the JAX package, bit for bit: ``fused_mac_mod``
against the Pallas kernel (interpret mode on the CPU, as
``tests/test_pallas.py`` runs it) and ``ks_inner_product`` against the JAX
keyswitch's loop of ``mul_mod``/``add_mod``.
"""

import numpy as np
import pytest
import torch

from openfhe_tpu.ops import limb
from openfhe_tpu.ops import modular as jmod
from openfhe_tpu.ops.elementwise_pallas import fused_mac_mod as jax_mac
from openfhe_tpu.utils import nbtheory
from openfhe_tpu_torch import convert
from openfhe_tpu_torch.ops import elementwise, modular


def _uniform(moduli, lead, n, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
            for q in moduli]
    return np.stack(cols, axis=-2).astype(np.int64)


def _from_jax(u):
    return convert.u64_to_tensor(u.lo, u.hi, "cpu")


def test_fused_mac_mod_matches_pallas():
    n, moduli = 2048, tuple(nbtheory.generate_prime_chain(3, 60, 2048))
    x, y, acc = (_uniform(moduli, (), n, seed=s) for s in (1, 2, 3))
    want = jax_mac(limb.from_int_array(x), limb.from_int_array(y),
                   limb.from_int_array(acc), jmod.make_mod_consts(moduli))
    got = elementwise.fused_mac_mod(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(acc),
        modular.make_mod_consts(moduli, "cpu"))
    assert torch.equal(got, _from_jax(want))


@pytest.mark.parametrize("bits,rows", [
    (60, [0, 1, 2, 3, 4, 5, 6]),      # full level: every key row
    (60, [0, 1, 2, 3, 5, 6]),         # one tower dropped, then the P block
    (30, [0, 1, 4, 5, 6]),            # composite-width moduli
])
def test_ks_inner_product_matches_jax_loop(bits, rows):
    """digits [ndig, R, n] against keys [dnum, Lfull+K, n] at the key rows
    `rows`, as keyswitch.hoist_inner_product selects them."""
    n, dnum = 256, 3
    key_moduli = tuple(nbtheory.generate_prime_chain(7, bits, n))
    act = tuple(key_moduli[r] for r in rows)
    ndig = 2 if len(rows) < 7 else 3
    digits = _uniform(act, (ndig,), n, seed=4)
    kb = _uniform(key_moduli, (dnum,), n, seed=5)
    ka = _uniform(key_moduli, (dnum,), n, seed=6)

    m = jmod.make_mod_consts(act)
    acc0 = acc1 = None
    for d in range(ndig):
        dj = limb.from_int_array(digits[d])
        t0 = jmod.mul_mod(dj, limb.from_int_array(kb[d, rows]), m)
        t1 = jmod.mul_mod(dj, limb.from_int_array(ka[d, rows]), m)
        acc0 = t0 if acc0 is None else jmod.add_mod(acc0, t0, m.q)
        acc1 = t1 if acc1 is None else jmod.add_mod(acc1, t1, m.q)

    got0, got1 = elementwise.ks_inner_product(
        torch.from_numpy(digits), torch.from_numpy(kb), torch.from_numpy(ka),
        rows, modular.make_mod_consts(act, "cpu"))
    assert torch.equal(got0, _from_jax(acc0))
    assert torch.equal(got1, _from_jax(acc1))


def test_shape_checks():
    n, moduli = 64, tuple(nbtheory.generate_prime_chain(3, 30, 64))
    x = torch.from_numpy(_uniform(moduli, (), n, seed=7))
    mod = modular.make_mod_consts(moduli, "cpu")
    with pytest.raises(ValueError):
        elementwise.fused_mac_mod(x, x[:2], x, mod)
    with pytest.raises(ValueError):
        elementwise.ks_inner_product(x[None], x[None], x[None], [0, 1], mod)
    with pytest.raises(ValueError):                  # key row out of range
        elementwise.ks_inner_product(x[None], x[None], x[None], [0, 1, 3],
                                     mod)
