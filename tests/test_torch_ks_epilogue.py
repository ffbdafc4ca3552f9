"""``ks_inner_product``'s two options on the CPU: the monomial epilogue
against the JAX blind-rotation step's arithmetic, bit for bit, and key rows
given as a tensor against the host list and the gathered key.

The JAX side is the CGGI step of ``openfhe_tpu/models/binfhe.py:675-687``
written out eagerly with ``openfhe_tpu.ops.modular``: each digit times its
key row by ``mul_mod``, summed by ``add_mod``, then ``mul_mod`` by the
monomial row. Inputs are drawn with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from openfhe_tpu.ops import limb
from openfhe_tpu.ops import modular as jmod
from openfhe_tpu_torch import convert
from openfhe_tpu_torch.models import binfhe
from openfhe_tpu_torch.ops import elementwise, modular
from openfhe_tpu_torch.utils import nbtheory


def _below(q, shape, rng):
    return rng.integers(0, q, size=shape, dtype=np.uint64).astype(np.int64)


def _jax_step(digits, key_b, key_a, rows, mono, mono_rows, q):
    """[2, R, n] by the JAX package's modular ops, one [R, n] plane at a
    time."""
    R = digits.shape[1]
    m = jmod.make_mod_consts((q,) * R)
    row = limb.from_int_array(mono[mono_rows])
    out = []
    for key in (key_b, key_a):
        acc = None
        for d in range(digits.shape[0]):
            t = jmod.mul_mod(limb.from_int_array(digits[d]),
                             limb.from_int_array(key[d, list(rows)]), m)
            acc = t if acc is None else jmod.add_mod(acc, t, m.q)
        rot = jmod.mul_mod(acc, row, m)
        out.append(convert.u64_to_tensor(rot.lo, rot.hi, "cpu"))
    return torch.stack(out)


def _switch_q():
    # scheme switching's FHEW modulus (chip_smoke.switch_fhew_params)
    return nbtheory.first_prime(27, 2 * 256)


# a GINX step's digits [2dg, B, N] against the step's [2dg, 2, N] slab:
# STD128 (27-bit), STD128Q_3 (50-bit), scheme switching's FHEW LUT (28-bit)
@pytest.mark.parametrize("q_of,ndig,batch,n", [
    pytest.param(lambda: binfhe.reference_params("STD128").Q, 6, 4, 1024,
                 id="STD128"),
    pytest.param(lambda: binfhe.reference_params("STD128Q_3").Q, 4, 4, 2048,
                 id="STD128Q_3"),
    pytest.param(_switch_q, 6, 1, 256, id="switch-FHEW")])
@pytest.mark.parametrize("sign", [0, 1])
def test_epilogue_matches_jax_step(q_of, ndig, batch, n, sign):
    q = q_of()
    rng = np.random.default_rng(ndig * n + sign)
    digits = _below(q, (ndig, batch, n), rng)
    kb, ka = (_below(q, (ndig, 2, n), rng) for _ in range(2))
    mono = _below(q, (2 * n, n), rng)
    mono_rows = rng.integers(0, 2 * n, size=batch)
    rows = (sign,) * batch
    want = _jax_step(digits, kb, ka, rows, mono, mono_rows, q)
    got = elementwise.ks_inner_product(
        torch.from_numpy(digits), torch.from_numpy(kb), torch.from_numpy(ka),
        rows, modular.make_mod_consts((q,) * batch, "cpu"),
        mono=torch.from_numpy(mono), mono_rows=torch.from_numpy(mono_rows))
    assert torch.equal(got, want)


def _ap_step(seed):
    """One STD128_AP step's operands: digits [6, 4, 1024], the step's key
    halves [6, B_r, 1024] and each batch element's row of them."""
    p = binfhe.reference_params("STD128_AP")
    B, ndig = 4, 2 * p.dg
    rng = np.random.default_rng(seed)
    digits = torch.from_numpy(_below(p.Q, (ndig, B, p.N), rng))
    ek_t = torch.from_numpy(_below(p.Q, (2, ndig, p.B_r, p.N), rng))
    dig = torch.from_numpy(rng.integers(0, p.B_r, size=B))
    return digits, ek_t, dig, modular.make_mod_consts((p.Q,) * B, "cpu")


def test_rows_tensor_matches_row_list_and_gathered_key():
    digits, ek_t, dig, mod = _ap_step(11)
    by_tensor = elementwise.ks_inner_product(digits, ek_t[0], ek_t[1], dig,
                                             mod)
    by_list = elementwise.ks_inner_product(digits, ek_t[0], ek_t[1],
                                           dig.tolist(), mod)
    # the AP step before the key was read in place: gather, then row i
    key = ek_t.index_select(2, dig)
    gathered = elementwise.ks_inner_product(
        digits, key[0], key[1], tuple(range(dig.numel())), mod)
    assert torch.equal(by_tensor, by_list)
    assert torch.equal(by_tensor, gathered)


def test_rows_tensor_with_epilogue_matches_row_list():
    digits, ek_t, dig, mod = _ap_step(12)
    rng = np.random.default_rng(13)
    q = int(mod.q[0])
    mono = torch.from_numpy(_below(q, (8, digits.shape[2]), rng))
    mono_rows = torch.tensor([7, 0, 3, 3])
    outs = [elementwise.ks_inner_product(digits, ek_t[0], ek_t[1], rows, mod,
                                         mono=mono, mono_rows=mono_rows)
            for rows in (dig, dig.tolist())]
    assert torch.equal(*outs)


def _small_call():
    q = nbtheory.first_prime(27, 64)
    rng = np.random.default_rng(14)
    digits = torch.from_numpy(_below(q, (16, 2, 32), rng))
    key = torch.from_numpy(_below(q, (16, 2, 32), rng))
    mono = torch.from_numpy(_below(q, (64, 32), rng))
    return digits, key, mono, modular.make_mod_consts((q, q), "cpu")


@pytest.mark.parametrize("case", ["mono without mono_rows",
                                  "mono_rows without mono",
                                  "table of the wrong width",
                                  "mono_rows of the wrong length",
                                  "more than MAX_DIGITS digits",
                                  "rows tensor of the wrong length"])
def test_wrapper_refuses(case):
    digits, key, mono, mod = _small_call()
    d = digits[:elementwise.MAX_DIGITS]
    idx = torch.tensor([1, 5])
    kwargs = {"mono without mono_rows": dict(mono=mono),
              "mono_rows without mono": dict(mono_rows=idx),
              "table of the wrong width": dict(mono=mono[:, :16],
                                               mono_rows=idx),
              "mono_rows of the wrong length": dict(mono=mono,
                                                    mono_rows=idx[:1])
              }.get(case, {})
    rows = torch.tensor([0, 1, 1]) if case.startswith("rows tensor") \
        else (0, 1)
    if case == "more than MAX_DIGITS digits":
        d = digits
    with pytest.raises(ValueError):
        elementwise.ks_inner_product(d, key, key, rows, mod, **kwargs)


@pytest.mark.parametrize("which", ["rows", "mono_rows"])
def test_checked_indices_out_of_range(monkeypatch, which):
    """Under OPENFHE_TPU_TORCH_CHECK=1 a device index past its table is
    refused before any kernel reads by it."""
    monkeypatch.setenv("OPENFHE_TPU_TORCH_CHECK", "1")
    digits, key, mono, mod = _small_call()
    d = digits[:elementwise.MAX_DIGITS]
    rows = torch.tensor([0, 2 if which == "rows" else 1])
    mono_rows = torch.tensor([1, 64 if which == "mono_rows" else 5])
    with pytest.raises(ValueError, match=which):
        elementwise.ks_inner_product(d, key, key, rows, mod, mono=mono,
                                     mono_rows=mono_rows)
