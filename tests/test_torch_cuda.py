"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA GPU and skips without one; on a machine with a
card run ``python -m pytest tests/test_torch_cuda.py -q``. ``chip_smoke.py``
repeats these checks at the main path's shapes (n = 2^16).
"""

import numpy as np
import pytest
import torch

from openfhe_tpu_torch.ops import elementwise, modular, ntt
from openfhe_tpu_torch.utils import nbtheory

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _uniform(moduli, shape, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, q, size=shape, dtype=np.uint64) for q in moduli]
    return torch.from_numpy(np.stack(cols, axis=-2).astype(np.int64))


# n = 2^12 .. 2^17 take the templated radix-16 kernels (sub-transforms of
# 64, 128, 256 and 512 points), every other n the generic radix-2 ones
NTT_SHAPES = [(n, (2,)) for n in (2, 16, 512, 2048, 4096, 8192, 16384, 32768,
                                   1 << 17)] + \
    [(n, lead) for n in (2048, 4096, 32768) for lead in ((1,), (3,), ())]


@pytest.mark.parametrize("n,lead", NTT_SHAPES)
@pytest.mark.parametrize("bits", [30, 61])
def test_ntt_kernel_matches_twin(cuda, n, bits, lead):
    moduli = tuple(nbtheory.generate_prime_chain(3, bits, n))
    x = _uniform(moduli, lead + (n,), seed=n + bits)      # [lead, 3, n]
    t_cpu = ntt.tables(n, moduli, "cpu")
    want = ntt.forward_plain(x, t_cpu)
    got = ntt.forward(x.to(cuda), moduli)
    assert torch.equal(got.cpu(), want)
    back = ntt.inverse(got, moduli)
    assert torch.equal(back.cpu(), x)
    assert torch.equal(back.cpu(), ntt.inverse_plain(want, t_cpu))


def test_ks_inner_product_kernel_matches_twin(cuda):
    n, bits = 1024, 60
    moduli = tuple(nbtheory.generate_prime_chain(7, bits, n))
    rows = [0, 1, 2, 5, 6]                  # a level below full, then P
    act = tuple(moduli[r] for r in rows)
    mod_cpu = modular.make_mod_consts(act, "cpu")
    digits = _uniform(act, (2, n), seed=1)  # ndig = 2 of dnum = 3
    kb = _uniform(moduli, (3, n), seed=2)
    ka = _uniform(moduli, (3, n), seed=3)
    want = elementwise.ks_inner_product(digits, kb, ka, rows, mod_cpu)
    got = elementwise.ks_inner_product(
        digits.to(cuda), kb.to(cuda), ka.to(cuda), rows,
        modular.make_mod_consts(act, cuda))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_fused_mac_kernel_matches_twin(cuda):
    n = 2048
    moduli = tuple(nbtheory.generate_prime_chain(3, 61, n))
    x, y, acc = (_uniform(moduli, (n,), seed=s) for s in (4, 5, 6))
    want = elementwise.fused_mac_mod(x, y, acc,
                                     modular.make_mod_consts(moduli, "cpu"))
    got = elementwise.fused_mac_mod(x.to(cuda), y.to(cuda), acc.to(cuda),
                                    modular.make_mod_consts(moduli, cuda))
    assert torch.equal(got.cpu(), want)
