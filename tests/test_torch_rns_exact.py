"""The port's exact RNS conversions, BFV/BGV encoders and BV key switch
against the JAX package's, bit for bit.

* ``ops/modular.py``: ``mul64_full`` and ``limb_sum`` against Python ints at
  the top of the 64-bit range;
* ``ops/rns.py``: the vectorised ``approx_switch_basis`` (into a prime and
  into 2^16), ``scale_and_round`` at both shapes of ``tests/test_rns.py``
  and at the 21 towers of a BFV S basis, ``exact_switch_basis`` (floor and
  centered) on random values and on values near ±R/2, and the three BEHZ
  conversions;
* ``encoding.py``: the packed, coefficient and string encoders;
* ``keyswitch.py``: ``bv_keygen`` and ``bv_apply`` with 18 digits, so that
  the digit inner product runs in two chunks.

Residues are drawn from a seed with numpy, near q, near 2^60 and at 0 as
well as uniformly, since a wrong carry shows only for large words.
"""

import numpy as np
import pytest
import torch

from openfhe_tpu import dcrt as jdcrt
from openfhe_tpu import encoding as jenc
from openfhe_tpu import keyswitch as jks
from openfhe_tpu.models import ckks as jckks
from openfhe_tpu.ops import limb
from openfhe_tpu.ops import rns as jrns
from openfhe_tpu_torch import convert, dcrt, encoding, keyswitch
from openfhe_tpu_torch.models import ckks
from openfhe_tpu_torch.ops import modular, rns
from openfhe_tpu_torch.utils import nbtheory

N = 64
T = 65537


def chain(num, bits, n=N, avoid=()):
    return tuple(nbtheory.generate_prime_chain(num, bits, n, list(avoid)))


def draw(moduli, rng, lead=()):
    """Residues [*lead, L, N]: uniform, with runs just below q and at 0."""
    rows = []
    for q in moduli:
        v = rng.integers(0, q, size=lead + (N,), dtype=np.uint64)
        v[..., :8] = np.uint64(q - 1) - rng.integers(0, 4, size=lead + (8,),
                                                     dtype=np.uint64)
        v[..., 8:10] = 0
        rows.append(v)
    return np.stack(rows, axis=-2).astype(np.int64)


def to_jax(arr):
    return limb.from_int_array(np.asarray(arr).astype(np.uint64)
                               .astype(object))


def from_jax(x):
    arr = np.asarray(limb.to_int_array(x), dtype=object).astype(np.uint64)
    return torch.from_numpy(arr.view(np.int64))


def same(jax_out, port_out):
    return torch.equal(from_jax(jax_out), port_out)


# --- ops/modular.py ---------------------------------------------------------

WORDS = [0, 1, 2**31, 2**32 - 1, 2**32, 2**60 - 1, 2**62 + 3, 2**63 - 1,
         2**63, 2**63 + 1, 2**64 - 2, 2**64 - 1]


def _bits(values):
    return torch.from_numpy(np.asarray(values, dtype=np.uint64)
                            .view(np.int64))


def test_mul64_full_is_the_128_bit_product():
    a = [x for x in WORDS for _ in WORDS]
    b = [y for _ in WORDS for y in WORDS]
    lo, hi = modular.mul64_full(_bits(a), _bits(b))
    lo = lo.numpy().view(np.uint64).tolist()
    hi = hi.numpy().view(np.uint64).tolist()
    assert [int(h) << 64 | int(ll) for h, ll in zip(hi, lo)] == \
        [x * y for x, y in zip(a, b)]


@pytest.mark.parametrize("limbs,bias", [(4, 0), (4, 1 << 63), (6, 1 << 127),
                                        (2, 5)])
def test_limb_sum_adds_with_carry(limbs, bias):
    rng = np.random.default_rng(limbs)
    words = rng.integers(0, 2**64, size=(2, 7, 5), dtype=np.uint64)
    words[0, :3] = np.uint64(2**64 - 1)
    parts = [(torch.from_numpy(words[0].view(np.int64)), 0),
             (torch.from_numpy(words[1].view(np.int64)), 1)]
    got = modular.limb_sum(parts, limbs, bias=bias)
    for c in range(5):
        want = bias + sum(int(words[0, r, c]) + (int(words[1, r, c]) << 32)
                          for r in range(7))
        want %= 1 << (32 * limbs)
        assert sum(int(g[c]) << (32 * k) for k, g in enumerate(got)) == want


# --- ops/rns.py -------------------------------------------------------------

Q3 = chain(3, 50)
QM, RM = chain(2, 45), chain(3, 50, avoid=chain(2, 45))
Q60 = chain(10, 60)
R60 = chain(11, 60, avoid=Q60)


@pytest.mark.parametrize("to_moduli", [chain(3, 60, avoid=Q3), (1 << 16,),
                                       chain(2, 59, avoid=Q3) + (1 << 16,)],
                         ids=["primes", "m_tilde", "bsk_and_m_tilde"])
def test_approx_switch_basis(to_moduli):
    x = draw(Q3, np.random.default_rng(1), (2,))
    want = torch.stack([from_jax(jrns.approx_switch_basis(
        to_jax(x[i]), Q3, to_moduli)) for i in range(2)])
    assert torch.equal(rns.approx_switch_basis(torch.from_numpy(x), Q3,
                                               to_moduli), want)


SCALE_CASES = {
    # tests/test_rns.py:110 (decrypt) and :123 (mult), and BFV's own S
    "decrypt_shape": (Q3, (T,), T, Q3),
    "mult_shape": (QM + RM, RM, T, QM),
    "bfv_60bit_S": (Q60 + R60, R60, T, Q60),
    "bfv_60bit_decrypt": (Q60, (T,), T, Q60),
}


@pytest.mark.parametrize("case", list(SCALE_CASES))
def test_scale_and_round(case):
    s_m, r_m, t, q_m = SCALE_CASES[case]
    x = draw(s_m, np.random.default_rng(len(s_m)))
    want = jrns.scale_and_round(to_jax(x), s_m, r_m, t, q_m)
    assert same(want, rns.scale_and_round(torch.from_numpy(x), s_m, r_m, t,
                                          q_m))


def _near_half(moduli, rng):
    """Residues of values just below and above R/2, and of small signed
    values, over `moduli`."""
    R = 1
    for r in moduli:
        R *= r
    vals = ([R // 2 - k for k in range(N // 4)]
            + [R // 2 + k for k in range(N // 4)]
            + [int(v) % R for v in rng.integers(-2**40, 2**40, size=N // 2)])
    return np.asarray([[v % r for v in vals] for r in moduli],
                      dtype=np.uint64).astype(np.int64)


@pytest.mark.parametrize("centered", [False, True], ids=["floor", "centered"])
@pytest.mark.parametrize("values", ["uniform", "near_half_R"])
@pytest.mark.parametrize("bases", ["test_rns", "bfv_60bit"])
def test_exact_switch_basis(bases, values, centered):
    r_m, q_m = (chain(3, 50), chain(2, 55, avoid=chain(3, 50))) \
        if bases == "test_rns" else (R60, Q60)
    rng = np.random.default_rng(7)
    x = draw(r_m, rng) if values == "uniform" else _near_half(r_m, rng)
    want = jrns.exact_switch_basis(to_jax(x), r_m, q_m, centered=centered)
    assert same(want, rns.exact_switch_basis(torch.from_numpy(x), r_m, q_m,
                                             centered=centered))


def _msk(avoid):
    m = nbtheory.first_prime(59, 2 * N)
    while m in avoid:
        m = nbtheory.previous_prime(m, 2 * N)
    return m


BEHZ_Q, BEHZ_B = chain(2, 50), chain(3, 50, avoid=chain(2, 50))
BEHZ_BSK = BEHZ_B + (_msk(set(BEHZ_Q) | set(BEHZ_B)),)


@pytest.mark.parametrize("which", ["montgomery", "floor", "shenoy_kumaresan"])
def test_behz_conversions(which):
    rng = np.random.default_rng(11)
    xq, xb = draw(BEHZ_Q, rng), draw(BEHZ_BSK, rng)
    tq, tb = torch.from_numpy(xq), torch.from_numpy(xb)
    if which == "montgomery":
        want = jrns.base_conv_q_to_bsk_montgomery(to_jax(xq), BEHZ_Q,
                                                  BEHZ_BSK)
        got = rns.base_conv_q_to_bsk_montgomery(tq, BEHZ_Q, BEHZ_BSK)
    elif which == "floor":
        want = jrns.rns_floor_q(to_jax(xq), to_jax(xb), BEHZ_Q, BEHZ_BSK)
        got = rns.rns_floor_q(tq, tb, BEHZ_Q, BEHZ_BSK)
    else:
        want = jrns.base_conv_sk(to_jax(xb), BEHZ_B, BEHZ_BSK[-1], BEHZ_Q)
        got = rns.base_conv_sk(tb, BEHZ_B, BEHZ_BSK[-1], BEHZ_Q)
    assert same(want, got)


# --- encoding.py ------------------------------------------------------------


@pytest.mark.parametrize("n,t", [(128, 12289), (128, 3329), (1024, 65537)])
def test_packed_encoding(n, t):
    rng = np.random.default_rng(n + t)
    v = [int(x) for x in rng.integers(0, t, size=n)]
    coeffs = encoding.packed_encode(v, n, t)
    assert coeffs == jenc.packed_encode(v, n, t)
    assert np.array_equal(encoding.packed_slot_perm(n),
                          jenc.packed_slot_perm(n))
    assert encoding.packed_decode(coeffs, n, t) == \
        jenc.packed_decode(coeffs, n, t) == v
    short = v[: n // 3]
    assert encoding.packed_encode(short, n, t) == \
        jenc.packed_encode(short, n, t)


def test_coefficient_and_string_encoding():
    vals = [5, -7, 0, 6144, -6144, 12288, 1]
    for length in (None, 5):
        enc = encoding.coef_encode(vals, 128, 12289)
        assert enc == jenc.coef_encode(vals, 128, 12289)
        assert encoding.coef_decode(enc, 128, 12289, length) == \
            jenc.coef_decode(enc, 128, 12289, length)
    text = "héllo, wörld"
    enc = encoding.string_encode(text, 128)
    assert enc == jenc.string_encode(text, 128)
    assert encoding.string_decode(enc) == jenc.string_decode(enc) == text
    with pytest.raises(ValueError):
        encoding.coef_encode([1] * 129, 128, 12289)


# --- keyswitch.py: BV -------------------------------------------------------


@pytest.fixture(scope="module")
def bv_flow():
    """tests/test_bv_keyswitch.py's relinearisation with log_base 8: towers
    of 50, 40 and 41 bits give 7 + 5 + 6 = 18 digits, two kernel-sized
    chunks."""
    out = {}
    for name, mod, ksm, where in (("jax", jckks, jks, ()),
                                  ("port", ckks, keyswitch, ("cpu",))):
        rng = np.random.default_rng(77)
        ctx = mod.gen_context(mod.CKKSParams(
            ring_dim=128, mult_depth=2, scaling_mod_size=40,
            first_mod_size=50, dnum=2), *where)
        pk, sk = mod.keygen(ctx, rng)
        params = ksm.BVKSParams(ctx.n, ctx.q_moduli, log_base=8)
        args = (ctx.basis(),) + (() if name == "jax" else ("cpu",))
        s = sk.poly(*args)
        dmod = jdcrt if name == "jax" else dcrt
        evk = ksm.bv_keygen(params, s, dmod.mul(s, s), rng)
        v = rng.normal(size=8)
        ctm = mod.eval_mult(mod.encrypt(ctx, pk, v, rng),
                            mod.encrypt(ctx, pk, v, rng))
        d0, d1 = ksm.bv_apply(evk, ctm.polys[2])
        relin = mod.Ciphertext((dmod.add(ctm.polys[0], d0),
                                dmod.add(ctm.polys[1], d1)), ctm.scale)
        out[name] = dict(evk=evk, ctm=ctm, d=(d0, d1), relin=relin,
                         slots=mod.decrypt(ctx, sk, relin, num_slots=8), v=v)
    return out


def test_bv_digit_count_needs_two_chunks(bv_flow):
    from openfhe_tpu_torch.ops import elementwise
    params = bv_flow["port"]["evk"].params
    digits = sum(params.num_digits(i) for i in range(len(params.q_moduli)))
    assert bv_flow["port"]["evk"].b.shape[0] == digits == 18
    assert digits > elementwise.MAX_DIGITS


def test_bv_keygen(bv_flow):
    want = convert.bv_kskey_from_jax(bv_flow["jax"]["evk"], "cpu")
    got = bv_flow["port"]["evk"]
    assert want.params == got.params
    assert torch.equal(want.b, got.b) and torch.equal(want.a, got.a)
    np_planes = convert.bv_kskey_to_numpy(got)
    assert np.array_equal(np_planes[0], np.asarray(bv_flow["jax"]["evk"].b_lo))


@pytest.mark.parametrize("half", [0, 1])
def test_bv_apply(bv_flow, half):
    want = convert.poly_from_jax(bv_flow["jax"]["d"][half], "cpu")
    assert torch.equal(want.data, bv_flow["port"]["d"][half].data)


def test_bv_relinearised_slots(bv_flow):
    port, jax_ = bv_flow["port"], bv_flow["jax"]
    assert np.array_equal(port["slots"], jax_["slots"])
    assert np.max(np.abs(port["slots"] - port["v"] ** 2)) < 1e-3
