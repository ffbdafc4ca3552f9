"""The port's composite-scaling CKKS chain against the JAX package's, bit for
bit, at ``tests/test_composite.py``'s four cases: ring 256, depth 2, 50-bit
scaling as products of two primes of ~25 bits (``composite_degree=2``),
seed 11. Both packages run the same flow from the same seed: the chain's
shape and word size, a depth-2 product and a rotation, FIXEDAUTO, and
FLEXIBLEAUTO refused. Keys and ciphertexts must be ``torch.equal``, decoded
slots ``np.array_equal``; the port must also meet the JAX tests' bounds.
The JAX side runs jitted, as ``tests/test_composite.py`` runs it (its
compiled programs are shared; op by op the two flows took 162 s, jitted
23 s). This is the chain ``examples/advanced_real_numbers_128.py`` takes.
"""

import numpy as np
import pytest
import torch

from openfhe_tpu.models import ckks as jckks
from openfhe_tpu.models import ckks_advanced as jadv
from openfhe_tpu_torch import convert
from openfhe_tpu_torch.models import ckks, ckks_advanced as adv

PARAMS = dict(ring_dim=256, mult_depth=2, scaling_mod_size=50,
              first_mod_size=60, dnum=2, composite_degree=2,
              security_level="HEStd_NotSet")


def _ctx(mod, **extra):
    where = ("cpu",) if mod is ckks else ()
    return mod.gen_context(mod.CKKSParams(**PARAMS, **extra), *where)


def _depth2_flow(mod):
    """test_composite.py's fixture, then its depth-2 mult and rotate."""
    ctx = _ctx(mod)
    rng = np.random.default_rng(11)
    pk, sk = mod.keygen(ctx, rng)
    evk = mod.relin_keygen(ctx, sk, rng)
    v1 = rng.normal(size=128) * 0.5
    v2 = rng.normal(size=128) * 0.5
    ct1 = mod.encrypt(ctx, pk, v1, rng)
    ct2 = mod.encrypt(ctx, pk, v2, rng)
    p1 = mod.rescale_ctx(ctx, mod.eval_mult_relin(ct1, ct2, evk))
    lvl = mod.level_reduce(ct1, ct1.towers - p1.towers)
    lvl = mod.Ciphertext(lvl.polys, p1.scale)
    p2 = mod.rescale_ctx(ctx, mod.eval_mult_relin(p1, lvl, evk))
    dec = mod.decrypt(ctx, sk, p2)[:128]
    rk = mod.rot_keygen(ctx, sk, [3], rng)
    rot = mod.eval_rotate(ct1, 3, rk[3])
    dec_rot = mod.decrypt(ctx, sk, rot)[:128]
    return dict(ctx=ctx, pk=pk, sk=sk, evk=evk, ct1=ct1, ct2=ct2, p1=p1,
                p2=p2, rk=rk[3], rot=rot, dec=np.asarray(dec),
                dec_rot=np.asarray(dec_rot), want=v1 * v2 * v1,
                want_rot=np.roll(v1, -3))


def _fixed_auto_flow(mod, amod):
    ctx = _ctx(mod, scaling_technique="FIXEDAUTO")
    rng = np.random.default_rng(13)
    pk, sk = mod.keygen(ctx, rng)
    evk = mod.relin_keygen(ctx, sk, rng)
    v = rng.normal(size=128) * 0.5
    ct = mod.encrypt(ctx, pk, v, rng)
    sq = amod.mult_fixed_auto(ctx, ct, ct, evk)
    cube = amod.mult_fixed_auto(ctx, sq, ct, evk)
    small = mod.compress(ctx, cube)
    dec = mod.decrypt(ctx, sk, small)[:128]
    return dict(ctx=ctx, evk=evk, sq=sq, cube=cube, small=small,
                dec=np.asarray(dec), want=v ** 3)


@pytest.fixture(scope="module")
def depth2():
    return _depth2_flow(jckks), _depth2_flow(ckks)


@pytest.fixture(scope="module")
def fixed_auto():
    return _fixed_auto_flow(jckks, jadv), _fixed_auto_flow(ckks, adv)


def _same_poly(jp, tp):
    return (jp.basis.moduli == tp.basis.moduli and jp.fmt.value ==
            tp.fmt.value and torch.equal(convert.poly_from_jax(jp, "cpu").data,
                                         tp.data))


def _same_ct(jct, tct):
    return (len(jct.polys) == len(tct.polys) and jct.scale == tct.scale
            and all(_same_poly(a, b) for a, b in zip(jct.polys, tct.polys)))


def _same_key(jk, tk):
    k = convert.kskey_from_jax(jk, "cpu")
    return (k.params == tk.params and torch.equal(k.b, tk.b)
            and torch.equal(k.a, tk.a))


def test_chain_shape_and_word_size(depth2):
    j, t = depth2
    ctx = t["ctx"]
    assert ctx.q_moduli == j["ctx"].q_moduli
    assert ctx.p_moduli == j["ctx"].p_moduli
    assert len(ctx.q_moduli) == 2 * 3           # d * (depth+1)
    assert all(q < (1 << 31) for q in ctx.q_moduli + ctx.p_moduli)
    lvl1 = ctx.q_moduli[2] * ctx.q_moduli[3]
    assert abs(lvl1 - 2.0 ** 50) / 2.0 ** 50 < 1e-3
    assert np.array_equal(j["sk"].coeffs, t["sk"].coeffs)
    assert _same_poly(j["pk"].b, t["pk"].b)
    assert _same_poly(j["pk"].a, t["pk"].a)
    assert _same_key(j["evk"], t["evk"])


@pytest.mark.parametrize("name", ["ct1", "ct2", "p1", "p2", "rot"])
def test_depth2_mult_and_rotate(depth2, name):
    j, t = depth2
    assert _same_ct(j[name], t[name])


def test_depth2_decrypts_equal(depth2):
    j, t = depth2
    assert _same_key(j["rk"], t["rk"])
    assert np.array_equal(j["dec"], t["dec"])
    assert np.array_equal(j["dec_rot"], t["dec_rot"])
    assert np.max(np.abs(t["dec"].real - t["want"])) < 1e-3
    assert np.max(np.abs(t["dec_rot"].real - t["want_rot"])) < 1e-4


@pytest.mark.parametrize("name", ["sq", "cube", "small"])
def test_fixed_auto_composite(fixed_auto, name):
    j, t = fixed_auto
    assert j["ctx"].q_moduli == t["ctx"].q_moduli
    assert _same_key(j["evk"], t["evk"])
    assert _same_ct(j[name], t[name])


def test_fixed_auto_decrypts_equal(fixed_auto):
    j, t = fixed_auto
    assert np.array_equal(j["dec"], t["dec"])
    assert np.max(np.abs(t["dec"].real - t["want"])) < 1e-3


def test_flexible_rejected():
    params = dict(ring_dim=256, mult_depth=1, composite_degree=2,
                  scaling_technique="FLEXIBLEAUTO",
                  security_level="HEStd_NotSet")
    with pytest.raises(AssertionError):
        jckks.gen_context(jckks.CKKSParams(**params))
    with pytest.raises(ValueError, match="composite scaling supports"):
        ckks.gen_context(ckks.CKKSParams(**params), "cpu")
