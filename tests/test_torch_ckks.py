"""The port's CKKS main path against the JAX package's, bit for bit.

One module-scoped run per chain of each package from the same seed:
gen_context -> keygen -> relin key -> rotation key -> encrypt x2 ->
EvalMult -> relinearize -> rescale -> EvalRotate(1) -> decrypt, at n = 256
with four levels on the 60-bit chain and on the composite (~30-bit) chain.
Every key, every ciphertext after every step and the decoded slots must be
equal (not close). Further tests feed one set of inputs, through
``openfhe_tpu_torch.convert``, to single functions of both packages
(``to_eval``, ``automorphism``, ``eval_add``/``eval_sub``,
``approx_switch_basis``, ``approx_mod_down``, ``rescale_eval``,
``drop_last_and_scale``, ``keyswitch.apply``); they mostly reuse the JAX
programs the runs compiled.
"""

import numpy as np
import pytest
import torch

from openfhe_tpu import dcrt as jdcrt
from openfhe_tpu import keyswitch as jks
from openfhe_tpu.models import ckks as jckks
from openfhe_tpu.ops import limb
from openfhe_tpu.ops import rns as jrns
from openfhe_tpu_torch import convert, dcrt, keyswitch
from openfhe_tpu_torch.models import ckks
from openfhe_tpu_torch.ops import rns

BASE = dict(ring_dim=256, mult_depth=3, scaling_mod_size=59,
            first_mod_size=60, dnum=3)
CHAINS = {"60bit": dict(BASE), "composite": dict(BASE, composite_degree=2)}
SEED = 5


def _drive(mod, params):
    rng = np.random.default_rng(SEED)
    # the port runs on the card unless asked for the CPU; JAX is on the CPU
    where = ("cpu",) if mod is ckks else ()
    ctx = mod.gen_context(mod.CKKSParams(**params), *where)
    pk, sk = mod.keygen(ctx, rng)
    evk = mod.relin_keygen(ctx, sk, rng)
    rk = mod.rot_keygen(ctx, sk, [1], rng)[1]
    n = ctx.n
    v1 = rng.uniform(-1, 1, size=n // 2)
    v2 = rng.uniform(-1, 1, size=n // 2)
    ct1 = mod.encrypt(ctx, pk, v1, rng)
    ct2 = mod.encrypt(ctx, pk, v2, rng)
    mult = mod.eval_mult(ct1, ct2)
    relin = mod.relinearize(mult, evk)
    rescaled = mod.rescale_ctx(ctx, relin)
    rotated = mod.eval_rotate(rescaled, 1, rk)
    slots = mod.decrypt(ctx, sk, rotated, num_slots=n // 2)
    return dict(ctx=ctx, pk=pk, sk=sk, evk=evk, rk=rk, ct1=ct1, ct2=ct2,
                mult=mult, relin=relin, rescaled=rescaled, rotated=rotated,
                slots=slots, want=np.roll(v1 * v2, -1))


@pytest.fixture(scope="module", params=list(CHAINS))
def runs(request):
    params = CHAINS[request.param]
    return _drive(jckks, params), _drive(ckks, params)


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


def _uniform(moduli, lead, n, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
            for q in moduli]
    return np.stack(cols, axis=-2).astype(np.int64)


def _jpoly(x, basis, fmt):
    u = limb.from_int_array(x)
    return jdcrt.RnsPoly(u.lo, u.hi, basis, fmt)


def _tpoly(x, basis, fmt):
    return dcrt.RnsPoly(torch.from_numpy(x),
                        dcrt.RnsBasis(basis.n, basis.moduli),
                        dcrt.Format(fmt.value))


# --- the run, step by step --------------------------------------------------


def test_context(runs):
    j, t = runs
    assert j["ctx"].q_moduli == t["ctx"].q_moduli
    assert j["ctx"].p_moduli == t["ctx"].p_moduli
    assert np.array_equal(j["sk"].coeffs, t["sk"].coeffs)


def test_public_key(runs):
    j, t = runs
    assert _same_poly(j["pk"].b, t["pk"].b)
    assert _same_poly(j["pk"].a, t["pk"].a)


def test_relin_key(runs):
    j, t = runs
    assert _same_key(j["evk"], t["evk"])


def test_rotation_key(runs):
    j, t = runs
    assert _same_key(j["rk"], t["rk"])


@pytest.mark.parametrize("name", ["ct1", "ct2", "mult", "relin", "rescaled",
                                  "rotated"])
def test_ciphertext_after_step(runs, name):
    j, t = runs
    assert _same_ct(j[name], t[name])


def test_decrypted_slots(runs):
    j, t = runs
    assert np.array_equal(j["slots"], t["slots"])
    assert np.max(np.abs(t["slots"].real - t["want"])) < 1e-6


# --- single functions on one set of inputs ----------------------------------


def test_to_eval(runs):
    j, _ = runs
    basis = j["ctx"].basis()
    x = _uniform(basis.moduli, (), basis.n, seed=11)
    want = jdcrt.to_eval(_jpoly(x, basis, jdcrt.Format.COEFF))
    got = dcrt.to_eval(_tpoly(x, basis, jdcrt.Format.COEFF))
    assert _same_poly(want, got)
    assert torch.equal(dcrt.to_coeff(got).data, torch.from_numpy(x))


@pytest.mark.parametrize("fmt", [jdcrt.Format.EVAL, jdcrt.Format.COEFF])
def test_automorphism(runs, fmt):
    """Automorphism at the rotated ciphertext's level and index: a slot
    permutation (EVAL) or a signed coefficient gather (COEFF)."""
    j, _ = runs
    basis = j["rescaled"].basis
    k = jckks.rotation_indices_to_galois(basis.n, 1)
    x = _uniform(basis.moduli, (), basis.n, seed=12)
    want = jdcrt.automorphism(_jpoly(x, basis, fmt), k)
    got = dcrt.automorphism(_tpoly(x, basis, fmt), k)
    assert _same_poly(want, got)


@pytest.mark.parametrize("c", [1 << 59, -(3 ** 40)])
def test_mul_scalar_int(runs, c):
    """A plain integer multiply (FLEXIBLEAUTOEXT's exact 2^p lift of a fresh
    plaintext), including a constant that is negative and above every q."""
    j, _ = runs
    basis = j["ctx"].basis()
    x = _uniform(basis.moduli, (), basis.n, seed=19)
    want = jdcrt.mul_scalar_int(_jpoly(x, basis, jdcrt.Format.EVAL), c)
    got = dcrt.mul_scalar_int(_tpoly(x, basis, jdcrt.Format.EVAL), c)
    assert _same_poly(want, got)


def test_eval_add_and_sub(runs):
    """add and sub of two fresh ciphertexts, and the relinearized product
    minus the unrelinearized one (the lone third component is negated)."""
    j, t = runs
    assert _same_ct(jckks.eval_add(j["ct1"], j["ct2"]),
                    ckks.eval_add(t["ct1"], t["ct2"]))
    assert _same_ct(jckks.eval_sub(j["ct1"], j["ct2"]),
                    ckks.eval_sub(t["ct1"], t["ct2"]))
    assert _same_ct(jckks.eval_sub(j["relin"], j["mult"]),
                    ckks.eval_sub(t["relin"], t["mult"]))


def test_approx_switch_basis(runs):
    """Digit 0 of the chain into its complement plus P (the mod-up)."""
    j, _ = runs
    p = j["evk"].params
    src = p.q_moduli[:p.alpha]
    dst = p.q_moduli[p.alpha:] + p.p_moduli
    x = _uniform(src, (), p.n, seed=13)
    want = jrns.approx_switch_basis(limb.from_int_array(x), src, dst)
    got = rns.approx_switch_basis(torch.from_numpy(x), src, dst)
    assert torch.equal(got, convert.u64_to_tensor(want.lo, want.hi, "cpu"))


@pytest.mark.parametrize("t", [1, 65537])
def test_approx_mod_down(runs, t):
    """Mod-down by P; t > 1 is the BGV lift that keeps V = 0 mod t."""
    j, _ = runs
    p = j["evk"].params
    xq = _uniform(p.q_moduli, (), p.n, seed=14)
    xp = _uniform(p.p_moduli, (), p.n, seed=15)
    want = jrns.approx_mod_down(limb.from_int_array(xq),
                                limb.from_int_array(xp), p.q_moduli,
                                p.p_moduli, t)
    got = rns.approx_mod_down(torch.from_numpy(xq), torch.from_numpy(xp),
                              p.q_moduli, p.p_moduli, t)
    assert torch.equal(got, convert.u64_to_tensor(want.lo, want.hi, "cpu"))


def test_rescale_eval(runs):
    j, _ = runs
    moduli = j["ctx"].q_moduli
    x = _uniform(moduli, (), j["ctx"].n, seed=16)
    want = jckks._rescale_fn(moduli)(limb.from_int_array(x))
    got = rns.rescale_eval(torch.from_numpy(x), moduli)
    assert torch.equal(got, convert.u64_to_tensor(want.lo, want.hi, "cpu"))


def test_drop_last_and_scale(runs):
    """Divide-and-round by the last modulus in the COEFFICIENT domain."""
    j, _ = runs
    moduli = j["ctx"].q_moduli
    x = _uniform(moduli, (), j["ctx"].n, seed=18)
    want = jrns.drop_last_and_scale(limb.from_int_array(x), moduli)
    got = rns.drop_last_and_scale(torch.from_numpy(x), moduli)
    assert torch.equal(got, convert.u64_to_tensor(want.lo, want.hi, "cpu"))


def test_keyswitch_apply(runs):
    """The relinearization key applied to a fresh EVAL poly over full Q."""
    j, _ = runs
    basis = j["ctx"].basis()
    x = _uniform(basis.moduli, (), basis.n, seed=17)
    want = jks.apply(j["evk"], _jpoly(x, basis, jdcrt.Format.EVAL))
    got = keyswitch.apply(convert.kskey_from_jax(j["evk"], "cpu"),
                          _tpoly(x, basis, jdcrt.Format.EVAL))
    assert _same_poly(want[0], got[0])
    assert _same_poly(want[1], got[1])


def test_state_round_trips_through_numpy(runs):
    """Port state -> JAX layout -> port state, and JAX keys decrypt the port's
    ciphertext to the JAX package's slots."""
    j, t = runs
    b_lo, b_hi, a_lo, a_hi = convert.kskey_to_numpy(t["evk"])
    assert np.array_equal(b_lo, np.asarray(j["evk"].b_lo))
    assert np.array_equal(a_hi, np.asarray(j["evk"].a_hi))
    (pb, pa) = convert.public_key_to_numpy(t["pk"])
    assert np.array_equal(pb[0], np.asarray(j["pk"].b.lo))
    assert np.array_equal(pa[1], np.asarray(j["pk"].a.hi))
    sk = convert.secret_key_from_jax(j["sk"])
    assert np.array_equal(convert.secret_key_to_numpy(sk), t["sk"].coeffs)
    planes, scale = convert.ciphertext_to_numpy(t["rotated"])
    jct = jckks.Ciphertext(tuple(
        jdcrt.RnsPoly(lo, hi, j["rotated"].basis, jdcrt.Format.EVAL)
        for lo, hi in planes), scale)
    slots = jckks.decrypt(j["ctx"], j["sk"], jct,
                          num_slots=j["ctx"].n // 2)
    assert np.array_equal(slots, t["slots"])
    back = convert.ciphertext_from_jax(jct, "cpu")
    assert _same_ct(jct, back)
    pk = convert.public_key_from_jax(j["pk"], "cpu")
    assert pk.b.basis == t["pk"].b.basis
