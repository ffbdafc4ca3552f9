"""The port's ``models/scheme_switch.py`` against the JAX package's.

The configuration of ``tests/test_scheme_switch.py``: CKKS at ring 512
(mult_depth 12, 35-bit scaling, a 50-bit first modulus, dnum 3, 64 nonzero
secret coefficients), the FHEW set n_lwe = 8, N = 256, q_ks = 2^14, slots 8
and a degree-56 Chebyshev sine, every draw from one Generator seeded 31 in
that file's order. Both packages run setup, keygen, CKKS -> FHEW of 0..7
and FHEW -> CKKS of 8 bits; the precomputation is held bit-equal as
float64 (D, B, the Chebyshev coefficients) and every key, LWE sample and
CKKS residue EQUAL, with the decryptions within the JAX test's bounds.

The JAX side is the cost (8-core CPU, cold XLA cache; CHANGES.md): op by op
(under ``jax.disable_jit()``) keygen takes 75 s, CKKS -> FHEW 72 s and
FHEW -> CKKS 1052 s (its degree-56 Chebyshev series). One module fixture
runs the JAX setup, keygen and CKKS -> FHEW jitted (tier 1 cold: 136 s
jitted, 145 s with CKKS -> FHEW op by op); FHEW -> CKKS, compare,
minimum/maximum and the _alt forms run through both packages only in the
``slow`` cases. In tier 1 the port runs every flow alone, with the JAX
test's draws, against the JAX test's decode bounds.
"""

import jax
import numpy as np
import pytest
import torch

from openfhe_tpu.models import binfhe as jb
from openfhe_tpu.models import ckks as jckks
from openfhe_tpu.models import ckks_advanced as jadv
from openfhe_tpu.models import scheme_switch as jss
from openfhe_tpu.utils import nbtheory as jnbtheory
from openfhe_tpu_torch import convert
from openfhe_tpu_torch.models import binfhe, ckks
from openfhe_tpu_torch.models import ckks_advanced as adv
from openfhe_tpu_torch.models import scheme_switch as ss
from openfhe_tpu_torch.utils import nbtheory

CKKS = dict(ring_dim=512, mult_depth=12, scaling_mod_size=35,
            first_mod_size=50, dnum=3, secret_hw=64)
P_MSG = 8
MSGS = list(range(8))
BITS = [0, 1, 1, 0, 1, 0, 0, 1]
V1 = [3, 1, 2, 0, 3, 2, 1, 1]
V2 = [1, 3, 0, 2, 1, 3, 3, 2]
JAX = (jckks, jb, jss, jnbtheory, jadv, ())
PORT = (ckks, binfhe, ss, nbtheory, adv, ("cpu",))


def _tile(ctx, vals):
    return np.tile(np.array(vals, dtype=float),
                   ctx.params.num_slots // len(vals))


def _switch(pkg):
    """tests/test_scheme_switch.py's fixture, then its first two tests'
    draws: the contexts, keys, CKKS -> FHEW of 0..7 and the LWE encryptions
    of BITS."""
    m_ckks, m_bin, m_ss, m_nbt, _, where = pkg
    rng = np.random.default_rng(31)
    ctx = m_ckks.gen_context(m_ckks.CKKSParams(**CKKS), *where)
    pk, sk = m_ckks.keygen(ctx, rng)
    bctx = m_bin.gen_context(m_bin.BinFHEParams(
        n_lwe=8, N=256, Q=m_nbt.first_prime(27, 2 * 256), q_ks=1 << 14,
        log_bg=10, log_bks=5, sigma=3.19), *where)
    sk_f = m_bin.keygen(bctx, rng)
    pre = m_ss.setup(ctx, bctx, slots=8, cheb_deg=56)
    keys = m_ss.keygen(ctx, bctx, pre, sk, sk_f, pk, rng)
    ct = m_ckks.encrypt(ctx, pk, _tile(ctx, MSGS), rng)
    lwes = m_ss.eval_ckks_to_fhew(ctx, bctx, pre, keys, ct, len(MSGS),
                                  P_MSG)
    lwe_in = [m_bin.encrypt(bctx, sk_f, b, rng) for b in BITS]
    return dict(rng=rng, ctx=ctx, pk=pk, sk=sk, bctx=bctx, sk_f=sk_f,
                pre=pre, keys=keys, ct=ct, lwes=lwes, lwe_in=lwe_in)


def _back(pkg, s):
    with jax.disable_jit(pkg is JAX):
        return pkg[2].eval_fhew_to_ckks(s["ctx"], s["bctx"], s["pre"],
                                        s["keys"], s["lwe_in"])


@pytest.fixture(scope="module")
def jax_side():
    return _switch(JAX)


@pytest.fixture(scope="module")
def port_side():
    s = _switch(PORT)
    s["back"] = _back(PORT, s)
    return s


def _flows(pkg, s):
    """The JAX test's compare, min/max and _alt tests in its order, on the
    state `s` left after the first two (its Generator included)."""
    m_ckks, m_bin, m_ss = pkg[:3]
    rng, ctx, bctx, pk, sk = s["rng"], s["ctx"], s["bctx"], s["pk"], s["sk"]
    pre, keys = s["pre"], s["keys"]
    out = {}
    bk = m_bin.bootstrap_keygen(bctx, s["sk_f"], rng)
    ct1 = m_ckks.encrypt(ctx, pk, _tile(ctx, V1), rng)
    ct2 = m_ckks.encrypt(ctx, pk, _tile(ctx, V2), rng)
    out["compare"] = (bk, ct1, ct2)
    for name, k, vals in (("min_max", 2, [3, 1] + [0] * 6),
                          ("alt", 4, [3, 1, 2, 3] + [0] * 4)):
        bk = m_bin.bootstrap_keygen(bctx, s["sk_f"], rng)
        rot = m_ckks.rot_keygen(ctx, sk,
                                m_ss.extremum_rotation_indices(ctx, k), rng)
        ct = m_ckks.encrypt(ctx, pk, _tile(ctx, vals), rng)
        out[name] = (bk, rot, ct)
    return out


@pytest.fixture(scope="module")
def port_flows(port_side):
    return _flows(PORT, port_side)


def _same_ct(jct, ct):
    want = convert.ciphertext_from_jax(jct, "cpu")
    assert want.scale == ct.scale and len(want.polys) == len(ct.polys)
    for w, g in zip(want.polys, ct.polys):
        assert w.basis == g.basis and w.fmt == g.fmt
        assert torch.equal(w.data, g.data)


def _same_lwe(jct, ct):
    want = convert.lwe_ciphertext_from_jax(jct, "cpu")
    assert torch.equal(want.a, ct.a)
    assert (want.b, want.modulus) == (ct.b, ct.modulus)


def _same_kskey(jk, k):
    want = convert.kskey_from_jax(jk, "cpu")
    assert want.params == k.params
    assert torch.equal(want.b, k.b) and torch.equal(want.a, k.a)


def test_setup_is_bit_equal(jax_side, port_side):
    j, p = jax_side["pre"], port_side["pre"]
    assert (p.slots, p.B) == (j.slots, j.B)
    for name in ("D", "cheb_coeffs"):
        got, want = getattr(p, name), np.asarray(getattr(j, name))
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
    back = convert.scheme_switch_precomp_to_numpy(
        convert.scheme_switch_precomp_from_jax(j))
    assert back["B"] == j.B and back["D"] is j.D


def test_keys(jax_side, port_side):
    """Conjugation, StC and FHEW->CKKS rotations, relinearization, the
    encryption of the FHEW key and the n -> n_lwe LWE switching key."""
    j, p = jax_side["keys"], port_side["keys"]
    _same_kskey(j.conj, p.conj)
    _same_kskey(j.evk, p.evk)
    for jd, d in ((j.rot_stc, p.rot_stc), (j.rot_f2c, p.rot_f2c)):
        assert sorted(jd) == sorted(d)
        for r in d:
            _same_kskey(jd[r], d[r])
    _same_ct(j.ct_s, p.ct_s)
    assert p.q_sw == j.q_sw
    assert torch.equal(p.lwe_ks_a, torch.from_numpy(j.lwe_ks_a))
    assert torch.equal(p.lwe_ks_b, torch.from_numpy(j.lwe_ks_b))
    keys = convert.scheme_switch_keys_from_jax(j, "cpu")
    assert torch.equal(keys.lwe_ks_a, p.lwe_ks_a)
    _same_kskey(j.rot_stc[1], keys.rot_stc[1])
    arrays = convert.scheme_switch_keys_to_numpy(p)
    assert np.array_equal(arrays["lwe_ks_b"], j.lwe_ks_b)
    assert all(np.array_equal(x, np.asarray(y)) for x, y in zip(
        arrays["evk"], (j.evk.b_lo, j.evk.b_hi, j.evk.a_lo, j.evk.a_hi)))


def test_ckks_to_fhew(jax_side, port_side):
    _same_ct(jax_side["ct"], port_side["ct"])
    assert len(port_side["lwes"]) == len(MSGS)
    for jct, ct in zip(jax_side["lwes"], port_side["lwes"]):
        _same_lwe(jct, ct)
    p = port_side
    assert [binfhe.decrypt_zp(p["bctx"], p["sk_f"], c, P_MSG)
            for c in p["lwes"]] == MSGS


def test_fhew_to_ckks(jax_side, port_side):
    """The LWE inputs equal; the packed result within the JAX test's bound
    (held equal to the JAX package's in the slow case below)."""
    for jct, ct in zip(jax_side["lwe_in"], port_side["lwe_in"]):
        _same_lwe(jct, ct)
    p = port_side
    dec = ckks.decrypt(p["ctx"], p["sk"], p["back"], num_slots=len(BITS))
    assert np.max(np.abs(dec.real - np.array(BITS))) < 0.12, dec.real


def _compare(pkg, s, flows):
    with jax.disable_jit(pkg is JAX):
        return pkg[2].eval_compare_scheme_switching(
            s["ctx"], s["bctx"], s["pre"], s["keys"], *flows["compare"],
            len(V1), P_MSG)


@pytest.fixture(scope="module")
def port_compare(port_side, port_flows):
    return _compare(PORT, port_side, port_flows)


def test_compare_on_the_port(port_side, port_compare):
    """The JAX test's comparison and bound, through the port alone."""
    p = port_side
    dec = ckks.decrypt(p["ctx"], p["sk"], port_compare,
                       num_slots=len(V1)).real
    want = [1.0 if a < b else 0.0 for a, b in zip(V1, V2)]
    assert np.max(np.abs(dec - want)) < 0.12, dec


def _extremum(m_ss, s, bk, rot, ct, k, alt, minimum):
    name = f"eval_{'min' if minimum else 'max'}_scheme_switching" + \
        ("_alt" if alt else "")
    return getattr(m_ss, name)(s["ctx"], s["bctx"], s["pre"], s["keys"], bk,
                               s["keys"].evk, rot, ct, k, P_MSG)


@pytest.mark.parametrize("alt", [False, True], ids=["min_max", "alt"])
def test_min_max_on_the_port(port_side, port_flows, alt):
    """The JAX tests' minimum and maximum (2 values; 4 for the _alt forms)
    and their bounds, through the port alone."""
    p = port_side
    bk, rot, ct = port_flows["alt" if alt else "min_max"]
    k, bound = (4, 0.2) if alt else (2, 0.15)
    mn, ind = _extremum(ss, p, bk, rot, ct, k, alt, True)
    mx, ind2 = _extremum(ss, p, bk, rot, ct, k, alt, False)
    dec = [ckks.decrypt(p["ctx"], p["sk"], c, num_slots=n).real
           for c, n in ((mn, 1), (ind, k), (mx, 1), (ind2, k))]
    want_ind = [0, 1, 0, 0] if alt else [0.0, 1.0]
    assert abs(dec[0][0] - 1.0) < bound, dec[0]
    assert np.max(np.abs(dec[1] - want_ind)) < bound, dec[1]
    assert abs(dec[2][0] - 3.0) < bound, dec[2]
    if not alt:
        assert np.max(np.abs(dec[3] - [1.0, 0.0])) < bound, dec[3]


def test_tournament_masks_are_canonical(port_side):
    """The select masks land on the canonical scale of their depth, so
    mult_auto takes them with the running extremum."""
    p = port_side
    ctx = p["ctx"]
    mask = ss._mult_plain_canonical(ctx, p["back"],
                                    np.full(ctx.params.num_slots, 0.5))
    k = adv.depth_of(ctx, mask)
    assert k == adv.depth_of(ctx, p["back"]) + 1
    assert mask.scale == pytest.approx(adv.scale_at(ctx, k), rel=1e-12)
    one = ss._indicator(ctx, p["pre"], p["keys"], 2)
    assert one.scale == pytest.approx(
        adv.scale_at(ctx, adv.depth_of(ctx, one)), rel=1e-12)


def test_sign_lut_and_rotation_indices():
    for p in (4, 8, 16):
        assert ss._sign_q4_lut(p) == jss._sign_q4_lut(p)
    for k in (1, 2, 4, 8):
        assert ss.extremum_rotation_indices(None, k) == \
            jss.extremum_rotation_indices(None, k)


# ---------------------------------------------------------------------------
# The flows through both packages: minutes of the JAX side each (CHANGES.md)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_flows(jax_side):
    return _flows(JAX, jax_side)


@pytest.mark.slow
@pytest.mark.timeout(7400)  # the four slow cases ran 3697 s together
def test_fhew_to_ckks_equals_the_reference(jax_side, port_side):
    _same_ct(_back(JAX, jax_side), port_side["back"])


@pytest.mark.slow
@pytest.mark.timeout(7400)
def test_compare_equals_the_reference(jax_side, jax_flows, port_side,
                                      port_compare):
    _same_ct(_compare(JAX, jax_side, jax_flows), port_compare)


@pytest.mark.slow
@pytest.mark.timeout(7400)
@pytest.mark.parametrize("alt", [False, True], ids=["min_max", "alt"])
def test_min_max_round_equals_the_reference(jax_side, port_side, jax_flows,
                                            port_flows, alt):
    """The first round of the tournament in both packages: the keys, the
    difference's LWE samples, the sign bootstraps and the signs switched
    back (slot-mapped). The JAX package's own min/max then stops at its
    scale check, where the port's masks are canonical (ROADMAP Queue 3)."""
    name = "alt" if alt else "min_max"
    k = 4 if alt else 2
    stride = k // 2
    outs = []
    for pkg, s, flows in ((JAX, jax_side, jax_flows),
                          (PORT, port_side, port_flows)):
        m_ckks, m_bin, m_ss, _, a = pkg[:5]
        bk, rot, ct = flows[name]
        ctx = s["ctx"]
        with jax.disable_jit(pkg is JAX):
            diff = a.sub_auto(ctx, ct, m_ckks.eval_rotate(ct, stride,
                                                          rot[stride]))
            lwes = m_ss.eval_ckks_to_fhew(ctx, s["bctx"], s["pre"],
                                          s["keys"], diff, stride, P_MSG)
        lut = m_ss._sign_q4_lut(P_MSG)
        signs = [m_bin.eval_func(s["bctx"], bk, c, lut, P_MSG) for c in lwes]
        p_idx = np.arange(ctx.params.num_slots)
        with jax.disable_jit(pkg is JAX):
            back = m_ss.eval_fhew_to_ckks(ctx, s["bctx"], s["pre"],
                                          s["keys"], signs,
                                          slot_map=p_idx % stride)
        outs.append((bk, rot, ct, diff, lwes, signs, back))
    (jbk, jrot, jct, jdiff, jlwes, jsigns, jback), \
        (bk, rot, ct, diff, lwes, signs, back) = outs
    assert torch.equal(convert.bootstrap_key_from_jax(jbk, "cpu").ek, bk.ek)
    for r in rot:
        _same_kskey(jrot[r], rot[r])
    for jc, c in ((jct, ct), (jdiff, diff), (jback, back)):
        _same_ct(jc, c)
    for jl, l in zip(jlwes + jsigns, lwes + signs):
        _same_lwe(jl, l)
