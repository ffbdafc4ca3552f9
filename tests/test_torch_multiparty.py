"""The port's ``models/multiparty.py`` (threshold FHE) and the joint-key
additions to ``keyswitch.py`` against the JAX package's, bit for bit.

Each flow runs once in each package from one seed, at the configurations
of ``tests/test_multiparty.py``: three-party joint keygen, encryption under
the joint key and distributed decryption for CKKS (n = 128); the two-round
joint relinearization key and the one-round joint rotation key with
EvalMult+relinearize and EvalRotate under them, for CKKS (n = 256), BGV
and BFV (n = 128, dnum 2); and a five-party BFV joint relinearization key,
as ``examples/threshold_fhe_5p.py`` builds it. The tests hold every key
share, joint key, partial decryption, ciphertext and decryption EQUAL to
the JAX package's (``torch.equal`` on residues, ``==`` on integer slots,
``np.array_equal`` on CKKS slots), and the slots to the plaintext
arithmetic.

The JAX flows run under ``jax.disable_jit()`` (the JAX package's code op by
op): cold on an 8-core CPU this file took 147 s op by op and 164 s jitted.
"""

import jax
import numpy as np
import pytest
import torch

from openfhe_tpu.models import bfv as jbfv
from openfhe_tpu.models import bgv as jbgv
from openfhe_tpu.models import ckks as jckks
from openfhe_tpu.models import multiparty as jmp
from openfhe_tpu_torch import convert, keyswitch
from openfhe_tpu_torch.models import bfv, bgv, ckks, multiparty as mp

JAX = dict(ckks=jckks, bgv=jbgv, bfv=jbfv, mp=jmp, where=())
PORT = dict(ckks=ckks, bgv=bgv, bfv=bfv, mp=mp, where=("cpu",))
MSG = [3, 1, 4, 1, 5, 9, 2, 6]


def _context(pkg, scheme):
    where = pkg["where"]
    if scheme == "ckks128":
        m = pkg["ckks"]
        return m, m.gen_context(m.CKKSParams(
            ring_dim=128, mult_depth=2, scaling_mod_size=40,
            first_mod_size=55, dnum=2), *where)
    if scheme == "ckks256":
        m = pkg["ckks"]
        return m, m.gen_context(m.CKKSParams(
            ring_dim=256, mult_depth=3, scaling_mod_size=40,
            first_mod_size=50, dnum=2), *where)
    if scheme == "bgv":
        m = pkg["bgv"]
        return m, m.gen_context(m.BGVParams(ring_dim=128, mult_depth=2,
                                            mod_size=55, dnum=2), *where)
    m = pkg["bfv"]
    return m, m.gen_context(m.BFVParams(ring_dim=128, num_towers=3,
                                        mod_size=55, dnum=2), *where)


def _joint_keys(mp_, ctx, rng, parties):
    out = {}
    pk, sk = mp_.keygen_lead(ctx, rng)
    out["pk_1"], shares = pk, [sk]
    for i in range(2, parties + 1):
        pk, sk = mp_.keygen_join(ctx, pk, rng)
        out[f"pk_{i}"] = pk
        shares.append(sk)
    for i, s in enumerate(shares, 1):
        out[f"sk_{i}"] = s
    return out, pk, shares


def _distributed(mp_, ctx, shares, ct, rng, out, name, slots):
    parts = [mp_.decrypt_lead(ctx, shares[0], ct, rng)]
    parts += [mp_.decrypt_main(ctx, s, ct, rng) for s in shares[1:]]
    for i, p in enumerate(parts, 1):
        out[f"{name}_partial_{i}"] = p
    out[f"{name}_slots"] = mp_.combine(ctx, ct, parts, num_slots=slots)


def _eval_keys(mp_, ctx, shares, rng, out):
    r1 = [mp_.evalmult_round1(ctx, shares[0], rng)]
    r1 += [mp_.evalmult_round1(ctx, s, rng, prev_key=r1[0])
           for s in shares[1:]]
    joint_ab = mp_.evalmult_accumulate_round1(r1)
    r2 = [mp_.evalmult_round2(ctx, s, joint_ab, rng) for s in shares]
    evk = mp_.evalmult_finalize(r2)
    for i, (a, b) in enumerate(zip(r1, r2), 1):
        out[f"round1_{i}"], out[f"round2_{i}"] = a, b
    out["joint_ab"], out["evk"] = joint_ab, evk
    return evk


def _flow(pkg, scheme):
    """One scheme's threshold flow; every state by name."""
    mp_ = pkg["mp"]
    module, ctx = _context(pkg, scheme)
    seeds = dict(ckks128=321, ckks256=77, bgv=17, bfv=29, bfv5=55)
    rng = np.random.default_rng(seeds[scheme])
    if scheme == "bfv5":
        module, ctx = _context(pkg, "bfv")
        out, pk, shares = _joint_keys(mp_, ctx, rng, 5)
        evk = _eval_keys(mp_, ctx, shares, rng, out)
        m1 = [(i % 7) + 1 for i in range(ctx.n)]
        m2 = [(i % 5) + 2 for i in range(ctx.n)]
        out["ct1"] = module.encrypt(ctx, pk, m1, rng)
        out["ct2"] = module.encrypt(ctx, pk, m2, rng)
        out["prod"] = module.eval_mult_relin(ctx, out["ct1"], out["ct2"], evk)
        _distributed(mp_, ctx, shares, out["prod"], rng, out, "prod", 8)
        return out
    out, pk, shares = _joint_keys(mp_, ctx, rng, 3)
    if scheme == "ckks128":
        v = rng.normal(size=8)
        out["ct"] = ct = module.encrypt(ctx, pk, v, rng)
        out["single_share_slots"] = module.decrypt(ctx, shares[0], ct,
                                                   num_slots=8)
        _distributed(mp_, ctx, shares, ct, rng, out, "ct", 8)
        out["joint"] = mp_.joint_secret(ctx, shares)
        out["add"] = module.eval_add(ct, ct)
        out["add_joint_slots"] = module.decrypt(ctx, out["joint"],
                                                out["add"], num_slots=8)
        out["want"] = v
        return out
    if scheme in ("bgv", "bfv"):
        out["ct_msg"] = ct = module.encrypt(ctx, pk, MSG, rng)
        _distributed(mp_, ctx, shares, ct, rng, out, "ct_msg", 8)
        out["add"] = module.eval_add(ct, ct)
        _distributed(mp_, ctx, shares, out["add"], rng, out, "add", 8)
    evk = _eval_keys(mp_, ctx, shares, rng, out)
    rsh = [mp_.rot_keygen_share(ctx, shares[0], 1, rng)]
    rsh += [mp_.rot_keygen_share(ctx, s, 1, rng, prev_key=rsh[0])
            for s in shares[1:]]
    for i, k in enumerate(rsh, 1):
        out[f"rot_share_{i}"] = k
    out["rot_key"] = rot_key = mp_.rot_keygen_finalize(rsh)
    if scheme == "ckks256":
        v1 = np.tile([0.5, -0.25, 1.0, 0.75], ctx.params.num_slots // 4)
        v2 = np.tile([2.0, 4.0, -1.0, 0.5], ctx.params.num_slots // 4)
        out["want"] = (v1, v2)
    else:
        v1 = [(i % 7) + 1 for i in range(ctx.n // 2)]
        v2 = [(i % 5) + 2 for i in range(ctx.n // 2)]
    out["ct1"] = ct1 = module.encrypt(ctx, pk, v1, rng)
    out["ct2"] = ct2 = module.encrypt(ctx, pk, v2, rng)
    out["prod"] = module.eval_mult_relin(ct1, ct2, evk) \
        if scheme != "bfv" else module.eval_mult_relin(ctx, ct1, ct2, evk)
    out["rot"] = module.eval_rotate(ct1, 1, rot_key)
    _distributed(mp_, ctx, shares, out["prod"], rng, out, "prod", 8)
    _distributed(mp_, ctx, shares, out["rot"], rng, out, "rot", 4)
    return out


SCHEMES = ["ckks128", "ckks256", "bgv", "bfv", "bfv5"]


@pytest.fixture(scope="module", params=SCHEMES)
def flows(request):
    with jax.disable_jit():
        jax_flow = _flow(JAX, request.param)
    return request.param, jax_flow, _flow(PORT, request.param)


def assert_same(port, ref):
    """A port object equal to the JAX package's, through ``convert``."""
    name = type(ref).__name__
    if name == "RnsPoly":
        want = convert.poly_from_jax(ref, "cpu")
        assert (want.basis, want.fmt) == (port.basis, port.fmt)
        assert torch.equal(want.data, port.data)
    elif name == "KSKey":
        want = convert.kskey_from_jax(ref, "cpu")
        assert want.params == port.params
        assert torch.equal(want.b, port.b) and torch.equal(want.a, port.a)
    elif name == "PublicKey":
        assert_same(port.b, ref.b)
        assert_same(port.a, ref.a)
    elif name == "SecretKey":
        assert np.array_equal(convert.secret_key_from_jax(ref).coeffs,
                              port.coeffs)
    elif name == "Ciphertext":
        assert len(port.polys) == len(ref.polys)
        for p, r in zip(port.polys, ref.polys):
            assert_same(p, r)
        for attr in ("scale", "noise_deg"):
            assert getattr(port, attr, None) == getattr(ref, attr, None)
    elif isinstance(ref, list):
        assert list(port) == ref
    else:
        assert np.array_equal(np.asarray(port), np.asarray(ref))


def test_every_state_equal(flows):
    scheme, j, p = flows
    assert set(p) == set(j)
    for name in sorted(j):
        assert_same(p[name], j[name]), name


@pytest.mark.parametrize("kind", ["keys", "shares", "partials", "slots"])
def test_state_kinds(flows, kind):
    """The same comparison by kind of state, so a failure names it."""
    scheme, j, p = flows
    pick = {"keys": lambda k: k.startswith(("pk_", "sk_", "evk", "rot_key",
                                            "joint")),
            "shares": lambda k: k.startswith(("round", "rot_share")),
            "partials": lambda k: "_partial_" in k,
            "slots": lambda k: k.endswith("_slots")}[kind]
    names = [k for k in j if pick(k)]
    if scheme == "ckks128" and kind == "shares":
        assert not names
    else:
        assert names
    for name in names:
        assert_same(p[name], j[name])


def test_decryptions_are_right(flows):
    """The port's slots against the plaintext arithmetic (and one share
    alone does not decrypt)."""
    scheme, _, p = flows
    if scheme == "ckks128":
        v = p["want"]
        assert np.max(np.abs(p["single_share_slots"] - v)) > 1e-2
        assert np.max(np.abs(p["ct_slots"] - v)) < 1e-3
        assert np.max(np.abs(p["add_joint_slots"] - 2 * v)) < 1e-3
        return
    if scheme == "ckks256":
        v1, v2 = p["want"]
        assert np.max(np.abs(p["prod_slots"].real - (v1 * v2)[:8])) < 1e-2
        assert np.max(np.abs(p["rot_slots"].real - np.roll(v1, -1)[:4])) \
            < 1e-2
        return
    t = 65537
    m1 = [(i % 7) + 1 for i in range(64)]
    m2 = [(i % 5) + 2 for i in range(64)]
    assert list(p["prod_slots"]) == [(a * b) % t for a, b in
                                     zip(m1[:8], m2[:8])]
    if scheme == "bfv5":
        return
    assert list(p["ct_msg_slots"]) == MSG
    assert list(p["add_slots"]) == [2 * m % t for m in MSG]
    assert list(p["rot_slots"]) == (m1[1:] + m1[:1])[:4]


def test_key_sums_and_share_product():
    """add_keys_b / add_keys_full / scale_key_by_share alone, against the
    JAX package's, with BGV's t-scaled errors (b's errors drawn before
    a's)."""
    from openfhe_tpu import keyswitch as jks
    jctx = jbgv.gen_context(jbgv.BGVParams(ring_dim=64, mult_depth=1,
                                           mod_size=50, dnum=2))
    ctx = convert.bgv_context_from_jax(jctx, "cpu")
    out = {}
    for pkg, c, m in ((jks, jctx, jbgv), (keyswitch, ctx, bgv)):
        rng = np.random.default_rng(9)
        _, sk = m.keygen(c, rng)
        k1 = m.relin_keygen(c, sk, rng)
        k2 = m.relin_keygen(c, sk, rng)
        s = sk.poly(c.full_qp_basis, *(() if m is jbgv else ("cpu",)))
        with jax.disable_jit():
            out[m is bgv] = [pkg.add_keys_b(k1, k2), pkg.add_keys_full(k1, k2),
                             pkg.scale_key_by_share(k1, s, rng, 3.19,
                                                    error_scale=c.t)]
    for port, ref in zip(out[True], out[False]):
        assert_same(port, ref)
    assert torch.equal(keyswitch.key_a_datas(out[True][0]),
                       out[True][0].a)


def test_convert_carries_protocol_state(flows):
    """Key shares and partial decryptions cross from the JAX package
    whole."""
    scheme, j, p = flows
    if scheme == "ckks128":
        assert convert.ckks_context_from_jax(
            _context(JAX, scheme)[1], "cpu").q_moduli == \
            _context(PORT, scheme)[1].q_moduli
        return
    shares = [j[f"round1_{i}"] for i in (1, 2, 3)]
    for ref in shares:
        port = convert.kskey_from_jax(ref, "cpu")
        assert_same(port, ref)
        assert torch.equal(port.a, keyswitch.key_a_datas(p["round1_1"]))
    for ref in (j[f"prod_partial_{i}"] for i in (1, 2, 3)):
        assert_same(convert.poly_from_jax(ref, "cpu"), ref)
