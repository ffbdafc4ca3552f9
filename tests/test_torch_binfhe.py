"""The port's ``models/binfhe.py`` against the JAX package's, bit for bit.

One fixture per parameter set (TOY: GINX at N = 256; TOY_AP: the DM/AP
accumulator; TOY_REF: the reference's own toy set, N = 512, a base-25 key
switch at the NTT prime) runs one BINFHE flow of both packages from one
seed: keygen, the bootstrap key, LWE encryptions, one batched truth table
per gate kind, NOT, the multi-input gates and CMUX over every input, refresh,
a blind rotation alone, and the public key with ``encrypt_pk`` and
``switch_ct_to_qn`` into a gate. The tests hold the secret, every residue of
both bootstrap keys, every ciphertext, the accumulator and every gate's
output EQUAL to the JAX package's (through ``openfhe_tpu_torch.convert``)
and the decryptions to the plaintext truth.

The JAX side runs jitted: its blind rotation is one ``lax.scan``, compiled
once per batch size in a few seconds, then some 0.03 s a gate at TOY; under
``jax.disable_jit()`` the scan runs step by step and one batched gate takes
about 40 s on an 8-core CPU. The integers are the same either way.

The signed gadget decomposition is held equal at the six wide sets of
``tests/test_binfhe_wide.py`` and two narrow ones, and the rounding modulus
switch at the widths where the JAX package's int64 product does and does
not wrap.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from openfhe_tpu.models import binfhe as jb
from openfhe_tpu.ops import limb
from openfhe_tpu_torch import convert
from openfhe_tpu_torch.models import binfhe

PAIRS = ((0, 0), (0, 1), (1, 0), (1, 1))
TRUTH = {"AND": lambda x, y: x & y, "OR": lambda x, y: x | y,
         "NAND": lambda x, y: 1 - (x & y), "NOR": lambda x, y: 1 - (x | y),
         "XOR": lambda x, y: x ^ y, "XNOR": lambda x, y: 1 - (x ^ y)}
MULTI = {"MAJORITY": lambda v: int(sum(v) >= 2), "AND3": min, "OR3": max,
         "AND4": min, "OR4": max, "CMUX": lambda v: v[1] if v[2] else v[0]}
# per set: seed, 2-input gates, multi-input gates, refreshes
FLOWS = {"TOY": (11, tuple(TRUTH), tuple(MULTI), 2),
         "TOY_AP": (13, ("AND", "XOR"), ("MAJORITY", "CMUX"), 1),
         "TOY_REF": (17, ("NAND", "XNOR"), ("OR3",), 1)}
WIDE_SETS = ["STD192", "STD192Q", "STD192Q_3", "STD192Q_4", "STD128Q_3",
             "STD128Q_4"]


def _multi_inputs(gate):
    arity, p = (3, 4) if gate == "CMUX" else jb.MULTI_GATES[gate][:2]
    return list(itertools.product((0, 1), repeat=arity)), p


def _flow(m, name, where):
    seed, gates, multi, refreshes = FLOWS[name]
    rng = np.random.default_rng(seed)
    ctx = m.gen_context(name, *where)
    sk = m.keygen(ctx, rng)
    bk = m.bootstrap_keygen(ctx, sk, rng)
    c1 = [m.encrypt(ctx, sk, x, rng) for x, _ in PAIRS]
    c2 = [m.encrypt(ctx, sk, y, rng) for _, y in PAIRS]
    outs, want = {}, {}
    for g in gates:
        outs[g] = m.eval_gate_batch(ctx, g, bk, c1, c2)
        want[g] = [TRUTH[g](x, y) for x, y in PAIRS]
    outs["NOT"] = [m.eval_not(ctx, c) for c in c1]
    want["NOT"] = [1 - x for x, _ in PAIRS]
    for g in multi:
        combos, p = _multi_inputs(g)
        batches = [[m.encrypt_zp(ctx, sk, v, p, rng) for v in c]
                   for c in combos]
        outs[g] = m.eval_gate_vec_batch(ctx, g, bk, batches)
        want[g] = [MULTI[g](c) for c in combos]
    outs["bootstrap"] = [m.bootstrap(ctx, bk, c)
                         for c in (c1[1], c1[2])[:refreshes]]
    want["bootstrap"] = [0, 1][:refreshes]
    pk = m.pubkey_gen(ctx, sk, rng)
    big = [m.encrypt_pk(ctx, pk, x, rng) for x in (0, 1)]
    moved = [m.switch_ct_to_qn(ctx, bk, c) for c in big]
    outs["switch_ct_to_qn"] = moved
    want["switch_ct_to_qn"] = [0, 1]
    outs["public key AND"] = m.eval_gate_batch(ctx, "AND", bk, moved,
                                               c2[2:])
    want["public key AND"] = [0, 1]
    # a blind rotation alone, at random exponents mod 2N
    p = ctx.params
    a_2n = rng.integers(0, 2 * p.N, size=(3, p.n_lwe), dtype=np.int64)
    b_2n = rng.integers(0, 2 * p.N, size=3, dtype=np.int64)
    if m is binfhe:
        acc = m._bootstrap_core(ctx, bk, torch.from_numpy(a_2n), b_2n)
    else:
        acc = convert.u64_to_tensor(
            *(np.asarray(x) for x in m._bootstrap_core(ctx, bk, a_2n, b_2n)),
            "cpu").transpose(0, 1)
    dec = {k: [m.decrypt(ctx, sk, c) for c in v] for k, v in outs.items()}
    return dict(ctx=ctx, sk=sk, bk=bk, pk=pk, cts=c1 + c2, big=big,
                outs=outs, want=want, dec=dec, acc=acc)


@pytest.fixture(scope="module", params=list(FLOWS))
def flows(request):
    name = request.param
    return name, _flow(jb, name, ()), _flow(binfhe, name, ("cpu",))


def _same_lwe(jct, ct):
    want = convert.lwe_ciphertext_from_jax(jct, "cpu")
    assert torch.equal(want.a, ct.a)
    assert (want.b, want.modulus) == (ct.b, ct.modulus)
    a, b, q = convert.lwe_ciphertext_to_numpy(ct)
    assert np.array_equal(a, np.asarray(jct.a)) and (b, q) == \
        (jct.b, jct.modulus)


def test_context_and_secret(flows):
    name, j, p = flows
    assert dataclasses.asdict(j["ctx"].params) == \
        dataclasses.asdict(p["ctx"].params)
    assert convert.binfhe_context_from_jax(j["ctx"], "cpu") == p["ctx"]
    sk = convert.binfhe_secret_from_jax(j["sk"])
    assert np.array_equal(sk.s_lwe, p["sk"].s_lwe)
    assert np.array_equal(sk.z_ring, p["sk"].z_ring)
    assert all(np.array_equal(x, y) for x, y in zip(
        convert.binfhe_secret_to_numpy(p["sk"]), (j["sk"].s_lwe,
                                                  j["sk"].z_ring)))


def test_bootstrap_key(flows):
    """Every residue of the blind-rotation key and the key-switch key, both
    ways through convert (the port keeps ek with axes 1 and 3 swapped)."""
    name, j, p = flows
    bk = convert.bootstrap_key_from_jax(j["bk"], "cpu")
    assert torch.equal(bk.ek, p["bk"].ek)
    assert torch.equal(bk.ks_a, p["bk"].ks_a)
    assert torch.equal(bk.ks_b, p["bk"].ks_b)
    ctx = p["ctx"].params
    T, V = ((ctx.n_lwe, 2) if ctx.method == "GINX"
            else (ctx.n_lwe * ctx.d_r, ctx.B_r))
    assert tuple(p["bk"].ek.shape) == (T, 2, 2 * ctx.dg, V, ctx.N)
    for got, want in zip(convert.bootstrap_key_to_numpy(p["bk"]),
                         (j["bk"].ek_lo, j["bk"].ek_hi, j["bk"].ks_a,
                          j["bk"].ks_b)):
        want = np.asarray(want)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_lwe_ciphertexts(flows):
    name, j, p = flows
    for jct, ct in zip(j["cts"], p["cts"]):
        _same_lwe(jct, ct)


def test_public_key_and_its_ciphertexts(flows):
    name, j, p = flows
    pk = convert.lwe_public_key_from_jax(j["pk"], "cpu")
    assert torch.equal(pk.A, p["pk"].A) and torch.equal(pk.v, p["pk"].v)
    for jct, ct in zip(j["big"], p["big"]):
        _same_lwe(jct, ct)
        assert ct.modulus == p["ctx"].params.Q


def test_accumulator_after_blind_rotation(flows):
    name, j, p = flows
    assert torch.equal(j["acc"], p["acc"])


def test_gate_outputs(flows):
    """Every gate's output ciphertext (one batched truth table per kind)."""
    name, j, p = flows
    assert list(j["outs"]) == list(p["outs"])
    for kind in p["outs"]:
        assert len(j["outs"][kind]) == len(p["outs"][kind])
        for jct, ct in zip(j["outs"][kind], p["outs"][kind]):
            _same_lwe(jct, ct)


def test_decryptions(flows):
    name, j, p = flows
    assert p["dec"] == j["dec"]
    assert p["dec"] == p["want"]


@pytest.mark.parametrize("name", WIDE_SETS + ["STD128", "TOY_REF"])
def test_signed_decompose(name):
    """One int64 path equals the JAX package's int32 lanes (Q <= 30 bits)
    and two-limb path (the wide sets), digit for digit."""
    p = binfhe.reference_params(name) if name != "TOY_REF" else \
        binfhe.PARAM_SETS[name]()
    jp = jb.PARAM_SETS[name]()
    rng = np.random.default_rng(len(name))
    vals = rng.integers(0, p.Q, size=(3, 2, p.N), dtype=np.uint64)
    # the centered lift's edges: 0, Q/2, Q/2 + 1, Q - 1
    vals[0, 0, :4] = [0, p.Q // 2, p.Q // 2 + 1, p.Q - 1]
    want = limb.to_int_array(jb._make_signed_decompose(jp)(
        limb.from_int_array(vals)))
    got = binfhe._make_signed_decompose(p)(
        torch.from_numpy(vals.astype(np.int64)).transpose(0, 1))
    assert tuple(got.shape) == (2 * p.dg, 3, p.N)
    assert np.array_equal(got.transpose(0, 1).numpy(),
                          np.asarray(want, dtype=np.int64))


@pytest.mark.parametrize("old,new", [
    ("TOY", "q_ks"), ("STD128", "q_ks"), ("STD128Q", "q_ks"),
    ("q_ks", "q"), ("TOY_REF", "q_ks")])
def test_mod_switch_equals_the_reference_where_it_does_not_wrap(old, new):
    p = binfhe.PARAM_SETS["STD128" if old == "q_ks" else old]()
    mod = p.q_ks if old == "q_ks" else p.Q
    new_mod = p.q if new == "q" else p.q_ks
    assert mod.bit_length() + new_mod.bit_length() + 1 <= 62
    rng = np.random.default_rng(mod % 1000)
    a = rng.integers(0, mod, size=64, dtype=np.int64)
    a[:3] = [0, mod // 2, mod - 1]
    b = int(rng.integers(0, mod))
    want = jb._mod_switch_lwe(jb.LWECiphertext(a, b, mod), new_mod)
    got = binfhe._mod_switch_lwe(binfhe.LWECiphertext(
        torch.from_numpy(a), b, mod), new_mod)
    _same_lwe(want, got)


def test_mod_switch_is_exact_where_the_reference_wraps():
    """At a 50-bit Q (STD128Q_3's) and q_ks = 2^15, (a * 2 q_ks) passes
    2^63: the JAX package's int64 product wraps, the port rounds exactly."""
    p = binfhe.reference_params("STD128Q_3")
    Q, q_ks = p.Q, p.q_ks
    assert (Q.bit_length(), q_ks) == (50, 1 << 15)
    rng = np.random.default_rng(5)
    a = rng.integers(0, Q, size=256, dtype=np.int64)
    a[:4] = [Q // 3, 0, Q // 2, Q - 1]
    exact = [(int(x) * q_ks * 2 + Q) // (2 * Q) % q_ks for x in a]
    got = binfhe._mod_switch_lwe(binfhe.LWECiphertext(
        torch.from_numpy(a), Q // 3, Q), q_ks)
    assert got.a.tolist() == exact and got.b == exact[0]
    ref = jb._mod_switch_lwe(jb.LWECiphertext(a, Q // 3, Q), q_ks)
    assert ref.a.tolist() != exact
    assert (int(ref.a[0]), exact[0]) == (2731, 10923)


def test_parameter_sets():
    """Every named set, the reference's 24 and the TOY variants, with the
    same primes and derived digit counts."""
    assert list(binfhe.PARAM_SETS) == list(jb.PARAM_SETS)
    assert binfhe._REF_TABLE == jb._REF_TABLE
    for name in binfhe.PARAM_SETS:
        p, jp = binfhe.PARAM_SETS[name](), jb.PARAM_SETS[name]()
        assert dataclasses.asdict(p) == dataclasses.asdict(jp), name
        assert (p.q, p.dg, p.B_ks, p.d_ks, p.B_r, p.d_r) == \
            (jp.q, jp.dg, jp.B_ks, jp.d_ks, jp.B_r, jp.d_r), name


def test_context_refusals():
    base = binfhe.toy_params()
    for bad, match in (
            (dataclasses.replace(base, Q=(1 << 60) + 1), "59-bit"),
            (dataclasses.replace(binfhe.reference_params("STD128Q_3"),
                                 method="AP"), "Q < 2"),
            (dataclasses.replace(base, q_gate=384), "divide 2N")):
        with pytest.raises(ValueError, match=match):
            binfhe.gen_context(bad, "cpu")
        with pytest.raises(ValueError, match=match):
            jb.gen_context(bad)


def test_lmkcdey_stops_after_its_secret():
    """A LMKCDEY context and its Gaussian secret equal the JAX package's;
    what follows the secret (the key, the blind rotation, the gates) is
    held equal in ``tests/test_torch_binfhe_lp.py``. Here: bootstrap_keygen
    gives the LMKCDEY key in the port's layout."""
    ctx = binfhe.gen_context("TOY_LMKCDEY", "cpu")
    for name in ("TOY_LMKCDEY", "STD128_LMKCDEY"):
        sk = binfhe.keygen(binfhe.gen_context(name, "cpu"),
                           np.random.default_rng(3))
        jsk = jb.keygen(jb.gen_context(name), np.random.default_rng(3))
        assert np.array_equal(sk.s_lwe, jsk.s_lwe)
        assert np.array_equal(sk.z_ring, jsk.z_ring)
    p = ctx.params
    sk = binfhe.keygen(ctx, np.random.default_rng(3))
    bk = binfhe.bootstrap_keygen(ctx, sk, np.random.default_rng(3))
    assert isinstance(bk, binfhe.LMKCDEYKey)
    assert tuple(bk.ek.shape) == (p.n_lwe, 2, 2 * p.dg, 1, p.N)
    assert tuple(bk.ak.shape) == (2, 2, p.dg, 1, p.N)


def test_multi_gates_refuse_bad_inputs(flows):
    name, _, p = flows
    ctx, sk, bk = p["ctx"], p["sk"], p["bk"]
    ct = binfhe.encrypt(ctx, sk, 1, np.random.default_rng(1))
    with pytest.raises(ValueError, match="independent"):
        binfhe.eval_gate_vec(ctx, "MAJORITY", bk, [ct, ct, p["cts"][0]])
    with pytest.raises(ValueError, match="exactly 4"):
        binfhe.eval_gate_vec(ctx, "AND4", bk, p["cts"][:3])


def test_zp_encryption_equals_the_reference():
    """encrypt_zp/decrypt_zp at p = 6 and 8 (the multi-input gates' input
    scales) draw and decode as the JAX package does."""
    ctx, jctx = binfhe.gen_context("TOY", "cpu"), jb.gen_context("TOY")
    rng, jrng = np.random.default_rng(9), np.random.default_rng(9)
    sk, jsk = binfhe.keygen(ctx, rng), jb.keygen(jctx, jrng)
    for p in (6, 8):
        for m in range(p):
            ct = binfhe.encrypt_zp(ctx, sk, m, p, rng)
            jct = jb.encrypt_zp(jctx, jsk, m, p, jrng)
            _same_lwe(jct, ct)
            assert binfhe.decrypt_zp(ctx, sk, ct, p) == m == \
                jb.decrypt_zp(jctx, jsk, jct, p)
