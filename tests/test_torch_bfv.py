"""The port's ``models/bfv.py`` against the JAX package's, bit for bit.

One fixture runs one BFV flow of both packages from one seed at the
configuration of ``tests/test_bfv.py:15`` (n = 128, t = 12289, two 55-bit
towers, dnum 2): keygen, the relinearization key and the seven keys of
``sum_galois_indices``, two encryptions, add/sub, the HPS product, the
HPSPOVERQ product (and its leveled pipeline with one tower dropped, as
``tests/test_bfv.py:140`` forces it), the BEHZ product (``:117``), each
relinearized, rotation, row flip, ``eval_sum``, the plaintext-operand ops,
the coefficient and string encodings and ``compress`` to one tower. The
tests hold every key, every ciphertext residue and its noise degree, and
every decryption EQUAL to the JAX package's, and the slots equal to the
plaintext arithmetic mod t.

As in ``tests/test_torch_bgv.py``, the JAX flow runs once, under
``jax.disable_jit()`` (the JAX package's own code op by op): cold on an
8-core CPU this file took 97 s op by op and 255 s jitted.
"""

import jax
import numpy as np
import pytest
import torch

from openfhe_tpu import dcrt as jdcrt
from openfhe_tpu.models import bfv as jbfv
from openfhe_tpu_torch import convert, dcrt
from openfhe_tpu_torch.models import bfv

N = 128
GALOIS = bfv.sum_galois_indices(N)
TEXT = "BFV über RNS"
COEFS = [3, -5, 0, 6144, -6144, 1, 7]
CIPHERTEXTS = ["ct1", "ct2", "add", "sub", "mult_hps", "relin_hps",
               "mult_povq", "relin_povq", "mult_povq_drop1", "mult_behz",
               "relin_behz", "rotate_1", "flip_rows", "sum", "add_plain",
               "mult_plain", "coef", "string", "compress"]


def _flow(mod, where):
    rng = np.random.default_rng(4242)
    ctx = mod.gen_context(mod.BFVParams(ring_dim=N, plaintext_modulus=12289,
                                        num_towers=2, mod_size=55, dnum=2),
                          *where)
    pk, sk = mod.keygen(ctx, rng)
    evk = mod.relin_keygen(ctx, sk, rng)
    rks = mod.rot_keygen(ctx, sk, GALOIS, rng)
    t = ctx.t
    v1 = [int(x) for x in rng.integers(0, t, size=N)]
    v2 = [int(x) for x in rng.integers(0, t, size=N)]
    c1 = mod.encrypt(ctx, pk, v1, rng)
    c2 = mod.encrypt(ctx, pk, v2, rng)
    cts = {"ct1": c1, "ct2": c2, "add": mod.eval_add(c1, c2),
           "sub": mod.eval_sub(c1, c2)}
    cts["mult_hps"] = mod.eval_mult(ctx, c1, c2)
    cts["mult_povq"] = mod.eval_mult_povq(ctx, c1, c2)
    cts["mult_behz"] = mod.eval_mult_behz(ctx, c1, c2)
    for name in ("hps", "povq", "behz"):
        cts[f"relin_{name}"] = mod.relinearize(cts[f"mult_{name}"], evk)
    if mod is bfv:
        x = torch.cat([torch.stack([p.data for p in c.polys])
                       for c in (c1, c2)])
        d = bfv.mult_povq(ctx, x, 1)
        polys = tuple(dcrt.RnsPoly(p, ctx.basis(), dcrt.Format.EVAL)
                      for p in d)
    else:
        d = jbfv._mult_pipeline_povq(ctx, 1)(
            c1.polys[0].data, c1.polys[1].data, c2.polys[0].data,
            c2.polys[1].data)
        polys = tuple(jdcrt.make_poly(ctx.basis(), p, jdcrt.Format.EVAL)
                      for p in d)
    cts["mult_povq_drop1"] = mod.Ciphertext(polys, noise_deg=2)
    prod = cts["relin_hps"]
    cts["rotate_1"] = mod.eval_rotate(prod, 1, rks[GALOIS[0]])
    cts["flip_rows"] = mod.eval_flip_rows(prod, rks[2 * N - 1])
    cts["sum"] = mod.eval_sum(prod, rks)
    cts["add_plain"] = mod.eval_add_plain(ctx, prod, v2)
    cts["mult_plain"] = mod.eval_mult_plain(ctx, prod, v2)
    cts["coef"] = mod.encrypt_poly(ctx, pk, mod.encode_coef(ctx, COEFS), rng)
    cts["string"] = mod.encrypt_poly(ctx, pk, mod.encode_string(ctx, TEXT),
                                     rng)
    cts["compress"] = mod.compress(ctx, prod)
    out = {k: mod.decrypt(ctx, sk, ct) for k, ct in cts.items()
           if k not in ("coef", "string")}
    out["coef"] = mod.decrypt_coef(ctx, sk, cts["coef"], len(COEFS))
    out["string"] = mod.decrypt_string(ctx, sk, cts["string"])
    return dict(ctx=ctx, pk=pk, sk=sk, evk=evk, rks=rks, cts=cts,
                out=out, v=(v1, v2))


@pytest.fixture(scope="module")
def flows():
    with jax.disable_jit():
        jax_flow = _flow(jbfv, ())
    return {"jax": jax_flow, "port": _flow(bfv, ("cpu",))}


def _expected(v1, v2, t):
    a, b = np.asarray(v1, dtype=np.int64), np.asarray(v2, dtype=np.int64)
    prod = (a * b % t).tolist()
    h = N // 2
    p = np.asarray(prod)
    out = {"ct1": a.tolist(), "ct2": b.tolist(), "add": ((a + b) % t).tolist(),
           "sub": ((a - b) % t).tolist(),
           "rotate_1": np.concatenate([np.roll(p[:h], -1),
                                       np.roll(p[h:], -1)]).tolist(),
           "flip_rows": np.concatenate([p[h:], p[:h]]).tolist(),
           "sum": [int(p.sum() % t)] * N,
           "add_plain": ((p + b) % t).tolist(),
           "mult_plain": (p * b % t).tolist(),
           "coef": COEFS, "string": TEXT, "compress": prod}
    for name in ("mult_hps", "relin_hps", "mult_povq", "relin_povq",
                 "mult_povq_drop1", "mult_behz", "relin_behz"):
        out[name] = prod
    return out


def test_context(flows):
    jctx, ctx = flows["jax"]["ctx"], flows["port"]["ctx"]
    assert (ctx.q_moduli, ctx.r_moduli, ctx.p_moduli) == \
        (jctx.q_moduli, jctx.r_moduli, jctx.p_moduli)
    assert ctx.delta_rows == jctx.delta_rows
    assert bfv._behz_msk(ctx) == jbfv._behz_msk(jctx)
    assert convert.bfv_context_from_jax(jctx, "cpu").r_moduli == ctx.r_moduli


def test_public_and_secret_key(flows):
    j, p = flows["jax"], flows["port"]
    assert np.array_equal(convert.secret_key_from_jax(j["sk"]).coeffs,
                          p["sk"].coeffs)
    pk = convert.public_key_from_jax(j["pk"], "cpu")
    assert torch.equal(pk.b.data, p["pk"].b.data)
    assert torch.equal(pk.a.data, p["pk"].a.data)


@pytest.mark.parametrize("k", ["relin"] + GALOIS)
def test_switching_keys(flows, k):
    j, p = flows["jax"], flows["port"]
    jk, pk = (j["evk"], p["evk"]) if k == "relin" else \
        (j["rks"][k], p["rks"][k])
    want = convert.kskey_from_jax(jk, "cpu")
    assert want.params == pk.params
    assert torch.equal(want.b, pk.b) and torch.equal(want.a, pk.a)
    if k != "relin":
        want = convert.rotation_keys_from_jax({k: jk}, "cpu")[k]
        assert torch.equal(want.b, pk.b)


@pytest.mark.parametrize("name", CIPHERTEXTS)
def test_ciphertexts(flows, name):
    jct = flows["jax"]["cts"][name]
    ct = flows["port"]["cts"][name]
    want = convert.bfv_ciphertext_from_jax(jct, "cpu")
    assert want.noise_deg == ct.noise_deg
    assert len(want.polys) == len(ct.polys)
    for wp, tp in zip(want.polys, ct.polys):
        assert wp.basis == tp.basis and wp.fmt == tp.fmt
        assert torch.equal(wp.data, tp.data)
    planes, deg = convert.bfv_ciphertext_to_numpy(ct)
    assert deg == jct.noise_deg
    assert all(np.array_equal(hi, np.asarray(jp.hi))
               for (_, hi), jp in zip(planes, jct.polys))


@pytest.mark.parametrize("name", CIPHERTEXTS)
def test_decryptions(flows, name):
    j, p = flows["jax"], flows["port"]
    assert p["out"][name] == j["out"][name]
    assert p["out"][name] == _expected(*p["v"], p["ctx"].t)[name]


def test_noise_degrees_and_towers(flows):
    cts = flows["port"]["cts"]
    assert cts["relin_hps"].noise_deg == cts["relin_behz"].noise_deg == 2
    # an automorphism's result has degree 1, as in the JAX package, and a
    # sum takes the larger degree
    assert cts["rotate_1"].noise_deg == 1 and cts["sum"].noise_deg == 2
    assert cts["compress"].basis.L == 1


@pytest.mark.parametrize("depth", [0, 1, 3, 5])
def test_find_levels_to_drop(depth):
    """The noise estimate's float arithmetic, in both packages, on the toy
    context of tests/test_bfv.py:140 and at n = 2^14."""
    for params in (dict(ring_dim=128, plaintext_modulus=3329, num_towers=4,
                        mod_size=50, dnum=2),
                   dict(ring_dim=1 << 14, plaintext_modulus=65537,
                        num_towers=10, mod_size=45, dnum=5)):
        jctx = jbfv.gen_context(jbfv.BFVParams(**params))
        ctx = bfv.gen_context(bfv.BFVParams(**params), "cpu")
        for ks in (False, True):
            assert bfv.find_levels_to_drop(ctx, depth, ks) == \
                jbfv.find_levels_to_drop(jctx, depth, ks)
    assert bfv.find_levels_to_drop(ctx, 5) >= 1
