"""The port's ``models/bgv.py`` against the JAX package's, bit for bit.

One fixture runs one BGV flow of both packages from one seed at the
configuration of ``tests/test_bgv.py:17`` (n = 128, t = 12289, three 55-bit
towers, dnum 2): keygen, the relinearization key and the seven keys of
``sum_galois_indices`` (the row rotations, among them the rotation by 1,
and the row flip), two encryptions, add/sub, the tensor product,
relinearization, ``mod_reduce``, rotation, row flip, ``eval_sum``, the
plaintext-operand ops and ``compress`` to one tower. The tests hold every
key, every ciphertext residue (through ``openfhe_tpu_torch.convert``) and
every decrypted slot EQUAL to the JAX package's, and the slots equal to the
plaintext arithmetic mod t.

The JAX side is the cost of this file, so its flow runs once and every case
reads from it, and it runs under ``jax.disable_jit()``: the JAX package's
own code op by op, the same integers. Jitted, compiling the flow costs more
than running it saves: cold on an 8-core CPU this file took 82 s op by op
and 100 s jitted.
"""

import jax
import numpy as np
import pytest
import torch

from openfhe_tpu.models import bgv as jbgv
from openfhe_tpu_torch import convert
from openfhe_tpu_torch.models import bgv

N = 128
GALOIS = bgv.sum_galois_indices(N)
CIPHERTEXTS = ["ct1", "ct2", "add", "sub", "mult", "mult_relin",
               "mod_reduce", "rotate_1", "flip_rows", "sum", "add_plain",
               "mult_plain", "compress"]


def _flow(mod, where):
    rng = np.random.default_rng(99)
    ctx = mod.gen_context(mod.BGVParams(ring_dim=N, mult_depth=2,
                                        plaintext_modulus=12289, mod_size=55,
                                        dnum=2), *where)
    pk, sk = mod.keygen(ctx, rng)
    evk = mod.relin_keygen(ctx, sk, rng)
    rks = mod.rot_keygen(ctx, sk, GALOIS, rng)
    t = ctx.t
    v1 = [int(x) for x in rng.integers(0, t, size=N)]
    v2 = [int(x) for x in rng.integers(0, t, size=N)]
    cts = {"ct1": mod.encrypt(ctx, pk, v1, rng),
           "ct2": mod.encrypt(ctx, pk, v2, rng)}
    cts["add"] = mod.eval_add(cts["ct1"], cts["ct2"])
    cts["sub"] = mod.eval_sub(cts["ct1"], cts["ct2"])
    cts["mult"] = mod.eval_mult(cts["ct1"], cts["ct2"])
    cts["mult_relin"] = mod.relinearize(cts["mult"], evk)
    low = cts["mod_reduce"] = mod.mod_reduce(ctx, cts["mult_relin"])
    cts["rotate_1"] = mod.eval_rotate(low, 1, rks[GALOIS[0]])
    cts["flip_rows"] = mod.eval_flip_rows(low, rks[2 * N - 1])
    cts["sum"] = mod.eval_sum(low, rks)
    cts["add_plain"] = mod.eval_add_plain(ctx, low, v2)
    cts["mult_plain"] = mod.eval_mult_plain(ctx, low, v2)
    cts["compress"] = mod.compress(ctx, cts["mult_relin"])
    slots = {k: mod.decrypt(ctx, sk, ct) for k, ct in cts.items()}
    return dict(ctx=ctx, pk=pk, sk=sk, evk=evk, rks=rks, cts=cts,
                slots=slots, v=(v1, v2))


@pytest.fixture(scope="module")
def flows():
    with jax.disable_jit():
        jax_flow = _flow(jbgv, ())
    return {"jax": jax_flow, "port": _flow(bgv, ("cpu",))}


def _expected(v1, v2, t):
    a, b = np.asarray(v1, dtype=np.int64), np.asarray(v2, dtype=np.int64)
    prod = a * b % t
    h = N // 2
    return {"ct1": a, "ct2": b, "add": (a + b) % t, "sub": (a - b) % t,
            "mult": prod, "mult_relin": prod, "mod_reduce": prod,
            "rotate_1": np.concatenate([np.roll(prod[:h], -1),
                                        np.roll(prod[h:], -1)]),
            "flip_rows": np.concatenate([prod[h:], prod[:h]]),
            "sum": np.full(N, prod.sum() % t),
            "add_plain": (prod + b) % t, "mult_plain": prod * b % t,
            "compress": prod}


def test_context(flows):
    jctx, ctx = flows["jax"]["ctx"], flows["port"]["ctx"]
    assert (ctx.q_moduli, ctx.p_moduli) == (jctx.q_moduli, jctx.p_moduli)
    for q in ctx.q_moduli + ctx.p_moduli:
        assert q % ctx.t == 1 and q % (2 * N) == 1
    assert convert.bgv_context_from_jax(jctx, "cpu").q_moduli == ctx.q_moduli


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


@pytest.mark.parametrize("name", CIPHERTEXTS)
def test_ciphertexts(flows, name):
    jct = flows["jax"]["cts"][name]
    ct = flows["port"]["cts"][name]
    want = convert.bgv_ciphertext_from_jax(jct, "cpu")
    assert len(want.polys) == len(ct.polys)
    for wp, tp in zip(want.polys, ct.polys):
        assert wp.basis == tp.basis and wp.fmt == tp.fmt
        assert torch.equal(wp.data, tp.data)
    planes = convert.bgv_ciphertext_to_numpy(ct)
    assert all(np.array_equal(lo, np.asarray(jp.lo))
               for (lo, _), jp in zip(planes, jct.polys))


@pytest.mark.parametrize("name", CIPHERTEXTS)
def test_decrypted_slots(flows, name):
    j, p = flows["jax"], flows["port"]
    assert p["slots"][name] == j["slots"][name]
    want = _expected(*p["v"], p["ctx"].t)[name]
    assert p["slots"][name] == want.tolist()


def test_towers_after_mod_switching(flows):
    cts = flows["port"]["cts"]
    assert cts["mult_relin"].towers == 3
    assert cts["mod_reduce"].towers == 2 and cts["compress"].towers == 1


def test_inner_product_on_the_port():
    """eval_inner_product (the port alone: it is eval_sum of
    eval_mult_relin, both held to the JAX package above)."""
    rng = np.random.default_rng(5)
    ctx = bgv.gen_context(bgv.BGVParams(ring_dim=N, mult_depth=1,
                                        plaintext_modulus=12289, mod_size=55,
                                        dnum=2), "cpu")
    pk, sk = bgv.keygen(ctx, rng)
    evk = bgv.relin_keygen(ctx, sk, rng)
    rks = bgv.rot_keygen(ctx, sk, GALOIS, rng)
    v1 = rng.integers(0, ctx.t, size=N)
    v2 = rng.integers(0, ctx.t, size=N)
    ct = bgv.eval_inner_product(ctx, bgv.encrypt(ctx, pk, v1.tolist(), rng),
                                bgv.encrypt(ctx, pk, v2.tolist(), rng), evk,
                                rks)
    assert bgv.decrypt(ctx, sk, ct) == [int((v1 * v2).sum() % ctx.t)] * N
