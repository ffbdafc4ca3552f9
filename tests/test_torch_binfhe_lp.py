"""The rest of the port's ``models/binfhe.py`` against the JAX package's, bit
for bit: programmable bootstrapping, the large-precision functions and the
LMKCDEY accumulator.

One fixture per set runs one flow of both packages from one seed. At TOY_LP
(GINX, the set ``tests/test_binfhe.py`` runs its large-precision tests at):
``encrypt_phase`` at q_ks, ``eval_sign`` over every message of Z_8 and
``eval_func`` with a negacyclic LUT, ``eval_floor``, ``eval_sign_large`` and
``eval_decomp``. At TOY_LMKCDEY: the LMKCDEY key (``ek``, ``ak``, ``ks_a``,
``ks_b``), AND, OR and XOR over their truth tables as batches, a refresh of
0 and of 1 and one ``eval_func``. Every key, ciphertext and output is held
EQUAL to the JAX package's (through ``openfhe_tpu_torch.convert``), and
every decryption to the bound the JAX test asserts. The JAX side runs
jitted, as ``tests/test_torch_binfhe.py`` explains; LMKCDEY's schedule and
automorphisms are held equal on the host at TOY and STD128 widths.
"""

import dataclasses

import numpy as np
import pytest
import torch

from openfhe_tpu.models import binfhe as jb
from openfhe_tpu_torch import convert
from openfhe_tpu_torch.models import binfhe

P_MSG = 8
LUT = [0, 1, 2, 3, 0, 7, 6, 5]        # negacyclic: lut[m+4] = -lut[m] mod 8
SIGN = [0, 1, 1, 1, 0, 7, 7, 7]       # eval_sign's table at p = 8
BETA = 64
FLOORS = (1000, 5000, 12345)
SIGNS = (100, 7000, 9000, 16000)
DECOMP = 12345
PAIRS = ((0, 0), (0, 1), (1, 0), (1, 1))
TRUTH = {"AND": lambda x, y: x & y, "OR": lambda x, y: x | y,
         "XOR": lambda x, y: x ^ y}
SEEDS = {"TOY_LP": 19, "TOY_LMKCDEY": 23}


def _lp_flow(m, ctx, sk, bk, rng):
    """Large precision at TOY_LP: (outputs by kind, their decryptions)."""
    mod = ctx.params.q_ks
    outs = {"encrypt_phase": [m.encrypt_phase(ctx, sk, v, mod, rng)
                              for v in FLOORS]}
    cts = [m.encrypt_zp(ctx, sk, v, P_MSG, rng) for v in range(P_MSG)]
    outs["eval_sign"] = [m.eval_sign(ctx, bk, c, P_MSG) for c in cts]
    outs["eval_func"] = [m.eval_func(ctx, bk, cts[v], LUT, P_MSG)
                         for v in (1, 3, 5)]
    outs["eval_floor"] = [m.eval_floor(ctx, bk, c, BETA)
                          for c in outs["encrypt_phase"]]
    outs["eval_sign_large"] = [
        m.eval_sign_large(ctx, bk, m.encrypt_phase(ctx, sk, v, mod, rng),
                          BETA) for v in SIGNS]
    outs["eval_decomp"] = m.eval_decomp(
        ctx, bk, m.encrypt_phase(ctx, sk, DECOMP, mod, rng), BETA)
    dec = {k: [m.decrypt_phase(ctx, sk, c) for c in v]
           for k, v in outs.items()}
    dec["eval_sign"] = [m.decrypt_zp(ctx, sk, c, P_MSG)
                        for c in outs["eval_sign"]]
    dec["eval_func"] = [m.decrypt_zp(ctx, sk, c, P_MSG)
                        for c in outs["eval_func"]]
    dec["eval_sign_large"] = [m.decrypt_zp(ctx, sk, c, 2)
                              for c in outs["eval_sign_large"]]
    return outs, dec


def _lmk_flow(m, ctx, sk, bk, rng):
    """LMKCDEY at TOY_LMKCDEY: gate batches, refreshes and one LUT."""
    outs = {}
    for gate in TRUTH:
        c1 = [m.encrypt(ctx, sk, x, rng) for x, _ in PAIRS]
        c2 = [m.encrypt(ctx, sk, y, rng) for _, y in PAIRS]
        outs[gate] = m.eval_gate_batch(ctx, gate, bk, c1, c2)
    outs["bootstrap"] = [m.bootstrap(ctx, bk, m.encrypt(ctx, sk, x, rng))
                         for x in (0, 1)]
    dec = {k: [m.decrypt(ctx, sk, c) for c in v] for k, v in outs.items()}
    outs["eval_func"] = [m.eval_func(
        ctx, bk, m.encrypt_zp(ctx, sk, 3, P_MSG, rng), LUT, P_MSG)]
    dec["eval_func"] = [m.decrypt_zp(ctx, sk, c, P_MSG)
                        for c in outs["eval_func"]]
    return outs, dec


def _flow(m, name, where):
    rng = np.random.default_rng(SEEDS[name])
    ctx = m.gen_context(name, *where)
    sk = m.keygen(ctx, rng)
    bk = m.bootstrap_keygen(ctx, sk, rng)
    run = _lp_flow if name == "TOY_LP" else _lmk_flow
    outs, dec = run(m, ctx, sk, bk, rng)
    return dict(ctx=ctx, sk=sk, bk=bk, outs=outs, dec=dec)


@pytest.fixture(scope="module", params=list(SEEDS))
def flows(request):
    name = request.param
    return name, _flow(jb, name, ()), _flow(binfhe, name, ("cpu",))


def _same_lwe(jct, ct):
    want = convert.lwe_ciphertext_from_jax(jct, "cpu")
    assert torch.equal(want.a, ct.a)
    assert (want.b, want.modulus) == (ct.b, ct.modulus)


def test_context_and_secret(flows):
    name, j, p = flows
    assert dataclasses.asdict(j["ctx"].params) == \
        dataclasses.asdict(p["ctx"].params)
    assert np.array_equal(j["sk"].s_lwe, p["sk"].s_lwe)
    assert np.array_equal(j["sk"].z_ring, p["sk"].z_ring)


def test_bootstrap_key(flows):
    """Every residue of the blind-rotation key (and LMKCDEY's automorphism
    keys) and the key-switch key, both ways through convert."""
    name, j, p = flows
    if name == "TOY_LP":
        got = convert.bootstrap_key_from_jax(j["bk"], "cpu")
        assert torch.equal(got.ek, p["bk"].ek)
        return
    pp = p["ctx"].params
    bk = p["bk"]
    assert tuple(bk.ek.shape) == (pp.n_lwe, 2, 2 * pp.dg, 1, pp.N)
    assert tuple(bk.ak.shape) == (2, 2, pp.dg, 1, pp.N)
    got = convert.lmkcdey_key_from_jax(j["bk"], "cpu")
    for g, w in ((got.ek, bk.ek), (got.ak, bk.ak), (got.ks_a, bk.ks_a),
                 (got.ks_b, bk.ks_b)):
        assert torch.equal(g, w)
    for g, w in zip(convert.lmkcdey_key_to_numpy(bk),
                    (j["bk"].ek_lo, j["bk"].ek_hi, j["bk"].ak_lo,
                     j["bk"].ak_hi, j["bk"].ks_a, j["bk"].ks_b)):
        w = np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_outputs(flows):
    """Every output ciphertext, at its modulus (q, q_ks, 2N or a digit's)."""
    name, j, p = flows
    assert list(j["outs"]) == list(p["outs"])
    for kind in p["outs"]:
        assert len(j["outs"][kind]) == len(p["outs"][kind]), kind
        for jct, ct in zip(j["outs"][kind], p["outs"][kind]):
            _same_lwe(jct, ct)


def test_decryptions(flows):
    """Equal to the JAX package's, and within the JAX tests' bounds."""
    name, j, p = flows
    dec = p["dec"]
    assert dec == j["dec"]
    if name == "TOY_LMKCDEY":
        for gate, fn in TRUTH.items():
            assert dec[gate] == [fn(x, y) for x, y in PAIRS], gate
        assert dec["bootstrap"] == [0, 1]
        assert dec["eval_func"] == [LUT[3]]
        return
    q, mod = 2 * p["ctx"].params.N, p["ctx"].params.q_ks
    assert dec["encrypt_phase"] == pytest.approx(FLOORS, abs=16)
    assert dec["eval_sign"] == SIGN
    assert dec["eval_func"] == [LUT[v] for v in (1, 3, 5)]
    for v, got in zip(FLOORS, dec["eval_floor"]):
        want = ((v + BETA) // q) * q
        assert min((got - want) % mod, (want - got) % mod) < 2 * BETA, v
    assert dec["eval_sign_large"] == [int(v >= mod // 2) for v in SIGNS]
    d0 = dec["eval_decomp"][0]
    assert len(dec["eval_decomp"]) >= 2
    assert min((d0 - DECOMP % q) % q, (DECOMP % q - d0) % q) < 16


@pytest.mark.parametrize("name", ["TOY_LMKCDEY", "STD128_LMKCDEY"])
def test_lmk_schedule(name):
    """One ciphertext's schedule of ops and key rows, the dlog table and
    both automorphisms equal the JAX package's (host code; STD128_LMKCDEY's
    N = 1024 schedule has 1469 steps)."""
    ctx, jctx = binfhe.gen_context(name, "cpu"), jb.gen_context(name)
    p = ctx.params
    a = np.random.default_rng(7).integers(0, 2 * p.N, p.n_lwe,
                                          dtype=np.int64)
    a[:3] = [0, 1, p.N]
    ops, idx = binfhe._lmk_schedule(ctx, a)
    jops, jidx = jb._lmk_schedule(jctx, a)
    assert np.array_equal(ops, jops) and np.array_equal(idx, jidx)
    assert len(ops) == 2 * (p.N // 2 - 1) + 1 + p.n_lwe
    assert sorted(idx[ops == 0]) == list(range(p.n_lwe))
    assert binfhe._lmk_dlog_table(p.N) == jb._lmk_dlog_table(p.N)
    rows = np.random.default_rng(8).integers(0, p.Q, (2, p.N),
                                             dtype=np.int64)
    for t in (binfhe._LMK_GEN, 2 * p.N - binfhe._LMK_GEN):
        assert all(np.array_equal(x, y) for x, y in zip(
            binfhe._auto_perm_sign(p.N, t), jb._auto_perm_sign(p.N, t)))
        got = binfhe._apply_auto_np_free(torch.from_numpy(rows), t, p.Q)
        want = jb._apply_auto_np_free(rows.astype(object), t, p.Q)
        assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_output_modulus_cannot_exceed_q_ks(flows):
    name, _, p = flows
    ctx = p["ctx"]
    acc = torch.zeros((2, 1, ctx.params.N), dtype=torch.int64)
    with pytest.raises(AssertionError, match="q_ks"):
        binfhe._extract_and_keyswitch_offset(ctx, p["bk"], acc, 0,
                                             out_mod=2 * ctx.params.q_ks)


def test_std128_reference_results():
    """chip_smoke.py phase 18 runs the large-precision functions at STD128
    on the card and holds the port's decryptions to LP_REFERENCE: these are
    the JAX package's for the same seed and draws (its side jitted, about
    half a minute on a CPU)."""
    import chip_smoke
    _, _, dec, misses = chip_smoke.lp_flow(
        jb, jb.gen_context("STD128"), chip_smoke.LP_SEED, chip_smoke.untimed)
    assert dec == chip_smoke.LP_REFERENCE["STD128"], (dec, misses)
