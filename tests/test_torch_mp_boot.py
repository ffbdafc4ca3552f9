"""The port's interactive multiparty CKKS bootstrap against the JAX
package's, bit for bit.

One flow per package from one seed at ``tests/test_mp_boot.py``'s
configuration (n = 256, 60-bit q0, three 40-bit towers, dnum 2): a
three-party joint key, encryption, two plaintext products with rescales
down to two towers, then the one-round bootstrap
(``int_mp_boot_adjust_scale``, ``int_mp_boot_random_element_gen``, each
party's ``int_mp_boot_decrypt``, ``int_mp_boot_add``,
``int_mp_boot_encrypt``), a distributed decryption of the fresh ciphertext
and of one more plaintext product at full level. Every ciphertext, the
common `a`, each party's (h0, h1), the aggregate and every partial
decryption are ``torch.equal`` to the JAX package's, the slots
``np.array_equal``. A second test feeds the lead's final step phases near
±q'/2, where a positive lift would wrap, and holds the centered lift to
the JAX package's and to Python integers.

The JAX flow runs jitted: cold on an 8-core CPU this file took 28 s,
and 61 s with the flow op by op (under ``jax.disable_jit()``).
"""

import numpy as np
import pytest
import torch

from openfhe_tpu import dcrt as jdcrt
from openfhe_tpu.models import ckks as jckks
from openfhe_tpu.models import multiparty as jmp
from openfhe_tpu_torch import convert, dcrt
from openfhe_tpu_torch.models import ckks, multiparty as mp

PARAMS = dict(ring_dim=256, mult_depth=3, scaling_mod_size=40,
              first_mod_size=60, dnum=2)
VALUES = np.array([0.25, -1.5, 2.0, 0.125])


def _flow(ckks_, mp_, where):
    ctx = ckks_.gen_context(ckks_.CKKSParams(**PARAMS), *where)
    rng = np.random.default_rng(2024)
    out = {}
    pk, sk = mp_.keygen_lead(ctx, rng)
    sks = [sk]
    for _ in range(2):
        pk, sk = mp_.keygen_join(ctx, pk, rng)
        sks.append(sk)
    out["pk"] = pk

    def dist(name, ct):
        parts = [mp_.decrypt_lead(ctx, sks[0], ct, rng)]
        parts += [mp_.decrypt_main(ctx, s, ct, rng) for s in sks[1:]]
        for i, p in enumerate(parts, 1):
            out[f"{name}_partial_{i}"] = p
        out[f"{name}_slots"] = mp_.combine(ctx, ct, parts, 4)

    ct = out["ct"] = ckks_.encrypt(ctx, pk, VALUES, rng)
    out["adjusted_fresh"] = mp_.int_mp_boot_adjust_scale(ctx, ct)
    dist("adjusted_fresh", out["adjusted_fresh"])
    for i in (1, 2):
        ct = out[f"burn_{i}"] = ckks_.rescale(
            ckks_.eval_mult_plain(ctx, ct, np.ones(4)))
    small = out["small"] = mp_.int_mp_boot_adjust_scale(ctx, ct)
    a = out["a"] = mp_.int_mp_boot_random_element_gen(ctx, rng)
    shares = [mp_.int_mp_boot_decrypt(ctx, s, small, a, rng) for s in sks]
    for i, (h0, h1) in enumerate(shares, 1):
        out[f"h0_{i}"], out[f"h1_{i}"] = h0, h1
    out["pairs"] = shares
    out["agg_h0"], out["agg_h1"] = agg = mp_.int_mp_boot_add(shares)
    fresh = out["fresh"] = mp_.int_mp_boot_encrypt(ctx, agg, a, small)
    dist("fresh", fresh)
    sq = out["square"] = ckks_.rescale(ckks_.eval_mult_plain(ctx, fresh,
                                                             VALUES))
    dist("square", sq)
    return ctx, out


@pytest.fixture(scope="module")
def flows():
    jctx, jout = _flow(jckks, jmp, ())
    ctx, out = _flow(ckks, mp, ("cpu",))
    return jctx, jout, ctx, out


def assert_same(port, ref):
    name = type(ref).__name__
    if name == "RnsPoly":
        want = convert.poly_from_jax(ref, "cpu")
        assert (want.basis, want.fmt) == (port.basis, port.fmt)
        assert torch.equal(want.data, port.data)
    elif name == "Ciphertext":
        want = convert.ciphertext_from_jax(ref, "cpu")
        assert want.scale == port.scale
        assert len(want.polys) == len(port.polys)
        for w, p in zip(want.polys, port.polys):
            assert w.basis == p.basis and torch.equal(w.data, p.data)
    elif name == "PublicKey":
        assert_same(port.b, ref.b)
        assert_same(port.a, ref.a)
    else:
        assert np.array_equal(np.asarray(port), np.asarray(ref))


NAMES = (["pk", "ct", "adjusted_fresh", "burn_1", "burn_2", "small", "a"]
         + [f"h{k}_{i}" for i in (1, 2, 3) for k in (0, 1)]
         + ["agg_h0", "agg_h1", "fresh", "square"]
         + [f"{c}_{s}" for c in ("adjusted_fresh", "fresh", "square")
            for s in ("partial_1", "partial_2", "partial_3", "slots")])


@pytest.mark.parametrize("name", NAMES)
def test_state_equal(flows, name):
    _, jout, _, out = flows
    assert set(out) == set(NAMES) | {"pairs"}
    assert_same(out[name], jout[name])


def test_share_pairs_cross_whole(flows):
    """The parties' (h0, h1) pairs, carried over by convert, aggregate and
    finish to the port's own fresh ciphertext."""
    _, jout, ctx, out = flows
    pairs = [(convert.poly_from_jax(h0, "cpu"),
              convert.poly_from_jax(h1, "cpu")) for h0, h1 in jout["pairs"]]
    assert len(pairs) == 3
    for (h0, h1), (p0, p1) in zip(pairs, out["pairs"]):
        assert torch.equal(h0.data, p0.data) and torch.equal(h1.data, p1.data)
    fresh = mp.int_mp_boot_encrypt(ctx, mp.int_mp_boot_add(pairs), out["a"],
                                   out["small"])
    assert all(torch.equal(f.data, g.data)
               for f, g in zip(fresh.polys, out["fresh"].polys))


def test_towers_and_slots(flows):
    """The port's own results, as tests/test_mp_boot.py checks the JAX
    package's."""
    _, _, ctx, out = flows
    assert out["adjusted_fresh"].towers == out["small"].towers == 2
    assert out["burn_2"].towers == 2
    assert out["fresh"].towers == ctx.basis().L
    assert out["fresh"].scale == out["small"].scale
    assert np.allclose(out["adjusted_fresh_slots"].real, VALUES, atol=1e-3)
    assert np.allclose(out["fresh_slots"].real, VALUES, atol=2e-3)
    assert np.allclose(out["square_slots"].real, VALUES * VALUES, atol=5e-3)


def test_centered_lift_near_half(flows):
    """Coefficients of c0 + h0 near +-q'/2 (h1 = 0): the final step's lift,
    equal in both packages. It is the centered representative, except where
    the shifted value x + floor(q'/2) mod q' is a small nonzero integer:
    there the 128-bit fixed-point overflow count of the exact basis switch
    (``rns.exact_switch_basis``, floor) comes out one low in both packages
    and the lift lands q' higher. A real phase m - M is far from +-q'/2."""
    jctx, _, ctx, out = flows
    small = out["small"].basis
    moduli = small.moduli
    qp = int(np.prod([int(q) for q in moduli], dtype=object))
    half = qp // 2
    n = ctx.n
    offsets = [-3, -2, -1, 0, 1, 2, 3]
    picks = [half + d for d in offsets] + [qp - half + d for d in offsets] \
        + [0, 1, qp - 1, qp // 3, half - 10 ** 6, qp - half + 10 ** 15]
    vals = (picks * n)[:n]
    rows = [[v % q for v in vals] for q in moduli]
    zero_rows = [[0] * n for _ in moduli]
    full = ctx.basis()
    full_zero = [[0] * n for _ in full.moduli]

    def port_lift():
        c0 = dcrt.to_eval(dcrt.from_int_rows(small, rows, dcrt.Format.COEFF,
                                             "cpu"))
        z = dcrt.from_int_rows(small, zero_rows, dcrt.Format.EVAL, "cpu")
        h1 = dcrt.from_int_rows(full, full_zero, dcrt.Format.EVAL, "cpu")
        ct = ckks.Ciphertext((c0, z), 1.0)
        res = mp.int_mp_boot_encrypt(ctx, (z, h1), h1, ct)
        return dcrt.to_int_rows(dcrt.to_coeff(res.polys[0]))

    def jax_lift():
        jsmall = jdcrt.RnsBasis(n, moduli)
        jfull = jctx.basis()
        c0 = jdcrt.to_eval(jdcrt.from_int_rows(jsmall, rows,
                                               jdcrt.Format.COEFF))
        z = jdcrt.from_int_rows(jsmall, zero_rows, jdcrt.Format.EVAL)
        h1 = jdcrt.from_int_rows(jfull, full_zero, jdcrt.Format.EVAL)
        ct = jckks.Ciphertext((c0, z), 1.0)
        res = jmp.int_mp_boot_encrypt(jctx, (z, h1), h1, ct)
        return convert.poly_from_jax(jdcrt.to_coeff(res.polys[0]),
                                     "cpu").data.numpy()

    got = port_lift()
    want = jax_lift()
    assert np.array_equal(got, want)
    for i, v in enumerate(vals[:len(picks)]):
        centered = v - qp if v >= qp - half else v
        assert -half <= centered < qp - half
        lifted = ckks.crt_interpolate_centered(got[:, i:i + 1],
                                               full.moduli)[0]
        shifted = (v + half) % qp
        if shifted == 0 or shifted >= 1 << 40:
            assert lifted == centered, (v - half, lifted - centered)
        else:
            # exact_switch_basis's floor count may be one low here (ROADMAP
            # Queue 3), in both packages alike
            assert lifted in (centered, centered + qp)
