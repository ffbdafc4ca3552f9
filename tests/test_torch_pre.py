"""The port's ``models/pre.py`` (proxy re-encryption) against the JAX
package's, bit for bit.

One flow per scheme and package from one seed: sender and receiver keys,
``rekey_gen`` (BGV with error_scale = t), an encryption under the sender's
key, ``encrypt_zero`` at the full level and two towers down, and
``re_encrypt`` in INDCPA, FIXED_NOISE_HRA and NOISE_FLOODING_HRA (BGV with
noise_scale = t; CKKS also from a ciphertext below the public key's level,
where the key is sliced), each decrypted by the receiver and by the sender.
Contexts: CKKS n = 128 (50-bit q0, two 40-bit towers), BGV and BFV n = 128
(three 55-bit towers), dnum 2. Every key, zero-encryption, re-encrypted
ciphertext (BFV's with its noise degree) and decryption is equal to the
JAX package's; ``flooding_sigma`` is compared with ``==``.

The JAX flows run jitted: cold on an 8-core CPU this file took 94 s,
and 111 s with the flows op by op (under ``jax.disable_jit()``).
"""

import numpy as np
import pytest
import torch

from openfhe_tpu.models import bfv as jbfv
from openfhe_tpu.models import bgv as jbgv
from openfhe_tpu.models import ckks as jckks
from openfhe_tpu.models import pre as jpre
from openfhe_tpu_torch import convert
from openfhe_tpu_torch.models import bfv, bgv, ckks, pre

MODES = ["INDCPA", "FIXED_NOISE_HRA", "NOISE_FLOODING_HRA"]
SCHEMES = ["ckks", "bgv", "bfv"]


def _context(m, scheme, where):
    if scheme == "ckks":
        return m.gen_context(m.CKKSParams(ring_dim=128, mult_depth=2,
                                          scaling_mod_size=40,
                                          first_mod_size=50, dnum=2), *where)
    if scheme == "bgv":
        return m.gen_context(m.BGVParams(ring_dim=128, mult_depth=2,
                                         mod_size=55, dnum=2), *where)
    return m.gen_context(m.BFVParams(ring_dim=128, num_towers=3, mod_size=55,
                                     dnum=2), *where)


def _flow(m, pre_, scheme, where):
    ctx = _context(m, scheme, where)
    rng = np.random.default_rng({"ckks": 8, "bgv": 18, "bfv": 28}[scheme])
    scale = ctx.t if scheme == "bgv" else 1
    out = {}
    pk_a, sk_a = m.keygen(ctx, rng)
    pk_b, sk_b = m.keygen(ctx, rng)
    out.update(pk_from=pk_a, sk_from=sk_a, pk_to=pk_b, sk_to=sk_b)
    rk = out["rekey"] = pre_.rekey_gen(ctx, sk_a, sk_b, rng,
                                       error_scale=scale)
    if scheme == "ckks":
        v = rng.normal(size=8)
    else:
        v = [int(x) for x in rng.integers(0, ctx.t, size=8)]
    ct = out["ct"] = m.encrypt(ctx, pk_a, v, rng)
    basis = ct.polys[0].basis
    out["zero_full"] = pre_.encrypt_zero(ctx, pk_a, basis, rng,
                                         error_scale=scale)
    low = basis.drop_last(2)
    out["zero_low"] = pre_.encrypt_zero(ctx, pk_a, low, rng,
                                        error_scale=scale)
    cts = {mode: pre_.re_encrypt(ct, rk, ctx=ctx, pk=pk_a, mode=mode,
                                 rng=rng, noise_scale=scale)
           for mode in MODES}
    if scheme == "ckks":
        cts["FIXED_NOISE_HRA_low"] = pre_.re_encrypt(
            m.level_reduce(ct, 1), rk, ctx=ctx, pk=pk_a,
            mode="FIXED_NOISE_HRA", rng=rng)
    for mode, c in cts.items():
        out[f"re_{mode}"] = c
        out[f"re_{mode}_to_slots"] = m.decrypt(ctx, sk_b, c, num_slots=8)
        out[f"re_{mode}_from_slots"] = m.decrypt(ctx, sk_a, c, num_slots=8)
    out["sigma"] = [pre_.flooding_sigma(ctx, mode) for mode in MODES] + [
        pre_.flooding_sigma(ctx, "NOISE_FLOODING_HRA", num_queries=4,
                            stat_security=40, threshold_parties=3)]
    return v, out


@pytest.fixture(scope="module", params=SCHEMES)
def flows(request):
    scheme = request.param
    jm = {"ckks": jckks, "bgv": jbgv, "bfv": jbfv}[scheme]
    m = {"ckks": ckks, "bgv": bgv, "bfv": bfv}[scheme]
    _, jout = _flow(jm, jpre, scheme, ())
    v, out = _flow(m, pre, scheme, ("cpu",))
    return scheme, v, jout, out


def _poly_equal(port, ref):
    want = convert.poly_from_jax(ref, "cpu")
    assert (want.basis, want.fmt) == (port.basis, port.fmt)
    assert torch.equal(want.data, port.data)


def _assert_same(port, ref):
    name = type(ref).__name__
    if name == "KSKey":
        want = convert.kskey_from_jax(ref, "cpu")
        assert want.params == port.params
        assert torch.equal(want.b, port.b) and torch.equal(want.a, port.a)
    elif name == "PublicKey":
        _poly_equal(port.b, ref.b)
        _poly_equal(port.a, ref.a)
    elif name == "SecretKey":
        assert np.array_equal(port.coeffs, np.asarray(ref.coeffs))
    elif name == "Ciphertext":
        assert type(port).__module__.rsplit(".", 1)[1] == \
            type(ref).__module__.rsplit(".", 1)[1]
        for attr in ("scale", "noise_deg"):
            assert getattr(port, attr, None) == getattr(ref, attr, None)
        assert len(port.polys) == len(ref.polys)
        for p, r in zip(port.polys, ref.polys):
            _poly_equal(p, r)
    elif isinstance(ref, tuple):
        for p, r in zip(port, ref, strict=True):
            _poly_equal(p, r)
    elif isinstance(ref, list) and ref and isinstance(ref[0], float):
        assert port == ref            # flooding sigmas: the same floats
    else:
        assert np.array_equal(np.asarray(port), np.asarray(ref))


NAMES = ["pk_from", "sk_from", "pk_to", "sk_to", "rekey", "ct", "zero_full",
         "zero_low", "sigma"] + [f"re_{m}{s}" for m in MODES
                                 for s in ("", "_to_slots", "_from_slots")]


@pytest.mark.parametrize("name", NAMES)
def test_state_equal(flows, name):
    _, _, jout, out = flows
    _assert_same(out[name], jout[name])


def test_ckks_below_the_key_level(flows):
    scheme, _, jout, out = flows
    if scheme != "ckks":
        assert "re_FIXED_NOISE_HRA_low" not in out
        return
    for s in ("", "_to_slots", "_from_slots"):
        name = f"re_FIXED_NOISE_HRA_low{s}"
        _assert_same(out[name], jout[name])
    assert out["re_FIXED_NOISE_HRA_low"].polys[0].basis.L == 2


def test_receiver_decrypts_sender_does_not(flows):
    scheme, v, _, out = flows
    assert out["zero_low"][0].basis.L == out["zero_full"][0].basis.L - 2
    assert out["sigma"][:2] == [0.0, float(pre.PRE_SD)]
    assert out["sigma"][2] > pre.PRE_SD
    for mode in MODES:
        got = out[f"re_{mode}_to_slots"]
        wrong = out[f"re_{mode}_from_slots"]
        if scheme == "ckks":
            if mode != "NOISE_FLOODING_HRA":   # its flood swamps a 2^40 scale
                assert np.max(np.abs(got - v)) < 1e-3
            assert np.max(np.abs(wrong - v)) > 1e-2
        else:
            assert list(got) == v and list(wrong) != v
            if scheme == "bfv":
                assert out[f"re_{mode}"].noise_deg == 1
