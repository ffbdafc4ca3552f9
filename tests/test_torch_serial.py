"""The port's ``utils/serial.py`` against the JAX package's archive format.

Every kind the port supports (the three contexts, the three ciphertexts,
PublicKey, SecretKey and KSKey, and BINFHE's context, LWE ciphertext, secret,
bootstrap key and LMKCDEY key) goes both ways in both flavours: written by
``openfhe_tpu.utils.serial.save`` and read by the port's ``load``, and
written by the port's ``save`` and read by the JAX package's ``load``; each
loaded object must equal the original through ``convert``. The JSON
archives of the two packages are the same bytes, and the binary ones hold
the same arrays and metadata. The objects are made by the port on the CPU
and handed to the JAX package's constructors as uint32 planes, so no JAX
arithmetic runs. ``load`` without a device raises where there is no CUDA
device.
"""

import json

import numpy as np
import pytest
import torch

from openfhe_tpu import dcrt as jdcrt
from openfhe_tpu import keyswitch as jks
from openfhe_tpu.models import bfv as jbfv
from openfhe_tpu.models import bgv as jbgv
from openfhe_tpu.models import binfhe as jbinfhe
from openfhe_tpu.models import ckks as jckks
from openfhe_tpu.utils import serial as jserial
from openfhe_tpu_torch import convert, dcrt
from openfhe_tpu_torch.models import bfv, bgv, binfhe, ckks
from openfhe_tpu_torch.utils import serial

FORMATS = ["binary", "json"]
KINDS = ["ckks_context", "ckks_composite_context", "bgv_context",
         "bfv_context", "ckks_ciphertext", "bgv_ciphertext",
         "bfv_ciphertext", "public_key", "secret_key", "ks_key",
         "binfhe_context", "lwe_ciphertext", "binfhe_secret",
         "binfhe_bootstrap_key", "binfhe_lmkcdey_key"]
CKKS = dict(ring_dim=64, mult_depth=2, scaling_mod_size=40,
            first_mod_size=50, dnum=2)
BGV = dict(ring_dim=64, mult_depth=1, plaintext_modulus=12289, mod_size=50,
           dnum=2)
BFV = dict(ring_dim=64, plaintext_modulus=12289, num_towers=2, mod_size=50,
           dnum=2)


def _jax_poly(p: dcrt.RnsPoly):
    lo, hi = convert.poly_to_numpy(p)
    return jdcrt.RnsPoly(lo, hi, jdcrt.RnsBasis(p.basis.n, p.basis.moduli),
                         jdcrt.Format(p.fmt.value))


@pytest.fixture(scope="module")
def objects():
    """kind -> (the port's object, the same object in the JAX package)."""
    rng = np.random.default_rng(777)
    out = {}
    ctx = ckks.gen_context(ckks.CKKSParams(**CKKS), "cpu")
    out["ckks_context"] = (ctx, jckks.gen_context(jckks.CKKSParams(**CKKS)))
    comp = dict(CKKS, scaling_mod_size=50, composite_degree=2)
    out["ckks_composite_context"] = (
        ckks.gen_context(ckks.CKKSParams(**comp), "cpu"),
        jckks.gen_context(jckks.CKKSParams(**comp)))
    bctx = bgv.gen_context(bgv.BGVParams(**BGV), "cpu")
    out["bgv_context"] = (bctx, jbgv.gen_context(jbgv.BGVParams(**BGV)))
    fctx = bfv.gen_context(bfv.BFVParams(**BFV), "cpu")
    out["bfv_context"] = (fctx, jbfv.gen_context(jbfv.BFVParams(**BFV)))

    pk, sk = ckks.keygen(ctx, rng)
    evk = ckks.relin_keygen(ctx, sk, rng)
    ct = ckks.eval_mult(ckks.encrypt(ctx, pk, rng.normal(size=4), rng),
                        ckks.encrypt(ctx, pk, rng.normal(size=4), rng))
    out["ckks_ciphertext"] = (ct, jckks.Ciphertext(
        tuple(_jax_poly(p) for p in ct.polys), ct.scale))
    out["public_key"] = (pk, jckks.PublicKey(_jax_poly(pk.b),
                                             _jax_poly(pk.a)))
    out["secret_key"] = (sk, jckks.SecretKey(sk.coeffs.copy()))
    kp = evk.params
    out["ks_key"] = (evk, jks.KSKey(*convert.kskey_to_numpy(evk),
                                    jks.KSParams(kp.n, kp.q_moduli,
                                                 kp.p_moduli, kp.alpha,
                                                 kp.plaintext_correction)))
    bpk, bsk = bgv.keygen(bctx, rng)
    bct = bgv.encrypt(bctx, bpk, [1, 2, 3], rng)
    out["bgv_ciphertext"] = (bct, jbgv.Ciphertext(
        tuple(_jax_poly(p) for p in bct.polys)))
    fpk, fsk = bfv.keygen(fctx, rng)
    fct = bfv.eval_mult(fctx, bfv.encrypt(fctx, fpk, [4, 5], rng),
                        bfv.encrypt(fctx, fpk, [6, 7], rng))
    assert fct.noise_deg == 2
    out["bfv_ciphertext"] = (fct, jbfv.Ciphertext(
        tuple(_jax_poly(p) for p in fct.polys), noise_deg=fct.noise_deg))
    out["secrets"] = (sk, bsk, fsk)

    lctx = binfhe.gen_context("TOY", "cpu")
    out["binfhe_context"] = (lctx, jbinfhe.gen_context("TOY"))
    lsk = binfhe.keygen(lctx, rng)
    out["binfhe_secret"] = (lsk, jbinfhe.BinFHESecret(
        *convert.binfhe_secret_to_numpy(lsk)))
    lct = binfhe.encrypt(lctx, lsk, 1, rng)
    out["lwe_ciphertext"] = (lct, jbinfhe.LWECiphertext(
        *convert.lwe_ciphertext_to_numpy(lct)))
    lbk = binfhe.bootstrap_keygen(lctx, lsk, rng)
    out["binfhe_bootstrap_key"] = (lbk, jbinfhe.BootstrapKey(
        *convert.bootstrap_key_to_numpy(lbk)))
    mctx = binfhe.gen_context("TOY_LMKCDEY", "cpu")
    mbk = binfhe.bootstrap_keygen(mctx, binfhe.keygen(mctx, rng), rng)
    out["binfhe_lmkcdey_key"] = (mbk, jbinfhe.LMKCDEYKey(
        *convert.lmkcdey_key_to_numpy(mbk)))
    return out


def _from_jax(kind, obj):
    """A JAX object (as the JAX package's load returns it) -> the port's."""
    if kind == "binfhe_context":
        return convert.binfhe_context_from_jax(obj, "cpu")
    if kind.endswith("context"):
        if kind.startswith("ckks"):
            return convert.ckks_context_from_jax(obj, "cpu")
        if kind == "bgv_context":
            return convert.bgv_context_from_jax(obj, "cpu")
        return convert.bfv_context_from_jax(obj, "cpu")
    return {"ckks_ciphertext": convert.ciphertext_from_jax,
            "bgv_ciphertext": convert.bgv_ciphertext_from_jax,
            "bfv_ciphertext": convert.bfv_ciphertext_from_jax,
            "public_key": convert.public_key_from_jax,
            "secret_key": lambda o, _: convert.secret_key_from_jax(o),
            "ks_key": convert.kskey_from_jax,
            "lwe_ciphertext": convert.lwe_ciphertext_from_jax,
            "binfhe_secret": lambda o, _: convert.binfhe_secret_from_jax(o),
            "binfhe_bootstrap_key": convert.bootstrap_key_from_jax,
            "binfhe_lmkcdey_key": convert.lmkcdey_key_from_jax,
            }[kind](obj, "cpu")


def _equal(kind, got, want):
    """Port objects equal; a loaded BFV ciphertext has noise degree 1, as
    the archive does not carry it."""
    assert type(got) is type(want)
    if kind.endswith("context"):
        assert got == want
    elif kind == "secret_key":
        assert np.array_equal(got.coeffs, want.coeffs)
        assert got.coeffs.dtype == np.int64
    elif kind == "public_key":
        for g, w in ((got.b, want.b), (got.a, want.a)):
            assert (g.basis, g.fmt) == (w.basis, w.fmt)
            assert torch.equal(g.data, w.data)
    elif kind == "ks_key":
        assert got.params == want.params
        assert torch.equal(got.b, want.b) and torch.equal(got.a, want.a)
    elif kind == "lwe_ciphertext":
        assert torch.equal(got.a, want.a)
        assert (got.b, got.modulus) == (want.b, want.modulus)
    elif kind == "binfhe_secret":
        for g, w in ((got.s_lwe, want.s_lwe), (got.z_ring, want.z_ring)):
            assert g.dtype == np.int64 and np.array_equal(g, w)
    elif kind == "binfhe_bootstrap_key":
        for g, w in ((got.ek, want.ek), (got.ks_a, want.ks_a),
                     (got.ks_b, want.ks_b)):
            assert torch.equal(g, w)
    elif kind == "binfhe_lmkcdey_key":
        for g, w in ((got.ek, want.ek), (got.ak, want.ak),
                     (got.ks_a, want.ks_a), (got.ks_b, want.ks_b)):
            assert torch.equal(g, w)
    else:
        assert len(got.polys) == len(want.polys)
        for g, w in zip(got.polys, want.polys):
            assert (g.basis, g.fmt) == (w.basis, w.fmt)
            assert torch.equal(g.data, w.data)
        if kind == "ckks_ciphertext":
            assert got.scale == want.scale
        if kind == "bfv_ciphertext":
            assert got.noise_deg == 1 and want.noise_deg == 2


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind", KINDS)
def test_jax_save_port_load(objects, kind, fmt, tmp_path):
    port, ref = objects[kind]
    path = tmp_path / f"{kind}.{fmt}"
    jserial.save(ref, str(path), fmt)
    _equal(kind, serial.load(path, "cpu"), port)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind", KINDS)
def test_port_save_jax_load(objects, kind, fmt, tmp_path):
    port, _ = objects[kind]
    path = tmp_path / f"{kind}.{fmt}"
    serial.save(port, path, fmt)
    _equal(kind, _from_jax(kind, jserial.load(str(path))), port)


def _npz(path):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return json.loads(bytes(arrays.pop("__meta__")).decode()), arrays


@pytest.mark.parametrize("kind", KINDS)
def test_archives_are_the_same(objects, kind, tmp_path):
    """The same JSON bytes; the same npz members, dtypes and metadata."""
    port, ref = objects[kind]
    serial.save(port, tmp_path / "port.json", "json")
    jserial.save(ref, str(tmp_path / "jax.json"), "json")
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    serial.save(port, tmp_path / "port.npz")
    jserial.save(ref, str(tmp_path / "jax.npz"))
    meta, arrays = _npz(tmp_path / "port.npz")
    jmeta, jarrays = _npz(tmp_path / "jax.npz")
    assert meta == jmeta and sorted(arrays) == sorted(jarrays)
    for name, a in arrays.items():
        assert a.dtype == jarrays[name].dtype
        assert np.array_equal(a, jarrays[name])


def test_loaded_objects_decrypt_the_same(objects, tmp_path):
    sk, bsk, fsk = objects["secrets"]
    for kind, m, key in (("ckks_ciphertext", ckks, sk),
                         ("bgv_ciphertext", bgv, bsk),
                         ("bfv_ciphertext", bfv, fsk)):
        ct = objects[kind][0]
        ctx = objects[kind.split("_")[0] + "_context"][0]
        for fmt in FORMATS:
            serial.save(ct, tmp_path / "ct", fmt)
            serial.save(key, tmp_path / "sk", fmt)
            got = m.decrypt(ctx, serial.load(tmp_path / "sk", "cpu"),
                            serial.load(tmp_path / "ct", "cpu"))
            want = m.decrypt(ctx, key, ct)
            assert np.array_equal(np.asarray(got), np.asarray(want))


def test_binfhe_archives_raise(objects, tmp_path):
    """An object the format does not know raises. The loaded LWE ciphertext
    and secret decrypt as the originals."""
    ct, sk = objects["lwe_ciphertext"][0], objects["binfhe_secret"][0]
    ctx = objects["binfhe_context"][0]
    for fmt in FORMATS:
        serial.save(ct, tmp_path / "ct", fmt)
        serial.save(sk, tmp_path / "sk", fmt)
        assert binfhe.decrypt(ctx, serial.load(tmp_path / "sk", "cpu"),
                              serial.load(tmp_path / "ct", "cpu")) == \
            binfhe.decrypt(ctx, sk, ct) == 1
    with pytest.raises(TypeError, match="don't know how to serialize"):
        serial.save(object(), tmp_path / "out.npz")


def test_load_needs_a_card_unless_asked_for_the_cpu(objects, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    path = tmp_path / "ct.npz"
    serial.save(objects["bgv_ciphertext"][0], path)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serial.load(path)
    assert serial.load(path, "cpu").polys[0].device == torch.device("cpu")
