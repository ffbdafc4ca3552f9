"""Archives of contexts, keys and ciphertexts of the RNS schemes and BINFHE.

The port's copy of ``openfhe_tpu/utils/serial.py`` and of its format, so
that a file written by either package loads in the other (role of the
reference's cereal ``Serial::Serialize``/``Deserialize``, ``utils/serial.h``,
in both of its SerType flavours):

* ``fmt="binary"`` (default): one ``.npz`` holding the arrays and a
  ``__meta__`` entry, the metadata as JSON bytes;
* ``fmt="json"``: one JSON document, ``{"__meta__": ..., "arrays": ...}``,
  each array a base64 ``.npy``.

A 64-bit residue tensor is stored as the JAX package stores it, as two
``uint32`` planes ``<name>.lo``/``<name>.hi`` (``b_lo``, ``b_hi``, ``a_lo``,
``a_hi`` for a switching key). Contexts store their params and moduli.
``load`` detects the flavour from the first byte and places tensors on
``device`` (None: the current CUDA device, raising without one).

Like the JAX package, ``load`` builds a BFV ciphertext with the default
noise degree 1: the archive does not carry it. A BINFHE bootstrap key is
stored in the JAX package's layout and dtypes (``ek_lo``/``ek_hi`` uint32
planes of ``[T, V, 2dg, 2, N]``, ``ks_a``/``ks_b`` int32; an LMKCDEY key's
``ek`` of ``[n, 2dg, 2, N]`` and ``ak_lo``/``ak_hi`` of ``[2, dg, 2, N]``),
whatever layout the port keeps it in.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
from typing import Any

import numpy as np
import torch

from .. import _build, dcrt, keyswitch
from ..convert import (bootstrap_key_from_arrays, bootstrap_key_to_numpy,
                       lmkcdey_key_from_arrays, lmkcdey_key_to_numpy,
                       tensor_to_u64, u64_to_tensor)
from ..models import bfv, bgv, binfhe, ckks

SERIAL_VERSION = 1
_LMKCDEY_ARRAYS = ("ek_lo", "ek_hi", "ak_lo", "ak_hi", "ks_a", "ks_b")


def _array_to_json(a: np.ndarray) -> dict:
    buf = io.BytesIO()
    np.save(buf, np.asarray(a), allow_pickle=False)
    return {"npy_b64": base64.b64encode(buf.getvalue()).decode()}


def _array_from_json(d: dict) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(d["npy_b64"])),
                   allow_pickle=False)


def _poly_arrays(prefix: str, p, arrays: dict) -> dict:
    arrays[f"{prefix}.lo"], arrays[f"{prefix}.hi"] = tensor_to_u64(p.data)
    return {"basis_n": p.basis.n, "basis_moduli": _moduli(p.basis.moduli),
            "fmt": p.fmt.value}


def _poly_restore(prefix: str, meta, arrays, device):
    basis = dcrt.RnsBasis(meta["basis_n"],
                          tuple(int(q) for q in meta["basis_moduli"]))
    return dcrt.RnsPoly(u64_to_tensor(arrays[f"{prefix}.lo"],
                                      arrays[f"{prefix}.hi"], device),
                        basis, dcrt.Format(meta["fmt"]))


def _moduli(ms) -> list:
    return [str(q) for q in ms]


def save(obj: Any, path, fmt: str = "binary") -> None:
    """Write `obj` (a context, ciphertext, PublicKey, SecretKey or KSKey of
    the port, or a BINFHE context, LWE ciphertext, secret, bootstrap key or
    LMKCDEY key)
    to `path` in the JAX package's archive format."""
    assert fmt in ("binary", "json"), fmt
    arrays: dict = {}
    meta: dict = {"version": SERIAL_VERSION}
    t = type(obj).__name__
    mod = type(obj).__module__

    if t in ("CKKSContext", "BGVContext"):
        meta.update(kind="ckks_context" if t == "CKKSContext"
                    else "bgv_context",
                    params=dataclasses.asdict(obj.params),
                    q_moduli=_moduli(obj.q_moduli),
                    p_moduli=_moduli(obj.p_moduli))
    elif t == "BFVContext":
        meta.update(kind="bfv_context", params=dataclasses.asdict(obj.params),
                    q_moduli=_moduli(obj.q_moduli),
                    r_moduli=_moduli(obj.r_moduli),
                    p_moduli=_moduli(obj.p_moduli))
    elif t == "Ciphertext" and "ckks" in mod:
        meta.update(kind="ckks_ciphertext", scale=obj.scale,
                    polys=[_poly_arrays(f"poly{i}", p, arrays)
                           for i, p in enumerate(obj.polys)])
    elif t == "Ciphertext":
        kind = "bgv_ciphertext" if "bgv" in mod else "bfv_ciphertext"
        meta.update(kind=kind,
                    polys=[_poly_arrays(f"poly{i}", p, arrays)
                           for i, p in enumerate(obj.polys)])
    elif t == "PublicKey":
        meta.update(kind="public_key",
                    b=_poly_arrays("b", obj.b, arrays),
                    a=_poly_arrays("a", obj.a, arrays))
    elif t == "SecretKey":
        meta.update(kind="secret_key")
        arrays["coeffs"] = np.asarray(obj.coeffs, dtype=np.int64)
    elif t == "KSKey":
        p = obj.params
        meta.update(kind="ks_key",
                    ks_params={"n": p.n, "q_moduli": _moduli(p.q_moduli),
                               "p_moduli": _moduli(p.p_moduli),
                               "alpha": p.alpha,
                               "plaintext_correction": p.plaintext_correction})
        arrays["b_lo"], arrays["b_hi"] = tensor_to_u64(obj.b)
        arrays["a_lo"], arrays["a_hi"] = tensor_to_u64(obj.a)
    elif t == "BinFHEContext":
        meta.update(kind="binfhe_context",
                    params=dataclasses.asdict(obj.params))
    elif t == "LWECiphertext":
        meta.update(kind="lwe_ciphertext", b=int(obj.b),
                    modulus=int(obj.modulus))
        arrays["a"] = obj.a.cpu().numpy().astype(np.int64)
    elif t == "BinFHESecret":
        meta.update(kind="binfhe_secret")
        arrays["s_lwe"] = np.asarray(obj.s_lwe, dtype=np.int64)
        arrays["z_ring"] = np.asarray(obj.z_ring, dtype=np.int64)
    elif t == "BootstrapKey":
        meta.update(kind="binfhe_bootstrap_key")
        arrays.update(zip(("ek_lo", "ek_hi", "ks_a", "ks_b"),
                          bootstrap_key_to_numpy(obj)))
    elif t == "LMKCDEYKey":
        meta.update(kind="binfhe_lmkcdey_key")
        arrays.update(zip(_LMKCDEY_ARRAYS, lmkcdey_key_to_numpy(obj)))
    else:
        raise TypeError(f"don't know how to serialize {mod}.{t}")

    if fmt == "json":
        doc = {"__meta__": meta,
               "arrays": {k: _array_to_json(v) for k, v in arrays.items()}}
        with open(path, "w") as f:
            json.dump(doc, f)
        return
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load(path, device=None) -> Any:
    """Read an archive written by either package; tensors go to `device`
    (None: the current CUDA device)."""
    with open(path, "rb") as f:
        magic = f.read(1)
    if magic == b"{":  # JSON flavour
        with open(path) as f:
            doc = json.load(f)
        meta = doc["__meta__"]
        arrays = {k: _array_from_json(v) for k, v in doc["arrays"].items()}
    else:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        meta = json.loads(bytes(arrays.pop("__meta__")).decode())
    assert meta["version"] <= SERIAL_VERSION, "newer serial format"
    kind = meta["kind"]
    device = _build.resolve_device(device)
    if kind in ("ckks_context", "bgv_context"):
        ctx_type, params_type = (
            (ckks.CKKSContext, ckks.CKKSParams) if kind == "ckks_context"
            else (bgv.BGVContext, bgv.BGVParams))
        return ctx_type(params_type(**meta["params"]),
                        tuple(int(q) for q in meta["q_moduli"]),
                        tuple(int(p) for p in meta["p_moduli"]), device)
    if kind == "bfv_context":
        return bfv.BFVContext(bfv.BFVParams(**meta["params"]),
                              tuple(int(q) for q in meta["q_moduli"]),
                              tuple(int(r) for r in meta["r_moduli"]),
                              tuple(int(p) for p in meta["p_moduli"]),
                              device)
    if kind in ("ckks_ciphertext", "bgv_ciphertext", "bfv_ciphertext"):
        polys = tuple(_poly_restore(f"poly{i}", pm, arrays, device)
                      for i, pm in enumerate(meta["polys"]))
        if kind == "ckks_ciphertext":
            return ckks.Ciphertext(polys, meta["scale"])
        return (bgv if kind == "bgv_ciphertext" else bfv).Ciphertext(polys)
    if kind == "public_key":
        return ckks.PublicKey(_poly_restore("b", meta["b"], arrays, device),
                              _poly_restore("a", meta["a"], arrays, device))
    if kind == "secret_key":
        return ckks.SecretKey(np.asarray(arrays["coeffs"], dtype=np.int64))
    if kind == "ks_key":
        kp = meta["ks_params"]
        params = keyswitch.KSParams(
            kp["n"], tuple(int(q) for q in kp["q_moduli"]),
            tuple(int(p) for p in kp["p_moduli"]), kp["alpha"],
            kp.get("plaintext_correction", 1))
        return keyswitch.KSKey(
            u64_to_tensor(arrays["b_lo"], arrays["b_hi"], device),
            u64_to_tensor(arrays["a_lo"], arrays["a_hi"], device), params)
    if kind == "binfhe_context":
        return binfhe.BinFHEContext(binfhe.BinFHEParams(**meta["params"]),
                                    device)
    if kind == "lwe_ciphertext":
        return binfhe.LWECiphertext(
            torch.from_numpy(np.asarray(arrays["a"], dtype=np.int64)).to(
                device), int(meta["b"]), int(meta["modulus"]))
    if kind == "binfhe_secret":
        return binfhe.BinFHESecret(np.asarray(arrays["s_lwe"], np.int64),
                                   np.asarray(arrays["z_ring"], np.int64))
    if kind == "binfhe_bootstrap_key":
        return bootstrap_key_from_arrays(arrays["ek_lo"], arrays["ek_hi"],
                                         arrays["ks_a"], arrays["ks_b"],
                                         device)
    if kind == "binfhe_lmkcdey_key":
        return lmkcdey_key_from_arrays(*(arrays[k] for k in _LMKCDEY_ARRAYS),
                                       device)
    raise TypeError(f"unknown serialized kind {kind}")
