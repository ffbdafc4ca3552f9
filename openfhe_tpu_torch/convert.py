"""Carry state between the JAX package and the port.

The JAX package stores a 64-bit residue as two uint32 planes (lo, hi); the
port stores one int64. The ``*_from_jax`` functions take the JAX package's
objects (read through their array attributes with ``numpy.asarray``, so this
module never imports jax) and return the port's objects; the ``*_to_numpy``
functions return numpy arrays in the JAX package's field layout, ready for
its constructors. Like every entry point of the port, the ``*_from_jax``
functions place tensors on the current CUDA device unless the caller passes
``device`` (``"cpu"`` in the CPU tests).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _build, dcrt, keyswitch
from .models import (bfv, bgv, binfhe, ckks, ckks_bootstrap, scheme_switch,
                     trapdoor)


def u64_to_tensor(lo, hi, device=None) -> torch.Tensor:
    """uint32 lo/hi planes -> int64 tensor lo | hi << 32 on `device`
    (None: the current CUDA device)."""
    lo = np.asarray(lo).astype(np.int64)
    hi = np.asarray(hi).astype(np.int64)
    return torch.from_numpy(lo | (hi << 32)).to(
        _build.resolve_device(device))


def tensor_to_u64(t: torch.Tensor):
    """int64 tensor -> (lo, hi) uint32 numpy planes."""
    v = t.detach().cpu().numpy().view(np.uint64)
    return ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (v >> np.uint64(32)).astype(np.uint32))


def poly_from_jax(p, device=None) -> dcrt.RnsPoly:
    """JAX RnsPoly -> port RnsPoly."""
    return dcrt.RnsPoly(u64_to_tensor(p.lo, p.hi, device),
                        dcrt.RnsBasis(p.basis.n, p.basis.moduli),
                        dcrt.Format(p.fmt.value))


def poly_to_numpy(p: dcrt.RnsPoly):
    """Port RnsPoly -> (lo, hi) for the JAX RnsPoly(lo, hi, basis, fmt)."""
    return tensor_to_u64(p.data)


def ks_params_from_jax(p) -> keyswitch.KSParams:
    return keyswitch.KSParams(p.n, tuple(p.q_moduli), tuple(p.p_moduli),
                              p.alpha, p.plaintext_correction)


def kskey_from_jax(k, device=None) -> keyswitch.KSKey:
    return keyswitch.KSKey(u64_to_tensor(k.b_lo, k.b_hi, device),
                           u64_to_tensor(k.a_lo, k.a_hi, device),
                           ks_params_from_jax(k.params))


def kskey_to_numpy(k: keyswitch.KSKey):
    """-> (b_lo, b_hi, a_lo, a_hi) for the JAX KSKey."""
    return tensor_to_u64(k.b) + tensor_to_u64(k.a)


def public_key_from_jax(pk, device=None) -> ckks.PublicKey:
    return ckks.PublicKey(poly_from_jax(pk.b, device),
                          poly_from_jax(pk.a, device))


def public_key_to_numpy(pk: ckks.PublicKey):
    """-> ((b_lo, b_hi), (a_lo, a_hi))."""
    return poly_to_numpy(pk.b), poly_to_numpy(pk.a)


def secret_key_from_jax(sk) -> ckks.SecretKey:
    return ckks.SecretKey(np.asarray(sk.coeffs, dtype=np.int64).copy())


def secret_key_to_numpy(sk: ckks.SecretKey) -> np.ndarray:
    return sk.coeffs.copy()


def ciphertext_from_jax(ct, device=None) -> ckks.Ciphertext:
    return ckks.Ciphertext(tuple(poly_from_jax(p, device) for p in ct.polys),
                           float(ct.scale))


def ciphertext_to_numpy(ct: ckks.Ciphertext):
    """-> ([(lo, hi) per poly], scale)."""
    return [poly_to_numpy(p) for p in ct.polys], ct.scale


def bootstrap_keys_from_jax(keys, device=None
                            ) -> ckks_bootstrap.BootstrapKeys:
    """JAX BootstrapKeys -> port BootstrapKeys on `device`."""
    return ckks_bootstrap.BootstrapKeys(
        kskey_from_jax(keys.evk, device), kskey_from_jax(keys.conj, device),
        {int(r): kskey_from_jax(k, device) for r, k in keys.rot.items()})


def bootstrap_keys_to_numpy(keys: ckks_bootstrap.BootstrapKeys):
    """-> (evk planes, conj planes, {rotation: planes}), each as
    ``kskey_to_numpy`` gives them."""
    return (kskey_to_numpy(keys.evk), kskey_to_numpy(keys.conj),
            {r: kskey_to_numpy(k) for r, k in keys.rot.items()})


_PRECOMP_FIELDS = ("slots", "K", "r", "cheb_coeffs", "A_half", "D",
                   "level_budget", "cts", "stc")


def bootstrap_precomp_from_jax(pre) -> ckks_bootstrap.BootstrapPrecomp:
    """JAX BootstrapPrecomp -> the port's; its arrays are host numpy on both
    sides and are carried as they are."""
    return ckks_bootstrap.BootstrapPrecomp(
        **{f: getattr(pre, f) for f in _PRECOMP_FIELDS})


def bootstrap_precomp_to_numpy(pre: ckks_bootstrap.BootstrapPrecomp) -> dict:
    """-> the keyword arguments of the JAX BootstrapPrecomp."""
    return {f: getattr(pre, f) for f in _PRECOMP_FIELDS}


def rotation_keys_from_jax(keys, device=None) -> dict:
    """{Galois element or rotation: JAX KSKey} -> the same dict of port
    KSKeys."""
    return {int(k): kskey_from_jax(v, device) for k, v in keys.items()}


def rotation_keys_to_numpy(keys: dict) -> dict:
    return {k: kskey_to_numpy(v) for k, v in keys.items()}


def bv_kskey_from_jax(k, device=None) -> keyswitch.BVKSKey:
    p = k.params
    return keyswitch.BVKSKey(
        u64_to_tensor(k.b_lo, k.b_hi, device),
        u64_to_tensor(k.a_lo, k.a_hi, device),
        keyswitch.BVKSParams(p.n, tuple(p.q_moduli), p.log_base))


def bv_kskey_to_numpy(k: keyswitch.BVKSKey):
    """-> (b_lo, b_hi, a_lo, a_hi) for the JAX BVKSKey."""
    return tensor_to_u64(k.b) + tensor_to_u64(k.a)


def _context_from_jax(gen_context, params_type, ctx, device):
    """The port's context built from the JAX context's params; its moduli
    must come out the same."""
    port = gen_context(params_type(**dataclasses.asdict(ctx.params)), device)
    for name in ("q_moduli", "r_moduli", "p_moduli"):
        if getattr(port, name, None) != getattr(ctx, name, None):
            raise ValueError(f"{name} differ between the packages")
    return port


def bgv_context_from_jax(ctx, device=None) -> bgv.BGVContext:
    return _context_from_jax(bgv.gen_context, bgv.BGVParams, ctx, device)


def bfv_context_from_jax(ctx, device=None) -> bfv.BFVContext:
    return _context_from_jax(bfv.gen_context, bfv.BFVParams, ctx, device)


def bgv_ciphertext_from_jax(ct, device=None) -> bgv.Ciphertext:
    return bgv.Ciphertext(tuple(poly_from_jax(p, device) for p in ct.polys))


def bfv_ciphertext_from_jax(ct, device=None) -> bfv.Ciphertext:
    return bfv.Ciphertext(tuple(poly_from_jax(p, device) for p in ct.polys),
                          noise_deg=int(ct.noise_deg))


def bgv_ciphertext_to_numpy(ct: bgv.Ciphertext):
    """-> [(lo, hi) per poly]."""
    return [poly_to_numpy(p) for p in ct.polys]


def bfv_ciphertext_to_numpy(ct: bfv.Ciphertext):
    """-> ([(lo, hi) per poly], noise_deg)."""
    return [poly_to_numpy(p) for p in ct.polys], ct.noise_deg


def ckks_context_from_jax(ctx, device=None) -> ckks.CKKSContext:
    return _context_from_jax(ckks.gen_context, ckks.CKKSParams, ctx, device)



def _int64_tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(
        _build.resolve_device(device))


def binfhe_context_from_jax(ctx, device=None) -> binfhe.BinFHEContext:
    return binfhe.gen_context(
        binfhe.BinFHEParams(**dataclasses.asdict(ctx.params)), device)


def binfhe_secret_from_jax(sk) -> binfhe.BinFHESecret:
    return binfhe.BinFHESecret(np.asarray(sk.s_lwe, dtype=np.int64).copy(),
                               np.asarray(sk.z_ring, dtype=np.int64).copy())


def binfhe_secret_to_numpy(sk: binfhe.BinFHESecret):
    """-> (s_lwe, z_ring) for the JAX BinFHESecret."""
    return sk.s_lwe.copy(), sk.z_ring.copy()


def lwe_ciphertext_from_jax(ct, device=None) -> binfhe.LWECiphertext:
    a = np.asarray(ct.a, dtype=np.int64)
    return binfhe.LWECiphertext(
        torch.from_numpy(a.copy()).to(_build.resolve_device(device)),
        int(ct.b), int(ct.modulus))


def lwe_ciphertext_to_numpy(ct: binfhe.LWECiphertext):
    """-> (a, b, modulus) for the JAX LWECiphertext."""
    return ct.a.cpu().numpy().astype(np.int64), int(ct.b), int(ct.modulus)


def lwe_public_key_from_jax(pk, device=None) -> binfhe.LWEPublicKey:
    device = _build.resolve_device(device)
    return binfhe.LWEPublicKey(
        torch.from_numpy(np.asarray(pk.A, dtype=np.int64).copy()).to(device),
        torch.from_numpy(np.asarray(pk.v, dtype=np.int64).copy()).to(device))


def bootstrap_key_from_arrays(ek_lo, ek_hi, ks_a, ks_b, device=None
                              ) -> binfhe.BootstrapKey:
    """The JAX package's BootstrapKey arrays (ek as uint32 planes of
    [T, V, 2dg, 2, N], ks_a/ks_b int32) -> the port's key: ek int64 with
    axes 1 and 3 swapped (``models/binfhe.py``), the key-switch key int64."""
    device = _build.resolve_device(device)
    ek = u64_to_tensor(ek_lo, ek_hi, device).transpose(1, 3).contiguous()
    return binfhe.BootstrapKey(ek, _int64_tensor(ks_a, device),
                               _int64_tensor(ks_b, device))


def bootstrap_key_from_jax(bk, device=None) -> binfhe.BootstrapKey:
    return bootstrap_key_from_arrays(bk.ek_lo, bk.ek_hi, bk.ks_a, bk.ks_b,
                                     device)


def bootstrap_key_to_numpy(bk: binfhe.BootstrapKey):
    """-> (ek_lo, ek_hi, ks_a, ks_b) in the JAX package's layout and dtypes
    (uint32 planes of [T, V, 2dg, 2, N]; int32)."""
    ek_lo, ek_hi = tensor_to_u64(bk.ek.transpose(1, 3).contiguous())
    return (ek_lo, ek_hi, bk.ks_a.cpu().numpy().astype(np.int32),
            bk.ks_b.cpu().numpy().astype(np.int32))


def _rgsw_from_jax(lo, hi, device) -> torch.Tensor:
    """[..., R, 2, N] uint32 planes -> int64 [..., 2, R, 1, N]: both halves
    of a key's rows as contiguous slabs with a one-row axis (the LMKCDEY
    layout of ``models/binfhe.py``)."""
    return u64_to_tensor(lo, hi, device).transpose(-3, -2).unsqueeze(-2) \
        .contiguous()


def _rgsw_to_numpy(t: torch.Tensor):
    return tensor_to_u64(t.squeeze(-2).transpose(-3, -2).contiguous())


def lmkcdey_key_from_arrays(ek_lo, ek_hi, ak_lo, ak_hi, ks_a, ks_b,
                            device=None) -> binfhe.LMKCDEYKey:
    """The JAX package's LMKCDEYKey arrays (ek as uint32 planes of
    [n, 2dg, 2, N], ak of [2, dg, 2, N], ks_a/ks_b int32) -> the port's key
    (ek [n, 2, 2dg, 1, N], ak [2, 2, dg, 1, N], int64)."""
    return binfhe.LMKCDEYKey(_rgsw_from_jax(ek_lo, ek_hi, device),
                             _rgsw_from_jax(ak_lo, ak_hi, device),
                             _int64_tensor(ks_a, device),
                             _int64_tensor(ks_b, device))


def lmkcdey_key_from_jax(bk, device=None) -> binfhe.LMKCDEYKey:
    return lmkcdey_key_from_arrays(bk.ek_lo, bk.ek_hi, bk.ak_lo, bk.ak_hi,
                                   bk.ks_a, bk.ks_b, device)


def lmkcdey_key_to_numpy(bk: binfhe.LMKCDEYKey):
    """-> (ek_lo, ek_hi, ak_lo, ak_hi, ks_a, ks_b) in the JAX package's
    layout and dtypes."""
    return (*_rgsw_to_numpy(bk.ek), *_rgsw_to_numpy(bk.ak),
            bk.ks_a.cpu().numpy().astype(np.int32),
            bk.ks_b.cpu().numpy().astype(np.int32))


def scheme_switch_precomp_from_jax(pre) -> scheme_switch.SchemeSwitchPrecomp:
    """Host constants on both sides, carried as they are."""
    return scheme_switch.SchemeSwitchPrecomp(int(pre.slots), pre.D,
                                             int(pre.B), pre.cheb_coeffs)


def scheme_switch_precomp_to_numpy(pre: scheme_switch.SchemeSwitchPrecomp
                                   ) -> dict:
    """-> the keyword arguments of the JAX SchemeSwitchPrecomp."""
    return dict(slots=pre.slots, D=pre.D, B=pre.B,
                cheb_coeffs=pre.cheb_coeffs)


def scheme_switch_keys_from_jax(keys, device=None
                                ) -> scheme_switch.SchemeSwitchKeys:
    return scheme_switch.SchemeSwitchKeys(
        kskey_from_jax(keys.conj, device),
        rotation_keys_from_jax(keys.rot_stc, device),
        rotation_keys_from_jax(keys.rot_f2c, device),
        kskey_from_jax(keys.evk, device),
        ciphertext_from_jax(keys.ct_s, device),
        _int64_tensor(keys.lwe_ks_a, device),
        _int64_tensor(keys.lwe_ks_b, device), int(keys.q_sw))


def scheme_switch_keys_to_numpy(keys: scheme_switch.SchemeSwitchKeys) -> dict:
    """-> the JAX SchemeSwitchKeys' fields: switching keys as
    ``kskey_to_numpy`` planes, ct_s as ``ciphertext_to_numpy``, the LWE
    switching key int64."""
    return dict(conj=kskey_to_numpy(keys.conj),
                rot_stc=rotation_keys_to_numpy(keys.rot_stc),
                rot_f2c=rotation_keys_to_numpy(keys.rot_f2c),
                evk=kskey_to_numpy(keys.evk),
                ct_s=ciphertext_to_numpy(keys.ct_s),
                lwe_ks_a=keys.lwe_ks_a.cpu().numpy(),
                lwe_ks_b=keys.lwe_ks_b.cpu().numpy(), q_sw=keys.q_sw)


def trapdoor_from_jax(A, T, device=None):
    """JAX trapdoor (A, TrapdoorPair) -> the port's: the k + 2 ring elements
    and the k (r, e) pairs as single-tower int64 polys on `device`."""
    return ([poly_from_jax(a, device) for a in A], trapdoor.TrapdoorPair(
        [poly_from_jax(r, device) for r in T.r],
        [poly_from_jax(e, device) for e in T.e]))


def trapdoor_to_numpy(A, T) -> dict:
    """-> (lo, hi) planes of A's ring elements and of T's r and e, for the
    JAX RnsPoly(lo, hi, basis, fmt) and TrapdoorPair."""
    return dict(A=[poly_to_numpy(a) for a in A],
                r=[poly_to_numpy(r) for r in T.r],
                e=[poly_to_numpy(e) for e in T.e])
