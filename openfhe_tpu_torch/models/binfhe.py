"""BINFHE: FHEW/TFHE boolean gates with CGGI (GINX), DM (AP) and LMKCDEY
blind rotation, programmable bootstrapping and the large-precision ops.

Counterpart of the whole of ``openfhe_tpu/models/binfhe.py``: LWE and
public-key LWE, the GINX, AP and LMKCDEY bootstrap keys and blind rotations,
gate bootstrapping, the 2-input and multi-input gates, CMUX and refresh,
``encrypt_zp``/``decrypt_zp``, the rounding modulus switch, ``eval_func``
(negacyclic LUTs) and the large-precision ``eval_floor``,
``eval_sign_large`` and ``eval_decomp``. Randomness is the caller's numpy
Generator, drawn in the JAX package's order and dtypes, and every device op
returns the unique reduced residue, so keys, accumulators and ciphertexts
are bit-equal to the JAX package's for the same seed.

Layout on the device (int64 residues, one modulus Q):

* the accumulator is ``[2, B, N]`` (both RLWE halves first, then the batch),
  so the digit stack of a step is ``[2*dg, B, N]`` in the reference's row
  order (half, then digit) and the external product is one
  ``ks_inner_product`` call;
* the bootstrap key ``ek`` is the JAX package's ``[T, V, 2*dg, 2, N]`` with
  axes 1 and 3 swapped: ``[T, 2, 2*dg, V, N]``, V = 2 signs (GINX, T = n) or
  B_r values (AP, T = n*d_r). ``ek[t, 0]`` and ``ek[t, 1]`` are the two
  halves of step t as contiguous ``[2*dg, V, N]`` slabs, and the kernel's row
  index picks the sign (GINX) or, read in place, the digit's slab (AP). The
  LMKCDEY key keeps the same layout with V = 1: ``ek`` ``[n, 2, 2*dg, 1, N]``
  (the JAX package's ``[n, 2*dg, 2, N]``) and the two automorphism keys
  ``ak`` ``[2, 2, dg, 1, N]`` (the JAX package's ``[2, dg, 2, N]``);
* the LWE key-switch key keeps the reference's ``[N, d_ks, B_ks, n]``.

One CGGI step is, for each sign: the signed gadget decomposition (one int64
path for every Q up to 59 bits), the forward NTT of ``[2*dg*B, 1, N]``, the
digit inner product times the (X^c - 1) row of the monomial table (one
``ks_inner_product`` call, the product in its epilogue), the inverse NTT of
``[2*B, 1, N]`` and an add. An LMKCDEY step is an external product
against ``ek[i]`` (decomposition, NTT, ``ks_inner_product``, inverse NTT)
or an automorphism X -> X^t, t = 5 or 2N - 5 (a signed permutation of both
halves, then the one-half key switch back under the ring secret, by the
same three kernels); its schedule is built on the host
per ciphertext. Every step loop is a Python loop on the card (the
reference's ``lax.scan``). The sample extraction, both rounding modulus
switches and the LWE key switch run on the card too; the rounding is exact
at every width (the reference's int64 product wraps in ``_mod_switch_lwe``
once Q and the new modulus pass 62 bits together).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..ops import elementwise, ntt
from ..ops.modular import (add_mod, make_mod_consts, mul_mod, neg_mod,
                           sub_mod)
from ..utils import nbtheory, sampling

KS_GATHER_BYTES = 1 << 30  # the LWE key switch gathers at most this at once


@dataclasses.dataclass(frozen=True)
class BinFHEParams:
    """Named parameter set (role of the reference's BINFHE_PARAMSET
    TOY..STD256Q_4); the JAX package's fields, defaults and order."""

    n_lwe: int
    N: int
    Q: int
    q_ks: int
    log_bg: int
    log_bks: int = 0
    sigma: float = 3.19
    method: str = "GINX"
    log_br: int = 3
    q_gate: int = 0
    base_ks: int = 0
    base_r: int = 0
    key_dist: str = "TERNARY"
    num_auto_keys: int = 1

    @property
    def q(self) -> int:
        """Gate/LWE ciphertext modulus; divides 2N."""
        return self.q_gate if self.q_gate else 2 * self.N

    @property
    def dg(self) -> int:
        return -(-self.Q.bit_length() // self.log_bg)

    @property
    def B_ks(self) -> int:
        return self.base_ks if self.base_ks else 1 << self.log_bks

    @property
    def d_ks(self) -> int:
        """Digits to cover q_ks - 1 in base B_ks."""
        d, x = 0, self.q_ks - 1
        while x:
            d += 1
            x //= self.B_ks
        return d

    @property
    def B_r(self) -> int:
        return self.base_r if self.base_r else 1 << self.log_br

    @property
    def d_r(self) -> int:
        """AP digit count: B_r^d_r >= 2N."""
        d, x = 0, 2 * self.N - 1
        while x:
            d += 1
            x //= self.B_r
        return d


def toy_params() -> BinFHEParams:
    Q = nbtheory.first_prime(27, 2 * 256)
    return BinFHEParams(n_lwe=32, N=256, Q=Q, q_ks=1 << 14,
                        log_bg=10, log_bks=5, sigma=3.19)


# The reference's named sets (binfhecontext.cpp:118-146), as the JAX package
# copies them: (numberBits, cyclOrder, latticeParam n, mod q, modKS (0 = the
# NTT prime Q), baseKS, gadgetBase, baseRK, numAutoKeys, keyDist, method).
_REF_TABLE = {
    "TOY_REF":           (27, 1024, 64, 512, 0, 25, 1 << 9, 23, 9,
                          "TERNARY", "GINX"),
    "MEDIUM":            (28, 2048, 422, 1024, 1 << 14, 1 << 7, 1 << 10, 32,
                          10, "TERNARY", "GINX"),
    "STD128_LMKCDEY":    (28, 2048, 446, 1024, 1 << 13, 1 << 5, 1 << 10, 32,
                          10, "GAUSSIAN", "LMKCDEY"),
    "STD128_AP":         (27, 2048, 503, 1024, 1 << 14, 1 << 5, 1 << 9, 32,
                          10, "TERNARY", "AP"),
    "STD128":            (27, 2048, 503, 1024, 1 << 14, 1 << 5, 1 << 9, 32,
                          10, "TERNARY", "GINX"),
    "STD192":            (37, 4096, 805, 1024, 1 << 15, 32, 1 << 13, 32,
                          10, "TERNARY", "GINX"),
    "STD256":            (29, 4096, 990, 2048, 1 << 14, 1 << 7, 1 << 8, 46,
                          10, "TERNARY", "GINX"),
    "STD128Q":           (25, 2048, 534, 1024, 1 << 14, 32, 1 << 7, 32,
                          10, "TERNARY", "GINX"),
    "STD128Q_LMKCDEY":   (27, 2048, 448, 1024, 1 << 13, 32, 1 << 9, 32,
                          10, "GAUSSIAN", "LMKCDEY"),
    "STD192Q":           (35, 4096, 875, 1024, 1 << 15, 32, 1 << 12, 32,
                          10, "TERNARY", "GINX"),
    "STD256Q":           (27, 4096, 1225, 1024, 1 << 16, 16, 1 << 7, 32,
                          10, "TERNARY", "GINX"),
    "STD128_3":          (27, 2048, 541, 1024, 1 << 15, 32, 1 << 7, 32,
                          10, "TERNARY", "GINX"),
    "STD128_3_LMKCDEY":  (28, 2048, 485, 1024, 1 << 15, 32, 1 << 10, 32,
                          10, "GAUSSIAN", "LMKCDEY"),
    "STD128Q_3":         (50, 4096, 575, 2048, 1 << 15, 32, 1 << 25, 32,
                          10, "TERNARY", "GINX"),
    "STD128Q_3_LMKCDEY": (27, 2048, 524, 1024, 1 << 15, 32, 1 << 9, 32,
                          10, "GAUSSIAN", "LMKCDEY"),
    "STD192Q_3":         (34, 4096, 922, 2048, 1 << 16, 16, 1 << 12, 32,
                          10, "TERNARY", "GINX"),
    "STD256Q_3":         (27, 4096, 1400, 4096, 1 << 16, 21, 1 << 6, 32,
                          10, "TERNARY", "GINX"),
    "STD128_4":          (27, 2048, 541, 2048, 1 << 15, 32, 1 << 7, 32,
                          10, "TERNARY", "GINX"),
    "STD128_4_LMKCDEY":  (28, 2048, 522, 2048, 1 << 15, 32, 1 << 10, 32,
                          10, "GAUSSIAN", "LMKCDEY"),
    "STD128Q_4":         (50, 4096, 647, 2048, 1 << 16, 16, 1 << 25, 32,
                          10, "TERNARY", "GINX"),
    "STD128Q_4_LMKCDEY": (27, 2048, 524, 2048, 1 << 15, 32, 1 << 7, 32,
                          10, "GAUSSIAN", "LMKCDEY"),
    "STD192Q_4":         (34, 4096, 980, 2048, 1 << 17, 16, 1 << 12, 32,
                          10, "TERNARY", "GINX"),
    "STD256Q_4":         (27, 4096, 1625, 4096, 1 << 21, 16, 1 << 6, 32,
                          10, "TERNARY", "GINX"),
    "SIGNED_MOD_TEST":   (28, 2048, 512, 1024, 0, 25, 1 << 7, 23,
                          10, "TERNARY", "GINX"),
}


def reference_params(name: str) -> BinFHEParams:
    """A named set with the reference's constants; Q is
    PreviousPrime(FirstPrime(bits, 2N), 2N) (binfhecontext.cpp:148-150)."""
    (bits, cyc, n, q, mod_ks, base_ks, base_g, base_r, n_auto, dist,
     meth) = _REF_TABLE[name]
    N = cyc // 2
    Q = nbtheory.previous_prime(nbtheory.first_prime(bits, cyc), cyc)
    if mod_ks == 0:      # the reference's PRIME sentinel: key-switch at Q
        mod_ks = Q
    return BinFHEParams(
        n_lwe=n, N=N, Q=Q, q_ks=mod_ks, log_bg=base_g.bit_length() - 1,
        sigma=3.19, method=meth, q_gate=q, base_ks=base_ks,
        base_r=base_r, key_dist=dist, num_auto_keys=n_auto)


def std128_params() -> BinFHEParams:
    return reference_params("STD128")


def toy_lp_params() -> BinFHEParams:
    """Toy set sized for the large-precision ops (lower sigma, fewer
    key-switch digits)."""
    return dataclasses.replace(toy_params(), log_bks=7, sigma=1.0)


def toy_ap_params() -> BinFHEParams:
    return dataclasses.replace(toy_params(), method="AP", log_br=3)


def toy_lmk_params() -> BinFHEParams:
    return dataclasses.replace(toy_params(), method="LMKCDEY")


def std128_ap_params() -> BinFHEParams:
    return reference_params("STD128_AP")


PARAM_SETS = {"TOY": toy_params, "STD128": std128_params,
              "TOY_LP": toy_lp_params,
              "TOY_AP": toy_ap_params, "STD128_AP": std128_ap_params,
              "TOY_LMKCDEY": toy_lmk_params}
PARAM_SETS.update({name: (lambda n=name: reference_params(n))
                   for name in _REF_TABLE if name not in PARAM_SETS})


class LWECiphertext(NamedTuple):
    """(a, b) over modulus q: phase = b - <a, s> encodes m * q/4. ``a`` is an
    int64 tensor on the context's device."""

    a: torch.Tensor
    b: int
    modulus: int


@dataclasses.dataclass
class BinFHESecret:
    s_lwe: np.ndarray    # int64 [n_lwe]
    z_ring: np.ndarray   # int64 [N] (the accumulator ring secret)


@dataclasses.dataclass
class BootstrapKey:
    """Blind-rotation key ``ek`` [T, 2, 2*dg, V, N] (module docstring) and the
    LWE key-switch key ``ks_a`` [N, d_ks, B_ks, n], ``ks_b`` [N, d_ks, B_ks]
    mod q_ks, all int64 on the device."""

    ek: torch.Tensor
    ks_a: torch.Tensor
    ks_b: torch.Tensor


@dataclasses.dataclass
class LWEPublicKey:
    """(A, v = A z + e) over Q at dimension N, int64 tensors."""

    A: torch.Tensor   # [N, N]
    v: torch.Tensor   # [N]


@dataclasses.dataclass(frozen=True)
class BinFHEContext:
    params: BinFHEParams
    device: torch.device


def gen_context(name_or_params="STD128", device=None) -> BinFHEContext:
    """A context for a named set or a BinFHEParams on `device`; None means
    the current CUDA device, and without one this raises (pass
    device="cpu" to run on the CPU)."""
    device = _build.resolve_device(device)
    p = PARAM_SETS[name_or_params]() if isinstance(name_or_params, str) \
        else name_or_params
    if p.Q.bit_length() > 59:
        raise ValueError(
            f"accumulator modulus Q ({p.Q.bit_length()} bits) exceeds the "
            "59-bit limit of the limb kernels")
    if p.Q.bit_length() > 30 and p.method != "GINX":
        raise ValueError(
            f"method {p.method} supports Q < 2^31 only (use GINX for "
            f"{p.Q.bit_length()}-bit Q)")
    if (2 * p.N) % p.q != 0:
        raise ValueError("gate modulus q must divide 2N")
    return BinFHEContext(p, device)


@lru_cache(maxsize=None)
def _mod(ctx: BinFHEContext):
    """Constants of Q, broadcasting against any shape."""
    return make_mod_consts((ctx.params.Q,), ctx.device, trailing_dims=0)


@lru_cache(maxsize=None)
def _row_mod(ctx: BinFHEContext, rows: int):
    """[rows, 1] constants of Q, for the digit inner product over a batch."""
    return make_mod_consts((ctx.params.Q,) * rows, ctx.device)


def _ntt_nd(x: torch.Tensor, Q: int, inverse: bool = False) -> torch.Tensor:
    """NTT over the last axis of any shape, as one [rows, 1, N] call (every
    BINFHE ring is at most 2^11, whose kernel takes any number of rows)."""
    fn = ntt.inverse if inverse else ntt.forward
    return fn(x.reshape(-1, 1, x.shape[-1]), (Q,)).reshape(x.shape)


def _rows(ctx: BinFHEContext, a) -> torch.Tensor:
    """Integer rows (a tensor, or anything numpy reads) as int64 on the
    context's device."""
    if isinstance(a, torch.Tensor):
        return a.to(device=ctx.device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(ctx.device)


def _round_switch(x: torch.Tensor, old: int, new: int) -> torch.Tensor:
    """floor((2*x*new + old) / (2*old)) mod new, exactly, for x in [0, old)
    and any widths: a float64 estimate of the quotient (off by at most one),
    corrected by the exact remainder, which int64 arithmetic modulo 2^64
    gives since its true value lies in [-2*old, 4*old)."""
    f = torch.floor(x.double() * (new / old) + 0.5).to(torch.int64)
    r = x * (2 * new) + old - f * (2 * old)
    f = f - (r < 0).to(torch.int64) + (r >= 2 * old).to(torch.int64)
    return f % new


def _round_int(x: int, old: int, new: int) -> int:
    return (x * new * 2 + old) // (2 * old) % new


def keygen(ctx: BinFHEContext, rng: np.random.Generator) -> BinFHESecret:
    """(role of BinFHEContext::KeyGen): ternary, or Gaussian for
    keyDist GAUSSIAN."""
    p = ctx.params
    if p.key_dist == "GAUSSIAN":
        assert p.method in ("LMKCDEY", "AP"), \
            "GAUSSIAN secrets require the LMKCDEY or AP method"
        return BinFHESecret(sampling.gaussian_coeffs(p.n_lwe, rng, p.sigma),
                            sampling.gaussian_coeffs(p.N, rng, p.sigma))
    return BinFHESecret(sampling.ternary_coeffs(p.n_lwe, rng),
                        sampling.ternary_coeffs(p.N, rng))


def encrypt_phase(ctx: BinFHEContext, sk: BinFHESecret, value: int,
                  modulus: int, rng: np.random.Generator) -> LWECiphertext:
    """LWE encryption of a raw phase `value` at any (power-of-two)
    `modulus`, the input format of the large-precision ops: a drawn as
    int64, then one normal."""
    p = ctx.params
    a = rng.integers(0, modulus, size=p.n_lwe, dtype=np.int64)
    e = int(np.rint(rng.normal(0, p.sigma)))
    return LWECiphertext(_rows(ctx, a),
                         (int(a @ sk.s_lwe) + e + value) % modulus, modulus)


def decrypt_phase(ctx: BinFHEContext, sk: BinFHESecret,
                  ct: LWECiphertext) -> int:
    """b - <a, s> mod the ciphertext's modulus."""
    return (ct.b - int(ct.a.cpu().numpy() @ sk.s_lwe)) % ct.modulus


def encrypt(ctx: BinFHEContext, sk: BinFHESecret, bit: int,
            rng: np.random.Generator) -> LWECiphertext:
    """LWE encrypt a bit at q/4 (LWEEncryptionScheme::Encrypt)."""
    q = ctx.params.q
    return encrypt_phase(ctx, sk, bit * (q // 4), q, rng)


def decrypt(ctx: BinFHEContext, sk: BinFHESecret, ct: LWECiphertext) -> int:
    q = ct.modulus
    return int(((4 * decrypt_phase(ctx, sk, ct) + q // 2) // q) % 4) & 1


def encrypt_zp(ctx: BinFHEContext, sk: BinFHESecret, m: int, p: int,
               rng: np.random.Generator) -> LWECiphertext:
    """LWE encrypt a message of Z_p at q/p."""
    q = ctx.params.q
    return encrypt_phase(ctx, sk, (m * q) // p, q, rng)


def decrypt_zp(ctx: BinFHEContext, sk: BinFHESecret, ct: LWECiphertext,
               p: int) -> int:
    q = ct.modulus
    return int(((p * decrypt_phase(ctx, sk, ct) + q // 2) // q) % p)


# ---------------------------------------------------------------------------
# Public-key LWE (LWEEncryptionScheme::KeyGenPair / PubKeyGen / EncryptN)
# ---------------------------------------------------------------------------


def _matvec_mod(A: torch.Tensor, x: np.ndarray, Q: int, mod) -> torch.Tensor:
    """(A @ x) mod Q for residues A and small signed x: reduced products,
    summed in blocks that cannot pass 2^62."""
    xq = torch.from_numpy(np.asarray(x, dtype=np.int64) % Q).to(A.device)
    prod = mul_mod(A, xq, mod)
    block = 1 << max(0, 62 - Q.bit_length())
    acc = torch.zeros(A.shape[0], dtype=torch.int64, device=A.device)
    for s in range(0, A.shape[1], block):
        acc = (acc + prod[:, s:s + block].sum(dim=1)) % Q
    return acc


def pubkey_gen(ctx: BinFHEContext, sk: BinFHESecret,
               rng: np.random.Generator) -> LWEPublicKey:
    """(role of LWEEncryptionScheme::PubKeyGen, lwe-pke.cpp:81-111)."""
    p = ctx.params
    N, Q = p.N, p.Q
    A = _rows(ctx, rng.integers(0, Q, size=(N, N), dtype=np.int64))
    e = _rows(ctx, np.rint(rng.normal(0, p.sigma, size=N)).astype(np.int64))
    v = (_matvec_mod(A, sk.z_ring, Q, _mod(ctx)) + e) % Q
    return LWEPublicKey(A, v)


def keygen_pair(ctx: BinFHEContext, rng: np.random.Generator
                ) -> Tuple[LWEPublicKey, BinFHESecret]:
    """The secret and a public key bound to its ring secret z_ring."""
    sk = keygen(ctx, rng)
    return pubkey_gen(ctx, sk, rng), sk


def encrypt_pk(ctx: BinFHEContext, pk: LWEPublicKey, m: int,
               rng: np.random.Generator) -> LWECiphertext:
    """Public-key LWE encryption of m mod 4 at dimension N, modulus Q
    (EncryptN, lwe-pke.cpp:153-194); switch_ct_to_qn makes it gate-ready."""
    p = ctx.params
    N, Q = p.N, p.Q
    mod = _mod(ctx)
    sp = sampling.ternary_coeffs(N, rng)
    ep = _rows(ctx, np.rint(rng.normal(0, p.sigma, size=N)).astype(np.int64))
    a = (_matvec_mod(pk.A.T, sp, Q, mod) + ep) % Q
    e2 = int(np.rint(rng.normal(0, p.sigma)))
    b = (int(_matvec_mod(pk.v[None, :], sp, Q, mod)[0]) + e2
         + (m % 4) * (Q // 4)) % Q
    return LWECiphertext(a, b, Q)


def _mod_switch_lwe(ct: LWECiphertext, new_mod: int) -> LWECiphertext:
    """Rounding LWE modulus switch (LWEEncryptionScheme::ModSwitch,
    lwe-pke.cpp:39), exact at every width."""
    return LWECiphertext(_round_switch(ct.a, ct.modulus, new_mod),
                         _round_int(ct.b, ct.modulus, new_mod), new_mod)


def switch_ct_to_qn(ctx: BinFHEContext, bk: BootstrapKey,
                    ct: LWECiphertext) -> LWECiphertext:
    """A dimension-N, modulus-Q ciphertext to the gate format: dimension
    n_lwe, modulus q (LWEEncryptionScheme::SwitchCTtoqn)."""
    p = ctx.params
    assert len(ct.a) == p.N, "input must be at ring dimension N"
    ct1 = _mod_switch_lwe(ct, p.q_ks)
    # the key switch reads phase = b + <a, z>; this one is b - <a, z>
    a_out, b_out = _lwe_keyswitch_batch(
        ctx, bk.ks_a, bk.ks_b, neg_mod(ct1.a, p.q_ks)[None, :],
        _rows(ctx, [ct1.b]))
    ct2 = LWECiphertext(a_out[0], int(b_out[0]), p.q_ks)
    return _mod_switch_lwe(ct2, p.q)


# ---------------------------------------------------------------------------
# Bootstrap key generation
# ---------------------------------------------------------------------------


def _rlwe_encrypt_batch(ctx: BinFHEContext, z_eval: torch.Tensor,
                        msgs_eval: torch.Tensor, shape,
                        rng: np.random.Generator):
    """RLWE encryptions under z of msgs [*shape, N] (EVAL): (c0, c1) with
    c0 + c1*z = msg + e. a is drawn as uint64, then the errors, as the
    reference draws them; the errors' NTT is one call."""
    p = ctx.params
    N, Q = p.N, p.Q
    a = _rows(ctx, rng.integers(0, Q, size=(*shape, N), dtype=np.uint64)
              .view(np.int64))
    e = np.rint(rng.normal(0, p.sigma, size=(*shape, N)))
    e_ev = _ntt_nd(_rows(ctx, e.astype(np.int64)) % Q, Q)
    c0 = add_mod(sub_mod(e_ev, mul_mod(a, z_eval, _mod(ctx)), Q), msgs_eval,
                 Q)
    return c0, a


def _keyswitch_keygen(ctx: BinFHEContext, sk: BinFHESecret,
                      rng: np.random.Generator):
    """LWE key-switch key from the ring coefficients to s_lwe at q_ks
    (LWEEncryptionScheme::KeySwitchGen)."""
    return _lwe_keyswitch_keygen(ctx, sk.z_ring, sk.s_lwe, rng)


def _lwe_keyswitch_keygen(ctx: BinFHEContext, z: np.ndarray,
                          s_lwe: np.ndarray, rng: np.random.Generator):
    """Encryptions under s_lwe at q_ks of v * B_ks^d * z_j for every
    coordinate j of the source key z (any dimension: the ring secret here,
    the CKKS secret in scheme switching): a drawn first, then the errors."""
    p = ctx.params
    N, n = len(z), p.n_lwe
    q_ks, d_ks, B_ks = p.q_ks, p.d_ks, p.B_ks
    a_ks = _rows(ctx, rng.integers(0, q_ks, size=(N, d_ks, B_ks, n),
                                   dtype=np.int64))
    e_ks = np.rint(rng.normal(0, p.sigma, size=(N, d_ks, B_ks)))
    vals = np.arange(B_ks, dtype=np.int64)[None, None, :]
    powers = np.array([pow(B_ks, d, q_ks) for d in range(d_ks)], np.int64)
    targets = (vals * powers[None, :, None] % q_ks
               * np.asarray(z, dtype=np.int64)[:, None, None]) % q_ks
    s = _rows(ctx, s_lwe)
    b_ks = ((a_ks * s).sum(dim=-1) + _rows(ctx, e_ks.astype(np.int64)
                                           + targets)) % q_ks
    return a_ks, b_ks


def _z_eval(ctx: BinFHEContext, sk: BinFHESecret) -> torch.Tensor:
    """The ring secret in the evaluation domain, [N]."""
    z = _rows(ctx, sampling.signed_to_rns_rows(sk.z_ring, (ctx.params.Q,))
              .view(np.int64))
    return _ntt_nd(z, ctx.params.Q)[0]


def bootstrap_keygen(ctx: BinFHEContext, sk: BinFHESecret,
                     rng: np.random.Generator) -> BootstrapKey:
    """(role of BinFHEContext::BTKeyGen), by the context's method."""
    method = ctx.params.method
    if method == "AP":
        return _bootstrap_keygen_dm(ctx, sk, rng)
    if method == "LMKCDEY":
        return bootstrap_keygen_lmkcdey(ctx, sk, rng)
    assert method == "GINX", method
    return _bootstrap_keygen_cggi(ctx, sk, rng)


def _bootstrap_keygen_cggi(ctx: BinFHEContext, sk: BinFHESecret,
                           rng: np.random.Generator) -> BootstrapKey:
    """CGGI/GINX double keys (rgsw-acc-cggi.cpp:40-57): step i, sign 0
    encrypts (s_i == 1), sign 1 encrypts (s_i == -1); rows d < dg carry
    bit * B^d, rows dg + d carry bit * B^d * z."""
    p = ctx.params
    N, Q, n, dg = p.N, p.Q, p.n_lwe, p.dg
    z_eval = _z_eval(ctx, sk)
    bits = np.stack([sk.s_lwe == 1, sk.s_lwe == -1], axis=1)   # [n, 2]
    powers = np.array([(1 << (p.log_bg * d)) % Q for d in range(dg)],
                      np.int64)
    first = _rows(ctx, bits[:, :, None] * powers[None, None, :])
    first = first[..., None].expand(n, 2, dg, N)
    second = mul_mod(first, z_eval, _mod(ctx))
    msgs = torch.cat([first, second], dim=2)                   # [n, 2, 2dg, N]
    c0, c1 = _rlwe_encrypt_batch(ctx, z_eval, msgs, (n, 2, 2 * dg), rng)
    ek = torch.stack([c0.transpose(1, 2), c1.transpose(1, 2)], dim=1)
    ks_a, ks_b = _keyswitch_keygen(ctx, sk, rng)
    return BootstrapKey(ek, ks_a, ks_b)


def _bootstrap_keygen_dm(ctx: BinFHEContext, sk: BinFHESecret,
                         rng: np.random.Generator) -> BootstrapKey:
    """DM/AP key (RingGSWAccumulatorDM::KeyGenAcc): ek[i*d_r + j, :, :, v]
    = RGSW(X^{s_i * v * B_r^j}); blind rotation gathers one slab per step."""
    p = ctx.params
    N, Q, n, dg = p.N, p.Q, p.n_lwe, p.dg
    d_r, B_r = p.d_r, p.B_r
    z_eval = _z_eval(ctx, sk)
    s = sk.s_lwe.astype(np.int64)
    v = np.arange(B_r, dtype=np.int64)
    bpow = np.array([pow(B_r, j, 2 * N) for j in range(d_r)], np.int64)
    c = (s[:, None, None] * bpow[None, :, None] * v[None, None, :]) % (2 * N)
    M = n * d_r * B_r
    xc = _rows(ctx, _monomial_eval_np(ctx))[_rows(ctx, c.reshape(-1))]
    powers = _rows(ctx, [(1 << (p.log_bg * d)) % Q for d in range(dg)])
    # Q < 2^31 for AP, so the products fit int64
    first = (xc[:, None, :] * powers[None, :, None]) % Q      # [M, dg, N]
    second = mul_mod(first, z_eval, _mod(ctx))
    msgs = torch.cat([first, second], dim=1)                   # [M, 2dg, N]
    del xc, first, second
    c0, c1 = _rlwe_encrypt_batch(ctx, z_eval, msgs, (M, 2 * dg), rng)
    del msgs
    T = n * d_r
    ek = torch.stack([c.reshape(T, B_r, 2 * dg, N).transpose(1, 2)
                      for c in (c0, c1)], dim=1)      # [T, 2, 2dg, B_r, N]
    ks_a, ks_b = _keyswitch_keygen(ctx, sk, rng)
    return BootstrapKey(ek, ks_a, ks_b)


# ---------------------------------------------------------------------------
# Blind rotation
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _monomial_eval_np(ctx: BinFHEContext) -> np.ndarray:
    """int64 [2N, N]: X^c in the evaluation domain for every exponent c
    (slot j evaluates at psi^(2*rev(j)+1)); exact Python-int powers."""
    p = ctx.params
    N, Q = p.N, p.Q
    psi = nbtheory.root_of_unity(2 * N, Q)
    exps = (2 * ntt.bit_reverse_perm(N) + 1) % (2 * N)
    acc = 1
    pw = np.empty(2 * N, dtype=np.int64)
    for i in range(2 * N):
        pw[i] = acc
        acc = acc * psi % Q
    return pw[(np.arange(2 * N, dtype=np.int64)[:, None] * exps[None, :])
              % (2 * N)]


@lru_cache(maxsize=None)
def _monomial_table(ctx: BinFHEContext) -> torch.Tensor:
    """[2N, N]: (X^c - 1) in the evaluation domain for every exponent c."""
    return _rows(ctx, (_monomial_eval_np(ctx) - 1) % ctx.params.Q)


def _make_signed_decompose(p: BinFHEParams):
    """[2, B, N] residues -> [2*dg, B, N] signed gadget digits as residues
    mod Q, rows in the reference's order (half, then digit): the centered
    lift, then dg rounds of r = ((v + B/2) mod B) - B/2, v = (v - r) >> logB
    (rgsw-acc.h:86-98). One int64 path for every Q up to 59 bits; the JAX
    package's int32 lanes and two-limb path give the same integers."""
    Q, dg, log_b = p.Q, p.dg, p.log_bg
    half_q, mask, half_b = Q // 2, (1 << log_b) - 1, 1 << (log_b - 1)

    def signed_decompose(acc: torch.Tensor) -> torch.Tensor:
        v = torch.where(acc > half_q, acc - Q, acc)
        digits = []
        for _ in range(dg):
            r = ((v + half_b) & mask) - half_b
            v = (v - r) >> log_b
            digits.append(r)
        d = torch.stack(digits, dim=1).flatten(0, 1)
        return torch.where(d < 0, d + Q, d)

    return signed_decompose


def _blind_rotate_cggi(ctx: BinFHEContext, ek: torch.Tensor,
                       acc: torch.Tensor, a_t: torch.Tensor) -> torch.Tensor:
    """The n_lwe CGGI accumulator updates (rgsw-acc-cggi.cpp:59-153).
    acc [2, B, N] coefficients; a_t [n, B] exponents mod 2N."""
    p = ctx.params
    N, Q = p.N, p.Q
    B = acc.shape[1]
    row_mod = _row_mod(ctx, B)
    mono = _monomial_table(ctx)
    decompose = _make_signed_decompose(p)
    # the rotation target is X^{b - sum a_i s_i}: the s_i = +1 key (sign 0)
    # rotates by X^{-a_i}, the s_i = -1 key by X^{+a_i}
    exps = torch.stack([(2 * N - a_t) % (2 * N), a_t], dim=1)   # [n, 2, B]
    sign_rows = ((0,) * B, (1,) * B)
    for i in range(p.n_lwe):
        for sign in range(2):
            digits = _ntt_nd(decompose(acc), Q)                 # [2dg, B, N]
            # the digit inner product times the (X^c - 1) row, one launch
            rotated = elementwise.ks_inner_product(
                digits, ek[i, 0], ek[i, 1], sign_rows[sign], row_mod,
                mono=mono, mono_rows=exps[i, sign])              # [2, B, N]
            acc = add_mod(acc, _ntt_nd(rotated, Q, inverse=True), Q)
    return acc


def _dm_digit_tensor(ctx: BinFHEContext, a_2n: torch.Tensor) -> torch.Tensor:
    """[n*d_r, B] base-B_r digits of (2N - a_i) mod 2N, so the product of
    the gathered slabs is X^{-sum a_i s_i}."""
    p = ctx.params
    M = 2 * p.N
    rem = ((M - a_2n % M) % M).T                                # [n, B]
    digs = []
    for _ in range(p.d_r):
        digs.append(rem % p.B_r)
        rem = rem // p.B_r
    return torch.stack(digs, dim=1).reshape(p.n_lwe * p.d_r, -1)


def _blind_rotate_dm(ctx: BinFHEContext, ek: torch.Tensor, acc: torch.Tensor,
                     dig: torch.Tensor) -> torch.Tensor:
    """The n_lwe*d_r DM updates (RingGSWAccumulatorDM::EvalAcc): each step
    replaces acc by acc (*) ek[t, :, :, digit], batch element b reading the
    key's row dig[t, b] in place."""
    p = ctx.params
    Q = p.Q
    B = acc.shape[1]
    row_mod = _row_mod(ctx, B)
    decompose = _make_signed_decompose(p)
    for t in range(dig.shape[0]):
        digits = _ntt_nd(decompose(acc), Q)
        ext = elementwise.ks_inner_product(digits, ek[t, 0], ek[t, 1],
                                           dig[t], row_mod)
        acc = _ntt_nd(ext, Q, inverse=True)
    return acc


@lru_cache(maxsize=None)
def _test_vector(ctx: BinFHEContext) -> torch.Tensor:
    """Gate test polynomial tv = (-Q/8) * sum_j X^j: const(tv * X^w) is +Q/8
    for w mod 2N in (0, N] and -Q/8 otherwise."""
    p = ctx.params
    return torch.full((p.N,), p.Q - p.Q // 8, dtype=torch.int64,
                      device=ctx.device)


def _rotate_test_vector(ctx: BinFHEContext, tv: torch.Tensor,
                        shifts: Sequence[int]) -> torch.Tensor:
    """[B, N]: tv * X^shift in Z_Q[X]/(X^N + 1) for each shift, a
    negacyclic shift: coefficient k is tv[k - s] when k >= s (mod 2N
    wrap-around), -tv[k - s + N] otherwise."""
    N = ctx.params.N
    ext = torch.cat([tv, neg_mod(tv, ctx.params.Q)])              # [2N]
    s = _rows(ctx, [int(v) % (2 * N) for v in shifts])
    idx = (torch.arange(N, device=ctx.device)[None, :] - s[:, None]) % (2 * N)
    return ext[idx]


def _bootstrap_core(ctx: BinFHEContext, bk, a_2n: torch.Tensor,
                    b_2n: Sequence[int]) -> torch.Tensor:
    """Blind-rotate the gate test vector by the phase of each (a, b) mod 2N.
    a_2n [B, n_lwe]; returns the accumulator [2, B, N] (coefficients)."""
    return _bootstrap_core_tv(ctx, bk, a_2n, b_2n, _test_vector(ctx))


def _bootstrap_core_tv(ctx: BinFHEContext, bk, a_2n, b_2n: Sequence[int],
                       tv: torch.Tensor) -> torch.Tensor:
    """_bootstrap_core with the caller's test polynomial tv [N] (reduced
    residues on the context's device): the negacyclic shift by each b runs
    on the card."""
    a_2n = _rows(ctx, a_2n)
    if ctx.params.method == "LMKCDEY":
        return _bootstrap_core_lmk(ctx, bk, a_2n, b_2n, tv)
    c0 = _rotate_test_vector(ctx, tv, b_2n)
    acc = torch.stack([c0, torch.zeros_like(c0)])
    return _run_blind_rotation(ctx, bk, acc, a_2n)


def _run_blind_rotation(ctx: BinFHEContext, bk: BootstrapKey,
                        acc: torch.Tensor, a_2n: torch.Tensor
                        ) -> torch.Tensor:
    """By the accumulator method (the reference's ACCscheme object)."""
    if ctx.params.method == "AP":
        return _blind_rotate_dm(ctx, bk.ek, acc, _dm_digit_tensor(ctx, a_2n))
    return _blind_rotate_cggi(ctx, bk.ek, acc,
                              (a_2n % (2 * ctx.params.N)).T)


def _lwe_keyswitch_batch(ctx: BinFHEContext, ks_a: torch.Tensor,
                         ks_b: torch.Tensor, a1: torch.Tensor,
                         b1: torch.Tensor):
    """LWE key switch from dimension N (a1's, the ring's or the CKKS ring's)
    to n_lwe at q_ks (LWEEncryptionScheme::KeySwitch): base-B_ks digits of
    each coordinate gather key rows, which are summed. a1 [B, N], b1 [B]
    mod q_ks; returns
    (a_out [B, n], b_out [B]). The [b, N, d_ks, n] gather runs in batches
    of at most KS_GATHER_BYTES."""
    p = ctx.params
    N, n, q_ks, B_ks, d_ks = a1.shape[1], p.n_lwe, p.q_ks, p.B_ks, p.d_ks
    digits = []
    rem = a1
    for _ in range(d_ks):
        digits.append(rem % B_ks)
        rem = rem // B_ks
    digits = torch.stack(digits, dim=2)                        # [B, N, d_ks]
    j = torch.arange(N, device=a1.device)[None, :, None]
    d = torch.arange(d_ks, device=a1.device)[None, None, :]
    chunk = max(1, KS_GATHER_BYTES // (8 * N * d_ks * n))
    # phase_in = b1 + sum_j a1_j z_j = b1 + sum(sel_b) - <sum(sel_a), s>
    a_out = torch.cat([ks_a[j, d, digits[s:s + chunk]].sum(dim=(1, 2))
                       for s in range(0, digits.shape[0], chunk)]) % q_ks
    b_out = (b1 + ks_b[j, d, digits].sum(dim=(1, 2))) % q_ks
    return a_out, b_out


def _extract_and_keyswitch_offset(ctx: BinFHEContext, bk,
                                  acc: torch.Tensor, offset: int,
                                  out_mod: int | None = None) -> list:
    """Sample-extract LWE(Q, N) from each accumulator, add `offset` to b
    (gate bootstrapping adds Q/8, a LUT none), switch to q_ks, key-switch to
    s_lwe and switch to `out_mod` (default the gate modulus q; at most q_ks:
    the large-precision ops keep their large modulus)
    (binfhe-base-scheme.cpp:118-122); both switches round exactly."""
    p = ctx.params
    Q, q_ks, q = p.Q, p.q_ks, p.q
    if out_mod is not None:
        assert out_mod <= q_ks, "output modulus cannot exceed q_ks"
        q = out_mod
    c0, c1 = acc[0], acc[1]
    b_n = (c0[:, 0] + offset) % Q
    a_n = torch.cat([c1[:, :1], neg_mod(c1[:, 1:].flip(1), Q)], dim=1)
    a_out, b_out = _lwe_keyswitch_batch(ctx, bk.ks_a, bk.ks_b,
                                        _round_switch(a_n, Q, q_ks),
                                        _round_switch(b_n, Q, q_ks))
    a2 = _round_switch(a_out, q_ks, q)
    b2 = _round_switch(b_out, q_ks, q).tolist()
    return [LWECiphertext(a2[i], int(b2[i]), q) for i in range(len(b2))]


def _extract_and_keyswitch(ctx: BinFHEContext, bk: BootstrapKey,
                           acc: torch.Tensor) -> list:
    """Gate bootstrapping's extraction: the + Q/8 offset maps the rotation
    halves to {0, Q/4}."""
    return _extract_and_keyswitch_offset(ctx, bk, acc, ctx.params.Q // 8)


def bootstrap_raw_batch(ctx: BinFHEContext, bk: BootstrapKey, a_q, b_q
                        ) -> list:
    """Batched PBS of LWE samples at the gate modulus q: a_q [B, n], b_q [B];
    exponents are scaled by 2N/q."""
    p = ctx.params
    M = 2 * p.N
    assert M % p.q == 0, "gate modulus must divide 2N"
    f = M // p.q
    a_2n = (_rows(ctx, a_q) * f) % M
    b_2n = [(int(b) * f) % M for b in b_q]
    return _extract_and_keyswitch(ctx, bk, _bootstrap_core(ctx, bk, a_2n,
                                                           b_2n))


def bootstrap_raw(ctx: BinFHEContext, bk: BootstrapKey, a_q, b_q
                  ) -> LWECiphertext:
    return bootstrap_raw_batch(ctx, bk, _rows(ctx, a_q)[None, :], [b_q])[0]


GATES = {
    "AND": (1, 1, -3, 8),   # w = ct1 + ct2 - 3q/8
    "OR": (1, 1, -1, 8),
    "NAND": (-1, -1, 3, 8),
    "NOR": (-1, -1, 1, 8),
}


def _gate_input(ctx: BinFHEContext, gate: str, ct1: LWECiphertext,
                ct2: LWECiphertext):
    q = ctx.params.q
    if gate in ("XOR", "XNOR"):
        a = (2 * (ct1.a - ct2.a)) % q
        b = (2 * (ct1.b - ct2.b) - 3 * q // 8) % q
        return a, b, gate == "XNOR"
    s1, s2, cnum, cden = GATES[gate]
    a = (s1 * ct1.a + s2 * ct2.a) % q
    b = (s1 * ct1.b + s2 * ct2.b + cnum * q // cden) % q
    return a, b, False


def eval_gate(ctx: BinFHEContext, gate: str, bk: BootstrapKey,
              ct1: LWECiphertext, ct2: LWECiphertext) -> LWECiphertext:
    """(role of BinFHEContext::EvalBinGate)."""
    return eval_gate_batch(ctx, gate, bk, [ct1], [ct2])[0]


def eval_gate_batch(ctx: BinFHEContext, gate: str, bk: BootstrapKey,
                    cts1: list, cts2: list) -> list:
    """The same gate over a batch of input pairs, one blind rotation."""
    inputs = [_gate_input(ctx, gate, c1, c2) for c1, c2 in zip(cts1, cts2)]
    outs = bootstrap_raw_batch(ctx, bk, torch.stack([i[0] for i in inputs]),
                               [i[1] for i in inputs])
    return [eval_not(ctx, o) if i[2] else o for o, i in zip(outs, inputs)]


def eval_not(ctx: BinFHEContext, ct: LWECiphertext) -> LWECiphertext:
    """NOT without bootstrapping (EvalNOT)."""
    q = ct.modulus
    return LWECiphertext((-ct.a) % q, (q // 4 - ct.b) % q, q)


# Multi-input gates (the ciphertext-vector EvalBinGate,
# binfhe-base-scheme.cpp:126-177): arity, input plaintext modulus p (encrypt
# the inputs at q/p with encrypt_zp) and the phase offset cnum*q/cden; the
# output is the standard q/4 bit encoding.
MULTI_GATES = {
    "MAJORITY": (3, 4, -3, 8),
    "AND3": (3, 6, -5, 12),
    "OR3": (3, 6, -1, 12),
    "AND4": (4, 8, -7, 16),
    "OR4": (4, 8, -1, 16),
}


def eval_gate_vec(ctx: BinFHEContext, gate: str, bk: BootstrapKey,
                  cts: list) -> LWECiphertext:
    """A multi-input gate over a ciphertext vector."""
    return eval_gate_vec_batch(ctx, gate, bk, [cts])[0]


def eval_gate_vec_batch(ctx: BinFHEContext, gate: str, bk: BootstrapKey,
                        batches: list) -> list:
    """Multi-input gates, one blind rotation for the whole batch (two for
    CMUX); ``batches`` is a list of ciphertext lists, all the same gate."""
    if gate == "CMUX":
        return _cmux_batch(ctx, bk, batches)
    arity, _p, cnum, cden = MULTI_GATES[gate]
    q = ctx.params.q
    a_rows, b_rows = [], []
    for cts in batches:
        if len(cts) != arity:
            raise ValueError(f"{gate} takes exactly {arity} inputs")
        for i in range(len(cts)):
            for j in range(i + 1, len(cts)):
                if cts[i] is cts[j]:
                    raise ValueError(
                        "input ciphertexts must be independent "
                        "(reference: EvalBinGate config_error)")
        a = torch.zeros_like(cts[0].a)
        b = 0
        for ct in cts:
            a = (a + ct.a) % q
            b = (b + ct.b) % q
        a_rows.append(a)
        b_rows.append((b + cnum * q // cden) % q)
    return bootstrap_raw_batch(ctx, bk, torch.stack(a_rows), b_rows)


def _cmux_batch(ctx: BinFHEContext, bk: BootstrapKey,
                triples: list) -> list:
    """CMUX(d0, d1, sel) = NAND(NAND(d0, NOT sel), NAND(d1, sel))
    (binfhe-base-scheme.cpp:169-176) over a batch of (d0, d1, sel): the
    inner NANDs of every triple in one blind rotation, the outer ones in
    another. Each output equals eval_cmux on its triple alone."""
    k = len(triples)
    inner = eval_gate_batch(
        ctx, "NAND", bk, [t[0] for t in triples] + [t[1] for t in triples],
        [eval_not(ctx, t[2]) for t in triples] + [t[2] for t in triples])
    return eval_gate_batch(ctx, "NAND", bk, inner[:k], inner[k:])


def eval_cmux(ctx: BinFHEContext, bk: BootstrapKey, ct0: LWECiphertext,
              ct1: LWECiphertext, sel: LWECiphertext) -> LWECiphertext:
    """d1 if sel else d0, for the standard q/4 bit encoding."""
    return _cmux_batch(ctx, bk, [(ct0, ct1, sel)])[0]


def bootstrap(ctx: BinFHEContext, bk: BootstrapKey,
              ct: LWECiphertext) -> LWECiphertext:
    """Refresh a ciphertext (Bootstrap): w = 2*ct - q/8 maps {0, q/4} to
    {-q/8, 3q/8}, keeping the bit."""
    q = ctx.params.q
    return bootstrap_raw(ctx, bk, (2 * ct.a) % q, (2 * ct.b - q // 8) % q)


# ---------------------------------------------------------------------------
# Arbitrary-function bootstrapping over Z_p (BinFHEContext::EvalFunc for
# negacyclic LUTs, binfhe-base-scheme.cpp:241-349)
# ---------------------------------------------------------------------------


def _tv_tensor(ctx: BinFHEContext, tv: Sequence[int]) -> torch.Tensor:
    """A test polynomial built in Python ints (f(x) * Q passes 2^63 once Q
    and the output modulus are wide) as one int64 tensor of residues."""
    return torch.tensor([int(t) for t in tv], dtype=torch.int64,
                        device=ctx.device)


def eval_func(ctx: BinFHEContext, bk, ct: LWECiphertext, lut,
              p: int) -> LWECiphertext:
    """Programmable bootstrapping: out encrypts lut[m] for input message m,
    for NEGACYCLIC tables (lut[(m + p/2) % p] == -lut[m] mod p): the test
    polynomial t_k = f(p - k*p/(2N)) * Q/p, blind-rotated by the phase."""
    pp = ctx.params
    N, Q, q = pp.N, pp.Q, pp.q
    half = p // 2
    for m in range(half):
        assert (lut[(m + half) % p] + lut[m]) % p == 0, \
            "lut must be negacyclic; compose eval_func twice otherwise"
    tv = [(lut[(p - int(np.rint(k * p / (2.0 * N)))) % p] * Q // p) % Q
          for k in range(N)]
    f = (2 * N) // q     # exponent scale when the gate modulus q < 2N
    acc = _bootstrap_core_tv(ctx, bk, (ct.a * f)[None, :] % (2 * N),
                             [(ct.b * f) % (2 * N)], _tv_tensor(ctx, tv))
    return _extract_and_keyswitch_offset(ctx, bk, acc, offset=0)[0]


def eval_sign(ctx: BinFHEContext, bk, ct: LWECiphertext,
              p: int) -> LWECiphertext:
    """Sign of a centered Z_p message: 1 for m in (0, p/2), p-1 for
    m in (p/2, p) (EvalSign's single-digit core)."""
    lut = [0] + [1] * (p // 2 - 1) + [0] + [p - 1] * (p // 2 - 1)
    return eval_func(ctx, bk, ct, lut, p)


# ---------------------------------------------------------------------------
# Large precision: EvalFloor, the large EvalSign and EvalDecomp
# (binfhe-base-scheme.cpp:316-483): a ciphertext at a large power-of-two
# modulus is processed in log2(2N)-bit chunks by pairs of negacyclic
# phase-domain bootstraps
# ---------------------------------------------------------------------------


def _bootstrap_phase_func(ctx: BinFHEContext, bk, ct: LWECiphertext, f,
                          out_mod: int) -> LWECiphertext:
    """PBS computing f(phase mod 2N) at output modulus out_mod, where f is
    negacyclic over [0, 2N): f(x + N) == -f(x) mod out_mod (BootstrapFunc's
    test vector). ct.modulus must be a multiple of 2N, so truncation keeps
    the phase mod 2N."""
    p = ctx.params
    N, Q = p.N, p.Q
    assert ct.modulus % (2 * N) == 0, "modulus must be a multiple of 2N"
    for x in range(N):
        assert (f(x) + f(x + N)) % out_mod == 0, "f must be negacyclic"
    # tv_0 = f(0), tv_k = -f(N - k): const(tv * X^phase) = f(phase)
    tv = [f(0) * Q // out_mod % Q] + [(-(f(N - k) * Q // out_mod)) % Q
                                      for k in range(1, N)]
    acc = _bootstrap_core_tv(ctx, bk, ct.a[None, :] % (2 * N),
                             [ct.b % (2 * N)], _tv_tensor(ctx, tv))
    return _extract_and_keyswitch_offset(ctx, bk, acc, offset=0,
                                         out_mod=out_mod)[0]


def _lwe_sub(x: LWECiphertext, y: LWECiphertext) -> LWECiphertext:
    mod = x.modulus
    return LWECiphertext((x.a - y.a) % mod, (x.b - y.b) % mod, mod)


def eval_floor(ctx: BinFHEContext, bk, ct: LWECiphertext,
               beta: int) -> LWECiphertext:
    """Clear the low log2(2N) bits of the phase (EvalFloor,
    binfhe-base-scheme.cpp:316-354): out ~ (m + beta) - ((m + beta) mod 2N)
    at the same large modulus; beta bounds the accumulated noise."""
    q = 2 * ctx.params.N       # the chunk modulus (the reference's q)
    mod = ct.modulus
    ct1 = LWECiphertext(ct.a.clone(), (ct.b + beta) % mod, mod)

    def f1(x):   # +-q/4 by the half of (phase mod q)
        return (mod - (q >> 2)) if x < (q >> 1) else (q >> 2)

    ct1 = _lwe_sub(ct1, _bootstrap_phase_func(ctx, bk, ct1, f1, mod))

    def f2(x):   # identity on the centered range, reflections outside
        if x < (q >> 2):
            return (mod - (q >> 1) - x) % mod
        if x < 3 * (q >> 2):
            return x
        return (mod + (q >> 1) - x) % mod

    return _lwe_sub(ct1, _bootstrap_phase_func(ctx, bk, ct1, f2, mod))


def eval_sign_large(ctx: BinFHEContext, bk, ct: LWECiphertext,
                    beta: int) -> LWECiphertext:
    """Large-precision sign (the EvalSign loop, binfhe-base-scheme.cpp:
    356-429): floor away low chunks until the modulus fits one PBS, then a
    sign bootstrap. Returns an LWE at modulus 2N encrypting 0 if
    phase < modulus/2 else 1 (at scale q/2)."""
    q = 2 * ctx.params.N
    mod = ct.modulus
    cttmp = ct
    while mod > q:
        cttmp = eval_floor(ctx, bk, cttmp, beta)
        mod = mod * 2 * beta // q
        cttmp = _mod_switch_lwe(cttmp, mod)
    if mod < q:  # scale up exactly (power-of-two factors)
        factor = q // mod
        cttmp = LWECiphertext((cttmp.a * factor) % q, (cttmp.b * factor) % q,
                              q)
    cttmp = LWECiphertext(cttmp.a, (cttmp.b + beta) % q, q)

    def f3(x):
        return (q >> 2) if x < (q >> 1) else (q - (q >> 2))

    out = _bootstrap_phase_func(ctx, bk, cttmp, f3, q)
    # the phase is +-q/4; shift to {q/2, 0} so decrypt_zp(..., 2) reads it
    return LWECiphertext((-out.a) % q, ((q >> 2) - out.b) % q, q)


def eval_decomp(ctx: BinFHEContext, bk, ct: LWECiphertext,
                beta: int) -> list:
    """Digit decomposition of a large-precision phase (EvalDecomp,
    binfhe-base-scheme.cpp:431-483): LWE ciphertexts at modulus q = 2N, the
    first encrypting (phase mod q), each later one the floored carry scaled
    by 2*beta."""
    q = 2 * ctx.params.N
    mod = ct.modulus
    cttmp = ct
    out = []
    while mod > q:
        out.append(LWECiphertext(cttmp.a % q, cttmp.b % q, q))
        cttmp = eval_floor(ctx, bk, cttmp, beta)
        mod = mod * 2 * beta // q
        cttmp = _mod_switch_lwe(cttmp, mod)
    out.append(cttmp)
    return out


# ---------------------------------------------------------------------------
# LMKCDEY blind rotation (rgsw-acc-lmkcdey.cpp, eprint 2022/198): n RGSW
# keys of X^{s_i} and two automorphism keys; the rotation exponents are
# walked along the orbit of X -> X^5. The JAX package turns the reference's
# data-dependent loop into a fixed host-built schedule per ciphertext
# (numAutoKeys fixed at 1: 2*(N/2 - 1) + 1 automorphisms and n external
# products, padded with no-ops); here each step of it is a few launches.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LMKCDEYKey:
    """``ek`` [n, 2, 2*dg, 1, N] RGSW(X^{s_i}), ``ak`` [2, 2, dg, 1, N] the
    key-switch keys of sigma_5 (0) and sigma_{2N-5} (1), both halves of
    each digit as contiguous slabs (module docstring), and the LWE
    key-switch key, all int64 on the device."""

    ek: torch.Tensor
    ak: torch.Tensor
    ks_a: torch.Tensor
    ks_b: torch.Tensor


_LMK_GEN = 5


def _auto_perm_sign(N: int, t: int):
    """Coefficient-domain automorphism X^j -> X^{j t mod 2N}: (dst [N],
    sign [N]) with out[dst[j]] = sign[j] * in[j]."""
    e = (np.arange(N, dtype=np.int64) * t) % (2 * N)
    return np.where(e < N, e, e - N), np.where(e < N, 1, -1)


@lru_cache(maxsize=None)
def _auto_gather(N: int, t: int, device: torch.device):
    """(src, negate) on the device: out[j] = -in[src[j]] where negate[j],
    else in[src[j]] (the inverse of _auto_perm_sign's map)."""
    dst, sgn = _auto_perm_sign(N, t)
    src = np.empty(N, dtype=np.int64)
    src[dst] = np.arange(N)
    neg = np.empty(N, dtype=bool)
    neg[dst] = sgn < 0
    return (torch.from_numpy(src).to(device), torch.from_numpy(neg).to(device))


def _apply_auto_np_free(rows: torch.Tensor, t: int, Q: int) -> torch.Tensor:
    """The automorphism X -> X^t of residue rows [..., N] mod Q, on the
    rows' device: the key's sigma_t(z), the free initial step (c1 = 0) and
    each automorphism step's permutation of both halves."""
    src, neg = _auto_gather(rows.shape[-1], t, rows.device)
    x = rows.index_select(-1, src)
    return torch.where(neg, neg_mod(x, Q), x)


def _lmk_dlog_table(N: int) -> dict:
    """dlog base 5 over the odd residues of Z_2N: class +k for 5^k, -k for
    -5^k (k in [0, N/2)), 2N (the sentinel) for -1."""
    M = 2 * N
    table = {}
    pw = 1
    for k in range(N // 2):
        table[pw] = k
        table[M - pw] = -k if k > 0 else M
        pw = pw * _LMK_GEN % M
    return table


def bootstrap_keygen_lmkcdey(ctx: BinFHEContext, sk: BinFHESecret,
                             rng: np.random.Generator) -> LMKCDEYKey:
    """(role of RingGSWAccumulatorLMKCDEY::KeyGenAcc + KeyGenAuto). Draws:
    the RGSW rows of X^{s_i} [n, 2dg], then the automorphism keys for
    t = 5 and t = 2N - 5 [dg] each, then the LWE key-switch key."""
    p = ctx.params
    N, Q, n, dg = p.N, p.Q, p.n_lwe, p.dg
    mod = _mod(ctx)
    z_eval = _z_eval(ctx, sk)
    # ek_i = RGSW(X^{s_i mod 2N}): the DM slab construction at v = s_i
    xc = _rows(ctx, _monomial_eval_np(ctx))[_rows(ctx, sk.s_lwe % (2 * N))]
    powers = _rows(ctx, [(1 << (p.log_bg * d)) % Q for d in range(dg)])
    # Q < 2^31 for LMKCDEY, so the products fit int64
    first = (xc[:, None, :] * powers[None, :, None]) % Q        # [n, dg, N]
    msgs = torch.cat([first, mul_mod(first, z_eval, mod)], dim=1)
    c0, c1 = _rlwe_encrypt_batch(ctx, z_eval, msgs, (n, 2 * dg), rng)
    ek = torch.stack([c0, c1], dim=1)[:, :, :, None, :]
    # automorphism keys: row d encrypts B_g^d * sigma_t(z) under z
    z = _rows(ctx, sampling.signed_to_rns_rows(sk.z_ring, (Q,))
              .view(np.int64))                                   # [1, N]
    ak = []
    for t in (_LMK_GEN, 2 * N - _LMK_GEN):
        zt = _ntt_nd(_apply_auto_np_free(z, t, Q), Q)[0]
        msgs_t = mul_mod(powers[:, None].expand(dg, N), zt, mod)  # [dg, N]
        kc0, kc1 = _rlwe_encrypt_batch(ctx, z_eval, msgs_t, (dg,), rng)
        ak.append(torch.stack([kc0, kc1]))                        # [2, dg, N]
    ak = torch.stack(ak)[:, :, :, None, :]
    ks_a, ks_b = _keyswitch_keygen(ctx, sk, rng)
    return LMKCDEYKey(ek, ak, ks_a, ks_b)


def _lmk_schedule(ctx: BinFHEContext, a_vec) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """The fixed schedule of one ciphertext, built on the host: ops [T]
    (0 external product, 1 automorphism by 5, 2 by 2N - 5, 3 no-op) and idx
    [T] (the ek row of each external product); the reference's EvalAcc
    control flow with numAutoKeys = 1, padded to T = 2*(N/2 - 1) + 1 + n."""
    p = ctx.params
    N = p.N
    M = 2 * N
    Nh = N // 2
    dlog = _lmk_dlog_table(N)
    neg, pos, cls0, clsM = {}, {}, [], []
    for i, a in enumerate(np.asarray(a_vec, dtype=np.int64) % M):
        k = dlog[int((M - a) % M) | 1]
        if k == M:
            clsM.append(i)
        elif k == 0:
            cls0.append(i)
        elif k > 0:
            pos.setdefault(k, []).append(i)
        else:
            neg.setdefault(-k, []).append(i)
    ops, idx = [], []

    def ext(lst):
        ops.extend([0] * len(lst))
        idx.extend(lst)

    for i in range(Nh - 1, 0, -1):
        ext(neg.get(i, []))
        ops.append(1)
        idx.append(0)
    ext(clsM)
    ops.append(2)
    idx.append(0)
    for i in range(Nh - 1, 0, -1):
        ext(pos.get(i, []))
        ops.append(1)
        idx.append(0)
    ext(cls0)
    T = 2 * (Nh - 1) + 1 + p.n_lwe
    ops += [3] * (T - len(ops))
    idx += [0] * (T - len(idx))
    assert len(ops) == T
    return np.asarray(ops, np.int32), np.asarray(idx, np.int32)


def _blind_rotate_lmk(ctx: BinFHEContext, bk: LMKCDEYKey, acc: torch.Tensor,
                      ops: np.ndarray, idx: np.ndarray) -> torch.Tensor:
    """One ciphertext's schedule over acc [2, 1, N] (coefficients). An
    external product replaces acc by acc (*) ek[j]; an automorphism permutes
    both halves and key-switches the permuted c1 back under z: acc =
    (c0' + ks_0, ks_1) with ks = sum_d digit_d(c1') * ak[which, :, d]."""
    p = ctx.params
    N, Q = p.N, p.Q
    mod, row_mod = _mod(ctx), _row_mod(ctx, 1)
    decompose = _make_signed_decompose(p)
    auto_t = (_LMK_GEN, 2 * N - _LMK_GEN)
    for op, j in zip(ops.tolist(), idx.tolist()):
        if op == 0:
            digits = _ntt_nd(decompose(acc), Q)                  # [2dg, 1, N]
            ext = elementwise.ks_inner_product(
                digits, bk.ek[j, 0], bk.ek[j, 1], (0,), row_mod)
            acc = _ntt_nd(ext, Q, inverse=True)
        elif op in (1, 2):
            perm = _apply_auto_np_free(acc, auto_t[op - 1], Q)
            digits = _ntt_nd(decompose(perm[1:]), Q)             # [dg, 1, N]
            key = bk.ak[op - 1]
            ks = _ntt_nd(elementwise.ks_inner_product(
                digits, key[0], key[1], (0,), row_mod), Q, inverse=True)
            acc = torch.stack([add_mod(perm[0], ks[0], Q), ks[1]])
    return acc


def _bootstrap_core_lmk(ctx: BinFHEContext, bk: LMKCDEYKey,
                        a_2n: torch.Tensor, b_2n: Sequence[int],
                        tv: torch.Tensor) -> torch.Tensor:
    """Blind-rotate tv along the automorphism orbit, one ciphertext at a
    time (each has its own schedule); returns the accumulator [2, B, N]."""
    p = ctx.params
    c0 = _rotate_test_vector(ctx, tv, b_2n)                       # [B, N]
    # the free initial automorphism by 2N - g (c1 = 0)
    c0 = _apply_auto_np_free(c0, 2 * p.N - _LMK_GEN, p.Q)
    a_host = a_2n.cpu().numpy()
    outs = []
    for bi in range(c0.shape[0]):
        acc = torch.stack([c0[bi:bi + 1], torch.zeros_like(c0[bi:bi + 1])])
        outs.append(_blind_rotate_lmk(ctx, bk, acc,
                                      *_lmk_schedule(ctx, a_host[bi])))
    return torch.cat(outs, dim=1)
