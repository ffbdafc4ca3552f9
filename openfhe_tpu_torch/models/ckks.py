"""CKKS over RNS towers.

Counterpart of ``openfhe_tpu/models/ckks.py``, the whole module: context
generation with the 60-bit or the composite (~30-bit, ``composite_degree=2``)
modulus chain, ternary-secret keygen, public-key encryption, add/sub/mult,
relinearization, hoisted rotation and conjugation (with a shareable digit
precompute) by hybrid key switching, plaintext-operand ops, FIXEDMANUAL
rescaling, level reduction and compression, complex packed encode/decode
(``encoding``, host numpy) and INDCPA^D noise-flooding decryption.

The context carries its torch device; every tensor of its keys and
ciphertexts lives there. Randomness is the caller's numpy Generator, drawn in
the JAX package's order, so keys and ciphertexts are bit-equal to its own
for the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .. import _build, dcrt, encoding, keyswitch
from ..dcrt import Format, RnsBasis, RnsPoly
from ..ops import rns
from ..utils import nbtheory, sampling, security


@dataclasses.dataclass(frozen=True)
class CKKSParams:
    """User-facing configuration, the JAX package's CKKSParams.

    Noise-flooding decryption (NOISE_FLOODING_DECRYPT) is two-phase: run
    with execution_mode="NOISE_ESTIMATION", measure the result's log-error
    with estimate_log_error(), then rebuild the context with
    execution_mode="EVALUATION" and that noise_estimate; decryption then
    floods the phase with sigma = 2^(statistical_security/2 +
    log2(sqrt(12 * num_adversarial_queries)) + noise_estimate)."""

    ring_dim: int = 1 << 12
    mult_depth: int = 2
    scaling_mod_size: int = 50
    first_mod_size: int = 60
    dnum: int = 3           # hybrid keyswitch digit count
    sigma: float = 3.19
    secret_hw: int = 0      # 0 = dense uniform ternary; else sparse weight
    security_level: str = "HEStd_NotSet"
    scaling_technique: str = "FIXEDMANUAL"
    composite_degree: int = 1
    decryption_noise_mode: str = "FIXED_NOISE_DECRYPT"
    execution_mode: str = "EVALUATION"  # or "NOISE_ESTIMATION"
    noise_estimate: float = 0.0         # log2 units, from phase 1
    statistical_security: float = 30.0
    num_adversarial_queries: float = 1.0

    @property
    def flood_decrypt_sigma(self) -> float:
        """Decryption flooding stddev; 0 when flooding is off."""
        if (self.decryption_noise_mode != "NOISE_FLOODING_DECRYPT"
                or self.execution_mode != "EVALUATION"):
            return 0.0
        logstd = (self.statistical_security / 2
                  + np.log2(np.sqrt(12 * self.num_adversarial_queries)))
        return float(2.0 ** (logstd + self.noise_estimate))

    @property
    def num_towers(self) -> int:
        extra = 1 if self.scaling_technique == "FLEXIBLEAUTOEXT" else 0
        return (self.mult_depth + 1 + extra) * self.composite_degree

    @property
    def num_slots(self) -> int:
        return self.ring_dim // 2


@dataclasses.dataclass(frozen=True)
class CKKSContext:
    params: CKKSParams
    q_moduli: Tuple[int, ...]
    p_moduli: Tuple[int, ...]
    device: torch.device

    @property
    def n(self) -> int:
        return self.params.ring_dim

    @property
    def scale(self) -> float:
        return float(2 ** self.params.scaling_mod_size)

    @property
    def ks_params(self) -> keyswitch.KSParams:
        alpha = -(-len(self.q_moduli) // self.params.dnum)
        return keyswitch.KSParams(self.n, self.q_moduli, self.p_moduli, alpha)

    def basis(self, towers: int | None = None) -> RnsBasis:
        towers = len(self.q_moduli) if towers is None else towers
        return RnsBasis(self.n, self.q_moduli[:towers])

    @property
    def full_qp_basis(self) -> RnsBasis:
        return RnsBasis(self.n, self.q_moduli + self.p_moduli)


def _composite_chain(params: CKKSParams, m: int):
    """Composite chain: each level's 2^p is the product of `d` NTT primes of
    ~p/d bits, alternating below/above their targets (every prime < 2^31)."""
    d = params.composite_degree

    def split_bits(total):
        b = total // d
        parts = [b] * (d - 1) + [total - b * (d - 1)]
        if not all(20 <= p <= 30 for p in parts):
            raise ValueError(f"composite parts {parts} must be 20..30 bits "
                             f"(scaling_mod_size={total}, degree={d})")
        return parts

    used: set = set()
    cursors: dict = {}

    def take_prime(bits: int, below_first: bool) -> int:
        st = cursors.setdefault(bits, [1 << bits, 1 << bits, below_first])
        while True:
            if st[2]:
                st[0] = nbtheory.prev_ntt_prime_below(st[0], m)
                cand = st[0]
            else:
                st[1] = nbtheory.next_ntt_prime_above(st[1], m)
                cand = st[1]
            st[2] = not st[2]
            if cand not in used:
                used.add(cand)
                return cand

    qs = []
    extra = 1 if params.scaling_technique == "FLEXIBLEAUTOEXT" else 0
    for level in range(params.mult_depth + 1 + extra):
        bits = params.first_mod_size if level == 0 else params.scaling_mod_size
        for i, part in enumerate(split_bits(bits)):
            qs.append(take_prime(part, below_first=(i % 2 == 0)))
    return qs, used


def gen_context(params: CKKSParams, device=None) -> CKKSContext:
    """Build the modulus chain (same primes as the JAX package's
    gen_context): scaling primes alternate just below/above
    2^scaling_mod_size, special primes scan down from 2^60 (2^30 for a
    composite chain). The context lives on `device`; None means the current
    CUDA device, and without one this raises (pass device="cpu" to run on
    the CPU)."""
    device = _build.resolve_device(device)
    n = params.ring_dim
    m = 2 * n
    L = params.num_towers
    if params.decryption_noise_mode == "NOISE_FLOODING_DECRYPT" and \
            params.execution_mode == "EVALUATION":
        if params.noise_estimate == 0:
            raise ValueError(
                "noise_estimate must be set (run execution_mode="
                "'NOISE_ESTIMATION' first) for NOISE_FLOODING_DECRYPT "
                "EVALUATION contexts")
        logstd = (params.statistical_security / 2
                  + np.log2(np.sqrt(12 * params.num_adversarial_queries)))
        if logstd + params.noise_estimate > params.scaling_mod_size - 3:
            raise ValueError(
                f"precision of less than 3 bits is not supported: logstd "
                f"{logstd:.1f} + noise_estimate {params.noise_estimate:.1f} "
                f"must be <= scaling_mod_size - 3 = "
                f"{params.scaling_mod_size - 3}")
    if params.composite_degree > 1:
        if params.scaling_technique not in ("FIXEDMANUAL", "FIXEDAUTO"):
            raise ValueError("composite scaling supports FIXEDMANUAL and "
                             "FIXEDAUTO")
        qs, used = _composite_chain(params, m)
        sp_bits = 30
    else:
        q0 = nbtheory.first_prime(params.first_mod_size, m)
        used = {q0}
        qs = [q0]
        lo_cursor = hi_cursor = 1 << params.scaling_mod_size
        below = True
        while len(qs) < L:
            if below:
                lo_cursor = nbtheory.prev_ntt_prime_below(lo_cursor, m)
                while lo_cursor in used:
                    lo_cursor = nbtheory.prev_ntt_prime_below(lo_cursor, m)
                qs.append(lo_cursor)
                used.add(lo_cursor)
            else:
                hi_cursor = nbtheory.next_ntt_prime_above(hi_cursor, m)
                while hi_cursor in used:
                    hi_cursor = nbtheory.next_ntt_prime_above(hi_cursor, m)
                qs.append(hi_cursor)
                used.add(hi_cursor)
            below = not below
        sp_bits = 60
    alpha = -(-L // params.dnum)
    ps = []
    cursor = nbtheory.first_prime(sp_bits, m)
    while len(ps) < alpha:
        while cursor in used:
            cursor = nbtheory.previous_prime(cursor, m)
        ps.append(cursor)
        used.add(cursor)
        cursor = nbtheory.previous_prime(cursor, m)
    log_qp = sum(q.bit_length() for q in qs) + sum(p.bit_length() for p in ps)
    security.validate(n, log_qp, params.security_level)
    return CKKSContext(params, tuple(qs), tuple(ps), device)


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SecretKey:
    coeffs: np.ndarray  # ternary, int64, host
    _cache: dict = dataclasses.field(default_factory=dict)

    def poly(self, basis: RnsBasis, device) -> RnsPoly:
        """EVAL-form secret over `basis` on `device` (cached)."""
        key = (basis, str(torch.device(device)))
        if key not in self._cache:
            rows = sampling.signed_to_rns_rows(self.coeffs, basis.moduli)
            p = dcrt.from_int_rows(basis, rows, Format.COEFF, device)
            self._cache[key] = dcrt.to_eval(p)
        return self._cache[key]


@dataclasses.dataclass
class PublicKey:
    b: RnsPoly  # -a*s + e  (EVAL, full Q)
    a: RnsPoly


@dataclasses.dataclass(frozen=True)
class Ciphertext:
    """Tuple of EVAL-form polys over a Q-prefix basis, with its scale."""

    polys: Tuple[RnsPoly, ...]
    scale: float

    @property
    def basis(self) -> RnsBasis:
        return self.polys[0].basis

    @property
    def towers(self) -> int:
        return self.basis.L


def _sample_error_poly(ctx: CKKSContext, basis: RnsBasis,
                       rng: np.random.Generator) -> RnsPoly:
    rows = sampling.signed_to_rns_rows(
        sampling.gaussian_coeffs(ctx.n, rng, ctx.params.sigma), basis.moduli)
    return dcrt.to_eval(dcrt.from_int_rows(basis, rows, Format.COEFF,
                                           ctx.device))


def keygen(ctx: CKKSContext, rng: np.random.Generator
           ) -> Tuple[PublicKey, SecretKey]:
    """Secret (ternary), then uniform `a`, then the error."""
    n = ctx.n
    hw = ctx.params.secret_hw
    coeffs = sampling.sparse_ternary_coeffs(n, hw, rng) if hw else \
        sampling.ternary_coeffs(n, rng)
    sk = SecretKey(coeffs)
    basis = ctx.basis()
    s = sk.poly(basis, ctx.device)
    a = dcrt.from_int_rows(basis, sampling.uniform_rns_rows(
        n, basis.moduli, rng), Format.EVAL, ctx.device)
    e = _sample_error_poly(ctx, basis, rng)
    return PublicKey(dcrt.sub(e, dcrt.mul(a, s)), a), sk


def relin_keygen(ctx: CKKSContext, sk: SecretKey,
                 rng: np.random.Generator) -> keyswitch.KSKey:
    """Key for s^2 -> s."""
    s = sk.poly(ctx.full_qp_basis, ctx.device)
    return keyswitch.keygen(ctx.ks_params, s, dcrt.mul(s, s), rng,
                            ctx.params.sigma)


def rotation_indices_to_galois(n: int, rot: int) -> int:
    """Slot rotation by `rot` -> Galois element 5^rot mod 2n."""
    return pow(5, rot % (n // 2), 2 * n)


def rot_keygen(ctx: CKKSContext, sk: SecretKey, rotations: Sequence[int],
               rng: np.random.Generator) -> Dict[int, keyswitch.KSKey]:
    """Keys for sigma_k(s) -> s, one per requested slot rotation, made in
    one batch (keyswitch.keygen_batch)."""
    rotations = list(rotations)
    if not rotations:
        return {}
    s = sk.poly(ctx.full_qp_basis, ctx.device)
    s_rots = [dcrt.automorphism(s, rotation_indices_to_galois(ctx.n, r))
              for r in rotations]
    keys = keyswitch.keygen_batch(ctx.ks_params, s, s_rots, rng,
                                  ctx.params.sigma)
    return dict(zip(rotations, keys))


def conj_keygen(ctx: CKKSContext, sk: SecretKey,
                rng: np.random.Generator) -> keyswitch.KSKey:
    """Key for sigma_{2n-1}(s) -> s (complex conjugation of the slots)."""
    s = sk.poly(ctx.full_qp_basis, ctx.device)
    return keyswitch.keygen(ctx.ks_params, s,
                            dcrt.automorphism(s, 2 * ctx.n - 1), rng,
                            ctx.params.sigma)


# ---------------------------------------------------------------------------
# Encode / encrypt / decrypt
# ---------------------------------------------------------------------------


def encode(ctx: CKKSContext, values: Sequence[complex],
           towers: int | None = None, scale: float | None = None) -> RnsPoly:
    """Complex slots -> EVAL-form plaintext poly."""
    basis = ctx.basis(towers)
    coeffs = encoding.ckks_encode(values, ctx.n, scale or ctx.scale)
    rows = sampling.signed_to_rns_rows(coeffs, basis.moduli)
    return dcrt.to_eval(dcrt.from_int_rows(basis, rows, Format.COEFF,
                                           ctx.device))


def encrypt(ctx: CKKSContext, pk: PublicKey, values: Sequence[complex],
            rng: np.random.Generator) -> Ciphertext:
    """Public-key encryption: draws v (ternary), then e0, then e1."""
    basis = ctx.basis()
    m = encode(ctx, values)
    scale = ctx.scale
    if ctx.params.scaling_technique == "FLEXIBLEAUTOEXT":
        m = dcrt.mul_scalar_int(m, 1 << ctx.params.scaling_mod_size)
        scale = ctx.scale * ctx.scale
    v_rows = sampling.signed_to_rns_rows(sampling.ternary_coeffs(ctx.n, rng),
                                         basis.moduli)
    v = dcrt.to_eval(dcrt.from_int_rows(basis, v_rows, Format.COEFF,
                                        ctx.device))
    e0 = _sample_error_poly(ctx, basis, rng)
    e1 = _sample_error_poly(ctx, basis, rng)
    c0 = dcrt.add(dcrt.mul_add(pk.b, v, e0), m)
    c1 = dcrt.mul_add(pk.a, v, e1)
    return Ciphertext((c0, c1), scale)


def decrypt_poly(ctx: CKKSContext, sk: SecretKey, ct: Ciphertext) -> RnsPoly:
    """m' = sum_i c_i s^i over the ciphertext's basis (EVAL)."""
    s = sk.poly(ct.basis, ctx.device)
    acc = ct.polys[0]
    s_pow = s
    for c in ct.polys[1:]:
        acc = dcrt.mul_add(c, s_pow, acc)
        s_pow = dcrt.mul(s_pow, s)
    return acc


def crt_interpolate_centered(rows, moduli: Tuple[int, ...]) -> np.ndarray:
    """Host: RNS rows [L, n] -> centered big-int coefficients (exact, as an
    object array of Python ints)."""
    Q = 1
    for q in moduli:
        Q *= q
    x = np.zeros(len(rows[0]), dtype=object)
    for i, q in enumerate(moduli):
        qh = Q // q
        x = x + np.asarray(rows[i]).astype(object) * (qh * pow(qh % q, -1, q))
    x = x % Q
    return np.where(x > Q // 2, x - Q, x)


def decrypt(ctx: CKKSContext, sk: SecretKey, ct: Ciphertext,
            num_slots: int | None = None,
            rng: np.random.Generator | None = None) -> np.ndarray:
    """Decrypt and decode to complex slots (host CRT interpolation). In
    NOISE_FLOODING_DECRYPT EVALUATION mode the phase is flooded with
    rounded Gaussian noise of ctx.params.flood_decrypt_sigma, drawn from
    `rng` (a fresh Generator when None) after the phase is computed."""
    m_eval = decrypt_poly(ctx, sk, ct)
    flood_sigma = ctx.params.flood_decrypt_sigma
    if flood_sigma:
        rng = np.random.default_rng() if rng is None else rng
        mags = np.rint(rng.normal(0, flood_sigma, size=ctx.n)).astype(object)
        rows = sampling.signed_to_rns_rows(mags, ct.basis.moduli)
        m_eval = dcrt.add(m_eval, dcrt.to_eval(dcrt.from_int_rows(
            ct.basis, rows, Format.COEFF, ctx.device)))
    m_coeff = dcrt.to_coeff(m_eval)
    coeffs = crt_interpolate_centered(dcrt.to_int_rows(m_coeff),
                                      ct.basis.moduli)
    return encoding.ckks_decode(coeffs, ctx.n, ct.scale, num_slots)


def estimate_log_error(slots, scale: float) -> float:
    """log2 error of a decrypted NOISE_ESTIMATION-phase result over REAL
    inputs: the imaginary parts of the slots are pure noise; their stddev
    times the ciphertext's scale is the error in phase units. Feed the
    result into CKKSParams.noise_estimate of the EVALUATION context."""
    slots = np.asarray(slots)
    stddev = float(np.std(np.imag(slots))) * float(scale)
    stddev = max(stddev, 2.0 ** -40)
    return float(np.round(np.log2(stddev)))


# ---------------------------------------------------------------------------
# Homomorphic ops
# ---------------------------------------------------------------------------


def _align(ct1: Ciphertext, ct2: Ciphertext):
    assert ct1.basis == ct2.basis, "level mismatch (rescale first)"
    assert abs(ct1.scale - ct2.scale) / ct1.scale < 1e-9, "scale mismatch"


def _combine(ct1: Ciphertext, ct2: Ciphertext, op, lone) -> Ciphertext:
    _align(ct1, ct2)
    polys = []
    for i in range(max(len(ct1.polys), len(ct2.polys))):
        if i < len(ct1.polys) and i < len(ct2.polys):
            polys.append(op(ct1.polys[i], ct2.polys[i]))
        elif i < len(ct1.polys):
            polys.append(ct1.polys[i])
        else:
            polys.append(lone(ct2.polys[i]))
    return Ciphertext(tuple(polys), ct1.scale)


def eval_add(ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
    return _combine(ct1, ct2, dcrt.add, lambda p: p)


def eval_sub(ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
    return _combine(ct1, ct2, dcrt.sub, dcrt.neg)


def eval_mult(ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
    """Tensor product without relinearization (degree grows)."""
    _align(ct1, ct2)
    d1, d2 = len(ct1.polys), len(ct2.polys)
    out = [None] * (d1 + d2 - 1)
    for i in range(d1):
        for j in range(d2):
            a, b = ct1.polys[i], ct2.polys[j]
            out[i + j] = dcrt.mul(a, b) if out[i + j] is None else \
                dcrt.mul_add(a, b, out[i + j])
    return Ciphertext(tuple(out), ct1.scale * ct2.scale)


def relinearize(ct: Ciphertext, evk: keyswitch.KSKey) -> Ciphertext:
    """Reduce a degree-2 ciphertext back to 2 components."""
    assert len(ct.polys) == 3
    d0, d1 = keyswitch.apply(evk, ct.polys[2])
    return Ciphertext((dcrt.add(ct.polys[0], d0),
                       dcrt.add(ct.polys[1], d1)), ct.scale)


def eval_mult_relin(ct1: Ciphertext, ct2: Ciphertext,
                    evk: keyswitch.KSKey) -> Ciphertext:
    return relinearize(eval_mult(ct1, ct2), evk)


def eval_square_relin(ct: Ciphertext, evk: keyswitch.KSKey) -> Ciphertext:
    return relinearize(eval_mult(ct, ct), evk)


def rescale(ct: Ciphertext, degree: int = 1) -> Ciphertext:
    """Drop the last `degree` towers, dividing by each (FIXEDMANUAL). The
    polynomials are stacked, so each dropped tower costs one inverse and one
    forward NTT for the whole ciphertext."""
    data = torch.stack([p.data for p in ct.polys])          # [polys, L, n]
    basis, scale = ct.basis, ct.scale
    for _ in range(degree):
        assert basis.L >= 2, \
            "rescale needs at least 2 towers (increase mult_depth)"
        data = rns.rescale_eval(data, basis.moduli)
        scale = scale / basis.moduli[-1]
        basis = basis.drop_last()
    return Ciphertext(tuple(RnsPoly(d, basis, Format.EVAL) for d in data),
                      scale)


def rescale_ctx(ctx: CKKSContext, ct: Ciphertext) -> Ciphertext:
    """One logical rescale under the context's composite degree."""
    return rescale(ct, ctx.params.composite_degree)


def level_reduce(ct: Ciphertext, levels: int = 1) -> Ciphertext:
    """Drop the last `levels` towers without scaling."""
    if levels == 0:
        return ct
    basis = ct.basis.drop_last(levels)
    return Ciphertext(tuple(dcrt.make_poly(basis, p.data[:basis.L],
                                           Format.EVAL) for p in ct.polys),
                      ct.scale)


def compress(ctx: CKKSContext, ct: Ciphertext, towers_left: int | None = None
             ) -> Ciphertext:
    """Shrink the modulus before transmission or decryption: rescale a
    pending degree-2 scale away, then drop towers down to `towers_left`
    (default: the composite degree, the towers of the first level)."""
    if towers_left is None:
        towers_left = ctx.params.composite_degree
    while ct.scale > 1.5 * ctx.scale and ct.towers > towers_left:
        ct = rescale(ct)
    if ct.towers > towers_left:
        ct = level_reduce(ct, ct.towers - towers_left)
    return ct


def _hoisted_automorphism(ct: Ciphertext, k: int, key: keyswitch.KSKey,
                          digits: torch.Tensor) -> Ciphertext:
    """sigma_k of a ciphertext whose c1 is already decomposed: c0 is
    permuted, the digit stack is permuted and switched back to s."""
    c0 = dcrt.automorphism(ct.polys[0], k)
    d0, d1 = keyswitch.hoist_rotate_apply(key, digits, ct.basis, k)
    return Ciphertext((dcrt.add(c0, d0), d1), ct.scale)


def fast_rotation_precompute(ct: Ciphertext, any_key: keyswitch.KSKey
                             ) -> torch.Tensor:
    """The hoisted digit stack of c1 (EVAL over Q_l*P), shared by every
    eval_fast_rotate/eval_fast_conjugate of the same ciphertext; `any_key`
    gives the key-switching geometry (all keys of a context share it)."""
    assert len(ct.polys) == 2
    return keyswitch.hoist_decompose(any_key.params, ct.polys[1])


def eval_rotate(ct: Ciphertext, rot: int, rot_key: keyswitch.KSKey
                ) -> Ciphertext:
    """Rotate slots by `rot`: decompose c1 FIRST, then permute the digit
    stack (the JAX package's hoisted order, which fixes the bits)."""
    return eval_fast_rotate(ct, rot, rot_key,
                            fast_rotation_precompute(ct, rot_key))


def eval_fast_rotate(ct: Ciphertext, rot: int, rot_key: keyswitch.KSKey,
                     digits: torch.Tensor) -> Ciphertext:
    """Rotation by `rot` from a precomputed digit stack."""
    assert len(ct.polys) == 2
    return _hoisted_automorphism(
        ct, rotation_indices_to_galois(ct.basis.n, rot), rot_key, digits)


def eval_fast_conjugate(ct: Ciphertext, conj_key: keyswitch.KSKey,
                        digits: torch.Tensor) -> Ciphertext:
    """Conjugation (Galois element 2n-1) from a precomputed digit stack."""
    assert len(ct.polys) == 2
    return _hoisted_automorphism(ct, 2 * ct.basis.n - 1, conj_key, digits)


def eval_conjugate(ct: Ciphertext, conj_key: keyswitch.KSKey) -> Ciphertext:
    """Complex conjugation of the slots, in the same hoisted order."""
    return eval_fast_conjugate(ct, conj_key,
                               fast_rotation_precompute(ct, conj_key))


def eval_add_plain(ctx: CKKSContext, ct: Ciphertext,
                   values: Sequence[complex]) -> Ciphertext:
    """ct + values, encoded at the ciphertext's level and scale."""
    pt = encode(ctx, values, towers=ct.towers, scale=ct.scale)
    return Ciphertext((dcrt.add(ct.polys[0], pt),) + ct.polys[1:], ct.scale)


def eval_mult_plain(ctx: CKKSContext, ct: Ciphertext,
                    values: Sequence[complex]) -> Ciphertext:
    """ct * values, encoded at the ciphertext's level and the context's
    scale (no rescale)."""
    pt = encode(ctx, values, towers=ct.towers)
    return Ciphertext(tuple(dcrt.mul(p, pt) for p in ct.polys),
                      ct.scale * ctx.scale)
