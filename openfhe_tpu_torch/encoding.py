"""Plaintext encodings: CKKS, and BGV/BFV packed, coefficient and string.

The port's own copy of ``openfhe_tpu/encoding.py`` (same names and
signatures, same results). CKKS packed encoding: complex canonical embedding
via the special 2n-th root FFT (reference: ``CKKSPackedEncoding`` +
``DiscreteFourierTransform::FFTSpecial``,
``pke/lib/encoding/ckkspackedencoding.cpp:126,426``), realized here with
numpy FFTs on the host. Slot j holds the value of the plaintext polynomial
at zeta^(5^j), zeta = exp(i*pi/n).

The BGV/BFV packed encoding puts Z_t slots through a negacyclic NTT mod t
on the host. The JAX package runs it as a Python-int butterfly loop; here
each stage is one numpy operation over all its butterflies (t < 2^31 keeps
every product below 2^62 in int64), which gives the same residues.

Encoding/decoding are host-side (they sit at the user API boundary, not in
the homomorphic hot path).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

import numpy as np

from .ops.ntt import bit_reverse_perm
from .utils import nbtheory


@lru_cache(maxsize=None)
def _ckks_slot_exponents(n: int) -> np.ndarray:
    """Exponents e_j = 5^j mod 2n for j < n/2 (the CKKS slot order)."""
    exps = np.zeros(n // 2, dtype=np.int64)
    e = 1
    for j in range(n // 2):
        exps[j] = e
        e = e * 5 % (2 * n)
    return exps


def ckks_embed(coeffs: np.ndarray, n: int) -> np.ndarray:
    """Evaluate real-coefficient poly at zeta^(5^j): n coeffs -> n/2 slots."""
    c = np.zeros(2 * n, dtype=np.complex128)
    c[: len(coeffs)] = coeffs
    # ifft uses exp(+2*pi*i*k*e/(2n)); scale back by 2n
    evals = np.fft.ifft(c) * (2 * n)
    return evals[_ckks_slot_exponents(n)]


def ckks_embed_inv(slots: np.ndarray, n: int) -> np.ndarray:
    """Inverse canonical embedding: n/2 slots -> n real coefficients."""
    exps = _ckks_slot_exponents(n)
    V = np.zeros(2 * n, dtype=np.complex128)
    V[exps] = slots
    V[(2 * n - exps) % (2 * n)] = np.conj(slots)
    c = np.fft.fft(V)[:n].real / n
    return c


def ckks_encode(values: Sequence[complex], n: int, scale: float) -> np.ndarray:
    """Complex slot values -> integer coefficient vector (rounded).

    The same integers as the JAX package's ckks_encode. Where every rounded
    coefficient is below 2^62 in magnitude they come as an int64 array
    (a float64 integer converts to int64 exactly), which
    ``sampling.signed_to_rns_rows`` reduces in one vectorised pass; above
    that, as Python ints in an object array, as the JAX package returns
    them always. At n = 2^16 the object path costs ~65k Python ints here
    and T x 65k Python remainders in the reduction, per plaintext."""
    slots = np.zeros(n // 2, dtype=np.complex128)
    vals = np.asarray(values, dtype=np.complex128)
    assert len(vals) <= n // 2, "too many slots"
    slots[: len(vals)] = vals
    rounded = np.rint(ckks_embed_inv(slots, n) * scale)
    if np.all(np.abs(rounded) < 2.0 ** 62):
        return rounded.astype(np.int64)
    return np.asarray([int(v) for v in rounded], dtype=object)


def ckks_decode(coeffs: Sequence[int], n: int, scale: float,
                num_slots: int | None = None) -> np.ndarray:
    """Centered integer coefficients -> complex slot values (scaled down)."""
    cs = np.asarray([float(c) for c in coeffs])
    slots = ckks_embed(cs, n) / scale
    if num_slots is not None:
        slots = slots[:num_slots]
    return slots


# ---------------------------------------------------------------------------
# BGV/BFV packed encoding (slots via NTT mod t)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _packed_tables(n: int, t: int):
    """Negacyclic NTT tables mod t on the host (exact ints)."""
    assert (t - 1) % (2 * n) == 0, f"t={t} must be 1 mod 2n for packing"
    psi = nbtheory.root_of_unity(2 * n, t)
    psi_inv = pow(psi, -1, t)
    n_inv = pow(n, -1, t)
    return psi, psi_inv, n_inv


@lru_cache(maxsize=None)
def _powers_bitrev(root: int, t: int, n: int) -> np.ndarray:
    """root^rev(j) mod t for j < n (int64)."""
    if t >= 1 << 31:
        raise ValueError(f"plaintext modulus {t} above 2^31: products "
                         "would overflow int64")
    pw = [1] * n
    for j in range(1, n):
        pw[j] = pw[j - 1] * root % t
    return np.asarray(pw, dtype=np.int64)[bit_reverse_perm(n)]


def _host_ntt(vals, t: int, psi: int, n: int) -> List[int]:
    """Negacyclic NTT mod t (natural -> bitrev), exact: Cooley-Tukey
    stages, each over all its butterflies at once."""
    a = np.asarray(vals, dtype=np.int64) % t
    w_all = _powers_bitrev(psi, t, n)
    m = 1
    while m < n:
        y = a.reshape(m, 2, n // (2 * m))
        u, v = y[:, 0], y[:, 1] * w_all[m:2 * m, None] % t
        a = np.stack([(u + v) % t, (u - v) % t], axis=1).reshape(n)
        m *= 2
    return a.tolist()


def _host_intt(vals, t: int, psi_inv: int, n_inv: int, n: int) -> List[int]:
    """Inverse of ``_host_ntt`` (Gentleman-Sande stages, then 1/n)."""
    a = np.asarray(vals, dtype=np.int64) % t
    w_all = _powers_bitrev(psi_inv, t, n)
    step, h = 1, n // 2
    while h >= 1:
        y = a.reshape(h, 2, step)
        u, v = y[:, 0], y[:, 1]
        a = np.stack([(u + v) % t, (u - v) % t * w_all[h:2 * h, None] % t],
                     axis=1).reshape(n)
        step, h = step * 2, h // 2
    return (a * n_inv % t).tolist()


@lru_cache(maxsize=None)
def packed_slot_perm(n: int) -> np.ndarray:
    """User-slot -> NTT-slot index map for the packed encoding.

    User slots are two rows of n/2 (the reference PackedEncoding's 2 x n/2
    structure, packedencoding.cpp): row 0 slot i holds the evaluation at
    psi^(5^i mod 2n), row 1 slot i at psi^(-5^i mod 2n). In this order
    sigma_{5^r} rotates both rows left by r (EvalAtIndex) and sigma_{2n-1}
    swaps the rows."""
    rev = bit_reverse_perm(n)
    exp_to_slot = np.zeros(2 * n, dtype=np.int64)
    exp_to_slot[2 * rev + 1] = np.arange(n)
    perm = np.zeros(n, dtype=np.int64)
    g = 1
    for i in range(n // 2):
        perm[i] = exp_to_slot[g]
        perm[i + n // 2] = exp_to_slot[2 * n - g]
        g = g * 5 % (2 * n)
    return perm


def packed_encode(values: Sequence[int], n: int, t: int) -> List[int]:
    """Z_t slot values -> plaintext polynomial coefficients mod t, user
    slots in the 5-orbit row order of ``packed_slot_perm``."""
    psi, psi_inv, n_inv = _packed_tables(n, t)
    vals = [int(v) % t for v in values] + [0] * (n - len(values))
    slots = np.zeros(n, dtype=np.int64)
    slots[packed_slot_perm(n)] = vals
    return _host_intt(slots, t, psi_inv, n_inv, n)


def packed_decode(coeffs: Sequence[int], n: int, t: int) -> List[int]:
    psi, psi_inv, n_inv = _packed_tables(n, t)
    ntt_slots = np.asarray(_host_ntt([int(c) % t for c in coeffs], t, psi,
                                     n), dtype=np.int64)
    return ntt_slots[packed_slot_perm(n)].tolist()


# ---------------------------------------------------------------------------
# Coefficient-packed and string encodings
# ---------------------------------------------------------------------------


def coef_encode(values: Sequence[int], n: int, t: int) -> List[int]:
    """Integers directly as polynomial coefficients mod t (reference:
    ``CoefPackedEncoding``). Signed inputs are lifted to [0, t); decode
    re-centers."""
    if len(values) > n:
        raise ValueError(f"{len(values)} values exceed ring dimension {n}")
    return [int(v) % t for v in values] + [0] * (n - len(values))


def coef_decode(coeffs: Sequence[int], n: int, t: int,
                length: int | None = None) -> List[int]:
    """Inverse of coef_encode with centered lift to (-t/2, t/2]."""
    out = [int(c) % t for c in coeffs[: (n if length is None else length)]]
    return [v - t if v > t // 2 else v for v in out]


def string_encode(text: str, n: int, t: int = 256) -> List[int]:
    """UTF-8 bytes as coefficients (reference: ``StringEncoding``; fixed
    t = 256 alphabet)."""
    data = text.encode("utf-8")
    if len(data) > n:
        raise ValueError(f"string of {len(data)} bytes exceeds ring dim {n}")
    return [int(b) % t for b in data] + [0] * (n - len(data))


def string_decode(coeffs: Sequence[int], t: int = 256) -> str:
    raw = bytes(int(c) % t for c in coeffs)
    return raw.rstrip(b"\x00").decode("utf-8", errors="replace")
