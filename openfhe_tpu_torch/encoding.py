"""Plaintext encodings: the CKKS part.

The port's own copy of ``openfhe_tpu/encoding.py:1-76`` (same names and
signatures, same results). CKKS packed encoding: complex canonical embedding
via the special 2n-th root FFT (reference: ``CKKSPackedEncoding`` +
``DiscreteFourierTransform::FFTSpecial``,
``pke/lib/encoding/ckkspackedencoding.cpp:126,426``), realized here with
numpy FFTs on the host. Slot j holds the value of the plaintext polynomial
at zeta^(5^j), zeta = exp(i*pi/n).

The packed (BGV/BFV) integer encoders are not copied yet: they come with
those schemes.

Encoding/decoding are host-side (they sit at the user API boundary, not in
the homomorphic hot path).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np


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
    """Complex slot values -> integer coefficient vector (int, rounded)."""
    slots = np.zeros(n // 2, dtype=np.complex128)
    vals = np.asarray(values, dtype=np.complex128)
    assert len(vals) <= n // 2, "too many slots"
    slots[: len(vals)] = vals
    coeffs = ckks_embed_inv(slots, n) * scale
    # exact rounding to Python ints (can exceed float64 int range at high
    # scale x depth; rint keeps us within 2^53 for standard params)
    return np.asarray([int(v) for v in np.rint(coeffs)], dtype=object)


def ckks_decode(coeffs: Sequence[int], n: int, scale: float,
                num_slots: int | None = None) -> np.ndarray:
    """Centered integer coefficients -> complex slot values (scaled down)."""
    cs = np.asarray([float(c) for c in coeffs])
    slots = ckks_embed(cs, n) / scale
    if num_slots is not None:
        slots = slots[:num_slots]
    return slots
