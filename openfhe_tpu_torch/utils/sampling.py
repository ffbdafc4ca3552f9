"""Host-side randomness: secret/error/uniform polynomial sampling.

Counterpart of the reference's distribution generators
(``math/discretegaussiangenerator.h``, ternary/discrete-uniform generators,
Blake2 PRNG) — randomness quality matters, bit-compatibility does not, so we
use numpy's PCG64 (or any np.random.Generator supplied by the caller).
Residues are produced directly per tower; independent uniform residues per
tower ARE the uniform distribution over Z_Q by CRT.

The port's own copy of ``openfhe_tpu/utils/sampling.py`` (same names and
signatures, same results), so that the port imports nothing of the JAX
package.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def ternary_coeffs(n: int, rng: np.random.Generator) -> np.ndarray:
    """Uniform ternary secret coefficients in {-1, 0, 1} (int64)."""
    return rng.integers(-1, 2, size=n, dtype=np.int64)


def sparse_ternary_coeffs(n: int, hamming_weight: int,
                          rng: np.random.Generator) -> np.ndarray:
    """Ternary secret with exactly `hamming_weight` nonzeros (the sparse
    secret distribution used for efficient CKKS bootstrapping)."""
    s = np.zeros(n, dtype=np.int64)
    idx = rng.choice(n, size=hamming_weight, replace=False)
    s[idx] = rng.choice([-1, 1], size=hamming_weight)
    return s


def gaussian_coeffs(n: int, rng: np.random.Generator,
                    sigma: float = 3.19) -> np.ndarray:
    """Rounded-Gaussian error coefficients (int64), sigma per HE standard."""
    return np.rint(rng.normal(0.0, sigma, size=n)).astype(np.int64)


def uniform_rns_rows(n: int, moduli: Sequence[int],
                     rng: np.random.Generator) -> np.ndarray:
    """Uniform element of R_Q in RNS form: independent uniforms per tower.
    Returns uint64 [L, n] (moduli < 2^62 so uint64 is exact)."""
    return np.stack([rng.integers(0, q, size=n, dtype=np.uint64)
                     for q in moduli])


def signed_to_rns_rows(coeffs, moduli: Sequence[int]) -> np.ndarray:
    """Signed integer coefficients -> RNS rows, vectorized when the values
    fit int64 (secrets/errors always do); exact bigint fallback otherwise.
    Returns uint64 [L, n] or a list-of-list of Python ints."""
    arr = np.asarray(coeffs)
    if arr.dtype != object and np.issubdtype(arr.dtype, np.integer):
        cs = arr.astype(np.int64)
        qs = np.asarray([int(q) for q in moduli], dtype=np.int64)
        rows = cs[None, :] % qs[:, None]  # numpy % is non-negative
        return rows.astype(np.uint64)
    cs = [int(c) for c in coeffs]
    return [[c % q for c in cs] for q in moduli]
