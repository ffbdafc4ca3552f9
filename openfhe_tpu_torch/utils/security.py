"""HE-standard lattice security tables and parameter validation.

Role of the reference's ``lattice/stdlatticeparms.h`` + the table in
``src/core/lib/lattice/stdlatticeparms.cpp:94-212``: the
HomomorphicEncryption.org standard tables mapping (secret distribution,
security level, ring dimension) -> maximum log2(Q*P) for which the RLWE
instance meets the target security. ``GenCryptoContext`` in the reference
validates the generated modulus chain against these tables and bumps the
ring dimension when needed; ``gen_context`` here does the same when a
``security_level`` is requested.

Rows are copied verbatim from the reference's ``stdlatticeparms.cpp``
(public-domain standard data). The table's coverage is exactly the
reference's: uniform secrets stop at n=32768, error/ternary stop at
n=65536 classic (no 65536-quantum or 131072 rows exist). Lookup
semantics mirror ``StdLatticeParm::FindMaxQ`` (exact ring-dim lookup,
0 when absent -> any modulus rejected) and ``FindRingDim`` (smallest
table dim admitting log2(QP); doubles the largest dim when the whole
table is exceeded), ``stdlatticeparms.h:146-172``.

The port's own copy of ``openfhe_tpu/utils/security.py`` (same names and
signatures, same results), so that the port imports nothing of the JAX
package.
"""

from __future__ import annotations

from enum import Enum


class SecurityLevel(str, Enum):
    HEStd_NotSet = "HEStd_NotSet"
    HEStd_128_classic = "HEStd_128_classic"
    HEStd_192_classic = "HEStd_192_classic"
    HEStd_256_classic = "HEStd_256_classic"
    HEStd_128_quantum = "HEStd_128_quantum"
    HEStd_192_quantum = "HEStd_192_quantum"
    HEStd_256_quantum = "HEStd_256_quantum"


class SecretDist(str, Enum):
    UNIFORM_TERNARY = "ternary"
    ERROR = "error"
    UNIFORM = "uniform"


_LC, _MC, _HC = (SecurityLevel.HEStd_128_classic, SecurityLevel.HEStd_192_classic,
                 SecurityLevel.HEStd_256_classic)
_LQ, _MQ, _HQ = (SecurityLevel.HEStd_128_quantum, SecurityLevel.HEStd_192_quantum,
                 SecurityLevel.HEStd_256_quantum)

# _MAXLOGQ[dist][level] = {ring_dim: max log2(QP)}. Every row below is a
# verbatim StdLatticeParm(...) entry from stdlatticeparms.cpp:94-212;
# dims absent there are absent here.
_MAXLOGQ = {
    SecretDist.UNIFORM: {
        _LC: {1024: 29, 2048: 56, 4096: 111, 8192: 220, 16384: 440, 32768: 880},
        _MC: {1024: 21, 2048: 39, 4096: 77, 8192: 154, 16384: 307, 32768: 612},
        _HC: {1024: 16, 2048: 31, 4096: 60, 8192: 120, 16384: 239, 32768: 478},
        _LQ: {1024: 27, 2048: 53, 4096: 103, 8192: 206, 16384: 413, 32768: 829},
        _MQ: {1024: 19, 2048: 37, 4096: 72, 8192: 143, 16384: 286, 32768: 573},
        _HQ: {1024: 15, 2048: 29, 4096: 56, 8192: 111, 16384: 222, 32768: 445},
    },
    SecretDist.ERROR: {
        _LC: {1024: 29, 2048: 56, 4096: 111, 8192: 220, 16384: 440, 32768: 883,
              65536: 1774},
        _MC: {1024: 21, 2048: 39, 4096: 77, 8192: 154, 16384: 307, 32768: 613,
              65536: 1230},
        _HC: {1024: 16, 2048: 31, 4096: 60, 8192: 120, 16384: 239, 32768: 478,
              65536: 958},
        _LQ: {1024: 27, 2048: 53, 4096: 103, 8192: 206, 16384: 413, 32768: 829},
        _MQ: {1024: 19, 2048: 37, 4096: 72, 8192: 143, 16384: 286, 32768: 573},
        _HQ: {1024: 15, 2048: 29, 4096: 56, 8192: 111, 16384: 222, 32768: 445},
    },
    SecretDist.UNIFORM_TERNARY: {
        _LC: {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438, 32768: 881,
              65536: 1772},
        _MC: {1024: 19, 2048: 37, 4096: 75, 8192: 152, 16384: 305, 32768: 611,
              65536: 1228},
        _HC: {1024: 14, 2048: 29, 4096: 58, 8192: 118, 16384: 237, 32768: 476,
              65536: 956},
        _LQ: {1024: 25, 2048: 51, 4096: 101, 8192: 202, 16384: 411, 32768: 827},
        _MQ: {1024: 17, 2048: 35, 4096: 70, 8192: 141, 16384: 284, 32768: 571},
        _HQ: {1024: 13, 2048: 27, 4096: 54, 8192: 109, 16384: 220, 32768: 443},
    },
}


def max_log_q(n: int, level: SecurityLevel,
              dist: SecretDist = SecretDist.UNIFORM_TERNARY) -> int:
    """Maximum log2(QP) permitted at ring dimension ``n`` for ``level``.

    Exact-dimension lookup: a ring dim with no table row (too small, too
    large, or not a standard power of two) returns 0 — i.e. no modulus is
    certifiably secure — exactly as ``StdLatticeParm::FindMaxQ``
    (stdlatticeparms.h:146-155) returns 0 on a missed map lookup.
    """
    level = SecurityLevel(level)
    dist = SecretDist(dist)
    if level == SecurityLevel.HEStd_NotSet:
        raise ValueError("max_log_q undefined for HEStd_NotSet")
    return _MAXLOGQ[dist][level].get(n, 0)


def min_ring_dim(log_qp: int, level: SecurityLevel,
                 dist: SecretDist = SecretDist.UNIFORM_TERNARY) -> int:
    """Smallest standard ring dimension whose table row admits log2(QP)
    = ``log_qp`` at ``level``; doubles the largest table dim when the
    whole table is exceeded (``StdLatticeParm::FindRingDim``,
    stdlatticeparms.h:157-172)."""
    level = SecurityLevel(level)
    dist = SecretDist(dist)
    if level == SecurityLevel.HEStd_NotSet:
        return 0
    table = _MAXLOGQ[dist][level]
    for dim in sorted(table):
        if log_qp <= table[dim]:
            return dim
    return 2 * max(table)


def validate(n: int, log_qp: int, level: SecurityLevel,
             dist: SecretDist = SecretDist.UNIFORM_TERNARY) -> None:
    """Raise if (n, log2 QP) violates the requested security level."""
    level = SecurityLevel(level)
    if level == SecurityLevel.HEStd_NotSet:
        return
    allowed = max_log_q(n, level, dist)
    if log_qp > allowed:
        raise ValueError(
            f"insecure parameters: ring dim {n} admits log2(QP) <= {allowed} "
            f"at {level.value}, but the modulus chain has log2(QP) = {log_qp}; "
            f"increase ring_dim to >= {min_ring_dim(log_qp, level, dist)}")
