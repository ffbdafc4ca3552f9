"""Host-side number theory on exact Python integers.

Provides NTT-friendly prime search and primitive roots of unity, matching the
behavior of the reference's ``src/core/include/math/nbtheory.h``
(FirstPrime/NextPrime/PreviousPrime, RootOfUnity) but implemented from
standard algorithms (deterministic Miller-Rabin for 64-bit, factor-based
primitive-root search). Everything here runs once at context-generation time;
nothing is performance-critical.

The port's own copy of ``openfhe_tpu/utils/nbtheory.py`` (same names and
signatures, same results), so that the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List

# Deterministic Miller-Rabin witnesses for n < 3.3 * 10^24 (covers 64-bit).
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _pollard_rho(n: int) -> int:
    if n % 2 == 0:
        return 2
    x, y, c, d = 2, 2, 1, 1
    while d == 1:
        x = (x * x + c) % n
        y = (y * y + c) % n
        y = (y * y + c) % n
        d = math.gcd(abs(x - y), n)
        if d == n:
            c += 1
            x = y = 2
            d = 1
    return d


def factorize(n: int) -> dict:
    """Prime factorization {p: e} via trial division + Pollard rho."""
    factors: dict = {}
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47):
        while n % p == 0:
            factors[p] = factors.get(p, 0) + 1
            n //= p
    stack = [n] if n > 1 else []
    while stack:
        m = stack.pop()
        if m == 1:
            continue
        if is_prime(m):
            factors[m] = factors.get(m, 0) + 1
            continue
        d = _pollard_rho(m)
        stack.extend([d, m // d])
    return factors


def first_prime(bits: int, m: int) -> int:
    """Smallest prime q with ~`bits` bits and q ≡ 1 (mod m).

    Mirrors the role of the reference's FirstPrime (``nbtheory.h:280``):
    starts at 2^bits rounded to ≡ 1 mod m and scans upward.
    """
    q = (1 << bits) + 1
    q += (-(q - 1)) % m
    assert q % m == 1
    while not is_prime(q):
        q += m
    return q


def previous_prime(q: int, m: int) -> int:
    """Largest prime < q with q' ≡ 1 (mod m) (reference: PreviousPrime)."""
    q -= m
    while q > m and not is_prime(q):
        q -= m
    if q <= m:
        raise ValueError("no smaller NTT-friendly prime")
    return q


def next_prime(q: int, m: int) -> int:
    q += m
    while not is_prime(q):
        q += m
    return q


def prev_ntt_prime_below(x: int, m: int) -> int:
    """Largest prime q < x with q ≡ 1 (mod m)."""
    q = x - 1 - ((x - 2) % m)  # largest value < x that is ≡ 1 mod m
    while q > m and not is_prime(q):
        q -= m
    if q <= m:
        raise ValueError("no NTT-friendly prime below bound")
    return q


def next_ntt_prime_above(x: int, m: int) -> int:
    """Smallest prime q > x with q ≡ 1 (mod m)."""
    q = x + 1 + ((-x) % m)  # smallest value > x that is ≡ 1 mod m
    while not is_prime(q):
        q += m
    return q


def primitive_root(q: int) -> int:
    """Smallest generator of (Z/q)^* for prime q."""
    phi = q - 1
    factors = factorize(phi)
    g = 2
    while True:
        if all(pow(g, phi // p, q) != 1 for p in factors):
            return g
        g += 1


def root_of_unity(m: int, q: int) -> int:
    """A primitive m-th root of unity mod prime q (requires m | q-1).

    Role of the reference's RootOfUnity (``nbtheory.h:85``). The smallest
    such root is chosen deterministically for reproducibility.
    """
    if (q - 1) % m != 0:
        raise ValueError(f"{m} does not divide {q}-1")
    g = primitive_root(q)
    w = pow(g, (q - 1) // m, q)
    assert pow(w, m, q) == 1 and pow(w, m // 2, q) != 1 if m > 1 else True
    return w


def mod_inverse(a: int, q: int) -> int:
    return pow(a, -1, q)


def generate_prime_chain(num: int, bits: int, ring_dim: int,
                         avoid: List[int] | None = None) -> List[int]:
    """Generate `num` distinct NTT-friendly primes of ~`bits` bits for ring
    dimension `ring_dim` (so q ≡ 1 mod 2n), scanning downward from 2^bits.
    """
    m = 2 * ring_dim
    avoid_set = set(avoid or [])
    chain: List[int] = []
    q = first_prime(bits, m)
    # scan downward from just above 2^bits to keep all primes ~ bits wide
    while len(chain) < num:
        if q not in avoid_set:
            chain.append(q)
            avoid_set.add(q)
        q = previous_prime(q, m)
    return chain
