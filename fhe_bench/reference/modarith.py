"""Exact modular arithmetic and the negacyclic NTT in plain PyTorch.

Residues are int64 tensors in [0, q) with q below 2^61. A product modulo q
is built by Horner's rule over 21-bit pieces of one factor: each step takes
a float64 estimate of its quotient, off by one at most, and corrects it by
the remainder, which int64 arithmetic modulo 2^64 gives exactly since its
true value lies in [-q, 2q), well inside +-2^63.

The evaluation order is the one OpenFHE uses: slot j of a transform of p
holds p(psi^(2*bitrev(j)+1)), psi = g^((q-1)/2n) for g the smallest
generator of the integers modulo q.
"""

from __future__ import annotations

import math
import random
from functools import lru_cache

import torch

MAX_Q_BITS = 61
_PIECE = 21  # bits of a factor taken a step: three steps cover 61 bits


def mulmod(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """a * b mod q for residues of q < 2^61 (q broadcasts against both)."""
    a, b = torch.broadcast_tensors(a, b)
    qd, bd = q.double(), b.double()
    r = torch.zeros_like(a)
    for shift in range(2 * _PIECE, -1, -_PIECE):
        piece = (a >> shift) & ((1 << _PIECE) - 1)
        quo = torch.floor((r.double() * 2.0 ** _PIECE + piece.double() * bd)
                          / qd).long()
        r = r * (1 << _PIECE) + piece * b - quo * q
        r = torch.where(r < 0, r + q, r)
        r = torch.where(r >= q, r - q, r)
    return r


def _is_prime(n: int) -> bool:
    """Miller-Rabin with the first twelve primes as bases: exact below
    3.3e24."""
    if n < 2:
        return False
    small = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
    for p in small:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for a in small:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _rho(n: int) -> int:
    """A non-trivial factor of the composite n (Pollard's rho, Brent)."""
    rnd = random.Random(n)
    while True:
        y, c, m = rnd.randrange(1, n), rnd.randrange(1, n), 128
        g = r = q = 1
        while g == 1:
            x = y
            for _ in range(r):
                y = (y * y + c) % n
            k = 0
            while k < r and g == 1:
                ys = y
                for _ in range(min(m, r - k)):
                    y = (y * y + c) % n
                    q = q * abs(x - y) % n
                g = math.gcd(q, n)
                k += m
            r *= 2
        if g == n:
            g = 1
            while g == 1:
                ys = (ys * ys + c) % n
                g = math.gcd(abs(x - ys), n)
        if g != n:
            return g


def prime_factors(n: int) -> set:
    out, stack = set(), [n]
    while stack:
        m = stack.pop()
        if m == 1:
            continue
        for p in (2, 3, 5, 7, 11, 13):
            while m % p == 0:
                out.add(p)
                m //= p
        if m == 1:
            continue
        if _is_prime(m):
            out.add(m)
            continue
        f = _rho(m)
        stack += [f, m // f]
    return out


@lru_cache(maxsize=None)
def root_2n(n: int, q: int) -> int:
    """psi = g^((q-1)/2n) for g the smallest generator modulo the prime q."""
    if not _is_prime(q) or (q - 1) % (2 * n):
        raise ValueError(f"{q} is not a prime = 1 mod {2 * n}")
    phi = q - 1
    factors = prime_factors(phi)
    g = 2
    while any(pow(g, phi // p, q) == 1 for p in factors):
        g += 1
    return pow(g, phi // (2 * n), q)


def _bitrev(n: int, device) -> torch.Tensor:
    bits = n.bit_length() - 1
    idx = torch.arange(n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _powers(root: torch.Tensor, n: int, q: torch.Tensor) -> torch.Tensor:
    """[L, n]: root^k mod q for k < n, by doubling."""
    out = torch.ones(root.shape[0], n, dtype=torch.int64, device=root.device)
    step, k = root.clone(), 1
    while k < n:
        out[:, k:2 * k] = mulmod(out[:, :k], step[:, None], q)
        step = mulmod(step, step, q[:, 0])
        k *= 2
    return out


class NTT:
    """Negacyclic transforms of [..., L, n] over the given moduli."""

    def __init__(self, n: int, moduli, device):
        moduli = [int(q) for q in moduli]
        if max(moduli).bit_length() > MAX_Q_BITS:
            raise ValueError(f"moduli above 2^{MAX_Q_BITS}")
        self.n, self.moduli = n, tuple(moduli)
        self.q = torch.tensor(moduli, dtype=torch.int64,
                              device=device)[:, None]
        psi = [root_2n(n, q) for q in moduli]
        rev = _bitrev(n, device)
        t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
        self.w = _powers(t(psi), n, self.q)[:, rev]
        self.w_inv = _powers(t([pow(p, -1, q) for p, q in zip(psi, moduli)]),
                             n, self.q)[:, rev]
        self.n_inv = t([pow(n, -1, q) for q in moduli])[:, None]

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        """Natural coefficients -> evaluations (Cooley-Tukey)."""
        n, q = self.n, self.q
        a = a.clone()
        lead = a.shape[:-1]
        m, t = 1, n
        while m < n:
            t //= 2
            v = a.reshape(*lead, m, 2, t)
            w = self.w[:, m:2 * m, None]
            x = mulmod(v[..., 1, :], w, q[..., None])
            u = v[..., 0, :]
            v[..., 0, :], v[..., 1, :] = (torch.remainder(u + x, q[..., None]),
                                          torch.remainder(u - x, q[..., None]))
            a = v.reshape(*lead, n)
            m *= 2
        return a

    def inverse(self, a: torch.Tensor) -> torch.Tensor:
        """Evaluations -> natural coefficients (Gentleman-Sande, 1/n)."""
        n, q = self.n, self.q
        a = a.clone()
        lead = a.shape[:-1]
        m, t = n, 1
        while m > 1:
            h = m // 2
            v = a.reshape(*lead, h, 2, t)
            w = self.w_inv[:, h:m, None]
            u, x = v[..., 0, :].clone(), v[..., 1, :].clone()
            v[..., 0, :] = torch.remainder(u + x, q[..., None])
            v[..., 1, :] = mulmod(torch.remainder(u - x, q[..., None]), w,
                                  q[..., None])
            a = v.reshape(*lead, n)
            t *= 2
            m = h
        return mulmod(a, self.n_inv.expand_as(a), q)
