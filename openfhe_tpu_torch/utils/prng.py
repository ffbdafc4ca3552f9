"""Cryptographic PRNG + exact discrete Gaussian sampling.

Role of the reference's Blake2-based PRNG (``utils/prng/blake2engine.h``:
counter-mode BLAKE2 with a 512-bit seed and a 1024-sample buffer) and
``math/discretegaussiangenerator.h:48-195`` (Peikert-inversion sampling
plus Karney's exact Algorithm D from https://arxiv.org/abs/1303.6257).

Design notes (host-side sampling):

* ``Blake2Engine`` is counter-mode BLAKE2b via ``hashlib`` — same
  construction as the reference (seed = key, counter = message), not
  bit-compatible by design (the reference's own PRNG is an implementation
  detail, never part of ciphertext formats). It implements the subset of
  the ``numpy.random.Generator`` API the sampling layer uses
  (``integers`` / ``normal`` / ``choice``), so every keygen/encrypt
  function in the framework accepts it interchangeably.
* ``DiscreteGaussianGenerator`` provides two exact samplers: CDF inversion
  with a 128-bit integer table (strictly tighter than the reference's
  double-precision ``m_vals``) and Karney's exact method (no floating
  point anywhere on the accept path).

The port's own copy of ``openfhe_tpu/utils/prng.py`` (same names and
signatures, same results), so that the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

_BLOCK_U32 = 16  # BLAKE2b-512 digest = 64 bytes = 16 uint32 samples


class Blake2Engine:
    """Counter-mode BLAKE2b PRNG with a numpy-Generator-compatible subset.

    (role of lbcrypto::Blake2Engine, ``blake2engine.h:56-120``)
    """

    def __init__(self, seed: int | bytes = 0):
        if isinstance(seed, int):
            seed = seed.to_bytes(64, "little", signed=False)
        if len(seed) < 64:
            seed = seed + b"\x00" * (64 - len(seed))
        self._key = seed[:64]
        self._counter = 0
        self._pool = np.empty(0, dtype=np.uint32)

    def _refill(self, min_words: int) -> None:
        blocks = max(64, -(-min_words // _BLOCK_U32))
        out = bytearray()
        for _ in range(blocks):
            h = hashlib.blake2b(
                self._counter.to_bytes(8, "little"), key=self._key)
            out += h.digest()
            self._counter += 1
        fresh = np.frombuffer(bytes(out), dtype=np.uint32)
        self._pool = np.concatenate([self._pool, fresh])

    def random_u32(self, count: int) -> np.ndarray:
        if len(self._pool) < count:
            self._refill(count - len(self._pool))
        out, self._pool = self._pool[:count], self._pool[count:]
        return out

    def random_u64(self, count: int) -> np.ndarray:
        w = self.random_u32(2 * count).astype(np.uint64)
        return (w[::2] << np.uint64(32)) | w[1::2]

    def random_bit(self) -> int:
        return int(self.random_u32(1)[0]) & 1

    # -- numpy.random.Generator-compatible subset ------------------------

    def integers(self, low, high=None, size=None, dtype=np.int64,
                 endpoint=False):
        if high is None:
            low, high = 0, low
        if endpoint:
            high = high + 1
        span = int(high) - int(low)
        assert span > 0
        n = int(np.prod(size)) if size is not None else 1
        # rejection sampling on the top multiple of span (unbiased)
        limit = (1 << 64) - ((1 << 64) % span)
        out = np.empty(n, dtype=np.uint64)
        filled = 0
        while filled < n:
            draw = self.random_u64(n - filled)
            if limit < (1 << 64):   # power-of-two spans accept everything
                draw = draw[draw < np.uint64(limit)]
            out[filled:filled + len(draw)] = draw
            filled += len(draw)
        vals = (out % np.uint64(span)).astype(np.int64) + int(low)
        if size is None:
            return dtype(vals[0]) if isinstance(dtype, type) else vals[0]
        return vals.reshape(size).astype(dtype)

    def random(self, size=None):
        n = int(np.prod(size)) if size is not None else 1
        u = self.random_u64(n).astype(np.float64) / float(1 << 64)
        return u.reshape(size) if size is not None else float(u[0])

    def normal(self, loc=0.0, scale=1.0, size=None):
        n = int(np.prod(size)) if size is not None else 1
        m = -(-n // 2) * 2
        u1 = np.clip(self.random(m // 2), 1e-300, 1.0)
        u2 = self.random(m // 2)
        r = np.sqrt(-2.0 * np.log(u1))
        z = np.concatenate([r * np.cos(2 * np.pi * u2),
                            r * np.sin(2 * np.pi * u2)])[:n]
        z = loc + scale * z
        return z.reshape(size) if size is not None else float(z[0])

    def choice(self, a, size=None, replace=True):
        n = int(a) if np.isscalar(a) else len(a)
        pool = np.arange(n) if np.isscalar(a) else np.asarray(a)
        k = int(np.prod(size)) if size is not None else 1
        if replace:
            idx = self.integers(0, n, size=k)
        else:
            assert k <= n
            # partial Fisher-Yates
            arr = pool.copy()
            for i in range(k):
                j = i + int(self.integers(0, n - i))
                arr[i], arr[j] = arr[j], arr[i]
            picked = arr[:k]
            return picked.reshape(size) if size is not None else picked[0]
        picked = pool[idx]
        return picked.reshape(size) if size is not None else picked[0]


class DiscreteGaussianGenerator:
    """Exact discrete Gaussian over Z (role of
    DiscreteGaussianGeneratorImpl, ``discretegaussiangenerator.h:86-195``).
    """

    _FRAC_BITS = 128

    def __init__(self, sigma: float = 3.19, tail_factor: float = 12.0):
        self.sigma = float(sigma)
        self.tail = int(math.ceil(tail_factor * sigma))
        self._cdf_cache = None

    @property
    def _cdf(self):
        # 128-bit fixed-point CDF table over [-tail, tail] (Peikert
        # inversion; the reference uses double-precision m_vals). Built
        # lazily on first inversion sample: at flooding sigma (2^20) the
        # table is ~17M Fraction entries and Karney-only users (the
        # flooding path) must not pay for it.
        if self._cdf_cache is None:
            sigma = self.sigma
            from fractions import Fraction
            ws = [Fraction(
                int(round(math.exp(-(x * x) / (2 * sigma * sigma)) * 1e18)),
                10 ** 18) for x in range(-self.tail, self.tail + 1)]
            total = sum(ws)
            acc = Fraction(0)
            cdf = []
            one = 1 << self._FRAC_BITS
            for w in ws:
                acc += w
                cdf.append(min(one, int(acc / total * one)))
            self._cdf_cache = cdf
        return self._cdf_cache

    def generate_inversion(self, n: int, engine: Blake2Engine
                           ) -> np.ndarray:
        """Peikert-inversion sampling with the 128-bit table."""
        out = np.empty(n, dtype=np.int64)
        for i in range(n):
            u = (int(engine.random_u64(1)[0]) << 64) | \
                int(engine.random_u64(1)[0])
            # binary search the first index with cdf >= u
            lo, hi = 0, len(self._cdf) - 1
            while lo < hi:
                mid = (lo + hi) // 2
                if self._cdf[mid] < u:
                    lo = mid + 1
                else:
                    hi = mid
            out[i] = lo - self.tail
        return out

    # -- Karney's exact Algorithm D (https://arxiv.org/abs/1303.6257) ----

    def _algorithm_h(self, engine) -> bool:
        """Bernoulli(exp(-1/2)) via von Neumann's descending-run trick in
        exact 64-bit fixed point: count the run u_1 > u_2 > ... starting
        below 1/2; P(run length even) = exp(-1/2)."""
        prev = 1 << 63   # x = 1/2 in 2^64 fixed point
        n = 0
        while True:
            u = int(engine.random_u64(1)[0])
            if u >= prev:
                return n % 2 == 0
            n += 1
            prev = u

    def _algorithm_g(self, engine) -> int:
        """Geometric: number of successive Bernoulli(exp(-1/2)) successes."""
        k = 0
        while self._algorithm_h(engine):
            k += 1
        return k

    def _algorithm_p(self, engine, m: int) -> bool:
        """Bernoulli(exp(-m/2)) as m independent exp(-1/2) trials."""
        for _ in range(m):
            if not self._algorithm_h(engine):
                return False
        return True

    def _algorithm_b(self, engine, k: int, x_num: int, x_den: int) -> bool:
        """Bernoulli(exp(-x(2k + x)/2)) for rational x = x_num/x_den in
        [0, 1] (Karney Algorithm B, exact integer comparisons)."""
        y_num, y_den = x_num, x_den
        n_trials = 0
        while True:
            z_num = int(engine.random_u64(1)[0])
            z_den = 1 << 64
            # z < y  <=>  z_num * y_den < y_num * z_den
            if z_num * y_den >= y_num * z_den:
                break
            # accept step with prob (2k + x)/(2k + 2): r < (2k+x)/(2k+2)
            r = int(engine.random_u64(1)[0])
            lhs = r * x_den * (2 * k + 2)
            rhs = (2 * k * x_den + x_num) << 64
            if lhs >= rhs:
                break
            y_num, y_den = z_num, z_den
            n_trials += 1
        return n_trials % 2 == 0

    def generate_karney(self, n: int, engine: Blake2Engine) -> np.ndarray:
        """Karney's exact discrete-Gaussian sampler (Algorithm D); no
        floating point on the accept path. Uses sigma rounded to a
        rational with 2^32 denominator (exact thereafter)."""
        sig_den = 1 << 32
        sig_num = int(round(self.sigma * sig_den))
        out = np.empty(n, dtype=np.int64)
        for i in range(n):
            while True:
                k = self._algorithm_g(engine)
                if not self._algorithm_p(engine, k * (k - 1)):
                    continue
                s = 1 if engine.random_bit() else -1
                # i0 = ceil(k * sigma), x0 = (i0 - k*sigma)/sigma
                i0 = -((-k * sig_num) // sig_den)
                j = int(self.integers_ceil(engine))
                # candidate value i0 + j; x = (i0 + j - k*sigma)/sigma
                x_num = (i0 + j) * sig_den - k * sig_num
                x_den = sig_num
                if x_num >= x_den:   # x >= 1: reject (next k covers it)
                    continue
                if x_num == 0 and k == 0 and s < 0:
                    continue         # avoid double-counting zero
                # STEP D7: k+1 successive B trials — each B is
                # Bernoulli(exp(-x(2k+x)/(2k+2))), so the product is the
                # target exp(-x(2k+x)/2)
                if all(self._algorithm_b(engine, k, x_num, x_den)
                       for _ in range(k + 1)):
                    out[i] = s * (i0 + j)
                    break
        return out

    def integers_ceil(self, engine) -> int:
        """Uniform j in [0, ceil(sigma))."""
        c = int(math.ceil(self.sigma))
        return int(engine.integers(0, c))

    def generate(self, n: int, engine: Blake2Engine,
                 method: str = "inversion") -> np.ndarray:
        if method == "karney":
            return self.generate_karney(n, engine)
        return self.generate_inversion(n, engine)
