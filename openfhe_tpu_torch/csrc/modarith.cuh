// 64-bit modular arithmetic shared by the kernels in this directory.
//
// Residues are reduced values in [0, q) with q < 2^62, carried in int64
// tensors and read here as unsigned 64-bit words. Shoup precons
// floor(c * 2^64 / q) use the full unsigned range; the tensors hold their
// bit pattern. The eager functions return the unique reduced residue, the
// same value as the plain PyTorch twins in ops/modular.py. The lazy (Harvey)
// functions beside them skip the final compare-and-subtract and keep values
// in [0, 2q) or [0, 4q); 4q < 2^64 because q < 2^62. Their callers reduce
// once before anything is stored for a reader, so only the reduced residue is
// ever observable.
#pragma once

#include <cstdint>

typedef unsigned long long u64;

__device__ __forceinline__ u64 add_mod(u64 a, u64 b, u64 q) {
  const u64 s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ u64 sub_mod(u64 a, u64 b, u64 q) {
  return a >= b ? a - b : a + q - b;
}

// (x * w) mod q for a constant w < q with precon wp = floor(w * 2^64 / q);
// any 64-bit x. x*w - h*q lies in [0, 2q) and is exact modulo 2^64.
__device__ __forceinline__ u64 mul_shoup(u64 x, u64 w, u64 wp, u64 q) {
  const u64 h = __umul64hi(x, wp);
  const u64 r = x * w - h * q;
  return r >= q ? r - q : r;
}

// Lazy Shoup product: congruent to x * w mod q, in [0, 2q), for ANY 64-bit x
// (so it also absorbs an unreduced input) and a constant w < q.
__device__ __forceinline__ u64 mul_shoup_lazy(u64 x, u64 w, u64 wp, u64 q) {
  return x * w - __umul64hi(x, wp) * q;
}

// x - m if x >= m else x, for x < 2m and m <= 2^63: the difference wraps to
// a value with the top bit set exactly when x < m, so its sign decides (one
// instruction cheaper than the 64-bit compare).
__device__ __forceinline__ u64 cond_sub(u64 x, u64 m) {
  const u64 d = x - m;
  return (long long)d < 0 ? x : d;
}

// [0, 2q) -> [0, q).
__device__ __forceinline__ u64 reduce_2q(u64 x, u64 q) { return cond_sub(x, q); }

// [0, 4q) -> [0, q); q2 = 2q.
__device__ __forceinline__ u64 reduce_4q(u64 x, u64 q, u64 q2) {
  return reduce_2q(cond_sub(x, q2), q);
}

// Lazy Cooley-Tukey butterfly (forward NTT): x, y in [0, 4q) on entry and on
// exit; (x, y) <- (x + w*y, x - w*y) mod q. q2 = 2q.
__device__ __forceinline__ void ct_lazy(u64& x, u64& y, u64 w, u64 wp, u64 q,
                                        u64 q2) {
  const u64 u = cond_sub(x, q2);                 // [0, 2q)
  const u64 t = mul_shoup_lazy(y, w, wp, q);     // [0, 2q)
  x = u + t;                                     // [0, 4q)
  y = u - t + q2;                                // (0, 4q)
}

// Lazy Gentleman-Sande butterfly (inverse NTT): x, y in [0, 2q) on entry and
// on exit; (x, y) <- (x + y, (x - y) * w) mod q. q2 = 2q.
__device__ __forceinline__ void gs_lazy(u64& x, u64& y, u64 w, u64 wp, u64 q,
                                        u64 q2) {
  const u64 s = x + y;                           // [0, 4q)
  const u64 d = x - y + q2;                      // (0, 4q)
  x = cond_sub(s, q2);                           // [0, 2q)
  y = mul_shoup_lazy(d, w, wp, q);               // [0, 2q)
}

// x mod q for any 64-bit x, with mu = floor(2^64 / q).
__device__ __forceinline__ u64 barrett_word(u64 x, u64 q, u64 mu) {
  const u64 h = __umul64hi(x, mu);
  const u64 r = x - h * q;
  return r >= q ? r - q : r;
}

// 128-bit accumulator (hi, lo) += x * y.
__device__ __forceinline__ void mac128(u64& lo, u64& hi, u64 x, u64 y) {
  const u64 p = x * y;
  lo += p;
  hi += __umul64hi(x, y) + (lo < p ? 1ull : 0ull);
}

// (hi * 2^64 + lo) mod q: hi * (2^64 mod q) by Shoup, lo by Barrett, as
// ops/modular.mul_mod does for one product.
__device__ __forceinline__ u64 reduce128(u64 lo, u64 hi, u64 q, u64 mu,
                                         u64 r64, u64 r64p) {
  return add_mod(mul_shoup(hi, r64, r64p, q), barrett_word(lo, q, mu), q);
}
