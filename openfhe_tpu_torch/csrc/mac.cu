// Keyswitch multiply-accumulate for Hopper.
//
// Replaces the Pallas kernel openfhe_tpu/ops/elementwise_pallas.py
// `fused_mac_mod` (_mac_kernel): acc' = (acc + x*y) mod q over [R, n] with
// per-row constants, the step of the keyswitch digit inner product
// (openfhe_tpu/keyswitch.py:368-396). On the TPU the digit loop is a
// sequential grid carrying the sum in memory; here it is a loop inside each
// thread, so the main entry ks_inner_product fuses the whole inner product:
//   acc0[r] = sum_d digits[d, r] * key_b[d, rows[r]]  (mod q_r)
//   acc1[r] = sum_d digits[d, r] * key_a[d, rows[r]]  (mod q_r)
// reading each digit once for both key halves. Products accumulate lazily
// in 128 bits and are reduced once; only the final residue is observable,
// so the result is bit-equal to a chain of mul_mod + add_mod.
//
// Optional epilogue: with a table mono [M, n] and an index mono_rows [R],
// both halves of row r are multiplied by mono[mono_rows[r]] mod q_r, the
// (X^c - 1) product of a CGGI blind-rotation step
// (openfhe_tpu/models/binfhe.py:685-687); one full 64x64 product reduced
// as ops/modular.mul_mod reduces it, so the output is bit-equal to
// mul_mod(ks_inner_product_plain(...), mono[mono_rows]).
//
// Key rows come by value in the kernel's parameters (a host list of at most
// kMaxRowsByValue rows) or from a device index rows [R] (the AP blind
// rotation's digit of each batch element, read in place of a gathered copy
// of the key).
//
// Bounds. Bytes at the main-path shape (ndig = 3 digits, R = 11 rows of
// 65536): the digits and both key halves, 3 * 3 * 11 * 65536 * 8 =
// 51.9 MB, and two [11, 65536] outputs, 11.5 MB: 63.4 MB per call, 19 us at
// 3.35 TB/s. At a blind-rotation step ([6, 4, 1024]: 0.2-0.4 MB) both
// bounds are a fraction of a microsecond, below one launch: there the time
// is the launch and the round trips to memory that one thread waits on.
//
// Design:
//   1. Every global load a thread makes is issued before its first product:
//      the kernel is a template on the digit count, so the digit loop
//      unrolls, and the key row offsets of a host row list are kernel
//      parameters, so no key load waits on an index load. The per-row
//      constants and mono_rows[r] are loaded beside the digits; only the
//      mono row (and, with device rows, the key) waits on one index load.
//   2. Two residues a thread, as one 16-byte load per operand through the
//      read-only path, so a large call keeps enough bytes in flight to come
//      near the card's copy rate.
//   3. A one-dimensional grid: block b serves row b / blocks_per_row, so
//      there is no cap on R. Blocks of 64 threads when the call is small
//      (R * n <= 2^16), so a blind-rotation step spreads over many SMs, and
//      256 otherwise; halved, down to 32, while half a block still covers
//      the n / 2 pairs of a row.
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kMaxDigits = 15;      // 15 products < 2^124 fit 128 bits
constexpr int kMaxRowsByValue = 128;
constexpr int kSmallCall = 1 << 16; // R * n up to this: small blocks

struct KsArgs {
  const u64* digits;          // [ndig, R, n]
  const u64* key_b;           // [dnum, key_rows, n]
  const u64* key_a;
  const long long* rows;      // [R] key rows on the device, or null
  const u64* q;               // [R] each: q, floor(2^64 / q), 2^64 mod q
  const u64* mu;              //   and its Shoup precon
  const u64* r64;
  const u64* r64p;
  const u64* mono;            // [M, n], or null: no epilogue
  const long long* mono_rows; // [R]
  u64* out0;                  // [R, n]
  u64* out1;
  int R, key_rows, n, blocks_per_row;
  int row_of[kMaxRowsByValue]; // key rows by value when rows is null
};

__device__ __forceinline__ ulonglong2 ld2(const u64* p) {
  return __ldg(reinterpret_cast<const ulonglong2*>(p));
}

__device__ __forceinline__ u64 mul_mod_word(u64 x, u64 y, u64 q, u64 mu,
                                            u64 r64, u64 r64p) {
  return reduce128(x * y, __umul64hi(x, y), q, mu, r64, r64p);
}

template <int NDIG, bool DEV_ROWS, bool MONO>
__global__ void ks_inner_product_kernel(const __grid_constant__ KsArgs a) {
  const int r = blockIdx.x / a.blocks_per_row;
  const int col = blockIdx.x - r * a.blocks_per_row;
  const int i = 2 * (col * blockDim.x + threadIdx.x);
  if (i >= a.n) return;
  // the index loads first: the key (device rows) and the mono row wait on
  // them, everything else is issued behind them
  long long mrow = 0;
  if (MONO) mrow = __ldg(a.mono_rows + r);
  const size_t krow = DEV_ROWS ? (size_t)__ldg(a.rows + r)
                               : (size_t)a.row_of[r];
  const size_t n = a.n;
  const size_t off = (size_t)r * n + i;
  const size_t plane = (size_t)a.R * n;
  const size_t kplane = (size_t)a.key_rows * n;
  ulonglong2 x[NDIG], kb[NDIG], ka[NDIG];
#pragma unroll
  for (int d = 0; d < NDIG; ++d) x[d] = ld2(a.digits + d * plane + off);
  const u64 q = __ldg(a.q + r), mu = __ldg(a.mu + r);
  const u64 r64 = __ldg(a.r64 + r), r64p = __ldg(a.r64p + r);
  const size_t koff = krow * n + i;
#pragma unroll
  for (int d = 0; d < NDIG; ++d) {
    kb[d] = ld2(a.key_b + d * kplane + koff);
    ka[d] = ld2(a.key_a + d * kplane + koff);
  }
  ulonglong2 m = make_ulonglong2(0, 0);
  if (MONO) m = ld2(a.mono + (size_t)mrow * n + i);
  u64 lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};
#pragma unroll
  for (int d = 0; d < NDIG; ++d) {
    mac128(lo[0], hi[0], x[d].x, kb[d].x);
    mac128(lo[1], hi[1], x[d].y, kb[d].y);
    mac128(lo[2], hi[2], x[d].x, ka[d].x);
    mac128(lo[3], hi[3], x[d].y, ka[d].y);
  }
  u64 o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = reduce128(lo[j], hi[j], q, mu, r64, r64p);
  if (MONO) {
    o[0] = mul_mod_word(o[0], m.x, q, mu, r64, r64p);
    o[1] = mul_mod_word(o[1], m.y, q, mu, r64, r64p);
    o[2] = mul_mod_word(o[2], m.x, q, mu, r64, r64p);
    o[3] = mul_mod_word(o[3], m.y, q, mu, r64, r64p);
  }
  *reinterpret_cast<ulonglong2*>(a.out0 + off) = make_ulonglong2(o[0], o[1]);
  *reinterpret_cast<ulonglong2*>(a.out1 + off) = make_ulonglong2(o[2], o[3]);
}

template <int NDIG>
void launch_ks(const KsArgs& a, bool dev_rows, bool mono, dim3 grid,
               int threads, cudaStream_t s) {
  if (dev_rows && mono)
    ks_inner_product_kernel<NDIG, true, true><<<grid, threads, 0, s>>>(a);
  else if (dev_rows)
    ks_inner_product_kernel<NDIG, true, false><<<grid, threads, 0, s>>>(a);
  else if (mono)
    ks_inner_product_kernel<NDIG, false, true><<<grid, threads, 0, s>>>(a);
  else
    ks_inner_product_kernel<NDIG, false, false><<<grid, threads, 0, s>>>(a);
}

__global__ void fused_mac_kernel(const int64_t* x, const int64_t* y,
                                 const int64_t* acc, int R, int n,
                                 const int64_t* qs, const int64_t* mus,
                                 const int64_t* r64s, const int64_t* r64ps,
                                 int64_t* out) {
  const int r = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t k = (size_t)r * n + i;
  u64 lo = (u64)acc[k], hi = 0;
  mac128(lo, hi, (u64)x[k], (u64)y[k]);
  out[k] = (int64_t)reduce128(lo, hi, (u64)qs[r], (u64)mus[r], (u64)r64s[r],
                              (u64)r64ps[r]);
}

}  // namespace

// digits: [ndig, R, n]; key_b, key_a: [dnum, key_rows, n]; the key row of
// each output row from rows_dev ([R] on the device) or, when that is null,
// from rows_host ([R] host ints, R <= kMaxRowsByValue); q/mu/r64/r64p: [R];
// mono: [M, n] and mono_rows: [R], or both null; out0, out1: [R, n]. n is
// even and every data pointer 16-byte aligned (the wrapper checks).
extern "C" int ks_inner_product(const int64_t* digits, const int64_t* key_b,
                                const int64_t* key_a, const int64_t* rows_dev,
                                const int* rows_host, int ndig, int R,
                                int key_rows, int n, const int64_t* q,
                                const int64_t* mu, const int64_t* r64,
                                const int64_t* r64p, const int64_t* mono,
                                const int64_t* mono_rows, int64_t* out0,
                                int64_t* out1, cudaStream_t stream) {
  if (ndig < 1 || ndig > kMaxDigits || n % 2 != 0 || R < 1 ||
      (!rows_dev && (!rows_host || R > kMaxRowsByValue)) ||
      (!mono != !mono_rows))
    return (int)cudaErrorInvalidValue;
  KsArgs a;
  a.digits = (const u64*)digits;
  a.key_b = (const u64*)key_b;
  a.key_a = (const u64*)key_a;
  a.rows = (const long long*)rows_dev;
  a.q = (const u64*)q;
  a.mu = (const u64*)mu;
  a.r64 = (const u64*)r64;
  a.r64p = (const u64*)r64p;
  a.mono = (const u64*)mono;
  a.mono_rows = (const long long*)mono_rows;
  a.out0 = (u64*)out0;
  a.out1 = (u64*)out1;
  a.R = R;
  a.key_rows = key_rows;
  a.n = n;
  for (int r = 0; r < kMaxRowsByValue; ++r)
    a.row_of[r] = (!rows_dev && r < R) ? rows_host[r] : 0;
  int threads = (long long)R * n <= kSmallCall ? 64 : 256;
  while (threads > 32 && threads >= n) threads /= 2;  // n / 2 pairs a row
  a.blocks_per_row = (n / 2 + threads - 1) / threads;
  const dim3 grid((unsigned)R * a.blocks_per_row);
  const bool dev = rows_dev != nullptr, mo = mono != nullptr;
  switch (ndig) {
#define KS_CASE(D) \
  case D: launch_ks<D>(a, dev, mo, grid, threads, stream); break;
    KS_CASE(1) KS_CASE(2) KS_CASE(3) KS_CASE(4) KS_CASE(5)
    KS_CASE(6) KS_CASE(7) KS_CASE(8) KS_CASE(9) KS_CASE(10)
    KS_CASE(11) KS_CASE(12) KS_CASE(13) KS_CASE(14) KS_CASE(15)
#undef KS_CASE
  }
  return (int)cudaGetLastError();
}

// x, y, acc, out: [R, n]; q/mu/r64/r64p: [R].
extern "C" int fused_mac_mod(const int64_t* x, const int64_t* y,
                             const int64_t* acc, int R, int n,
                             const int64_t* q, const int64_t* mu,
                             const int64_t* r64, const int64_t* r64p,
                             int64_t* out, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const dim3 grid((n + kThreads - 1) / kThreads, R);
  fused_mac_kernel<<<grid, kThreads, 0, stream>>>(x, y, acc, R, n, q, mu, r64,
                                                  r64p, out);
  return (int)cudaGetLastError();
}
