// Negacyclic NTT (forward and inverse) for rings of n = 2 .. 2^11 over RNS
// towers, one launch per transform, for Hopper.
//
// Replaces the Pallas kernels openfhe_tpu/ops/ntt_pallas.py:282 `forward`
// and :293 `inverse` at these ring sizes (BINFHE's rings, scheme switching's
// FHEW side, the four-step's sub-transforms, the example programs). Bit-equal
// to them and to openfhe_tpu/ops/ntt.py: slot j holds p(psi^(2*bitrev(j)+1))
// mod q, reduced to [0, q); the inverse has 1/n folded in.
//
// Data: int64 [rows, n] (rows = batch * L towers, contiguous), tower
// l = row % L. The transform is the merged network of
// openfhe_tpu/ops/ntt.py:267-330 with psi folded into the twiddles, so there
// is no twist pass: forward runs Cooley-Tukey stages on index bits
// log2(n)-1 .. 0, inverse Gentleman-Sande stages on bits 0 .. log2(n)-1;
// the butterfly on bit b of element i reads twiddle (n + i) >> (b + 1) of
// the tower's table, psi^bitrev(j) forward and psi^-bitrev(j) inverse,
// each beside its Shoup precon as one 16-byte pair.
//
// Bounds, per call. Bytes: the data read and written once (16 per
// coefficient) and the tower tables (16 per tower coefficient): 16.4 KB at
// [1, 1024], 1.6 MB at [96, 1024], 1.07 GB at [65535, 1024], 320 us at
// 3.35 TB/s. Integer operations: n/2 log2 n butterflies a row at 16
// 32-bit operations (a Shoup product is ten multiply-adds, then three
// two-word additions; the count of csrc/ntt.cu), at 16.75e12 a second:
// 80 operations a coefficient at n = 1024, 320 us at [65535, 1024] as well.
// At the 1-96 rows of a blind-rotation step both bounds are 0.01-0.5 us,
// well under what one launch costs the card (a CUDA-graph replay of an
// empty one-block kernel, ../bench/launch_floor.cu): at those shapes the
// launch is the floor, so the design keeps each transform to one launch
// with a short critical path; at key generation's 2676-289,728 rows the
// bounds rule and the design keeps the integer pipe busy.
//
// What the design does about the generic radix-2 passes this replaces
// (csrc/ntt.cu, still there for n > 2^17):
//   1. One launch, not a column pass and a row pass: a ring of at most
//      2^11 words is 16 KB, and a block holds whole rows.
//   2. Geometry fixed at compile time: the kernel is a template on log2 n,
//      so every index is a shift or a mask and every loop unrolls.
//   3. Residues in registers: a thread holds 8 residues (all n of its row
//      for n < 8) and runs up to three stages on them with no barrier.
//      Rounds exchange through padded shared memory (one word of padding
//      per 8), one barrier per exchange: 1024 points are four rounds
//      (3 + 3 + 3 + 1 stages) and four barriers, not ten. Eight residues
//      rather than csrc/ntt.cu's sixteen: at 1-96 rows the critical path
//      of one thread is the time, and halving a thread's butterflies took
//      a third off it (3.7-4.6 us against 5.6-6.6 at [1-96, 1, 1024] on
//      an NVIDIA H100 80GB HBM3 at 700 W, bench/ntt_times.py), while key
//      generation's 65,535 rows moved by 2-6% either way. Loading the next
//      round's twiddles during a round did not pay at either width.
//   4. No twist: the merged tables carry psi.
//   5. A block holds one row for n >= 1024 (128 or 256 threads), 1024/n
//      rows for 8 <= n < 1024 (128 threads) and 128 rows of one thread
//      for n < 8. Rows sit on blockIdx.x, so there is no 65,535-row cap.
//      A ragged last block computes its missing rows on a copy of its last
//      row and stores nothing of them.
//   6. Lazy Harvey butterflies (modarith.cuh): values stay in [0, 4q)
//      forward and [0, 2q) inverse. Forward reduces once, on the way out;
//      inverse folds 1/n into its last stage, which alone reads twiddle 1
//      (psi^-bitrev(1)): (x + y) n^-1 and (x - y) psi^-bitrev(1) n^-1, two
//      eager Shoup products, so its output is reduced with no extra pass.
//   Twiddles go through the read-only path (__ldg), not through shared
//   memory: at 1-96 rows a block would read its whole table for a dozen
//   twiddles a thread. The first round's 7 twiddles are the same for every
//   thread of a row, one broadcast load each, issued before the row's
//   data. Each row reads its own tower's table, so a block may mix towers.
//   Global traffic is coalesced both ways: forward reads its first field
//   (the top three index bits vary, neighbouring threads on neighbouring
//   words) straight from global memory and leaves through shared memory,
//   whose linear tile it stores word by word; inverse is the mirror image.
// Moduli: every q < 2^62 that ops/modular.py admits (4q < 2^64 for the
// lazy forward). Residues are int64 in memory.
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

// Field width: a thread holds 2^kF residues of its row (fewer for n < 2^kF)
// and runs up to kF stages on them between exchanges.
constexpr int kF = 3;
constexpr int kBlockThreads = 128;

// Shared-memory slot of index i within a row: one word of padding per
// 2^kF. pad(a | b) = pad(a) + pad(b) when a and b share no bits.
__host__ __device__ constexpr int pad(int i) { return i + (i >> kF); }

// Per-size geometry: a thread holds E = 2^F residues of one row, the
// elements whose index bits P..P+F-1 vary in each round.
template <int LOG_N>
struct Geo {
  static constexpr int N = 1 << LOG_N;
  static constexpr int F = LOG_N < kF ? LOG_N : kF;
  static constexpr int E = 1 << F;
  static constexpr int LOG_TPR = LOG_N - F;  // threads a row, log2
  static constexpr int ROWS =
      LOG_N >= 10 ? 1
                  : (LOG_N >= kF ? (kBlockThreads << kF) >> LOG_N
                                 : kBlockThreads);
  static constexpr int THREADS = ROWS << LOG_TPR;
  static constexpr int NR = (LOG_N + F - 1) / F;  // rounds
  static constexpr int RS = pad(N);               // a row's shared words
};

// Round K: the stages on index bits BLO..BHI, run by a thread that holds
// the elements whose bits P..P+F-1 vary. Forward walks the bits downwards
// from LOG_N-1, inverse upwards from 0. Stage s of the round is on bit
// bit(s) and reads groups(s) twiddles, at tw[offset(s) ..] of the round's.
template <int LOG_N, bool FWD, int K>
struct Round {
  static constexpr int F = Geo<LOG_N>::F, E = Geo<LOG_N>::E;
  static constexpr bool kFwd = FWD;
  static constexpr int N = Geo<LOG_N>::N;
  static constexpr int kTop =
      F * K + F - 1 < LOG_N - 1 ? F * K + F - 1 : LOG_N - 1;
  static constexpr int BHI = FWD ? LOG_N - 1 - F * K : kTop;
  static constexpr int BLO = FWD ? (BHI > F - 1 ? BHI - F + 1 : 0) : F * K;
  static constexpr int P = FWD ? BLO : BHI - (F - 1);
  static constexpr int NS = BHI - BLO + 1;
  __host__ __device__ static constexpr int bit(int s) {
    return FWD ? BHI - s : BLO + s;
  }
  // the inverse's last stage reads the 1/n pairs instead
  __host__ __device__ static constexpr bool scaled(int s) {
    return !FWD && bit(s) == LOG_N - 1;
  }
  __host__ __device__ static constexpr int groups(int s) {
    return scaled(s) ? 0 : (E / 2) >> (bit(s) - P);
  }
  __host__ __device__ static constexpr int offset(int s) {
    int o = 0;
    for (int i = 0; i < s; ++i) o += groups(i);
    return o;
  }
  static constexpr int NTW = offset(NS) > 0 ? offset(NS) : 1;
  // index bits of thread u of a row outside the field P..P+F-1
  static __device__ __forceinline__ int ibase(int u) {
    return ((u >> P) << (P + F)) | (u & ((1 << P) - 1));
  }
};

// The twiddle pairs round R's stages S.. read, into w: stage s on bit b
// reads twiddle (n + i) >> (b + 1) for element i, so group g of the
// thread's elements reads ((n + ibase) >> (b + 1)) + g; base = n + ibase.
template <class R, int S = 0>
__device__ __forceinline__ void fetch(ulonglong2 (&w)[R::NTW],
                                      const ulonglong2* tw, int base) {
  if constexpr (S < R::NS) {
#pragma unroll
    for (int g = 0; g < R::groups(S); ++g)
      w[R::offset(S) + g] = __ldg(tw + (base >> (R::bit(S) + 1)) + g);
    fetch<R, S + 1>(w, tw, base);
  }
}

template <class R>
__device__ __forceinline__ void fetch_round(ulonglong2 (&w)[R::NTW],
                                            const ulonglong2* tw, int u) {
  fetch<R>(w, tw, R::N + R::ibase(u));
}

// One butterfly stage on field bit LAM of the E elements a thread holds:
// pairs (f, f | 1 << LAM), group g of them with the twiddle pair w[g].
template <int E, int LAM, bool FWD>
__device__ __forceinline__ void stage(u64 (&v)[E], const ulonglong2* w,
                                      u64 q, u64 q2) {
#pragma unroll
  for (int g = 0; g < ((E / 2) >> LAM); ++g) {
#pragma unroll
    for (int k = 0; k < (1 << LAM); ++k) {
      const int f = (g << (LAM + 1)) | k;
      if (FWD)
        ct_lazy(v[f], v[f | (1 << LAM)], w[g].x, w[g].y, q, q2);
      else
        gs_lazy(v[f], v[f | (1 << LAM)], w[g].x, w[g].y, q, q2);
    }
  }
}

// The inverse's last stage (bit LOG_N-1, the field's top bit, twiddle 1 for
// every pair) with 1/n folded in: sc[0] = n^-1, sc[1] = psi^-bitrev(1) n^-1,
// each with its precon. Inputs in [0, 2q), outputs reduced.
template <int E>
__device__ __forceinline__ void last_inverse_stage(u64 (&v)[E],
                                                   const ulonglong2* sc,
                                                   u64 q, u64 q2) {
  const ulonglong2 s0 = __ldg(sc), s1 = __ldg(sc + 1);
#pragma unroll
  for (int f = 0; f < E / 2; ++f) {
    const u64 x = v[f], y = v[f + E / 2];
    v[f] = mul_shoup(x + y, s0.x, s0.y, q);
    v[f + E / 2] = mul_shoup(x - y + q2, s1.x, s1.y, q);
  }
}

// The stages of round R on the thread's field, with the round's twiddles w.
template <class R, int S = 0>
__device__ __forceinline__ void round_stages(u64 (&v)[R::E],
                                             const ulonglong2 (&w)[R::NTW],
                                             const ulonglong2* sc, u64 q,
                                             u64 q2) {
  if constexpr (S < R::NS) {
    if constexpr (R::scaled(S))
      last_inverse_stage<R::E>(v, sc, q, q2);
    else
      stage<R::E, R::bit(S) - R::P, R::kFwd>(v, w + R::offset(S), q, q2);
    round_stages<R, S + 1>(v, w, sc, q, q2);
  }
}

// A thread's field of round R between registers and its row in shared
// memory.
template <class R>
__device__ __forceinline__ void load_field(u64 (&v)[R::E], const u64* row,
                                           int u) {
  const u64* p = row + pad(R::ibase(u));
#pragma unroll
  for (int f = 0; f < R::E; ++f) v[f] = p[pad(f << R::P)];
}

template <class R>
__device__ __forceinline__ void store_field(const u64 (&v)[R::E], u64* row,
                                            int u) {
  u64* p = row + pad(R::ibase(u));
#pragma unroll
  for (int f = 0; f < R::E; ++f) p[pad(f << R::P)] = v[f];
}

// Rounds K .. NR-1 of one row: v holds round K's field on entry and the last
// round's on exit, w round K's twiddles; between rounds the fields go
// through the row's shared memory. A round writes the slots it read, so one
// barrier per exchange is all the ordering needed.
template <int LOG_N, bool FWD, int K>
__device__ __forceinline__ void rounds(
    u64 (&v)[Geo<LOG_N>::E], ulonglong2 (&w)[Round<LOG_N, FWD, K>::NTW],
    u64* row, int u, const ulonglong2* tw, const ulonglong2* sc, u64 q,
    u64 q2) {
  using R = Round<LOG_N, FWD, K>;
  if constexpr (K + 1 < Geo<LOG_N>::NR) {
    using RN = Round<LOG_N, FWD, K + 1>;
    round_stages<R>(v, w, sc, q, q2);
    store_field<R>(v, row, u);
    __syncthreads();
    ulonglong2 wn[RN::NTW];
    fetch_round<RN>(wn, tw, u);
    load_field<RN>(v, row, u);
    rounds<LOG_N, FWD, K + 1>(v, wn, row, u, tw, sc, q, q2);
  } else {
    round_stages<R>(v, w, sc, q, q2);
  }
}

// Shared-memory slot of word e of a block's linear tile (whole rows one
// after another).
template <int LOG_N>
__device__ __forceinline__ int tile_slot(int e) {
  return (e >> LOG_N) * Geo<LOG_N>::RS + pad(e & ((1 << LOG_N) - 1));
}

// Geo::ROWS rows of x into y, each through the whole network. tw: [L, n]
// (w, precon) pairs of the direction; sc: [L, 2] 1/n pairs (inverse only).
template <int LOG_N, bool FWD>
__global__ void __launch_bounds__(Geo<LOG_N>::THREADS)
ntt_small_kernel(const u64* x, u64* y, int rows, int L, const u64* qs,
                 const ulonglong2* tw, const ulonglong2* sc) {
  using G = Geo<LOG_N>;
  constexpr int E = G::E, T = G::THREADS;
  using R0 = Round<LOG_N, FWD, 0>;
  using RL = Round<LOG_N, FWD, G::NR - 1>;
  __shared__ u64 sh[G::NR > 1 ? G::ROWS * G::RS : 1];
  const int tid = threadIdx.x;
  const int rb = tid >> G::LOG_TPR, u = tid & ((1 << G::LOG_TPR) - 1);
  const size_t row0 = (size_t)blockIdx.x * G::ROWS;
  const size_t left = (size_t)rows - row0;
  const int valid = left < (size_t)G::ROWS ? (int)left : G::ROWS;
  const size_t row = row0 + (rb < valid ? rb : valid - 1);
  const int l = (int)(row % L);
  const u64 q = __ldg(qs + l), q2 = 2 * q;
  const ulonglong2* t = tw + ((size_t)l << LOG_N);
  const ulonglong2* s = sc + 2 * l;
  u64* srow = sh + rb * G::RS;
  u64 v[E];
  ulonglong2 w[R0::NTW];
  fetch_round<R0>(w, t, u);
  if constexpr (G::NR == 1) {  // n <= 2^kF: the thread holds its whole row
    const u64* xr = x + (row << LOG_N);
#pragma unroll
    for (int f = 0; f < E; ++f) v[f] = xr[f];
    round_stages<R0>(v, w, s, q, q2);
    if (rb < valid) {
      u64* yr = y + (row << LOG_N);
#pragma unroll
      for (int f = 0; f < E; ++f) yr[f] = FWD ? reduce_4q(v[f], q, q2) : v[f];
    }
  } else if constexpr (FWD) {
    // round 0's field: words u + f * n/E of the row, coalesced
    const u64* xr = x + (row << LOG_N) + R0::ibase(u);
#pragma unroll
    for (int f = 0; f < E; ++f) v[f] = xr[f << R0::P];
    rounds<LOG_N, true, 0>(v, w, srow, u, t, s, q, q2);
    // reduced by the row's own modulus, then out through the linear tile
#pragma unroll
    for (int f = 0; f < E; ++f) v[f] = reduce_4q(v[f], q, q2);
    store_field<RL>(v, srow, u);
    __syncthreads();
    u64* yt = y + (row0 << LOG_N);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int e = tid + k * T;
      if ((e >> LOG_N) < valid) yt[e] = sh[tile_slot<LOG_N>(e)];
    }
  } else {
    const u64* xt = x + (row0 << LOG_N);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int e = tid + k * T;
      if ((e >> LOG_N) < valid) sh[tile_slot<LOG_N>(e)] = xt[e];
    }
    __syncthreads();
    load_field<R0>(v, srow, u);
    rounds<LOG_N, false, 0>(v, w, srow, u, t, s, q, q2);
    if (rb < valid) {  // the last field: words u + f * n/E, coalesced
      u64* yr = y + (row << LOG_N) + RL::ibase(u);
#pragma unroll
      for (int f = 0; f < E; ++f) yr[f << RL::P] = v[f];
    }
  }
}

template <int LOG_N, bool FWD>
cudaError_t launch(const u64* x, u64* y, int rows, int L, const u64* q,
                   const ulonglong2* tw, const ulonglong2* sc,
                   cudaStream_t stream) {
  using G = Geo<LOG_N>;
  const unsigned blocks =
      (unsigned)(((long long)rows + G::ROWS - 1) / G::ROWS);
  ntt_small_kernel<LOG_N, FWD><<<blocks, G::THREADS, 0, stream>>>(
      x, y, rows, L, q, tw, sc);
  return cudaGetLastError();
}

template <bool FWD>
int run(const int64_t* x, int64_t* y, int rows, int L, int log_n,
        const int64_t* q, const int64_t* tw, const int64_t* sc,
        cudaStream_t s) {
  if (rows < 1 || L < 1 || rows % L) return (int)cudaErrorInvalidValue;
  const u64* xi = (const u64*)x;
  u64* yo = (u64*)y;
  const u64* qi = (const u64*)q;
  const ulonglong2* t = (const ulonglong2*)tw;
  const ulonglong2* c = (const ulonglong2*)sc;
  switch (log_n) {
#define NTT_SMALL(B) \
  case B: return (int)launch<B, FWD>(xi, yo, rows, L, qi, t, c, s);
    NTT_SMALL(1) NTT_SMALL(2) NTT_SMALL(3) NTT_SMALL(4) NTT_SMALL(5)
    NTT_SMALL(6) NTT_SMALL(7) NTT_SMALL(8) NTT_SMALL(9) NTT_SMALL(10)
    NTT_SMALL(11)
#undef NTT_SMALL
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: [rows, 2^log_n], rows a multiple of L, log_n in 1..11; q: [L];
// tw: [L, 2^log_n, 2] psi^bitrev(j) and its precon.
extern "C" int ntt_small_forward(const int64_t* x, int64_t* y, int rows,
                                 int L, int log_n, const int64_t* q,
                                 const int64_t* tw, const int64_t* sc,
                                 cudaStream_t stream) {
  return run<true>(x, y, rows, L, log_n, q, tw, sc, stream);
}

// Same layout; tw holds psi^-bitrev(j) and its precon, sc: [L, 2, 2] the
// pairs (n^-1, precon) and (psi^-bitrev(1) n^-1, precon).
extern "C" int ntt_small_inverse(const int64_t* x, int64_t* y, int rows,
                                 int L, int log_n, const int64_t* q,
                                 const int64_t* tw, const int64_t* sc,
                                 cudaStream_t stream) {
  return run<false>(x, y, rows, L, log_n, q, tw, sc, stream);
}
