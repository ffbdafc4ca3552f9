// Negacyclic NTT (forward and inverse) over RNS towers, four-step, for Hopper.
//
// Replaces the Pallas kernels openfhe_tpu/ops/ntt_pallas.py `forward`
// (_fwd_kernel) and `inverse` (_inv_kernel). Bit-equal to their output and
// to openfhe_tpu/ops/ntt.py: slot j holds p(psi^(2*bitrev(j)+1)).
//
// Data: int64 [rows, n1, n2] (rows = batch * L towers, contiguous), tower
// l = row % L. Forward:
//   column pass: n1-point Cooley-Tukey NTT down every column, then multiply
//                by the twist T[l, c1, j2];
//   row pass:    n2-point Cooley-Tukey NTT along every row.
// The row-major [c1, c2] result is ntt.forward's bit-reversed order, so no
// transpose is needed. Inverse runs the passes in reverse with
// Gentleman-Sande butterflies: rows, then the untwist (1/n folded in) and
// columns. Twiddles are the flat bit-reversed tables of the sub-transforms:
// the butterfly on index bit b of element i reads entry (R + i) >> (b + 1).
//
// Two bounds, per call (each input and output byte counted once, whatever a
// two-pass transform reads again). Bytes: 16 per coefficient of data (read
// and written) plus 16 per tower coefficient of twist and precon: 16.8 MB
// for the [8, 65536] ciphertext, 46.1 MB for the keyswitch mod-up
// [3, 11, 65536], 5.0 and 13.8 us at 3.35 TB/s. Integer operations: a
// butterfly is one Shoup product (ten 32-bit multiply-adds: a 64x64 high
// word and two low words) and three two-word additions, 16 operations, a
// twist 12; at 64 INT32 lanes on each of 132 SMs at 1.98 GHz (16.7e12 a
// second) the 17.3 M butterflies and 2.2 M twists of [3, 11, 65536] need
// 18.1 us, the [8, 65536] call 4.4 us. So the large batch is bound by the
// integer pipe and the single ciphertext by bytes, and a design has to keep
// everything that is not a butterfly off the instruction stream. The count
// of 16 is generous to the card: ../bench/butterfly.cu times a loop of
// nothing but lazy butterflies in registers, and an SM partition of an
// NVIDIA H100 80GB HBM3 at 700 W starts one per warp every 44 clocks, not 32,
// which alone is 25 us at [3, 11, 65536].
//
// Design of the main path (n = 2^12 .. 2^17, sub-transforms of R = 64 ..
// 512 points, kernels templated on log2 R so every index is a shift or a
// mask and every loop unrolls):
//   * A thread holds 16 residues in registers and runs up to four butterfly
//     stages on them with no shared-memory traffic and no barrier. A 256-point
//     sub-transform is two such rounds with one exchange through shared memory
//     between them; R = 128 and 64 end in a radix-8 or radix-4 round, R = 512
//     takes a third, radix-2 round. A pass has one barrier after the tile is
//     staged and one after each round (3 at R = 256) where the radix-2 passes
//     below take one per stage (8).
//   * Lazy (Harvey) butterflies, modarith.cuh: values stay in [0, 4q)
//     through the forward stages and [0, 2q) through the inverse ones; the
//     pass's last store reduces once (the forward twist's Shoup product
//     absorbs the reduction for free).
//   * The tower's sub-transform table is staged into shared memory beside
//     the tile as (w, precon) pairs, one 16-byte shared load per twiddle;
//     the first round's 15 twiddles are the same for the whole block and
//     broadcast.
//   * Tile: 2048 words (16 KB + 1/16 padding, so both the coalesced and the
//     strided access of a half-warp fall on 16 different banks) and 128
//     threads per block, one tile per block. [8, 65536] gives 256 blocks a
//     pass, two per SM, and some five blocks fit an SM (registers bind), so
//     the loads and barriers of one block hide behind the butterflies of
//     the others. 1024- and 4096-word tiles were slower at the single
//     ciphertext or the single tower and no faster at the batch.
//   * Global traffic is 8 bytes a thread in runs of a full 64 bytes (column
//     pass, 8 adjacent columns) or the whole 16 KB tile (row pass), straight
//     into registers. All 16 loads of a thread are started before the first
//     is used. The passes are bound by instruction throughput, not by
//     memory: cold, each pass of [3, 11, 65536] moves its bytes at about
//     half the memory rate. Staging the tile by cp.async into a second
//     shared-memory buffer while a block works on the previous tile,
//     prefetching the next tile into registers, and cutting the batch into
//     L2-sized chunks were each built and measured slower at every batch
//     size (the extra trip through shared memory, the lost occupancy, the
//     shorter grids), so blocks stay independent and the SM's scheduler
//     overlaps them. Joining the passes by programmatic dependent launch
//     took a microsecond off some shapes and added one to others, and
//     nothing off an operation's device time.
//   * Twist tables go through the read-only path, and the column pass's grid
//     runs the digits of a [ndig, L, n] batch that share a tower's twist tile
//     next to each other, so all but the first find it in L2.
// Tensor cores do not apply: the butterflies are exact 60-bit modular
// products.
//
// Rings above 2^17 take the generic radix-2 passes at the end of this file:
// one butterfly per thread and stage in shared memory, eager reduction,
// geometry as run-time arguments. The entry points pick by n1 and n2 alone,
// and refuse rings below 2^12: those take the one-launch kernels of
// ntt_small.cu.
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

// ---------------------------------------------------------------------------
// Main path: register-resident radix-16 rounds, geometry known at compile time
// ---------------------------------------------------------------------------

constexpr int kLogTile = 11;
constexpr int kTile = 1 << kLogTile;      // words per block
constexpr int kFastThreads = kTile / 16;  // 16 residues per thread
constexpr int kMinLogR = 6, kMaxLogR = 9;

// Shared-memory slot of transform index i: one word of padding per 16.
// pad16(a | b) = pad16(a) + pad16(b) when a and b share no bits.
__host__ __device__ constexpr int pad16(int i) { return i + (i >> 4); }

// Slot of twiddle j in the shared table: one pair of padding per 8, so the
// threads of a quarter-warp that read 8 (4, 2) consecutive pairs each, 8 (4,
// 2) pairs apart, fall on different banks. padtw(t + g) = padtw(t) + g for
// the g < 8 >> LAM pairs a stage reads from a multiple t of 8 >> LAM.
__host__ __device__ constexpr int padtw(int j) { return j + (j >> 3); }

// Round K of a size-2^LOG_R transform: the stages on index bits BLO..BHI, run
// by a thread that holds the 16 elements whose index bits P..P+3 vary.
// Forward walks the bits downwards from LOG_R-1, inverse upwards from 0.
template <int LOG_R, bool FWD, int K>
struct Round {
  static constexpr int kTop = 4 * K + 3 < LOG_R - 1 ? 4 * K + 3 : LOG_R - 1;
  static constexpr int BHI = FWD ? LOG_R - 1 - 4 * K : kTop;
  static constexpr int BLO = FWD ? (BHI > 3 ? BHI - 3 : 0) : 4 * K;
  static constexpr int P = FWD ? BLO : BHI - 3;
  // index bits of thread u in [0, R/16) outside the field P..P+3
  static __device__ __forceinline__ int ibase(int u) {
    return ((u >> P) << (P + 4)) | (u & ((1 << P) - 1));
  }
};

// One butterfly stage on bit LAM of the 16 elements a thread holds: pairs
// (f, f | 1 << LAM), group g of them with the twiddle pair t[g]. Every loop
// bound is a template constant, so v stays in registers.
template <int LAM, bool FWD>
__device__ __forceinline__ void stage(u64 (&v)[16], const ulonglong2* t,
                                      u64 q, u64 q2) {
#pragma unroll
  for (int g = 0; g < (8 >> LAM); ++g) {
    const ulonglong2 wv = t[g];
#pragma unroll
    for (int k = 0; k < (1 << LAM); ++k) {
      const int f = (g << (LAM + 1)) | k;
      if (FWD)
        ct_lazy(v[f], v[f | (1 << LAM)], wv.x, wv.y, q, q2);
      else
        gs_lazy(v[f], v[f | (1 << LAM)], wv.x, wv.y, q, q2);
    }
  }
}

// The stages on bits LAM0..LAM1 of v (downwards forward, upwards inverse) for
// the thread whose elements are (ibase | f << p) of a size-2^LOG_R transform:
// the butterfly on index bit b reads twiddle (R + i) >> (b + 1). tw: the
// tower's (w, precon) pairs, bit-reversed. p may be a run-time value.
template <int LOG_R, int LAM0, int LAM1, bool FWD, int S = 0>
__device__ __forceinline__ void stages16(u64 (&v)[16], int ibase, int p,
                                         const ulonglong2* tw, u64 q, u64 q2) {
  if constexpr (S <= LAM1 - LAM0) {
    constexpr int LAM = FWD ? LAM1 - S : LAM0 + S;
    stage<LAM, FWD>(
        v, tw + padtw(((1 << LOG_R) + ibase) >> (p + LAM + 1)), q, q2);
    stages16<LOG_R, LAM0, LAM1, FWD, S + 1>(v, ibase, p, tw, q, q2);
  }
}

// A thread's 16 elements of round G between registers and the transform in
// shared memory at lane[pad16(i) * STRIDE].
template <class G, int STRIDE>
__device__ __forceinline__ void load_field(u64 (&v)[16], const u64* lane,
                                           int u) {
  const u64* p = lane + pad16(G::ibase(u)) * STRIDE;
#pragma unroll
  for (int f = 0; f < 16; ++f) v[f] = p[pad16(f << G::P) * STRIDE];
}

template <class G, int STRIDE>
__device__ __forceinline__ void store_field(const u64 (&v)[16], u64* lane,
                                            int u) {
  u64* p = lane + pad16(G::ibase(u)) * STRIDE;
#pragma unroll
  for (int f = 0; f < 16; ++f) p[pad16(f << G::P) * STRIDE] = v[f];
}

// All rounds of one transform; u in [0, R/16) is the thread's place within
// it. With IN, round 0 finds its 16 elements already in v (the caller loaded
// them from global memory), otherwise in shared memory; with OUT, the last
// round hands its elements to io.store, otherwise it leaves them in shared
// memory behind a barrier. Between rounds the elements go through shared
// memory: a round writes the slots it read, so one barrier per exchange is
// all the ordering needed.
//
// The first LOG_R / 4 rounds are full radix-16 rounds with the same
// butterflies on v; when there are two of them they run as one loop whose
// body holds the stage code once, with the field position as a run-time
// value. Unrolled, a pass is some 2,700 instructions, which the instruction
// cache does not hold; the loop brings it near 1,700.
template <int LOG_R, bool FWD, int STRIDE, bool IN, bool OUT, class Io>
__device__ __forceinline__ void transform(u64 (&v)[16], u64* lane, int u,
                                          const ulonglong2* tw, u64 q, u64 q2,
                                          const Io& io) {
  constexpr int NR = (LOG_R + 3) / 4, NFULL = LOG_R / 4;
  static_assert(NFULL == 1 || NFULL == 2, "sub-transforms of 16 .. 2048");
  using G0 = Round<LOG_R, FWD, 0>;
  using GF = Round<LOG_R, FWD, NFULL - 1>;  // last full round
  using GE = Round<LOG_R, FWD, NR - 1>;     // last round
  if constexpr (!IN) load_field<G0, STRIDE>(v, lane, u);
  if constexpr (NFULL == 2) {
#pragma unroll 1
    for (int k = 0; k < 2; ++k) {
      stages16<LOG_R, 0, 3, FWD>(v, k ? GF::ibase(u) : G0::ibase(u),
                                 k ? GF::P : G0::P, tw, q, q2);
      if (k == 0) {
        store_field<G0, STRIDE>(v, lane, u);
        __syncthreads();
        load_field<GF, STRIDE>(v, lane, u);
      }
    }
  } else {
    stages16<LOG_R, 0, 3, FWD>(v, G0::ibase(u), G0::P, tw, q, q2);
  }
  if constexpr (NR > NFULL) {  // a last round of fewer than four stages
    store_field<GF, STRIDE>(v, lane, u);
    __syncthreads();
    load_field<GE, STRIDE>(v, lane, u);
    stages16<LOG_R, GE::BLO - GE::P, GE::BHI - GE::P, FWD>(
        v, GE::ibase(u), GE::P, tw, q, q2);
  }
  if constexpr (OUT) {
    io.template store<GE::P>(v, GE::ibase(u));
  } else {
    store_field<GE, STRIDE>(v, lane, u);
    __syncthreads();
  }
}

template <int LOG_R>
__device__ __forceinline__ void stage_twiddles(ulonglong2* tw, const u64* w,
                                               const u64* wp, int l) {
  constexpr int R = 1 << LOG_R;
  for (int j = threadIdx.x; j < R; j += kFastThreads)
    tw[padtw(j)] = make_ulonglong2(__ldg(w + (size_t)l * R + j),
                                   __ldg(wp + (size_t)l * R + j));
}

// Shared-memory slot of word e of a row pass's linear tile (whole padded
// transforms one after another); additive over words that share no bits.
template <int LOG_R>
__host__ __device__ constexpr int tile_slot(int e) {
  return (e >> LOG_R) * pad16(1 << LOG_R) + pad16(e & ((1 << LOG_R) - 1));
}

// Global side of a row pass for one thread: x and y point at its transform
// and twist, twistp at the tower's twist and precon for it; element i of the
// field (ibase | f << P) is word i. Offsets between the 16 elements are
// compile-time constants. Forward twists as it loads: the column pass left
// its values unreduced, and the lazy Shoup product takes any 64-bit value.
// Inverse stores its values unreduced, in [0, 2q), for the column pass's
// untwist to absorb.
struct RowIo {
  const u64* x;
  u64* y;
  const u64* twist;
  const u64* twistp;
  u64 q;
  template <int P>
  __device__ __forceinline__ void load(u64 (&v)[16], int ibase) const {
#pragma unroll
    for (int f = 0; f < 16; ++f) v[f] = x[ibase + (f << P)];
#pragma unroll
    for (int f = 0; f < 16; ++f) {
      const int i = ibase + (f << P);
      v[f] = mul_shoup_lazy(v[f], __ldg(twist + i), __ldg(twistp + i), q);
    }
  }
  template <int P>
  __device__ __forceinline__ void store(const u64 (&v)[16], int ibase) const {
#pragma unroll
    for (int f = 0; f < 16; ++f) y[ibase + (f << P)] = v[f];
  }
};

// kTile / R whole rows of R contiguous words: a linear 16 KB tile of x.
// Forward loads a thread's first field straight from global memory (runs of
// R/16 words across neighbouring threads), twists it, and leaves through
// shared memory, because the last field is 16 contiguous words per thread;
// inverse is the mirror image without the twist. Block b of the grid takes
// batch entry b % B first, so the B blocks that share a twist tile run
// together. x and y may alias: a block reads its whole tile before it writes
// any of it.
template <int LOG_R, bool FWD>
__global__ void __launch_bounds__(kFastThreads)
row_pass_fast(const u64* x, u64* y, int L, int B, int log_n, const u64* qs,
              const u64* w, const u64* wp, const u64* twist,
              const u64* twistp) {
  constexpr int R = 1 << LOG_R, RS = pad16(R), NT = kFastThreads;
  __shared__ ulonglong2 tw[padtw(R)];
  __shared__ u64 sh[pad16(kTile)];
  const int tid = threadIdx.x;
  const int d = blockIdx.x % B;
  const size_t tbase = (size_t)(blockIdx.x / B) * kTile;  // within [L, n]
  const size_t base = ((size_t)d * L << log_n) + tbase;
  const int l = (int)(tbase >> log_n);
  const u64 q = __ldg(qs + l), q2 = 2 * q;
  const int tr = tid >> (LOG_R - 4), u = tid & (R / 16 - 1);
  // word tid + k * NT of the tile sits at lin[tile_slot<LOG_R>(k * NT)]: tid
  // and k * NT share no bits
  u64* lin = sh + tile_slot<LOG_R>(tid);
  const RowIo io{x + base + tr * R, y + base + tr * R,
                 twist + tbase + tr * R, twistp + tbase + tr * R, q};
  u64 v[16];
  if (FWD) {
    using G = Round<LOG_R, true, 0>;
    io.template load<G::P>(v, G::ibase(u));
    stage_twiddles<LOG_R>(tw, w, wp, l);
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = x[base + tid + k * NT];
    stage_twiddles<LOG_R>(tw, w, wp, l);
#pragma unroll
    for (int k = 0; k < 16; ++k) lin[tile_slot<LOG_R>(k * NT)] = v[k];
  }
  __syncthreads();
  transform<LOG_R, FWD, 1, FWD, !FWD>(v, sh + tr * RS, u, tw, q, q2, io);
  if (FWD) {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      y[base + tid + k * NT] =
          reduce_4q(lin[tile_slot<LOG_R>(k * NT)], q, q2);
  }
}

// Global side of a column pass for one thread: every pointer is at the
// thread's column (of the data, and of the tower's twist and its precon);
// element i is i << LOG_N2 words further, a compile-time offset within the
// field. Inverse untwists as it loads and stores reduced residues; forward
// stores its values unreduced, in [0, 4q), for the row pass's twist to
// absorb.
template <int LOG_N2, bool FWD>
struct ColIo {
  const u64* x;
  u64* y;
  const u64* twist;
  const u64* twistp;
  u64 q;
  template <int P>
  __device__ __forceinline__ void load(u64 (&v)[16], int ibase) const {
    const int o = ibase << LOG_N2;
#pragma unroll
    for (int f = 0; f < 16; ++f) v[f] = x[o + (f << (P + LOG_N2))];
    if (!FWD) {
#pragma unroll
      for (int f = 0; f < 16; ++f) {
        const int of = o + (f << (P + LOG_N2));
        v[f] = mul_shoup_lazy(v[f], __ldg(twist + of), __ldg(twistp + of), q);
      }
    }
  }
  template <int P>
  __device__ __forceinline__ void store(const u64 (&v)[16], int ibase) const {
    const int o = ibase << LOG_N2;
#pragma unroll
    for (int f = 0; f < 16; ++f) {
      y[o + (f << (P + LOG_N2))] = FWD ? v[f] : reduce_2q(v[f], q);
    }
  }
};

// kTile / R adjacent columns of one tower; inverse untwists before the
// stages. Both ends go straight between global memory and registers:
// whatever field a thread holds, neighbouring threads hold neighbouring
// columns. Block b of the grid takes batch entry b % B first, so
// the B blocks that share a twist tile run together. x and y may alias: a
// block has read its whole tile before the barrier that precedes its writes.
template <int LOG_R, int LOG_N2, bool FWD>
__global__ void __launch_bounds__(kFastThreads)
col_pass_fast(const u64* x, u64* y, int L, int B, const u64* qs, const u64* w,
              const u64* wp, const u64* twist, const u64* twistp) {
  constexpr int R = 1 << LOG_R, LOG_C = kLogTile - LOG_R, TC = 1 << LOG_C;
  constexpr int NCB = (1 << LOG_N2) >> LOG_C;  // column tiles in a tower
  __shared__ ulonglong2 tw[padtw(R)];
  __shared__ u64 sh[pad16(kTile)];
  const int tid = threadIdx.x;
  const int d = blockIdx.x % B, rest = blockIdx.x / B;
  const int cb = rest % NCB, l = rest / NCB;
  const u64 q = __ldg(qs + l), q2 = 2 * q;
  const int c = tid & (TC - 1), u = tid >> LOG_C;
  const size_t tcol = ((size_t)l << (LOG_R + LOG_N2)) + (size_t)cb * TC + c;
  const size_t col = ((size_t)d * L << (LOG_R + LOG_N2)) + tcol;
  const ColIo<LOG_N2, FWD> io{x + col, y + col, twist + tcol, twistp + tcol, q};
  using G = Round<LOG_R, FWD, 0>;
  u64 v[16];
  io.template load<G::P>(v, G::ibase(u));
  stage_twiddles<LOG_R>(tw, w, wp, l);
  __syncthreads();
  transform<LOG_R, FWD, TC, true, true>(v, sh + c, u, tw, q, q2, io);
}

int log2_exact(int v) {
  int b = 0;
  while ((1 << b) < v) ++b;
  return (1 << b) == v ? b : -1;
}

// The main path takes the balanced splits of n = 2^12 .. 2^17.
bool fast_geometry(int n1, int n2) {
  const int b1 = log2_exact(n1), b2 = log2_exact(n2);
  return b2 >= kMinLogR && b2 < kMaxLogR && (b1 == b2 || b1 == b2 + 1);
}

template <int LOG_R, bool FWD>
cudaError_t launch_rows(const u64* x, u64* y, int rows, int L, int log_n1,
                        const u64* q, const u64* w, const u64* wp,
                        const u64* tw, const u64* twp, cudaStream_t stream) {
  const int log_n = log_n1 + LOG_R;
  const unsigned blocks = (unsigned)(((size_t)rows << log_n) >> kLogTile);
  row_pass_fast<LOG_R, FWD><<<blocks, kFastThreads, 0, stream>>>(
      x, y, L, rows / L, log_n, q, w, wp, tw, twp);
  return cudaGetLastError();
}

template <int LOG_R, int LOG_N2, bool FWD>
cudaError_t launch_cols(const u64* x, u64* y, int rows, int L, const u64* q,
                        const u64* w, const u64* wp, const u64* tw,
                        const u64* twp, cudaStream_t stream) {
  const unsigned blocks =
      (unsigned)(((size_t)rows << (LOG_R + LOG_N2)) >> kLogTile);
  col_pass_fast<LOG_R, LOG_N2, FWD><<<blocks, kFastThreads, 0, stream>>>(
      x, y, L, rows / L, q, w, wp, tw, twp);
  return cudaGetLastError();
}

template <bool FWD>
cudaError_t rows_fast(const u64* x, u64* y, int rows, int L, int n1, int n2,
                      const u64* q, const u64* w, const u64* wp,
                      const u64* tw, const u64* twp, cudaStream_t s) {
#define NTT_ROWS(R) \
  launch_rows<R, FWD>(x, y, rows, L, log2_exact(n1), q, w, wp, tw, twp, s)
  switch (log2_exact(n2)) {
    case 6: return NTT_ROWS(6);
    case 7: return NTT_ROWS(7);
    default: return NTT_ROWS(8);
  }
#undef NTT_ROWS
}

template <bool FWD>
cudaError_t cols_fast(const u64* x, u64* y, int rows, int L, int n1, int n2,
                      const u64* q, const u64* w, const u64* wp,
                      const u64* tw, const u64* twp, cudaStream_t s) {
#define NTT_COLS(R, N2) \
  launch_cols<R, N2, FWD>(x, y, rows, L, q, w, wp, tw, twp, s)
  switch (log2_exact(n1) + log2_exact(n2)) {
    case 12: return NTT_COLS(6, 6);
    case 13: return NTT_COLS(7, 6);
    case 14: return NTT_COLS(7, 7);
    case 15: return NTT_COLS(8, 7);
    case 16: return NTT_COLS(8, 8);
    default: return NTT_COLS(9, 8);
  }
#undef NTT_COLS
}

// ---------------------------------------------------------------------------
// Generic path: radix-2 stages in shared memory, geometry at run time
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTileWords = 4096;

// All log2(R) butterfly stages of `lanes` independent size-R transforms held
// in shared memory; element i of lane c sits at sh[i * es + c * ls].
template <bool FWD>
__device__ void stages(u64* sh, int R, int lanes, int es, int ls,
                       const u64* w, const u64* wp, u64 q) {
  const int half = R >> 1;
  const int total = half * lanes;
  int t = FWD ? half : 1;
  for (int s = 1; s < R; s <<= 1) {
    // forward: m = s groups of half-size t = R/(2m); inverse: h = R/(2s)
    // groups of half-size t = s
    const int groups = FWD ? s : half / s;
    for (int b = threadIdx.x; b < total; b += blockDim.x) {
      int c, k;
      if (es == 1) {  // rows: neighbouring threads on neighbouring words
        k = b % half;
        c = b / half;
      } else {        // columns: neighbouring threads on neighbouring lanes
        c = b % lanes;
        k = b / lanes;
      }
      const int g = k / t;
      const int i0 = 2 * g * t + (k - g * t);
      u64* p0 = sh + i0 * es + c * ls;
      u64* p1 = p0 + t * es;
      const u64 wv = w[groups + g];
      const u64 wpv = wp[groups + g];
      const u64 u = *p0;
      if (FWD) {
        const u64 v = mul_shoup(*p1, wv, wpv, q);
        *p0 = add_mod(u, v, q);
        *p1 = sub_mod(u, v, q);
      } else {
        const u64 v = *p1;
        *p0 = add_mod(u, v, q);
        *p1 = mul_shoup(sub_mod(u, v, q), wv, wpv, q);
      }
    }
    __syncthreads();
    t = FWD ? t >> 1 : t << 1;
  }
}

// Columns of TC adjacent j2 for one tower; forward twists after the stages,
// inverse untwists before them. x and y may alias: a block reads its whole
// tile before it writes any of it.
template <bool FWD>
__global__ void col_pass(const u64* x, u64* y, int L, int n1, int n2, int TC,
                         const u64* qs, const u64* w, const u64* wp,
                         const u64* tw, const u64* twp) {
  extern __shared__ u64 sh[];
  const int row = blockIdx.y;
  const int l = row % L;
  const int c0 = blockIdx.x * TC;
  const u64 q = qs[l];
  const size_t base = (size_t)row * n1 * n2;
  const size_t tbase = (size_t)l * n1 * n2;
  const int total = n1 * TC;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx / TC;
    const size_t off = (size_t)r * n2 + c0 + (idx - r * TC);
    u64 v = x[base + off];
    if (!FWD) v = mul_shoup(v, tw[tbase + off], twp[tbase + off], q);
    sh[idx] = v;
  }
  __syncthreads();
  stages<FWD>(sh, n1, TC, TC, 1, w + (size_t)l * n1, wp + (size_t)l * n1, q);
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx / TC;
    const size_t off = (size_t)r * n2 + c0 + (idx - r * TC);
    u64 v = sh[idx];
    if (FWD) v = mul_shoup(v, tw[tbase + off], twp[tbase + off], q);
    y[base + off] = v;
  }
}

// TR whole rows (contiguous n2 words each) for one tower.
template <bool FWD>
__global__ void row_pass(const u64* x, u64* y, int L, int n1, int n2, int TR,
                         const u64* qs, const u64* w, const u64* wp) {
  extern __shared__ u64 sh[];
  const int row = blockIdx.y;
  const int l = row % L;
  const u64 q = qs[l];
  const size_t base = (size_t)row * n1 * n2 + (size_t)blockIdx.x * TR * n2;
  const int total = TR * n2;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x)
    sh[idx] = x[base + idx];
  __syncthreads();
  stages<FWD>(sh, n2, TR, 1, n2, w + (size_t)l * n2, wp + (size_t)l * n2, q);
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x)
    y[base + idx] = sh[idx];
}

int tile(int other, int len) {  // lanes per tile: whole transforms of `len`
  int t = kTileWords / len;
  if (t < 1) t = 1;
  return t < other ? t : other;
}

template <bool FWD>
cudaError_t rows_generic(const u64* x, u64* y, int rows, int L, int n1, int n2,
                         const u64* q, const u64* w, const u64* wp,
                         cudaStream_t stream) {
  const int TR = tile(n1, n2);
  row_pass<FWD><<<dim3(n1 / TR, rows), kThreads,
                  (size_t)TR * n2 * sizeof(u64), stream>>>(
      x, y, L, n1, n2, TR, q, w, wp);
  return cudaGetLastError();
}

template <bool FWD>
cudaError_t cols_generic(const u64* x, u64* y, int rows, int L, int n1, int n2,
                         const u64* q, const u64* w, const u64* wp,
                         const u64* tw, const u64* twp, cudaStream_t stream) {
  const int TC = tile(n2, n1);
  col_pass<FWD><<<dim3(n2 / TC, rows), kThreads,
                  (size_t)n1 * TC * sizeof(u64), stream>>>(
      x, y, L, n1, n2, TC, q, w, wp, tw, twp);
  return cudaGetLastError();
}

inline const u64* in(const int64_t* p) { return (const u64*)p; }

// Both passes of one transform of [rows, n1 * n2]: forward runs columns then
// rows, inverse rows then columns; the second pass works in place on y.
template <bool FWD>
int run(const int64_t* x, int64_t* y, int rows, int L, int n1, int n2,
        const int64_t* q, const int64_t* w1, const int64_t* w1p,
        const int64_t* w2, const int64_t* w2p, const int64_t* tw,
        const int64_t* twp, cudaStream_t stream) {
  if (n1 * n2 < (1 << 12)) return (int)cudaErrorInvalidValue;
  const bool fast = fast_geometry(n1, n2);
  u64* out = (u64*)y;
  for (int pass = 0; pass < 2; ++pass) {
    const u64* from = pass ? out : in(x);
    cudaError_t err;
    if ((pass == 0) == FWD)
      err = fast ? cols_fast<FWD>(from, out, rows, L, n1, n2, in(q), in(w1),
                                  in(w1p), in(tw), in(twp), stream)
                 : cols_generic<FWD>(from, out, rows, L, n1, n2, in(q),
                                     in(w1), in(w1p), in(tw), in(twp), stream);
    else
      err = fast ? rows_fast<FWD>(from, out, rows, L, n1, n2, in(q), in(w2),
                                  in(w2p), in(tw), in(twp), stream)
                 : rows_generic<FWD>(from, out, rows, L, n1, n2, in(q), in(w2),
                                     in(w2p), stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// x, y: [rows, n1 * n2], rows a multiple of L; q: [L]; w1/w1p: [L, n1] and
// w2/w2p: [L, n2] bit-reversed sub-transform roots and precons; tw/twp:
// [L, n1, n2] twist.
extern "C" int ntt_forward(const int64_t* x, int64_t* y, int rows, int L,
                           int n1, int n2, const int64_t* q,
                           const int64_t* w1, const int64_t* w1p,
                           const int64_t* w2, const int64_t* w2p,
                           const int64_t* tw, const int64_t* twp,
                           cudaStream_t stream) {
  return run<true>(x, y, rows, L, n1, n2, q, w1, w1p, w2, w2p, tw, twp,
                   stream);
}

// Same layout; w1/w2 hold the inverse roots and tw/twp the untwist with
// 1/n folded in.
extern "C" int ntt_inverse(const int64_t* x, int64_t* y, int rows, int L,
                           int n1, int n2, const int64_t* q,
                           const int64_t* w1, const int64_t* w1p,
                           const int64_t* w2, const int64_t* w2p,
                           const int64_t* tw, const int64_t* twp,
                           cudaStream_t stream) {
  return run<false>(x, y, rows, L, n1, n2, q, w1, w1p, w2, w2p, tw, twp,
                    stream);
}
