// Tap correlator of fetched window rows with the factored carrier (K2),
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gnsslib_tpu/ops/pallas_gram.py gram_usum_impl
// (:267, body _kernel :47) together with the one-hot diagonal extraction
// that follows it in gnsslib_tpu/track/fast.py (_taps_fused :443), and
// returns what _taps_fused returns, the (B, 2T) taps.
//
// Window b arrives as K rows of 128 samples, already masked to its valid
// length (bf16; a second array for Q when the signal is I/Q).  With sample
// i = 128 k + j the mixing angle factors (angle addition) into a row-start
// angle and an in-row ramp:
//
//   theta_k = 2*pi * frac(frac(ftot_b * 128 k) + rem_b)
//   phi_j   = 2*pi * (ftot_b * j)
//   a = xr cos(theta_k) - xi sin(theta_k),  b = xr sin(theta_k) + xi cos(theta_k)
//   wc = bf16(a cos(phi_j) - b sin(phi_j)),  ws = bf16(b cos(phi_j) + a sin(phi_j))
//   cos_t[b] = sum_i wc(i) * r_b[i + smax + o_t],  sin_t[b] likewise with ws
//
// (xi = 0 for real windows; replica samples past the row's end count as 0)
// written as (B, 2T) float32 interleaved [cos_t, sin_t].  The bf16 rounding
// of wc/ws is _kernel's (its matrix-unit operands); the products
// bf16 * int8 are exact in float32 and summed in float32.  The TPU kernel's
// second rounding, of each Gram entry to bf16 before the extraction, is a
// layout artefact this kernel does not reproduce: it sums unrounded.
//
// What bounds it on this card: at the 32-channel L1CA super-step (320
// windows of 128 x 128 samples, 16412-sample int8 rows, 13 taps) it reads
// ~10.5 MB of bf16 rows and ~5.3 MB of replica rows (~4.7 us at 3.35 TB/s)
// and, as direct tap sums, ~272 MFLOP (~4 us at 67 TFLOP/s f32).  As the
// TPU kernel forms it, the function is a bf16 Gram on the matrix unit:
//
//   U[j, l] = sum_k wc[k, j] * B[k, l],   B[k, l] = r_b[128 k + l]
//   cos_t   = sum_j U[j, j + smax + o_t]
//
// and only the band l - j in [0, 2 smax] of U is read.  The operands are
// exactly mma's: wc/ws are bf16 by definition, and bf16 holds the int8
// replica exactly, so every product is exact and only the summation order
// differs from the plain version (as it did for the v1 kernel).
//
// Two kernels.  gram_taps_v1_kernel (the port's first K2 kernel) gives each
// window one 256-thread block, stages the replica one byte per thread and
// pays per sample 13 shared loads, 13 conversions and 26 FFMAs on the CUDA
// cores.  gram_taps_mma_kernel is the banded Gram on the tensor cores; it
// takes any offsets with smax <= 36 (kMaxTiles n-tiles) and up to 256 rows
// (kMaxRows); ops/gram_taps.py::tile_plan decides, from the same two
// limits, and sends any other geometry (a band wider than 2*36 + 1 lags,
// windows longer than 256 rows) to v1.  tools/profile_gram.py builds the
// steps below and ablations as variants of this source and times them:
//
// 1. Banded Gram on tensor cores.  mma.sync m16n8k16 (bf16 in, f32 sums):
//    M is the in-row lane j (8 m-tiles of 16, one warp each), the
//    contraction runs over the row index k (16 rows per step, padded with
//    zero rows in shared memory), N is the lag column l.  The m-tile at j0
//    reads only the columns [j0, j0 + 8 NN), NN = ceil((16 + 2 smax) / 8)
//    n-tiles (7 at the main path's smax = 18, 11 at smax = 36).  A is mixed
//    in registers straight from the staged raw rows (the v1 kernel's precise
//    sincosf and __fmul_rn sequence, so wc/ws keep its bits; each of the
//    window's 128 + K angles is one thread's single sincosf) and rounded to
//    bf16 by one packed conversion; B is loaded by ldmatrix.trans from the
//    replica, converted once from int8 to bf16 when it is staged (4 bytes
//    per step, by a float bias and the upper halves, no conversion
//    instruction), as a matrix of rows 128 samples apart whose pitch is 16
//    bytes past a multiple of 128: the 8 rows of an ldmatrix hit 8
//    different bank groups (a linear copy would conflict 8 ways).  Against
//    v1 this step alone (mma: S = 1, plain loads) is slower: the staging,
//    unhidden, then holds every warp back.
// 2. Staging by 16-byte cp.async.  The CTA's window rows (to a pitch of 136
//    values, so that the mixing's loads do not conflict) and its replica
//    bytes (stage_async of stage_async.cuh, the copy K3-K5 use: the rows
//    start every `next` bytes, 4-byte aligned only) are all in flight
//    before one wait.  This step moved most (3.5-4x at the main path's
//    shapes).
// 3. Fill the card.  Each window's rows are split over S = kCluster CTAs
//    (whole 16-row steps each) that run as one thread-block cluster.  S = 2:
//    S = 1 is within 5% for real rows but ~19% slower for I/Q ones (137 KB
//    of shared memory, one CTA per SM), S = 4 is 40-45% slower.
// 4. Deterministic extraction.  After the last step each warp writes the
//    band of its accumulators (the lags 0..2 smax of its 16 lanes) to shared
//    memory over the staged rows, sums the diagonals of the taps' lags over
//    its lanes in lane order, and the warps' sums are added in warp order;
//    every rank
//    writes its 2T sums into rank 0's shared memory through distributed
//    shared memory, and rank 0 adds them in rank order.  No register array
//    is indexed by a runtime tap: taps are picked from shared memory.  One
//    launch, no scratch, no atomics: repeats and graph replays are
//    bit-identical.  The kernel takes no valid length (the rows arrive
//    masked); a launch with K = 0 rows is a memset on the host, before any
//    launch, and a rank whose rows lie past K stages nothing and adds zeros
//    but reaches every barrier of its cluster.
//
// Where the time goes (tools/profile_gram.py, PERF.md): at the main path's
// shapes about 0.008 ms are fixed (the launch, the angles, B's conversion,
// the extraction and the cluster barriers: its `empty` variant), the k-steps
// ~0.009 and the staging ~0.005, half hidden behind them.  Both
// instantiations take ~117 registers (2 CTAs per SM, no spill); capped at 80
// they spill 20-60 bytes and gain at most 8%.  Tried and left out: 16 warps
// each holding one m-tile of either sum (512 threads, 61 registers), 5-12%
// slower; the rows staged in two cp.async groups, the second in flight
// while the first is converted and multiplied, ~10% slower.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage_async.cuh"
#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;                    // samples per window row
static_assert(kThreads % kLanes == 0, "a v1 thread keeps one lane j");
static_assert(kWarps * 16 == kLanes, "an mma warp keeps one m-tile");
constexpr int kCluster = 2;       // CTAs per window: one thread-block cluster
constexpr int kMaxTiles = 11;     // n-tiles per m-tile: smax <= 36
constexpr int kMaxRows = 256;     // window rows the mma kernel takes
constexpr int kMaxTaps = 25;
constexpr int kXPitch = kLanes + 8;            // staged window row (values)
constexpr float kTwoPi = 6.283185307179586f;   // f32(2*pi), as the plain version

__device__ __forceinline__ float frac_f(float x) { return x - floorf(x); }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

int ceil_div(int x, int y) { return (x + y - 1) / y; }

// ------------------------------------------------------------------------
// The v1 kernel: one block per window, f32 FMAs, any band.

template <int NT, bool IQ>
__global__ void __launch_bounds__(kThreads)
gram_taps_v1_kernel(const __nv_bfloat16* __restrict__ win_i,
                    const __nv_bfloat16* __restrict__ win_q, int K,
                    const int8_t* __restrict__ rc, int next,
                    const float* __restrict__ rem,
                    const float* __restrict__ ftot,
                    const int* __restrict__ offsets, int smax,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ck = reinterpret_cast<float*>(smem);   // cos(theta_k), k < K
  float* sk = ck + K;                           // sin(theta_k)
  int8_t* rep = reinterpret_cast<int8_t*>(sk + K);
  __shared__ float part[kWarps][2 * NT];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nsamp = K * kLanes;
  const int span = nsamp + 2 * smax;

  const int8_t* row = rc + (size_t)b * next;
  for (int j = tid; j < span; j += kThreads) rep[j] = j < next ? row[j] : 0;
  const float f = ftot[b];
  const float r0 = rem[b];
  for (int k = tid; k < K; k += kThreads) {
    const float ph = frac_f(frac_f(__fmul_rn(f, (float)(k * kLanes))) + r0);
    sincosf(__fmul_rn(kTwoPi, ph), &sk[k], &ck[k]);
  }
  const int j = tid & (kLanes - 1);
  float sj, cj;
  sincosf(__fmul_rn(kTwoPi, __fmul_rn(f, (float)j)), &sj, &cj);
  int lag[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) lag[t] = smax + offsets[t];
  __syncthreads();

  float ac[NT], as[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    ac[t] = 0.f;
    as[t] = 0.f;
  }
  const __nv_bfloat16* wi = win_i + (size_t)b * nsamp;
  const __nv_bfloat16* wq = IQ ? win_q + (size_t)b * nsamp : nullptr;
  for (int i = tid; i < nsamp; i += kThreads) {
    const int k = i / kLanes;
    const float c = ck[k];
    const float s = sk[k];
    const float xr = __bfloat162float(wi[i]);
    float a, bb;
    // the _rn intrinsics keep every product rounded where the plain
    // version rounds it (no FMA contraction)
    if (IQ) {
      const float xi = __bfloat162float(wq[i]);
      a = __fsub_rn(__fmul_rn(xr, c), __fmul_rn(xi, s));
      bb = __fadd_rn(__fmul_rn(xr, s), __fmul_rn(xi, c));
    } else {
      a = __fmul_rn(xr, c);
      bb = __fmul_rn(xr, s);
    }
    const float wc = bf16_round(__fsub_rn(__fmul_rn(a, cj), __fmul_rn(bb, sj)));
    const float ws = bf16_round(__fadd_rn(__fmul_rn(bb, cj), __fmul_rn(a, sj)));
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float r = (float)rep[i + lag[t]];
      ac[t] = fmaf(wc, r, ac[t]);
      as[t] = fmaf(ws, r, as[t]);
    }
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    float x = ac[t];
    float y = as[t];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      x += __shfl_down_sync(0xffffffffu, x, d);
      y += __shfl_down_sync(0xffffffffu, y, d);
    }
    if (lane == 0) {
      part[warp][2 * t] = x;
      part[warp][2 * t + 1] = y;
    }
  }
  __syncthreads();
  if (tid < 2 * NT) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += part[w][tid];
    out[(size_t)b * 2 * NT + tid] = v;
  }
}

// ------------------------------------------------------------------------
// The banded-Gram kernel (steps 1-4 above).

struct MmaArgs {
  const __nv_bfloat16* win_i;
  const __nv_bfloat16* win_q;    // I/Q only
  int K;                         // rows per window
  const int8_t* rc;
  long long rc_bytes;            // bytes in rc (B * next)
  int next;
  const float* rem;
  const float* ftot;
  const int* offsets;            // ntaps device ints, |o| <= smax
  int ntaps;
  int smax;
  int kr;                        // rows per CTA, a multiple of 16
  float* out;
};

// The B matrix of NN n-tiles: the columns the last m-tile reads, and a
// pitch (bf16 values) of 16 bytes past a multiple of 128 bytes.
template <int NN>
struct Band {
  static constexpr int kCols = kLanes - 16 + 8 * NN;
  static constexpr int kPitch = (kCols - 8 + 63) / 64 * 64 + 8;
  static_assert(kPitch >= kCols && (2 * kPitch) % 128 == 16, "B pitch");
};

// Shared bytes of the staged operands (B, the window rows, the raw replica
// bytes and a word past them for the conversion's funnel shift) and of the
// extraction's band of U, which lies over them once the steps are done.
template <int NN, bool IQ>
__host__ __device__ constexpr int stage_bytes(int kr) {
  return kr * Band<NN>::kPitch * 2 + (IQ ? 2 : 1) * kr * kXPitch * 2 +
         staged_bytes(kLanes * (kr - 1) + Band<NN>::kCols) + 16;
}
__host__ __device__ constexpr int band_bytes(int smax) {
  return kWarps * 2 * 16 * (2 * smax + 1) * (int)sizeof(float);
}

// `rows` window rows of 128 bf16 values from src (row-contiguous) to dst at
// a pitch of kXPitch values by 16-byte cp.async (plain copies when src is
// not 16-byte aligned); rows [rows, kr) are zeros.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int rows, int kr) {
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int v = threadIdx.x; v < kr * 16; v += blockDim.x) {
    const int row = v >> 4;
    const int c = 8 * (v & 15);
    __nv_bfloat16* d = dst + row * kXPitch + c;
    const __nv_bfloat16* s = src + row * kLanes + c;
    if (row >= rows) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (aligned) {
      cp_async16(d, s, 16);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = s[e];
    }
  }
}

// The mixed pair of sample (k, j): the v1 kernel's products, rounded where
// the plain version rounds them (no FMA contraction); the caller rounds
// wc/ws to bf16.
template <bool IQ>
__device__ __forceinline__ void mix(float xr, float xi, float c, float s,
                                    float cj, float sj, float& wc,
                                    float& ws) {
  float a, bb;
  if (IQ) {
    a = __fsub_rn(__fmul_rn(xr, c), __fmul_rn(xi, s));
    bb = __fadd_rn(__fmul_rn(xr, s), __fmul_rn(xi, c));
  } else {
    a = __fmul_rn(xr, c);
    bb = __fmul_rn(xr, s);
  }
  wc = __fsub_rn(__fmul_rn(a, cj), __fmul_rn(bb, sj));
  ws = __fadd_rn(__fmul_rn(bb, cj), __fmul_rn(a, sj));
}

// Two floats as one bf16x2 register, lo in the low half (round to nearest
// even, as __float2bfloat16_rn).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The two low int8 bytes of x as one bf16x2 register (byte 0 in the low
// half), exactly: an int8 value v is the float 2^23 + 2^22 + v less
// 2^23 + 2^22 (no conversion instruction), and its bf16 is the float's upper
// half (8 significant bits at most: no rounding).
__device__ __forceinline__ uint32_t bf16x2_of_int8(uint32_t x) {
  const float lo =
      __int_as_float(0x4B400000 + ((int)(x << 24) >> 24)) - 12582912.f;
  const float hi =
      __int_as_float(0x4B400000 + ((int)(x << 16) >> 24)) - 12582912.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr)
      : "memory");
}

// d += A (16x16, row) * B (16x8, col), bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NN, bool IQ>
__global__ void __launch_bounds__(kThreads, 2)
gram_taps_mma_kernel(const MmaArgs a) {
  constexpr int F = IQ ? 2 : 1;
  constexpr int kCols = Band<NN>::kCols;
  constexpr int P = Band<NN>::kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int lag[kMaxTaps];                  // smax + o_t
  __shared__ float part[kWarps][2 * kMaxTaps];   // each warp's tap sums
  __shared__ float gather[kCluster][2 * kMaxTaps];   // rank 0's: every rank's
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kr = a.kr;
  const int k_first = rank * kr;                   // the CTA's first row
  const int kv = max(0, min(kr, a.K - k_first));   // its rows with samples
  const int nd = 2 * a.smax + 1;                   // band lags
  // arrive now, wait before writing to rank 0's shared memory: every CTA
  // of the cluster has then started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float* ck = reinterpret_cast<float*>(smem);      // cos(theta_k), k < kr
  float* sk = ck + kr;
  float* cjs = sk + kr;                            // cos(phi_j), j < 128
  float* sjs = cjs + kLanes;
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(sjs + kLanes);  // B
  __nv_bfloat16* xs = bs + kr * P;                 // F planes of kr rows
  unsigned char* raw = reinterpret_cast<unsigned char*>(xs + F * kr * kXPitch);

  // 1. stage the replica bytes the CTA's rows read (row-relative
  // [128 k_first, 128 k_first + rcount), cut at the row's end) and the
  // window rows, all in flight before one wait
  const long long rfirst = (long long)b * a.next + (long long)kLanes * k_first;
  const int rcount =
      kv > 0 ? min(kLanes * (kv - 1) + kCols, a.next - kLanes * k_first) : 0;
  int rhead = 0;
  if (rcount > 0)
    rhead = stage_async(raw, a.rc, a.rc_bytes, rfirst, rcount);
  const size_t wfirst = ((size_t)b * a.K + k_first) * kLanes;
  stage_rows(xs, a.win_i + wfirst, kv, kr);
  if (IQ) stage_rows(xs + kr * kXPitch, a.win_q + wfirst, kv, kr);
  // the window's angles, one sincosf each: the lanes' phi_j on threads
  // [0, 128), the CTA's rows' theta_k on the next kr
  const float f = a.ftot[b];
  const float r0 = a.rem[b];
  if (tid < a.ntaps) lag[tid] = a.smax + a.offsets[tid];
  for (int t = tid; t < kLanes + kr; t += blockDim.x) {
    if (t < kLanes) {
      sincosf(__fmul_rn(kTwoPi, __fmul_rn(f, (float)t)), &sjs[t], &cjs[t]);
    } else {
      const int k = t - kLanes;
      const float ph = frac_f(
          frac_f(__fmul_rn(f, (float)((k_first + k) * kLanes))) + r0);
      sincosf(__fmul_rn(kTwoPi, ph), &sk[k], &ck[k]);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // B[k, c] = bf16(r[128 (k_first + k) + c]), zero past the row's end and
  // for rows without samples, converted once: 4 bytes per step, from the
  // two aligned words around them
  constexpr int kQuads = kCols / 4;
  const uint32_t* raw32 = reinterpret_cast<const uint32_t*>(raw);
  const unsigned shift = 8u * (rhead & 3);
#pragma unroll 2
  for (int v = tid; v < kr * kQuads; v += blockDim.x) {
    const int k = v / kQuads;
    const int c = 4 * (v - k * kQuads);
    const int i = kLanes * k + c;                  // row-relative byte
    const int w = (rhead + i) >> 2;
    uint32_t x = __funnelshift_r(raw32[w], raw32[w + 1], shift);
    const int left = k < kv ? rcount - i : 0;      // bytes in range
    if (left < 4) x = left <= 0 ? 0u : x & (0xffffffffu >> (32 - 8 * left));
    *reinterpret_cast<uint2*>(bs + k * P + c) =
        make_uint2(bf16x2_of_int8(x), bf16x2_of_int8(x >> 16));
  }
  __syncthreads();
  // this lane's two in-row lanes of its warp's m-tile
  const int g = lane >> 2;
  const int q = lane & 3;
  const int j0 = 16 * warp;

  // 2. the banded Gram: warp `warp` owns lanes [j0, j0 + 16), both sums
  float acc[2][NN][4];                             // [cos/sin][n-tile][frag]
#pragma unroll
  for (int cs = 0; cs < 2; ++cs)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[cs][n][e] = 0.f;
  // ldmatrix: lane l addresses row (l & 7) of matrix l >> 3; matrices
  // (k rows 0-7, n-tile t), (8-15, t), (0-7, t + 1), (8-15, t + 1)
  const int mrow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int mcol = j0 + 8 * (lane >> 4);
  const uint32_t bsa = static_cast<uint32_t>(__cvta_generic_to_shared(bs));
  for (int kb = 0; kb < kv; kb += 16) {
    // A fragments: a[r] holds rows kb + 2q + 8 (r >> 1) + {0, 1} of lane
    // j0 + g + 8 (r & 1)
    uint32_t ac[4], as[4];
    // phi of the lane's two in-row lanes, from shared memory each step
    // (registers are the scarcer resource)
    const float cj[2] = {cjs[j0 + g], cjs[j0 + g + 8]};
    const float sj[2] = {sjs[j0 + g], sjs[j0 + g + 8]};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = kb + 2 * q + 8 * (r >> 1);
      const int x = k * kXPitch + j0 + g + 8 * (r & 1);
      float wc[2], ws[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float xr = __bfloat162float(xs[x + e * kXPitch]);
        const float xi =
            IQ ? __bfloat162float(xs[kr * kXPitch + x + e * kXPitch]) : 0.f;
        mix<IQ>(xr, xi, ck[k + e], sk[k + e], cj[r & 1], sj[r & 1], wc[e],
                ws[e]);
      }
      ac[r] = pack_bf16(wc[0], wc[1]);
      as[r] = pack_bf16(ws[0], ws[1]);
    }
    const uint32_t row = bsa + 2u * (uint32_t)((kb + mrow) * P + mcol);
#pragma unroll
    for (int n = 0; n + 1 < NN; n += 2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(row + 16u * n, b0, b1, b2, b3);
      mma_bf16(acc[0][n], ac, b0, b1);
      mma_bf16(acc[1][n], as, b0, b1);
      mma_bf16(acc[0][n + 1], ac, b2, b3);
      mma_bf16(acc[1][n + 1], as, b2, b3);
    }
    if constexpr (NN % 2 == 1) {
      uint32_t b0, b1;                 // lanes 0-15 address the last tile
      ldsm_x2_trans(bsa + 2u * (uint32_t)((kb + mrow) * P + j0 + 8 * (NN - 1)),
                    b0, b1);
      mma_bf16(acc[0][NN - 1], ac, b0, b1);
      mma_bf16(acc[1][NN - 1], as, b0, b1);
    }
  }

  // 3. the band of U, over the staged operands: ub[cs][lane jj][lag d] of
  // this warp; accumulator (n, 2h + e) is lane jj = g + 8h, column
  // 8n + 2q + e of the m-tile, lag d = column - jj
  __syncthreads();                     // every warp is done with B and rows
  float* ub = reinterpret_cast<float*>(bs) + warp * 2 * 16 * nd;
#pragma unroll
  for (int cs = 0; cs < 2; ++cs)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = g + 8 * (e >> 1);
        const int d = 8 * n + 2 * q + (e & 1) - jj;
        if (d >= 0 && d < nd) ub[(cs * 16 + jj) * nd + d] = acc[cs][n][e];
      }
  __syncwarp();
  // the diagonals of the taps' lags, [cos_t, sin_t] interleaved
  for (int t = lane; t < 2 * a.ntaps; t += 32) {
    const float* col = ub + (t & 1) * 16 * nd + lag[t >> 1];
    float x = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) x += col[jj * nd];
    part[warp][t] = x;
  }
  __syncthreads();
  // each rank writes its taps into rank 0's gather[rank]; after the cluster
  // barrier rank 0 adds them in rank order
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* to = cluster.map_shared_rank(&gather[0][0], 0) + rank * 2 * kMaxTaps;
  for (int t = tid; t < 2 * a.ntaps; t += blockDim.x) {
    float x = 0.f;
    for (int w = 0; w < kWarps; ++w) x += part[w][t];
    to[t] = x;
  }
  cluster.sync();
  if (rank == 0) {
    float* o = a.out + (size_t)b * 2 * a.ntaps;
    for (int t = tid; t < 2 * a.ntaps; t += blockDim.x) {
      float x = 0.f;
      for (int r = 0; r < kCluster; ++r) x += gather[r][t];
      o[t] = x;
    }
  }
}

template <int NN, bool IQ>
cudaError_t launch_mma(MmaArgs a, int nwindows, cudaStream_t stream) {
  a.kr = ceil_div(ceil_div(a.K, kCluster), 16) * 16;
  const int stage = stage_bytes<NN, IQ>(a.kr);
  const int band = band_bytes(a.smax);
  const size_t shm = (size_t)(a.kr + kLanes) * 2 * sizeof(float) +
                     (size_t)(stage > band ? stage : band);
  static size_t opted = 0;            // this instantiation's opt-in
  return launch_kernel(gram_taps_mma_kernel<NN, IQ>, opted,
                       dim3((unsigned)(nwindows * kCluster)), dim3(kThreads),
                       shm, kCluster, stream, a);
}

template <int NT, bool IQ>
cudaError_t launch_v1(const void* win_i, const void* win_q, int K,
                      const int8_t* rc, int next, const float* rem,
                      const float* ftot, const int* offsets, int smax,
                      int nwindows, float* out, cudaStream_t stream) {
  const size_t shm = (size_t)K * 2 * sizeof(float) + (size_t)K * kLanes +
                     2 * (size_t)smax;
  static size_t opted = 0;            // this instantiation's opt-in
  return launch_kernel(gram_taps_v1_kernel<NT, IQ>, opted,
                       dim3((unsigned)nwindows), dim3(kThreads), shm, 0,
                       stream, static_cast<const __nv_bfloat16*>(win_i),
                       static_cast<const __nv_bfloat16*>(win_q), K, rc, next,
                       rem, ftot, offsets, smax, out);
}

}  // namespace

#define TILE_CASES(X) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11)
#define TAP_CASES(X) X(1) X(3) X(5) X(7) X(9) X(11) X(13) X(15) X(17) \
                     X(19) X(21) X(23) X(25)

// Plain C interface for ctypes.  win_i/win_q: (B, K, 128) bf16 rows
// (win_q ignored unless iq); rc: (B, next) int8; offsets: ntaps device
// ints.  Every pointer is a device pointer; the stream is the caller's
// current CUDA stream.  Each returns the cudaError_t of the launch (0 on
// success); arguments it does not take return cudaErrorInvalidValue
// without launching.

// The banded-Gram kernel with `ntiles` n-tiles per m-tile (2..11, at least
// ceil((16 + 2 smax) / 8); ops/gram_taps.py::tile_plan), K <= 256 rows,
// any ntaps <= 25 offsets within [-smax, smax].
extern "C" int gram_taps_launch(int iq, const void* win_i, const void* win_q,
                                int K, const void* rc, int next,
                                const void* rem, const void* ftot,
                                const void* offsets, int ntaps, int smax,
                                int ntiles, int nwindows, void* out,
                                void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || smax < 0 || K < 0 || K > kMaxRows ||
      8 * ntiles < 16 + 2 * smax)
    return (int)cudaErrorInvalidValue;
  if (nwindows <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 0)                     // no samples: every tap sum is zero
    return (int)cudaMemsetAsync(out, 0, (size_t)nwindows * 2 * ntaps * 4, st);
  MmaArgs a = {};
  a.win_i = static_cast<const __nv_bfloat16*>(win_i);
  a.win_q = static_cast<const __nv_bfloat16*>(win_q);
  a.K = K;
  a.rc = static_cast<const int8_t*>(rc);
  a.rc_bytes = (long long)nwindows * next;
  a.next = next;
  a.rem = static_cast<const float*>(rem);
  a.ftot = static_cast<const float*>(ftot);
  a.offsets = static_cast<const int*>(offsets);
  a.ntaps = ntaps;
  a.smax = smax;
  a.out = static_cast<float*>(out);
#define MMA_CASE(NN)                                                    \
  case NN:                                                              \
    return iq ? (int)launch_mma<NN, true>(a, nwindows, st)              \
              : (int)launch_mma<NN, false>(a, nwindows, st);
  switch (ntiles) {
    TILE_CASES(MMA_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MMA_CASE
}

// The v1 kernel: any band, any K, ntaps in {1, 3, ..., 25}.
extern "C" int gram_taps_v1_launch(int iq, const void* win_i,
                                   const void* win_q, int K, const void* rc,
                                   int next, const void* rem,
                                   const void* ftot, const void* offsets,
                                   int ntaps, int smax, int nwindows,
                                   void* out, void* stream) {
  if (nwindows <= 0) return (int)cudaSuccess;
  const int8_t* r = static_cast<const int8_t*>(rc);
  const float* rm = static_cast<const float*>(rem);
  const float* ft = static_cast<const float*>(ftot);
  const int* of = static_cast<const int*>(offsets);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define V1_CASE(NT)                                                       \
  case NT:                                                                \
    return iq ? (int)launch_v1<NT, true>(win_i, win_q, K, r, next, rm, ft, \
                                         of, smax, nwindows, y, st)        \
              : (int)launch_v1<NT, false>(win_i, win_q, K, r, next, rm,    \
                                          ft, of, smax, nwindows, y, st);
  switch (ntaps) {
    TAP_CASES(V1_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef V1_CASE
}

// CTAs per window of the banded-Gram kernel (for the caller's records).
extern "C" int gram_taps_ctas_per_window() { return kCluster; }

extern "C" const char* gram_taps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
