// The correlator ablation (K6), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of tools/profile_kernel.py, ``make`` (:40, the
// pl.pallas_call at :47), with its four bodies:
//   FULL    k_full    (:69)  K4's body: direct phase, cos/sin, 13 taps at
//                            smax + o_t
//   NOSIN   k_nosin   (:87)  the transcendental removed: cos -> 1 - ph^2,
//                            sin -> ph (two operations)
//   ONETAP  k_onetap  (:105) the tap loop removed: tap 0 only, its I/Q pair
//                            written for every tap
//   ALIGNED k_aligned (:124) tap t read at offset 128*t instead of smax + o_t
// For every window b:
//
//   ph_b(i)  = frac(frac(ftot_b * i) + rem_b)
//   cos_t[b] = sum_{i < n_b} w_b[i] * cos(2*pi*ph_b(i)) * rc_b[i + lag_t]
//   sin_t[b] = the same with sin
//
// written as (B, 2T) float32 interleaved [cos_t, sin_t] in the caller's
// tap order.  n_b is a float, as in the TPU tool (its mask is i < n), and
// the window index i runs below min(ceil(n_b), nwin).  The TPU's 8 windows
// per grid cell and the tool's B % 8 padding were tiling artefacts and are
// gone: any B.
//
// The TPU tool ablates K4's body, so this kernel ablates the port's K4
// body: the window cluster kernel (window_cluster_body, csrc/
// window_cluster.cuh, shared with csrc/window_taps.cu), whose chains of kJ
// samples d apart reuse each replica value across the taps in registers,
// whose segments are staged by 16-byte cp.async, whose S CTAs per window
// add their sums in rank order through distributed shared memory, and
// whose carrier is sincospif.  It takes lags that form a progression
// base + m*d (ops/ablation_taps.py::plan); the entry ablation_taps_launch
// runs, per variant:
//   FULL    K4's f32 instantiation itself, with a float valid bound and the
//           columns in the caller's order: at tap_offsets(6, 3) its output
//           is correlate_windows8's bit for bit, columns permuted
//   NOSIN   the chain's carrier slot computes 1 - ph^2 and ph (the outer
//           frac taken explicitly, which sincospif's argument reduction
//           takes for FULL): what the carrier costs in K4's chains
//   ONETAP  the one-tap chain (NT = 1: no replica value left to reuse) at
//           FULL's d, its pair written to every tap: what the tap loop
//           costs
//   ALIGNED FULL's instructions at lags 0, 128, ..., 128*(T-1) (d = 128:
//           tiles of 33*128 samples, 12*128 more replica values staged per
//           segment at 13 taps).  The TPU's question, the cost of slices
//           that do not start on a 128-lane boundary, has no counterpart
//           here: cp.async stages a segment at any head, and a warp's
//           stride-d reads hit 32 banks for any d.  What ALIGNED measures
//           on this card is a wider lag spread: more replica bytes per
//           segment and longer chains in the row.
// Lags that form no progression (none of the tool's) go to the port's
// first K6 kernel, kept as ablation_taps_v1_launch: one block per window,
// the whole row in shared memory, a precise sincosf, the lags from a
// device array.
//
// What bounds it on this card: memory.  At the tool's shapes (B = 320,
// nwin = 16493, W = 18229, 13 taps) a launch must read 21.1 MB of f32
// windows and ~21.1 MB of the f32 rows its lags reach, ~42 MB: ~12.6 us at
// 3.35 TB/s (H100 SXM), against ~0.28 GFLOP of tap FMAs (~4 us at
// 67 TFLOP/s f32) plus a carrier per sample.  Every launch opts in the
// dynamic shared memory it needs (launch.cuh): the cluster kernel stages
// ~66 KB per CTA, v1 a whole row (72.9 KB).
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage_async.cuh"
#include "launch.cuh"
#include "window_cluster.cuh"

namespace {

enum Variant { kFull = 0, kNoSin = 1, kOneTap = 2, kAligned = 3 };
constexpr int kMaxTaps = 25;      // templated tap counts 1, 3, ..., 25

// ------------------------------------------------------------------------
// The cluster kernel: window_cluster_body on f32 windows and rows, a float
// valid bound and the caller's column order; POLY for NOSIN.

// 80 registers up to 13 taps (3 CTAs of 256 threads per SM), 255 above
template <bool POLY, int NT>
__global__ void __launch_bounds__(kThreads, NT <= 13 ? 3 : 1)
ablation_taps_cluster_kernel(const ClusterArgs a) {
  window_cluster_body<NT, false, float, float, false, float, POLY, true>(a);
}

template <bool POLY, int NT>
cudaError_t launch_ablation(ClusterArgs a, int nwindows, cudaStream_t st) {
  static size_t opted = 0;            // this instantiation's opt-in
  return launch_cluster<NT, false, float, float>(
      ablation_taps_cluster_kernel<POLY, NT>, opted, a, nwindows, st);
}

// ------------------------------------------------------------------------
// The v1 kernel (the port's first K6 kernel): any lags, from a device
// array.

template <int V, int NT>
__global__ void __launch_bounds__(kThreads)
ablation_taps_v1_kernel(const float* __restrict__ win, int nwin,
                        const float* __restrict__ rc, int W,
                        const float* __restrict__ rem,
                        const float* __restrict__ ftot,
                        const float* __restrict__ nvalid,
                        const int* __restrict__ lags,
                        float* __restrict__ out) {
  constexpr int NC = V == kOneTap ? 1 : NT;     // taps computed
  extern __shared__ __align__(16) unsigned char smem[];
  float* rep = reinterpret_cast<float*>(smem);  // this window's replica row
  __shared__ float part[kWarps][2 * NC];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  const float* row = rc + (size_t)b * W;
  for (int j = tid; j < W; j += kThreads) rep[j] = row[j];
  int lag[NC];
#pragma unroll
  for (int t = 0; t < NC; ++t) lag[t] = lags[t];
  __syncthreads();

  float ac[NC], as[NC];
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    ac[t] = 0.f;
    as[t] = 0.f;
  }
  const float* w = win + (size_t)b * nwin;
  // i < n for float n and integer i: i < ceil(n)
  const int n = (int)ceilf(fminf(fmaxf(nvalid[b], 0.f), (float)nwin));
  const float f = ftot[b];
  const float r0 = rem[b];
  for (int i = tid; i < n; i += kThreads) {
    // the _rn intrinsics keep every product rounded where the plain
    // version rounds it (no FMA contraction)
    const float ph = frac_f(frac_f(__fmul_rn(f, (float)i)) + r0);
    float s, c;
    if (V == kNoSin) {
      c = __fsub_rn(1.f, __fmul_rn(ph, ph));
      s = ph;
    } else {
      sincosf(__fmul_rn(kTwoPi, ph), &s, &c);
    }
    const float x = w[i];
    const float wc = __fmul_rn(x, c);
    const float ws = __fmul_rn(x, s);
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      const float r = rep[i + lag[t]];
      ac[t] = fmaf(wc, r, ac[t]);
      as[t] = fmaf(ws, r, as[t]);
    }
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    float a = ac[t];
    float s = as[t];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, d);
      s += __shfl_down_sync(0xffffffffu, s, d);
    }
    if (lane == 0) {
      part[warp][2 * t] = a;
      part[warp][2 * t + 1] = s;
    }
  }
  __syncthreads();
  if (tid < 2 * NT) {
    const int k = V == kOneTap ? (tid & 1) : tid;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) v += part[q][k];
    out[(size_t)b * 2 * NT + tid] = v;
  }
}

template <int V, int NT>
cudaError_t launch_v1(const float* win, int nwin, const float* rc, int W,
                      const float* rem, const float* ftot, const float* nvalid,
                      const int* lags, int nwindows, float* out,
                      cudaStream_t stream) {
  static size_t opted = 0;            // this instantiation's opt-in
  return launch_kernel(ablation_taps_v1_kernel<V, NT>, opted,
                       dim3((unsigned)nwindows), dim3(kThreads),
                       (size_t)W * sizeof(float), 0, stream, win, nwin, rc,
                       W, rem, ftot, nvalid, lags, out);
}

template <int NT>
cudaError_t dispatch_v1(int variant, const float* win, int nwin,
                        const float* rc, int W, const float* rem,
                        const float* ftot, const float* nv, const int* lags,
                        int nwindows, float* out, cudaStream_t st) {
  switch (variant) {
    case kFull:
      return launch_v1<kFull, NT>(win, nwin, rc, W, rem, ftot, nv, lags,
                                  nwindows, out, st);
    case kNoSin:
      return launch_v1<kNoSin, NT>(win, nwin, rc, W, rem, ftot, nv, lags,
                                   nwindows, out, st);
    case kOneTap:
      return launch_v1<kOneTap, NT>(win, nwin, rc, W, rem, ftot, nv, lags,
                                    nwindows, out, st);
    case kAligned:
      return launch_v1<kAligned, NT>(win, nwin, rc, W, rem, ftot, nv, lags,
                                     nwindows, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

#define TAP_CASES(X) X(1) X(3) X(5) X(7) X(9) X(11) X(13) X(15) X(17) \
                     X(19) X(21) X(23) X(25)

// Plain C interface for ctypes.  variant: 0 FULL, 1 NOSIN, 2 ONETAP,
// 3 ALIGNED.  win (B, nwin), rc (B, W), rem, ftot and n (B,) float32; out
// (B, 2*ntaps) float32.  Every pointer is a device pointer; the stream is
// the caller's current CUDA stream.  Each returns the
// cudaError_t of the launch (0 on success); arguments it does not take (a
// variant outside 0..3, ntaps outside {1, 3, ..., 25}, a bad plan) return
// cudaErrorInvalidValue without launching.

// The cluster kernel for lags base + m*d (base >= 0, d >= 1, each with
// lag + nwin <= W: the caller checks).  src (ntaps ints on the device):
// the lag m < ntaps whose pair output tap j takes, a permutation for FULL,
// NOSIN and ALIGNED; ONETAP computes the lag `base` only (its chain still
// d apart), and its src is all zeros: its pair goes to every tap.
extern "C" int ablation_taps_launch(int variant, const void* win, int nwin,
                                    const void* rc, int W, const void* rem,
                                    const void* ftot, const void* n,
                                    int ntaps, int base, int d,
                                    const void* src, int nwindows, void* out,
                                    void* stream) {
  if (variant < 0 || variant > 3 || ntaps < 1 || ntaps > kMaxTaps ||
      ntaps % 2 == 0 || base < 0 || d < 1)
    return (int)cudaErrorInvalidValue;
  if (nwindows <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nwin <= 0)                  // no samples: every tap sum is zero
    return (int)cudaMemsetAsync(out, 0, (size_t)nwindows * 2 * ntaps * 4, st);
  ClusterArgs a = {};
  a.win = win;
  a.win_bytes = (long long)nwindows * nwin * 4;
  a.nwin = nwin;
  a.rc = rc;
  a.rc_bytes = (long long)nwindows * W * 4;
  a.next = W;
  a.rem = static_cast<const float*>(rem);
  a.ftot = static_cast<const float*>(ftot);
  a.nvalid = n;
  a.d = d;
  a.base = base;
  a.out = static_cast<float*>(out);
  a.nout = ntaps;
  a.src = static_cast<const int*>(src);
  if (variant == kOneTap)
    return (int)launch_ablation<false, 1>(a, nwindows, st);
#define CLUSTER_CASE(NT)                                              \
  case NT:                                                            \
    return variant == kNoSin                                          \
               ? (int)launch_ablation<true, NT>(a, nwindows, st)      \
               : (int)launch_ablation<false, NT>(a, nwindows, st);
  switch (ntaps) {
    TAP_CASES(CLUSTER_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CLUSTER_CASE
}

// The v1 kernel, for any lags: lags (ntaps,) int32 on the device, each
// with lag + nwin <= W (the caller checks).
extern "C" int ablation_taps_v1_launch(int variant, const void* win, int nwin,
                                       const void* rc, int W, const void* rem,
                                       const void* ftot, const void* n,
                                       const void* lags, int ntaps,
                                       int nwindows, void* out,
                                       void* stream) {
  if (variant < 0 || variant > 3) return (int)cudaErrorInvalidValue;
  if (nwindows <= 0) return (int)cudaSuccess;
  const float* w = static_cast<const float*>(win);
  const float* r = static_cast<const float*>(rc);
  const float* rm = static_cast<const float*>(rem);
  const float* ft = static_cast<const float*>(ftot);
  const float* nv = static_cast<const float*>(n);
  const int* lg = static_cast<const int*>(lags);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define V1_CASE(NT)                                                           \
  case NT:                                                                    \
    return (int)dispatch_v1<NT>(variant, w, nwin, r, W, rm, ft, nv, lg,       \
                                nwindows, y, st);
  switch (ntaps) {
    TAP_CASES(V1_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef V1_CASE
}

// Samples per chain and CTAs per window of the cluster kernel (for the
// caller's records).
extern "C" int ablation_taps_samples_per_thread() { return kJ; }
extern "C" int ablation_taps_ctas_per_window() { return kCluster; }

extern "C" const char* ablation_taps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
