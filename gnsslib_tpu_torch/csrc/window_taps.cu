// Tap correlators of fetched windows (K3, K4, K5), for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernels of gnsslib_tpu/ops/pallas_corr.py:
//   K5 correlate_windows_impl   (:66,  body _kernel   :36)  f32 windows, f32 rows
//   K4 correlate_windows8_impl  (:156, body _kernel8  :128) f32 windows, f32 rows
//   K3 correlate_windows16_impl (:236, body _kernel16 :201) bf16 windows, int8 rows
// For every window b (already fetched out of the sample block):
//
//   ph_b(i)  = frac(frac(ftot_b * i) + rem_b)
//   cos_t[b] = sum_{i < n_b} w_b[i] * cos(2*pi*ph_b(i)) * r_b[i + smax + o_t]
//   sin_t[b] = the same with sin; I/Q windows mix (wr + j wi) e^{+j 2 pi ph}
//
// written as (B, 2T) float32 interleaved [cos_t, sin_t].  K4 and K5 compute
// the same float32 function and share one instantiation; the TPU's 8 or 16
// windows per grid cell and its B % 16 padding were tiling artefacts and
// are gone (any B).  K3 rounds each mixed sample to bf16 (round to nearest
// even) as _kernel16 does; its tap products bf16 * int8 are exact in float32
// and summed in float32, as the Pallas kernel's reference evaluation
// (interpret mode) sums them.  K4/K5 mix and sum in float32 unrounded.
//
// What bounds each instantiation on this card, at the 32-channel L1CA
// super-step (320 windows of 16376 samples, 16412-element rows, 13 taps):
//   K3     ~10.5 MB of bf16 windows and ~5.3 MB of int8 rows, 4.7 us at
//          3.35 TB/s, and ~283 MFLOP of tap FMAs, 4.2 us at 67 TFLOP/s f32:
//          bytes and f32 issue are almost level, so K3 needs both fewer
//          instructions per sample and more bytes in flight;
//   K4/K5  ~21 MB of f32 windows and ~21 MB of f32 rows, 12.5 us: bytes.
//
// Two kernels.  window_taps_v1_kernel (the port's first) gives each window
// one 256-thread block (320 blocks on 132 SMs), stages the whole replica
// row one element per thread before any work, and pays per sample and tap
// one shared load (and K3 one int8->f32 conversion) for two FMAs, plus a
// precise sincosf per sample; it takes any offsets.
// window_taps_cluster_kernel takes the offsets the receiver and the
// profiler make, tap_offsets(corrn, d): 0, -d, +d, ..., -corrn*d,
// +corrn*d, so tap m (in lag order) of sample i reads r[i + base + m*d]
// with base = smax - corrn*d; the wrapper sends any other offsets to v1.
// Its body is window_cluster_body (csrc/window_cluster.cuh, which also
// serves K6's ablations of it), in four build steps: chains of kJ samples
// reusing each replica value across the taps in registers, the segment
// staged by 16-byte cp.async, S = kCluster CTAs per window in one
// thread-block cluster with a rank-order sum, and a sincospif carrier.
// tools/profile_window.py builds the steps, the other choices of each
// constant and ablations as variants of this source and times them
// (PERF.md has the table; at the main path's shapes K3 takes under half
// of v1's time, the f32 instantiation about two thirds).  What it found
// beyond the steps:
//
// - Staging the window beat reading it through L1 for K3 and for f32 I/Q
//   windows (by up to 30%): the windows come from device memory, unlike
//   K1's block, which stays in L2.  f32 real windows read up to 13% faster
//   through L1 in most runs and slower in one; one path, staged, serves
//   all.  Two designs that should hide the copies behind the chains were
//   slower (PERF.md): the copies split into one group per round of chains,
//   2 or 4 chains per thread, and clusters that stay resident and stage
//   the next window while they compute one (twice the shared memory, so
//   fewer CTAs per SM).
// - Both instantiations fit 80 registers with no spill (3 CTAs of 256
//   threads per SM); capped at 64 (4 CTAs) some instantiations spill and
//   none is faster by more than 2%.
// - The sincospif carrier's error against the plain version's
//   cos/sin(f32(2*pi) * ph) is a few 1e-7 absolute, inside the f32
//   tolerance (1e-5 of the window's L1 norm); for K3 it flips the bf16
//   rounding of about 1.4 mixed values in 10^4 (1424 of 10475554 at the
//   main path's shapes, real input), each moving a tap by at most
//   2^-7 |x_i|: the largest tap error is then 0.75 against K3's tolerance
//   of 106 (1e-4 of the L1 norm), where sincosf's is 0.004.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage_async.cuh"
#include "launch.cuh"
#include "window_cluster.cuh"

namespace {

// ------------------------------------------------------------------------
// The v1 kernel.  W: window sample type, R: replica type, BF16: K3's
// rounding of the mix.

template <int NT, bool IQ, typename W, typename R, bool BF16>
__global__ void __launch_bounds__(kThreads)
window_taps_v1_kernel(const W* __restrict__ win, int nwin,
                      const R* __restrict__ rc, int next,
                      const float* __restrict__ rem,
                      const float* __restrict__ ftot,
                      const int* __restrict__ nvalid,
                      const int* __restrict__ offsets, int smax,
                      float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  R* rep = reinterpret_cast<R*>(smem);          // this window's replica row
  __shared__ float part[kWarps][2 * NT];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  const R* row = rc + (size_t)b * next;
  for (int j = tid; j < next; j += kThreads) rep[j] = row[j];
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
  const W* w = win + (size_t)b * nwin * (IQ ? 2 : 1);
  const int n = min(nvalid[b], nwin);
  const float f = ftot[b];
  const float r0 = rem[b];
  for (int i = tid; i < n; i += kThreads) {
    // the _rn intrinsics keep every product rounded where the plain
    // version rounds it (no FMA contraction)
    const float ph = frac_f(frac_f(__fmul_rn(f, (float)i)) + r0);
    float s, c;
    sincosf(__fmul_rn(kTwoPi, ph), &s, &c);
    float wc, ws;
    if (IQ) {
      const float xr = as_float(w[2 * i]);
      const float xi = as_float(w[2 * i + 1]);
      wc = __fsub_rn(__fmul_rn(xr, c), __fmul_rn(xi, s));
      ws = __fadd_rn(__fmul_rn(xr, s), __fmul_rn(xi, c));
    } else {
      const float x = as_float(w[i]);
      wc = __fmul_rn(x, c);
      ws = __fmul_rn(x, s);
    }
    if (BF16) {
      wc = bf16_round(wc);
      ws = bf16_round(ws);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float r = as_float(rep[i + lag[t]]);
      ac[t] = fmaf(wc, r, ac[t]);
      as[t] = fmaf(ws, r, as[t]);
    }
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
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
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v += part[k][tid];
    out[(size_t)b * 2 * NT + tid] = v;
  }
}

// ------------------------------------------------------------------------
// The cluster kernel: window_cluster_body with an int valid bound, the
// sincospif carrier and tap_offsets order.

// 80 registers up to 13 taps (3 CTAs of 256 threads per SM), 255 above
template <int NT, bool IQ, typename W, typename R, bool BF16>
__global__ void __launch_bounds__(kThreads, NT <= 13 ? 3 : 1)
window_taps_cluster_kernel(const ClusterArgs a) {
  window_cluster_body<NT, IQ, W, R, BF16>(a);
}

template <int NT, bool IQ, typename W, typename R, bool BF16>
cudaError_t launch_v1(const void* win, int nwin, const void* rc, int next,
                      const float* rem, const float* ftot, const int* nvalid,
                      const int* offsets, int smax, int nwindows, float* out,
                      cudaStream_t stream) {
  static size_t opted = 0;            // this instantiation's opt-in
  return launch_kernel(window_taps_v1_kernel<NT, IQ, W, R, BF16>, opted,
                       dim3((unsigned)nwindows), dim3(kThreads),
                       (size_t)next * sizeof(R), 0, stream,
                       static_cast<const W*>(win), nwin,
                       static_cast<const R*>(rc), next, rem, ftot, nvalid,
                       offsets, smax, out);
}

template <int NT, bool IQ, typename W, typename R, bool BF16>
cudaError_t launch_windows(ClusterArgs a, int nwindows, cudaStream_t st) {
  static size_t opted = 0;            // this instantiation's opt-in
  return launch_cluster<NT, IQ, W, R>(
      window_taps_cluster_kernel<NT, IQ, W, R, BF16>, opted, a, nwindows, st);
}

// kind 0: float32 windows and rows (K4/K5); kind 1: bf16 windows, int8 rows
// and bf16 rounding of the mix (K3).
template <int NT>
cudaError_t dispatch_cluster(int kind, int iq, ClusterArgs a, int nwindows,
                             cudaStream_t st) {
  if (kind == 0)
    return iq ? launch_windows<NT, true, float, float, false>(a, nwindows, st)
              : launch_windows<NT, false, float, float, false>(a, nwindows, st);
  return iq ? launch_windows<NT, true, __nv_bfloat16, int8_t, true>(
                  a, nwindows, st)
            : launch_windows<NT, false, __nv_bfloat16, int8_t, true>(
                  a, nwindows, st);
}

template <int NT>
cudaError_t dispatch_v1(int kind, int iq, const void* win, int nwin,
                        const void* rc, int next, const float* rem,
                        const float* ftot, const int* nvalid,
                        const int* offsets, int smax, int nwindows,
                        float* out, cudaStream_t st) {
  if (kind == 0) {
    return iq ? launch_v1<NT, true, float, float, false>(
                    win, nwin, rc, next, rem, ftot, nvalid, offsets, smax,
                    nwindows, out, st)
              : launch_v1<NT, false, float, float, false>(
                    win, nwin, rc, next, rem, ftot, nvalid, offsets, smax,
                    nwindows, out, st);
  }
  return iq ? launch_v1<NT, true, __nv_bfloat16, int8_t, true>(
                  win, nwin, rc, next, rem, ftot, nvalid, offsets, smax,
                  nwindows, out, st)
            : launch_v1<NT, false, __nv_bfloat16, int8_t, true>(
                  win, nwin, rc, next, rem, ftot, nvalid, offsets, smax,
                  nwindows, out, st);
}

}  // namespace

#define TAP_CASES(X) X(1) X(3) X(5) X(7) X(9) X(11) X(13) X(15) X(17) \
                     X(19) X(21) X(23) X(25)

// Plain C interface for ctypes.  kind 0: float32 windows and float32 rows
// (K4/K5); kind 1: bf16 windows and int8 rows with bf16 rounding (K3).
// Every pointer is a device pointer; the stream is the caller's current
// CUDA stream.  Each returns the cudaError_t of the launch (0 on success);
// arguments it does not take (a kind other than 0/1, ntaps outside
// {1, 3, ..., 25}) return cudaErrorInvalidValue without launching.

// The cluster kernel for offsets tap_offsets((ntaps - 1) / 2, d).
extern "C" int window_taps_launch(int kind, int iq, const void* win, int nwin,
                                  const void* rc, int next, const void* rem,
                                  const void* ftot, const void* nvalid,
                                  int ntaps, int smax, int d, int nwindows,
                                  void* out, void* stream) {
  if (kind != 0 && kind != 1) return (int)cudaErrorInvalidValue;
  if (nwindows <= 0) return (int)cudaSuccess;
  const int base = smax - (ntaps - 1) / 2 * d;
  if (d < 1 || base < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nwin <= 0)                  // no samples: every tap sum is zero
    return (int)cudaMemsetAsync(out, 0, (size_t)nwindows * 2 * ntaps * 4, st);
  const int wsize = kind == 0 ? 4 : 2;           // bytes per window value
  const int rsize = kind == 0 ? 4 : 1;           // bytes per replica value
  ClusterArgs a = {};
  a.win = win;
  a.win_bytes = (long long)nwindows * nwin * (iq ? 2 : 1) * wsize;
  a.nwin = nwin;
  a.rc = rc;
  a.rc_bytes = (long long)nwindows * next * rsize;
  a.next = next;
  a.rem = static_cast<const float*>(rem);
  a.ftot = static_cast<const float*>(ftot);
  a.nvalid = static_cast<const int*>(nvalid);
  a.d = d;
  a.base = base;
  a.out = static_cast<float*>(out);
#define CLUSTER_CASE(NT) \
  case NT:               \
    return (int)dispatch_cluster<NT>(kind, iq, a, nwindows, st);
  switch (ntaps) {
    TAP_CASES(CLUSTER_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CLUSTER_CASE
}

// The v1 kernel, for any offsets (a device array of ntaps ints).
extern "C" int window_taps_v1_launch(int kind, int iq, const void* win,
                                     int nwin, const void* rc, int next,
                                     const void* rem, const void* ftot,
                                     const void* nvalid, const void* offsets,
                                     int ntaps, int smax, int nwindows,
                                     void* out, void* stream) {
  if (kind != 0 && kind != 1) return (int)cudaErrorInvalidValue;
  if (nwindows <= 0) return (int)cudaSuccess;
  const float* rm = static_cast<const float*>(rem);
  const float* ft = static_cast<const float*>(ftot);
  const int* nv = static_cast<const int*>(nvalid);
  const int* of = static_cast<const int*>(offsets);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define V1_CASE(NT)                                                          \
  case NT:                                                                   \
    return (int)dispatch_v1<NT>(kind, iq, win, nwin, rc, next, rm, ft, nv,   \
                                of, smax, nwindows, y, st);
  switch (ntaps) {
    TAP_CASES(V1_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef V1_CASE
}

// Samples per chain and CTAs per window of the cluster kernel (for the
// caller's records).
extern "C" int window_taps_samples_per_thread() { return kJ; }
extern "C" int window_taps_ctas_per_window() { return kCluster; }

extern "C" const char* window_taps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
