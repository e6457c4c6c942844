// Tap correlators of fetched windows (K3, K4, K5), for NVIDIA Hopper (sm_90a).
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
// are gone (one thread block per window, any B).
//
// K3 reproduces _kernel16's rounding of the mixed samples to bf16 (round to
// nearest even), so kernel and plain version agree in the working type.
// Its tap products bf16 * int8 are exact in float32 and summed in float32,
// as the Pallas kernel's reference evaluation (interpret mode) sums them;
// with the tracker's +-1 replica rows a bf16 product would be exact anyway.
// K4/K5 mix and sum in float32 unrounded.
//
// What bounds it on this card: at the 32-channel L1CA super-step (320
// windows of 16376 samples, 16412-sample rows, 13 taps) K3 reads ~10.5 MB
// of bf16 windows and ~5.3 MB of int8 rows (~4.7 us at 3.35 TB/s) and does
// ~272 MFLOP of tap FMAs plus one sincosf per sample (~4 us at 67 TFLOP/s
// f32); K4/K5 read ~21 MB of f32 windows and ~21 MB of f32 rows (~12.5 us).
// The design keeps every reuse on chip: one thread block per window stages
// the window's replica row in shared memory once (the 13 taps read it 13
// times at shifted offsets), each thread strides over the samples with 2T
// register accumulators, and a warp-shuffle plus shared-memory reduction
// writes the 2T sums.  A float32 row is 16412 x 4 = 65.6 KB, more than the
// default 48 KB of shared memory: the launch opts in to the larger dynamic
// size with cudaFuncSetAttribute and returns its error.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kTwoPi = 6.283185307179586f;   // f32(2*pi), as the plain version

__device__ __forceinline__ float frac_f(float x) { return x - floorf(x); }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float as_float(int8_t x) { return (float)x; }

// W: window sample type, R: replica type, BF16: K3's rounding of the mix.
template <int NT, bool IQ, typename W, typename R, bool BF16>
__global__ void __launch_bounds__(kThreads)
window_taps_kernel(const W* __restrict__ win, int nwin,
                   const R* __restrict__ rc, int next,
                   const float* __restrict__ rem, const float* __restrict__ ftot,
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

template <int NT, bool IQ, typename W, typename R, bool BF16>
cudaError_t launch(const void* win, int nwin, const void* rc, int next,
                   const float* rem, const float* ftot, const int* nvalid,
                   const int* offsets, int smax, int nwindows, float* out,
                   cudaStream_t stream) {
  auto kernel = window_taps_kernel<NT, IQ, W, R, BF16>;
  const size_t shm = (size_t)next * sizeof(R);
  if (shm > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (e != cudaSuccess) return e;
  }
  kernel<<<nwindows, kThreads, shm, stream>>>(
      static_cast<const W*>(win), nwin, static_cast<const R*>(rc), next, rem,
      ftot, nvalid, offsets, smax, out);
  return cudaGetLastError();
}

template <int NT>
cudaError_t dispatch(int kind, int iq, const void* win, int nwin,
                     const void* rc, int next, const float* rem,
                     const float* ftot, const int* nvalid, const int* offsets,
                     int smax, int nwindows, float* out, cudaStream_t st) {
  if (kind == 0) {
    return iq ? launch<NT, true, float, float, false>(
                    win, nwin, rc, next, rem, ftot, nvalid, offsets, smax,
                    nwindows, out, st)
              : launch<NT, false, float, float, false>(
                    win, nwin, rc, next, rem, ftot, nvalid, offsets, smax,
                    nwindows, out, st);
  }
  return iq ? launch<NT, true, __nv_bfloat16, int8_t, true>(
                  win, nwin, rc, next, rem, ftot, nvalid, offsets, smax,
                  nwindows, out, st)
            : launch<NT, false, __nv_bfloat16, int8_t, true>(
                  win, nwin, rc, next, rem, ftot, nvalid, offsets, smax,
                  nwindows, out, st);
}

}  // namespace

#define WINDOW_TAPS_CASE(NT)                                                 \
  case NT:                                                                   \
    return (int)dispatch<NT>(kind, iq, win, nwin, rc, next, rm, ft, nv, of,  \
                             smax, nwindows, y, st);

// Plain C interface for ctypes.  kind 0: float32 windows and float32 rows
// (K4/K5); kind 1: bf16 windows and int8 rows with bf16 rounding (K3).
// Every pointer is a device pointer; the stream is the caller's current
// CUDA stream.  Returns the cudaError_t of the launch (0 on success); a
// kind other than 0/1 or ntaps outside {1, 3, ..., 25} returns
// cudaErrorInvalidValue without launching.
extern "C" int window_taps_launch(int kind, int iq, const void* win, int nwin,
                                  const void* rc, int next, const void* rem,
                                  const void* ftot, const void* nvalid,
                                  const void* offsets, int ntaps, int smax,
                                  int nwindows, void* out, void* stream) {
  if (kind != 0 && kind != 1) return (int)cudaErrorInvalidValue;
  if (nwindows <= 0) return (int)cudaSuccess;
  const float* rm = static_cast<const float*>(rem);
  const float* ft = static_cast<const float*>(ftot);
  const int* nv = static_cast<const int*>(nvalid);
  const int* of = static_cast<const int*>(offsets);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ntaps) {
    WINDOW_TAPS_CASE(1)
    WINDOW_TAPS_CASE(3)
    WINDOW_TAPS_CASE(5)
    WINDOW_TAPS_CASE(7)
    WINDOW_TAPS_CASE(9)
    WINDOW_TAPS_CASE(11)
    WINDOW_TAPS_CASE(13)
    WINDOW_TAPS_CASE(15)
    WINDOW_TAPS_CASE(17)
    WINDOW_TAPS_CASE(19)
    WINDOW_TAPS_CASE(21)
    WINDOW_TAPS_CASE(23)
    WINDOW_TAPS_CASE(25)
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* window_taps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
