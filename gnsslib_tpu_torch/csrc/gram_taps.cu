// Tap correlator of fetched window rows with the factored carrier (K2),
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gnsslib_tpu/ops/pallas_gram.py gram_usum_impl
// (:267, body _kernel :47) together with the one-hot diagonal extraction
// that follows it in gnsslib_tpu/track/fast.py (_taps_fused :443).  The
// TPU kernel packed the mixed rows into a split 64-lane layout and formed
// a bf16 128x128 Gram matrix per window only to feed its matrix unit; this
// kernel returns what _taps_fused returns, the (B, 2T) taps, directly.
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
// and does ~272 MFLOP of tap FMAs (~4 us at 67 TFLOP/s f32); the factored
// carrier needs only K + 128 sincosf per window instead of one per sample.
// The design: one thread block per window stages the window's replica row
// (zero-padded to the rows' extent) and the K row-start cos/sin in shared
// memory; with 256 threads each thread keeps one lane j, so its cos/sin
// of phi_j live in registers for the whole window; 2T register
// accumulators and a warp-shuffle plus shared-memory reduction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;                    // samples per window row
static_assert(kThreads % kLanes == 0, "a thread keeps one lane j");
constexpr float kTwoPi = 6.283185307179586f;   // f32(2*pi), as the plain version

__device__ __forceinline__ float frac_f(float x) { return x - floorf(x); }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int NT, bool IQ>
__global__ void __launch_bounds__(kThreads)
gram_taps_kernel(const __nv_bfloat16* __restrict__ win_i,
                 const __nv_bfloat16* __restrict__ win_q, int K,
                 const int8_t* __restrict__ rc, int next,
                 const float* __restrict__ rem, const float* __restrict__ ftot,
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

template <int NT, bool IQ>
cudaError_t launch(const void* win_i, const void* win_q, int K,
                   const int8_t* rc, int next, const float* rem,
                   const float* ftot, const int* offsets, int smax,
                   int nwindows, float* out, cudaStream_t stream) {
  auto kernel = gram_taps_kernel<NT, IQ>;
  const size_t shm = (size_t)K * 2 * sizeof(float) + (size_t)K * kLanes +
                     2 * (size_t)smax;
  if (shm > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (e != cudaSuccess) return e;
  }
  kernel<<<nwindows, kThreads, shm, stream>>>(
      static_cast<const __nv_bfloat16*>(win_i),
      static_cast<const __nv_bfloat16*>(win_q), K, rc, next, rem, ftot,
      offsets, smax, out);
  return cudaGetLastError();
}

}  // namespace

#define GRAM_TAPS_CASE(NT)                                                   \
  case NT:                                                                   \
    return iq ? (int)launch<NT, true>(win_i, win_q, K, r, next, rm, ft, of,  \
                                      smax, nwindows, y, st)                 \
              : (int)launch<NT, false>(win_i, win_q, K, r, next, rm, ft, of, \
                                       smax, nwindows, y, st);

// Plain C interface for ctypes.  win_i/win_q: (B, K, 128) bf16 rows
// (win_q ignored unless iq); rc: (B, next) int8.  Every pointer is a
// device pointer; the stream is the caller's current CUDA stream.
// Returns the cudaError_t of the launch (0 on success); ntaps outside
// {1, 3, ..., 25} returns cudaErrorInvalidValue without launching.
extern "C" int gram_taps_launch(int iq, const void* win_i, const void* win_q,
                                int K, const void* rc, int next,
                                const void* rem, const void* ftot,
                                const void* offsets, int ntaps, int smax,
                                int nwindows, void* out, void* stream) {
  if (nwindows <= 0) return (int)cudaSuccess;
  const int8_t* r = static_cast<const int8_t*>(rc);
  const float* rm = static_cast<const float*>(rem);
  const float* ft = static_cast<const float*>(ftot);
  const int* of = static_cast<const int*>(offsets);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ntaps) {
    GRAM_TAPS_CASE(1)
    GRAM_TAPS_CASE(3)
    GRAM_TAPS_CASE(5)
    GRAM_TAPS_CASE(7)
    GRAM_TAPS_CASE(9)
    GRAM_TAPS_CASE(11)
    GRAM_TAPS_CASE(13)
    GRAM_TAPS_CASE(15)
    GRAM_TAPS_CASE(17)
    GRAM_TAPS_CASE(19)
    GRAM_TAPS_CASE(21)
    GRAM_TAPS_CASE(23)
    GRAM_TAPS_CASE(25)
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gram_taps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
