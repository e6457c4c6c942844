// Band correlator of the steady-state tracker, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gnsslib_tpu/ops/pallas_gram.py
// gram_usum_band_impl (body _kernel_band) together with the one-hot
// diagonal extraction that follows it in gnsslib_tpu/track/fast.py
// (_taps_band).  The TPU kernel formed a 128x128 Gram matrix per window
// only to feed its matrix unit; this kernel computes what _taps_band
// returns directly, in tap form:
//
//   cos_t[b] = sum_{i < n_b} x[wstart_b + i] * cos(2*pi*ph_b(i)) * r_b[i + smax + o_t]
//   sin_t[b] = sum_{i < n_b} x[wstart_b + i] * sin(2*pi*ph_b(i)) * r_b[i + smax + o_t]
//   ph_b(i)  = frac(frac(ftot_b * i) + rem_b)
//
// with x the float32 sample block (real, or interleaved I/Q mixed as
// (xr + j xi) * e^{+j 2 pi ph}) and r_b the window's int8 replica row.
//
// What bounds it on this card: float32 FMAs, int8->float conversions and
// shared-memory replica reads — per super-step of the 32-channel L1CA
// envelope about 5.2 M samples x 13 taps x 2 (cos, sin) FMAs plus one
// sincospif per sample; the sample stream itself is only ~21 MB.  The
// design keeps every operand on chip: one thread block per window stages
// that window's 16 KB replica row in shared memory once, each thread
// strides over the samples with 2*NT register accumulators (one sincospif
// per sample, NT shared loads and 2*NT FMAs), and a warp-shuffle plus
// shared-memory reduction writes the 2*NT sums.  Nothing but the (B, 2T)
// result goes back to device memory.
//
// Out-of-block windows: an active window whose samples [wstart, wstart+n)
// leave [0, nblock) writes zeros and clears *ok (the caller raises, as the
// TPU path raises on its out-of-band flag).  Inactive windows write zeros
// and never touch *ok.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float frac_f(float x) { return x - floorf(x); }

template <int NT, bool IQ>
__global__ void __launch_bounds__(kThreads)
band_taps_kernel(const float* __restrict__ block, long long nblock,
                 const int8_t* __restrict__ rc, int next, int nwin,
                 const int* __restrict__ wstart, const int* __restrict__ nvalid,
                 const float* __restrict__ rem, const float* __restrict__ ftot,
                 const uint8_t* __restrict__ active,
                 const int* __restrict__ offsets, int smax,
                 float* __restrict__ out, int* __restrict__ ok) {
  extern __shared__ int8_t rep[];            // this window's replica row
  __shared__ float part[kWarps][2 * NT];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  float* o = out + (size_t)b * 2 * NT;

  const long long w0 = wstart[b];
  const int n = min(nvalid[b], nwin);
  const bool act = active[b] != 0;
  const bool inside = w0 >= 0 && w0 + (long long)max(n, 0) <= nblock;
  if (!act || !inside) {                     // uniform across the block
    if (act && tid == 0) *ok = 0;
    for (int t = tid; t < 2 * NT; t += kThreads) o[t] = 0.f;
    return;
  }

  const int8_t* row = rc + (size_t)b * next;
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
  const float f = ftot[b];
  const float r0 = rem[b];
  for (int i = tid; i < n; i += kThreads) {
    // __fmul_rn: keep ftot*i rounded before the floor, as the plain
    // version computes it (no FMA contraction into the frac)
    const float ph = frac_f(frac_f(__fmul_rn(f, (float)i)) + r0);
    float s, c;
    sincospif(2.f * ph, &s, &c);
    float wc, ws;
    if (IQ) {
      const float xr = block[2 * (w0 + i)];
      const float xi = block[2 * (w0 + i) + 1];
      wc = xr * c - xi * s;
      ws = xr * s + xi * c;
    } else {
      const float x = block[w0 + i];
      wc = x * c;
      ws = x * s;
    }
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
    for (int w = 0; w < kWarps; ++w) v += part[w][tid];
    o[tid] = v;
  }
}

template <int NT, bool IQ>
cudaError_t launch(const float* block, long long nblock, const int8_t* rc,
                   int next, int nwin, const int* wstart, const int* nvalid,
                   const float* rem, const float* ftot, const uint8_t* active,
                   const int* offsets, int smax, int nwindows, float* out,
                   int* ok, cudaStream_t stream) {
  auto kernel = band_taps_kernel<NT, IQ>;
  if (next > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, next);
    if (e != cudaSuccess) return e;
  }
  kernel<<<nwindows, kThreads, next, stream>>>(
      block, nblock, rc, next, nwin, wstart, nvalid, rem, ftot, active,
      offsets, smax, out, ok);
  return cudaGetLastError();
}

}  // namespace

#define BAND_TAPS_CASE(NT)                                                   \
  case NT:                                                                   \
    return iq ? launch<NT, true>(x, nblock, r, next, nwin, ws, nv, rm, ft,   \
                                 ac, of, smax, nwindows, y, okp, st)         \
              : launch<NT, false>(x, nblock, r, next, nwin, ws, nv, rm, ft,  \
                                  ac, of, smax, nwindows, y, okp, st);

// Plain C interface for ctypes.  Every pointer is a device pointer; the
// stream is the caller's current CUDA stream.  Returns the cudaError_t of
// the launch (0 on success); ntaps outside {1, 3, ..., 25} returns
// cudaErrorInvalidValue without launching.
extern "C" int band_taps_launch(const void* block, long long nblock, int iq,
                                const void* rc, int next, int nwin,
                                const void* wstart, const void* nvalid,
                                const void* rem, const void* ftot,
                                const void* active, const void* offsets,
                                int ntaps, int smax, int nwindows, void* out,
                                void* ok, void* stream) {
  if (nwindows <= 0) return (int)cudaSuccess;
  const float* x = static_cast<const float*>(block);
  const int8_t* r = static_cast<const int8_t*>(rc);
  const int* ws = static_cast<const int*>(wstart);
  const int* nv = static_cast<const int*>(nvalid);
  const float* rm = static_cast<const float*>(rem);
  const float* ft = static_cast<const float*>(ftot);
  const uint8_t* ac = static_cast<const uint8_t*>(active);
  const int* of = static_cast<const int*>(offsets);
  float* y = static_cast<float*>(out);
  int* okp = static_cast<int*>(ok);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ntaps) {
    BAND_TAPS_CASE(1)
    BAND_TAPS_CASE(3)
    BAND_TAPS_CASE(5)
    BAND_TAPS_CASE(7)
    BAND_TAPS_CASE(9)
    BAND_TAPS_CASE(11)
    BAND_TAPS_CASE(13)
    BAND_TAPS_CASE(15)
    BAND_TAPS_CASE(17)
    BAND_TAPS_CASE(19)
    BAND_TAPS_CASE(21)
    BAND_TAPS_CASE(23)
    BAND_TAPS_CASE(25)
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* band_taps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
