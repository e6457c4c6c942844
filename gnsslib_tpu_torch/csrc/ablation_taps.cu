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
// written as (B, 2T) float32 interleaved [cos_t, sin_t].  n_b is a float,
// as in the TPU tool (its mask is i < n), and the window index i runs
// below min(ceil(n_b), nwin).  The TPU's 8 windows per grid cell and the
// tool's B % 8 padding were tiling artefacts and are gone: one thread block
// per window, any B.
//
// The kernel is window_taps.cu's float32 instantiation instruction for
// instruction (the same shared-memory row, the same scalar loads, the same
// register accumulators and reduction), so that each ablation measures one
// cost of K3-K5 on this card.  The tap lags come from the caller as a
// device array (smax + o_t, or 128*t for ALIGNED): FULL and ALIGNED run the
// same instructions and differ only in the addresses they read.  Every load
// is a scalar 4-byte load: the window from device memory (coalesced), the
// replica from shared memory, where 32 consecutive samples of a warp hit 32
// banks at any offset.  An unaligned offset therefore costs nothing here
// that an aligned one saves; ALIGNED measures that claim.
//
// What bounds it on this card: memory.  At the tool's shapes (B = 320,
// nwin = 16493, W = 18229, 13 taps) a launch reads 21.1 MB of f32 windows
// and 23.3 MB of f32 rows, 44.4 MB: ~13.3 us at 3.35 TB/s (H100 SXM),
// against ~0.28 GFLOP of tap FMAs (~4 us at 67 TFLOP/s f32) plus one sincosf
// per sample.  A row is 18229 x 4 = 72.9 KB of dynamic shared memory, above
// the default 48 KB: a launch that needs more than its instantiation has
// opted in to calls cudaFuncSetAttribute and returns its error (so a
// launch inside CUDA-graph capture, after a warm-up, makes no such call).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kTwoPi = 6.283185307179586f;   // f32(2*pi), as the plain version

enum Variant { kFull = 0, kNoSin = 1, kOneTap = 2, kAligned = 3 };

__device__ __forceinline__ float frac_f(float x) { return x - floorf(x); }

template <int V, int NT>
__global__ void __launch_bounds__(kThreads)
ablation_taps_kernel(const float* __restrict__ win, int nwin,
                     const float* __restrict__ rc, int W,
                     const float* __restrict__ rem,
                     const float* __restrict__ ftot,
                     const float* __restrict__ nvalid,
                     const int* __restrict__ lags, float* __restrict__ out) {
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
cudaError_t launch(const float* win, int nwin, const float* rc, int W,
                   const float* rem, const float* ftot, const float* nvalid,
                   const int* lags, int nwindows, float* out,
                   cudaStream_t stream) {
  auto kernel = ablation_taps_kernel<V, NT>;
  const size_t shm = (size_t)W * sizeof(float);
  // opt in only when a launch needs more than this instantiation already
  // has, so that repeated launches (and graph capture) make no call
  static size_t opted = 48 * 1024;
  if (shm > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (e != cudaSuccess) return e;
    opted = shm;
  }
  kernel<<<nwindows, kThreads, shm, stream>>>(win, nwin, rc, W, rem, ftot,
                                              nvalid, lags, out);
  return cudaGetLastError();
}

template <int NT>
cudaError_t dispatch(int variant, const float* win, int nwin, const float* rc,
                     int W, const float* rem, const float* ftot,
                     const float* nv, const int* lags, int nwindows,
                     float* out, cudaStream_t st) {
  switch (variant) {
    case kFull:
      return launch<kFull, NT>(win, nwin, rc, W, rem, ftot, nv, lags,
                               nwindows, out, st);
    case kNoSin:
      return launch<kNoSin, NT>(win, nwin, rc, W, rem, ftot, nv, lags,
                                nwindows, out, st);
    case kOneTap:
      return launch<kOneTap, NT>(win, nwin, rc, W, rem, ftot, nv, lags,
                                 nwindows, out, st);
    case kAligned:
      return launch<kAligned, NT>(win, nwin, rc, W, rem, ftot, nv, lags,
                                  nwindows, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

#define ABLATION_TAPS_CASE(NT)                                                \
  case NT:                                                                    \
    return (int)dispatch<NT>(variant, w, nwin, r, W, rm, ft, nv, lg, nwindows, \
                             y, st);

// Plain C interface for ctypes.  variant: 0 FULL, 1 NOSIN, 2 ONETAP,
// 3 ALIGNED.  win (B, nwin), rc (B, W), rem, ftot and n (B,) float32; lags
// (ntaps,) int32, each with lag + nwin <= W (the caller checks); out
// (B, 2*ntaps) float32.  Every pointer is a device pointer; the stream is
// the caller's current CUDA stream.  Returns the cudaError_t of the launch
// (0 on success); a variant outside 0..3 or ntaps outside {1, 3, ..., 25}
// returns cudaErrorInvalidValue without launching.
extern "C" int ablation_taps_launch(int variant, const void* win, int nwin,
                                    const void* rc, int W, const void* rem,
                                    const void* ftot, const void* n,
                                    const void* lags, int ntaps, int nwindows,
                                    void* out, void* stream) {
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
  switch (ntaps) {
    ABLATION_TAPS_CASE(1)
    ABLATION_TAPS_CASE(3)
    ABLATION_TAPS_CASE(5)
    ABLATION_TAPS_CASE(7)
    ABLATION_TAPS_CASE(9)
    ABLATION_TAPS_CASE(11)
    ABLATION_TAPS_CASE(13)
    ABLATION_TAPS_CASE(15)
    ABLATION_TAPS_CASE(17)
    ABLATION_TAPS_CASE(19)
    ABLATION_TAPS_CASE(21)
    ABLATION_TAPS_CASE(23)
    ABLATION_TAPS_CASE(25)
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ablation_taps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
