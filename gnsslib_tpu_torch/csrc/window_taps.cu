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
// tools/profile_window.py builds the steps below, the other choices of
// each constant and ablations as variants of this source and times them
// (PERF.md has the table; at the main path's shapes K3 takes under half
// of v1's time, the f32 instantiation about two thirds):
//
// 1. Reuse each replica value across the taps.  A thread takes a chain of
//    kJ samples s0 + j*d and holds R[q] = r[s0 + base + q*d],
//    q < kJ + 2*corrn, in registers, converted to f32 once: tap m of chain
//    step j is R[j + m], (kJ + 2*corrn)/kJ = 1.36 shared loads and
//    conversions per sample at 13 taps instead of 13.  Threads cover the d
//    residues of tiles of kJ*d samples; with kJ = 33, (kJ - 1)*d is a
//    multiple of 32, so chain starts are distinct mod 32 and a warp's
//    stride-d reads of 4-byte values hit 32 banks for any d.  Alone (one
//    CTA per window, staged one value per thread) this step is slower
//    than v1: the staging, unhidden, then holds every chain back.
// 2. Stage with asynchronous copies.  The segment's replica values and
//    its window samples are copied global -> shared by 16-byte cp.async,
//    all issued before one wait, so each CTA has its whole segment's bytes
//    in flight at once.  Copies start at the 16-byte boundary below the
//    first byte: K3's int8 rows start every 16412 bytes (4-byte aligned
//    only) and a segment starts anywhere in its row; a copy that reaches
//    past the bytes asked for (or the last row) is cut to those bytes.
//    This step moved most.  Staging the window too beat reading it
//    through L1 for K3 and for f32 I/Q windows (by up to 30%): the
//    windows come from device memory, unlike K1's block, which stays in
//    L2.  f32 real windows read up to 13% faster through L1 in most runs
//    and slower in one; one path, staged, serves all.  Two designs that
//    should hide the copies behind the chains were slower (PERF.md): the
//    copies split into one group per round of chains, 2 or 4 chains per
//    thread, and clusters that stay resident and stage the next window
//    while they compute one (twice the shared memory, so fewer CTAs per
//    SM).
// 3. Fill the card.  Each window is split into S = kCluster segments, one
//    CTA each, and the S CTAs of a window run as one thread-block cluster
//    (cudaLaunchKernelEx with the cluster attribute).  Each CTA reduces its
//    2T sums in shared memory (a warp butterfly, then the warps in order);
//    every rank writes them into rank 0's shared memory through distributed
//    shared memory, and after one cluster barrier rank 0 adds them in rank
//    order and writes the row.  One launch, no scratch buffer, no atomics:
//    the output is bit-identical from launch to launch.  Whether a window
//    has work (n > 0) is decided per window, before the first cluster
//    barrier, so every CTA of a cluster takes the same early return or
//    reaches every barrier.  S = 2 was the fastest of 1, 2 and 4.  Both
//    instantiations fit 80 registers with no spill (3 CTAs of 256 threads
//    per SM); capped at 64 (4 CTAs) some instantiations spill and none
//    is faster by more than 2%.
// 4. Carrier.  sincospif(2*ph) in place of sincosf(f32(2*pi) * ph): no
//    Payne-Hanek reduction, no rounding of the angle; about a fifth of the
//    kernel's time is still the carrier.  Its error against the plain
//    version's cos/sin(f32(2*pi) * ph) is a few 1e-7 absolute, inside the
//    f32 tolerance (1e-5 of the window's L1 norm); for K3 it flips the
//    bf16 rounding of about 1.4 mixed values in 10^4 (1424 of 10475554 at
//    the main path's shapes, real input), each moving a tap by at most
//    2^-7 |x_i|: the largest tap error is then 0.75 against K3's tolerance
//    of 106 (1e-4 of the L1 norm), where sincosf's is 0.004.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kJ = 33;            // samples per chain (stride d)
constexpr int kCluster = 2;       // CTAs per window: one thread-block cluster
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

int ceil_div(int x, int y) { return (x + y - 1) / y; }

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
// The cluster kernel (steps 1-4 above).

struct ClusterArgs {
  const void* win;
  long long win_bytes;           // bytes in win (B * nwin * F * sizeof(W))
  int nwin;
  const void* rc;
  long long rc_bytes;            // bytes in rc (B * next * sizeof(R))
  int next;
  const float* rem;
  const float* ftot;
  const int* nvalid;
  int d;                         // the offsets' step
  int base;                      // smax - corrn * d: the lag of tap m is base + m*d
  int seg;                       // samples per CTA, a multiple of kJ * d
  float* out;
};

// The output slot of the tap at lag index m (offset (m - c) * d) in
// tap_offsets order [0, -d, +d, -2d, +2d, ...].
__device__ __forceinline__ int slot_of(int m, int c) {
  return m == c ? 0 : (m < c ? 2 * (c - m) - 1 : 2 * (m - c));
}

// The carrier of sample i (fi = i as a float): sincospif(2 ph) with
// ph = frac(frac(ftot * i) + rem).  The outer frac is left to sincospif,
// whose argument reduction removes the same even integer from 2 ph either
// way, so the result is the same bit for bit (|2 ph| < 2^22).
__device__ __forceinline__ void carrier(float f, float fi, float r0,
                                        float* sn, float* cs) {
  // __fmul_rn: ftot*i rounded before the floor, as the plain version
  // computes it (no FMA contraction into the frac)
  sincospif(2.f * (frac_f(__fmul_rn(f, fi)) + r0), sn, cs);
}

// One level of a warp butterfly over v[0, 2H): lanes that differ in bit H
// swap halves, and each keeps the half its bit selects, summed with the
// partner's: after fold<16>, lane l holds the warp's sum of v[l].  Shuffles
// per level halve (31 in all, not 5 per value); the order is fixed.
template <int H>
__device__ __forceinline__ void fold(float (&v)[32], int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = v[i];
    const float hi = v[i + H];
    v[i] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, H);
  }
  if constexpr (H > 1) fold<H / 2>(v, lane);
}

// K3's rounding of a mixed pair to bf16 (round to nearest even).
__device__ __forceinline__ void bf16_round_pair(float& a, float& b) {
  a = bf16_round(a);
  b = bf16_round(b);
}

// The mixed sample s of x (F values of W each) as f32 (wc, ws); zero where
// !valid (x is not read).  K3 (BF16) rounds every product where the plain
// version rounds it (no FMA contraction), then the mix to bf16.
template <bool IQ, bool BF16, typename W>
__device__ __forceinline__ void mix(const W* x, int s, bool valid, float sn,
                                    float cs, float& wc, float& ws) {
  if (IQ) {
    const float xr = valid ? as_float(x[2 * s]) : 0.f;
    const float xi = valid ? as_float(x[2 * s + 1]) : 0.f;
    if (BF16) {
      wc = __fsub_rn(__fmul_rn(xr, cs), __fmul_rn(xi, sn));
      ws = __fadd_rn(__fmul_rn(xr, sn), __fmul_rn(xi, cs));
    } else {
      wc = xr * cs - xi * sn;
      ws = xr * sn + xi * cs;
    }
  } else {
    const float xv = valid ? as_float(x[s]) : 0.f;
    wc = xv * cs;
    ws = xv * sn;
  }
  if (BF16) bf16_round_pair(wc, ws);
}

// The taps of one chain, kJ samples d apart from x (the first `left` count,
// the rest are taken as zero).  The replica values from r, d apart, are
// loaded and converted once into R, and tap m (lag order) of chain step j
// is R[j + m]; R[j + 2C] is loaded at step j, so the live values stay near
// NT.  fi0 is the first sample's window index.
template <int NT, bool IQ, bool BF16, typename W, typename R>
__device__ __forceinline__ void chain_taps(float (&ac)[NT], float (&as)[NT],
                                           const R* r, const W* x, int d,
                                           int left, float f, float r0,
                                           float fi0) {
  constexpr int C = (NT - 1) / 2;
  float Rv[kJ + 2 * C];
#pragma unroll
  for (int q = 0; q < 2 * C; ++q) Rv[q] = as_float(r[q * d]);
  const float fd = (float)d;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    Rv[j + 2 * C] = as_float(r[(j + 2 * C) * d]);
    const int s = j * d;
    float sn, cs;
    // the window index fi0 + s, exact (integers below 2^24)
    carrier(f, fmaf((float)j, fd, fi0), r0, &sn, &cs);
    float wc, ws;
    mix<IQ, BF16>(x, s, s < left, sn, cs, wc, ws);
#pragma unroll
    for (int m = 0; m < NT; ++m) {
      ac[m] = fmaf(wc, Rv[j + m], ac[m]);
      as[m] = fmaf(ws, Rv[j + m], as[m]);
    }
  }
}

// 80 registers up to 13 taps (3 CTAs of 256 threads per SM), 255 above
template <int NT, bool IQ, typename W, typename R, bool BF16>
__global__ void __launch_bounds__(kThreads, NT <= 13 ? 3 : 1)
window_taps_cluster_kernel(const ClusterArgs a) {
  constexpr int C = (NT - 1) / 2;            // corrn
  constexpr int F = IQ ? 2 : 1;              // values per sample
  constexpr int NV = 2 * NT;                 // sums per window
  constexpr int NCH = (NV + 31) / 32;        // 32-sum chunks
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part[kWarps][32 * NCH];
  __shared__ float gather[kCluster][NV];     // rank 0's: every rank's sums
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  float* o = a.out + (size_t)b * NV;

  const int n = min(a.nvalid[b], a.nwin);
  const float f = a.ftot[b];
  const float r0 = a.rem[b];
  if (n <= 0) {                 // the same in every CTA of the cluster
    if (rank == 0)
      for (int t = tid; t < NV; t += blockDim.x) o[t] = 0.f;
    return;
  }
  // arrive now, wait before writing to rank 0's shared memory: every CTA
  // of the cluster has then started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int d = a.d;
  const int seg = a.seg;
  const int seg0 = rank * seg;                     // first window sample
  const int lim = max(0, min(n - seg0, seg));      // valid samples here

  float ac[NT], as[NT];                            // lag order m
#pragma unroll
  for (int m = 0; m < NT; ++m) {
    ac[m] = 0.f;
    as[m] = 0.f;
  }

  if (lim > 0) {                                   // uniform in the CTA
    const int nrep = seg + 2 * C * d;              // replica values read
    const int rcount = nrep * (int)sizeof(R);
    const long long rfirst =
        ((long long)b * a.next + seg0 + a.base) * (long long)sizeof(R);
    const int rhead = stage_async(smem, a.rc, a.rc_bytes, rfirst, rcount);
    const R* rep = reinterpret_cast<const R*>(smem + rhead);
    unsigned char* wsm = smem + staged_bytes(rcount);
    const long long wfirst =
        ((long long)b * a.nwin + seg0) * F * (long long)sizeof(W);
    const W* x = reinterpret_cast<const W*>(           // the segment's samples
        wsm + stage_async(wsm, a.win, a.win_bytes, wfirst,
                          lim * F * (int)sizeof(W)));
    cp_async_wait_all();
    __syncthreads();
    // chain u: tile k = u / d of kJ*d samples, residue u % d
    const int tile = kJ * d;
    for (int u = tid; u < seg / tile * d; u += blockDim.x) {
      const int k = u / d;
      const int s0 = k * tile + (u - k * d);
      if (s0 < lim)
        chain_taps<NT, IQ, BF16>(ac, as, rep + s0, x + F * s0, d, lim - s0,
                                 f, r0, (float)(seg0 + s0));
    }
  }

  // The CTA's sums, [cos_m, sin_m] in lag order: a butterfly over the
  // warp (fold) leaves lane l with the warp's sum of value l of each
  // 32-value chunk; then the warps' sums are added in warp order.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float v[NCH][32];
#pragma unroll
  for (int k = 0; k < 32 * NCH; ++k) v[k / 32][k % 32] = 0.f;
#pragma unroll
  for (int m = 0; m < NT; ++m) {
    v[2 * m / 32][2 * m % 32] = ac[m];
    v[(2 * m + 1) / 32][(2 * m + 1) % 32] = as[m];
  }
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    fold<16>(v[ch], lane);
    part[warp][32 * ch + lane] = v[ch][0];
  }
  __syncthreads();
  // each rank writes its sums into rank 0's gather[rank]; after the
  // cluster barrier rank 0 adds them in rank order
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* to = cluster.map_shared_rank(&gather[0][0], 0) + rank * NV;
  for (int t = tid; t < NV; t += blockDim.x) {
    float x = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) x += part[w][t];
    to[t] = x;
  }
  cluster.sync();
  if (rank == 0) {
    for (int t = tid; t < NV; t += blockDim.x) {
      float x = 0.f;
      for (int r = 0; r < kCluster; ++r) x += gather[r][t];
      o[2 * slot_of(t >> 1, C) + (t & 1)] = x;
    }
  }
}

template <int NT, bool IQ, typename W, typename R, bool BF16>
cudaError_t launch_v1(const void* win, int nwin, const void* rc, int next,
                      const float* rem, const float* ftot, const int* nvalid,
                      const int* offsets, int smax, int nwindows, float* out,
                      cudaStream_t stream) {
  auto kernel = window_taps_v1_kernel<NT, IQ, W, R, BF16>;
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

template <int NT, bool IQ, typename W, typename R, bool BF16>
cudaError_t launch_cluster(ClusterArgs a, int nwindows, cudaStream_t stream) {
  constexpr int C = (NT - 1) / 2;
  constexpr int F = IQ ? 2 : 1;
  const int tile = kJ * a.d;
  a.seg = ceil_div(ceil_div(a.nwin, kCluster), tile) * tile;
  const int nrep = a.seg + 2 * C * a.d;
  // one chain of kJ samples per thread where the segment allows
  const int want = ceil_div(a.seg / tile * a.d, 32) * 32;
  const int threads = want < kThreads ? want : kThreads;
  size_t shm = staged_bytes(nrep * (int)sizeof(R));
  shm += staged_bytes(a.seg * F * (int)sizeof(W));
  auto kernel = window_taps_cluster_kernel<NT, IQ, W, R, BF16>;
  // opt in only when a launch needs more than this instantiation already
  // has, so that repeated launches (and graph capture) make no call; the
  // first launch opts in whatever it needs (its static shared memory
  // counts against the 48 KB default too)
  static size_t opted = 0;
  if (shm > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (e != cudaSuccess) {
      cudaGetLastError();             // leave no error for the next launch
      return e;
    }
    opted = shm;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nwindows * kCluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = shm;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// kind 0: float32 windows and rows (K4/K5); kind 1: bf16 windows, int8 rows
// and bf16 rounding of the mix (K3).
template <int NT>
cudaError_t dispatch_cluster(int kind, int iq, ClusterArgs a, int nwindows,
                             cudaStream_t st) {
  if (kind == 0)
    return iq ? launch_cluster<NT, true, float, float, false>(a, nwindows, st)
              : launch_cluster<NT, false, float, float, false>(a, nwindows, st);
  return iq ? launch_cluster<NT, true, __nv_bfloat16, int8_t, true>(
                  a, nwindows, st)
            : launch_cluster<NT, false, __nv_bfloat16, int8_t, true>(
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
