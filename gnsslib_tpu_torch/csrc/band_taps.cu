// Band correlator of the steady-state tracker (K1), for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel gnsslib_tpu/ops/pallas_gram.py
// gram_usum_band_impl (:192, pl.pallas_call at :256, body _kernel_band
// :107) together with the one-hot diagonal extraction that follows it in
// gnsslib_tpu/track/fast.py (_taps_band).  The TPU kernel formed a 128x128
// Gram matrix per window only to feed its matrix unit; this kernel computes
// what _taps_band returns directly, in tap form:
//
//   cos_t[b] = sum_{i < n_b} x[wstart_b + i] * cos(2*pi*ph_b(i)) * r_b[i + smax + o_t]
//   sin_t[b] = sum_{i < n_b} x[wstart_b + i] * sin(2*pi*ph_b(i)) * r_b[i + smax + o_t]
//   ph_b(i)  = frac(frac(ftot_b * i) + rem_b)
//
// with x the float32 sample block (real, or interleaved I/Q mixed as
// (xr + j xi) * e^{+j 2 pi ph}), r_b the window's int8 replica row and
// n_b = min(n_b, nwin).  Out-of-block windows: an active window whose
// samples [wstart, wstart+n) leave [0, nblock) writes zeros and clears *ok
// (the caller raises, as the TPU path raises on its out-of-band flag).
// Inactive windows write zeros and never touch *ok.
//
// What bounds it on this card: float32 issue.  At the main path's shapes
// (320 windows of 16376 samples, ~240 active, ~3.9 M samples, 13 taps) a
// launch does ~102 M FMAs, ~3.4 us on 132 SMs x 128 lanes at ~1.75 GHz;
// with the carrier (one sincospif: argument reduction, two polynomials,
// quadrant fix-ups, ~30 instructions), the mix, the loads and their
// addresses, a sample costs ~85 instructions, ~10 us of issue.  Then the
// reads of the samples (the 0.85 MB f32 block, which all 32 channels'
// windows read, stays in L2; the windows read ~14 MB of it through L1).
//
// The v1 kernel (band_taps_v1_kernel, below, the port's first) gives each
// window one 256-thread block and pays, per sample and tap, one shared
// byte load and one int8->f32 conversion for two FMAs, and copies its
// replica row one byte per thread per iteration.  This kernel
// (band_taps_cluster_kernel) is built in three steps; tools/profile_band.py
// builds steps 1-2 and the other cluster sizes as variants of this source
// and times them:
//
// 1. Fill the card.  Each window is split into S segments of `seg`
//    samples, one CTA each, and the S CTAs of a window run as one thread
//    block cluster (cudaLaunchKernelEx with the cluster attribute).  Each
//    CTA stages only its segment's replica bytes plus the 2*corrn*d halo
//    and reduces its 2T sums in shared memory (a warp butterfly, then the
//    warps in order); every rank writes them into rank 0's shared memory
//    through distributed shared memory, and after one cluster barrier
//    rank 0 adds them in rank order and writes the row and the flag.  One
//    launch, no scratch buffer, no atomics: the output is bit-identical
//    from launch to launch.  Whether a window is active and inside the
//    block is decided per window, so every CTA of a cluster takes the same
//    early return or reaches every cluster barrier.  S = kCluster = 2
//    was the fastest of 1, 2, 4 and 8 on the card, I/Q input included.
// 2. Convert each replica byte once and reuse it across the taps.  The
//    receiver's offsets are tap_offsets(corrn, d): 0, -d, +d, ... -corrn*d,
//    +corrn*d, so tap m (in lag order) of sample i reads r[i + base + m*d]
//    with base = smax - corrn*d.  A thread takes a chain of samples
//    s0 + j*d, j < kJ, and holds R[q] = r[s0 + base + q*d], q < kJ + 2*corrn,
//    in registers: tap m of chain step j is R[j + m], so each replica byte
//    is loaded and converted once per thread and feeds up to T taps x 2
//    FMAs, (kJ + 2*corrn)/kJ = 1.36 byte loads and conversions per sample
//    at 13 taps instead of 13.  Threads cover the d residues of tiles of
//    kJ*d samples; with kJ = 33, (kJ - 1)*d is a multiple of 32, so chain
//    starts are distinct mod 32 and a warp's stride-d reads hit 32 banks
//    for any d.  Steps 1 and 2 stage the replica bytes one per thread per
//    iteration; step 1 is step 2 with kJ = 1 (per sample and tap one byte
//    load and one conversion).  Offsets that are not such a progression
//    are never produced by the receiver; the wrapper sends them to the
//    v1 kernel.
// 3. More bytes in flight for the staging.  The segment's replica bytes
//    are staged with 16-byte cp.async copies from the 16-byte boundary
//    below their first byte (row b starts at b*next bytes, which is
//    4-byte aligned only), all issued before one wait; a copy that
//    reaches past the row data is cut to the bytes that lie in it (nothing
//    is read past the last row).  The samples are read from the block, as
//    in step 2: a warp's stride-d loads touch ~11 cache lines, which the
//    chain's next steps hit in L1, and staging them in shared memory as
//    well was slower on the card (it adds their transfer before the chain
//    loop can start).
//
// Wide geometries (T > 25 taps, CORRN 13 and up; the JAX package runs them
// through the same band kernel up to CORRN*CORRD = 32 and beyond that
// through its diag backend).  The instantiations above stop at 25 taps;
// band_taps_wide_kernel takes any odd T in the same single launch per
// super-step, with the same clusters, staging, output and out-of-block
// flag.  Each CTA stages its replica segment once (seg + 2*corrn*d bytes)
// and loops over the taps in groups of kGroup = 13 lags, each group at the
// 13-tap instantiation's register budget (R[kJ + 12] and 26 sums): group g
// runs the chains of step 2 against the replica shifted by its first lag,
// reduces its 26 sums into the CTA's row in shared memory, and the next
// group starts.  The last group starts at T - 13 and recomputes the lags
// it shares with the group before it (written again, the same way every
// launch), so no lag past 2*corrn*d is read.  The carrier-mixed samples
// are computed once per CTA into shared memory (2 floats per sample, ~66
// KB per CTA at 16376-sample windows) and every group reads them there
// (STAGED), which measured faster than recomputing them in every group
// as the chains of the narrow kernel do (tools/profile_band.py --wide
// times both; PERF.md has the times).  Staging needs ~9 bytes per
// segment sample, so launch_wide stages where the card's shared memory
// holds it (windows up to ~51k samples on an H100, e.g. 1 ms codes up to
// ~51 Msps) and recomputes past that, to the narrow kernel's own cap of
// ~1 byte per segment sample.  Offsets that are not a progression take
// band_taps_v1_wide_kernel: v1 looping over groups of kGroup taps, the
// carrier recomputed per group.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kJ = 33;            // samples per thread (stride d)
constexpr int kCluster = 2;       // CTAs per window: one thread block cluster
constexpr int kMaxNarrow = 25;    // the largest tap count instantiated below
constexpr int kGroup = 13;        // taps per group of the wide kernels

__device__ __forceinline__ float frac_f(float x) { return x - floorf(x); }

// ------------------------------------------------------------------------
// The v1 kernel: one thread block per window, the whole replica row in
// shared memory as int8, per sample one sincospif, NT shared byte loads and
// 2*NT FMAs.  Takes any offsets of up to kMaxNarrow taps.

template <int NT, bool IQ>
__global__ void __launch_bounds__(kThreads)
band_taps_v1_kernel(const float* __restrict__ block, long long nblock,
                    const int8_t* __restrict__ rc, int next, int nwin,
                    const int* __restrict__ wstart,
                    const int* __restrict__ nvalid,
                    const float* __restrict__ rem,
                    const float* __restrict__ ftot,
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

// The v1 kernel for more than kMaxNarrow taps: the same per-sample work,
// looped over groups of kGroup taps (the offsets past the last tap repeat
// it and are not written).
template <bool IQ>
__global__ void __launch_bounds__(kThreads)
band_taps_v1_wide_kernel(const float* __restrict__ block, long long nblock,
                         const int8_t* __restrict__ rc, int next, int nwin,
                         const int* __restrict__ wstart,
                         const int* __restrict__ nvalid,
                         const float* __restrict__ rem,
                         const float* __restrict__ ftot,
                         const uint8_t* __restrict__ active,
                         const int* __restrict__ offsets, int ntaps,
                         int smax, float* __restrict__ out,
                         int* __restrict__ ok) {
  constexpr int G = kGroup;
  extern __shared__ int8_t rep[];            // this window's replica row
  __shared__ float part[kWarps][2 * G];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  float* o = out + (size_t)b * 2 * ntaps;

  const long long w0 = wstart[b];
  const int n = min(nvalid[b], nwin);
  const bool act = active[b] != 0;
  const bool inside = w0 >= 0 && w0 + (long long)max(n, 0) <= nblock;
  if (!act || !inside) {                     // uniform across the block
    if (act && tid == 0) *ok = 0;
    for (int t = tid; t < 2 * ntaps; t += kThreads) o[t] = 0.f;
    return;
  }

  const int8_t* row = rc + (size_t)b * next;
  for (int j = tid; j < next; j += kThreads) rep[j] = row[j];
  __syncthreads();
  const float f = ftot[b];
  const float r0 = rem[b];
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int t0 = 0; t0 < ntaps; t0 += G) {
    int lag[G];
    float ac[G], as[G];
#pragma unroll
    for (int t = 0; t < G; ++t) {
      lag[t] = smax + offsets[min(t0 + t, ntaps - 1)];
      ac[t] = 0.f;
      as[t] = 0.f;
    }
    for (int i = tid; i < n; i += kThreads) {
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
      for (int t = 0; t < G; ++t) {
        const float r = (float)rep[i + lag[t]];
        ac[t] = fmaf(wc, r, ac[t]);
        as[t] = fmaf(ws, r, as[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < G; ++t) {
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
    if (tid < 2 * G && t0 + tid / 2 < ntaps) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += part[w][tid];
      o[2 * t0 + tid] = v;
    }
    __syncthreads();                         // part is the next group's
  }
}

// ------------------------------------------------------------------------
// The cluster kernel (steps 1-3 above).

struct ClusterArgs {
  const float* block;
  long long nblock;              // samples in the block
  const int8_t* rc;
  long long rc_len;              // bytes in rc (B * next)
  int next, nwin;
  const int* wstart;
  const int* nvalid;
  const float* rem;
  const float* ftot;
  const uint8_t* active;
  int d;                         // the offsets' step
  int base;                      // smax - corrn * d: the lag of tap m is base + m*d
  int seg;                       // samples per CTA, a multiple of kJ * d
  float* out;
  int* ok;
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

// Shared bytes that stage_async needs for `count` bytes at any head.
__host__ __device__ constexpr int staged_bytes(int count) {
  return (count + 30) / 16 * 16;
}

// 16 bytes global -> shared without a register round trip: the first
// `bytes` (1..16) from src, zeros after them.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// bytes [first, first + count) of src (len bytes) land at
// dst + head, head = (src + first) mod 16, by 16-byte cp.async copies from
// the 16-byte boundary at or below src + first, every one issued before
// any wait.  A copy that reaches past first + count or len is cut to the
// bytes in range (the rest of its 16 are zero); a vector that starts
// before src is copied byte by byte.  dst is 16-byte aligned and holds
// staged_bytes(count).  Returns head; the caller waits
// (cp_async_wait_all) and synchronises.
__device__ __forceinline__ int stage_async(unsigned char* dst,
                                           const int8_t* src, long long len,
                                           long long first, int count) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  const int head = static_cast<int>(
      reinterpret_cast<uintptr_t>(s + first) & 15);
  const long long end = min(len, first + count);
  for (int v = threadIdx.x; v < (head + count + 15) >> 4; v += blockDim.x) {
    const long long k0 = first - head + 16LL * v;   // the vector's first byte
    unsigned char* out = dst + 16 * v;
    if (k0 >= 0 && k0 < end) {
      cp_async16(out, s + k0, static_cast<int>(min(16LL, end - k0)));
    } else if (k0 >= end) {
      *reinterpret_cast<uint4*>(out) = make_uint4(0u, 0u, 0u, 0u);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        out[e] = k0 + e >= 0 && k0 + e < end ? s[k0 + e] : 0;
    }
  }
  return head;
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

// The taps of one chain, kJ samples d apart from the sample
// at x in the block (F floats each; the first `left` count, the rest are
// taken as zero).  The replica bytes from r, d apart, are loaded and
// converted once into R, and tap m (lag order) of chain step j is
// R[j + m].  fi0 is the first sample's window index.
template <int NT, bool IQ>
__device__ __forceinline__ void chain_taps(float (&ac)[NT], float (&as)[NT],
                                           const int8_t* r, const float* x,
                                           int d, int left, float f,
                                           float r0, float fi0) {
  constexpr int C = (NT - 1) / 2;
  float R[kJ + 2 * C];
#pragma unroll
  for (int q = 0; q < kJ + 2 * C; ++q) R[q] = (float)r[q * d];
  const float fd = (float)d;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int s = j * d;
    const bool valid = s < left;
    float sn, cs;
    // the window index fi0 + s, exact (integers below 2^24)
    carrier(f, fmaf((float)j, fd, fi0), r0, &sn, &cs);
    float wc, ws;
    if (IQ) {
      const float xr = valid ? x[2 * s] : 0.f;
      const float xi = valid ? x[2 * s + 1] : 0.f;
      wc = xr * cs - xi * sn;
      ws = xr * sn + xi * cs;
    } else {
      const float xv = valid ? x[s] : 0.f;
      wc = xv * cs;
      ws = xv * sn;
    }
#pragma unroll
    for (int m = 0; m < NT; ++m) {
      ac[m] = fmaf(wc, R[j + m], ac[m]);
      as[m] = fmaf(ws, R[j + m], as[m]);
    }
  }
}

// Registers: up to 13 taps, 64 for real input (4 CTAs of 256 threads per
// SM) and 80 for I/Q input (3 CTAs per SM): an I/Q chain step holds both
// sample components and four products for the mix, and capped at 64 the
// 13-tap I/Q instantiation spilled (an 80-byte stack frame, 132 bytes of
// spill stores); 128 above 13 taps.
template <int NT, bool IQ>
__global__ void __launch_bounds__(kThreads, NT <= 13 ? (IQ ? 3 : 4) : 2)
band_taps_cluster_kernel(const ClusterArgs a) {
  constexpr int C = (NT - 1) / 2;            // corrn
  constexpr int F = IQ ? 2 : 1;              // floats per sample
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

  const long long w0 = a.wstart[b];
  const int n = min(a.nvalid[b], a.nwin);
  const bool act = a.active[b] != 0;
  const float f = a.ftot[b];
  const float r0 = a.rem[b];
  const bool inside = w0 >= 0 && w0 + (long long)max(n, 0) <= a.nblock;
  if (!act || !inside) {        // the same in every CTA of the cluster
    if (rank == 0) {
      if (act && tid == 0) *a.ok = 0;
      for (int t = tid; t < NV; t += blockDim.x) o[t] = 0.f;
    }
    return;
  }
  // arrive now, wait before writing to rank 0's shared memory: every CTA
  // of the cluster has then started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int d = a.d;
  const int seg = a.seg;
  const int seg0 = rank * seg;                     // first window sample
  const int lim = max(0, min(n - seg0, seg));      // valid samples here
  const int nrep = seg + 2 * C * d;                // replica bytes read
  const long long rfirst = (long long)b * a.next + seg0 + a.base;
  const float* blk = a.block + F * (w0 + seg0);    // the segment's samples

  float ac[NT], as[NT];                            // lag order m
#pragma unroll
  for (int m = 0; m < NT; ++m) {
    ac[m] = 0.f;
    as[m] = 0.f;
  }

  const int8_t* rep = reinterpret_cast<const int8_t*>(smem);
  rep += stage_async(smem, a.rc, a.rc_len, rfirst, nrep);
  cp_async_wait_all();
  __syncthreads();
  // chain u: tile k = u / d of kJ*d samples, residue u % d
  const int tile = kJ * d;
  for (int u = tid; u < seg / tile * d; u += blockDim.x) {
    const int k = u / d;
    const int s0 = k * tile + (u - k * d);
    if (s0 < lim)
      chain_taps<NT, IQ>(ac, as, rep + s0, blk + F * s0, d, lim - s0, f, r0,
                         (float)(seg0 + s0));
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

// The taps of one chain as chain_taps computes them, from carrier-mixed
// samples staged in shared memory (wc, ws at the chain's first sample,
// zero past the valid ones) instead of the block.
template <int NT>
__device__ __forceinline__ void chain_taps_mixed(float (&ac)[NT],
                                                 float (&as)[NT],
                                                 const int8_t* r,
                                                 const float* wc,
                                                 const float* ws, int d) {
  float R[kJ + NT - 1];
#pragma unroll
  for (int q = 0; q < kJ + NT - 1; ++q) R[q] = (float)r[q * d];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const float c = wc[j * d];
    const float s = ws[j * d];
#pragma unroll
    for (int m = 0; m < NT; ++m) {
      ac[m] = fmaf(c, R[j + m], ac[m]);
      as[m] = fmaf(s, R[j + m], as[m]);
    }
  }
}

// The cluster kernel for any odd ntaps > kMaxNarrow (the wide path in the
// header): the tap groups of kGroup lags loop inside the CTA.  Dynamic
// shared memory: the staged replica bytes, then (floats) the CTA's 2T
// sums in lag order, rank 0's gather of every rank's sums, and when
// STAGED the segment's mixed samples (cos, then sin).
template <bool IQ, bool STAGED>
__global__ void __launch_bounds__(kThreads, IQ ? 3 : 4)
band_taps_wide_kernel(const ClusterArgs a, int ntaps) {
  constexpr int G = kGroup;
  constexpr int F = IQ ? 2 : 1;              // floats per sample
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part[kWarps][32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int C = (ntaps - 1) / 2;             // corrn
  const int NV = 2 * ntaps;                  // sums per window
  float* row_out = a.out + (size_t)b * NV;

  const long long w0 = a.wstart[b];
  const int n = min(a.nvalid[b], a.nwin);
  const bool act = a.active[b] != 0;
  const float f = a.ftot[b];
  const float r0 = a.rem[b];
  const bool inside = w0 >= 0 && w0 + (long long)max(n, 0) <= a.nblock;
  if (!act || !inside) {        // the same in every CTA of the cluster
    if (rank == 0) {
      if (act && tid == 0) *a.ok = 0;
      for (int t = tid; t < NV; t += blockDim.x) row_out[t] = 0.f;
    }
    return;
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int d = a.d;
  const int seg = a.seg;
  const int seg0 = rank * seg;
  const int lim = max(0, min(n - seg0, seg));
  const int nrep = seg + 2 * C * d;
  const long long rfirst = (long long)b * a.next + seg0 + a.base;
  const float* blk = a.block + F * (w0 + seg0);
  float* sums = reinterpret_cast<float*>(smem + staged_bytes(nrep));
  float* gather = sums + NV;
  float* mc = gather + kCluster * NV;
  float* ms = mc + seg;

  const int8_t* rep = reinterpret_cast<const int8_t*>(smem);
  rep += stage_async(smem, a.rc, a.rc_len, rfirst, nrep);
  if (STAGED) {
    for (int i = tid; i < seg; i += blockDim.x) {
      float wc = 0.f, ws = 0.f;
      if (i < lim) {
        float sn, cs;
        carrier(f, (float)(seg0 + i), r0, &sn, &cs);
        if (IQ) {
          const float xr = blk[2 * i];
          const float xi = blk[2 * i + 1];
          wc = xr * cs - xi * sn;
          ws = xr * sn + xi * cs;
        } else {
          const float xv = blk[i];
          wc = xv * cs;
          ws = xv * sn;
        }
      }
      mc[i] = wc;
      ms[i] = ws;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int tile = kJ * d;
  const int nchain = seg / tile * d;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int m0 = 0; m0 < ntaps; m0 += G) {
    const int g0 = min(m0, ntaps - G);       // the group's first lag
    float ac[G], as[G];
#pragma unroll
    for (int m = 0; m < G; ++m) {
      ac[m] = 0.f;
      as[m] = 0.f;
    }
    for (int u = tid; u < nchain; u += blockDim.x) {
      const int k = u / d;
      const int s0 = k * tile + (u - k * d);
      if (s0 >= lim) continue;
      const int8_t* r = rep + s0 + g0 * d;
      if (STAGED)
        chain_taps_mixed<G>(ac, as, r, mc + s0, ms + s0, d);
      else
        chain_taps<G, IQ>(ac, as, r, blk + F * s0, d, lim - s0, f, r0,
                          (float)(seg0 + s0));
    }
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = 0.f;
#pragma unroll
    for (int m = 0; m < G; ++m) {
      v[2 * m] = ac[m];
      v[2 * m + 1] = as[m];
    }
    fold<16>(v, lane);
    part[warp][lane] = v[0];
    __syncthreads();
    if (tid < 2 * G) {
      float x = 0.f;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) x += part[w][tid];
      sums[2 * g0 + tid] = x;
    }
    __syncthreads();                         // part is the next group's
  }

  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* to = cluster.map_shared_rank(gather, 0) + rank * NV;
  for (int t = tid; t < NV; t += blockDim.x) to[t] = sums[t];
  cluster.sync();
  if (rank == 0) {
    for (int t = tid; t < NV; t += blockDim.x) {
      float x = 0.f;
      for (int r = 0; r < kCluster; ++r) x += gather[r * NV + t];
      row_out[2 * slot_of(t >> 1, C) + (t & 1)] = x;
    }
  }
}

int ceil_div(int x, int y) { return (x + y - 1) / y; }

template <int NT, bool IQ>
cudaError_t launch_v1(const float* block, long long nblock, const int8_t* rc,
                      int next, int nwin, const int* wstart,
                      const int* nvalid, const float* rem, const float* ftot,
                      const uint8_t* active, const int* offsets, int smax,
                      int nwindows, float* out, int* ok,
                      cudaStream_t stream) {
  static size_t opted = 0;            // this instantiation's opt-in
  return launch_kernel(band_taps_v1_kernel<NT, IQ>, opted,
                       dim3((unsigned)nwindows), dim3(kThreads),
                       (size_t)next, 0, stream, block, nblock, rc, next,
                       nwin, wstart, nvalid, rem, ftot, active, offsets,
                       smax, out, ok);
}

template <int NT, bool IQ>
cudaError_t launch_cluster(ClusterArgs a, int nwindows, cudaStream_t stream) {
  constexpr int C = (NT - 1) / 2;
  const int tile = kJ * a.d;
  a.seg = ceil_div(ceil_div(a.nwin, kCluster), tile) * tile;
  const int nrep = a.seg + 2 * C * a.d;
  // one chain of kJ samples per thread where the segment allows
  const int want = ceil_div(a.seg / tile * a.d, 32) * 32;
  const int threads = want < kThreads ? want : kThreads;
  const size_t shm = staged_bytes(nrep);
  static size_t opted = 0;            // this instantiation's opt-in
  return launch_kernel(band_taps_cluster_kernel<NT, IQ>, opted,
                       dim3((unsigned)(nwindows * kCluster)),
                       dim3((unsigned)threads), shm, kCluster, stream, a);
}

template <bool IQ>
cudaError_t launch_v1_wide(const float* block, long long nblock,
                           const int8_t* rc, int next, int nwin,
                           const int* wstart, const int* nvalid,
                           const float* rem, const float* ftot,
                           const uint8_t* active, const int* offsets,
                           int ntaps, int smax, int nwindows, float* out,
                           int* ok, cudaStream_t stream) {
  static size_t opted = 0;            // this instantiation's opt-in
  return launch_kernel(band_taps_v1_wide_kernel<IQ>, opted,
                       dim3((unsigned)nwindows), dim3(kThreads),
                       (size_t)next, 0, stream, block, nblock, rc, next,
                       nwin, wstart, nvalid, rem, ftot, active, offsets,
                       ntaps, smax, out, ok);
}

template <bool IQ>
cudaError_t launch_wide(ClusterArgs a, int ntaps, int nwindows,
                        cudaStream_t stream) {
  const int tile = kJ * a.d;
  a.seg = ceil_div(ceil_div(a.nwin, kCluster), tile) * tile;
  const int nrep = a.seg + (ntaps - 1) * a.d;
  const int want = ceil_div(a.seg / tile * a.d, 32) * 32;
  const int threads = want < kThreads ? want : kThreads;
  const size_t shm = staged_bytes(nrep) +
                     sizeof(float) * (size_t)2 * ntaps * (1 + kCluster);
  const size_t mixed = sizeof(float) * 2 * (size_t)a.seg;
  // the mixed samples staged where the card's shared memory holds them,
  // else recomputed per group; a segment whose replica bytes pass it is
  // refused by the opt-in (cudaErrorInvalidValue), as the narrow kernel's.
  // The room is asked once per process (the port's cards are alike), so
  // a launch captured in a CUDA graph after its warm-up asks nothing.
  static size_t room = 0;
  if (room == 0) room = max_dynamic_shm(band_taps_wide_kernel<IQ, true>);
  const bool staged = shm + mixed <= room;
  static size_t opted[2] = {0, 0};    // each instantiation's opt-in
  if (staged)
    return launch_kernel(band_taps_wide_kernel<IQ, true>, opted[1],
                         dim3((unsigned)(nwindows * kCluster)),
                         dim3((unsigned)threads), shm + mixed, kCluster,
                         stream, a, ntaps);
  return launch_kernel(band_taps_wide_kernel<IQ, false>, opted[0],
                       dim3((unsigned)(nwindows * kCluster)),
                       dim3((unsigned)threads), shm, kCluster, stream, a,
                       ntaps);
}

}  // namespace

#define TAP_CASES(X) X(1) X(3) X(5) X(7) X(9) X(11) X(13) X(15) X(17) \
                     X(19) X(21) X(23) X(25)

// Plain C interface for ctypes.  Every pointer is a device pointer; the
// stream is the caller's current CUDA stream.  Each returns the cudaError_t
// of the launch (0 on success); arguments it does not take return
// cudaErrorInvalidValue without launching.

// The cluster kernel for offsets tap_offsets((ntaps - 1) / 2, d): ntaps in
// {1, 3, ..., 25} by its instantiations, any larger odd ntaps by the wide
// kernel.
extern "C" int band_taps_launch(const void* block, long long nblock, int iq,
                                const void* rc, int next, int nwin,
                                const void* wstart, const void* nvalid,
                                const void* rem, const void* ftot,
                                const void* active, int ntaps, int smax,
                                int d, int nwindows, void* out, void* ok,
                                void* stream) {
  if (nwindows <= 0) return (int)cudaSuccess;
  const int base = smax - (ntaps - 1) / 2 * d;
  if (d < 1 || base < 0) return (int)cudaErrorInvalidValue;
  ClusterArgs a = {};
  a.block = static_cast<const float*>(block);
  a.nblock = nblock;
  a.rc = static_cast<const int8_t*>(rc);
  a.rc_len = (long long)nwindows * next;
  a.next = next;
  a.nwin = nwin;
  a.wstart = static_cast<const int*>(wstart);
  a.nvalid = static_cast<const int*>(nvalid);
  a.rem = static_cast<const float*>(rem);
  a.ftot = static_cast<const float*>(ftot);
  a.active = static_cast<const uint8_t*>(active);
  a.d = d;
  a.base = base;
  a.out = static_cast<float*>(out);
  a.ok = static_cast<int*>(ok);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CLUSTER_CASE(NT)                                         \
  case NT:                                                       \
    return iq ? launch_cluster<NT, true>(a, nwindows, st)        \
              : launch_cluster<NT, false>(a, nwindows, st);
  switch (ntaps) {
    TAP_CASES(CLUSTER_CASE)
    default:
      if (ntaps <= kMaxNarrow || ntaps % 2 == 0)
        return (int)cudaErrorInvalidValue;
      return iq ? launch_wide<true>(a, ntaps, nwindows, st)
                : launch_wide<false>(a, ntaps, nwindows, st);
  }
#undef CLUSTER_CASE
}

// The v1 kernel, for any offsets (a device array of ntaps ints; more than
// kMaxNarrow of them go to the v1 wide kernel).
extern "C" int band_taps_v1_launch(const void* block, long long nblock,
                                   int iq, const void* rc, int next,
                                   int nwin, const void* wstart,
                                   const void* nvalid, const void* rem,
                                   const void* ftot, const void* active,
                                   const void* offsets, int ntaps, int smax,
                                   int nwindows, void* out, void* ok,
                                   void* stream) {
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
#define V1_CASE(NT)                                                         \
  case NT:                                                                  \
    return iq ? launch_v1<NT, true>(x, nblock, r, next, nwin, ws, nv, rm,   \
                                    ft, ac, of, smax, nwindows, y, okp, st) \
              : launch_v1<NT, false>(x, nblock, r, next, nwin, ws, nv, rm,  \
                                     ft, ac, of, smax, nwindows, y, okp, st);
  switch (ntaps) {
    TAP_CASES(V1_CASE)
    default:
      if (ntaps <= kMaxNarrow || ntaps % 2 == 0)
        return (int)cudaErrorInvalidValue;
      return iq ? launch_v1_wide<true>(x, nblock, r, next, nwin, ws, nv, rm,
                                       ft, ac, of, ntaps, smax, nwindows, y,
                                       okp, st)
                : launch_v1_wide<false>(x, nblock, r, next, nwin, ws, nv, rm,
                                        ft, ac, of, ntaps, smax, nwindows, y,
                                        okp, st);
  }
#undef V1_CASE
}

// Samples per thread and CTAs per window of the cluster kernel (for the
// caller's records).
extern "C" int band_taps_samples_per_thread() { return kJ; }
extern "C" int band_taps_ctas_per_window() { return kCluster; }

extern "C" const char* band_taps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
