// The window cluster kernel's body, shared by csrc/window_taps.cu (K3-K5)
// and csrc/ablation_taps.cu (K6, which ablates it).  The build
// (cuda_build.py) inlines this header into each source that includes it
// before hashing the source; it includes no other csrc/ header, so a source
// includes stage_async.cuh and launch.cuh before it.
//
// For every window b (already fetched out of the sample block):
//
//   ph_b(i)  = frac(frac(ftot_b * i) + rem_b)
//   cos_m[b] = sum_{i < n_b} w_b[i] * cos(2*pi*ph_b(i)) * r_b[i + base + m*d]
//   sin_m[b] = the same with sin; I/Q windows mix (wr + j wi) e^{+j 2 pi ph}
//
// for the NT lags base + m*d, m < NT: the taps' lags must form that
// progression (the callers route any others to their v1 kernels).  The
// design, in the build steps tools/profile_window.py times:
//
// 1. Reuse each replica value across the taps.  A thread takes a chain of
//    kJ samples s0 + j*d and holds R[q] = r[s0 + base + q*d],
//    q < kJ + 2*C (C = (NT - 1) / 2), in registers, converted to f32 once:
//    tap m of chain step j is R[j + m], (kJ + 2*C)/kJ = 1.36 shared loads
//    and conversions per sample at 13 taps instead of 13.  Threads cover
//    the d residues of tiles of kJ*d samples; with kJ = 33, (kJ - 1)*d is a
//    multiple of 32, so chain starts are distinct mod 32 and a warp's
//    stride-d reads of 4-byte values hit 32 banks for any d.  Alone (one
//    CTA per window, staged one value per thread) this step is slower
//    than a block per window reading every tap from shared memory: the
//    staging, unhidden, then holds every chain back.
// 2. Stage with asynchronous copies.  The segment's replica values and
//    its window samples are copied global -> shared by 16-byte cp.async
//    (stage_async.cuh), all issued before one wait, so each CTA has its
//    whole segment's bytes in flight at once.  Copies start at the 16-byte
//    boundary below the first byte: K3's int8 rows start every 16412 bytes
//    (4-byte aligned only) and a segment starts anywhere in its row; a copy
//    that reaches past the bytes asked for (or the last row) is cut to
//    those bytes.  This step moved most.  Staging the window too beat
//    reading it through L1 for K3 and for f32 I/Q windows (by up to 30%).
// 3. Fill the card.  Each window is split into S = kCluster segments, one
//    CTA each, and the S CTAs of a window run as one thread-block cluster.
//    Each CTA reduces its 2*NT sums in shared memory (a warp butterfly,
//    then the warps in order); every rank writes them into rank 0's shared
//    memory through distributed shared memory, and after one cluster
//    barrier rank 0 adds them in rank order and writes the row.  One
//    launch, no scratch buffer, no atomics: the output is bit-identical
//    from launch to launch.  Whether a window has work (n > 0) is decided
//    per window, before the first cluster barrier, so every CTA of a
//    cluster takes the same early return or reaches every barrier.  S = 2
//    was the fastest of 1, 2 and 4.
// 4. Carrier.  sincospif(2*ph) in place of sincosf(f32(2*pi) * ph): no
//    Payne-Hanek reduction, no rounding of the angle; about a fifth of the
//    kernel's time is still the carrier.
//
// Three template parameters serve K6 and keep K3-K5's code: N, the type of
// the valid bound (int for K3-K5; float for K6, whose mask is i < n),
// POLY, K6's nosin carrier (1 - ph^2, ph) in the carrier's place, and MAP,
// K6's output columns (column pair j takes the sums of lag a.src[j], a
// device array; K3-K5 write tap_offsets order).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Samples i < n count: an int bound directly, a float bound (K6) as
// ceil(n), both at most nwin (n <= 0: none).
__device__ __forceinline__ int valid_count(int n, int nwin) {
  return min(n, nwin);
}
__device__ __forceinline__ int valid_count(float n, int nwin) {
  return (int)ceilf(fminf(fmaxf(n, 0.f), (float)nwin));
}

int ceil_div(int x, int y) { return (x + y - 1) / y; }

struct ClusterArgs {
  const void* win;
  long long win_bytes;           // bytes in win (B * nwin * F * sizeof(W))
  int nwin;
  const void* rc;
  long long rc_bytes;            // bytes in rc (B * next * sizeof(R))
  int next;
  const float* rem;
  const float* ftot;
  const void* nvalid;            // (B,) N: the valid bound of each window
  int d;                         // the lags' step
  int base;                      // the lag of tap m (lag order) is base + m*d
  int seg;                       // samples per CTA, a multiple of kJ * d
  float* out;
  int nout;                      // MAP: output column pairs (taps)
  const int* src;                // MAP: (nout,) the lag column pair j takes
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

// K6's nosin carrier in the carrier's place: cos -> 1 - ph^2, sin -> ph.
// No argument reduction takes the outer frac here, so it is computed, and
// every product is rounded where the plain version rounds it.
__device__ __forceinline__ void carrier_poly(float f, float fi, float r0,
                                             float* sn, float* cs) {
  const float ph = frac_f(frac_f(__fmul_rn(f, fi)) + r0);
  *cs = __fsub_rn(1.f, __fmul_rn(ph, ph));
  *sn = ph;
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
template <int NT, bool IQ, bool BF16, bool POLY, typename W, typename R>
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
    const float fi = fmaf((float)j, fd, fi0);
    if constexpr (POLY)
      carrier_poly(f, fi, r0, &sn, &cs);
    else
      carrier(f, fi, r0, &sn, &cs);
    float wc, ws;
    mix<IQ, BF16>(x, s, s < left, sn, cs, wc, ws);
#pragma unroll
    for (int m = 0; m < NT; ++m) {
      ac[m] = fmaf(wc, Rv[j + m], ac[m]);
      as[m] = fmaf(ws, Rv[j + m], as[m]);
    }
  }
}

// The body of a cluster kernel entry: one CTA of window blockIdx.x / S,
// rank blockIdx.x % S in its cluster (steps 1-4 above).  Each entry is a
// __global__ that calls it, so that ptxas reports each under its name.
template <int NT, bool IQ, typename W, typename R, bool BF16,
          typename N = int, bool POLY = false, bool MAP = false>
__device__ __forceinline__ void window_cluster_body(const ClusterArgs a) {
  constexpr int C = (NT - 1) / 2;            // taps each side of the middle
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
  const int width = MAP ? 2 * a.nout : NV;   // output columns
  float* o = a.out + (size_t)b * width;

  const int n = valid_count(static_cast<const N*>(a.nvalid)[b], a.nwin);
  const float f = a.ftot[b];
  const float r0 = a.rem[b];
  if (n <= 0) {                 // the same in every CTA of the cluster
    if (rank == 0)
      for (int t = tid; t < width; t += blockDim.x) o[t] = 0.f;
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
        chain_taps<NT, IQ, BF16, POLY>(ac, as, rep + s0, x + F * s0, d,
                                       lim - s0, f, r0, (float)(seg0 + s0));
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
    if constexpr (MAP) {
      // column t: sum (t & 1) of the lag its pair takes.  The map is a
      // device array: indexing an array in the arguments at run time
      // copies the whole argument block to local memory in every thread
      for (int t = tid; t < width; t += blockDim.x) {
        const int k = 2 * a.src[t >> 1] + (t & 1);
        float x = 0.f;
        for (int r = 0; r < kCluster; ++r) x += gather[r][k];
        o[t] = x;
      }
    } else {
      for (int t = tid; t < NV; t += blockDim.x) {
        float x = 0.f;
        for (int r = 0; r < kCluster; ++r) x += gather[r][t];
        o[2 * slot_of(t >> 1, C) + (t & 1)] = x;
      }
    }
  }
}

// Launch a cluster kernel entry `kernel` (running window_cluster_body<NT,
// IQ, W, R, ...>) over `nwindows` windows: S CTAs per window, each taking
// a segment of whole tiles, one chain of kJ samples per thread where the
// segment allows; `opted` as launch_kernel takes it.
template <int NT, bool IQ, typename W, typename R>
cudaError_t launch_cluster(void (*kernel)(ClusterArgs), size_t& opted,
                           ClusterArgs a, int nwindows, cudaStream_t stream) {
  constexpr int C = (NT - 1) / 2;
  constexpr int F = IQ ? 2 : 1;
  const int tile = kJ * a.d;
  a.seg = ceil_div(ceil_div(a.nwin, kCluster), tile) * tile;
  const int nrep = a.seg + 2 * C * a.d;
  const int want = ceil_div(a.seg / tile * a.d, 32) * 32;
  const int threads = want < kThreads ? want : kThreads;
  size_t shm = staged_bytes(nrep * (int)sizeof(R));
  shm += staged_bytes(a.seg * F * (int)sizeof(W));
  return launch_kernel(kernel, opted, dim3((unsigned)(nwindows * kCluster)),
                       dim3((unsigned)threads), shm, kCluster, stream, a);
}

}  // namespace
