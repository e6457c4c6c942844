// Staging of device memory into shared memory by 16-byte asynchronous
// copies (cp.async), shared by csrc/window_taps.cu (K3-K5) and
// csrc/gram_taps.cu (K2).  The build (cuda_build.py) inlines this header
// into each source that includes it before hashing the source.
#include <cuda_runtime.h>
#include <stdint.h>

// Shared bytes that staging `count` bytes at any head needs.
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

// bytes [first, first + count) of src (len bytes) land at dst + head,
// head = (src + first) mod 16, by 16-byte cp.async copies from the 16-byte
// boundary at or below src + first, every one issued before any wait.  A
// copy that reaches past first + count or len is cut to the bytes in range
// (the rest of its 16 are zero); a vector that starts before src is copied
// byte by byte.  dst is 16-byte aligned and holds staged_bytes(count).
// Returns head; the caller waits (cp_async_wait_all) and synchronises.
__device__ __forceinline__ int stage_async(unsigned char* dst,
                                           const void* src, long long len,
                                           long long first, int count) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
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
