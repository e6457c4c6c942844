// One kernel launch with its dynamic shared memory opted in, shared by
// every csrc/*.cu.  The build (cuda_build.py) inlines this header into each
// source that includes it before hashing the source.
//
// A block's static shared memory counts against the 48 KB that a kernel
// may use without opting in, so a launch whose dynamic bytes fit in 48 KB
// can still be refused.  launch_kernel therefore opts each kernel in at
// its first launch whatever the size, and again only when a later launch
// needs more (so repeated launches, and graph capture after a warm-up, make
// no call).  It clears the error it returns, so that the next launch does
// not report it.
#include <cuda_runtime.h>

// Launch kernel<<<grid, block, shm, stream>>>(args...), as one thread-block
// cluster of `cluster` CTAs along x when cluster > 0.  `opted` holds the
// dynamic shared bytes this kernel is opted in to: one per kernel
// instantiation, a function-local static of its launching template,
// starting at 0.  Returns the cudaError_t of the opt-in or the launch
// (0 on success), with no error left set.
template <typename... Params, typename... Args>
cudaError_t launch_kernel(void (*kernel)(Params...), size_t& opted,
                          dim3 grid, dim3 block, size_t shm,
                          unsigned cluster, cudaStream_t stream,
                          Args... args) {
  if (shm > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
    opted = shm;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = shm;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (cluster > 0) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();    // and clears it
  return e != cudaSuccess ? e : last;
}

// The dynamic shared bytes `kernel` can opt in to on the current device:
// the card's per-block opt-in limit less the kernel's static shared
// memory (0, with no error left set, if the runtime cannot say).
template <typename... Params>
size_t max_dynamic_shm(void (*kernel)(Params...)) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&fa, kernel) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return (size_t)optin > fa.sharedSizeBytes ? (size_t)optin - fa.sharedSizeBytes
                                           : 0;
}
