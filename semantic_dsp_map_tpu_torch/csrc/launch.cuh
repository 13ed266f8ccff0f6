// How every kernel of this directory is launched: with cuLaunchKernel, each
// kernel's CUfunction looked up once.
//
// The runtime's <<<>>> looks the kernel up and checks the context on every
// launch; cuLaunchKernel on a cached CUfunction does neither.  With the
// library loaded as a ctypes.PyDLL this took the x2 probe's host path from
// 1.13-1.22x to 1.04-1.12x of torch.mul's on an H100 host (PERF.md, section 6).
// The cached CUfunction belongs to the context current at the first
// launch: one card a process, as every caller of this package runs (the
// sharded step runs a process a card).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace dsp {

// Keeps the launch arguments out of template deduction, so each converts
// to the kernel's parameter type.
template <typename T>
struct Same {
  using type = T;
};

// Launches `kernel` on `stream` with `args`.  `fn` is the call site's
// cache of the kernel's CUfunction (a static of the caller: one a kernel).
// Returns 0 or a CUDA error code (CUresult and cudaError_t agree on those
// a launch gives).
template <typename... P>
int launch(void (*kernel)(P...), CUfunction& fn, dim3 grid, dim3 block,
           unsigned smem, cudaStream_t stream, typename Same<P>::type... args) {
  if (fn == nullptr) {
    const cudaError_t e =
        cudaGetFuncBySymbol(&fn, reinterpret_cast<const void*>(kernel));
    if (e != cudaSuccess) return (int)e;
  }
  void* params[] = {&args...};
  return (int)cuLaunchKernel(fn, grid.x, grid.y, grid.z, block.x, block.y,
                             block.z, smem, reinterpret_cast<CUstream>(stream),
                             params, nullptr);
}

}  // namespace dsp
