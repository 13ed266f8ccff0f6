// The two primitive-op probe kernels for Hopper (sm_90a), plain C interface.
//
// dsp_gather replaces the TPU kernel gather_kernel (pallas_gather) of
// benchmarks/prim_bench7.py; dsp_scale2 replaces the TPU kernel k_ of
// benchmarks/prim_bench1.py.  Oracles: gather_plain / scale2_plain in
// semantic_dsp_map_tpu_torch/ops/probes.py.
//
//   gather:  out[i] = table[idx[i]]   (table = the depth image, flattened)
//   scale2:  out[i] = x[i] * 2.0f
//
// What bounds them.  The gather moves 4 B of index in and 4 B of value out
// per lookup, plus the table once: device memory.  The TPU kernel exists to
// hold the 1.9 MB table in VMEM and stream the indices past it in blocks; a
// block of this card has 227 KB of shared memory, so the table cannot sit
// there.  It does not have to: the 50 MB L2 holds it whole, and the random
// lookups go through the read-only path (__ldg) and hit L2 after the first
// touch.  The design is the simple one: one thread per lookup, grid-stride,
// neighbouring threads on neighbouring indices, so index loads and output
// stores are coalesced and only the table reads are scattered.  Indices
// outside [0, table size) are the caller's error and are not checked.
//
// The scale2 probe at its shape ([8, 128] f32, 8 KB) is bound by nothing on
// the device: its time is the launch.  It is the card's launch floor for a
// kernel bound with ctypes, the per-launch cost that goes with the frame
// step's launch count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
// Enough blocks to fill 132 SMs several times over; beyond that the
// grid-stride loop takes the rest.
constexpr long long MAX_BLOCKS = 132 * 16;

__global__ void gather_kernel(const float* __restrict__ table,
                              const int* __restrict__ idx,
                              float* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = __ldg(table + idx[i]);
  }
}

__global__ void scale2_kernel(const float* __restrict__ x,
                              float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] * 2.0f;
}

}  // namespace

extern "C" int dsp_gather(const float* table, const int* idx, float* out,
                          long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n + BLOCK - 1) / BLOCK;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  gather_kernel<<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      table, idx, out, n);
  return (int)cudaGetLastError();
}

extern "C" int dsp_scale2(const float* x, float* out, long long n,
                          void* stream) {
  if (n <= 0 || (n + BLOCK - 1) / BLOCK > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  scale2_kernel<<<(unsigned)((n + BLOCK - 1) / BLOCK), BLOCK, 0,
                  (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}
