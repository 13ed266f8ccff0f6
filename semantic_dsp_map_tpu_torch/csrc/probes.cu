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
// What bounds the gather.  Its bound counts 4 B of index in and 4 B of value
// out per lookup, plus the table once, at the device-memory rate.  The TPU
// kernel holds the whole table in VMEM and streams the indices past it; on
// this card the 1.9 MB table of the probe sits in the 50 MB L2 (and the
// probe's 35 MB of inputs and output too, in a run of launches).  What
// limits it is the L2's rate of random sector reads: each 4 B table read
// moves a 32 B sector (134 MB for the probe's 4.2M lookups, 3.8x the bytes
// the bound counts).  Measured on an H100 (PERF.md, section 6): 0.037 ms with
// one lookup in flight a thread or eight, as fast as torch.index_select; the
// same lookups sorted take 0.011 ms, and random ones within the table's
// first 64 KB (which each SM's L1 holds) 0.013 ms.
//
// The design (what the streaming part of the work gains from): a persistent
// grid (as many blocks as fit on the SMs at once), each thread taking 8
// lookups an iteration: two 16 B index loads that are coalesced across the
// warp (lookups [4t, 4t+4) and [4B+4t, 4B+4t+4) of a block's 8B-lookup
// chunk), then eight independent table reads through the read-only path,
// all issued before the first store, then two 16 B stores.  The index loads
// and the stores carry the streaming hint (__ldcs, __stcs: evict first), so
// the read-once streams do not push the table out of L2.  With sorted
// indices this runs 1.3x as fast as one lookup a thread.  An index view
// that does not start on a 16 B boundary (rc[1:] of a whole tensor) takes
// scalar code up to the boundary; the last 0-3 lookups take scalar code
// too; and where the output does not sit at the same offset from a 16 B
// boundary as the index, the stores are scalar (still coalesced).  Indices
// outside [0, table size) are the caller's error and are not checked.  The
// L2 access-policy window (cudaStreamSetAttribute) is not used: it would
// change PyTorch's stream for every later kernel.
//
// Tried and dropped: the table in the distributed shared memory of a
// 16-block thread-block cluster (119,808 B a block, the card's nearest
// thing to the TPU kernel's table in VMEM), read through
// cluster.map_shared_rank.  Seven such clusters fit the card at once, one
// block an SM, and a random 4 B read of another SM's shared memory costs
// more than an L2 hit: 0.071 ms against this design's 0.038 (0.030 against
// 0.011 with the indices sorted).
//
// The scale2 probe at its shape ([8, 128] f32, 8 KB) is bound by nothing on
// the device: its time is the launch.  It measures what a ctypes-bound
// kernel's host path costs beside one PyTorch elementwise call, the
// per-launch cost that goes with the frame step's launch count.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

// Threads a block; a gather thread takes two quads of 4 lookups an iteration.
constexpr int BLOCK = 256;

template <bool kVectorOut>
__global__ void __launch_bounds__(BLOCK)
    gather_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                  float* __restrict__ out, long long n, long long head) {
  const long long tid = (long long)blockIdx.x * BLOCK + threadIdx.x;
  // The body: whole quads from idx + head, which is 16 B aligned.
  const long long quads = (n - head) / 4;
  const long long rest = head + quads * 4;
  // Scalar code for the 0-3 lookups before the body and the 0-3 after it.
  if (tid < head) out[tid] = __ldg(table + idx[tid]);
  if (tid < n - rest) out[rest + tid] = __ldg(table + idx[rest + tid]);

  const int4* idx4 = reinterpret_cast<const int4*>(idx + head);
  float* body = out + head;
  const long long step = (long long)gridDim.x * (BLOCK * 2);
  for (long long q = (long long)blockIdx.x * (BLOCK * 2) + threadIdx.x; q < quads;
       q += step) {
    const long long q2 = q + BLOCK;
    const bool two = q2 < quads;
    const int4 a = __ldcs(idx4 + q);
    const int4 b = two ? __ldcs(idx4 + q2) : make_int4(0, 0, 0, 0);
    float4 va, vb;
    va.x = __ldg(table + a.x);
    va.y = __ldg(table + a.y);
    va.z = __ldg(table + a.z);
    va.w = __ldg(table + a.w);
    if (two) {
      vb.x = __ldg(table + b.x);
      vb.y = __ldg(table + b.y);
      vb.z = __ldg(table + b.z);
      vb.w = __ldg(table + b.w);
    }
    if (kVectorOut) {
      float4* body4 = reinterpret_cast<float4*>(body);
      __stcs(body4 + q, va);
      if (two) __stcs(body4 + q2, vb);
    } else {
      float* o = body + 4 * q;
      __stcs(o, va.x);
      __stcs(o + 1, va.y);
      __stcs(o + 2, va.z);
      __stcs(o + 3, va.w);
      if (two) {
        o = body + 4 * q2;
        __stcs(o, vb.x);
        __stcs(o + 1, vb.y);
        __stcs(o + 2, vb.z);
        __stcs(o + 3, vb.w);
      }
    }
  }
}

__global__ void scale2_kernel(const float* __restrict__ x,
                              float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] * 2.0f;
}

// Blocks of one gather variant that fit on the card at once (its persistent
// grid), asked of the runtime once a process.
template <bool kVectorOut>
cudaError_t resident_blocks(long long* blocks) {
  static long long cached = 0;
  if (cached == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_kernel<kVectorOut>, BLOCK, 0);
    if (e != cudaSuccess) return e;
    cached = (long long)sms * per_sm;
  }
  *blocks = cached;
  return cudaSuccess;
}

template <bool kVectorOut>
int launch_gather(const float* table, const int* idx, float* out, long long n,
                  long long head, cudaStream_t stream) {
  long long blocks = 0;
  const cudaError_t e = resident_blocks<kVectorOut>(&blocks);
  if (e != cudaSuccess) return (int)e;
  const long long quads = (n - head) / 4;
  const long long needed = (quads + BLOCK * 2 - 1) / (BLOCK * 2);
  if (blocks > needed) blocks = needed;
  if (blocks < 1) blocks = 1;  // the head and tail alone
  static CUfunction fn = nullptr;
  return dsp::launch(gather_kernel<kVectorOut>, fn, (unsigned)blocks, BLOCK, 0,
                     stream, table, idx, out, n, head);
}

}  // namespace

extern "C" int dsp_gather(const float* table, const int* idx, float* out,
                          long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const uintptr_t ia = (uintptr_t)idx, oa = (uintptr_t)out;
  long long head = (long long)(((16 - (ia & 15)) & 15) / 4);
  if (head > n) head = n;
  const cudaStream_t s = (cudaStream_t)stream;
  // The stores are 16 B wide where the output lies at the index's offset
  // from a 16 B boundary.
  if (((ia ^ oa) & 15) == 0) return launch_gather<true>(table, idx, out, n, head, s);
  return launch_gather<false>(table, idx, out, n, head, s);
}

extern "C" int dsp_scale2(const float* x, float* out, long long n,
                          void* stream) {
  if (n < 0 || (n + BLOCK - 1) / BLOCK > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  static CUfunction fn = nullptr;
  return dsp::launch(scale2_kernel, fn, (unsigned)((n + BLOCK - 1) / BLOCK),
                     BLOCK, 0, (cudaStream_t)stream, x, out, n);
}
