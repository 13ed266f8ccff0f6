// What the captured step needs beside PyTorch's own calls, plain C
// interface: a conditional IF node in a CUDA graph under stream capture
// (below), and the frame tracer's stamp (at the end of the file).
//
// The IF node is the counterpart of XLA's conditional (lax.cond) for the
// template stages, whose slots run their sweep only where they have work.
// Called by step_graph.slot_cond.
//
// CUDA 12.3 and later give a graph conditional nodes; PyTorch 2.11 has no
// call for one.  dsp_if_node_begin does what a capture needs around such a
// node, on PyTorch's capture stream:
//   1. read the capture's graph and its current dependencies;
//   2. make a conditional handle in that graph;
//   3. capture a one-thread kernel that sets the handle from the device
//      flag `pred` (read at each replay, so the branch is decided on the
//      device);
//   4. add an IF node after it, and make the node the capture stream's
//      only dependency: what the stream captures next runs after the node;
//   5. start capturing the side stream `body` into the node's body graph.
// The caller then enqueues the branch's work on `body` and ends with
// dsp_if_node_end, which ends that capture.  A replay runs the body only
// where *pred is true.

#include <cuda.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

__global__ void set_if_condition(cudaGraphConditionalHandle handle,
                                 const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

CUfunction set_if_condition_fn = nullptr;

}  // namespace

// Loads the kernel of step 3 before any capture (a module load inside a
// capture is refused).
extern "C" int dsp_if_node_prepare() {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, set_if_condition);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetFuncBySymbol(&set_if_condition_fn,
                                  reinterpret_cast<const void*>(set_if_condition));
}

extern "C" int dsp_if_node_begin(void* capture_stream, const bool* pred,
                                 void* body_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(capture_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorIllegalState;

  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  int err = dsp::launch(set_if_condition, set_if_condition_fn, dim3(1), dim3(1), 0, s,
                        handle, pred);
  if (err) return err;

  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                            params.conditional.phGraph_out[0], nullptr,
                                            nullptr, 0, cudaStreamCaptureModeGlobal);
}

extern "C" int dsp_if_node_end(void* body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}

// The frame tracer's stamp (timing.Tracer, through timing.stamp_cuda): one
// thread writes the device's %globaltimer (ns) into column `column` of the
// current frame's row of the stamp ring, int64[capacity, stamp_width].
// Replaces no TPU kernel: it marks the stage boundaries of the captured
// step, inside the CUDA graphs, so that a replay records its stages' device
// times with no host involvement.  The frame's first stamp (`first`)
// advances the frame cursor (cursor[0] frames begun, cursor[1] the current
// row) and clears the row of both rings.  It also copies `n_counts` int64
// device scalars (the frame's StepDiagnostics at the last stamp, the
// template stages' counts at template birth's end) into the columns from
// `first_count` on of the row of the counter ring, int64[capacity,
// counter_width].
// Bound: one launch, a few dozen bytes; its cost is the launch.

namespace {

constexpr int MAX_COUNTS = 16;

struct Counts {
  const long long* p[MAX_COUNTS];
};

__global__ void stamp_kernel(long long* cursor, long long* stamps, long long* counters,
                             int capacity, int stamp_width, int counter_width, int column,
                             int first, int first_count, int n_counts, Counts counts) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (first) {
    const long long frame = cursor[0];
    cursor[0] = frame + 1;
    cursor[1] = frame % capacity;
    for (int c = 0; c < stamp_width; ++c) stamps[cursor[1] * stamp_width + c] = -1;
    for (int c = 0; c < counter_width; ++c) counters[cursor[1] * counter_width + c] = -1;
  }
  stamps[cursor[1] * stamp_width + column] = (long long)now;
  for (int i = 0; i < n_counts; ++i) {
    counters[cursor[1] * counter_width + first_count + i] = *counts.p[i];
  }
}

CUfunction stamp_fn = nullptr;

}  // namespace

// `counts`: a host array of `n_counts` device pointers (at most MAX_COUNTS).
extern "C" int dsp_stamp(void* cursor, void* stamps, void* counters, int capacity,
                         int stamp_width, int counter_width, int column, int first,
                         int first_count, int n_counts, const void* const* counts,
                         void* stream) {
  if (n_counts < 0 || n_counts > MAX_COUNTS || first_count < 0 ||
      first_count + n_counts > counter_width) {
    return (int)cudaErrorInvalidValue;
  }
  Counts c = {};
  for (int i = 0; i < n_counts; ++i) c.p[i] = static_cast<const long long*>(counts[i]);
  return dsp::launch(stamp_kernel, stamp_fn, dim3(1), dim3(1), 0,
                     static_cast<cudaStream_t>(stream), static_cast<long long*>(cursor),
                     static_cast<long long*>(stamps), static_cast<long long*>(counters),
                     capacity, stamp_width, counter_width, column, first, first_count,
                     n_counts, c);
}
