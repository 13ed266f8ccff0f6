// A conditional IF node in a CUDA graph under stream capture, plain C
// interface: the counterpart of XLA's conditional (lax.cond) for the
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
