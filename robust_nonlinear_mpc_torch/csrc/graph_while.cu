// WHILE nodes in a CUDA graph under capture: the device-side exit of the
// port's masked loops, for NVIDIA Hopper (sm_90a). Bound to PyTorch through
// a plain C interface (ctypes) by robust_nonlinear_mpc_torch/ops/graph_while.py;
// robust_nonlinear_mpc_torch/utils/graph_loop.py (`device_while`) drives it.
//
// What it replaces: no Pallas kernel. It is the counterpart of the test of
// `lax.while_loop`'s condition inside a jitted program of the JAX package
// (robust_nonlinear_mpc_tpu/ops/qp_ipm.py `solve_qp`'s two loops, and the
// SQP, soft NLP, fast-SLS and SCP loops): a conditional node of type
// cudaGraphCondTypeWhile replays its body graph on the device while its
// handle holds 1, and `set_while_condition` sets the handle from a device
// bool that the loop's condition wrote, before the first body and at the
// end of every body. The host reads nothing.
//
// Design. `rnm_while_begin` is called while the current stream captures a
// graph: it creates the handle, captures the test before the first body,
// adds the conditional node after the stream's capture dependencies, makes
// the node the stream's only dependency, and starts capturing the node's
// body graph on a second stream (the body's kernels, the Newton kernels
// included, are then captured there). `rnm_while_end` captures the test
// after the body and ends the body's capture. The test also enforces a
// host-known cap on the body runs of one launch of the node, so a condition
// that never turns false (a NaN lane) cannot spin, and counts the body runs
// of every launch (`runs`: [runs in this launch, runs since the counter was
// zeroed]), which the launch accounting reads.
//
// Bound: latency. One thread, a few bytes and one call into the graph
// runtime per body run; it adds one kernel node per body and one before it.

#include <cuda_runtime.h>

namespace {

__global__ void set_while_condition(cudaGraphConditionalHandle handle, const bool* flag,
                                    long long* runs, long long cap, int after_body) {
  long long n = 0;
  if (after_body) {
    n = runs[0] + 1;
    runs[0] = n;
    runs[1] += 1;
  } else {
    runs[0] = 0;
  }
  cudaGraphSetConditional(handle, (*flag && n < cap) ? 1u : 0u);
}

// the capturing graph of `stream` and its current capture dependencies
cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, nullptr,
                                             n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorIllegalState;
}

}  // namespace

extern "C" {

// Begin a WHILE node in the graph that `stream` captures: the test of
// `flag` (capped by `cap` body runs) before the first body, the node, and
// the capture of its body on `body_stream`, which must not be capturing.
// Writes the node's handle to `handle_out`. Returns a cudaError_t.
int rnm_while_begin(const void* flag, void* runs, long long cap, void* stream,
                    void* body_stream, unsigned long long* handle_out) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_while_condition<<<1, 1, 0, s>>>(handle, (const bool*)flag, (long long*)runs, cap, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  err = cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream, params.conditional.phGraph_out[0],
                                      nullptr, nullptr, 0, cudaStreamCaptureModeGlobal);
  if (err != cudaSuccess) return err;
  *handle_out = handle;
  return cudaSuccess;
}

// End the body begun by `rnm_while_begin`: the test of `flag` after the
// body, then the end of the body's capture on `body_stream`.
int rnm_while_end(unsigned long long handle, const void* flag, void* runs, long long cap,
                  void* body_stream) {
  cudaStream_t b = (cudaStream_t)body_stream;
  set_while_condition<<<1, 1, 0, b>>>(handle, (const bool*)flag, (long long*)runs, cap, 1);
  cudaError_t err = cudaGetLastError();
  cudaGraph_t body;
  cudaError_t end = cudaStreamEndCapture(b, &body);
  return err != cudaSuccess ? err : end;
}

// A stream of its own for the bodies at one nesting depth (created once,
// never destroyed), and the kernel's module loaded, both outside a capture.
int rnm_while_stream(void** stream_out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, set_while_condition);
  if (err != cudaSuccess) return err;
  cudaStream_t s;
  err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err != cudaSuccess) return err;
  *stream_out = (void*)s;
  return cudaSuccess;
}

}  // extern "C"
