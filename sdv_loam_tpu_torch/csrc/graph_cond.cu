// Conditional nodes (IF and WHILE) inside a CUDA graph under stream capture.
//
// The JAX package runs each stage as one compiled program whose
// `lax.while_loop`s and `lax.cond`s are decided on the device. The port
// captures a stage as one CUDA graph (utils/device_loop.program): a cond's
// body goes into an IF node, and a loop's later chunks into a WHILE node
// whose body is one chunk; a one-thread kernel copies the node's condition
// from a device bool just before the node (and, for a WHILE node, again at
// the end of each pass of its body), so the graph decides on the device
// whether and how often a body runs, with no host read.
//
// sdv_cond_begin(parent, body, flag, loop, handle_out): `parent` is a
// stream capturing into a graph. Appends to that graph (after the parent's
// current capture dependencies) the setter kernel, reading *flag, and an
// IF node (loop = 0) or a WHILE node (loop = 1) after it; makes the node
// the parent's only dependency; starts capturing `body` (a stream not
// capturing) into the node's body graph; and returns the node's
// conditional handle. sdv_cond_set(stream, handle, flag) captures the
// setter on `stream` (a WHILE body's last work: whether to pass again).
// sdv_cond_end(body, nodes) ends the body's capture and returns the number
// of nodes in the body graph. Nesting: `body` may itself be the parent of a
// further node.
//
// Needs CUDA 12.4 or later (conditional nodes with kernel, memcpy, memset
// and nested conditional nodes in their bodies). Returns the cudaError_t of
// the first call that failed, 0 on success.

#include <cuda_runtime.h>

__global__ void sdv_set_cond(cudaGraphConditionalHandle handle,
                             const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

extern "C" int sdv_cond_set(void* stream, unsigned long long handle,
                            const void* flag) {
  sdv_set_cond<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle),
      static_cast<const bool*>(flag));
  return cudaGetLastError();
}

extern "C" int sdv_cond_begin(void* parent_stream, void* body_stream,
                              const void* flag, int loop,
                              unsigned long long* handle_out) {
  cudaStream_t parent = static_cast<cudaStream_t>(parent_stream);
  cudaStream_t body = static_cast<cudaStream_t>(body_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(parent, &status, nullptr,
                                             &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  err = static_cast<cudaError_t>(sdv_cond_set(parent_stream, handle, flag));
  if (err != cudaSuccess) return err;
  err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = loop ? cudaGraphCondTypeWhile
                                 : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(parent, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  *handle_out = static_cast<unsigned long long>(handle);
  return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

extern "C" int sdv_cond_end(void* body_stream, unsigned long long* nodes) {
  cudaGraph_t graph = nullptr;
  cudaError_t err =
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &graph);
  if (err != cudaSuccess) return err;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  *nodes = n;
  return err;
}

// The nodes the graph `stream` is capturing into holds so far (a nested
// conditional node counts as one: sdv_cond_end counts its body).
extern "C" int sdv_capture_nodes(void* stream, unsigned long long* nodes) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, nullptr, &graph, nullptr,
      nullptr);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  *nodes = n;
  return err;
}
