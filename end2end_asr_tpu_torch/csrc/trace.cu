// Device stamps of the port's tracer (utils/profiling.py), and the node
// counts of a CUDA graph while it is captured.
//
// Replaces no TPU kernel: the JAX package times its steps with
// jax.profiler alone. Added because a CUDA graph of K train steps is one
// launch to the host and to the profiler's host ranges, so nothing outside
// the graph can say which part of a step holds its device time.
//
//   trace_stamp: one thread reads %globaltimer (nanoseconds, one clock for
//   every SM) and writes (index << 16 | stamp id, time) at slot
//   index & mask of a ring in device memory, the index taken from an atomic
//   cursor. Launched on the caller's stream it runs after the work queued
//   before it and before the work queued after it; captured into a graph
//   it is a node of the graph, so every replay appends its own entry. Bound
//   by its launch (two 8-byte stores and one atomic); ~1-2 us of the card.
//
//   trace_capture_nodes: the kernel, memcpy, memset and other nodes of the
//   graph that `stream` is capturing now (cudaStreamGetCaptureInfo, then
//   cudaGraphGetNodes and cudaGraphNodeGetType; querying a graph under
//   capture is allowed). trace_graph_nodes: the same of a finished graph.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>

namespace {

__global__ void trace_stamp_kernel(unsigned long long* __restrict__ ring,
                                   unsigned long long* __restrict__ cursor,
                                   unsigned long long mask,
                                   unsigned long long id) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long i = atomicAdd(cursor, 1ULL);
  ring[2 * (i & mask)] = (i << 16) | id;
  ring[2 * (i & mask) + 1] = t;
}

// out[0..3]: kernel, memcpy, memset and other nodes of `graph`
cudaError_t count_nodes(cudaGraph_t graph, long* out) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return err;
  for (int k = 0; k < 4; ++k) out[k] = 0;
  if (n == 0) return cudaSuccess;
  cudaGraphNode_t* nodes =
      static_cast<cudaGraphNode_t*>(malloc(n * sizeof(cudaGraphNode_t)));
  if (nodes == nullptr) return cudaErrorMemoryAllocation;
  err = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) break;
    out[type == cudaGraphNodeTypeKernel   ? 0
        : type == cudaGraphNodeTypeMemcpy ? 1
        : type == cudaGraphNodeTypeMemset ? 2
                                          : 3] += 1;
  }
  free(nodes);
  return err;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int trace_stamp(void* ring, void* cursor, unsigned long long mask,
                           unsigned long long id, void* stream) {
  trace_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(ring),
      static_cast<unsigned long long*>(cursor), mask, id);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trace_capture_nodes(void* stream, long* out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, nullptr, &graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive || graph == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);  // not capturing
  return static_cast<int>(count_nodes(graph, out));
}

extern "C" int trace_graph_nodes(void* graph, long* out) {
  return static_cast<int>(count_nodes(static_cast<cudaGraph_t>(graph), out));
}
