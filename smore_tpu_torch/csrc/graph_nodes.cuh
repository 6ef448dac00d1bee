// The kernel nodes of a CUDA graph that launch one of a library's kernels,
// and the exports every kernel library has (KERNEL_LIBRARY_EXPORTS).
//
// A launch recorded under stream capture runs no host code when the graph
// is replayed, so the launch counters (smore_tpu_torch/ops/launches.py)
// cannot count replays. Each library exports <name>_graph_launches, which
// reads the captured graph and counts the nodes that launch its own
// kernels; the driver credits that count on every replay. The query goes
// through this library's own CUDA runtime (each library links it
// statically), which maps a node it launched back to the kernel's entry
// point; a node of another library is not one of ours, whatever the query
// answers for it.

#pragma once

#include <cuda_runtime.h>

#include <vector>

namespace graph_nodes {

// Nodes of `graph` that launch one of the n `kernels` (entry points), in
// *count. Returns the first error of the graph's queries.
inline cudaError_t count(cudaGraph_t graph, const void* const* kernels, int n,
                         long long* count) {
  *count = 0;
  size_t num = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &num);
  if (err != cudaSuccess || num == 0) return err;
  std::vector<cudaGraphNode_t> nodes(num);
  err = cudaGraphGetNodes(graph, nodes.data(), &num);
  if (err != cudaSuccess) return err;
  // the runtime hands back the entry point, or the function's handle where
  // it does not map it back: either identifies our kernel
  std::vector<cudaFunction_t> handles(n);
  for (int k = 0; k < n; ++k) {
    err = cudaGetFuncBySymbol(&handles[k], kernels[k]);
    if (err != cudaSuccess) return err;
  }
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(node, &type);
    if (err != cudaSuccess) return err;
    if (type != cudaGraphNodeTypeKernel) continue;
    cudaKernelNodeParams kp = {};
    if (cudaGraphKernelNodeGetParams(node, &kp) != cudaSuccess) {
      cudaGetLastError();  // a kernel this runtime did not register
      continue;
    }
    for (int k = 0; k < n; ++k) {
      if (kp.func == kernels[k] || kp.func == (void*)handles[k]) {
        ++*count;
        break;
      }
    }
  }
  return cudaSuccess;
}

// count() of the given kernels (entry points or their handles, any type).
template <typename... Kernels>
inline cudaError_t count_of(cudaGraph_t graph, long long* n,
                            Kernels... kernels) {
  const void* k[] = {(const void*)kernels...};
  return count(graph, k, (int)sizeof...(Kernels), n);
}

}  // namespace graph_nodes

// Inside a library's extern "C" block: <name>_error_string, the message of a
// cudaError_t its calls return, and <name>_graph_launches, the nodes of a
// captured graph that launch one of its kernels (the entry points listed
// after the name), in *count, returning a cudaError_t.
#define KERNEL_LIBRARY_EXPORTS(name, ...)                                \
  const char* name##_error_string(int code) {                            \
    return cudaGetErrorString((cudaError_t)code);                        \
  }                                                                      \
  int name##_graph_launches(void* graph, long long* count) {             \
    return (int)graph_nodes::count_of((cudaGraph_t)graph, count,         \
                                      __VA_ARGS__);                      \
  }
