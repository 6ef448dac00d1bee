// The tracer's on-card stamp (smore_tpu_torch/utils/profiling.py).
//
// One thread reads the card's nanosecond clock (%globaltimer) when the
// stream reaches it, takes the next slot of a device ring through an atomic
// cursor and writes (code, time) there. Launched eagerly it stamps that
// point of the stream; launched under stream capture it is a node of the
// CUDA graph, so every replay writes its own stamp and nothing on the host
// waits. A stamp past the ring's capacity writes nothing: the cursor still
// counts it, so the host reads how many were dropped.

#include <cuda_runtime.h>
#include <stdint.h>

#include "graph_nodes.cuh"

namespace {

__global__ void trace_stamp_kernel(long long* __restrict__ ring,
                                   unsigned long long* __restrict__ cursor,
                                   int capacity, int code) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long slot = atomicAdd(cursor, 1ULL);
  if (slot < (unsigned long long)capacity) {
    ring[2 * slot] = (long long)code;
    ring[2 * slot + 1] = (long long)t;
  }
}

}  // namespace

extern "C" {

KERNEL_LIBRARY_EXPORTS(trace_stamp, trace_stamp_kernel)

// ring (capacity, 2) int64: (code, ns) records; cursor: one uint64, the
// stamps taken so far. Returns the launch's cudaError_t.
int trace_stamp_launch(int device, long long* ring,
                       unsigned long long* cursor, int capacity, int code,
                       void* stream_handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  trace_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream_handle>>>(
      ring, cursor, capacity, code);
  return (int)cudaGetLastError();
}

}  // extern "C"
