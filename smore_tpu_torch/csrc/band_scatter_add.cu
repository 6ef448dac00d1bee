// Band row scatter-add for Hopper (sm_90a).
//
// Replaces the TPU kernel smore_tpu/ops/pallas_scatter.py band_scatter_add
// (body _kernel): table[*start + idx[r]] += delta[r] for every row r of a
// (B, D) f32 delta, duplicate rows summed. The TPU kernel held the whole band
// in VMEM and added the rows one after another on the vector unit, in 2048-row
// tiles; here one warp takes one delta row and each lane adds D/32 of its
// columns with atomicAdd into the table in device memory (the band, 8.4 MB at
// 32776 x 64 f32, stays in the 50 MB L2). Atomics change only the order in
// which duplicates are summed.
//
// What bounds it on the H100: bytes. B delta rows read once (8.4 MB at
// B = 32768, D = 64), the distinct band rows read and written once by the
// L2's atomic units, and the indices; one add per element. The band start
// stays on the device, so the host never reads it back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 delta rows per block

__global__ void __launch_bounds__(kThreads) band_scatter_add_rows(
    float* __restrict__ table, const int* __restrict__ start,
    const int* __restrict__ idx, const float* __restrict__ delta, int B,
    int D) {
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= B) return;
  float* row = table + ((int64_t)(*start) + idx[r]) * D;
  const float* d = delta + (size_t)r * D;
  for (int c = lane; c < D; c += 32) atomicAdd(row + c, d[c]);
}

}  // namespace

extern "C" {

const char* band_scatter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// table (rows, D) f32; start: one int32 band START row; idx (B,) int32
// band-local rows; delta (B, D) f32. Returns the launch's cudaError_t.
int band_scatter_add_launch(int device, float* table, const int* start,
                            const int* idx, const float* delta, int B, int D,
                            void* stream_handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int rows_per_block = kThreads / 32;
  band_scatter_add_rows<<<(B + rows_per_block - 1) / rows_per_block, kThreads,
                          0, (cudaStream_t)stream_handle>>>(
      table, start, idx, delta, B, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
