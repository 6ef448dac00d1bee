// Cost of one cooperative_groups grid barrier of one 256-thread block per
// SM on a CUDA card, and whether 16-byte vector atomicAdd and grid.sync()
// build without -rdc (sm_90a):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v \
//        -o build/grid_sync_probe experiments/grid_sync_probe.cu
//   build/grid_sync_probe
//
// Times 10 cooperative launches of 100 barriers each with CUDA events and
// prints the time per barrier (µs) and the atomics' sums.
#include <cooperative_groups.h>
#include <cstdio>
namespace cg = cooperative_groups;
__global__ void k(float* x, int n) {
  cg::grid_group g = cg::this_grid();
  for (int it = 0; it < 100; ++it) {
    if (threadIdx.x == 0) atomicAdd(reinterpret_cast<float4*>(x), make_float4(1.f, 2.f, 3.f, 4.f));
    g.sync();
  }
}
int main() {
  float* x; cudaMalloc(&x, 16); cudaMemset(x, 0, 16);
  int dev = 0, sms = 0, occ = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, 256, 0);
  int n = 0; void* args[] = {&x, &n};
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaError_t e = cudaLaunchCooperativeKernel((void*)k, sms, 256, args, 0, 0);
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  for (int r = 0; r < 10; ++r) cudaLaunchCooperativeKernel((void*)k, sms, 256, args, 0, 0);
  cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b);
  float h[4]; cudaMemcpy(h, x, 16, cudaMemcpyDeviceToHost);
  printf("launch %s sms %d occ %d x %g %g %g %g; %.3f us per grid sync (132 blocks)\n", cudaGetErrorString(e), sms, occ, h[0], h[1], h[2], h[3], ms * 1000 / 1000);
  return 0;
}
