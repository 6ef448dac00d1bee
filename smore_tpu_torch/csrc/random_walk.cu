// Batched random walks for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX walk (smore_tpu/sampling/walks.py
// random_walk) is a lax.scan over the steps, which the port ran as a Python
// loop of ~18 small torch ops a step (smore_tpu_torch/sampling/walks.py
// random_walk_ref, the plain twin). Here one launch takes every step: one
// thread a walk. Each step reads the step's two uniforms, the cursor's
// [indptr, degree] row of vert_meta and the drawn slot's row of the
// per-vertex context alias table ctx_pa, and picks the next vertex as
// SamplerTables._context_of does: the same float32 product, rounded to
// nearest and never contracted into an FMA, the same truncations, minima and
// clamps, the same restart rule. So the walks are bit-equal to the twin's
// given the same uniforms.
//
// What bounds it on the H100: latency. A step's two table reads depend on one
// another (the cursor's row gives the slot) and on the last step's vertex, so
// a walk is a chain of 2 x steps dependent loads (vert_meta in L2, ctx_pa in
// HBM on a Youtube-sized graph); the bytes, B x steps x 32 read and
// B x (steps + 1) x 4 written, are a few MB at most. The design keeps the
// chain bare: the next step's uniforms are loaded before this step's chain,
// the tables go through the read-only path, and a block's walks are staged in
// shared memory and written out coalesced as the (B, steps + 1) int32 result.

#include <cuda_runtime.h>
#include <stdint.h>

#include "graph_nodes.cuh"

namespace {

constexpr int kThreads = 64;  // walks per block
// walk entries a pass stages per walk: 64 x 63 x 4 B = 15.75 KB of shared
// memory at most; a walk of up to 62 steps is one pass
constexpr int kMaxCols = 63;

__global__ void __launch_bounds__(kThreads) random_walk_steps(
    const int* __restrict__ starts, const float2* __restrict__ u,
    const int2* __restrict__ vert_meta, const float4* __restrict__ ctx_pa,
    int* __restrict__ walk, float* __restrict__ row_mask, int B, int steps,
    int n_edges, int restart) {
  extern __shared__ int tile[];  // [kThreads][stride]
  const int L = steps + 1;
  const int cols = min(L, kMaxCols);
  const int stride = cols | 1;  // odd: a warp's column writes hit 32 banks
  const int b0 = blockIdx.x * kThreads;
  const int b = b0 + threadIdx.x;
  const bool live = b < B;
  const int rows = min(kThreads, B - b0);

  int start = 0;
  int2 meta0 = make_int2(0, 0);
  float2 next_u = make_float2(0.f, 0.f);
  if (live) {
    start = starts[b];
    meta0 = __ldg(vert_meta + start);
    row_mask[b] = meta0.y > 0 ? 1.0f : 0.0f;
    if (steps > 0) next_u = __ldg(u + b);
  }
  int cur = start;
  int t = 0;  // steps taken
  for (int c0 = 0; c0 < L; c0 += cols) {
    const int w = min(cols, L - c0);
    for (int j = 0; j < w; ++j) {
      if (live && c0 + j > 0) {
        const float2 uu = next_u;
        if (t + 1 < steps) next_u = __ldg(u + (size_t)(t + 1) * B + b);
        int2 m = __ldg(vert_meta + cur);
        if (restart && m.y == 0) {  // a dead end: back to the start
          cur = start;
          m = meta0;
        }
        if (m.y > 0) {  // a zero-degree cursor stays where it is
          const int r = (int)__fmul_rn(uu.x, (float)m.y);  // in [0, deg]
          const int slot = min(m.x + min(r, m.y - 1), n_edges - 1);
          const float4 row = __ldg(ctx_pa + slot);  // [prob, vid, alias, 0]
          cur = (int)(uu.y < row.x ? row.y : row.z);
        }
        ++t;
      }
      tile[threadIdx.x * stride + j] = cur;
    }
    __syncthreads();
    // rows b0.. of columns c0..c0+w-1; one contiguous span when w == L
    int* out = walk + (size_t)b0 * L + c0;
    for (int i = threadIdx.x; i < rows * w; i += kThreads) {
      const int r = i / w, c = i - r * w;
      out[(size_t)r * L + c] = tile[r * stride + c];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

KERNEL_LIBRARY_EXPORTS(random_walk, random_walk_steps)

// starts (B,) int32; u (steps, B, 2) f32; vert_meta (N, 2) int32
// [indptr, degree]; ctx_pa (n_edges, 4) f32 [prob, vid, alias_vid, 0];
// walk (B, steps + 1) int32 and row_mask (B,) f32 written. u, vert_meta and
// ctx_pa at 8-, 8- and 16-byte aligned addresses. restart != 0: a dead end
// sends the cursor back to the start. Returns the launch's cudaError_t.
int random_walk_launch(int device, const int* starts, const float* u,
                       const int* vert_meta, const float* ctx_pa, int* walk,
                       float* row_mask, int B, int steps, int n_edges,
                       int restart, void* stream_handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int cols = (steps + 1) < kMaxCols ? (steps + 1) : kMaxCols;
  const size_t smem = (size_t)kThreads * (cols | 1) * sizeof(int);
  random_walk_steps<<<(B + kThreads - 1) / kThreads, kThreads, smem,
                      (cudaStream_t)stream_handle>>>(
      starts, (const float2*)u, (const int2*)vert_meta,
      (const float4*)ctx_pa, walk, row_mask, B, steps, n_edges, restart);
  return (int)cudaGetLastError();
}

}  // extern "C"
