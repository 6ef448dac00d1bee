// node2vec's second-order walk for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX walk (smore_tpu/sampling/walks.py
// node2vec_walk) is a Python loop of jnp ops over the steps, which the port
// ran as a loop of ~400-700 small torch ops a step (each trial an alias draw
// and a NeighborIndex binary search of ~9 ops an iteration; the plain twin
// smore_tpu_torch/sampling/walks.py node2vec_walk_ref). Here one launch takes
// every step: one thread a walk.
//
// The law: from (prev, cur) the next vertex x is drawn with weight w(cur, x)
// times 1/p (x == prev), 1 (x a neighbour of prev) or 1/q (otherwise), by
// rejection: up to `trials` candidates, each an alias draw from cur's
// context table (SamplerTables._context_of's rounding), accepted when
// u * max_bias < bias; the first accepted one is kept, the last one when
// none is. The thread stops drawing at the first accepted candidate (the
// twin computes every trial and keeps the same one), and the last trial
// needs no bias. "Is x a neighbour of prev" is a binary search for x in
// prev's sorted slice [indptr[prev], indptr[prev + 1]) of sorted_nbrs, as
// NeighborIndex.contains finds it. The first step is the first-order draw
// of target_sample; a dead end sends the cursor back to the start, as the
// twin's restart rule does. Every product is rounded to nearest and never
// contracted into an FMA, so the walks are bit-equal to the twin's given
// the same uniforms.
//
// What bounds it on the H100: latency. A trial is a chain of dependent
// loads: the candidate's ctx_pa row (the slot comes from cur's vert_meta
// row), then ~log2(deg(prev)) reads of the neighbour search, then the
// acceptance; a step takes ~1 to 4 trials, and a walk's steps follow one
// another. The bytes the law needs are a few 32-B sectors a trial. The
// design keeps the chain bare: cur's vert_meta row, prev's indptr pair and
// the first trial's uniforms are issued together at the top of a step (none
// depends on another), everything goes through the read-only path, and each
// walk's entries are written as they are drawn (41 a walk at the cells'
// shapes; the writes do not stall the chain).

#include <cuda_runtime.h>
#include <stdint.h>

#include "graph_nodes.cuh"

namespace {

constexpr int kThreads = 64;  // walks per block

// One out-neighbour of v by its alias table, as SamplerTables._context_of
// draws it: a zero-degree vertex returns itself.
__device__ __forceinline__ int alias_draw(int v, int2 m, float ua, float ub,
                                          const float4* __restrict__ ctx_pa,
                                          int n_edges) {
  if (m.y <= 0) return v;
  const int r = (int)__fmul_rn(ua, (float)m.y);  // in [0, deg]
  const int slot = min(m.x + min(r, m.y - 1), n_edges - 1);
  const float4 row = __ldg(ctx_pa + slot);  // [prob, vid, alias, 0]
  return (int)(ub < row.x ? row.y : row.z);
}

// Is x in the sorted slice nbrs[lo, hi)? The lower bound of x, as
// NeighborIndex.contains finds it.
__device__ __forceinline__ bool in_slice(const int* __restrict__ nbrs, int lo,
                                         int hi, int x) {
  const int end = hi;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(nbrs + mid) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < end && __ldg(nbrs + lo) == x;
}

__global__ void __launch_bounds__(kThreads) node2vec_walk_steps(
    const int* __restrict__ starts, const float2* __restrict__ u_first,
    const float* __restrict__ u, const int2* __restrict__ vert_meta,
    const float4* __restrict__ ctx_pa, const int* __restrict__ indptr,
    const int* __restrict__ nbrs, int* __restrict__ walk,
    float* __restrict__ row_mask, int B, int steps, int trials, int n_edges,
    float inv_p, float inv_q, float max_bias) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int L = steps + 1;
  int* out = walk + (size_t)b * L;
  const int start = starts[b];
  const int2 meta0 = __ldg(vert_meta + start);
  row_mask[b] = meta0.y > 0 ? 1.0f : 0.0f;
  out[0] = start;
  if (steps == 0) return;
  const float2 uf = __ldg(u_first + b);
  int cur = alias_draw(start, meta0, uf.x, uf.y, ctx_pa, n_edges);
  out[1] = cur;
  int prev = start;
  const size_t per_step = (size_t)B * trials * 3;
  const float* us = u + (size_t)b * trials * 3;
  for (int s = 0; s + 1 < steps; ++s, us += per_step) {
    // issued together: none of the three waits on another
    int2 m = __ldg(vert_meta + cur);
    const int lo = __ldg(indptr + prev), hi = __ldg(indptr + prev + 1);
    float ua = __ldg(us), ub = __ldg(us + 1), uc = __ldg(us + 2);
    if (m.y == 0) {  // a dead end: back to the start
      cur = start;
      m = meta0;
    }
    int chosen = cur;
    for (int t = 0;; ++t) {
      const int cand = alias_draw(cur, m, ua, ub, ctx_pa, n_edges);
      if (t == trials - 1) {  // the last candidate is taken as it is
        chosen = cand;
        break;
      }
      const float bias = cand == prev ? inv_p
                         : in_slice(nbrs, lo, hi, cand) ? 1.0f
                                                        : inv_q;
      if (__fmul_rn(uc, max_bias) < bias) {
        chosen = cand;
        break;
      }
      const float* un = us + 3 * (t + 1);
      ua = __ldg(un);
      ub = __ldg(un + 1);
      uc = __ldg(un + 2);
    }
    out[s + 2] = chosen;
    prev = cur;
    cur = chosen;
  }
}

}  // namespace

extern "C" {

const char* node2vec_walk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// starts (B,) int32; u_first (B, 2) f32; u (steps - 1, B, trials, 3) f32
// [index, alias, acceptance]; vert_meta (N, 2) int32 [indptr, degree];
// ctx_pa (n_edges, 4) f32 [prob, vid, alias_vid, 0]; indptr (N + 1,) int32
// and sorted_nbrs (n_edges,) int32, each vertex's out-neighbours sorted;
// walk (B, steps + 1) int32 and row_mask (B,) f32 written. u_first,
// vert_meta and ctx_pa at 8-, 8- and 16-byte aligned addresses; trials >= 1.
// inv_p, inv_q and max_bias are float32 as the twin rounds them. Returns the
// launch's cudaError_t.
int node2vec_walk_launch(int device, const int* starts, const float* u_first,
                         const float* u, const int* vert_meta,
                         const float* ctx_pa, const int* indptr,
                         const int* sorted_nbrs, int* walk, float* row_mask,
                         int B, int steps, int trials, int n_edges,
                         float inv_p, float inv_q, float max_bias,
                         void* stream_handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  node2vec_walk_steps<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                        (cudaStream_t)stream_handle>>>(
      starts, (const float2*)u_first, u, (const int2*)vert_meta,
      (const float4*)ctx_pa, indptr, sorted_nbrs, walk, row_mask, B, steps,
      trials, n_edges, inv_p, inv_q, max_bias);
  return (int)cudaGetLastError();
}

// Kernel nodes of a captured CUDA graph that launch this library's kernel,
// in *count. Returns a cudaError_t.
int node2vec_walk_graph_launches(void* graph, long long* count) {
  const void* k = (const void*)node2vec_walk_steps;
  return (int)graph_nodes::count((cudaGraph_t)graph, &k, 1, count);
}

}  // extern "C"
