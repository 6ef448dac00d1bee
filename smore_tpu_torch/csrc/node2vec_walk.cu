// node2vec's second-order walk for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX walk (smore_tpu/sampling/walks.py
// node2vec_walk) is a Python loop of jnp ops over the steps, which the port
// ran as a loop of ~400-700 small torch ops a step (each trial an alias draw
// and a NeighborIndex binary search of ~9 ops an iteration; the plain twin
// smore_tpu_torch/sampling/walks.py node2vec_walk_ref). Here one launch takes
// every step of every walk.
//
// The law: from (prev, cur) the next vertex x is drawn with weight w(cur, x)
// times 1/p (x == prev), 1 (x a neighbour of prev) or 1/q (otherwise), by
// rejection: up to `trials` candidates, each an alias draw from cur's
// context table (SamplerTables._context_of's rounding), accepted when
// u * max_bias < bias; the first accepted one is kept, the last one when
// none is, and the last trial needs no bias. "Is x a neighbour of prev" is
// membership of x in prev's sorted slice [indptr[prev], indptr[prev + 1]) of
// sorted_nbrs, as NeighborIndex.contains finds it. The first step is the
// first-order draw of target_sample; a dead end sends the cursor back to the
// start, as the twin's restart rule does. Every product is rounded to nearest
// and never contracted into an FMA, so the walks are bit-equal to the twin's
// given the same uniforms.
//
// What bounds it on the H100: latency. The bytes the law needs are a few
// 32-B sectors a trial; a walk's steps follow one another, and a step is a
// chain of dependent reads. One thread a walk runs the trials in turn, each
// the candidate's ctx_pa row (the slot from cur's vert_meta row) and then a
// binary search of prev's list: ~2.7 trials a step at p 0.5, q 2 and
// ceil(log2(deg + 1)) = 5.8 reads a search on the Youtube graph's
// degree-weighted visits, up to 15 on its hubs, so ~19 dependent reads a
// step (~13 us a step in a replay on cold rows). At 128 walks that is 4
// warps on 2 of 132 SMs, and nothing hides the chain.
//
// So the kernel has two instances, of 1 and 32 lanes a walk
// (node2vec_walk_steps<kLanes>). In the 32-lane instance a warp takes a
// walk, and its lanes split into groups, one group a trial (ng groups, the
// next power of two of `trials` up to 32; with more trials than groups the
// groups take them in rounds, earliest first), and a step is:
//   1. cur's vert_meta row, each group's three uniforms and cur's indptr
//      pair, issued together;
//   2. every group's candidate row of ctx_pa at once; beside it, from cur's
//      indptr pair, the first-round pivots of cur's slice, which is prev's
//      in the next step (prefetched one step ahead);
//   3. the search of prev's slice by the group's G lanes at once: each lane
//      reads one pivot, a ballot narrows the range ~2G-fold, a slice of at
//      most G entries is read whole; the first round's pivots are already
//      there, so ~1-2 more rounds on hub slices and none on small ones;
//   4. a ballot of the groups' acceptances: the earliest accepted trial, or
//      the last one.
// That is ~3-4 dependent reads a step: a 128-walk launch of 40 steps in a
// node2vec.youtube replay takes ~0.084 ms, against ~0.53 ms a thread a walk. The twin computes every trial and
// keeps the first accepted one, so evaluating a step's trials at once gives
// the same walk: the uniforms of each trial are the twin's, and membership
// is membership whatever the search's order. The 1-lane instance is the
// thread-a-walk loop (trials in turn, stopping at the first accepted one),
// which issues ~32 times fewer instructions a walk, for batches that fill
// the card: the launcher (ops/node2vec_walk.py lanes_for) takes the warp
// while the batch is at most WARP_WALKS_PER_SM = 160 walks an SM (21,120 on
// the H100), one thread a walk above. The crossover is measured by
// chip_smoke.py phase 38 (PERF.md section 6): a warp a walk is 6.3x faster
// at 128 walks on the Youtube tables (0.070 against 0.437 ms a launch,
// cold) and still ahead at 16,384 on both graphs; one thread a walk is
// ahead from ~20,000 walks on the Flickr tables and ~33,000 on Youtube's,
// 1.5x at 80,640. An 8-lane instance was faster than both only near
// 16,384 walks on the Flickr tables (by 12%), and was left out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "graph_nodes.cuh"

namespace {

// threads a block: 64 walks a block with one thread a walk; a warp a walk in
// blocks of one warp, spread over the SMs
template <int kLanes>
constexpr int kBlock = kLanes == 1 ? 64 : 32;

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

// the launch's arguments (the tables read through the read-only path)
struct Args {
  const int* starts;
  const float2* u_first;
  const float* u;
  const int2* vert_meta;
  const float4* ctx_pa;
  const int* indptr;
  const int* nbrs;
  int* walk;
  float* row_mask;
  int B, steps, trials, n_edges;
  float inv_p, inv_q, max_bias;
};

// One thread a walk: the trials in turn, stopping at the first accepted one.
__device__ __forceinline__ void walk_one_lane(const Args& a) {
  const int b = blockIdx.x * kBlock<1> + threadIdx.x;
  if (b >= a.B) return;
  const int L = a.steps + 1;
  int* out = a.walk + (size_t)b * L;
  const int start = a.starts[b];
  const int2 meta0 = __ldg(a.vert_meta + start);
  a.row_mask[b] = meta0.y > 0 ? 1.0f : 0.0f;
  out[0] = start;
  if (a.steps == 0) return;
  const float2 uf = __ldg(a.u_first + b);
  int cur = alias_draw(start, meta0, uf.x, uf.y, a.ctx_pa, a.n_edges);
  out[1] = cur;
  int prev = start;
  const int trials = a.trials;
  const size_t per_step = (size_t)a.B * trials * 3;
  const float* us = a.u + (size_t)b * trials * 3;
  for (int s = 0; s + 1 < a.steps; ++s, us += per_step) {
    // issued together: none of the three waits on another
    int2 m = __ldg(a.vert_meta + cur);
    const int lo = __ldg(a.indptr + prev), hi = __ldg(a.indptr + prev + 1);
    float ua = __ldg(us), ub = __ldg(us + 1), uc = __ldg(us + 2);
    if (m.y == 0) {  // a dead end: back to the start
      cur = start;
      m = meta0;
    }
    int chosen = cur;
    for (int t = 0;; ++t) {
      const int cand = alias_draw(cur, m, ua, ub, a.ctx_pa, a.n_edges);
      if (t == trials - 1) {  // the last candidate is taken as it is
        chosen = cand;
        break;
      }
      const float bias = cand == prev                      ? a.inv_p
                         : in_slice(a.nbrs, lo, hi, cand) ? 1.0f
                                                           : a.inv_q;
      if (__fmul_rn(uc, a.max_bias) < bias) {
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

constexpr unsigned kFull = 0xffffffffu;  // a warp's lanes

// A group of G = 1 << lg lanes searching the sorted slice [lo, hi): lane k's
// pivot while the slice is longer than G (the midpoints of G equal parts,
// strictly increasing, the last below hi), else lane k reads entry lo + k.
__device__ __forceinline__ int pivot(int lo, int len, int k, int lg) {
  return lo + (int)(((long long)(2 * k + 1) * len) >> (lg + 1));
}

// The value lane k reads in a search round over [lo, hi) (0 where it reads
// nothing: past a short slice's end).
__device__ __forceinline__ int round_value(const int* __restrict__ nbrs,
                                           int lo, int hi, int k, int lg) {
  const int len = hi - lo;
  if (len <= (1 << lg)) return k < len ? __ldg(nbrs + lo + k) : 0;
  return __ldg(nbrs + pivot(lo, len, k, lg));
}

// Is x in the sorted slice nbrs[lo, hi)? Searched by a group of G = 1 << lg
// lanes (lane k of the group, the group's bits `shift` up in the warp),
// every group of the warp for its own x at once; `v` is the value lane k
// reads in the first round (round_value), read ahead. Groups with `want`
// false take part in the ballots only. The warp stays converged: each round
// is a ballot of the whole warp.
__device__ __forceinline__ bool group_search(const int* __restrict__ nbrs,
                                             int lo, int hi, int v, int x,
                                             bool want, int k, int lg,
                                             int shift) {
  const int G = 1 << lg;
  const unsigned low = lg == 5 ? 0xffffffffu : (1u << G) - 1;
  bool found = false, active = want;
  while (__any_sync(kFull, active)) {
    const int len = hi - lo;
    const bool whole = len <= G;  // the last round: the slice read whole
    const bool read = active && (!whole || k < len);
    const unsigned eq = (__ballot_sync(kFull, read && v == x) >> shift) & low;
    const unsigned lt = (__ballot_sync(kFull, read && v < x) >> shift) & low;
    if (active) {
      if (eq || whole) {
        found = eq != 0;
        active = false;
      } else {
        // the pivots below x are a prefix: x lies between the last of them
        // and the next one
        const int c = __popc(lt);
        const int nlo = c == 0 ? lo : pivot(lo, len, c - 1, lg) + 1;
        const int nhi = c == G ? hi : pivot(lo, len, c, lg);
        lo = nlo;
        hi = nhi;
        if (lo < hi) {
          v = round_value(nbrs, lo, hi, k, lg);
        } else {
          active = false;
        }
      }
    }
  }
  return found;
}

// A warp a walk: a step's trials in groups of lanes at once.
__device__ __forceinline__ void walk_warp(const Args& a) {
  const int b = blockIdx.x;  // a block is one warp
  const int lane = threadIdx.x;
  const int trials = a.trials;
  // ng groups of G = 1 << lg lanes; lane k of group g
  int lg_ng = 0;
  while ((1 << lg_ng) < trials && lg_ng < 5) ++lg_ng;
  const int ng = 1 << lg_ng;
  const int lg = 5 - lg_ng;
  const int g = lane >> lg, k = lane & ((1 << lg) - 1);
  const int shift = g << lg;

  const int L = a.steps + 1;
  int* out = a.walk + (size_t)b * L;
  const int start = a.starts[b];
  const int2 meta0 = __ldg(a.vert_meta + start);
  if (lane == 0) {
    a.row_mask[b] = meta0.y > 0 ? 1.0f : 0.0f;
    out[0] = start;
  }
  if (a.steps == 0) return;
  const float2 uf = __ldg(a.u_first + b);
  int cur = alias_draw(start, meta0, uf.x, uf.y, a.ctx_pa, a.n_edges);
  if (lane == 0) out[1] = cur;
  if (a.steps == 1) return;
  // the start's slice and first-round value: prev's in the first step, and
  // after every restart
  const int s_lo = __ldg(a.indptr + start), s_hi = __ldg(a.indptr + start + 1);
  const int s_v = round_value(a.nbrs, s_lo, s_hi, k, lg);
  int prev = start, p_lo = s_lo, p_hi = s_hi, p_v = s_v;
  const size_t per_step = (size_t)a.B * trials * 3;
  const float* us = a.u + (size_t)b * trials * 3;
  for (int s = 0; s + 1 < a.steps; ++s, us += per_step) {
    // issued together: none waits on another
    int2 m = __ldg(a.vert_meta + cur);
    const int c_lo = __ldg(a.indptr + cur), c_hi = __ldg(a.indptr + cur + 1);
    int t = g;  // this group's trial
    float ua = 0.f, ub = 0.f, uc = 0.f;
    if (t < trials) {
      ua = __ldg(us + 3 * t);
      ub = __ldg(us + 3 * t + 1);
      uc = __ldg(us + 3 * t + 2);
    }
    // cur's first-round value, prev's in the next step, read ahead
    int n_lo = c_lo, n_hi = c_hi, n_v = round_value(a.nbrs, c_lo, c_hi, k, lg);
    if (m.y == 0) {  // a dead end: back to the start
      cur = start;
      m = meta0;
      n_lo = s_lo;
      n_hi = s_hi;
      n_v = s_v;
    }
    int chosen = cur;
    for (;; t += ng) {
      const bool has = t < trials;
      const bool last = t == trials - 1;
      const int cand =
          has ? alias_draw(cur, m, ua, ub, a.ctx_pa, a.n_edges) : cur;
      // the last candidate is taken as it is: no search
      const bool near = group_search(a.nbrs, p_lo, p_hi, p_v, cand,
                                     has && !last && cand != prev, k, lg,
                                     shift);
      const float bias = cand == prev ? a.inv_p : near ? 1.0f : a.inv_q;
      const bool accept = has && (last || __fmul_rn(uc, a.max_bias) < bias);
      // the groups' first lanes: the earliest accepted trial is the lowest
      const unsigned acc = __ballot_sync(kFull, accept && k == 0);
      if (acc) {
        chosen = __shfl_sync(kFull, cand, __ffs(acc) - 1);
        break;
      }
      const int tn = t + ng;
      if (tn < trials) {
        ua = __ldg(us + 3 * tn);
        ub = __ldg(us + 3 * tn + 1);
        uc = __ldg(us + 3 * tn + 2);
      }
    }
    if (lane == 0) out[s + 2] = chosen;
    prev = cur;
    cur = chosen;
    p_lo = n_lo;
    p_hi = n_hi;
    p_v = n_v;
  }
}

template <int kLanes>
__global__ void __launch_bounds__(kBlock<kLanes>) node2vec_walk_steps(
    Args a) {
  static_assert(kLanes == 1 || kLanes == 32, "a thread or a warp a walk");
  if constexpr (kLanes == 1) {
    walk_one_lane(a);
  } else {
    walk_warp(a);
  }
}

template <int kLanes>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int walks = kBlock<kLanes> / kLanes;  // a block's
  node2vec_walk_steps<kLanes>
      <<<(a.B + walks - 1) / walks, kBlock<kLanes>, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

KERNEL_LIBRARY_EXPORTS(node2vec_walk, node2vec_walk_steps<1>,
                       node2vec_walk_steps<32>)

// starts (B,) int32; u_first (B, 2) f32; u (steps - 1, B, trials, 3) f32
// [index, alias, acceptance]; vert_meta (N, 2) int32 [indptr, degree];
// ctx_pa (n_edges, 4) f32 [prob, vid, alias_vid, 0]; indptr (N + 1,) int32
// and sorted_nbrs (n_edges,) int32, each vertex's out-neighbours sorted;
// walk (B, steps + 1) int32 and row_mask (B,) f32 written. u_first,
// vert_meta and ctx_pa at 8-, 8- and 16-byte aligned addresses; trials >= 1.
// inv_p, inv_q and max_bias are float32 as the twin rounds them. `lanes` (1
// or 32) picks the instance. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a lane count with no instance).
int node2vec_walk_launch_lanes(int device, int lanes, const int* starts,
                               const float* u_first, const float* u,
                               const int* vert_meta, const float* ctx_pa,
                               const int* indptr, const int* sorted_nbrs,
                               int* walk, float* row_mask, int B, int steps,
                               int trials, int n_edges, float inv_p,
                               float inv_q, float max_bias,
                               void* stream_handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{starts,   (const float2*)u_first,
               u,        (const int2*)vert_meta,
               (const float4*)ctx_pa, indptr,
               sorted_nbrs, walk,
               row_mask, B,
               steps,    trials,
               n_edges,  inv_p,
               inv_q,    max_bias};
  const cudaStream_t stream = (cudaStream_t)stream_handle;
  switch (lanes) {
    case 1:
      return (int)launch<1>(a, stream);
    case 32:
      return (int)launch<32>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
