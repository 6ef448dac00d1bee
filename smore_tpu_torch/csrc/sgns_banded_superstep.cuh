// A whole banded shared-negative SGNS superstep in ONE persistent,
// cooperative launch, for Hopper (sm_90a). Shared by
// sgns_banded_multiblock.cu (K4), sgns_banded_multiblock_nb.cu (K5) and
// sgns_banded_fused.cu (K3: one micro-step, S = 1, of 2048-row tiles, with
// band = 1 and the band START rows in place of band indices).
//
// S micro-steps run in order; micro-step s works source band sb[s] of Wv and
// context band db[s] of Wc, and its B samples are cut into tiles of tb rows
// that also run in order. For a tile:
//
//   v  = Wv[sb * band + src]      cp = Wc[db * band + pos]       (tb, D)
//   g_pos = (1 - sigmoid(v . cp)) * alpha                          (tb,)
//   g_neg = -sigmoid(v cn^T) * alpha * k/Ks                        (tb, Ks)
//   Wv[src] += g_pos cp + g_neg cn      Wc[pos] += g_pos v        (atomics)
//   d_neg += g_neg^T v     loss += -log(s_pos + 1e-7)
//                                  - k/Ks sum log(1 - s_neg + 1e-7)
//
// K4 and K3 take cn (S, Ks, D) from the caller's snapshot and return d_neg
// (S, Ks, D) for the caller to apply. K5 reads step s's cn from Wc's window
// rows nb[s] * nb2 + negs[s, :] when the step starts and adds the step's
// d_neg back into those rows (duplicates sum) before the next step starts.
//
// What bounds it on the H100: not the math (~6 Ks D flops a sample, 1.6
// GFLOP a superstep at the main path's shapes, 24 us at the f32 peak) but
// the serial chain: every tile's gathers must see the previous tile's
// scatters, so a superstep is 2 S B / tb dependent phases of a few
// microseconds each, separated by grid barriers (~1.2 us each).
//
// Design:
//   * One block of 256 threads per SM (all co-resident: a block takes ~160
//     registers a thread), launched with cudaLaunchCooperativeKernel;
//     phases are separated by cooperative_groups' grid barrier. Per tile:
//       phase A: each block takes groups of 8 rows: gathers v and cp, the
//         8 x Ks logits as a 2 x 2 register tile per thread, g, d_src as a
//         4 x 4 register tile per thread over an eighth of the negatives,
//         and writes v, g_neg (kept for d_neg), d_src and g_pos to scratch;
//       phase B: atomicAdd (16-byte vector atomics) of every row's d_src
//         into Wv and g_pos v into Wc.
//     All of a tile's gathers precede all of its scatters, so duplicate rows
//     inside a tile sum deltas of the same pre-scatter values.
//   * cn is staged in each block's shared memory once per micro-step (row
//     stride D + 4: a quarter-warp's 16-byte loads of 8 rows hit distinct
//     banks) and kept across the step's tiles.
//   * Every shared-memory load is 16 bytes and feeds 4 or more FMAs.
//   * d_neg has no phase of its own: v and g_neg stay in scratch, and
//     d_neg = G^T V is reduced in the phase B of the LAST tile of its span,
//     beside that tile's scatters. For K4 the span is the superstep (all S
//     steps at once: nothing in the superstep reads d_neg, and one phase of
//     16 steps' products measured faster on the H100 than a phase per
//     step); for K5 one micro-step (its window rows must be updated before
//     the next step gathers them). The reduction is a split-K product of
//     (step, negative slice, chunk of rows) items (see plan): a block
//     keeps an 8 x 4 register tile per thread across its consecutive
//     items, prefetches the next chunk into registers while it computes on
//     the current one, and adds its partial sums with 16-byte atomics when
//     the (step, negative slice) changes. K3 (one step) keeps no rows:
//     each thread sums one 8 x 4 tile of d_neg over the rows of every
//     phase A group it computes, and the blocks add their tiles with
//     atomics beside the last scatters.
//   * Each phase A ends by prefetching into L2 rows that the next phase A
//     gathers, and a step's last phase B the next step's negative rows:
//     the bands of a new step are often cold, and a prefetch moves no
//     value, so it is coherent.
//   * f32 throughout: no TF32, no tensor cores.
//   * Coherence: the tables and the scratch are written and read by the
//     same launch, so they are never const __restrict__, and every read of
//     them goes through L2 (__ldcg): a block's L1 may hold a line from an
//     earlier phase, and a grid barrier does not invalidate it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "graph_nodes.cuh"

namespace sgns_ss {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kRows = 8;     // sample rows per block in phase A
constexpr int kSplit = 8;    // negative split of d_src in phase A
constexpr int kMaxPre = 8;   // float4 per thread prefetched by the reduction
constexpr int kRedTile = 32; // one thread's d_neg tile: 8 negatives x 4 cols

// Which kernel a launch is. Each library instantiates only its own mode: a
// kernel that two libraries of one process both define refuses its
// cooperative launch, so K3 does not share K4's instantiation.
enum Mode : int {
  kSnapshot = 0,  // K4: cn from the caller's (S, Ks, D) snapshot
  kWindow = 1,    // K5: cn from Wc's window rows, d_neg added back per step
  kFused = 2,     // K3: K4's path for one micro-step (S = 1)
};
// phase A: one warp per row for the positive logit, 64 threads per row
// pair for the negative logits
static_assert(kThreads / 32 == kRows && kThreads / 64 == kRows / 2,
              "phase A's thread layout");

struct Params {
  float* wv;  // (Np, D) tables, updated in place
  float* wc;
  const int* sb;     // (S,) band indices
  const int* db;
  const int* nb;     // (S,) window indices (K5)
  const int* src;    // (S, B) band-local rows
  const int* pos;
  const int* negs;   // (S, Ks) window-local rows (K5)
  const float* cn;   // (S, Ks, D) negative snapshot (K4)
  const float* alpha;  // (S,)
  int S, B, tb, Ks, D, band, nb2;
  float kscale;      // k_equiv / Ks
  int ki;            // negatives per reduction item (a multiple of 8)
  int chunk;         // rows per reduction chunk
  int ldg;           // row stride of gneg: Ks rounded up to 4
  int inline_dneg;   // K3: d_neg summed in phase A's registers (see plan)
  float* vbuf;       // (kept, D) v for phase B and d_neg: K4 S * B rows,
                     // K5 and K3 B
  float* gneg;       // (kept_g, ldg) g_neg kept for d_neg (see plan)
  float* dsrc;       // (tb, D)
  float* gpos;       // (tb,)
  float* d_neg;      // (S, Ks, D), K4's and K3's output
  float* loss;       // () loss sum over all S * B rows
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float4 ld4cg(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 ld4s(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void atomic_add4(float* p, float4 x) {
  atomicAdd(reinterpret_cast<float4*>(p), x);
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Shared memory, in floats: cn (Ks x (D + 4)) kept across a step's tiles,
// then one work area that phase A and the reduction use in turn.
__host__ __device__ inline int phase_a_floats(int Ks, int D) {
  return 2 * kRows * D + kRows * Ks + kRows * ((Ks + 3) / 4 * 4) +
         kSplit * kRows * D + kRows;
}

__host__ __device__ inline int reduce_floats(int D, int ki, int chunk) {
  const int staged = chunk * (D + ki);
  const int partials = kThreads * kRedTile;
  return staged > partials ? staged : partials;
}

// Phase A for rows [row0, row0 + tb) of the (S, B) index arrays; their v
// and g_neg are kept at rows keep0 + r of vbuf and gneg, or, with kInline
// and p.inline_dneg (K3), v is kept for phase B and g_neg^T v summed
// straight into the thread's d_neg tile dacc (8 negatives x 4 columns:
// tile dtile of the (Ks / 8) x (D / 4) tiles, none when dtile < 0).
template <bool kInline>
__device__ __forceinline__ void phase_a(const Params& p, int s, int row0,
                                        int keep0, const float* scn,
                                        float* work, float& lacc,
                                        float (&dacc)[kRedTile], int dtile) {
  const int D = p.D, D4 = D >> 2, Ks = p.Ks, ldc = D + 4, tid = threadIdx.x;
  const float a = p.alpha[s];
  const float scale = a * p.kscale;
  const int64_t vb = (int64_t)p.sb[s] * p.band, cb = (int64_t)p.db[s] * p.band;
  float* sv = work;                  // kRows x D  gathered v
  float* scp = sv + kRows * D;       // kRows x D  gathered cp
  float* sgt = scp + kRows * D;      // Ks x kRows g_neg, negative-major
  float* sgr = sgt + Ks * kRows;     // kRows x ldg g_neg, row-major
  float* sred = sgr + kRows * p.ldg; // kSplit x kRows x D  d_src partials
  float* sgp = sred + kSplit * kRows * D;  // kRows  g_pos
  const int warp = tid >> 5, lane = tid & 31;
  const int rp = tid >> 6, kl = tid & 63;  // logits: rows 2rp, 2rp+1
  const int kq = (Ks + kSplit - 1) / kSplit;

  for (int grp = blockIdx.x; grp * kRows < p.tb; grp += gridDim.x) {
    const int rb = grp * kRows;  // first tile row of the group
    for (int i = tid; i < kRows * D4; i += kThreads) {
      const int r = i / D4, c = (i - r * D4) * 4;
      const int n = row0 + rb + r;
      const float4 x = ld4cg(p.wv + (vb + p.src[n]) * D + c);
      const float4 y = ld4cg(p.wc + (cb + p.pos[n]) * D + c);
      st4(sv + r * D + c, x);
      st4(scp + r * D + c, y);
      st4(p.vbuf + (size_t)(keep0 + rb + r) * D + c, x);
    }
    __syncthreads();

    {  // the positive logit of row `warp`
      float dot = 0.f;
      for (int d = lane; d < D; d += 32)
        dot = fmaf(sv[warp * D + d], scp[warp * D + d], dot);
      dot = warp_sum(dot);
      if (lane == 0) {
        const float sp = sigmoid(dot);
        const float gp = (1.f - sp) * a;
        sgp[warp] = gp;
        p.gpos[rb + warp] = gp;
        lacc -= logf(sp + 1e-7f);
      }
    }

    // negative logits: 2 rows x 2 negatives (k, k + 64) per thread
    const float* v0 = sv + 2 * rp * D;
    const float* v1 = v0 + D;
    float lneg = 0.f;
    for (int kc = 0; kc < Ks; kc += 128) {
      const int k0 = kc + kl, k1 = k0 + 64;
      const float* c0 = scn + min(k0, Ks - 1) * ldc;
      const float* c1 = scn + min(k1, Ks - 1) * ldc;
      float z00 = 0.f, z01 = 0.f, z10 = 0.f, z11 = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; d += 4) {
        const float4 a0 = ld4s(v0 + d), a1 = ld4s(v1 + d);
        const float4 b0 = ld4s(c0 + d), b1 = ld4s(c1 + d);
        z00 = dot4(a0, b0, z00);
        z01 = dot4(a0, b1, z01);
        z10 = dot4(a1, b0, z10);
        z11 = dot4(a1, b1, z11);
      }
      const float z[4] = {z00, z01, z10, z11};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 2 * rp + (j >> 1), k = (j & 1) ? k1 : k0;
        if (k < Ks) {
          const float sn = sigmoid(z[j]);
          const float gk = sn * (-scale);
          sgt[k * kRows + r] = gk;
          sgr[r * p.ldg + k] = gk;
          lneg += logf(1.f - sn + 1e-7f);
        }
      }
    }
    lacc -= p.kscale * lneg;
    __syncthreads();
    if (kInline && p.inline_dneg) {
      // the group's g_neg^T v into the thread's d_neg tile; sums of
      // negatives past Ks read padding and are never added to d_neg
      if (dtile >= 0) {
        const int k0 = (dtile / D4) * 8, c = (dtile % D4) * 4;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 g0 = ld4s(sgr + r * p.ldg + k0);
          const float4 g1 = ld4s(sgr + r * p.ldg + k0 + 4);
          const float4 v = ld4s(sv + r * D + c);
          const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            dacc[j * 4] = fmaf(gs[j], v.x, dacc[j * 4]);
            dacc[j * 4 + 1] = fmaf(gs[j], v.y, dacc[j * 4 + 1]);
            dacc[j * 4 + 2] = fmaf(gs[j], v.z, dacc[j * 4 + 2]);
            dacc[j * 4 + 3] = fmaf(gs[j], v.w, dacc[j * 4 + 3]);
          }
        }
      }
    } else {
      for (int i = tid; i < kRows * (p.ldg / 4); i += kThreads) {
        const int r = i / (p.ldg / 4), k = (i - r * (p.ldg / 4)) * 4;
        st4(p.gneg + (size_t)(keep0 + rb + r) * p.ldg + k,
            ld4s(sgr + r * p.ldg + k));
      }
    }

    // d_src partials: rows 4 rq .. 4 rq + 3 x columns c..c+3 over the
    // negatives of split ks
    for (int it = tid; it < kSplit * (kRows / 4) * D4; it += kThreads) {
      const int c = (it % D4) * 4;
      const int rq = (it / D4) % (kRows / 4);
      const int ks = it / (D4 * (kRows / 4));
      const int k_hi = min(Ks, (ks + 1) * kq);
      float4 acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = ks * kq; k < k_hi; ++k) {
        const float4 g = ld4s(sgt + k * kRows + 4 * rq);
        const float4 cc = ld4s(scn + k * ldc + c);
        fma4(acc[0], g.x, cc);
        fma4(acc[1], g.y, cc);
        fma4(acc[2], g.z, cc);
        fma4(acc[3], g.w, cc);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        st4(sred + (ks * kRows + 4 * rq + j) * D + c, acc[j]);
    }
    __syncthreads();
    for (int i = tid; i < kRows * D4; i += kThreads) {
      const int r = i / D4, c = (i - r * D4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      fma4(x, sgp[r], ld4s(scp + r * D + c));
#pragma unroll
      for (int ks = 0; ks < kSplit; ++ks) {
        const float4 y = ld4s(sred + (ks * kRows + r) * D + c);
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      st4(p.dsrc + (size_t)(rb + r) * D + c, x);
    }
    __syncthreads();  // the buffers are reused by the next group
  }
}

// Phase B's scatters of the tile at rows [row0, row0 + tb), kept at keep0.
__device__ __forceinline__ void phase_b(const Params& p, int s, int row0,
                                        int keep0) {
  const int D = p.D, D4 = D >> 2;
  const int64_t vb = (int64_t)p.sb[s] * p.band, cb = (int64_t)p.db[s] * p.band;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.tb * D4;
       i += gridDim.x * kThreads) {
    const int r = i / D4, c = (i - r * D4) * 4;
    const int n = row0 + r;
    const float4 ds = ld4cg(p.dsrc + (size_t)r * D + c);
    const float4 v = ld4cg(p.vbuf + (size_t)(keep0 + r) * D + c);
    const float g = __ldcg(p.gpos + r);
    atomic_add4(p.wv + (vb + p.src[n]) * D + c, ds);
    atomic_add4(p.wc + (cb + p.pos[n]) * D + c,
                make_float4(g * v.x, g * v.y, g * v.z, g * v.w));
  }
}

// d_neg = G^T V of `n_groups` groups of B kept rows (group g at rows g * B):
// items of (group, negative slice of ki, chunk of rows) split over the grid
// in contiguous ranges, partial sums added with atomics into d_neg[g] (K4,
// every step at once) or into the current step's window rows `wrow` (K5,
// one group; duplicates sum).
template <bool kNb>
__device__ __forceinline__ void reduce_dneg(const Params& p, int n_groups,
                                            const int* wrow, float* work) {
  const int D = p.D, D4 = D >> 2, Ks = p.Ks, ki = p.ki, cr = p.chunk;
  const int tid = threadIdx.x;
  const int n_t = (ki / 8) * D4;      // output tiles of 8 negatives x 4 cols
  const int rsplit = kThreads / n_t;  // threads that split one tile's rows
  const int n_q = (Ks + ki - 1) / ki;
  const int n_ch = (p.B + cr - 1) / cr;
  const int total = n_groups * n_q * n_ch;
  const int lo = (int)((int64_t)total * blockIdx.x / gridDim.x);
  const int hi = (int)((int64_t)total * (blockIdx.x + 1) / gridDim.x);
  if (lo >= hi) return;
  float* tv = work;         // cr x D   v rows of the chunk
  float* tg = tv + cr * D;  // cr x ki  g_neg columns of the slice
  float* tred = work;       // 8 x rsplit x n_t float4 partials (aliases)
  const int tile = tid % n_t, rs = tid / n_t;
  const bool active = rs < rsplit;
  const int k8 = tile / D4, c = (tile % D4) * 4;
  const int ki4 = ki / 4;
  const int nv = cr * D4, ng = cr * ki4;  // float4 per chunk: v, then g

  float4 pre[kMaxPre];
  float acc[kRedTile];
#pragma unroll
  for (int j = 0; j < kRedTile; ++j) acc[j] = 0.f;

  auto load = [&](int item) {
    const int gq = item / n_ch;
    const int r0 = (item - gq * n_ch) * cr;
    const size_t kept0 = (size_t)(gq / n_q) * p.B + r0;
#pragma unroll
    for (int j = 0; j < kMaxPre; ++j) {
      const int e = tid + j * kThreads;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < nv) {
        const int r = e / D4;
        if (r0 + r < p.B)
          x = ld4cg(p.vbuf + (kept0 + r) * D + (e - r * D4) * 4);
      } else if (e < nv + ng) {
        const int r = (e - nv) / ki4;
        const int kk = (gq % n_q) * ki + (e - nv - r * ki4) * 4;
        if (r0 + r < p.B && kk < Ks) {
          x = ld4cg(p.gneg + (kept0 + r) * p.ldg + kk);
          if (kk + 1 >= Ks) x.y = 0.f;  // padding of a ragged Ks
          if (kk + 2 >= Ks) x.z = 0.f;
          if (kk + 3 >= Ks) x.w = 0.f;
        }
      }
      pre[j] = x;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < kMaxPre; ++j) {
      const int e = tid + j * kThreads;
      if (e < nv) {
        st4(tv + e * 4, pre[j]);  // row-major cr x D
      } else if (e < nv + ng) {
        st4(tg + (e - nv) * 4, pre[j]);  // row-major cr x ki
      }
    }
  };
  auto flush = [&](int gq) {
    const int g = gq / n_q, q = gq % n_q;
    __syncthreads();  // tred aliases the staged chunk
    if (active) {  // float4 j of every thread's tile, thread-contiguous
#pragma unroll
      for (int j = 0; j < kRedTile / 4; ++j)
        st4(tred + ((j * rsplit + rs) * n_t + tile) * 4,
            make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                        acc[4 * j + 3]));
    }
    __syncthreads();
    for (int o = tid; o < n_t * 8; o += kThreads) {
      const int t = o % n_t, j = o / n_t;  // tile t, its negative j
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r2 = 0; r2 < rsplit; ++r2) {
        const float4 y = ld4s(tred + ((j * rsplit + r2) * n_t + t) * 4);
        sum.x += y.x;
        sum.y += y.y;
        sum.z += y.z;
        sum.w += y.w;
      }
      const int kk = q * ki + (t / D4) * 8 + j;
      if (kk < Ks) {
        const int64_t row = kNb ? wrow[kk] : (int64_t)g * Ks + kk;
        atomic_add4((kNb ? p.wc : p.d_neg) + row * D + (t % D4) * 4, sum);
      }
    }
#pragma unroll
    for (int j = 0; j < kRedTile; ++j) acc[j] = 0.f;
  };

  int cur = -1;
  load(lo);
  for (int item = lo; item < hi; ++item) {
    const int gq = item / n_ch;
    if (gq != cur) {
      if (cur >= 0) flush(cur);
      cur = gq;
    }
    __syncthreads();  // the previous chunk (or flush) is done with smem
    store();
    __syncthreads();
    if (item + 1 < hi) load(item + 1);  // in flight during the products
    if (active) {
      for (int r = rs; r < cr; r += rsplit) {
        const float4 g0 = ld4s(tg + r * ki + k8 * 8);
        const float4 g1 = ld4s(tg + r * ki + k8 * 8 + 4);
        const float4 v = ld4s(tv + r * D + c);
        const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j * 4] = fmaf(gs[j], v.x, acc[j * 4]);
          acc[j * 4 + 1] = fmaf(gs[j], v.y, acc[j * 4 + 1]);
          acc[j * 4 + 2] = fmaf(gs[j], v.z, acc[j * 4 + 2]);
          acc[j * 4 + 3] = fmaf(gs[j], v.w, acc[j * 4 + 3]);
        }
      }
    }
  }
  flush(cur);
}

__device__ __forceinline__ void prefetch_l2(const void* ptr) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(ptr));
}

// Brings step s's negative rows into L2 before the step stages them, split
// over the grid. A prefetch reads no value, so it is coherent with every
// write that precedes the step.
template <bool kNb>
__device__ __forceinline__ void prefetch_negs(const Params& p, int s) {
  const int lines = (p.D * 4 + 127) / 128;  // 128-byte lines of one row
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.Ks * lines;
       i += gridDim.x * kThreads) {
    const int k = i / lines, l = i % lines;
    const float* row =
        kNb ? p.wc + ((int64_t)p.nb[s] * p.nb2 + p.negs[(size_t)s * p.Ks + k])
                         * p.D
            : p.cn + ((size_t)s * p.Ks + k) * p.D;
    prefetch_l2(row + l * 32);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1) superstep(Params p) {
  constexpr bool kNb = kMode == kWindow;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int D = p.D, D4 = D >> 2, Ks = p.Ks, ldc = D + 4, tid = threadIdx.x;
  float* scn = smem;  // Ks x (D + 4)
  int* wrow = reinterpret_cast<int*>(scn + Ks * ldc);  // K5's window rows
  float* work = scn + Ks * ldc + (Ks + 3) / 4 * 4;     // phase A / reduction
  const int n_tiles = p.B / p.tb;
  float lacc = 0.f;
  // K3's d_neg tile in registers (p.inline_dneg): each block maps its
  // threads onto the tiles from its own offset, so that the blocks' final
  // atomics do not all meet on the same rows at once
  constexpr bool kInline = kMode == kFused;
  float dacc[kRedTile];
#pragma unroll
  for (int j = 0; j < kRedTile; ++j) dacc[j] = 0.f;
  const int n_dt = (Ks + 7) / 8 * D4;
  const int dtile =
      tid < n_dt ? (int)((tid + (int64_t)blockIdx.x * n_dt / gridDim.x) % n_dt)
                 : -1;

  // outputs that are only ever added to; the first addition follows a
  // grid barrier
  if (blockIdx.x == 0 && tid == 0) *p.loss = 0.f;
  if (!kNb) {
    for (size_t i = (size_t)blockIdx.x * kThreads + tid;
         i < (size_t)p.S * Ks * D; i += (size_t)gridDim.x * kThreads)
      p.d_neg[i] = 0.f;
  }

  for (int s = 0; s < p.S; ++s) {
    // the step's negatives, kept in shared memory for all its tiles
    if (kNb) {
      for (int k = tid; k < Ks; k += kThreads)
        wrow[k] = p.nb[s] * p.nb2 + p.negs[(size_t)s * Ks + k];
      __syncthreads();
    }
    for (int i = tid; i < Ks * D4; i += kThreads) {
      const int k = i / D4, c = (i - k * D4) * 4;
      const float4 x =
          kNb ? ld4cg(p.wc + (int64_t)wrow[k] * D + c)
              : __ldg(reinterpret_cast<const float4*>(
                    p.cn + ((size_t)s * Ks + k) * D + c));
      st4(scn + k * ldc + c, x);
    }
    __syncthreads();
    for (int t = 0; t < n_tiles; ++t) {
      const int row0 = s * p.B + t * p.tb;  // into the (S, B) indices
      const int keep0 = kNb ? t * p.tb : row0;
      const bool last_tile = t == n_tiles - 1, last = last_tile && s == p.S - 1;
      // One of the 2 x 8 rows the block gathers first in the next tile:
      // its index is loaded now, and the row prefetched into L2 after this
      // phase A, so that the next phase A finds it there (the bands of a
      // new step are often cold). A prefetch reads no value, so it is
      // coherent with this tile's scatters.
      const float* next_row = nullptr;
      int next_idx = 0;
      if (!last && tid < 2 * kRows && blockIdx.x * kRows < p.tb) {
        const int ns = last_tile ? s + 1 : s, nt = last_tile ? 0 : t + 1;
        const int n = ns * p.B + nt * p.tb + blockIdx.x * kRows + (tid >> 1);
        next_row = (tid & 1) ? p.wc + (int64_t)p.db[ns] * p.band * D
                             : p.wv + (int64_t)p.sb[ns] * p.band * D;
        next_idx = (tid & 1) ? p.pos[n] : p.src[n];
      }
      phase_a<kInline>(p, s, row0, keep0, scn, work, lacc, dacc, dtile);
      if (next_row != nullptr) {
        for (int l = 0; l < D; l += 32)
          prefetch_l2(next_row + (int64_t)next_idx * D + l);
      }
      grid.sync();
      phase_b(p, s, row0, keep0);
      if (kNb && last_tile) reduce_dneg<kNb>(p, 1, wrow, work);
      if (!kNb && last && !(kInline && p.inline_dneg))
        reduce_dneg<kNb>(p, p.S, wrow, work);
      if (kInline && p.inline_dneg && last && dtile >= 0) {
        const int k0 = (dtile / D4) * 8, c = (dtile % D4) * 4;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (k0 + j < Ks)
            atomic_add4(p.d_neg + (size_t)(k0 + j) * D + c,
                        make_float4(dacc[4 * j], dacc[4 * j + 1],
                                    dacc[4 * j + 2], dacc[4 * j + 3]));
        }
      }
      if (last) break;
      if (last_tile) prefetch_negs<kNb>(p, s + 1);
      grid.sync();
    }
  }

  // the block's loss, one atomic per block
  __shared__ float wsum[kThreads / 32];
  lacc = warp_sum(lacc);
  if ((tid & 31) == 0) wsum[tid >> 5] = lacc;
  __syncthreads();
  if (tid == 0) {
    float x = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) x += wsum[w];
    atomicAdd(p.loss, x);
  }
}

struct Plan {
  int ki, chunk, ldg, inline_dneg;
  size_t smem;
};

// The reduction's tiling for (Ks, D): negatives per item and rows per
// chunk. K4 reduces all S steps in one phase: wide items (all negatives,
// up to 256 / (D / 4) octets, by 32 rows) read each v row once, and give
// every block ~8 items at the main path's shapes. K5 reduces one step per
// phase: narrow items (32 negatives by 64 rows) make ~1 item a block, which
// measured faster on the H100 than 16 (~2 items a block) or 64 (~half). K3
// takes the same items where its d_neg does not fit phase A's registers.
template <int kMode>
inline Plan plan(int Ks, int D) {
  Plan pl;
  const bool narrow = kMode != kSnapshot;
  const int D4 = D / 4;
  const int nk8 = (Ks + 7) / 8;
  int q8 = kThreads / D4;
  if (narrow && q8 > 4) q8 = 4;
  if (q8 > nk8) q8 = nk8;
  if (q8 < 1) q8 = 1;
  pl.ki = 8 * q8;
  pl.chunk = narrow ? 64 : 32;
  while (pl.chunk > 8 && pl.chunk * (D4 + pl.ki / 4) > kMaxPre * kThreads)
    pl.chunk /= 2;
  pl.ldg = (Ks + 3) / 4 * 4;
  // K3 sums d_neg in phase A's registers when one 8 x 4 tile a thread
  // covers it (Ks <= 256 at D = 64): no kept g_neg, no reduction phase
  pl.inline_dneg = kMode == kFused && (Ks + 7) / 8 * (D / 4) <= kThreads;
  const int a = phase_a_floats(Ks, D), b = reduce_floats(D, pl.ki, pl.chunk);
  pl.smem = sizeof(float) * ((size_t)Ks * (D + 4) + (Ks + 3) / 4 * 4 +
                             (a > b ? a : b));
  return pl;
}

// Whether (Ks, D) fit the kernel: D a multiple of 4 whose float4 columns
// fit one block, and one chunk's prefetch in kMaxPre float4 a thread.
template <int kMode>
inline bool supported(int Ks, int D) {
  if (Ks < 1 || D < 4 || D % 4 || D / 4 > kThreads) return false;
  const Plan pl = plan<kMode>(Ks, D);
  return pl.chunk * (D / 4 + pl.ki / 4) <= kMaxPre * kThreads;
}

// Rows of v a launch keeps for phase B and its d_neg reduction: K4 S * B,
// K5 and K3 B.
template <int kMode>
inline int kept_rows(int S, int B) {
  return kMode == kWindow ? B : S * B;
}

// Rows of g_neg kept: those of v, or none when K3 sums d_neg in phase A
// (see plan).
template <int kMode>
inline int kept_g_rows(int S, int B, int Ks, int D) {
  return kMode == kFused && plan<kMode>(Ks, D).inline_dneg
             ? 0
             : kept_rows<kMode>(S, B);
}

// Floats of scratch one launch needs: vbuf (kept rows), gneg (kept_g rows)
// and dsrc, gpos (one tile's), each a multiple of 4 floats (16 B).
inline size_t scratch_floats(int kept, int kept_g, int tb, int Ks, int D) {
  const size_t ldg = (size_t)(Ks + 3) / 4 * 4;
  const size_t tb4 = (size_t)(tb + 3) / 4 * 4;
  return (size_t)kept * D + (size_t)kept_g * ldg + (size_t)tb * D + tb4;
}

inline void carve(Params& p, float* scratch, int kept, int kept_g) {
  p.vbuf = scratch;
  p.gneg = p.vbuf + (size_t)kept * p.D;
  p.dsrc = p.gneg + (size_t)kept_g * p.ldg;
  p.gpos = p.dsrc + (size_t)p.tb * p.D;
}

// The grid: one block on each SM (phase A's 128 groups of a 1024-row tile
// fill the card, and a smaller grid keeps the grid barrier cheaper), after
// checking that one block fits and the device takes cooperative launches.
template <int kMode>
inline cudaError_t grid_size(int device, int Ks, int D, int* grid) {
  *grid = 0;
  if (!supported<kMode>(Ks, D)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Plan pl = plan<kMode>(Ks, D);
  err = cudaFuncSetAttribute(superstep<kMode>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)pl.smem);
  if (err != cudaSuccess) return err;
  int sms = 0, occ = 0, coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, superstep<kMode>,
                                                      kThreads, pl.smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = sms;
  return cudaSuccess;
}

// One cooperative launch of the superstep on `stream`. p's tables, indices,
// sizes, d_neg and loss are set by the caller; scratch holds
// scratch_floats(kept_rows, kept_g_rows, tb, Ks, D) floats. Returns the
// launch's error.
template <int kMode>
inline cudaError_t launch(int device, Params p, float* scratch,
                          cudaStream_t stream) {
  // the grid of the last (device, Ks, D): the queries cost host time on
  // every superstep of a host-bound route
  static int last[3] = {-1, 0, 0};
  static int grid = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (last[0] != device || last[1] != p.Ks || last[2] != p.D) {
    err = grid_size<kMode>(device, p.Ks, p.D, &grid);
    if (err != cudaSuccess) return err;
    last[0] = device;
    last[1] = p.Ks;
    last[2] = p.D;
  }
  const Plan pl = plan<kMode>(p.Ks, p.D);
  p.ki = pl.ki;
  p.chunk = pl.chunk;
  p.ldg = pl.ldg;
  p.inline_dneg = pl.inline_dneg;
  carve(p, scratch, kept_rows<kMode>(p.S, p.B),
        kept_g_rows<kMode>(p.S, p.B, p.Ks, p.D));
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)superstep<kMode>, dim3(grid),
                                    dim3(kThreads), args, pl.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace sgns_ss

// Inside the extern "C" block of a library of one mode of the superstep:
// its exports beside its launcher, <name>_smem_bytes (dynamic shared memory
// of one block, 0 when (Ks, D) are not supported), <name>_scratch_floats
// (floats of the scratch buffer one launch needs; K3 passes S = 1),
// <name>_grid_size (the grid one launch uses, one block on each SM, or
// minus the cudaError_t that prevents it) and those of every library.
#define SUPERSTEP_LIBRARY_EXPORTS(name, mode)                                \
  size_t name##_smem_bytes(int Ks, int D) {                                  \
    return sgns_ss::supported<mode>(Ks, D) ? sgns_ss::plan<mode>(Ks, D).smem \
                                           : 0;                              \
  }                                                                          \
  size_t name##_scratch_floats(int S, int B, int tb, int Ks, int D) {        \
    return sgns_ss::scratch_floats(                                          \
        sgns_ss::kept_rows<mode>(S, B),                                      \
        sgns_ss::kept_g_rows<mode>(S, B, Ks, D), tb, Ks, D);                 \
  }                                                                          \
  int name##_grid_size(int device, int Ks, int D) {                          \
    int grid = 0;                                                            \
    const cudaError_t err =                                                  \
        sgns_ss::grid_size<mode>(device, Ks, D, &grid);                      \
    return err == cudaSuccess ? grid : -(int)err;                            \
  }                                                                          \
  KERNEL_LIBRARY_EXPORTS(name, sgns_ss::superstep<mode>)
