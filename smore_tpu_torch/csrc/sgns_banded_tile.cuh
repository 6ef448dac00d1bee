// One tile of a banded shared-negative SGNS micro-step, for Hopper (sm_90a).
//
// Shared by sgns_banded_multiblock.cu (K4: S micro-steps of 1024-row tiles)
// and sgns_banded_fused.cu (K3: one micro-step of 2048-row tiles). For a
// tile of tb sample rows:
//
//   v  = Wv[*sb * band + src]      cp = Wc[*db * band + pos]    (tb, D)
//   g_pos = (1 - sigmoid(v . cp)) * alpha                       (tb,)
//   g_neg = -sigmoid(v cn^T) * alpha * k/Ks                     (tb, Ks)
//   Wv[src] += g_pos cp + g_neg cn      Wc[pos] += g_pos v      (scatter-add)
//   d_neg += g_neg^T v                  loss_rows = -log(s_pos + 1e-7)
//                                           - k/Ks sum log(1 - s_neg + 1e-7)
//
// A band start in rows is passed as the band index with band = 1.
//
// What bounds it on the H100: random 256-byte row gathers and row atomics
// (two of each per sample at D = 64), and the launch rate: the math is
// ~6*Ks*D flops per sample, far below the card's f32 rate for one tile.
// Both bands of a step (2 x 16400 x 64 x 4 B = 8.4 MB) sit in the 50 MB L2,
// so gathers and atomics hit L2, not HBM.
//
// Design (simple and in order, f32 throughout, no TF32, no tensor cores):
//   launch A, tile_grads: one warp per sample row, 8 rows per block; the
//     block stages cn in shared memory (row stride D + 1, so lanes that
//     walk different negatives hit different banks); each lane computes
//     Ks/32 of the v . cn dot products and D/32 columns of d_src. It writes
//     v, g_neg, d_src, d_pos and the row's loss to scratch.
//   launch B, tile_scatter: blocks [0, rows/8) scatter-add d_src into Wv
//     and d_pos into Wc with atomicAdd (one warp per row); the remaining
//     blocks reduce d_neg += g_neg^T v, each over a chunk of 64 rows and
//     256 outputs (one thread per output): the chunk's v rows and g_neg
//     columns are staged in shared memory with many loads in flight (a
//     thread walking all rows of the tile alone is bound by L2 latency),
//     and the partial sum is added to d_neg with one atomicAdd.
// Callers launch A then B per tile on one stream: stream order gives the TPU
// kernels' tile-serial update order (every gather sees the writes of
// earlier tiles; duplicates inside a tile sum, because the tile's deltas
// all come from its pre-scatter gather). Nothing here synchronises or
// allocates.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sgns_tile {

constexpr int kWarps = 8;  // sample rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kRowChunk = 64;  // rows per d_neg block

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kThreads) tile_grads(
    const float* __restrict__ wv, const float* __restrict__ wc,
    const int* __restrict__ sb, const int* __restrict__ db,
    const int* __restrict__ src, const int* __restrict__ pos,
    const float* __restrict__ cn, const float* __restrict__ alpha,
    int tb, int Ks, int D, int band, float kscale,
    float* __restrict__ vbuf, float* __restrict__ gneg,
    float* __restrict__ dsrc, float* __restrict__ dpos,
    float* __restrict__ loss_rows) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* scn = smem;                 // Ks x (D + 1)
  float* sv = scn + Ks * ld;         // kWarps x D  gathered v
  float* scp = sv + kWarps * D;      // kWarps x D  gathered cp
  float* sg = scp + kWarps * D;      // kWarps x Ks g_neg

  for (int i = threadIdx.x; i < Ks * D; i += kThreads)
    scn[(i / D) * ld + i % D] = cn[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= tb) return;
  const float a = *alpha;
  const float scale = a * kscale;
  const int64_t vr = (int64_t)(*sb) * band + src[r];
  const int64_t cr = (int64_t)(*db) * band + pos[r];
  float* v = sv + warp * D;
  float* c = scp + warp * D;
  float* g = sg + warp * Ks;

  float dot = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float x = wv[vr * D + d], y = wc[cr * D + d];
    v[d] = x;
    c[d] = y;
    dot += x * y;
  }
  dot = warp_sum(dot);
  __syncwarp();
  const float s_pos = sigmoid(dot);
  const float g_pos = (1.f - s_pos) * a;

  float lneg = 0.f;
  for (int k = lane; k < Ks; k += 32) {
    const float* ck = scn + k * ld;
    float z = 0.f;
    for (int d = 0; d < D; ++d) z += v[d] * ck[d];
    const float sn = sigmoid(z);
    const float gk = sn * (-scale);
    g[k] = gk;
    gneg[(size_t)r * Ks + k] = gk;
    lneg += logf(1.f - sn + 1e-7f);
  }
  lneg = warp_sum(lneg);
  if (lane == 0) loss_rows[r] = -logf(s_pos + 1e-7f) - kscale * lneg;
  __syncwarp();

  for (int d = lane; d < D; d += 32) {
    float acc = g_pos * c[d];
    for (int k = 0; k < Ks; ++k) acc += g[k] * scn[k * ld + d];
    dsrc[(size_t)r * D + d] = acc;
    dpos[(size_t)r * D + d] = g_pos * v[d];
    vbuf[(size_t)r * D + d] = v[d];
  }
}

__global__ void __launch_bounds__(kThreads) tile_scatter(
    float* __restrict__ wv, float* __restrict__ wc,
    const int* __restrict__ sb, const int* __restrict__ db,
    const int* __restrict__ src, const int* __restrict__ pos,
    int tb, int Ks, int D, int band, int n_scatter_blocks,
    const float* __restrict__ vbuf, const float* __restrict__ gneg,
    const float* __restrict__ dsrc, const float* __restrict__ dpos,
    float* __restrict__ d_neg) {
  if (blockIdx.x < n_scatter_blocks) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * kWarps + warp;
    if (r >= tb) return;
    const int64_t vr = (int64_t)(*sb) * band + src[r];
    const int64_t cr = (int64_t)(*db) * band + pos[r];
    for (int d = lane; d < D; d += 32) {
      atomicAdd(wv + vr * D + d, dsrc[(size_t)r * D + d]);
      atomicAdd(wc + cr * D + d, dpos[(size_t)r * D + d]);
    }
    return;
  }
  // d_neg[k, d] += sum over rows r0 <= r < r1 of g_neg[r, k] * v[r, d]
  extern __shared__ float smem[];
  const int n_chunks = (tb + kRowChunk - 1) / kRowChunk;
  const int id = blockIdx.x - n_scatter_blocks;
  const int r0 = (id % n_chunks) * kRowChunk;
  const int n = min(kRowChunk, tb - r0);
  const int o0 = (id / n_chunks) * kThreads;  // first output of the block
  const int k_lo = o0 / D;
  const int nk = min(Ks, (o0 + kThreads - 1) / D + 1) - k_lo;
  float* sv = smem;                  // n x D    v rows of the chunk
  float* sg = smem + kRowChunk * D;  // n x nk   g_neg[:, k_lo:k_lo + nk]
  for (int i = threadIdx.x; i < n * D; i += kThreads)
    sv[i] = vbuf[(size_t)r0 * D + i];
  for (int i = threadIdx.x; i < n * nk; i += kThreads)
    sg[i] = gneg[(size_t)(r0 + i / nk) * Ks + k_lo + i % nk];
  __syncthreads();
  const int o = o0 + threadIdx.x;
  if (o >= Ks * D) return;
  const int kk = o / D - k_lo, d = o % D;
  float acc = 0.f;
#pragma unroll 8
  for (int r = 0; r < n; ++r) acc += sg[r * nk + kk] * sv[r * D + d];
  atomicAdd(d_neg + o, acc);
}

inline size_t grads_smem_bytes(int Ks, int D) {
  return sizeof(float) * ((size_t)Ks * (D + 1) + 2 * kWarps * D + kWarps * Ks);
}

inline size_t scatter_smem_bytes(int Ks, int D) {
  const int nk = (kThreads + D - 1) / D + 1;  // g_neg columns per block
  return sizeof(float) * (size_t)kRowChunk * (D + (nk < Ks ? nk : Ks));
}

// Selects the device and raises both kernels' shared-memory limit where
// (Ks, D) need more than the default 48 KB.
inline cudaError_t prepare(int device, int Ks, int D) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = grads_smem_bytes(Ks, D);
  const size_t smem_b = scatter_smem_bytes(Ks, D);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        tile_grads, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (smem_b > 48 * 1024) {
    err = cudaFuncSetAttribute(
        tile_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_b);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Launches A then B for one tile of tb rows on `stream`. src, pos and
// loss_rows point at the tile's first row; scratch: vbuf, dsrc, dpos
// (tb, D), gneg (tb, Ks). Returns the first launch error.
inline cudaError_t launch_tile(
    cudaStream_t stream, float* wv, float* wc, const int* sb, const int* db,
    const int* src, const int* pos, const float* cn, const float* alpha,
    int tb, int Ks, int D, int band, float kscale, float* vbuf, float* gneg,
    float* dsrc, float* dpos, float* d_neg, float* loss_rows) {
  const int row_blocks = (tb + kWarps - 1) / kWarps;
  const int dneg_blocks = ((Ks * D + kThreads - 1) / kThreads) *
                          ((tb + kRowChunk - 1) / kRowChunk);
  tile_grads<<<row_blocks, kThreads, grads_smem_bytes(Ks, D), stream>>>(
      wv, wc, sb, db, src, pos, cn, alpha, tb, Ks, D, band, kscale, vbuf,
      gneg, dsrc, dpos, loss_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_scatter<<<row_blocks + dneg_blocks, kThreads,
                 scatter_smem_bytes(Ks, D), stream>>>(
      wv, wc, sb, db, src, pos, tb, Ks, D, band, row_blocks, vbuf, gneg,
      dsrc, dpos, d_neg);
  return cudaGetLastError();
}

}  // namespace sgns_tile
