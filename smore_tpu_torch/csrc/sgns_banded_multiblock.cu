// Banded multiblock SGNS superstep for Hopper (sm_90a).
//
// Replaces the TPU kernel smore_tpu/ops/pallas_sgns_banded.py
// sgns_banded_multiblock (bodies _make_multi_kernel / _make_multi_kernel_db):
// S micro-steps run in order; micro-step s works source band sb[s] of the
// vertex table Wv and context band db[s] of the context table Wc, and its
// batch of B samples is cut into tiles of TB rows that also run in order.
// For each tile:
//
//   v  = Wv[sb*band + src_l]      cp = Wc[db*band + pos_l]    (TB, D)
//   g_pos = (1 - sigmoid(v . cp)) * alpha                      (TB,)
//   g_neg = -sigmoid(v cn^T) * alpha * k/Ks                    (TB, Ks)
//   Wv[src] += g_pos cp + g_neg cn      Wc[pos] += g_pos v     (scatter-add)
//   d_neg[s] += g_neg^T v               loss += -log(s_pos + 1e-7)
//                                               - k/Ks sum log(1 - s_neg + 1e-7)
//
// cn (S, Ks, D) is the caller's snapshot of the shared negatives; d_neg is
// applied by the caller after the superstep. Every gather sees the writes of
// earlier tiles and steps; duplicates inside a tile sum, because the tile's
// deltas all come from its pre-scatter gather.
//
// What bounds it on the H100: random 256-byte row gathers and row atomics
// (two of each per sample at D = 64), and the launch rate: the math is
// ~2*Ks*D FMAs per sample, far below the card's f32 rate. Both bands of a
// step (2 x 16400 x 64 x 4 B = 8.4 MB) sit in the 50 MB L2, so gathers and
// atomics hit L2, not HBM. The TPU's band slabs, 2-row table fold and
// 128-lane layout existed for VMEM and Mosaic; here the tables are plain
// (Np, D) f32 and the L2 does the slab's work.
//
// Design (simple and in order, f32 throughout, no TF32, no tensor cores):
//   launch A, sgns_mb_grads: one warp per sample row, 8 rows per block; the
//     block stages cn[s] in shared memory (row stride D + 1, so lanes that
//     walk different negatives hit different banks); each lane computes
//     Ks/32 of the v . cn dot products and D/32 columns of d_src. It writes
//     v, g_neg, d_src, d_pos and the row's loss to scratch.
//   launch B, sgns_mb_scatter: blocks [0, rows/8) scatter-add d_src into Wv
//     and d_pos into Wc with atomicAdd (one warp per row); the remaining
//     blocks reduce d_neg[s] += g_neg^T v, each over a chunk of 64 rows and
//     256 outputs (one thread per output): the chunk's v rows and g_neg
//     columns are staged in shared memory with many loads in flight (a
//     thread walking all rows of the tile alone is bound by L2 latency),
//     and the partial sum is added to d_neg with one atomicAdd.
// The host loop below issues A then B per tile and per micro-step on the
// caller's stream: stream order gives the TPU kernel's tile-serial and
// step-serial update order. Nothing here synchronises or allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__global__ void __launch_bounds__(kThreads) sgns_mb_grads(
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

__global__ void __launch_bounds__(kThreads) sgns_mb_scatter(
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

}  // namespace

extern "C" {

size_t sgns_mb_grads_smem_bytes(int Ks, int D) {
  return sizeof(float) * ((size_t)Ks * (D + 1) + 2 * kWarps * D + kWarps * Ks);
}

size_t sgns_mb_scatter_smem_bytes(int Ks, int D) {
  const int nk = (kThreads + D - 1) / D + 1;  // g_neg columns per block
  return sizeof(float) * (size_t)kRowChunk * (D + (nk < Ks ? nk : Ks));
}

const char* sgns_mb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One superstep: S micro-steps of B samples, tiles of tb rows (B % tb == 0).
// Index arrays are int32 and row-major (S, B); cn and d_neg are (S, Ks, D);
// scratch: vbuf, dsrc, dpos (tb, D), gneg (tb, Ks); loss_rows (S, B).
// Returns the first cudaError_t of any launch (0 when all were accepted).
int sgns_banded_multiblock_launch(
    int device, float* wv, float* wc, const int* sb, const int* db,
    const int* src_l, const int* pos_l, const float* cn, const float* alpha,
    int S, int B, int tb, int Ks, int D, int band, float kscale,
    float* vbuf, float* gneg, float* dsrc, float* dpos, float* d_neg,
    float* loss_rows, void* stream_handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  const size_t smem = sgns_mb_grads_smem_bytes(Ks, D);
  const size_t smem_b = sgns_mb_scatter_smem_bytes(Ks, D);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(sgns_mb_grads,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (smem_b > 48 * 1024) {
    err = cudaFuncSetAttribute(sgns_mb_scatter,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_b);
    if (err != cudaSuccess) return (int)err;
  }
  const int row_blocks = (tb + kWarps - 1) / kWarps;
  const int dneg_blocks = ((Ks * D + kThreads - 1) / kThreads) *
                          ((tb + kRowChunk - 1) / kRowChunk);
  for (int s = 0; s < S; ++s) {
    for (int row0 = 0; row0 < B; row0 += tb) {
      const size_t off = (size_t)s * B + row0;
      sgns_mb_grads<<<row_blocks, kThreads, smem, stream>>>(
          wv, wc, sb + s, db + s, src_l + off, pos_l + off,
          cn + (size_t)s * Ks * D, alpha + s, tb, Ks, D, band, kscale,
          vbuf, gneg, dsrc, dpos, loss_rows + off);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      sgns_mb_scatter<<<row_blocks + dneg_blocks, kThreads, smem_b, stream>>>(
          wv, wc, sb + s, db + s, src_l + off, pos_l + off, tb, Ks, D, band,
          row_blocks, vbuf, gneg, dsrc, dpos, d_neg + (size_t)s * Ks * D);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

}  // extern "C"
