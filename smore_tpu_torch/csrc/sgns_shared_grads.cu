// Fused shared-negative SGNS gradients for Hopper (sm_90a).
//
// Replaces the TPU kernel smore_tpu/ops/pallas_sgns.py
// sgns_shared_grads_pallas (body _kernel). Given the gathered rows v, cp
// (B, D), the shared negatives cn (Ks, D) and the rate alpha:
//
//   g_pos = (1 - sigmoid(v . cp)) * alpha                  (B,)
//   g_neg = -sigmoid(v cn^T) * alpha * k/Ks                (B, Ks)
//   d_src = g_pos cp + g_neg cn      d_pos = g_pos v       (B, D)
//   d_neg = g_neg^T v                                      (Ks, D)
//
// No gather and no scatter: the caller does both. The TPU kernel kept the
// (B, Ks) logits in VMEM and summed d_neg over its 1024-row tiles in order;
// here d_neg is summed with atomics, which changes only the f32 order.
//
// What bounds it on the H100: three products of B x Ks x D multiply-adds
// (1.6 GFLOP at B = 32768, Ks = 128, D = 64) against ~32 MB of row traffic
// (v, cp in; d_src, d_pos out) plus the g_neg scratch: compute, in f32 on
// the CUDA cores (no TF32, no tensor cores), and shared-memory loads feed
// the multiply-adds.
//
// Design (simple, f32 throughout):
//   launch A, sgns_sg_rows: one block of 8 warps per 64 rows. It stages cn
//     (row stride D + 1), its v and cp rows in shared memory; one warp per
//     row computes v . cp and g_pos; then each thread holds an 8-row x
//     4-negative tile of v cn^T in registers (8 + 4 shared loads per 32
//     multiply-adds), turns it into g_neg in shared memory, and an 8-row x
//     2-column tile of g_neg cn for d_src. It writes d_src, d_pos and g_neg
//     (to a (B, Ks) scratch).
//   launch B, sgns_sg_dneg: d_neg = g_neg^T v split over 512-row chunks;
//     each block owns a 64 x 64 tile of d_neg, stages 32 rows of g_neg and
//     v at a time, keeps a 4 x 4 tile per thread and adds it to d_neg with
//     one atomicAdd per output (d_neg arrives zeroed).
// Both launches go on the caller's stream; nothing here synchronises or
// allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                     // rows per block, launch A
constexpr int kRowsPerWarp = kRows / kWarps;  // 8
constexpr int kNegTile = 4;                   // negatives per thread, A
constexpr int kColTile = 2;                   // columns per thread, A
constexpr int kChunk = 512;                   // rows per block, launch B
constexpr int kTile = 64;                     // d_neg tile edge, launch B
constexpr int kSub = 32;                      // rows staged per pass, B

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kThreads) sgns_sg_rows(
    const float* __restrict__ v, const float* __restrict__ cp,
    const float* __restrict__ cn, const float* __restrict__ alpha, int B,
    int Ks, int D, float kscale, float* __restrict__ gneg,
    float* __restrict__ dsrc, float* __restrict__ dpos) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* scn = smem;               // Ks x (D + 1)
  float* sv = scn + Ks * ld;       // kRows x D
  float* scp = sv + kRows * D;     // kRows x D
  float* sg = scp + kRows * D;     // kRows x Ks   g_neg
  float* sgp = sg + kRows * Ks;    // kRows        g_pos

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);
  const float a = *alpha;
  const float scale = a * kscale;

  for (int i = tid; i < Ks * D; i += kThreads)
    scn[(i / D) * ld + i % D] = cn[i];
  const size_t base = (size_t)row0 * D;
  for (int i = tid; i < kRows * D; i += kThreads) {
    const bool in = i < nrows * D;  // rows past the batch end read as 0
    sv[i] = in ? v[base + i] : 0.f;
    scp[i] = in ? cp[base + i] : 0.f;
  }
  __syncthreads();

  const int r_lo = warp * kRowsPerWarp;  // this warp's / thread's rows
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r_lo + i;
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) dot += sv[r * D + d] * scp[r * D + d];
    dot = warp_sum(dot);
    if (lane == 0) sgp[r] = (1.f - sigmoid(dot)) * a;
  }

  // g_neg = -sigmoid(v cn^T) * scale: rows r_lo + i, negatives
  // kc + lane + 32 j
  for (int kc = 0; kc < Ks; kc += 32 * kNegTile) {
    float acc[kRowsPerWarp][kNegTile];
    const float* cptr[kNegTile];
    bool kin[kNegTile];
#pragma unroll
    for (int j = 0; j < kNegTile; ++j) {
      const int k = kc + lane + 32 * j;
      kin[j] = k < Ks;
      cptr[j] = scn + (kin[j] ? k : 0) * ld;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) acc[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float b[kNegTile];
#pragma unroll
      for (int j = 0; j < kNegTile; ++j) b[j] = cptr[j][d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float x = sv[(r_lo + i) * D + d];
#pragma unroll
        for (int j = 0; j < kNegTile; ++j) acc[i][j] += x * b[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kNegTile; ++j) {
      if (!kin[j]) continue;
      const int k = kc + lane + 32 * j;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        sg[(r_lo + i) * Ks + k] = sigmoid(acc[i][j]) * (-scale);
    }
  }
  __syncthreads();

  for (int i = tid; i < nrows * Ks; i += kThreads)
    gneg[(size_t)row0 * Ks + i] = sg[i];

  // d_src = g_pos cp + g_neg cn, d_pos = g_pos v: rows r_lo + i, columns
  // dc + lane + 32 j
  for (int dc = 0; dc < D; dc += 32 * kColTile) {
    float acc[kRowsPerWarp][kColTile];
    int dj[kColTile];
    bool din[kColTile];
#pragma unroll
    for (int j = 0; j < kColTile; ++j) {
      dj[j] = dc + lane + 32 * j;
      din[j] = dj[j] < D;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) acc[i][j] = 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < Ks; ++k) {
      float b[kColTile];
#pragma unroll
      for (int j = 0; j < kColTile; ++j)
        b[j] = din[j] ? scn[k * ld + dj[j]] : 0.f;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float x = sg[(r_lo + i) * Ks + k];
#pragma unroll
        for (int j = 0; j < kColTile; ++j) acc[i][j] += x * b[j];
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = r_lo + i;
      if (r >= nrows) break;
      const float gp = sgp[r];
      const size_t o = (size_t)(row0 + r) * D;
#pragma unroll
      for (int j = 0; j < kColTile; ++j) {
        if (!din[j]) continue;
        dsrc[o + dj[j]] = gp * scp[r * D + dj[j]] + acc[i][j];
        dpos[o + dj[j]] = gp * sv[r * D + dj[j]];
      }
    }
  }
}

// d_neg[k, d] += sum over the block's rows r of gneg[r, k] * v[r, d]
__global__ void __launch_bounds__(kThreads) sgns_sg_dneg(
    const float* __restrict__ v, const float* __restrict__ gneg, int B,
    int Ks, int D, int k_tiles, float* __restrict__ d_neg) {
  __shared__ float sgk[kSub * kTile];  // kSub rows x 64 negatives
  __shared__ float svd[kSub * kTile];  // kSub rows x 64 columns
  const int tid = threadIdx.x;
  const int k0 = (blockIdx.x % k_tiles) * kTile;
  const int d0 = (blockIdx.x / k_tiles) * kTile;
  const int r0 = blockIdx.y * kChunk;
  const int r1 = min(B, r0 + kChunk);
  const int tk = tid / 16, td = tid % 16;  // outputs k0 + tk + 16 i,
                                           //         d0 + td + 16 j
  float acc[4][4] = {};
  for (int rs = r0; rs < r1; rs += kSub) {
    for (int i = tid; i < kSub * kTile; i += kThreads) {
      const int r = rs + i / kTile, c = i % kTile;
      sgk[i] = (r < r1 && k0 + c < Ks) ? gneg[(size_t)r * Ks + k0 + c] : 0.f;
      svd[i] = (r < r1 && d0 + c < D) ? v[(size_t)r * D + d0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kSub; ++rr) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = sgk[rr * kTile + tk + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = svd[rr * kTile + td + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += x[i] * y[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + tk + 16 * i;
    if (k >= Ks) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + td + 16 * j;
      if (d < D) atomicAdd(d_neg + (size_t)k * D + d, acc[i][j]);
    }
  }
}

}  // namespace

extern "C" {

size_t sgns_sg_smem_bytes(int Ks, int D) {
  return sizeof(float) * ((size_t)Ks * (D + 1) + 2 * (size_t)kRows * D +
                          (size_t)kRows * Ks + kRows);
}

const char* sgns_sg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// v, cp (B, D); cn (Ks, D); alpha one float on the device; scratch gneg
// (B, Ks); outputs d_src, d_pos (B, D) and d_neg (Ks, D), d_neg zeroed by
// the caller. Returns the first cudaError_t of either launch (0 when both
// were accepted).
int sgns_shared_grads_launch(int device, const float* v, const float* cp,
                             const float* cn, const float* alpha, int B,
                             int Ks, int D, float kscale, float* gneg,
                             float* dsrc, float* dpos, float* d_neg,
                             void* stream_handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  const size_t smem = sgns_sg_smem_bytes(Ks, D);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(sgns_sg_rows,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sgns_sg_rows<<<(B + kRows - 1) / kRows, kThreads, smem, stream>>>(
      v, cp, cn, alpha, B, Ks, D, kscale, gneg, dsrc, dpos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int k_tiles = (Ks + kTile - 1) / kTile;
  const dim3 grid(k_tiles * ((D + kTile - 1) / kTile),
                  (B + kChunk - 1) / kChunk);
  sgns_sg_dneg<<<grid, kThreads, 0, stream>>>(v, gneg, B, Ks, D, k_tiles,
                                               d_neg);
  return (int)cudaGetLastError();
}

}  // extern "C"
