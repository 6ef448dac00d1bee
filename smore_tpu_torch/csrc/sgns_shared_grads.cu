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
// here g_neg never leaves shared memory and d_neg is summed with atomics,
// which changes only the f32 order.
//
// What bounds it on the H100: three products of B x Ks x D multiply-adds
// (1.6 GFLOP at B = 32768, Ks = 128, D = 64: 24 us at the f32 peak) against
// 33.6 MB of row traffic (v, cp in; d_src, d_pos out: 10 us at 3.35 TB/s).
// So the multiply-adds, in f32 on the CUDA cores (no TF32, no tensor
// cores): every shared-memory load is 16 bytes and feeds 4 or more of them.
//
// Design: ONE cooperative launch of a persistent kernel, one 256-thread
// block per SM, each block walking tiles of tr rows of the batch (tr = 64
// at D = 64; smaller where shared memory would not hold the buffers):
//   * cn is staged in the block's shared memory once (row stride D + 4, so
//     16-byte loads of 8 consecutive rows hit distinct banks); rows past Ks
//     (Ks padded to a multiple of 8) are zero.
//   * v and cp of the block's NEXT tile are copied into shared memory with
//     cp.async while it computes on the current one (double buffer); rows
//     past B read as zero and are never written out.
//   * per tile:
//       logits v cn^T as a 4-row x 8-negative register tile a thread (12
//         loads per 128 multiply-adds; a thread's negatives kg + j Ks/8, so
//         a warp's 16 loads of one j hit distinct banks); g_neg goes to
//         shared memory only: no (B, Ks) scratch in device memory; v . cp
//         and g_pos from 4 lanes per row;
//       d_src = g_pos cp + g_neg cn as a 4 x 4 register tile a thread, and
//         d_pos = g_pos v, written straight out;
//       d_neg += g_neg^T v as an 8-negative x 4-column register tile a
//         thread over the tile's rows, added into the block's partial d_neg
//         in shared memory (every thread owns its outputs: no atomics).
//   * d_neg is zeroed by the kernel; after the one grid barrier every block
//     adds its partial with 16-byte atomics.
// Nothing here synchronises the host or allocates.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxTile = 64;            // rows per tile where they fit
constexpr size_t kMaxSmem = 232448;     // bytes a block may use on the H100

struct Params {
  const float* v;      // (B, D)
  const float* cp;     // (B, D)
  const float* cn;     // (Ks, D)
  const float* alpha;  // one float
  int B, Ks, D;
  float kscale;        // k_equiv / Ks
  int tr;              // rows per tile, a multiple of 4
  int nbuf;            // 2: the next tile is copied during this one
  int kp;              // Ks rounded up to 8
  float* dsrc;         // (B, D)
  float* dpos;         // (B, D)
  float* d_neg;        // (Ks, D)
};

// 1 / (1 + e^-x) from the hardware's approximate exp2 and reciprocal
// (__expf, __fdividef: a few ulp, ~1e-6 relative at the logits' sizes, far
// inside the kernel-vs-twin tolerance); expf and a correctly rounded
// reciprocal cost ~5 us more of a ~0.07 ms call at the main path's shapes
// on the H100.
__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

__device__ __forceinline__ float4 ld4s(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
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

// 16 bytes global -> shared, asynchronously; zero-filled when !full.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Shared memory, in floats: cn (kp x (D + 4)), v and cp (nbuf x tr x
// (D + 4) each), g_neg (tr x (kp + 4)), the partial d_neg (kp x D), g_pos
// (tr). Every region starts on 16 bytes.
__host__ __device__ inline size_t smem_floats(int tr, int nbuf, int Ks,
                                              int D) {
  const size_t kp = (Ks + 7) / 8 * 8, ldv = D + 4;
  return kp * ldv + 2 * (size_t)nbuf * tr * ldv + (size_t)tr * (kp + 4) +
         kp * D + tr;
}

// Every phase takes D from its template argument kD, or from p when kD is
// 0: the main path's D = 64 as a constant unrolls the depth loops and turns
// the row strides into immediate offsets (3 us of a call on the H100).

// Copies the v and cp rows of tile t into sv, scp (one commit group).
template <int kD>
__device__ __forceinline__ void load_tile(const Params& p, int t, float* sv,
                                          float* scp) {
  const int D = kD ? kD : p.D, D4 = D >> 2, ldv = D + 4;
  for (int i = threadIdx.x; i < p.tr * D4; i += kThreads) {
    const int r = i / D4, c = (i - r * D4) * 4;
    const int row = t * p.tr + r;
    const bool in = row < p.B;
    const size_t off = in ? (size_t)row * D + c : 0;
    cp_async16(sv + r * ldv + c, p.v + off, in);
    cp_async16(scp + r * ldv + c, p.cp + off, in);
  }
  cp_async_commit();
}

// g_neg of the tile into sg: 4 rows x 8 negatives a thread.
template <int kD>
__device__ __forceinline__ void logits(const Params& p, const float* sv,
                                       const float* scn, float* sg,
                                       float scale) {
  const int D = kD ? kD : p.D, ldv = D + 4, ldg = p.kp + 4;
  const int n_kg = p.kp >> 3;
  for (int it = threadIdx.x; it < (p.tr >> 2) * n_kg; it += kThreads) {
    const int kg = it % n_kg, r0 = (it / n_kg) * 4;
    const float* a = sv + r0 * ldv;
    const float* b = scn + kg * ldv;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = ld4s(a + i * ldv + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 y = ld4s(b + j * n_kg * ldv + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = dot4(x[i], y, acc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = kg + j * n_kg;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sg[(r0 + i) * ldg + k] =
            k < p.Ks ? sigmoid(acc[i][j]) * (-scale) : 0.f;
    }
  }
}

// g_pos of the tile's rows: 4 lanes per row (8 rows a warp at once), each
// lane over every 4th float4 of the row.
template <int kD>
__device__ __forceinline__ void positives(const Params& p, const float* sv,
                                          const float* scp, float* sgp,
                                          float a) {
  const int D = kD ? kD : p.D, ldv = D + 4;
  const int q = threadIdx.x & 3;
  for (int r = threadIdx.x >> 2; r < p.tr; r += kThreads / 4) {
    float dot = 0.f;
    for (int d = 4 * q; d < D; d += 16)
      dot = dot4(ld4s(sv + r * ldv + d), ld4s(scp + r * ldv + d), dot);
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    if (q == 0) sgp[r] = (1.f - sigmoid(dot)) * a;
  }
}

// d_src and d_pos of the tile's first nrows rows: 4 rows x 4 columns a
// thread, written to device memory.
template <int kD>
__device__ __forceinline__ void src_pos(const Params& p, int t, int nrows,
                                        const float* sv, const float* scp,
                                        const float* scn, const float* sg,
                                        const float* sgp) {
  const int D = kD ? kD : p.D, D4 = D >> 2, ldv = D + 4, ldg = p.kp + 4;
  for (int it = threadIdx.x; it < (p.tr >> 2) * D4; it += kThreads) {
    const int c = (it % D4) * 4, r0 = (it / D4) * 4;
    if (r0 >= nrows) continue;
    const float* g = sg + r0 * ldg;
    const float* b = scn + c;
    float4 acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int k = 0; k < p.kp; k += 4) {
      float4 gg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gg[i] = ld4s(g + i * ldg + k);
      const float4 b0 = ld4s(b + k * ldv), b1 = ld4s(b + (k + 1) * ldv);
      const float4 b2 = ld4s(b + (k + 2) * ldv), b3 = ld4s(b + (k + 3) * ldv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fma4(acc[i], gg[i].x, b0);
        fma4(acc[i], gg[i].y, b1);
        fma4(acc[i], gg[i].z, b2);
        fma4(acc[i], gg[i].w, b3);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i;
      if (r >= nrows) break;
      const float gp = sgp[r];
      const float4 x = ld4s(scp + r * ldv + c), y = ld4s(sv + r * ldv + c);
      fma4(acc[i], gp, x);
      const size_t o = ((size_t)t * p.tr + r) * D + c;
      st4(p.dsrc + o, acc[i]);
      st4(p.dpos + o, make_float4(gp * y.x, gp * y.y, gp * y.z, gp * y.w));
    }
  }
}

// The block's partial d_neg += g_neg^T v over the tile's first nrows rows:
// 8 negatives x 4 columns a thread, each thread adding into its own
// outputs of sdn.
template <int kD>
__device__ __forceinline__ void dneg_tile(const Params& p, int nrows,
                                          const float* sv, const float* sg,
                                          float* sdn) {
  const int D = kD ? kD : p.D, D4 = D >> 2, ldv = D + 4, ldg = p.kp + 4;
  for (int it = threadIdx.x; it < (p.kp >> 3) * D4; it += kThreads) {
    const int c = (it % D4) * 4, k0 = (it / D4) * 8;
    float4 acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int r = 0; r < nrows; ++r) {
      const float4 g0 = ld4s(sg + r * ldg + k0);
      const float4 g1 = ld4s(sg + r * ldg + k0 + 4);
      const float4 x = ld4s(sv + r * ldv + c);
      fma4(acc[0], g0.x, x);
      fma4(acc[1], g0.y, x);
      fma4(acc[2], g0.z, x);
      fma4(acc[3], g0.w, x);
      fma4(acc[4], g1.x, x);
      fma4(acc[5], g1.y, x);
      fma4(acc[6], g1.z, x);
      fma4(acc[7], g1.w, x);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* o = sdn + (k0 + j) * D + c;
      float4 s = ld4s(o);
      s.x += acc[j].x;
      s.y += acc[j].y;
      s.z += acc[j].z;
      s.w += acc[j].w;
      st4(o, s);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    shared_grads_persistent(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int D = kD ? kD : p.D, D4 = D >> 2, Ks = p.Ks, kp = p.kp, tr = p.tr;
  const int ldv = D + 4, tid = threadIdx.x;
  float* scn = smem;                    // kp x ldv
  float* sv = scn + kp * ldv;           // nbuf x tr x ldv
  float* scp = sv + p.nbuf * tr * ldv;  // nbuf x tr x ldv
  float* sg = scp + p.nbuf * tr * ldv;  // tr x (kp + 4)
  float* sdn = sg + tr * (kp + 4);      // kp x D
  float* sgp = sdn + kp * D;            // tr
  const int n_tiles = (p.B + tr - 1) / tr;
  const float a = *p.alpha;
  const float scale = a * p.kscale;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // d_neg is only ever added to, after the grid barrier below
  for (int i = blockIdx.x * kThreads + tid; i < Ks * D;
       i += gridDim.x * kThreads)
    p.d_neg[i] = 0.f;

  int t = blockIdx.x;
  if (t < n_tiles) load_tile<kD>(p, t, sv, scp);
  for (int i = tid; i < kp * D4; i += kThreads) {
    const int k = i / D4, c = (i - k * D4) * 4;
    st4(scn + k * ldv + c,
        k < Ks ? __ldg(reinterpret_cast<const float4*>(p.cn + k * D + c))
               : zero);
    st4(sdn + i * 4, zero);
  }

  int buf = 0;
  for (; t < n_tiles; t += gridDim.x) {
    const int next = t + gridDim.x;
    const float* v_s = sv + buf * tr * ldv;
    const float* cp_s = scp + buf * tr * ldv;
    if (p.nbuf == 2 && next < n_tiles) {
      const int other = (buf ^ 1) * tr * ldv;
      load_tile<kD>(p, next, sv + other, scp + other);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile's rows (and, first, cn) are in place
    logits<kD>(p, v_s, scn, sg, scale);
    positives<kD>(p, v_s, cp_s, sgp, a);
    __syncthreads();
    const int nrows = min(tr, p.B - t * tr);
    src_pos<kD>(p, t, nrows, v_s, cp_s, scn, sg, sgp);
    dneg_tile<kD>(p, nrows, v_s, sg, sdn);
    __syncthreads();  // sg and this tile's buffer are free again
    if (p.nbuf == 2)
      buf ^= 1;
    else if (next < n_tiles)
      load_tile<kD>(p, next, sv, scp);
  }

  grid.sync();  // every block's zeroing of d_neg is done
  // each block starts its atomics at its own offset, so that the blocks do
  // not all add into the same rows of d_neg at once
  const int n4 = Ks * D4;
  const int rot = (int)((int64_t)n4 * blockIdx.x / gridDim.x);
  for (int m = tid; m < n4; m += kThreads) {
    const int i = m + rot < n4 ? m + rot : m + rot - n4;
    atomicAdd(reinterpret_cast<float4*>(p.d_neg + i * 4), ld4s(sdn + i * 4));
  }
}

struct Plan {
  int tr, nbuf;
  size_t smem;
};

// The largest tile (64 rows down to 8), double-buffered where it fits,
// whose buffers fit one block's shared memory; false when none does or
// (Ks, D) are not supported (D a multiple of 4).
inline bool plan(int Ks, int D, Plan* pl) {
  if (Ks < 1 || D < 4 || D % 4) return false;
  for (int tr = kMaxTile; tr >= 8; tr /= 2) {
    for (int nbuf = 2; nbuf >= 1; --nbuf) {
      const size_t bytes = sizeof(float) * smem_floats(tr, nbuf, Ks, D);
      if (bytes <= kMaxSmem) {
        *pl = {tr, nbuf, bytes};
        return true;
      }
    }
  }
  return false;
}

// The kernel for D: its D = 64 form on the main path, else the general one.
inline const void* kernel_for(int D) {
  return D == 64 ? (const void*)shared_grads_persistent<64>
                 : (const void*)shared_grads_persistent<0>;
}

// Blocks the card holds at once for (Ks, D): one a SM as a rule, after
// checking that one fits and the device takes cooperative launches.
inline cudaError_t resident_blocks(int device, int Ks, int D, int* blocks) {
  *blocks = 0;
  Plan pl;
  if (!plan(Ks, D, &pl)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel_for(D),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)pl.smem);
  if (err != cudaSuccess) return err;
  int sms = 0, occ = 0, coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel_for(D),
                                                      kThreads, pl.smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms * occ;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block (0 when (Ks, D) are not supported).
size_t sgns_sg_smem_bytes(int Ks, int D) {
  Plan pl;
  return plan(Ks, D, &pl) ? pl.smem : 0;
}

// The grid of a launch over B rows (one block a SM, at most one a tile), or
// minus the cudaError_t that prevents it.
int sgns_sg_grid_size(int device, int B, int Ks, int D) {
  int blocks = 0;
  const cudaError_t err = resident_blocks(device, Ks, D, &blocks);
  if (err != cudaSuccess) return -(int)err;
  Plan pl;
  plan(Ks, D, &pl);
  const int tiles = (B + pl.tr - 1) / pl.tr;
  return tiles < blocks ? tiles : blocks;
}

const char* sgns_sg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// v, cp (B, D); cn (Ks, D); alpha one float on the device; outputs d_src,
// d_pos (B, D) and d_neg (Ks, D), all written by the kernel (D % 4 == 0,
// every pointer on 16 bytes). Returns the launch's cudaError_t (0 when it
// was accepted).
int sgns_shared_grads_launch(int device, const float* v, const float* cp,
                             const float* cn, const float* alpha, int B,
                             int Ks, int D, float kscale, float* dsrc,
                             float* dpos, float* d_neg,
                             void* stream_handle) {
  // the resident blocks of the last (device, Ks, D): the queries cost host
  // time on every call of a host-bound route
  static int last[3] = {-1, 0, 0};
  static int blocks = 0;
  Plan pl;
  if (!plan(Ks, D, &pl)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (last[0] != device || last[1] != Ks || last[2] != D) {
    err = resident_blocks(device, Ks, D, &blocks);
    if (err != cudaSuccess) return (int)err;
    last[0] = device;
    last[1] = Ks;
    last[2] = D;
  }
  Params p = {};
  p.v = v;
  p.cp = cp;
  p.cn = cn;
  p.alpha = alpha;
  p.B = B;
  p.Ks = Ks;
  p.D = D;
  p.kscale = kscale;
  p.tr = pl.tr;
  p.nbuf = pl.nbuf;
  p.kp = (Ks + 7) / 8 * 8;
  p.dsrc = dsrc;
  p.dpos = dpos;
  p.d_neg = d_neg;
  const int tiles = (B + pl.tr - 1) / pl.tr;
  const int grid = tiles < blocks ? tiles : blocks;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel_for(D), dim3(grid),
                                    dim3(kThreads), args,
                                    pl.smem, (cudaStream_t)stream_handle);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
