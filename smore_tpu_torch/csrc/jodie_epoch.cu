// One JODIE epoch for Hopper (sm_90a): the chronological scan over the
// events in ONE launch.
//
// Replaces the jitted lax.scan of smore_tpu/models/jodie.py (JODIE._epoch_fn,
// its body ``body``); the JAX package has no Pallas kernel there, and the
// port's plain loop (ops/jodie_epoch.py jodie_epoch_ref) issues a few dozen
// small torch ops per event, so an 8,000-event epoch costs seconds of host
// time. Here one thread block of 4 D threads walks the events in order:
//   - thread d < D owns coordinate d of every table row, so the table
//     updates of consecutive events need no synchronisation (the same
//     thread reads what it wrote);
//   - the two dot products (u . i, u . neg) are warp sums of the first D
//     threads, combined through shared memory;
//   - the two RNN cells' products Wh h + Wx[:, :D] x (2 x D outputs, each
//     two dots of length D) take all 4 D threads: thread t computes half
//     (t & 1) of output t >> 1, and a shuffle adds the halves. Wh and
//     Wx[:, :D] of both cells stay in shared memory for the whole epoch,
//     rows padded to D + 1 floats (66 KB at D = 64); the table-free part of
//     the RNN input, Wx[:, D:] [f | dt] + b, comes precomputed per event.
// Three __syncthreads() an event separate the dependent steps. The write
// order is the JAX scan's: ue[u] = u + du, ie[i] = i + di, ie[neg] += dn,
// then ue[u] = new_u, ie[i] = new_i (so dn is overwritten when neg == i),
// then the statics.
//
// What bounds it on the H100: operations, 8 D^2 + O(D) f32 a event (0.28
// GFLOP at T = 8,000, D = 64, 4.2 us at 67 TFLOP/s), but the scan is
// sequential: one block on one SM, and each event waits for the last, so
// its time is the latency of an event's dependent chain (loads of the rows
// from L2, three barriers, a D-long FMA chain), not a rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// region stride and vector offsets padded by 16 floats, so that the two
// halves of a warp (Wh and Wx rows; su and si) sit in different banks
constexpr int kPad = 16;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__host__ __device__ inline int region_floats(int D) {
  return D * (D + 1) + kPad;
}

__host__ __device__ inline int smem_floats(int D) {
  // 4 weight regions, su (+ pad), si, so (2 D), the warp partials
  return 4 * region_floats(D) + (D + kPad) + D + 2 * D + 2 * (D / 32);
}

__global__ void jodie_epoch_scan(
    float* __restrict__ ue, float* __restrict__ ie, float* __restrict__ us,
    float* __restrict__ is, const int* __restrict__ uid,
    const int* __restrict__ iid, const int* __restrict__ negs,
    const float* __restrict__ cu, const float* __restrict__ ci,
    const float* __restrict__ u_wh, const float* __restrict__ u_wx,
    const float* __restrict__ i_wh, const float* __restrict__ i_wx, int T,
    int D, int in_dim, float lr, float bce_lr, float* __restrict__ loss_out) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int rs = region_floats(D);
  float* w = smem;                     // regions: u_wh, u_wx, i_wh, i_wx
  float* su = w + 4 * rs;              // post-BCE user vector
  float* si = su + D + kPad;           // post-BCE item vector
  float* so = si + D;                  // tanh outputs, user then item
  float* red = so + 2 * D;             // warp partials of the two dots
  const int tid = threadIdx.x;
  const int nw = D / 32;

  for (int k = tid; k < D * D; k += blockDim.x) {
    const int r = k / D, c = k - r * D;
    w[0 * rs + r * ld + c] = u_wh[r * D + c];
    w[1 * rs + r * ld + c] = u_wx[(size_t)r * in_dim + c];
    w[2 * rs + r * ld + c] = i_wh[r * D + c];
    w[3 * rs + r * ld + c] = i_wx[(size_t)r * in_dim + c];
  }
  __syncthreads();

  // this thread's product: output o (cell 0 user, 1 item; row), half 0
  // Wh[row] . h (h = su for the user cell, si for the item cell), half 1
  // Wx[row, :D] . x (x = si for the user cell, su for the item cell)
  const int o = tid >> 1, cell = o / D, row = o - cell * D, half = tid & 1;
  const float* wrow = w + (2 * cell + half) * rs + row * ld;
  const float* vec = (cell == half) ? su : si;
  const float* crow = (cell == 0 ? cu : ci) + row;

  const float keep = 1.f - lr, step = 0.1f * lr;
  float loss = 0.f;
  for (int e = 0; e < T; ++e) {
    const int u = uid[e], i = iid[e], n = negs[e];
    const size_t ur = (size_t)u * D + tid, ir = (size_t)i * D + tid,
                 nr = (size_t)n * D + tid;
    float uv = 0.f, iv = 0.f, nv = 0.f;
    if (tid < D) {
      uv = ue[ur];
      iv = ie[ir];
      nv = ie[nr];
      const float a = warp_sum(uv * iv), b = warp_sum(uv * nv);
      if ((tid & 31) == 0) {
        red[tid >> 5] = a;
        red[nw + (tid >> 5)] = b;
      }
    }
    __syncthreads();
    if (tid < D) {
      float sp = 0.f, sn = 0.f;
      for (int k = 0; k < nw; ++k) {
        sp += red[k];
        sn += red[nw + k];
      }
      const float pp = sigmoid(sp), pn = sigmoid(sn);
      if (tid == 0) loss += -logf(pp + 1e-10f) - logf(1.f - pn + 1e-10f);
      const float du = bce_lr * ((1.f - pp) * iv - pn * nv);
      const float di = bce_lr * (1.f - pp) * uv;
      const float dn = -bce_lr * pn * uv;
      uv += du;
      iv += di;
      ue[ur] = uv;
      ie[ir] = iv;
      ie[nr] += dn;
      su[tid] = uv;
      si[tid] = iv;
    }
    __syncthreads();
    float acc = 0.f;
    for (int k = 0; k < D; ++k) acc = fmaf(wrow[k], vec[k], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) so[o] = tanhf(acc + crow[(size_t)e * D]);
    __syncthreads();
    if (tid < D) {
      const float nu = keep * uv + lr * so[tid];
      const float ni = keep * iv + lr * so[D + tid];
      ue[ur] = nu;
      ie[ir] = ni;
      us[ur] += step * (nu - us[ur]);
      is[ir] += step * (ni - is[ir]);
    }
  }
  if (tid == 0) *loss_out = loss;
}

}  // namespace

extern "C" {

const char* jodie_epoch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int jodie_epoch_smem_bytes(int D) { return smem_floats(D) * (int)sizeof(float); }

// ue (U, D), ie (I, D) dynamic and us, is static f32 tables, updated in
// place; uid, iid, negs (T,) int32; cu, ci (T, D) f32; u_wh, i_wh (D, D),
// u_wx, i_wx (D, in_dim) f32 row-major; D a multiple of 32, 4 D <= 1024.
// Writes the summed BCE loss to *loss_sum. Returns the launch's
// cudaError_t.
int jodie_epoch_launch(int device, float* ue, float* ie, float* us, float* is,
                       const int* uid, const int* iid, const int* negs,
                       const float* cu, const float* ci, const float* u_wh,
                       const float* u_wx, const float* i_wh,
                       const float* i_wx, int T, int D, int in_dim, float lr,
                       float bce_lr, float* loss_sum, void* stream_handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D % 32 != 0 || 4 * D > 1024) return (int)cudaErrorInvalidValue;
  const int smem = jodie_epoch_smem_bytes(D);
  err = cudaFuncSetAttribute(jodie_epoch_scan,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  jodie_epoch_scan<<<1, 4 * D, smem, (cudaStream_t)stream_handle>>>(
      ue, ie, us, is, uid, iid, negs, cu, ci, u_wh, u_wx, i_wh, i_wx, T, D,
      in_dim, lr, bce_lr, loss_sum);
  return (int)cudaGetLastError();
}

}  // extern "C"
