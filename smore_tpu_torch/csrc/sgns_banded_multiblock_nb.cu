// Banded multiblock SGNS superstep with banded negatives, for Hopper (sm_90a).
//
// Replaces the TPU kernel smore_tpu/ops/pallas_sgns_banded.py
// sgns_banded_multiblock_nb (body _make_multi_kernel_nb): K4's superstep
// (sgns_banded_multiblock.cu) where micro-step s takes its Ks shared
// negatives from its own window of nb2 context rows, starting at row
// nb[s] * nb2. Per micro-step, in stream order:
//
//   (a) nb_gather: cn = Wc[nb[s] * nb2 + negs[s, :]] from the CURRENT table,
//       and d_neg = 0;
//   (b) the step's tiles, as in K4 (sgns_banded_tile.cuh), against that cn,
//       accumulating d_neg;
//   (c) nb_scatter: Wc[nb[s] * nb2 + negs[s, j]] += d_neg[j] with atomicAdd,
//       so duplicate negatives sum.
//
// So every gather sees every write of earlier steps (their band scatters and
// their negative deltas), and a step's negative deltas land after its own
// positive and source scatters: the TPU kernel's update order. The TPU also
// staged the window through a third VMEM slab and carried conflict flags
// (conf, confn, ninc, noff, wbi) and a parity mask for its 2-row table fold,
// all to keep two VMEM copies of one HBM row from losing writes at
// write-back; the tables here are plain (Np, D) f32 in device memory and L2,
// and none of that has a counterpart.
//
// What bounds it: K4's tile (row gathers and atomics into L2-resident bands,
// and the launch rate). (a) and (c) move Ks rows each (32 KB at Ks = 128,
// D = 64): one thread per element, Ks * D / 256 blocks. That is six launches
// per micro-step at B = 2048; folding (a) and (c) into the tile kernels is
// later work.

#include "sgns_banded_tile.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) nb_gather(
    const float* __restrict__ wc, const int* __restrict__ nb,
    const int* __restrict__ negs, int Ks, int D, int nb2,
    float* __restrict__ cn, float* __restrict__ d_neg) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= Ks * D) return;
  const int64_t row = (int64_t)(*nb) * nb2 + negs[i / D];
  cn[i] = wc[row * D + i % D];
  d_neg[i] = 0.f;
}

__global__ void __launch_bounds__(kThreads) nb_scatter(
    float* __restrict__ wc, const int* __restrict__ nb,
    const int* __restrict__ negs, int Ks, int D, int nb2,
    const float* __restrict__ d_neg) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= Ks * D) return;
  const int64_t row = (int64_t)(*nb) * nb2 + negs[i / D];
  atomicAdd(wc + row * D + i % D, d_neg[i]);
}

}  // namespace

extern "C" {

size_t sgns_nb_grads_smem_bytes(int Ks, int D) {
  return sgns_tile::grads_smem_bytes(Ks, D);
}

size_t sgns_nb_scatter_smem_bytes(int Ks, int D) {
  return sgns_tile::scatter_smem_bytes(Ks, D);
}

const char* sgns_nb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One superstep: S micro-steps of B samples, tiles of tb rows (B % tb == 0).
// Index arrays are int32 and row-major: sb, db, nb (S,), src_l, pos_l (S, B),
// negs_l (S, Ks) window-local. Scratch: cn, d_neg (Ks, D), reused step after
// step; vbuf, dsrc, dpos (tb, D), gneg (tb, Ks); loss_rows (S, B).
// Returns the first cudaError_t of any launch (0 when all were accepted).
int sgns_banded_multiblock_nb_launch(
    int device, float* wv, float* wc, const int* sb, const int* db,
    const int* nb, const int* src_l, const int* pos_l, const int* negs_l,
    const float* alpha, int S, int B, int tb, int Ks, int D, int band,
    int nb2, float kscale, float* cn, float* vbuf, float* gneg, float* dsrc,
    float* dpos, float* d_neg, float* loss_rows, void* stream_handle) {
  cudaError_t err = sgns_tile::prepare(device, Ks, D);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  const int blocks = (Ks * D + kThreads - 1) / kThreads;
  for (int s = 0; s < S; ++s) {
    const int* negs = negs_l + (size_t)s * Ks;
    nb_gather<<<blocks, kThreads, 0, stream>>>(wc, nb + s, negs, Ks, D, nb2,
                                               cn, d_neg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int row0 = 0; row0 < B; row0 += tb) {
      const size_t off = (size_t)s * B + row0;
      err = sgns_tile::launch_tile(
          stream, wv, wc, sb + s, db + s, src_l + off, pos_l + off, cn,
          alpha + s, tb, Ks, D, band, kscale, vbuf, gneg, dsrc, dpos, d_neg,
          loss_rows + off);
      if (err != cudaSuccess) return (int)err;
    }
    nb_scatter<<<blocks, kThreads, 0, stream>>>(wc, nb + s, negs, Ks, D, nb2,
                                                d_neg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
