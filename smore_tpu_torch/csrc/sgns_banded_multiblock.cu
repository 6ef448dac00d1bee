// Banded multiblock SGNS superstep for Hopper (sm_90a).
//
// Replaces the TPU kernel smore_tpu/ops/pallas_sgns_banded.py
// sgns_banded_multiblock (bodies _make_multi_kernel / _make_multi_kernel_db):
// S micro-steps run in order; micro-step s works source band sb[s] of the
// vertex table Wv and context band db[s] of the context table Wc, and its
// batch of B samples is cut into tiles of TB rows that also run in order.
// Each tile is one banded SGNS tile (sgns_banded_tile.cuh: the math, what
// bounds it and the two launches).
//
// cn (S, Ks, D) is the caller's snapshot of the shared negatives; d_neg is
// applied by the caller after the superstep. Every gather sees the writes of
// earlier tiles and steps; duplicates inside a tile sum.
//
// The TPU's band slabs, 2-row table fold and 128-lane layout existed for
// VMEM and Mosaic; here the tables are plain (Np, D) f32 and the L2 does the
// slab's work. The host loop below launches A then B per tile and per
// micro-step on the caller's stream: stream order gives the TPU kernel's
// tile-serial and step-serial update order.

#include "sgns_banded_tile.cuh"

extern "C" {

size_t sgns_mb_grads_smem_bytes(int Ks, int D) {
  return sgns_tile::grads_smem_bytes(Ks, D);
}

size_t sgns_mb_scatter_smem_bytes(int Ks, int D) {
  return sgns_tile::scatter_smem_bytes(Ks, D);
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
  cudaError_t err = sgns_tile::prepare(device, Ks, D);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  for (int s = 0; s < S; ++s) {
    for (int row0 = 0; row0 < B; row0 += tb) {
      const size_t off = (size_t)s * B + row0;
      err = sgns_tile::launch_tile(
          stream, wv, wc, sb + s, db + s, src_l + off, pos_l + off,
          cn + (size_t)s * Ks * D, alpha + s, tb, Ks, D, band, kscale, vbuf,
          gneg, dsrc, dpos, d_neg + (size_t)s * Ks * D, loss_rows + off);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

}  // extern "C"
