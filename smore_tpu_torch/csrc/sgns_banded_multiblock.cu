// Banded multiblock SGNS superstep for Hopper (sm_90a).
//
// Replaces the TPU kernel smore_tpu/ops/pallas_sgns_banded.py
// sgns_banded_multiblock (bodies _make_multi_kernel / _make_multi_kernel_db):
// S micro-steps run in order; micro-step s works source band sb[s] of the
// vertex table Wv and context band db[s] of the context table Wc, and its
// batch of B samples is cut into tiles of TB rows that also run in order.
//
// cn (S, Ks, D) is the caller's snapshot of the shared negatives; d_neg is
// applied by the caller after the superstep. Every gather sees the writes of
// earlier tiles and steps; duplicates inside a tile sum.
//
// The whole superstep is ONE cooperative launch of the persistent kernel in
// sgns_banded_superstep.cuh (the math, what bounds it and the design): two
// grid-wide phases per tile, and d_neg of all S steps reduced beside the
// last tile's scatters. The TPU's band slabs, 2-row table fold and 128-lane
// layout existed for VMEM and Mosaic; here the tables are plain (Np, D) f32
// and the L2 does the slab's work.

#include "sgns_banded_superstep.cuh"

static constexpr int kMode = sgns_ss::kSnapshot;

extern "C" {

// Dynamic shared memory of one block (0 when (Ks, D) are not supported).
size_t sgns_mb_smem_bytes(int Ks, int D) {
  return sgns_ss::supported<kMode>(Ks, D) ? sgns_ss::plan<kMode>(Ks, D).smem
                                          : 0;
}

// Floats of the scratch buffer one launch needs.
size_t sgns_mb_scratch_floats(int S, int B, int tb, int Ks, int D) {
  return sgns_ss::scratch_floats(sgns_ss::kept_rows<kMode>(S, B),
                                 sgns_ss::kept_g_rows<kMode>(S, B, Ks, D),
                                 tb, Ks, D);
}

// The grid one launch uses (one block on each SM), or minus the
// cudaError_t that prevents it.
int sgns_mb_grid_size(int device, int Ks, int D) {
  int grid = 0;
  const cudaError_t err = sgns_ss::grid_size<kMode>(device, Ks, D, &grid);
  return err == cudaSuccess ? grid : -(int)err;
}

const char* sgns_mb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One superstep: S micro-steps of B samples, tiles of tb rows (B % tb == 0,
// tb % 8 == 0, D % 4 == 0). Index arrays are int32 and row-major (S, B); cn
// and d_neg are (S, Ks, D); scratch holds sgns_mb_scratch_floats floats;
// loss receives the loss sum over all S * B rows. Returns the launch's
// cudaError_t (0 when it was accepted).
int sgns_banded_multiblock_launch(
    int device, float* wv, float* wc, const int* sb, const int* db,
    const int* src_l, const int* pos_l, const float* cn, const float* alpha,
    int S, int B, int tb, int Ks, int D, int band, float kscale,
    float* scratch, float* d_neg, float* loss, void* stream_handle) {
  sgns_ss::Params p = {};
  p.wv = wv;
  p.wc = wc;
  p.sb = sb;
  p.db = db;
  p.src = src_l;
  p.pos = pos_l;
  p.cn = cn;
  p.alpha = alpha;
  p.S = S;
  p.B = B;
  p.tb = tb;
  p.Ks = Ks;
  p.D = D;
  p.band = band;
  p.kscale = kscale;
  p.d_neg = d_neg;
  p.loss = loss;
  return (int)sgns_ss::launch<kMode>(device, p, scratch,
                                     (cudaStream_t)stream_handle);
}

}  // extern "C"
