// Banded multiblock SGNS superstep with banded negatives, for Hopper (sm_90a).
//
// Replaces the TPU kernel smore_tpu/ops/pallas_sgns_banded.py
// sgns_banded_multiblock_nb (body _make_multi_kernel_nb): K4's superstep
// (sgns_banded_multiblock.cu) where micro-step s takes its Ks shared
// negatives from its own window of nb2 context rows, starting at row
// nb[s] * nb2. Per micro-step, inside the one cooperative launch of
// sgns_banded_superstep.cuh:
//
//   (a) every block stages cn = Wc[nb[s] * nb2 + negs[s, :]] from the
//       CURRENT table into its shared memory when the step starts;
//   (b) the step's tiles run against that cn, as in K4;
//   (c) beside the last tile's scatters, the step's d_neg is reduced from
//       the kept v and g_neg rows and added into those window rows with
//       atomics, so duplicate negatives sum; a grid barrier follows.
//
// So every gather sees every write of earlier steps (their band scatters and
// their negative deltas), and a step's negative deltas land with its own
// last positive and source scatters, before the next step: the TPU kernel's
// update order. The TPU also staged the window through a third VMEM slab
// and carried conflict flags (conf, confn, ninc, noff, wbi) and a parity
// mask for its 2-row table fold, all to keep two VMEM copies of one HBM row
// from losing writes at write-back; the tables here are plain (Np, D) f32 in
// device memory and L2, and none of that has a counterpart.

#include "sgns_banded_superstep.cuh"

static constexpr int kMode = sgns_ss::kWindow;

extern "C" {

SUPERSTEP_LIBRARY_EXPORTS(sgns_banded_multiblock_nb, kMode)

// One superstep: S micro-steps of B samples, tiles of tb rows (B % tb == 0,
// tb % 8 == 0, D % 4 == 0). Index arrays are int32 and row-major: sb, db,
// nb (S,), src_l, pos_l (S, B), negs_l (S, Ks) window-local. scratch holds
// sgns_banded_multiblock_nb_scratch_floats floats; loss receives the loss
// sum over all S * B rows. Returns the launch's cudaError_t (0 when it was
// accepted).
int sgns_banded_multiblock_nb_launch(
    int device, float* wv, float* wc, const int* sb, const int* db,
    const int* nb, const int* src_l, const int* pos_l, const int* negs_l,
    const float* alpha, int S, int B, int tb, int Ks, int D, int band,
    int nb2, float kscale, float* scratch, float* loss,
    void* stream_handle) {
  sgns_ss::Params p = {};
  p.wv = wv;
  p.wc = wc;
  p.sb = sb;
  p.db = db;
  p.nb = nb;
  p.src = src_l;
  p.pos = pos_l;
  p.negs = negs_l;
  p.alpha = alpha;
  p.S = S;
  p.B = B;
  p.tb = tb;
  p.Ks = Ks;
  p.D = D;
  p.band = band;
  p.nb2 = nb2;
  p.kscale = kscale;
  p.loss = loss;
  return (int)sgns_ss::launch<kMode>(device, p, scratch,
                                     (cudaStream_t)stream_handle);
}

}  // extern "C"
