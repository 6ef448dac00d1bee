// Fused banded SGNS micro-step for Hopper (sm_90a).
//
// Replaces the TPU kernel smore_tpu/ops/pallas_sgns_banded.py
// sgns_banded_fused (body _make_kernel, mode "full"): one banded micro-step
// of B samples on the source band starting at row *sb of the vertex table
// Wv and the context band starting at row *db of the context table Wc, in
// tiles of TB = min(2048, B) rows that run in order. Each tile gathers
// v = Wv[*sb + src_l] and cp = Wc[*db + pos_l] from the CURRENT tables
// (earlier tiles' writes included), computes the shared-negative SGNS
// gradients against cn, scatter-adds d_src into Wv and d_pos into Wc, and
// adds g_neg^T v into d_neg; loss gets the loss sum over all B rows.
//
// It is K4's superstep with S = 1, a 2048-row tile and band = 1 (the band
// START rows stand where K4 passes band indices), so the whole micro-step
// is ONE cooperative launch of the persistent kernel in
// sgns_banded_superstep.cuh (the math, what bounds it and the design): two
// grid-wide phases per tile, d_neg summed in phase A's registers and added
// beside the last tile's scatters, d_neg and the loss zeroed and summed in
// the kernel. It instantiates the
// kernel's own fused mode, so that K3 and K4 can run in one process. The
// TPU kept both bands resident in VMEM for the whole batch; here both bands
// (2 x 16392 x 64 x 4 B = 8.4 MB at the fused route's band) sit in the
// 50 MB L2. The band starts stay on the device, so the host never reads
// them back.

#include "sgns_banded_superstep.cuh"

static constexpr int kMode = sgns_ss::kFused;

extern "C" {

SUPERSTEP_LIBRARY_EXPORTS(sgns_banded_fused, kMode)

// One micro-step: B samples in tiles of tb rows (B % tb == 0, tb % 8 == 0,
// D % 4 == 0). sb, db: one int32 band START row each; src_l, pos_l: (B,)
// int32 band-local rows; cn and d_neg (Ks, D); alpha: one float; scratch
// holds sgns_banded_fused_scratch_floats(1, B, tb, Ks, D) floats; loss
// receives the loss sum over the B rows. Returns the launch's cudaError_t
// (0 when it was accepted).
int sgns_banded_fused_launch(
    int device, float* wv, float* wc, const int* sb, const int* db,
    const int* src_l, const int* pos_l, const float* cn, const float* alpha,
    int B, int tb, int Ks, int D, float kscale, float* scratch, float* d_neg,
    float* loss, void* stream_handle) {
  sgns_ss::Params p = {};
  p.wv = wv;
  p.wc = wc;
  p.sb = sb;
  p.db = db;
  p.src = src_l;
  p.pos = pos_l;
  p.cn = cn;
  p.alpha = alpha;
  p.S = 1;
  p.B = B;
  p.tb = tb;
  p.Ks = Ks;
  p.D = D;
  p.band = 1;
  p.kscale = kscale;
  p.d_neg = d_neg;
  p.loss = loss;
  return (int)sgns_ss::launch<kMode>(device, p, scratch,
                                     (cudaStream_t)stream_handle);
}

}  // extern "C"
