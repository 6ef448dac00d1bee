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
// adds g_neg^T v into d_neg; loss_rows gets every row's loss.
//
// It is one micro-step of the multiblock kernel on unfolded tables with a
// 2048-row tile, so it runs the same tile (sgns_banded_tile.cuh: the math,
// what bounds it and the two launches) with band = 1 and the band START
// rows in place of band indices. The TPU kept both bands resident in VMEM
// for the whole batch; here both bands (2 x 16392 x 64 x 4 B = 8.4 MB at the
// fused route's band) sit in the 50 MB L2. The band starts stay on the
// device, so the host never reads them back.

#include "sgns_banded_tile.cuh"

extern "C" {

size_t sgns_bf_grads_smem_bytes(int Ks, int D) {
  return sgns_tile::grads_smem_bytes(Ks, D);
}

size_t sgns_bf_scatter_smem_bytes(int Ks, int D) {
  return sgns_tile::scatter_smem_bytes(Ks, D);
}

const char* sgns_bf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One micro-step: B samples in tiles of tb rows (B % tb == 0). sb, db: one
// int32 band START row each; src_l, pos_l: (B,) int32 band-local rows; cn and
// d_neg (Ks, D); alpha: one float; scratch: vbuf, dsrc, dpos (tb, D), gneg
// (tb, Ks); loss_rows (B,). Returns the first cudaError_t of any launch.
int sgns_banded_fused_launch(
    int device, float* wv, float* wc, const int* sb, const int* db,
    const int* src_l, const int* pos_l, const float* cn, const float* alpha,
    int B, int tb, int Ks, int D, float kscale, float* vbuf, float* gneg,
    float* dsrc, float* dpos, float* d_neg, float* loss_rows,
    void* stream_handle) {
  cudaError_t err = sgns_tile::prepare(device, Ks, D);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  for (int row0 = 0; row0 < B; row0 += tb) {
    err = sgns_tile::launch_tile(
        stream, wv, wc, sb, db, src_l + row0, pos_l + row0, cn, alpha, tb, Ks,
        D, /*band=*/1, kscale, vbuf, gneg, dsrc, dpos, d_neg,
        loss_rows + row0);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
