// One JODIE epoch for Hopper (sm_90a): the chronological scan over the
// events as ONE launch that walks the events' dependency levels.
//
// Replaces the jitted lax.scan of smore_tpu/models/jodie.py (JODIE._epoch_fn,
// its body ``body``); the JAX package has no Pallas kernel there. Per event
// e = (u, i, neg): two dots, the BCE step, the two RNN cells (Wh h + Wx[:,
// :D] x + the table-free part cu / ci, tanh), the statics' step. An event
// reads and writes only row u of the user tables and rows i and neg of the
// item tables, so the host groups the events into levels (csrc/
// jodie_schedule.cpp: level = 1 + the last level of any of its rows). The
// events of one level touch disjoint rows, and each row meets its events in
// time order, so walking the levels in order, the events of a level side by
// side, gives every row exactly the sequential scan's operations.
//
// Design:
//   - A persistent grid of "units", one event of a level each at a time,
//     at most as many as the widest level has events. Between levels the
//     grid's barrier (cooperative launch, cooperative_groups). The barrier
//     of ONE thread-block cluster as the whole grid (barrier.cluster, in
//     hardware) was measured slower on every set (experiments/
//     torch_jodie_levels.py, variant cluster): its 8 units take a wide
//     level in many rounds.
//   - A unit is a cluster of `split` blocks: block r computes output rows
//     [r R, (r + 1) R) of both cells (R = ceil(D / split)) and writes those
//     coordinates of the event's rows. Every block of the cluster reads the
//     whole rows for the dots, so the cluster's barrier (arrive after the
//     reads, wait before the writes) keeps a write from overtaking a read
//     of the same event. The split grows until a block's weights leave
//     room for three blocks an SM, and further while a narrow level would
//     leave SMs idle (up to 8, a portable cluster).
//   - Weights: each block keeps as many of its output rows [Wh | Wx[:, :D]]
//     (2 D floats, padded to a stride of 8 mod 32 floats: conflict-free for
//     8-lane groups) as its shared memory holds; the rest are read from L2.
//     Any D: every loop runs over coordinates and rows with masks.
//   - Products: 8 lanes per output row, two accumulators a lane, a 3-step
//     shuffle sum. f32 on the CUDA cores, no TF32.
//   - Off the dependent chain: the prologue gathers (order[j], uid, iid,
//     negs) into one int4 a slot; a unit loads its next slot and the next
//     level's bounds while the current event computes; cu / ci and the
//     statics' rows are loaded beside the table rows.
//   - Tables written inside the launch are read through L2 (__ldcg): a
//     block's L1 survives the barriers.
//   - The loss: one partial per block, summed in block order after the last
//     barrier (deterministic).
// The write order is the JAX scan's: ie[neg] += dn lands before ie[i] =
// new_i, so dn is overwritten when neg == i.
//
// What bounds it on the H100: operations, 8 D^2 + O(D) f32 an event (21.1
// GFLOP at T = 157,474, D = 128: 0.32 ms at 67 TFLOP/s), but a level costs a
// dependent chain (row loads from L2, three block barriers, the products, a
// level barrier) whatever its width: the levels, not the SMs, bound a set
// whose levels are narrow.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "graph_nodes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;  // lanes per output row in the products
constexpr int kGroups = kThreads / kGroup;
constexpr int kMaxSplit = 8;  // a portable cluster
// the split chosen by default leaves a block's shared memory small enough
// for this many blocks an SM (its 110 registers a thread allow two): on
// the H100, D = 128 on the Wikipedia shape took 13.3 ms an epoch at split
// 4 (248 blocks), 14.8 at split 2 (132 blocks, one an SM)
constexpr int kBlocksPerSM = 3;

struct Params {
  float* ue;
  float* ie;
  float* us;
  float* is;
  const int* uid;
  const int* iid;
  const int* negs;
  const int* order;
  const int* level_ptr;
  const float* cu;
  const float* ci;
  const float* u_wh;
  const float* u_wx;
  const float* i_wh;
  const float* i_wx;
  int4* slots;      // (T,) scratch: (e, u, i, neg) in level order
  float* partials;  // (grid,) scratch, grid <= kMaxSplit * max_width
  float* loss_out;
  int T, L, D, in_dim, split, cached, ld;
  float lr, bce_lr;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the barrier between levels
__device__ __forceinline__ void level_barrier() { cg::this_grid().sync(); }

__host__ __device__ inline int rows_per_block(int D, int split) {
  return (D + split - 1) / split;
}

// shared floats besides the cached weight rows: xin [u' | i' | u'] (3 D),
// ie[neg] + dn (D), the tanh outputs, cu / ci and the statics (2 R each),
// the dot partials
__host__ __device__ inline int vector_floats(int D, int split) {
  return 4 * D + 6 * rows_per_block(D, split) + 2 * kWarps;
}

__host__ __device__ inline int row_stride(int D) {
  return (2 * D + 31) / 32 * 32 + kGroup;
}

__global__ void __launch_bounds__(kThreads, 1)
    jodie_levels(const Params p) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, S = p.split, ld = p.ld, D2 = 2 * D;
  const int R = rows_per_block(D, S);
  const int rank = S > 1 ? (int)cluster_rank() : 0;
  const int r0 = rank * R;
  const int nr = max(0, min(D, r0 + R) - r0);  // rows of each cell here
  const int O = 2 * nr;  // outputs: user rows r0.., then item rows r0..
  const int unit = blockIdx.x / S, units = gridDim.x / S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float* const w = smem;                  // cached output rows
  float* const xin = w + p.cached * ld;   // [u' | i' | u']
  float* const nvn = xin + 3 * D;         // ie[neg] + dn
  float* const so = nvn + D;              // tanh outputs (O)
  float* const cv = so + 2 * R;           // cu, ci slices (O)
  float* const st = cv + 2 * R;           // us[u], is[i] slices (O)
  float* const red = st + 2 * R;          // 2 kWarps dot partials

  // prologue: the slots of the whole epoch and this block's weight rows
  for (int j = blockIdx.x * kThreads + tid; j < p.T;
       j += gridDim.x * kThreads) {
    const int e = __ldg(p.order + j);
    p.slots[j] = make_int4(e, __ldg(p.uid + e), __ldg(p.iid + e),
                           __ldg(p.negs + e));
  }
  const int cached = min(p.cached, O);
  for (int x = tid; x < cached * D2; x += kThreads) {
    const int q = x / D2, k = x - q * D2;
    const int cell = q >= nr, r = r0 + q - cell * nr;
    const float* wh = cell ? p.i_wh : p.u_wh;
    const float* wx = cell ? p.i_wx : p.u_wx;
    w[q * ld + k] = k < D ? __ldg(wh + (size_t)r * D + k)
                          : __ldg(wx + (size_t)r * p.in_dim + (k - D));
  }
  level_barrier();

  const float keep = 1.f - p.lr, step = 0.1f * p.lr, bce = p.bce_lr;
  const int g = tid / kGroup, lk = tid % kGroup;
  float loss = 0.f;
  int lo = __ldg(p.level_ptr), hi = p.L > 0 ? __ldg(p.level_ptr + 1) : 0;
  int pj = lo + unit;  // the prefetched slot
  int4 pf = pj < p.T ? __ldcg(p.slots + pj) : make_int4(0, 0, 0, 0);
  for (int l = 0; l < p.L; ++l) {
    const int hi2 = l + 2 <= p.L ? __ldg(p.level_ptr + l + 2) : hi;
    if (lo + unit >= hi && pj != hi + unit) {  // idle here: the next level
      pj = hi + unit;
      if (pj < p.T) pf = __ldcg(p.slots + pj);
    }
    for (int j = lo + unit; j < hi; j += units) {
      const int4 ev = j == pj ? pf : __ldcg(p.slots + j);
      pj = j + units < hi ? j + units : hi + unit;
      if (pj < p.T) pf = __ldcg(p.slots + pj);
      const int e = ev.x, u = ev.y, i = ev.z, n = ev.w;
      const float* urow = p.ue + (size_t)u * D;
      const float* irow = p.ie + (size_t)i * D;
      const float* nrow = p.ie + (size_t)n * D;
      __syncthreads();  // the last event's reads of the shared vectors

      // 1. the rows, the dots' partials, this block's cu / ci / statics
      float a = 0.f, b = 0.f;
      for (int d = tid; d < D; d += kThreads) {
        const float uv = __ldcg(urow + d), iv = __ldcg(irow + d),
                    nv = __ldcg(nrow + d);
        a = fmaf(uv, iv, a);
        b = fmaf(uv, nv, b);
        xin[d] = uv;
        xin[D + d] = iv;
        nvn[d] = nv;
      }
      // this block's reads of the rows are done: its peers' wait (before
      // their writes) overlaps the rest of this event
      if (S > 1) cluster_arrive();
      for (int q = tid; q < O; q += kThreads) {
        const int cell = q >= nr, r = r0 + q - cell * nr;
        cv[q] = __ldg((cell ? p.ci : p.cu) + (size_t)e * D + r);
        st[q] = __ldcg((cell ? p.is : p.us) +
                       (size_t)(cell ? i : u) * D + r);
      }
      a = warp_sum(a);
      b = warp_sum(b);
      if (lane == 0) {
        red[warp] = a;
        red[kWarps + warp] = b;
      }
      __syncthreads();

      // 2. the BCE step (every block of a cluster alike)
      float sp = 0.f, sn = 0.f;
      for (int k = 0; k < kWarps; ++k) {
        sp += red[k];
        sn += red[kWarps + k];
      }
      const float pp = sigmoid(sp), pn = sigmoid(sn);
      if (tid == 0 && rank == 0)
        loss += -logf(pp + 1e-10f) - logf(1.f - pn + 1e-10f);
      for (int d = tid; d < D; d += kThreads) {
        const float uv = xin[d], iv = xin[D + d], nv = nvn[d];
        const float u2 = uv + bce * ((1.f - pp) * iv - pn * nv);
        const float i2 = iv + bce * (1.f - pp) * uv;
        xin[d] = u2;
        xin[D + d] = i2;
        xin[D2 + d] = u2;
        nvn[d] = nv + -bce * pn * uv;
      }
      __syncthreads();

      // 3. this block's outputs: tanh(W[q] . x + c[q]), x = [u' | i'] for a
      // user row, [i' | u'] for an item row
      for (int qb = 0; qb < O; qb += kGroups) {
        const int q = qb + g;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        if (q < O) {
          const int cell = q >= nr;
          const float* x = xin + cell * D;
          if (q < p.cached) {
            const float* row = w + q * ld;
            int k = lk;
            for (; k + 3 * kGroup < D2; k += 4 * kGroup) {
              a0 = fmaf(row[k], x[k], a0);
              a1 = fmaf(row[k + kGroup], x[k + kGroup], a1);
              a2 = fmaf(row[k + 2 * kGroup], x[k + 2 * kGroup], a2);
              a3 = fmaf(row[k + 3 * kGroup], x[k + 3 * kGroup], a3);
            }
            for (; k < D2; k += kGroup) a0 = fmaf(row[k], x[k], a0);
          } else {
            const int r = r0 + q - cell * nr;
            const float* wh = (cell ? p.i_wh : p.u_wh) + (size_t)r * D;
            const float* wx = (cell ? p.i_wx : p.u_wx) + (size_t)r * p.in_dim;
            for (int k = lk; k < D; k += kGroup)
              a0 = fmaf(__ldg(wh + k), x[k], a0);
            for (int k = lk; k < D; k += kGroup)
              a1 = fmaf(__ldg(wx + k), x[D + k], a1);
          }
        }
        float acc = (a0 + a1) + (a2 + a3);
        acc += __shfl_xor_sync(0xffffffffu, acc, 4);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (q < O && lk == 0) so[q] = tanhf(acc + cv[q]);
      }
      if (S > 1) cluster_wait();  // every block's reads of the rows are done
      __syncthreads();

      // 4. this block's coordinates of the event's rows
      float* uw = p.ue + (size_t)u * D;
      float* iw = p.ie + (size_t)i * D;
      float* nw = p.ie + (size_t)n * D;
      float* usw = p.us + (size_t)u * D;
      float* isw = p.is + (size_t)i * D;
      for (int q = tid; q < nr; q += kThreads) {
        const int d = r0 + q;
        const float nu = keep * xin[d] + p.lr * so[q];
        const float ni = keep * xin[D + d] + p.lr * so[nr + q];
        uw[d] = nu;
        if (n != i) nw[d] = nvn[d];
        iw[d] = ni;
        usw[d] = st[q] + step * (nu - st[q]);
        isw[d] = st[nr + q] + step * (ni - st[nr + q]);
      }
    }
    level_barrier();
    lo = hi;
    hi = hi2;
  }

  if (tid == 0) p.partials[blockIdx.x] = loss;
  level_barrier();
  if (blockIdx.x == 0 && tid == 0) {
    float s = 0.f;
    for (int k = 0; k < (int)gridDim.x; ++k) s += __ldcg(p.partials + k);
    *p.loss_out = s;
  }
}

struct Plan {
  int grid, split, cached, ld, smem;
};

const void* const kKernel = (const void*)jodie_levels;

// Sets the kernel's shared-memory limit to the plan's (a launch needs it,
// and so do the occupancy queries).
cudaError_t set_smem(const Plan& pl) {
  return cudaFuncSetAttribute(kKernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              pl.smem);
}

// How many units of pl.split blocks the card holds at once.
cudaError_t resident_units(int device, const Plan& pl, int* units) {
  cudaError_t err = set_smem(pl);
  if (err != cudaSuccess) return err;
  if (pl.split == 1) {
    int occ = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kKernel, kThreads, pl.smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    *units = occ * sms;
    return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = pl.split;
  at.val.clusterDim.y = 1;
  at.val.clusterDim.z = 1;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(units, kKernel, &cfg);
}

// The launch's shape: the split (the least power of two up to kMaxSplit
// whose slice of both cells' weights fits a kBlocksPerSM-th of an SM's
// shared memory, raised while the widest level's units leave SMs idle),
// the cached rows, the grid (units, at most the widest level and what the
// card holds at once).
cudaError_t make_plan(int device, int D, int max_width, Plan* pl) {
  int optin = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int floats = optin / (int)sizeof(float);
  const int ld = row_stride(D);
  const int width = max_width > 1 ? max_width : 1;
  int split = 1;
  while (split < kMaxSplit &&
         (2 * rows_per_block(D, split) * ld + vector_floats(D, split) >
              floats / kBlocksPerSM ||
          2 * split * width <= sms))
    split *= 2;
  if (vector_floats(D, split) > floats) return cudaErrorInvalidValue;
  pl->split = split;
  pl->ld = ld;
  const int rows = 2 * rows_per_block(D, split);
  const int fit = (floats - vector_floats(D, split)) / ld;
  pl->cached = rows < fit ? rows : fit;
  pl->smem = (pl->cached * ld + vector_floats(D, split)) * (int)sizeof(float);
  int units = 0;
  err = resident_units(device, *pl, &units);
  if (err != cudaSuccess) return err;
  if (units < 1) return cudaErrorCooperativeLaunchTooLarge;
  pl->grid = (width < units ? width : units) * split;
  return cudaSuccess;
}

}  // namespace

extern "C" {

KERNEL_LIBRARY_EXPORTS(jodie_epoch, kKernel)

// The launch's plan for (D, the widest level): out = {grid blocks, split,
// cached weight rows of a block, shared bytes of a block}. Returns a
// cudaError_t.
int jodie_epoch_plan(int device, int D, int max_width, int* out) {
  Plan pl;
  const cudaError_t err = make_plan(device, D, max_width, &pl);
  if (err != cudaSuccess) return (int)err;
  out[0] = pl.grid;
  out[1] = pl.split;
  out[2] = pl.cached;
  out[3] = pl.smem;
  return 0;
}

// ue (U, D), ie (I, D) dynamic and us, is static f32 tables, updated in
// place; uid, iid, negs (T,) int32; order (T,) and level_ptr (L + 1,) int32,
// the levels of csrc/jodie_schedule.cpp, max_width the widest; cu, ci (T, D)
// f32; u_wh, i_wh (D, D), u_wx, i_wx (D, in_dim) f32 row-major; slots (T,)
// int4 and partials (kMaxSplit * max_width,) f32 scratch. Writes the summed
// BCE loss to *loss_sum. Returns the launch's cudaError_t.
int jodie_epoch_launch(int device, float* ue, float* ie, float* us, float* is,
                       const int* uid, const int* iid, const int* negs,
                       const int* order, const int* level_ptr,
                       const float* cu, const float* ci, const float* u_wh,
                       const float* u_wx, const float* i_wh,
                       const float* i_wx, void* slots, float* partials,
                       int T, int L, int max_width, int D, int in_dim,
                       float lr, float bce_lr, float* loss_sum,
                       void* stream_handle) {
  // the plan of the last (device, D, max_width): the queries cost host time
  // on every call
  static int last[3] = {-1, 0, 0};
  static Plan pl;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (last[0] != device || last[1] != D || last[2] != max_width) {
    last[0] = -1;
    err = make_plan(device, D, max_width, &pl);
    if (err != cudaSuccess) return (int)err;
    last[0] = device;
    last[1] = D;
    last[2] = max_width;
  }
  // jodie_epoch_plan may have set another limit since the plan was made
  err = set_smem(pl);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.ue = ue;
  p.ie = ie;
  p.us = us;
  p.is = is;
  p.uid = uid;
  p.iid = iid;
  p.negs = negs;
  p.order = order;
  p.level_ptr = level_ptr;
  p.cu = cu;
  p.ci = ci;
  p.u_wh = u_wh;
  p.u_wx = u_wx;
  p.i_wh = i_wh;
  p.i_wx = i_wx;
  p.slots = (int4*)slots;
  p.partials = partials;
  p.loss_out = loss_sum;
  p.T = T;
  p.L = L;
  p.D = D;
  p.in_dim = in_dim;
  p.split = pl.split;
  p.cached = pl.cached;
  p.ld = pl.ld;
  p.lr = lr;
  p.bce_lr = bce_lr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = (cudaStream_t)stream_handle;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeCooperative;
  at[0].val.cooperative = 1;
  at[1].id = cudaLaunchAttributeClusterDimension;
  at[1].val.clusterDim.x = pl.split;
  at[1].val.clusterDim.y = 1;
  at[1].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = pl.split > 1 ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, jodie_levels, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
