// K1, K2, K3 (the unshadowed soft train path) and the cross-block gradient
// reduction, for Hopper (sm_90a).
//
// Replaces rtwc_tpu/render/pallas_soft.py:
//   K1 `_soft_fwd_body` (pl.pallas_call at :2434): online softmin over the
//      tile's sphere list and every live plane, seeded with the background;
//      writes the 10 planes (rgb, depth, normal, alpha, m, s) and the gates;
//   K2 `_soft_bwd_body` (:2476): closed-form softmax VJP from the saved m / s,
//      object replay gated by K1's gates, per-object gradients, raygen VJP;
//   K3 the unshadowed branch of `_soft_mse_fused_body` (:2526): K1's rgb
//      sweep, masked MSE, its cotangents and K2's sweep in one pass;
//   D3 `_twofloat_plane_sum` (tests/test_pallas_soft.py:283) becomes the
//      two-float block sums here plus the reduction `rtwc_soft_grad_reduce`.
// The plain torch versions are in render/soft_kernel.py; the device
// functions and hand-written adjoints in soft_common.cuh; the block sums
// and the forward and backward sweeps in soft_block.cuh.
//
// Design. One thread per pixel, one block per broad-phase tile (bh x bw
// pixels, threadIdx.x along the width), as K7. K1 and K3 copy their tile's
// list row and the listed spheres into shared memory at block start
// (stage_lists), K2 reads them through __ldg with a block-uniform index (a
// broadcast); the plane table is staged in shared memory. Culling is
// block-uniform, like JAX's per-tile `jnp.max(...) > -16`: each thread tests
// its pixel against the running max and __syncthreads_or decides for the
// block. K1 writes that decision into the gate table, K2 reads it for the
// same tile, K3 keeps it in shared memory between its two sweeps.
//
// The TPU grid runs tiles in order and adds into shared tables; blocks here
// run at once. So K2 and K3 write per-block partials and never add into a
// global table: one row of 7 sphere gradients per list entry (keyed by list
// slot, compact), [T, NP, 12] plane rows, and two-float (hi, lo) pairs for
// the camera position and basis cotangents and the loss. Within a block,
// sums are warp butterflies (__shfl_down_sync) and then the warps' sums in
// warp order (csrc/soft_block.cuh). The reduction below sums the partials
// (and the shadow-list entries that the shadowed kernels of
// csrc/soft_shadow.cu write) in a fixed order. No float atomics anywhere:
// the tables are bit-equal from launch to launch.
//
// What bounds it. Per pixel, K1 does O(list + planes) object evaluations
// (two transcendentals each in the penalties plus an exp per softmin step),
// K2 and K3 a forward replay and a hand-written adjoint per gated object,
// and a few dozen shuffles per gated object per block for the sums. Stores
// are 40 B per pixel (K1); K2 reads 68 B per pixel (9 saved planes, alpha
// unread, and 8 cotangent planes), i.e. 84 / 142 MB at 1080p: about 25 /
// 42 us at 3.35 TB/s. A 16x16 tile of the train path gates less than one
// object a sweep on average, so K2 and K3 are bound by what every block does
// once and by latency. Both run the backward sweep of csrc/soft_block.cuh
// (backward_sweep_slab): a gated object's per-warp sums wait in a
// shared-memory slab, summed once a sweep; the camera's two-float sum runs
// on 12 / 13 threads at once; what the sweep re-reads waits in a per-thread
// shared-memory stash, so that 3 (K3) or 4 (K2) blocks fit an SM.
//
// Float semantics follow the plain versions op for op; compiled with
// -fmad=false (see soft_common.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "soft_block.cuh"

using namespace soft;

// Mirror: ReduceParams in render/soft_core.py, whose reduce_params() sets
// the sizes below.
// The entry tables hold a capacity of entries each (n_entries main,
// n_sh_entries shadow); how many are real, the kernels read from device
// memory (`ncnt` [2]: main, shadow), so the host never waits for them. The
// grids and workspaces are sized for the capacities, and the blocks past the
// real counts exit.
struct ReduceParams {
  int ns, np, n_entries, n_tiles, ntf, device;
  int n_sh_entries;  // shadow-list capacity (K5, K6); 0 otherwise
  int n_wc;          // warp chunks at most: min(RED_WARP_CHUNKS, ceil(capacities / 256))
  int tch;           // tiles a first-pass plane or camera block sums, a multiple of 8
  int n_tchunks;     // tile chunks: ceil(n_tiles / tch), at least 1
  int n_schunks;     // sphere chunks at most: ceil(capacities / RED_CHUNK) + 2 ns, at least 1
};

// About this many warps count and scatter the sphere keys: each takes
// wc_keys of the real entries, the least multiple of 256 (8 rounds of 32)
// that keeps the warps at most this many. The sphere sums' blocks loop over
// the chunks, RED_SPHERE_BLOCKS blocks at most.
constexpr int RED_WARP_CHUNKS = 2048, RED_SPHERE_BLOCKS = 2048;

namespace {

// K1's sweep (also K3's forward): the online softmin over forward_sweep's
// objects, accumulating the first NACC of (rgb, t_clip, normal).
template <int NACC>
__device__ __forceinline__ void softmin_sweep(const SoftParams& p, const float* __restrict__ cam,
                                              const StagedList& list, const float* s_pl,
                                              int* gate_row, Vec3 d, Vec3 o, float* m, float* s,
                                              float acc[NACC]) {
  forward_sweep(p, cam, list, s_pl, gate_row, d, o, m,
                [&](const Geo& g, const float* col, Vec3 sn) {
                  accumulate<NACC>(p, obj_out(p, g, col, sn, d), m, s, acc);
                });
}

// The staged list row and its spheres (stage_lists) of K1 and K3: list_stride
// ints, then STAGED (list_stride - 1) floats.
inline size_t staged_row_smem(int list_stride) {
  return sizeof(int) * (size_t)list_stride + sizeof(float) * STAGED * (size_t)(list_stride - 1);
}

}  // namespace

// Blocks an SM that K1 is built for: 8, at most 32 registers a thread (24 B
// of spill stores). On an H100 at 1080p it took 0.0507-0.0512 ms at 8
// blocks, 0.0528 at 6 (40 registers), 0.0527-0.0529 at 5 (48, no spill;
// the parent's register budget), 0.0566 at 4 (PERF.md section 6).
constexpr int K1_MIN_BLOCKS = 8;

// K1: the softmin sweep on the tile's list row and spheres, staged in shared
// memory at block start (stage_lists), then the 10 planes.
__global__ void __launch_bounds__(MAX_THREADS, K1_MIN_BLOCKS)
soft_fwd_kernel(SoftParams p, const float* __restrict__ cam, const float* __restrict__ sph,
                const float* __restrict__ pl_g, const int* __restrict__ lists,
                float* __restrict__ out, int* __restrict__ gates) {
  extern __shared__ float s_pl[];  // [12, NP] planes, then the staged row (staged_row_smem)
  int* s_lst = reinterpret_cast<int*>(s_pl + PL_ROWS * p.np);
  float* s_sph = reinterpret_cast<float*>(s_lst + p.list_stride);
  const int tile = blockIdx.y * (p.wp / p.bw) + blockIdx.x;
  stage_lists<false>(p, sph, lists + (size_t)tile * p.list_stride, nullptr, s_lst, s_sph);
  stage_planes(p, pl_g, s_pl);  // its barrier publishes the list too
  const Ray r = block_ray(p, cam);
  const Vec3 o = {__ldg(cam + C_POSX), __ldg(cam + C_POSY), __ldg(cam + C_POSZ)};
  float m = p.bg_logit, s = 1.0f;
  float acc[7] = {0.0f, 0.0f, 0.0f, p.far, 0.0f, 0.0f, 0.0f};
  softmin_sweep<7>(p, cam, StagedList{s_lst, s_sph, p.list_stride - 1}, s_pl,
                   gates + (size_t)tile * 2 * (p.ns + p.np), r.d, o, &m, &s, acc);
  const float inv_s = 1.0f / s;
  const size_t plane = (size_t)p.hp * p.wp;
  const size_t pix = (size_t)(blockIdx.y * p.bh + threadIdx.y) * p.wp + blockIdx.x * p.bw +
                     threadIdx.x;
  for (int i = 0; i < 7; ++i) out[i * plane + pix] = acc[i] * inv_s;
  out[SO_ALPHA * plane + pix] = 1.0f - expf(p.bg_logit - m) * inv_s;
  out[SO_M * plane + pix] = m;
  out[SO_S * plane + pix] = s;
}

// Blocks an SM that K2 is built for: 4, at most 64 registers a thread. It
// spills 108 B there and is the fastest of 2 to 5 blocks on an H100 at 1080p
// (PERF.md section 6): 0.142 ms at 4 (64 registers), 0.151 at 3 (80, 8 B of
// spill stores), 0.185 at 2 (96, no spill), 0.164-0.188 at 5 (48, 268 B).
constexpr int K2_MIN_BLOCKS = 4;

// K2: the backward sweep of K3, K5 and K6 (backward_sweep_slab) unshaded,
// against K1's saved m and s: the per-object sums wait in the slab, the
// camera's go through block_tf_rows, and what the sweep re-reads (m, 1/s,
// S, the seven output cotangents, the ray cotangents and the camera sum's
// ray terms) waits in the stash, not in registers.
__global__ void __launch_bounds__(MAX_THREADS, K2_MIN_BLOCKS)
soft_bwd_kernel(SoftParams p, const float* __restrict__ cam, const float* __restrict__ sph,
                const float* __restrict__ pl_g, const int* __restrict__ lists,
                const int* __restrict__ offsets, const int* __restrict__ gates,
                const float* __restrict__ sav, const float* __restrict__ g,
                float* __restrict__ pvals, float* __restrict__ ppl, float* __restrict__ ptf) {
  extern __shared__ float s_pl[];  // [12, NP] planes, then the stash [ST_FIELDS, MAX_THREADS]
  __shared__ Reduce sm;
  __shared__ Slab sb;
  stage_planes(p, pl_g, s_pl);
  const int tile = blockIdx.y * (p.wp / p.bw) + blockIdx.x;
  const Stash st(s_pl + PL_ROWS * p.np);
  const Vec3 d = stash_ray(block_ray(p, cam), st);
  const Vec3 o = {__ldg(cam + C_POSX), __ldg(cam + C_POSY), __ldg(cam + C_POSZ)};
  const size_t plane = (size_t)p.hp * p.wp;
  const size_t pix = (size_t)(blockIdx.y * p.bh + threadIdx.y) * p.wp + blockIdx.x * p.bw +
                     threadIdx.x;
  const float m = sav[SO_M * plane + pix];
  const float inv_s = 1.0f / sav[SO_S * plane + pix];
  const float w_bg = expf(p.bg_logit - m) * inv_s;
  float gv[7];
  for (int i = 0; i < 7; ++i) gv[i] = g[i * plane + pix];
  float S = gv[0] * sav[pix];
  for (int i = 1; i < 7; ++i) S = S + gv[i] * sav[i * plane + pix];
  S = S - g[SO_ALPHA * plane + pix] * w_bg;
  st.put(ST_M, m);
  st.put(ST_INV_S, inv_s);
  st.put(ST_S, S);
  for (int i = 0; i < 7; ++i) st.put(ST_GV + i, gv[i]);
  for (int i = 0; i < 3; ++i) {
    st.put(ST_GD + i, 0.0f);
    st.put(ST_GO + i, 0.0f);
  }
  backward_sweep_slab<12, false>(p, cam, sph, s_pl, lists + (size_t)tile * p.list_stride,
                                 gates + (size_t)tile * 2 * (p.ns + p.np), tile,
                                 __ldg(offsets + tile), d, o, 1.0f, st, &sm, &sb, pvals, ppl,
                                 ptf);
}

// Blocks an SM that K3 is built for: 3, at most 80 registers a thread. It
// spills 60 B there (107 registers and no spill at 2) and is 12 % faster on
// an H100 at 1080p (PERF.md section 6): the third block hides more latency
// than the spilled stores cost.
constexpr int K3_MIN_BLOCKS = 3;

// K3: K1's rgb sweep, the masked MSE and its cotangents, then the backward
// sweep of K5 and K6 (backward_sweep_slab) unshaded: the per-object sums
// wait in the slab, the camera's and the loss's go through block_tf_rows,
// and the per-pixel values the sweep re-reads wait in the stash.
__global__ void __launch_bounds__(MAX_THREADS, K3_MIN_BLOCKS)
soft_mse_kernel(SoftParams p, const float* __restrict__ cam, const float* __restrict__ sph,
                const float* __restrict__ pl_g, const int* __restrict__ lists,
                const int* __restrict__ offsets, const float* __restrict__ tgt,
                float* __restrict__ pvals, float* __restrict__ ppl, float* __restrict__ ptf) {
  // [12, NP] floats, NS + NP gate ints, the staged row (staged_row_smem),
  // then the stash [ST_FIELDS, MAX_THREADS]
  extern __shared__ float s_pl[];
  __shared__ Reduce sm;
  __shared__ Slab sb;
  int* s_gate = reinterpret_cast<int*>(s_pl + PL_ROWS * p.np);
  int* s_lst = s_gate + p.ns + p.np;
  float* s_sph = reinterpret_cast<float*>(s_lst + p.list_stride);
  const Stash st(s_sph + STAGED * (p.list_stride - 1));
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int e = tid; e < p.ns + p.np; e += blockDim.x * blockDim.y) s_gate[e] = 0;
  const int tile = blockIdx.y * (p.wp / p.bw) + blockIdx.x;
  const int* lst = lists + (size_t)tile * p.list_stride;
  stage_lists<false>(p, sph, lst, nullptr, s_lst, s_sph);
  stage_planes(p, pl_g, s_pl);  // its barrier publishes the list too
  const Ray r = block_ray(p, cam);
  const Vec3 o = {__ldg(cam + C_POSX), __ldg(cam + C_POSY), __ldg(cam + C_POSZ)};
  float m = p.bg_logit, s = 1.0f;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  softmin_sweep<3>(p, cam, StagedList{s_lst, s_sph, p.list_stride - 1}, s_pl, s_gate, r.d, o,
                   &m, &s, acc);
  __syncthreads();  // the gates, written by thread 0, are read by all below
  const Vec3 d = stash_ray(r, st);
  const float inv_s = 1.0f / s;
  const size_t plane = (size_t)p.hp * p.wp;
  const int row = blockIdx.y * p.bh + threadIdx.y, col = blockIdx.x * p.bw + threadIdx.x;
  const size_t pix = (size_t)row * p.wp + col;
  const float mask = (row < p.loss_h && col < p.loss_w) ? 1.0f : 0.0f;
  float out[3], diff[3], gv[3];
  for (int c = 0; c < 3; ++c) {
    out[c] = acc[c] * inv_s;
    diff[c] = (out[c] - tgt[c * plane + pix]) * mask;
    gv[c] = p.loss_scale * diff[c];
  }
  st.put(ST_M, m);
  st.put(ST_INV_S, inv_s);
  st.put(ST_S, gv[0] * out[0] + gv[1] * out[1] + gv[2] * out[2]);
  for (int i = 0; i < 7; ++i) st.put(ST_GV + i, i < 3 ? gv[i] : 0.0f);
  for (int i = 0; i < 3; ++i) {
    st.put(ST_GD + i, 0.0f);
    st.put(ST_GO + i, 0.0f);
  }
  st.put(ST_LOSS, diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]);
  backward_sweep_slab<13, false>(p, cam, sph, s_pl, lst, s_gate, tile, __ldg(offsets + tile), d,
                                 o, 1.0f, st, &sm, &sb, pvals, ppl, ptf);
}

// ---- D3, the gradient reduction ------------------------------------------
//
// Sums the kernels' per-block partials into dsph [8, NS], dpl [12, NP] and
// the two-float camera and loss pairs [NTF, 2], in a fixed order, with no
// float atomics: two launches give the same bits, and soft_grad_reduce_plain
// (render/soft_kernel.py) gives them too. Five launches on one stream:
//  1 count: each warp counts the sphere keys of wc_keys entries (key k for
//    a main-list entry of sphere k, NS + k for a shadow-list one) in its
//    own shared histogram (integer shared atomics), and its block adds its
//    8 warps' counts; the other blocks sum tch tiles of the plane rows or of
//    the camera pairs each (the first pass of those tables);
//  2 prefix: one warp a key scans its counting blocks' counts: each block's
//    first position within the key, and the key's total;
//  3 scatter: each block scans the keys' totals into the keys' segments
//    (and their chunks of RED_CHUNK entries, which block 0 writes out);
//    each warp writes the sorted position of its entries after its key's
//    segment start, its block's position and its block's earlier warps'
//    counts, ranked within a round by __match_any_sync: a stable counting
//    sort, tile order within a key;
//  4 spheres: one block a chunk of a key's sorted entries, one entry a
//    thread, each entry's values read once, summed in soft_core.py
//    `block_sum_plain`'s order;
//  5 final: one warp a sphere, a plane column or a camera slot sums the
//    first passes' chunks, lane l chunks l, l + 32, ..., then a butterfly;
//    a sphere's rows 0-3 add its shadow chunks' sum to its main chunks'.
// What bounds it: each input is read once (the keys twice), about 1 MB at
// 1080p and 17 MB at 4K / 200 spheres, 0.3-5 us at 3.35 TB/s; the five
// dependent launches and the ranking of 3.8e5 keys at 4K set its time. The
// counting blocks and the first passes put hundreds of blocks on the card
// at 4K and at 1080p, where one block a sphere, plane and slot put 35.
constexpr int RED_THREADS = 256, RED_WARPS = RED_THREADS / 32;
constexpr int RED_CHUNK = RED_THREADS;  // sorted entries a sphere block sums
constexpr int COL_GROUP = 128;          // plane columns a first-pass block sums
constexpr int KEY_BATCH = 8;            // rounds of 32 keys whose loads a warp starts at once

// The real entries, main then shadow, are numbered 0 .. nm + nsh - 1: entry
// i < nm is main-list entry i, the others shadow-list entry i - nm.
struct RealCounts {
  int nm, n;          // main entries, all entries
  int wc_keys;        // keys a warp counts and scatters
  int n_wc, n_count;  // warp chunks (at most rp.n_wc) and counting blocks that hold them
};

__device__ __forceinline__ RealCounts real_counts(const int* __restrict__ ncnt) {
  RealCounts c;
  c.nm = __ldg(ncnt);
  c.n = c.nm + __ldg(ncnt + 1);
  c.wc_keys = 256 * max(1, (c.n + 256 * RED_WARP_CHUNKS - 1) / (256 * RED_WARP_CHUNKS));
  c.n_wc = (c.n + c.wc_keys - 1) / c.wc_keys;
  c.n_count = (c.n_wc + 7) / 8;  // RED_WARPS warp chunks a counting block
  return c;
}

__device__ __forceinline__ int red_key(const ReduceParams& rp, int nm,
                                       const int* __restrict__ pidx,
                                       const int* __restrict__ pshidx, int i) {
  const bool main = i < nm;
  const int k = main ? __ldg(pidx + i) : __ldg(pshidx + (i - nm));
  return (k >= 0 && k < rp.ns) ? (main ? k : rp.ns + k) : -1;  // out of range: dropped
}

// Warp chunk wc's keys in rounds of 32, in order; round(key, i) runs on
// every lane, key -1 where entry i is past the chunk or its sphere index
// out of range, then the warp syncs.
template <typename Round>
__device__ __forceinline__ void warp_key_rounds(const ReduceParams& rp, const RealCounts& rc,
                                                const int* __restrict__ pidx,
                                                const int* __restrict__ pshidx, int wc,
                                                Round&& round) {
  const int lane = threadIdx.x & 31;
  const int end = min(rc.n, (wc + 1) * rc.wc_keys);
  for (int b0 = wc * rc.wc_keys; b0 < end; b0 += 32 * KEY_BATCH) {
    int key[KEY_BATCH];
#pragma unroll
    for (int j = 0; j < KEY_BATCH; ++j) {
      const int i = b0 + j * 32 + lane;
      key[j] = i < end ? red_key(rp, rc.nm, pidx, pshidx, i) : -1;
    }
#pragma unroll
    for (int j = 0; j < KEY_BATCH; ++j) {
      round(key[j], b0 + j * 32 + lane);
      __syncwarp();
    }
  }
}

// Exclusive scan of x[0, n) in place by one block of THREADS threads, in
// tiles of THREADS * SCAN_ITEMS staged through s_tile (coalesced loads and
// stores; each thread scans SCAN_ITEMS neighbours); returns the total.
constexpr int SCAN_ITEMS = 8;

template <int THREADS>
__device__ int block_scan(int* x, int n, int* s_tile, int* s_warp) {
  constexpr int NW = THREADS / 32, TILE = THREADS * SCAN_ITEMS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = 0;
  for (int t0 = 0; t0 < n; t0 += TILE) {
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      const int i = t0 + j * THREADS + tid;
      s_tile[j * THREADS + tid] = i < n ? x[i] : 0;
    }
    __syncthreads();
    int v[SCAN_ITEMS], sum = 0;
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      v[j] = s_tile[tid * SCAN_ITEMS + j];
      sum += v[j];
    }
    int incl = sum;  // inclusive scan over the block: warps, then the warps' totals
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int t = lane < NW ? s_warp[lane] : 0;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, t, off);
        if (lane >= off) t += y;
      }
      if (lane < NW) s_warp[lane] = t;  // inclusive totals of warps 0..lane
    }
    __syncthreads();
    int run = carry + incl - sum + (warp > 0 ? s_warp[warp - 1] : 0);
    carry += s_warp[NW - 1];
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      s_tile[tid * SCAN_ITEMS + j] = run;
      run += v[j];
    }
    __syncthreads();
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      const int i = t0 + j * THREADS + tid;
      if (i < n) x[i] = s_tile[j * THREADS + tid];
    }
    __syncthreads();  // s_tile and s_warp are free again
  }
  return carry;
}

__global__ void __launch_bounds__(RED_THREADS)
soft_grad_reduce_count(ReduceParams rp, const int* __restrict__ ncnt,
                       const int* __restrict__ pidx, const int* __restrict__ pshidx,
                       const float* __restrict__ ppl, const float* __restrict__ ptf,
                       int* __restrict__ counts, int* __restrict__ wcounts,
                       float* __restrict__ ppart, float* __restrict__ cpart) {
  extern __shared__ int s_red[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nkeys = 2 * rp.ns;
  const int n_count = (rp.n_wc + RED_WARPS - 1) / RED_WARPS;
  const int W = rp.np * PL_ROWS, n_groups = (W + COL_GROUP - 1) / COL_GROUP;
  int b = blockIdx.x;
  if (b < n_count) {  // the histograms of a block's 8 warp chunks, and their total
    const RealCounts rc = real_counts(ncnt);
    if (b >= rc.n_count) return;  // past the real entries: nothing reads its counts
    int* hist = s_red + warp * nkeys;
    for (int k = lane; k < nkeys; k += 32) hist[k] = 0;
    __syncwarp();
    const int wc = b * RED_WARPS + warp;
    if (wc < rc.n_wc)
      warp_key_rounds(rp, rc, pidx, pshidx, wc, [&](int key, int) {
        if (key >= 0) atomicAdd(hist + key, 1);
      });
    __syncthreads();
    for (int k = threadIdx.x; k < nkeys; k += RED_THREADS) {
      int tot = 0;
      for (int w = 0; w < RED_WARPS; ++w) {
        const int c = s_red[w * nkeys + k];
        wcounts[((size_t)b * RED_WARPS + w) * nkeys + k] = c;
        tot += c;
      }
      counts[(size_t)k * n_count + b] = tot;
    }
    return;
  }
  b -= n_count;
  float* sf = reinterpret_cast<float*>(s_red);
  if (b < rp.n_tchunks * n_groups) {  // plane rows: tch tiles, COL_GROUP columns
    const int c = b / n_groups, g = b - c * n_groups;
    float acc[COL_GROUP / 32];
    for (int j = 0; j < COL_GROUP / 32; ++j) acc[j] = 0.0f;
    for (int i = 0; i < rp.tch / RED_WARPS; ++i) {
      const int t = c * rp.tch + i * RED_WARPS + warp;
      if (t >= rp.n_tiles) break;
      for (int j = 0; j < COL_GROUP / 32; ++j) {
        const int col = g * COL_GROUP + j * 32 + lane;
        if (col < W) acc[j] = acc[j] + __ldg(ppl + (size_t)t * W + col);
      }
    }
    for (int j = 0; j < COL_GROUP / 32; ++j) sf[warp * COL_GROUP + j * 32 + lane] = acc[j];
    __syncthreads();
    const int col = g * COL_GROUP + threadIdx.x;
    if (threadIdx.x < COL_GROUP && col < W) {
      float a = sf[threadIdx.x];
      for (int w = 1; w < RED_WARPS; ++w) a = a + sf[w * COL_GROUP + threadIdx.x];
      ppart[(size_t)c * W + col] = a;
    }
    return;
  }
  b -= rp.n_tchunks * n_groups;  // camera pairs: tch tiles, error-free
  float s = 0.0f, e = 0.0f;
  if (lane < rp.ntf)
    for (int i = 0; i < rp.tch / RED_WARPS; ++i) {
      const int t = b * rp.tch + i * RED_WARPS + warp;
      if (t >= rp.n_tiles) break;
      const float2 x = __ldg(reinterpret_cast<const float2*>(ptf) + (size_t)t * rp.ntf + lane);
      tf_combine(s, e, x.x, x.y, &s, &e);
    }
  if (lane < rp.ntf) {
    sf[(warp * rp.ntf + lane) * 2] = s;
    sf[(warp * rp.ntf + lane) * 2 + 1] = e;
  }
  __syncthreads();
  if (threadIdx.x < rp.ntf) {
    const int slot = threadIdx.x;
    float a = sf[slot * 2], ae = sf[slot * 2 + 1];
    for (int w = 1; w < RED_WARPS; ++w)
      tf_combine(a, ae, sf[(w * rp.ntf + slot) * 2], sf[(w * rp.ntf + slot) * 2 + 1], &a, &ae);
    cpart[((size_t)b * rp.ntf + slot) * 2] = a;
    cpart[((size_t)b * rp.ntf + slot) * 2 + 1] = ae;
  }
}

__global__ void __launch_bounds__(RED_THREADS)
soft_grad_reduce_prefix(ReduceParams rp, const int* __restrict__ ncnt,
                        int* __restrict__ counts, int* __restrict__ totals) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * RED_WARPS + (threadIdx.x >> 5);
  if (k >= 2 * rp.ns) return;
  const int n_count = (rp.n_wc + RED_WARPS - 1) / RED_WARPS;  // the row stride
  const int n_real = real_counts(ncnt).n_count;
  int* row = counts + (size_t)k * n_count;
  int carry = 0;
  for (int b0 = 0; b0 < n_real; b0 += 32) {
    const int c = b0 + lane < n_real ? row[b0 + lane] : 0;
    int incl = c;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    if (b0 + lane < n_real) row[b0 + lane] = carry + incl - c;
    carry += __shfl_sync(FULL, incl, 31);
  }
  if (lane == 0) totals[k] = carry;
}

__global__ void __launch_bounds__(RED_THREADS)
soft_grad_reduce_scatter(ReduceParams rp, const int* __restrict__ ncnt,
                         const int* __restrict__ pidx,
                         const int* __restrict__ pshidx, const int* __restrict__ prefix,
                         const int* __restrict__ wcounts, int* __restrict__ totals,
                         int* __restrict__ seg, int* __restrict__ cbase, int* __restrict__ perm) {
  // [8, 2 NS] the warps' next positions, [2 NS + 1] the segments, then a scan tile
  extern __shared__ int s_red[];
  __shared__ int s_warp[RED_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nkeys = 2 * rp.ns;
  const int n_count = (rp.n_wc + RED_WARPS - 1) / RED_WARPS;
  int* s_seg = s_red + RED_WARPS * nkeys;
  int* s_tile = s_seg + nkeys + 1;
  for (int k = threadIdx.x; k < nkeys; k += RED_THREADS) s_seg[k] = __ldg(totals + k);
  __syncthreads();
  const int total = block_scan<RED_THREADS>(s_seg, nkeys, s_tile, s_warp);
  if (threadIdx.x == 0) s_seg[nkeys] = total;
  __syncthreads();
  if (blockIdx.x == 0) {  // the segments and their chunks, for the last two launches
    for (int k = threadIdx.x; k <= nkeys; k += RED_THREADS) seg[k] = s_seg[k];
    for (int k = threadIdx.x; k < nkeys; k += RED_THREADS)
      cbase[k] = (s_seg[k + 1] - s_seg[k] + RED_CHUNK - 1) / RED_CHUNK;
    __syncthreads();
    const int n_chunks = block_scan<RED_THREADS>(cbase, nkeys, s_tile, s_warp);
    if (threadIdx.x == 0) cbase[nkeys] = n_chunks;
  }
  const RealCounts rc = real_counts(ncnt);
  if ((int)blockIdx.x >= rc.n_count) return;  // past the real entries
  for (int k = threadIdx.x; k < nkeys; k += RED_THREADS) {
    int r = s_seg[k] + __ldg(prefix + (size_t)k * n_count + blockIdx.x);
    for (int w = 0; w < RED_WARPS; ++w) {
      const int c = __ldg(wcounts + ((size_t)blockIdx.x * RED_WARPS + w) * nkeys + k);
      s_red[w * nkeys + k] = r;
      r += c;
    }
  }
  __syncthreads();
  const int wc = blockIdx.x * RED_WARPS + warp;
  if (wc >= rc.n_wc) return;
  int* run = s_red + warp * nkeys;
  warp_key_rounds(rp, rc, pidx, pshidx, wc, [&](int key, int i) {
    const unsigned peers = __match_any_sync(FULL, key);
    if (key < 0) return;
    perm[run[key] + __popc(peers & ((1u << lane) - 1u))] = i;
    __syncwarp(peers);
    if (lane == __ffs(peers) - 1) run[key] += __popc(peers);
  });
}

__global__ void __launch_bounds__(RED_THREADS)
soft_grad_reduce_spheres(ReduceParams rp, const int* __restrict__ ncnt,
                         const float* __restrict__ pvals,
                         const float* __restrict__ psh, const int* __restrict__ seg,
                         const int* __restrict__ cbase, const int* __restrict__ perm,
                         float* __restrict__ spart) {
  __shared__ float s_sum[RED_WARPS][7];
  extern __shared__ int s_cbase[];  // cbase [2 NS + 1]
  const int nkeys = 2 * rp.ns;
  const int n_chunks = __ldg(cbase + nkeys);
  if ((int)blockIdx.x >= n_chunks) return;  // block-uniform
  for (int k = threadIdx.x; k <= nkeys; k += RED_THREADS) s_cbase[k] = __ldg(cbase + k);
  __syncthreads();
  const int nm = __ldg(ncnt);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = blockIdx.x; b < n_chunks; b += gridDim.x) {  // chunk b of a key's entries
    int lo = 0, hi = nkeys - 1;  // the last key whose chunks start at or before b
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_cbase[mid] <= b) lo = mid; else hi = mid - 1;
    }
    const int key = lo;
    const int row = __ldg(seg + key) + (b - s_cbase[key]) * RED_CHUNK + threadIdx.x;
    float v[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (row < __ldg(seg + key + 1)) {
      const int e = __ldg(perm + row);
      if (key < rp.ns) {  // a main-list entry: 7 of its 8 floats
        const float4 a = __ldg(reinterpret_cast<const float4*>(pvals) + (size_t)e * 2);
        const float4 c = __ldg(reinterpret_cast<const float4*>(pvals) + (size_t)e * 2 + 1);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = c.x; v[5] = c.y; v[6] = c.z;
      } else {  // a shadow-list entry: 4 floats
        const float4 a = __ldg(reinterpret_cast<const float4*>(psh) + (size_t)(e - nm));
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      }
    }
    warp_sum<7>(v);  // block_sum_plain's order: warp butterflies, then the warps in order
    if (lane == 0)
      for (int i = 0; i < 7; ++i) s_sum[warp][i] = v[i];
    __syncthreads();
    if (threadIdx.x < 7) {
      float a = s_sum[0][threadIdx.x];
      for (int w = 1; w < RED_WARPS; ++w) a = a + s_sum[w][threadIdx.x];
      spart[(size_t)b * 8 + threadIdx.x] = a;
    }
    __syncthreads();  // s_sum is free for the block's next chunk
  }
}

// A warp's sum of key's chunk partials: lane l chunks l, l + 32, ..., then
// the butterfly; lane 0 ends with the first N values' totals.
template <int N>
__device__ __forceinline__ void warp_chunks(const int* __restrict__ cbase,
                                            const float* __restrict__ spart, int key,
                                            float v[N]) {
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < N; ++i) v[i] = 0.0f;
  for (int c = __ldg(cbase + key) + lane; c < __ldg(cbase + key + 1); c += 32)
    for (int i = 0; i < N; ++i) v[i] = v[i] + __ldg(spart + (size_t)c * 8 + i);
  warp_sum<N>(v);
}

__global__ void __launch_bounds__(RED_THREADS)
soft_grad_reduce_final(ReduceParams rp, const int* __restrict__ cbase,
                       const float* __restrict__ spart, const float* __restrict__ ppart,
                       const float* __restrict__ cpart, float* __restrict__ dsph,
                       float* __restrict__ dpl, float* __restrict__ dtf) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * RED_WARPS + (threadIdx.x >> 5);  // one warp a sphere, column, slot
  const int W = rp.np * PL_ROWS;
  if (q < rp.ns) {  // a sphere: its main chunks, then rows 0-3 plus its shadow chunks
    float v[7], sh[4];
    warp_chunks<7>(cbase, spart, q, v);
    warp_chunks<4>(cbase, spart, rp.ns + q, sh);
    if (lane == 0) {
      for (int i = 0; i < 7; ++i) dsph[i * rp.ns + q] = i < 4 ? v[i] + sh[i] : v[i];
      dsph[7 * rp.ns + q] = 0.0f;
    }
  } else if (q < rp.ns + W) {  // a plane column
    const int col = q - rp.ns;
    float v = 0.0f;
    for (int c = lane; c < rp.n_tchunks; c += 32) v = v + __ldg(ppart + (size_t)c * W + col);
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
    const int row = col % PL_ROWS, k = col / PL_ROWS;
    if (lane == 0) dpl[row * rp.np + k] = row == PL_ROWS - 1 ? 0.0f : v;  // the active row
  } else if (q < rp.ns + W + rp.ntf) {  // a camera or loss slot, error-free
    const int slot = q - rp.ns - W;
    float s = 0.0f, e = 0.0f;
    for (int c = lane; c < rp.n_tchunks; c += 32)
      tf_combine(s, e, __ldg(cpart + ((size_t)c * rp.ntf + slot) * 2),
                 __ldg(cpart + ((size_t)c * rp.ntf + slot) * 2 + 1), &s, &e);
    for (int off = 16; off > 0; off >>= 1) {
      const float s2 = __shfl_down_sync(FULL, s, off);
      const float e2 = __shfl_down_sync(FULL, e, off);
      tf_combine(s, e, s2, e2, &s, &e);
    }
    if (lane == 0) {
      dtf[slot * 2] = s;
      dtf[slot * 2 + 1] = e;
    }
  }
}

// C entries for ctypes. Pointers are device pointers of contiguous tensors
// the wrapper (render/soft_kernel.py) has checked and allocated; `stream`
// is PyTorch's current stream. Each returns the launch's cudaError_t (0 on
// success) and does not synchronise.
extern "C" int rtwc_soft_fwd(const float* cam, const float* sph, const float* pl,
                             const int* lists, float* out, int* gates, const SoftParams* params,
                             void* stream) {
  const SoftParams p = *params;
  const size_t smem = sizeof(float) * PL_ROWS * (size_t)p.np + staged_row_smem(p.list_stride);
  if (int rc = prepare(soft_fwd_kernel, p, smem)) return rc;
  soft_fwd_kernel<<<dim3(p.wp / p.bw, p.hp / p.bh), dim3(p.bw, p.bh), smem,
                    (cudaStream_t)stream>>>(p, cam, sph, pl, lists, out, gates);
  return (int)cudaGetLastError();
}

extern "C" int rtwc_soft_bwd(const float* cam, const float* sph, const float* pl,
                             const int* lists, const int* offsets, const int* gates,
                             const float* sav, const float* g, float* pvals, float* ppl,
                             float* ptf, const SoftParams* params, void* stream) {
  const SoftParams p = *params;
  const size_t smem = sizeof(float) * (PL_ROWS * (size_t)p.np + ST_FIELDS * MAX_THREADS);
  if (int rc = prepare(soft_bwd_kernel, p, smem, sizeof(Reduce) + sizeof(Slab))) return rc;
  soft_bwd_kernel<<<dim3(p.wp / p.bw, p.hp / p.bh), dim3(p.bw, p.bh), smem,
                    (cudaStream_t)stream>>>(p, cam, sph, pl, lists, offsets, gates, sav, g,
                                            pvals, ppl, ptf);
  return (int)cudaGetLastError();
}

extern "C" int rtwc_soft_mse(const float* cam, const float* sph, const float* pl,
                             const int* lists, const int* offsets, const float* tgt,
                             float* pvals, float* ppl, float* ptf, const SoftParams* params,
                             void* stream) {
  const SoftParams p = *params;
  const size_t smem = sizeof(float) * PL_ROWS * (size_t)p.np + sizeof(int) * (size_t)(p.ns + p.np) +
                      staged_row_smem(p.list_stride) + sizeof(float) * ST_FIELDS * MAX_THREADS;
  if (int rc = prepare(soft_mse_kernel, p, smem, sizeof(Reduce) + sizeof(Slab))) return rc;
  soft_mse_kernel<<<dim3(p.wp / p.bw, p.hp / p.bh), dim3(p.bw, p.bh), smem,
                    (cudaStream_t)stream>>>(p, cam, sph, pl, lists, offsets, tgt, pvals, ppl,
                                            ptf);
  return (int)cudaGetLastError();
}

// The reduction's five launches; ncnt [2] holds the real main and shadow
// entry counts (device memory). With n_count = ceil(n_wc / 8) counting
// blocks, iws holds counts [2 NS, n_count] (scanned in place per key),
// wcounts [n_count, 8, 2 NS], totals [2 NS], seg [2 NS + 1], cbase
// [2 NS + 1] and perm [entries]; fws holds spart [n_schunks, 8], ppart
// [n_tchunks, 12 NP] and cpart [n_tchunks, NTF, 2] (render/soft_core.py
// reduce_params sizes them).
extern "C" int rtwc_soft_grad_reduce(const float* pvals, const int* pidx, const float* psh,
                                     const int* pshidx, const int* ncnt, const float* ppl,
                                     const float* ptf, float* dsph, float* dpl, float* dtf,
                                     int* iws, float* fws, const ReduceParams* params,
                                     void* stream) {
  const ReduceParams rp = *params;
  cudaError_t err = cudaSetDevice(rp.device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nkeys = 2 * rp.ns, W = rp.np * PL_ROWS;
  const int n_count = (rp.n_wc + RED_WARPS - 1) / RED_WARPS;
  int* counts = iws;
  int* wcounts = counts + (size_t)nkeys * n_count;
  int* totals = wcounts + (size_t)n_count * RED_WARPS * nkeys;
  int* seg = totals + nkeys;
  int* cbase = seg + nkeys + 1;
  int* perm = cbase + nkeys + 1;
  float* spart = fws;
  float* ppart = spart + (size_t)rp.n_schunks * 8;
  float* cpart = ppart + (size_t)rp.n_tchunks * W;
  const size_t hist_smem = sizeof(int) * RED_WARPS * (size_t)nkeys;
  const size_t count_smem = hist_smem > sizeof(float) * RED_WARPS * COL_GROUP
                                ? hist_smem : sizeof(float) * RED_WARPS * COL_GROUP;
  const size_t scatter_smem =
      hist_smem + sizeof(int) * ((size_t)nkeys + 1 + RED_THREADS * SCAN_ITEMS);
  const size_t cbase_smem = sizeof(int) * (size_t)(nkeys + 1);
  if (count_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(soft_grad_reduce_count, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)count_smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (scatter_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(soft_grad_reduce_scatter,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)scatter_smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_groups = (W + COL_GROUP - 1) / COL_GROUP;
  soft_grad_reduce_count<<<n_count + rp.n_tchunks * (n_groups + 1), RED_THREADS, count_smem,
                           st>>>(rp, ncnt, pidx, pshidx, ppl, ptf, counts, wcounts, ppart, cpart);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n_prefix = nkeys > 0 ? (nkeys + RED_WARPS - 1) / RED_WARPS : 1;
  soft_grad_reduce_prefix<<<n_prefix, RED_THREADS, 0, st>>>(rp, ncnt, counts, totals);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  soft_grad_reduce_scatter<<<n_count > 0 ? n_count : 1, RED_THREADS, scatter_smem, st>>>(
      rp, ncnt, pidx, pshidx, counts, wcounts, totals, seg, cbase, perm);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  soft_grad_reduce_spheres<<<min(rp.n_schunks, RED_SPHERE_BLOCKS), RED_THREADS, cbase_smem, st>>>(
      rp, ncnt, pvals, psh, seg, cbase, perm, spart);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  soft_grad_reduce_final<<<(rp.ns + W + rp.ntf + RED_WARPS - 1) / RED_WARPS, RED_THREADS, 0,
                           st>>>(rp, cbase, spart, ppart, cpart, dsph, dpl, dtf);
  return (int)cudaGetLastError();
}
