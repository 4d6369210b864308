// K4, K5, K6 and K4-stats (the shadowed soft train path), for Hopper (sm_90a).
//
// Replaces the config.shadows branches of rtwc_tpu/render/pallas_soft.py:
//   K4 `_soft_sh_fwd_body` (:1727-1921, pl.pallas_call at :2434): sweep 1
//      (online softmin with the vis-independent ambient / direct shading
//      parts A, B and a per-pixel object cache), the shadow sweep at the
//      blended hit point (`_shadow_vis_sweep`, :1001-1111: planes first,
//      then the tile's shadow list, split stage A / stage B sphere gate,
//      block-uniform all-dark early-out), and the clamp-corrected colour
//      blend (`_clamp_blend_from_cache`, :1114, or the exact re-walk
//      `_clamp_blend_fallback`, :1145). Writes 14 planes and both gate rows;
//   K4-stats `_build_cache_stats` (:2796, launched at :2822): K4 as a
//      compile-time variant that also writes, per tile, the culled-in main
//      count (the cache demand) and the applied occluder count;
//   K5 `_soft_sh_bwd_body` (:1496-1725, launched at :2476): the value path
//      through vis from the saved d(rgb)/d(vis) planes, the shadow sweep's
//      adjoint at the blended hit point (occluder, camera and blended-depth
//      cotangents), and the softmax VJP with rgb_k = min(255, A_k + vis B_k);
//   K6 the shadowed branch of `_soft_mse_fused_body` (:1923-2347, launched
//      at :2526): K4's forward and K5's backward in one pass at loss
//      cotangent 1, the MSE cotangents derived in registers.
// The plain torch versions are in render/shadow_kernel.py; the device
// functions and hand-written adjoints in soft_common.cuh; the block sums and
// the forward and main backward sweeps in soft_block.cuh.
//
// Design. As K1-K3: one thread per pixel, one block per broad-phase tile,
// object gates decided for the whole block with __syncthreads_or /
// __syncthreads_and, so every branch below is block-uniform. The TPU kernel
// keeps its object cache in VMEM (29 / 21 slots of 3 planes, sized from its
// 16 MB); here a cache slot is 3 floats per thread (t_eff, dterm, sterm),
// NC = 8 slots, in shared memory, and the 3 colour scalars of a slot too.
// The cache is filled in sweep-1 order; a block whose culled-in count
// exceeds NC takes the exact re-walk (a block-uniform decision: the count
// is). Shadow-occluder gradients are
// keyed by the shadow list, so K5 / K6 write them to a second compact table
// ([E_sh, 4], row = shadow-list slot at sh_offsets[tile] + slot), beside
// K2's [E, 8] sphere table; soft_grad_reduce (soft_render.cu) sums both in
// a fixed order. Plane rows hold the shadow sweep's partial plus the main
// sweep's. No float atomics.
//
// What bounds it. Per pixel, K4 does K1's work plus, per listed occluder,
// a quadratic (stage A) and for the survivors a root, four exps and one
// division; per gated object it caches 3 floats and replays 45 flops in the
// correction. Stores are 56 B per pixel (K4); K5 loads 84 B (13 saved
// planes, alpha unread, and 8 cotangent planes): 117 / 175 MB at 1080p, 35
// / 52 us at 3.35 TB/s. But a 16x16 tile of the bench's scenes gates less
// than one object a sweep on average (at most 2 main objects and 3
// occluders at 1080p / 20 spheres, 9 and 11 at 4K / 200), so K5 and K6 are
// bound by what every block does once and by latency: the planes, lists
// and gates it loads, the camera's two-float sum, and how few blocks an SM
// holds to hide them. Their design:
// - the slab (soft_block.cuh `Slab`): a gated object's per-warp sums wait
//   in shared memory and the block sums them when 32 slots are full or the
//   sweep ends, two barriers a sweep instead of two an object, each total
//   by one thread in soft_core.py `block_sum_plain`'s order (warp
//   butterflies, then the warps in order; bit-equal to it);
// - the camera sum's cross-warp combine runs on 12 / 13 threads at once
//   (block_tf_rows), where one thread did about 84 dependent steps while
//   255 waited;
// - what a sweep only re-reads (m, 1/s, S, the output and ray cotangents,
//   the camera sum's inputs) waits in a per-thread shared-memory stash, and
//   K6's clamp cache lives in shared memory, so that K5 and K6 fit the
//   register budget of K5_MIN_BLOCKS / K6_MIN_BLOCKS blocks an SM;
// - K6 runs the tiles that list no sphere, two thirds of the headline's, in
//   a variant built without the sphere sweeps, beside the full kernel (K6's
//   tile classes, below).
// K4 (and K4-stats), whose bound is its 56 B a pixel of stores:
// - the TPU kernels read the tile's lists from SMEM by scalar prefetch; a
//   K4 (and a K6) block copies its list row, its shadow list row and the
//   listed spheres' parameters into shared memory at block start (stage_lists,
//   one chain of dependent loads a block), so that no listed object costs
//   a chain of dependent device-memory loads before its block vote;
// - the clamp cache is in shared memory (a runtime slot index puts
//   per-thread arrays in local memory), so that 5 blocks fit an SM at 48
//   registers.
// Without its stores K4 takes 88 % of its time at the headline (PERF.md
// section 6), so the sweeps' arithmetic and block votes bound it.
//
// Float semantics follow the plain versions op for op; compiled with
// -fmad=false (see soft_common.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "soft_block.cuh"

using namespace soft;

namespace {

constexpr int NC = 8;  // clamp-correction cache slots per pixel
// Blocks an SM that K5 and K6's full kernel are built for. K5: 2, at most
// 65536 / (256 x 2) = 128 registers a thread, the most blocks at which it
// does not spill (112 registers; at 3, 80, and at 4, 64, it spills). K6's
// full kernel, which since its split by tile class runs only tiles that list
// a sphere: 3, 80 registers and 128 B of spill stores. On an H100, with the
// plane-only variant at 4, K6 took 0.2548 / 0.2679 / 0.2556 ms at 3 / 2 / 4
// (4: 64 registers, 296 B spilled) at the bench headline, 1.315 / 1.465 /
// 1.295 ms at 4K / 200 (a CUDA graph of 20 calls; PERF.md section 6).
constexpr int K5_MIN_BLOCKS = 2, K6_MIN_BLOCKS = 3;

// What the shadowed forward leaves for the blend, the outputs and the
// backward, per pixel.
struct ShFwd {
  float m, s, inv_s, depth, n[3], rgb[3], dv[3], vis;
  int count, napp;  // culled-in main objects, applied occluders (block-uniform)
};

// The clamp cache: NC slots of (t_eff, dterm, sterm) a pixel, in shared
// memory, [slot][value][MAX_THREADS] (3 NC x 256 floats, 24 KB a block):
// neighbouring threads on neighbouring banks, and no register or local
// memory holds it across the shadow sweep. The slot index is the count of
// culled-in objects so far, a runtime value, which would put per-thread
// arrays in local memory.
struct SharedCache {
  float* col;  // this thread's column: s_cache + tid
  __device__ explicit SharedCache(float* s_cache)
      : col(s_cache + threadIdx.y * blockDim.x + threadIdx.x) {}
  __device__ void put(int j, float te, float dt, float st) {
    col[3 * j * MAX_THREADS] = te;
    col[(3 * j + 1) * MAX_THREADS] = dt;
    col[(3 * j + 2) * MAX_THREADS] = st;
  }
  __device__ float t(int j) const { return col[3 * j * MAX_THREADS]; }
  __device__ float dterm(int j) const { return col[(3 * j + 1) * MAX_THREADS]; }
  __device__ float sterm(int j) const { return col[(3 * j + 2) * MAX_THREADS]; }
};

// One step of sweep 1 (pallas_soft.py:1790-1818): the online softmin over
// t_eff with the depth, normal and A / B accumulators, and the cache store.
__device__ __forceinline__ void fused_accumulate(const SoftParams& p, const Geo& g,
                                                 const float col[3], Vec3 sn, Vec3 d, float* m,
                                                 float* s, float acc[10], int* count,
                                                 SharedCache* c, float* s_ccol) {
  float dterm, sterm, A[3], B[3];
  shade_terms(p, g.pt, sn, d, &dterm, &sterm);
  parts_from_terms(p, dterm, sterm, col, A, B);
  const float logit = -g.t_eff * p.inv_tau;
  const float m_new = fmaxf(*m, logit);
  const float e = expf(-fabsf(logit - *m));
  const bool up = logit > *m;
  const float alpha = up ? e : 1.0f;
  const float pw = up ? 1.0f : e;
  *s = *s * alpha + pw;
  const float vals[10] = {g.t_clip, g.n.x, g.n.y, g.n.z, A[0], A[1], A[2], B[0], B[1], B[2]};
#pragma unroll
  for (int i = 0; i < 10; ++i) acc[i] = acc[i] * alpha + pw * vals[i];
  if (*count < NC) {
    c->put(*count, g.t_eff, dterm, sterm);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      for (int k = 0; k < 3; ++k) s_ccol[*count * 3 + k] = col[k];
  }
  *count += 1;
  *m = m_new;
}

// One object of the exact re-walk (pallas_soft.py:1151-1161).
__device__ __forceinline__ void shade_accumulate(const SoftParams& p, const Geo& g,
                                                 const float col[3], Vec3 sn, Vec3 d, float m,
                                                 float inv_s, float vis, float out[6]) {
  const float w = expf(-g.t_eff * p.inv_tau - m) * inv_s;
  float dterm, sterm, A[3], B[3];
  shade_terms(p, g.pt, sn, d, &dterm, &sterm);
  parts_from_terms(p, dterm, sterm, col, A, B);
  for (int c = 0; c < 3; ++c) {
    const float val = A[c] + vis * B[c];
    const float gate = val < 255.0f ? 1.0f : 0.0f;
    out[c] = out[c] + w * fminf(val, 255.0f);
    out[3 + c] = out[3 + c] + w * B[c] * gate;
  }
}

// K4's forward (also K6's): gate0 / gate1 get the block's main-sweep and
// shadow-sweep decisions (thread 0 writes them). The list rows and their
// spheres come from `lst` and `shl`, staged by stage_lists. The clamp cache
// is on s_cache. SPHERES false (K6's plane-only variant) compiles out the
// sweeps over both lists, which are empty in its tiles.
template <bool SPHERES = true>
__device__ void sh_forward(const SoftParams& p, const float* __restrict__ cam,
                           const StagedList& lst, const StagedList& shl, const float* s_pl,
                           int* gate0, int* gate1, float* s_ccol, float* s_cache, Vec3 d,
                           Vec3 o, ShFwd* f) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  // ---- sweep 1
  float m = p.bg_logit, s = 1.0f;
  float acc[10] = {p.far, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  SharedCache cache(s_cache);
  int count = 0;
  forward_sweep<SPHERES>(p, cam, lst, s_pl, gate0, d, o, &m,
                         [&](const Geo& g, const float* col, Vec3 sn) {
                           fused_accumulate(p, g, col, sn, d, &m, &s, acc, &count, &cache,
                                            s_ccol);
                         });
  const float inv_s = 1.0f / s;
  const float depth = acc[0] * inv_s;

  // ---- the shadow sweep at the blended hit point: planes first, then the
  // shadow list; `dark` (every pixel's vis <= 1e-7) skips the heavy branch
  const int n_pl = (int)__ldg(cam + C_NPL);
  const LightRay l = light_ray(p, Vec3{o.x + d.x * depth, o.y + d.y * depth, o.z + d.z * depth});
  float vis = 1.0f;
  bool dark = false;
  int napp = 0;
  for (int k = 0; k < n_pl; ++k) {
    const Plane q = load_plane(s_pl, p.np, k);
    float args[5];
    const float min_arg = shadow_plane_pre(p, q, l, args);
    bool rel = true;
    if (p.cull) {
      const int rel_geo = __syncthreads_or(min_arg > p.sh_floor);
      if (tid == 0) gate1[p.ns + k] = rel_geo ? 1 : 0;
      rel = rel_geo && !dark;
    } else if (tid == 0) {
      gate1[p.ns + k] = 1;
    }
    if (rel) {
      vis = vis * transmittance<5>(p, args);
      if (p.cull) dark = __syncthreads_and(vis <= VIS_EARLY_OUT);
      ++napp;
    }
  }
  const int n_sh = SPHERES ? shl.n() : 0;
  for (int jj = 0; jj < n_sh; ++jj) {
    const int k = shl.index(jj);
    const Sphere sp = shl.sphere(jj);
    float args[4];
    if (!p.cull) {
      if (tid == 0) gate1[k] = 1;
      shadow_sphere_pre(p, sp, l, args);
      vis = vis * transmittance<4>(p, args);
      ++napp;
      continue;
    }
    float disc, dss, b;
    shadow_sphere_preA(p, sp, l, &disc, &dss, &b);
    if (__syncthreads_or(dss > p.sh_floor)) {  // stage A passed: the root and the rest
      const float min_arg = shadow_sphere_preB(disc, dss, b, l.dist, args);
      const int rel_geo = __syncthreads_or(min_arg > p.sh_floor);
      if (tid == 0) gate1[k] = rel_geo ? 1 : 0;
      if (rel_geo && !dark) {
        vis = vis * transmittance<4>(p, args);
        dark = __syncthreads_and(vis <= VIS_EARLY_OUT);
        ++napp;
      }
    } else if (tid == 0) {
      gate1[k] = 0;
    }
  }
  __syncthreads();  // the cache colours and the gates, written by thread 0

  // ---- the clamp-corrected colour blend
  if (count <= NC) {
    float corr[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < count; ++j) {
      float A[3], B[3];
      parts_from_terms(p, cache.dterm(j), cache.sterm(j), s_ccol + 3 * j, A, B);
      const float w = expf(-cache.t(j) * p.inv_tau - m) * inv_s;
      for (int c = 0; c < 3; ++c) {
        const float val = A[c] + vis * B[c];
        const bool over = val >= 255.0f;
        corr[c] = corr[c] + w * (over ? val - 255.0f : 0.0f);
        corr[3 + c] = corr[3 + c] + w * (over ? B[c] : 0.0f);
      }
    }
    for (int c = 0; c < 3; ++c) {
      const float a = acc[4 + c] * inv_s, bb = acc[7 + c] * inv_s;
      f->rgb[c] = a + vis * bb - corr[c];
      f->dv[c] = bb - corr[3 + c];
    }
  } else {  // more culled-in objects than slots: the exact re-walk, gated on the final m
    float out[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    forward_sweep<SPHERES>(p, cam, lst, s_pl, nullptr, d, o, &m,
                           [&](const Geo& g, const float* col, Vec3 sn) {
                             shade_accumulate(p, g, col, sn, d, m, inv_s, vis, out);
                           });
    for (int c = 0; c < 3; ++c) {
      f->rgb[c] = out[c];
      f->dv[c] = out[3 + c];
    }
  }
  f->m = m;
  f->s = s;
  f->inv_s = inv_s;
  f->depth = depth;
  for (int c = 0; c < 3; ++c) f->n[c] = acc[1 + c] * inv_s;
  f->vis = vis;
  f->count = count;
  f->napp = napp;
}

// K5's sweeps (also K6's backward): the shadow sweep's adjoint at the
// blended hit point, then the main backward sweep (backward_sweep_slab)
// seeded with its ray cotangents and with the depth cotangent raised by
// ct_D = ctP . d. The caller has put in the stash m, 1/s, vis, depth, the
// rgb and normal cotangents (ST_GV 0-2 and 4-6), the first three terms of S
// (ST_S), the normals (ST_ON), g_depth0, g_alpha w_bg and what the camera
// sum reads; the shadow sweep holds in registers only the hit point, its
// cotangent and one occluder. The per-object partials of both sweeps go
// through the slab `sb`; the shadow sweep flushes before the main sweep, so
// a plane row holds the shadow total before the main sweep's is added.
// SPHERES false compiles out both lists' sweeps, as sh_forward's.
template <int NTFB, bool SPHERES = true>
__device__ void sh_backward(const SoftParams& p, const float* __restrict__ cam,
                            const float* __restrict__ sph, const float* s_pl,
                            const int* __restrict__ lst, const int* __restrict__ shl,
                            const int* gate0, const int* gate1, int tile, int offset,
                            int sh_offset, Vec3 d, Vec3 o, float g_vis, Stash st,
                            Reduce* sm, Slab* sb, float* __restrict__ pvals,
                            float* __restrict__ psh, float* __restrict__ ppl,
                            float* __restrict__ ptf) {
  const float depth0 = st.get(ST_DEPTH);
  const Vec3 pb = {o.x + d.x * depth0, o.y + d.y * depth0, o.z + d.z * depth0};
  const float ct_vis = g_vis * st.get(ST_VIS);  // d vis / d f_j = vis / f_j
  Vec3 ctp = {0.0f, 0.0f, 0.0f};
  int used = 0;  // slab slots filled
  const int n_sh = SPHERES ? __ldg(shl) : 0;
  for (int jj = 0; jj < n_sh; ++jj) {
    const int k = __ldg(shl + 1 + jj);
    if (p.cull && gate1[k] != 1) continue;  // block-uniform
    const Sphere sp = load_sphere(sph, p.ns, k);
    float g[4];
    Vec3 c;
    shadow_sphere_f_vjp(p, sp, pb, ct_vis / shadow_sphere_f(p, sp, pb), g, &c);
    ctp.x = ctp.x + c.x;
    ctp.y = ctp.y + c.y;
    ctp.z = ctp.z + c.z;
    slab_put<4>(g, sb, used, psh + (size_t)(sh_offset + jj) * 4, false);
  }
  const int n_pl = (int)__ldg(cam + C_NPL);
  for (int k = 0; k < n_pl; ++k) {
    if (p.cull && gate1[p.ns + k] != 1) continue;
    const Plane q = load_plane(s_pl, p.np, k);
    float g[8];
    Vec3 c;
    shadow_plane_f_vjp(p, q, pb, ct_vis / shadow_plane_f(p, q, pb), g, &c);
    ctp.x = ctp.x + c.x;
    ctp.y = ctp.y + c.y;
    ctp.z = ctp.z + c.z;
    slab_put<8>(g, sb, used, ppl + ((size_t)tile * p.np + k) * PL_ROWS, false);
  }
  if (used > 0) slab_flush(sb, used);
  const float depth = st.get(ST_DEPTH);
  const float g_depth = st.get(ST_GDEPTH0) + (ctp.x * d.x + ctp.y * d.y + ctp.z * d.z);
  float S = st.get(ST_S);
  S = S + g_depth * depth;
  S = S + st.get(ST_GV + 4) * st.get(ST_ON);
  S = S + st.get(ST_GV + 5) * st.get(ST_ON + 1);
  S = S + st.get(ST_GV + 6) * st.get(ST_ON + 2);
  S = S - st.get(ST_GAW);
  st.put(ST_S, S);
  st.put(ST_GV + 3, g_depth);
  st.put(ST_GD, ctp.x * depth);
  st.put(ST_GD + 1, ctp.y * depth);
  st.put(ST_GD + 2, ctp.z * depth);
  st.put(ST_GO, ctp.x);
  st.put(ST_GO + 1, ctp.y);
  st.put(ST_GO + 2, ctp.z);
  backward_sweep_slab<NTFB, true, SPHERES>(p, cam, sph, s_pl, lst, gate0, tile, offset, d, o,
                                           st.get(ST_VIS), st, sm, sb, pvals, ppl, ptf);
}

__device__ __forceinline__ int tile_index(const SoftParams& p) {
  return blockIdx.y * (p.wp / p.bw) + blockIdx.x;
}

__device__ __forceinline__ size_t pixel_index(const SoftParams& p) {
  return (size_t)(blockIdx.y * p.bh + threadIdx.y) * p.wp + blockIdx.x * p.bw + threadIdx.x;
}

}  // namespace

// K4's dynamic shared memory, in this order: the plane table [12, NP], the
// cache colours [NC, 3], the list row and the shadow list row [2,
// list_stride] ints, their staged spheres [2, STAGED, list_stride - 1]
// (StagedList), and the clamp cache [3 NC, MAX_THREADS]. About 25 KB a
// block at the bench headline (20 spheres, 4 planes), 37 KB at 4K / 200.
inline size_t sh_fwd_smem(int np, int list_stride) {
  return sizeof(float) * (PL_ROWS * (size_t)np + 3 * NC) + sizeof(int) * 2 * (size_t)list_stride +
         sizeof(float) * 2 * STAGED * (size_t)(list_stride - 1) +
         sizeof(float) * 3 * NC * MAX_THREADS;
}

// Blocks an SM that K4 and K4-stats are built for: 5, at most 48 registers
// a thread (4-8 B of spill stores). With 26 KB of shared memory a block at
// the bench headline and 37 KB at 4K / 200, shared memory would allow 8 and
// 6 blocks, threads 8: registers bind at both shapes. On an H100 at 4 / 5 /
// 6 blocks (62 / 48 / 40 registers; 0 / 4 / 52 B of spill stores): 0.0856 /
// 0.0807 / 0.0814 ms at the headline, 0.514 / 0.488 / 0.511 ms at 4K / 200
// (PERF.md section 6).
constexpr int K4_MIN_BLOCKS = 5;

// K4 and K4-stats: sh_forward on the tile's lists and spheres staged in
// shared memory at block start (stage_lists), with the clamp cache in
// shared memory too, then the 14 planes (and with STATS the tile's counts).
template <bool STATS>
__global__ void __launch_bounds__(MAX_THREADS, K4_MIN_BLOCKS)
soft_sh_fwd_kernel(SoftParams p, const float* __restrict__ cam, const float* __restrict__ sph,
                   const float* __restrict__ pl_g, const int* __restrict__ lists,
                   const int* __restrict__ shlists, float* __restrict__ out,
                   int* __restrict__ gates, int* __restrict__ counts) {
  extern __shared__ float s_pl[];  // sh_fwd_smem's layout
  float* s_ccol = s_pl + PL_ROWS * p.np;
  int* s_lst = reinterpret_cast<int*>(s_ccol + 3 * NC);
  float* s_sph = reinterpret_cast<float*>(s_lst + 2 * p.list_stride);
  float* s_cache = s_sph + 2 * STAGED * (p.list_stride - 1);
  const int tile = tile_index(p);
  stage_lists<true>(p, sph, lists + (size_t)tile * p.list_stride,
                    shlists + (size_t)tile * p.list_stride, s_lst, s_sph);
  stage_planes(p, pl_g, s_pl);  // its barrier publishes the lists too
  const Ray r = block_ray(p, cam);
  const Vec3 o = {__ldg(cam + C_POSX), __ldg(cam + C_POSY), __ldg(cam + C_POSZ)};
  int* gate0 = gates + (size_t)tile * 2 * (p.ns + p.np);
  const int L = p.list_stride - 1;
  ShFwd f;
  sh_forward(p, cam, StagedList{s_lst, s_sph, L},
             StagedList{s_lst + p.list_stride, s_sph + STAGED * L, L}, s_pl, gate0,
             gate0 + p.ns + p.np, s_ccol, s_cache, r.d, o, &f);
  const size_t plane = (size_t)p.hp * p.wp;
  const size_t pix = pixel_index(p);
  const float vals[N_PLANES_SH] = {f.rgb[0], f.rgb[1], f.rgb[2], f.depth, f.n[0], f.n[1], f.n[2],
                                   1.0f - expf(p.bg_logit - f.m) * f.inv_s, f.m, f.s, f.vis,
                                   f.dv[0], f.dv[1], f.dv[2]};
  for (int i = 0; i < N_PLANES_SH; ++i) out[i * plane + pix] = vals[i];
  if (STATS && threadIdx.x == 0 && threadIdx.y == 0) {
    counts[tile * 2] = f.count;
    counts[tile * 2 + 1] = f.napp;
  }
}

__global__ void __launch_bounds__(MAX_THREADS, K5_MIN_BLOCKS)
soft_sh_bwd_kernel(SoftParams p, const float* __restrict__ cam, const float* __restrict__ sph,
                   const float* __restrict__ pl_g, const int* __restrict__ lists,
                   const int* __restrict__ shlists, const int* __restrict__ offsets,
                   const int* __restrict__ sh_offsets, const int* __restrict__ gates,
                   const float* __restrict__ sav, const float* __restrict__ g,
                   float* __restrict__ pvals, float* __restrict__ psh, float* __restrict__ ppl,
                   float* __restrict__ ptf) {
  extern __shared__ float s_pl[];  // [12, NP] planes, then the stash [ST_FIELDS, threads]
  __shared__ Reduce sm;
  __shared__ Slab sb;
  stage_planes(p, pl_g, s_pl);
  const int tile = tile_index(p);
  const Stash st(s_pl + PL_ROWS * p.np);
  const Vec3 d = stash_ray(block_ray(p, cam), st);
  const Vec3 o = {__ldg(cam + C_POSX), __ldg(cam + C_POSY), __ldg(cam + C_POSZ)};
  const size_t plane = (size_t)p.hp * p.wp;
  const size_t pix = pixel_index(p);
  const float m = sav[SO_M * plane + pix];
  const float inv_s = 1.0f / sav[SO_S * plane + pix];
  const float w_bg = expf(p.bg_logit - m) * inv_s;
  const float g_rgb[3] = {g[pix], g[plane + pix], g[2 * plane + pix]};
  const float g_vis = g_rgb[0] * sav[SO_DVR * plane + pix] + g_rgb[1] * sav[(SO_DVR + 1) * plane + pix] +
                      g_rgb[2] * sav[(SO_DVR + 2) * plane + pix];
  float S = g_rgb[0] * sav[pix];
  S = S + g_rgb[1] * sav[plane + pix];
  S = S + g_rgb[2] * sav[2 * plane + pix];
  st.put(ST_M, m);
  st.put(ST_INV_S, inv_s);
  st.put(ST_S, S);
  for (int c = 0; c < 3; ++c) {
    st.put(ST_GV + c, g_rgb[c]);
    st.put(ST_GV + 4 + c, g[(SO_NX + c) * plane + pix]);
    st.put(ST_ON + c, sav[(SO_NX + c) * plane + pix]);
  }
  st.put(ST_GDEPTH0, g[SO_DEPTH * plane + pix]);
  st.put(ST_GAW, g[SO_ALPHA * plane + pix] * w_bg);
  st.put(ST_VIS, sav[SO_VIS * plane + pix]);
  st.put(ST_DEPTH, sav[SO_DEPTH * plane + pix]);
  const int* gate0 = gates + (size_t)tile * 2 * (p.ns + p.np);
  sh_backward<12>(p, cam, sph, s_pl, lists + (size_t)tile * p.list_stride,
                  shlists + (size_t)tile * p.list_stride, gate0, gate0 + p.ns + p.np, tile,
                  __ldg(offsets + tile), __ldg(sh_offsets + tile), d, o, g_vis, st, &sm, &sb,
                  pvals, psh, ppl, ptf);
}

// K6's tile classes. A tile whose view list and shadow list are both empty
// (67 % of the bench headline's 8160 tiles: sky, and ground that no sphere
// shades) runs no sphere work: its forward, shadow sweep and backward see the
// planes alone. The full kernel is built for the worst tile, K6_MIN_BLOCKS
// blocks an SM; such tiles run a variant with both lists' sweeps and their
// staged rows compiled out (k6_tile<false>), built for K6_LEAN_MIN_BLOCKS.
// Each tile's arithmetic, and so every partial row it writes, is the same in
// either variant: in the full kernel a plane-only tile's list loops run zero
// times. The split reads nothing back to the host, so the step stays one CUDA
// graph: the entry zeroes the header of a work buffer the wrapper allocates,
// soft_sh_mse_classify writes each class's tiles and counts there, and each
// variant runs as many blocks as fit the card at once, each of which stages
// the planes once and claims its class's tiles one at a time from a counter
// in the buffer (the next claim's atomicAdd is in flight while the block
// works on its tile), so that a slow tile holds back one block, not a share
// of the tiles. Measured at the bench headline (PERF.md section 6), a call
// of a CUDA graph: a grid of one block a tile for each variant, each block
// leaving the other class's tiles, 0.307 ms; these blocks 0.280 with the
// variants in turn and 0.255 at once (rtwc_soft_sh_mse); a one-block
// classification alone 0.026 ms, where 32 blocks take 0.0026. At exit a
// block adds the tiles it ran to tiles_run[class] (the counters
// k6.tiles_plane_only, k6.tiles_full of render/shadow_kernel.py).
constexpr int K6_WORK_HEADER = 4;  // the classes' tile counts, then their claim counters
constexpr int CLASSIFY_THREADS = 256;
// Blocks an SM the plane-only variant is built for: 4, 64 registers and
// 132 B of spill stores. K6 took 0.2590 / 0.2548 / 0.2627 ms at 3 / 4 / 5
// at the headline, 1.334 / 1.315 / 1.310 at 4K / 200; the plane-only tiles
// alone, in the full kernel at 2 / 3 / 4, 0.168 / 0.150 / 0.152: their
// sweeps' arithmetic bounds them, not latency.
constexpr int K6_LEAN_MIN_BLOCKS = 4;

// The classes, one tile a thread: each block puts its plane-only tiles at
// work + K6_WORK_HEADER and its others at work + K6_WORK_HEADER + n_tiles,
// each in tile order, at places it takes with one atomicAdd a class on the
// counts work[0], work[1] (zero at launch). The order of the blocks' runs is
// the order of their atomics; no sum depends on it.
__global__ void __launch_bounds__(CLASSIFY_THREADS)
soft_sh_mse_classify(const int* __restrict__ lists, const int* __restrict__ shlists, int n_tiles,
                     int stride, int* __restrict__ work) {
  constexpr int NW = CLASSIFY_THREADS / 32;
  __shared__ int s_warp[2][NW];
  __shared__ int s_base[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x * CLASSIFY_THREADS + tid;
  bool po = false;
  if (t < n_tiles)
    po = (__ldg(lists + (size_t)t * stride) | __ldg(shlists + (size_t)t * stride)) == 0;
  const bool full = t < n_tiles && !po;
  const unsigned b_po = __ballot_sync(FULL, po), b_full = __ballot_sync(FULL, full);
  const unsigned below = (1u << lane) - 1u;
  if (lane == 0) {
    s_warp[0][warp] = __popc(b_po);
    s_warp[1][warp] = __popc(b_full);
  }
  __syncthreads();
  if (tid < 2) {  // each class's warps in order, then the block's places
    int sum = 0;
    for (int w = 0; w < NW; ++w) {
      const int n = s_warp[tid][w];
      s_warp[tid][w] = sum;
      sum += n;
    }
    s_base[tid] = atomicAdd(work + tid, sum);
  }
  __syncthreads();
  int* order = work + K6_WORK_HEADER;
  if (po) order[s_base[0] + s_warp[0][warp] + __popc(b_po & below)] = t;
  if (full) order[n_tiles + s_base[1] + s_warp[1][warp] + __popc(b_full & below)] = t;
}

// One tile of K6: K4's forward, the masked MSE and its cotangents, K5's
// sweeps at loss-cotangent 1. SPHERES false: the plane-only variant, which
// stages no list and sweeps no sphere. The caller staged the planes.
template <bool SPHERES>
__device__ __forceinline__ void k6_tile(
    const SoftParams& p, const float* __restrict__ cam, const float* __restrict__ sph,
    const int* __restrict__ lists, const int* __restrict__ shlists,
    const int* __restrict__ offsets, const int* __restrict__ sh_offsets,
    const float* __restrict__ tgt, float* __restrict__ pvals, float* __restrict__ psh,
    float* __restrict__ ppl, float* __restrict__ ptf, int tile, const float* s_pl,
    float* s_ccol, int* s_gate, int* s_lst, float* s_sph, float* s_cache, Reduce* sm,
    Slab* sb) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int e = tid; e < 2 * (p.ns + p.np); e += blockDim.x * blockDim.y) s_gate[e] = 0;
  const int* lst = lists + (size_t)tile * p.list_stride;
  const int* shl = shlists + (size_t)tile * p.list_stride;
  if constexpr (SPHERES) stage_lists<true>(p, sph, lst, shl, s_lst, s_sph);
  __syncthreads();  // the zeroed gates and the staged lists
  const int gx = p.wp / p.bw, ty = tile / gx, tx = tile - ty * gx;
  const Ray r = tile_ray(p, cam, ty, tx);
  const Vec3 o = {__ldg(cam + C_POSX), __ldg(cam + C_POSY), __ldg(cam + C_POSZ)};
  const int L = p.list_stride - 1;
  ShFwd f;
  // sh_forward ends with a __syncthreads after its last gate write
  sh_forward<SPHERES>(p, cam, StagedList{s_lst, s_sph, L},
                      StagedList{s_lst + p.list_stride, s_sph + STAGED * L, L}, s_pl, s_gate,
                      s_gate + p.ns + p.np, s_ccol, s_cache, r.d, o, &f);
  const Stash st(s_cache);
  const Vec3 d = stash_ray(r, st);
  const size_t plane = (size_t)p.hp * p.wp;
  const int row = ty * p.bh + threadIdx.y, col = tx * p.bw + threadIdx.x;
  const size_t pix = (size_t)row * p.wp + col;
  const float mask = (row < p.loss_h && col < p.loss_w) ? 1.0f : 0.0f;
  float diff[3], g_rgb[3];
  for (int c = 0; c < 3; ++c) {
    diff[c] = (f.rgb[c] - tgt[c * plane + pix]) * mask;
    g_rgb[c] = p.loss_scale * diff[c];
  }
  const float loss_px = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2];
  const float g_vis = g_rgb[0] * f.dv[0] + g_rgb[1] * f.dv[1] + g_rgb[2] * f.dv[2];
  float S = g_rgb[0] * f.rgb[0];
  S = S + g_rgb[1] * f.rgb[1];
  S = S + g_rgb[2] * f.rgb[2];
  st.put(ST_M, f.m);
  st.put(ST_INV_S, f.inv_s);
  st.put(ST_S, S);
  for (int c = 0; c < 3; ++c) {  // the loss has no depth, normal or alpha cotangent
    st.put(ST_GV + c, g_rgb[c]);
    st.put(ST_GV + 4 + c, 0.0f);
    st.put(ST_ON + c, f.n[c]);
  }
  st.put(ST_GDEPTH0, 0.0f);
  st.put(ST_GAW, 0.0f);
  st.put(ST_LOSS, loss_px);
  st.put(ST_VIS, f.vis);
  st.put(ST_DEPTH, f.depth);
  sh_backward<13, SPHERES>(p, cam, sph, s_pl, lst, shl, s_gate, s_gate + p.ns + p.np, tile,
                           SPHERES ? __ldg(offsets + tile) : 0,
                           SPHERES ? __ldg(sh_offsets + tile) : 0, d, o, g_vis, st, sm, sb,
                           pvals, psh, ppl, ptf);
}

// K6, one variant a tile class: PLANE_ONLY takes the plane-only tiles at
// K6_LEAN_MIN_BLOCKS blocks an SM, the full kernel the others at
// K6_MIN_BLOCKS. Each block stages the planes once, then claims its class's
// tiles (soft_sh_mse_classify's) until none is left.
template <bool PLANE_ONLY>
__global__ void __launch_bounds__(MAX_THREADS, PLANE_ONLY ? K6_LEAN_MIN_BLOCKS : K6_MIN_BLOCKS)
soft_sh_mse_kernel(SoftParams p, const float* __restrict__ cam, const float* __restrict__ sph,
                   const float* __restrict__ pl_g, const int* __restrict__ lists,
                   const int* __restrict__ shlists, const int* __restrict__ offsets,
                   const int* __restrict__ sh_offsets, const float* __restrict__ tgt,
                   float* __restrict__ pvals, float* __restrict__ psh, float* __restrict__ ppl,
                   float* __restrict__ ptf, int* __restrict__ work,
                   unsigned long long* __restrict__ tiles_run) {
  // k6_smem's layout: [12, NP] planes, [NC, 3] cache colours, 2 (NS + NP)
  // gate ints, the list rows and their staged spheres (StagedList, as K4's;
  // the full kernel only), then the clamp cache [NC, 3, threads], whose space
  // the stash [ST_FIELDS, threads] takes once the forward is done
  extern __shared__ float s_pl[];
  __shared__ Reduce sm;
  __shared__ Slab sb;
  __shared__ int s_claim;
  constexpr int cls = PLANE_ONLY ? 0 : 1;
  float* s_ccol = s_pl + PL_ROWS * p.np;
  int* s_gate = reinterpret_cast<int*>(s_ccol + 3 * NC);
  int* s_lst = s_gate + 2 * (p.ns + p.np);
  float* s_sph = reinterpret_cast<float*>(s_lst + (PLANE_ONLY ? 0 : 2 * p.list_stride));
  float* s_cache = s_sph + (PLANE_ONLY ? 0 : 2 * STAGED * (p.list_stride - 1));
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_tiles = (p.wp / p.bw) * (p.hp / p.bh);
  const int n = work[cls];
  const int* order = work + K6_WORK_HEADER + cls * n_tiles;
  int* claim = work + 2 + cls;
  stage_planes(p, pl_g, s_pl);  // once a block: every tile reads the same planes
  int next = tid == 0 ? atomicAdd(claim, 1) : 0;
  int ran = 0;
  for (;;) {
    if (tid == 0) s_claim = next;
    __syncthreads();  // also: the last tile's reads of shared memory are done
    const int i = s_claim;
    if (i >= n) break;
    if (tid == 0) next = atomicAdd(claim, 1);  // in flight while this tile runs
    k6_tile<!PLANE_ONLY>(p, cam, sph, lists, shlists, offsets, sh_offsets, tgt, pvals, psh, ppl,
                         ptf, __ldg(order + i), s_pl, s_ccol, s_gate, s_lst, s_sph, s_cache, &sm,
                         &sb);
    ++ran;
  }
  if (tid == 0 && ran > 0) atomicAdd(tiles_run + cls, (unsigned long long)ran);
}

// K6's dynamic shared memory (the kernel's layout); the plane-only variant
// stages no list.
inline size_t k6_smem(const SoftParams& p, bool plane_only) {
  const size_t lists = plane_only ? 0
                                  : sizeof(int) * 2 * (size_t)p.list_stride +
                                        sizeof(float) * 2 * STAGED * (size_t)(p.list_stride - 1);
  return sizeof(float) * (PL_ROWS * (size_t)p.np + 3 * NC) +
         sizeof(int) * 2 * (size_t)(p.ns + p.np) + lists +
         sizeof(float) * (3 * NC > ST_FIELDS ? 3 * NC : ST_FIELDS) * MAX_THREADS;
}

// One class's launch: as many blocks as fit the card at once, at most one a
// tile.
template <bool PLANE_ONLY>
int launch_k6(const SoftParams& p, int n_tiles, cudaStream_t stream, const float* cam,
              const float* sph, const float* pl, const int* lists, const int* shlists,
              const int* offsets, const int* sh_offsets, const float* tgt, float* pvals,
              float* psh, float* ppl, float* ptf, int* work, unsigned long long* tiles_run) {
  const size_t smem = k6_smem(p, PLANE_ONLY);
  if (int rc = prepare(soft_sh_mse_kernel<PLANE_ONLY>, p, smem,
                       sizeof(Reduce) + sizeof(Slab) + sizeof(int)))
    return rc;
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, soft_sh_mse_kernel<PLANE_ONLY>, p.bw * p.bh, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, p.device);
  if (err != cudaSuccess) return (int)err;
  soft_sh_mse_kernel<PLANE_ONLY><<<max(1, min(n_tiles, per_sm * sms)), dim3(p.bw, p.bh), smem,
                                   stream>>>(p, cam, sph, pl, lists, shlists, offsets,
                                             sh_offsets, tgt, pvals, psh, ppl, ptf, work,
                                             tiles_run);
  return (int)cudaGetLastError();
}

// C entries for ctypes, as in soft_render.cu: device pointers of contiguous
// tensors the wrapper (render/shadow_kernel.py) has checked and allocated,
// PyTorch's current stream; each returns the launch's cudaError_t and does
// not synchronise. rtwc_soft_sh_fwd launches the K4-stats variant when
// `counts` is not null.
extern "C" int rtwc_soft_sh_fwd(const float* cam, const float* sph, const float* pl,
                                const int* lists, const int* shlists, float* out, int* gates,
                                int* counts, const SoftParams* params, void* stream) {
  const SoftParams p = *params;
  const size_t smem = sh_fwd_smem(p.np, p.list_stride);
  const dim3 grid(p.wp / p.bw, p.hp / p.bh), block(p.bw, p.bh);
  if (counts) {
    if (int rc = prepare(soft_sh_fwd_kernel<true>, p, smem)) return rc;
    soft_sh_fwd_kernel<true><<<grid, block, smem, (cudaStream_t)stream>>>(
        p, cam, sph, pl, lists, shlists, out, gates, counts);
  } else {
    if (int rc = prepare(soft_sh_fwd_kernel<false>, p, smem)) return rc;
    soft_sh_fwd_kernel<false><<<grid, block, smem, (cudaStream_t)stream>>>(
        p, cam, sph, pl, lists, shlists, out, gates, counts);
  }
  return (int)cudaGetLastError();
}

extern "C" int rtwc_soft_sh_bwd(const float* cam, const float* sph, const float* pl,
                                const int* lists, const int* shlists, const int* offsets,
                                const int* sh_offsets, const int* gates, const float* sav,
                                const float* g, float* pvals, float* psh, float* ppl, float* ptf,
                                const SoftParams* params, void* stream) {
  const SoftParams p = *params;
  const size_t smem = sizeof(float) * (PL_ROWS * (size_t)p.np + ST_FIELDS * MAX_THREADS);
  if (int rc = prepare(soft_sh_bwd_kernel, p, smem, sizeof(Reduce) + sizeof(Slab))) return rc;
  soft_sh_bwd_kernel<<<dim3(p.wp / p.bw, p.hp / p.bh), dim3(p.bw, p.bh), smem,
                       (cudaStream_t)stream>>>(p, cam, sph, pl, lists, shlists, offsets,
                                               sh_offsets, gates, sav, g, pvals, psh, ppl, ptf);
  return (int)cudaGetLastError();
}

// The side stream and the two events of K6's fork, one set a device, made by
// the device's first call.
struct K6Fork {
  cudaStream_t side = nullptr;
  cudaEvent_t go = nullptr, done = nullptr;
};
static K6Fork k6_forks[64];

// K6: the classes, then the full kernel on the tiles that list a sphere on
// the caller's stream and the plane-only variant on the rest on a side
// stream, joined before the entry returns. The two run at once (a capture
// holds them as two branches of the graph), so the plane-only blocks fill
// the SMs that the full kernel's last tiles leave, and the step waits at one
// kernel's end, not at two in turn (PERF.md section 6). `work`
// holds K6_WORK_HEADER + 2 n_tiles ints (the entry zeroes the header; the
// classes' launch writes the rest); tiles_run [2] counts the tiles each
// variant ran, summed over calls.
extern "C" int rtwc_soft_sh_mse(const float* cam, const float* sph, const float* pl,
                                const int* lists, const int* shlists, const int* offsets,
                                const int* sh_offsets, const float* tgt, float* pvals, float* psh,
                                float* ppl, float* ptf, int* work, unsigned long long* tiles_run,
                                const SoftParams* params, void* stream) {
  const SoftParams p = *params;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (p.wp / p.bw) * (p.hp / p.bh);
  if (p.device < 0 || p.device >= 64) return (int)cudaErrorInvalidDevice;
  K6Fork& f = k6_forks[p.device];
  cudaError_t err = cudaSetDevice(p.device);
  if (err == cudaSuccess && !f.side) {
    err = cudaStreamCreateWithFlags(&f.side, cudaStreamNonBlocking);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&f.go, cudaEventDisableTiming);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&f.done, cudaEventDisableTiming);
  }
  if (err == cudaSuccess) err = cudaMemsetAsync(work, 0, sizeof(int) * K6_WORK_HEADER, s);
  if (err != cudaSuccess) return (int)err;
  soft_sh_mse_classify<<<(n_tiles + CLASSIFY_THREADS - 1) / CLASSIFY_THREADS, CLASSIFY_THREADS, 0,
                         s>>>(lists, shlists, n_tiles, p.list_stride, work);
  if ((err = cudaGetLastError()) == cudaSuccess) err = cudaEventRecord(f.go, s);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(f.side, f.go, 0);
  if (err != cudaSuccess) return (int)err;
  if (int rc = launch_k6<false>(p, n_tiles, s, cam, sph, pl, lists, shlists, offsets, sh_offsets,
                                tgt, pvals, psh, ppl, ptf, work, tiles_run))
    return rc;
  if (int rc = launch_k6<true>(p, n_tiles, f.side, cam, sph, pl, lists, shlists, offsets,
                               sh_offsets, tgt, pvals, psh, ppl, ptf, work, tiles_run))
    return rc;
  if ((err = cudaEventRecord(f.done, f.side)) != cudaSuccess) return (int)err;
  return (int)cudaStreamWaitEvent(s, f.done, 0);
}
