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
//      two-float block sums here plus `soft_grad_reduce`.
// The plain torch versions are in render/soft_kernel.py; the device
// functions and hand-written adjoints in soft_common.cuh.
//
// Design. One thread per pixel, one block per broad-phase tile (bh x bw
// pixels, threadIdx.x along the width), as K7. The block reads its own list
// row; sphere parameters come through __ldg with a block-uniform index (a
// broadcast), the plane table is staged in shared memory. Culling is
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
// warp order, by one thread. soft_grad_reduce sums the partials: each of
// 256 threads walks a fixed chunk in tile order, then a fixed tree. No
// float atomics anywhere: the tables are bit-equal from launch to launch.
//
// What bounds it. Per pixel, K1 does O(list + planes) object evaluations
// (two transcendentals each in the penalties plus an exp per softmin step),
// K2 and K3 a forward replay and a hand-written adjoint per gated object,
// and a few dozen shuffles per gated object per block for the sums. Stores
// are 40 B per pixel (K1), reads 80 B per pixel (K2), i.e. 83 / 166 MB at
// 1080p: about 25 / 50 us at 3.35 TB/s. The kernels are compute- and
// latency-bound (registers carry the saved planes, the cotangents and the
// ray residuals), and at the sizes of the train path the torch work around
// them (broad phase, pack, optimiser) is as large. A simple design that is
// right comes first; making it fast is later work.
//
// Float semantics follow the plain versions op for op; compiled with
// -fmad=false (see soft_common.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "soft_common.cuh"

using namespace soft;

struct ReduceParams {
  int ns, np, n_entries, n_tiles, ntf, device;
};

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ Sphere load_sphere(const float* __restrict__ sph, int ns, int k) {
  Sphere s;
  s.cx = __ldg(sph + S_CX * ns + k);
  s.cy = __ldg(sph + S_CY * ns + k);
  s.cz = __ldg(sph + S_CZ * ns + k);
  s.r = __ldg(sph + S_R * ns + k);
  s.col[0] = __ldg(sph + S_COLR * ns + k);
  s.col[1] = __ldg(sph + S_COLG * ns + k);
  s.col[2] = __ldg(sph + S_COLB * ns + k);
  return s;
}

__device__ __forceinline__ Plane load_plane(const float* s_pl, int np, int k) {
  Plane q;
  q.cx = s_pl[P_CX * np + k];
  q.cy = s_pl[P_CY * np + k];
  q.cz = s_pl[P_CZ * np + k];
  q.nx = s_pl[P_NX * np + k];
  q.ny = s_pl[P_NY * np + k];
  q.nz = s_pl[P_NZ * np + k];
  q.hw = s_pl[P_HW * np + k];
  q.hh = s_pl[P_HH * np + k];
  q.col[0] = s_pl[P_COLR * np + k];
  q.col[1] = s_pl[P_COLG * np + k];
  q.col[2] = s_pl[P_COLB * np + k];
  return q;
}

// Block sum of N values per thread; thread 0 gets the totals in out[].
// Warp butterflies, then the warps' sums in warp order (block_sum_plain).
template <int N>
__device__ __forceinline__ void block_sum(float v[N], float* s_red, float out[N]) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = (blockDim.x * blockDim.y) >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i)
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_down_sync(FULL, v[i], off);
  if (lane == 0)
    for (int i = 0; i < N; ++i) s_red[warp * N + i] = v[i];
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < N; ++i) {
      float a = s_red[i];
      for (int w = 1; w < nwarps; ++w) a = a + s_red[w * N + i];
      out[i] = a;
    }
  }
  __syncthreads();
}

// Two-float block sum of N values per thread (block_tf_sum_plain).
template <int N>
__device__ __forceinline__ void block_tf_sum(const float v[N], float* s_red, float hi[N],
                                             float lo[N]) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = (blockDim.x * blockDim.y) >> 5;
  float s[N], e[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = v[i];
    e[i] = 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      const float s2 = __shfl_down_sync(FULL, s[i], off);
      const float e2 = __shfl_down_sync(FULL, e[i], off);
      tf_combine(s[i], e[i], s2, e2, &s[i], &e[i]);
    }
  }
  if (lane == 0)
    for (int i = 0; i < N; ++i) {
      s_red[(warp * N + i) * 2] = s[i];
      s_red[(warp * N + i) * 2 + 1] = e[i];
    }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < N; ++i) {
      float a = s_red[2 * i], b = s_red[2 * i + 1];
      for (int w = 1; w < nwarps; ++w)
        tf_combine(a, b, s_red[(w * N + i) * 2], s_red[(w * N + i) * 2 + 1], &a, &b);
      hi[i] = a;
      lo[i] = b;
    }
  }
  __syncthreads();
}

// One online-softmin step (pallas_soft.py:1236-1252).
template <int NACC>
__device__ __forceinline__ void accumulate(const SoftParams& p, const ObjOut& v, float* m,
                                           float* s, float acc[NACC]) {
  const float vals[7] = {v.rgb[0], v.rgb[1], v.rgb[2], v.t_clip, v.nx, v.ny, v.nz};
  const float logit = -v.t_eff * p.inv_tau;
  const float m_new = fmaxf(*m, logit);
  const float e = expf(-fabsf(logit - *m));
  const bool up = logit > *m;
  const float alpha = up ? e : 1.0f;
  const float pw = up ? 1.0f : e;
  *s = *s * alpha + pw;
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = acc[i] * alpha + pw * vals[i];
  *m = m_new;
}

// K1's sweep (also K3's forward): the tile's sphere list, then every live
// plane. gate_row[k] (spheres) / gate_row[ns + k] (planes) gets the
// block's decision, written by thread 0.
template <int NACC>
__device__ void forward_sweep(const SoftParams& p, const float* __restrict__ cam,
                              const float* __restrict__ sph, const float* s_pl,
                              const int* __restrict__ lst, int* gate_row, Vec3 d, Vec3 o,
                              float* m, float* s, float acc[NACC]) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_list = __ldg(lst);
  for (int kk = 0; kk < n_list; ++kk) {
    const int k = __ldg(lst + 1 + kk);
    const Sphere sp = load_sphere(sph, p.ns, k);
    if (p.cull) {
      float t2, dss;
      const float lb = sphere_lb_ex(p, sp, d, o, &t2, &dss);
      const int rel = __syncthreads_or((-lb * p.inv_tau - *m) > CULL_LOG_EPS);
      if (tid == 0) gate_row[k] = rel ? 1 : 0;
      if (rel) accumulate<NACC>(p, sphere_f_post(p, sp, t2, dss, d, o), m, s, acc);
    } else {
      if (tid == 0) gate_row[k] = 1;
      accumulate<NACC>(p, sphere_f(p, sp, d, o), m, s, acc);
    }
  }
  const int n_pl = (int)__ldg(cam + C_NPL);
  for (int k = 0; k < n_pl; ++k) {
    const Plane q = load_plane(s_pl, p.np, k);
    if (p.cull) {
      float t, denom, px, pz;
      const float lb = plane_lb_ex(p, q, d, o, &t, &denom, &px, &pz);
      const int rel = __syncthreads_or((-lb * p.inv_tau - *m) > CULL_LOG_EPS);
      if (tid == 0) gate_row[p.ns + k] = rel ? 1 : 0;
      if (rel) accumulate<NACC>(p, plane_f_post(p, q, t, denom, px, pz, d, o), m, s, acc);
    } else {
      if (tid == 0) gate_row[p.ns + k] = 1;
      accumulate<NACC>(p, plane_f(p, q, d, o), m, s, acc);
    }
  }
}

// Output cotangents of one object (pallas_soft.py:1381-1391).
__device__ __forceinline__ ObjOut cotangents(const SoftParams& p, const ObjOut& v, float m,
                                             float inv_s, const float gv[7], float S) {
  const float w = expf(-v.t_eff * p.inv_tau - m) * inv_s;
  float gdotv = gv[0] * v.rgb[0];
  gdotv = gdotv + gv[1] * v.rgb[1];
  gdotv = gdotv + gv[2] * v.rgb[2];
  gdotv = gdotv + gv[3] * v.t_clip;
  gdotv = gdotv + gv[4] * v.nx;
  gdotv = gdotv + gv[5] * v.ny;
  gdotv = gdotv + gv[6] * v.nz;
  const float dlogit = w * (gdotv - S);
  ObjOut ct;
  ct.t_eff = -dlogit * p.inv_tau;
  ct.rgb[0] = w * gv[0];
  ct.rgb[1] = w * gv[1];
  ct.rgb[2] = w * gv[2];
  ct.t_clip = w * gv[3];
  ct.nx = w * gv[4];
  ct.ny = w * gv[5];
  ct.nz = w * gv[6];
  return ct;
}

struct Reduce {
  float red[MAX_WARPS * 11];
  float tf[MAX_WARPS * NTF * 2];
};

// K2's sweep (also K3's backward). Writes the block's partials: NTFB
// two-float slots, the twelve camera cotangents and, for K3 (NTFB = 13),
// the loss from each pixel's loss_px.
template <int NTFB>
__device__ void backward_sweep(const SoftParams& p, const float* __restrict__ cam,
                               const float* __restrict__ sph, const float* s_pl,
                               const int* __restrict__ lst, const int* gate_row, int tile,
                               int offset, const Ray& r, Vec3 o, float m, float inv_s,
                               const float gv[7], float S, float loss_px, Reduce* sm,
                               float* __restrict__ pvals, float* __restrict__ ppl,
                               float* __restrict__ ptf) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  Vec3 gd = {0.0f, 0.0f, 0.0f}, go = {0.0f, 0.0f, 0.0f};
  const int n_list = __ldg(lst);
  for (int kk = 0; kk < n_list; ++kk) {
    const int k = __ldg(lst + 1 + kk);
    if (p.cull && gate_row[k] != 1) continue;  // block-uniform
    const Sphere sp = load_sphere(sph, p.ns, k);
    const ObjOut v = sphere_f(p, sp, r.d, o);
    const ObjOut ct = cotangents(p, v, m, inv_s, gv, S);
    float g[7], tot[7];
    Vec3 cd, co;
    sphere_f_vjp(p, sp, r.d, o, ct, g, &cd, &co);
    gd.x = gd.x + cd.x;
    gd.y = gd.y + cd.y;
    gd.z = gd.z + cd.z;
    go.x = go.x + co.x;
    go.y = go.y + co.y;
    go.z = go.z + co.z;
    block_sum<7>(g, sm->red, tot);
    if (tid == 0)
      for (int i = 0; i < 7; ++i) pvals[(size_t)(offset + kk) * 8 + i] = tot[i];
  }
  const int n_pl = (int)__ldg(cam + C_NPL);
  for (int k = 0; k < n_pl; ++k) {
    if (p.cull && gate_row[p.ns + k] != 1) continue;
    const Plane q = load_plane(s_pl, p.np, k);
    const ObjOut v = plane_f(p, q, r.d, o);
    const ObjOut ct = cotangents(p, v, m, inv_s, gv, S);
    float g[11], tot[11];
    Vec3 cd, co;
    plane_f_vjp(p, q, r.d, o, ct, g, &cd, &co);
    gd.x = gd.x + cd.x;
    gd.y = gd.y + cd.y;
    gd.z = gd.z + cd.z;
    go.x = go.x + co.x;
    go.y = go.y + co.y;
    go.z = go.z + co.z;
    block_sum<11>(g, sm->red, tot);
    if (tid == 0)
      for (int i = 0; i < 11; ++i) ppl[((size_t)tile * p.np + k) * PL_ROWS + i] = tot[i];
  }
  // camera: position cotangents and the raygen VJP, two-float
  float v[NTFB], hi[NTFB], lo[NTFB];
  v[0] = go.x;
  v[1] = go.y;
  v[2] = go.z;
  raygen_vjp(r, gd, v + 3);
  if constexpr (NTFB > SLOT_LOSS) v[SLOT_LOSS] = loss_px;
  block_tf_sum<NTFB>(v, sm->tf, hi, lo);
  if (tid == 0)
    for (int i = 0; i < NTFB; ++i) {
      ptf[((size_t)tile * NTF + i) * 2] = hi[i];
      ptf[((size_t)tile * NTF + i) * 2 + 1] = lo[i];
    }
}

__device__ __forceinline__ void stage_planes(const SoftParams& p, const float* pl_g, float* s_pl) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int e = tid; e < PL_ROWS * p.np; e += blockDim.x * blockDim.y) s_pl[e] = pl_g[e];
  __syncthreads();
}

__device__ __forceinline__ Ray block_ray(const SoftParams& p, const float* cam) {
  const float rowf = __ldg(cam + C_ROW0) + (float)(blockIdx.y * p.bh) + (float)threadIdx.y;
  const float colf = (float)(blockIdx.x * p.bw) + (float)threadIdx.x;
  return raygen(p, cam, rowf, colf);
}

}  // namespace

__global__ void __launch_bounds__(MAX_THREADS)
soft_fwd_kernel(SoftParams p, const float* __restrict__ cam, const float* __restrict__ sph,
                const float* __restrict__ pl_g, const int* __restrict__ lists,
                float* __restrict__ out, int* __restrict__ gates) {
  extern __shared__ float s_pl[];
  stage_planes(p, pl_g, s_pl);
  const int tile = blockIdx.y * (p.wp / p.bw) + blockIdx.x;
  const Ray r = block_ray(p, cam);
  const Vec3 o = {__ldg(cam + C_POSX), __ldg(cam + C_POSY), __ldg(cam + C_POSZ)};
  float m = p.bg_logit, s = 1.0f;
  float acc[7] = {0.0f, 0.0f, 0.0f, p.far, 0.0f, 0.0f, 0.0f};
  forward_sweep<7>(p, cam, sph, s_pl, lists + (size_t)tile * p.list_stride,
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

__global__ void __launch_bounds__(MAX_THREADS)
soft_bwd_kernel(SoftParams p, const float* __restrict__ cam, const float* __restrict__ sph,
                const float* __restrict__ pl_g, const int* __restrict__ lists,
                const int* __restrict__ offsets, const int* __restrict__ gates,
                const float* __restrict__ sav, const float* __restrict__ g,
                float* __restrict__ pvals, float* __restrict__ ppl, float* __restrict__ ptf) {
  extern __shared__ float s_pl[];
  __shared__ Reduce sm;
  stage_planes(p, pl_g, s_pl);
  const int tile = blockIdx.y * (p.wp / p.bw) + blockIdx.x;
  const Ray r = block_ray(p, cam);
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
  backward_sweep<12>(p, cam, sph, s_pl, lists + (size_t)tile * p.list_stride,
                     gates + (size_t)tile * 2 * (p.ns + p.np), tile, __ldg(offsets + tile), r, o,
                     m, inv_s, gv, S, 0.0f, &sm, pvals, ppl, ptf);
}

__global__ void __launch_bounds__(MAX_THREADS)
soft_mse_kernel(SoftParams p, const float* __restrict__ cam, const float* __restrict__ sph,
                const float* __restrict__ pl_g, const int* __restrict__ lists,
                const int* __restrict__ offsets, const float* __restrict__ tgt,
                float* __restrict__ pvals, float* __restrict__ ppl, float* __restrict__ ptf) {
  extern __shared__ float s_pl[];  // [12, NP] floats, then NS + NP gate ints
  __shared__ Reduce sm;
  int* s_gate = reinterpret_cast<int*>(s_pl + PL_ROWS * p.np);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int e = tid; e < p.ns + p.np; e += blockDim.x * blockDim.y) s_gate[e] = 0;
  stage_planes(p, pl_g, s_pl);
  const int tile = blockIdx.y * (p.wp / p.bw) + blockIdx.x;
  const int* lst = lists + (size_t)tile * p.list_stride;
  const Ray r = block_ray(p, cam);
  const Vec3 o = {__ldg(cam + C_POSX), __ldg(cam + C_POSY), __ldg(cam + C_POSZ)};
  float m = p.bg_logit, s = 1.0f;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  forward_sweep<3>(p, cam, sph, s_pl, lst, s_gate, r.d, o, &m, &s, acc);
  __syncthreads();  // the gates, written by thread 0, are read by all below
  const float inv_s = 1.0f / s;
  const size_t plane = (size_t)p.hp * p.wp;
  const int row = blockIdx.y * p.bh + threadIdx.y, col = blockIdx.x * p.bw + threadIdx.x;
  const size_t pix = (size_t)row * p.wp + col;
  const float mask = (row < p.loss_h && col < p.loss_w) ? 1.0f : 0.0f;
  float out[3], diff[3], gv[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = 0; c < 3; ++c) {
    out[c] = acc[c] * inv_s;
    diff[c] = (out[c] - tgt[c * plane + pix]) * mask;
    gv[c] = p.loss_scale * diff[c];
  }
  const float S = gv[0] * out[0] + gv[1] * out[1] + gv[2] * out[2];
  const float loss_px = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2];
  backward_sweep<13>(p, cam, sph, s_pl, lst, s_gate, tile, __ldg(offsets + tile), r, o, m, inv_s,
                     gv, S, loss_px, &sm, pvals, ppl, ptf);
}

__global__ void __launch_bounds__(256)
soft_grad_reduce_kernel(ReduceParams rp, const float* __restrict__ pvals,
                        const int* __restrict__ pidx, const float* __restrict__ ppl,
                        const float* __restrict__ ptf, float* __restrict__ dsph,
                        float* __restrict__ dpl, float* __restrict__ dtf) {
  __shared__ float s_a[11][256];
  __shared__ float s_e[256];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  if (b < rp.ns) {  // one sphere: its entries, in tile order
    const int k = b;
    const int chunk = max(1, (rp.n_entries + 255) / 256);
    float acc[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const int e1 = min(rp.n_entries, (tid + 1) * chunk);
    for (int e = tid * chunk; e < e1; ++e)
      if (__ldg(pidx + e) == k)
        for (int i = 0; i < 7; ++i) acc[i] = acc[i] + __ldg(pvals + (size_t)e * 8 + i);
    for (int i = 0; i < 7; ++i) s_a[i][tid] = acc[i];
    __syncthreads();
    for (int stride = 128; stride > 0; stride >>= 1) {
      if (tid < stride)
        for (int i = 0; i < 7; ++i) s_a[i][tid] = s_a[i][tid] + s_a[i][tid + stride];
      __syncthreads();
    }
    if (tid == 0) {
      for (int i = 0; i < 7; ++i) dsph[i * rp.ns + k] = s_a[i][0];
      dsph[7 * rp.ns + k] = 0.0f;
    }
  } else if (b < rp.ns + rp.np) {  // one plane: every tile's row
    const int k = b - rp.ns;
    const int chunk = max(1, (rp.n_tiles + 255) / 256);
    float acc[11];
    for (int i = 0; i < 11; ++i) acc[i] = 0.0f;
    const int t1 = min(rp.n_tiles, (tid + 1) * chunk);
    for (int t = tid * chunk; t < t1; ++t)
      for (int i = 0; i < 11; ++i)
        acc[i] = acc[i] + __ldg(ppl + ((size_t)t * rp.np + k) * PL_ROWS + i);
    for (int i = 0; i < 11; ++i) s_a[i][tid] = acc[i];
    __syncthreads();
    for (int stride = 128; stride > 0; stride >>= 1) {
      if (tid < stride)
        for (int i = 0; i < 11; ++i) s_a[i][tid] = s_a[i][tid] + s_a[i][tid + stride];
      __syncthreads();
    }
    if (tid == 0) {
      for (int i = 0; i < 11; ++i) dpl[i * rp.np + k] = s_a[i][0];
      dpl[11 * rp.np + k] = 0.0f;
    }
  } else {  // one two-float slot: every tile's (hi, lo), error-free
    const int slot = b - rp.ns - rp.np;
    const int chunk = max(1, (rp.n_tiles + 255) / 256);
    float s = 0.0f, e = 0.0f;
    const int t1 = min(rp.n_tiles, (tid + 1) * chunk);
    for (int t = tid * chunk; t < t1; ++t)
      tf_combine(s, e, __ldg(ptf + ((size_t)t * rp.ntf + slot) * 2),
                 __ldg(ptf + ((size_t)t * rp.ntf + slot) * 2 + 1), &s, &e);
    s_a[0][tid] = s;
    s_e[tid] = e;
    __syncthreads();
    for (int stride = 128; stride > 0; stride >>= 1) {
      if (tid < stride)
        tf_combine(s_a[0][tid], s_e[tid], s_a[0][tid + stride], s_e[tid + stride], &s_a[0][tid],
                   &s_e[tid]);
      __syncthreads();
    }
    if (tid == 0) {
      dtf[slot * 2] = s_a[0][0];
      dtf[slot * 2 + 1] = s_e[0];
    }
  }
}

// C entries for ctypes. Pointers are device pointers of contiguous tensors
// the wrapper (render/soft_kernel.py) has checked and allocated; `stream`
// is PyTorch's current stream. Each returns the launch's cudaError_t (0 on
// success) and does not synchronise.
namespace {

template <typename K>
int prepare(K kernel, const SoftParams& p, size_t smem) {
  cudaError_t err = cudaSetDevice(p.device);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" int rtwc_soft_fwd(const float* cam, const float* sph, const float* pl,
                             const int* lists, float* out, int* gates, const SoftParams* params,
                             void* stream) {
  const SoftParams p = *params;
  const size_t smem = sizeof(float) * PL_ROWS * (size_t)p.np;
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
  const size_t smem = sizeof(float) * PL_ROWS * (size_t)p.np;
  if (int rc = prepare(soft_bwd_kernel, p, smem)) return rc;
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
  const size_t smem = sizeof(float) * PL_ROWS * (size_t)p.np + sizeof(int) * (size_t)(p.ns + p.np);
  if (int rc = prepare(soft_mse_kernel, p, smem)) return rc;
  soft_mse_kernel<<<dim3(p.wp / p.bw, p.hp / p.bh), dim3(p.bw, p.bh), smem,
                    (cudaStream_t)stream>>>(p, cam, sph, pl, lists, offsets, tgt, pvals, ppl,
                                            ptf);
  return (int)cudaGetLastError();
}

extern "C" int rtwc_soft_grad_reduce(const float* pvals, const int* pidx, const float* ppl,
                                     const float* ptf, float* dsph, float* dpl, float* dtf,
                                     const ReduceParams* params, void* stream) {
  const ReduceParams rp = *params;
  cudaError_t err = cudaSetDevice(rp.device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = rp.ns + rp.np + rp.ntf;
  soft_grad_reduce_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(rp, pvals, pidx, ppl, ptf,
                                                                    dsph, dpl, dtf);
  return (int)cudaGetLastError();
}
