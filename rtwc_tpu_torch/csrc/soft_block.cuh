// Block-level device code shared by the soft kernels (csrc/soft_render.cu,
// csrc/soft_shadow.cu): table loads, the block sums of the per-block
// partials, the online-softmin step, the forward and backward sweeps and
// the launch helpers. One thread per pixel, one block per (bh, bw)
// broad-phase tile. The plain torch twins are in render/soft_core.py
// (block_sum_plain, block_tf_sum_plain, _accumulate, object_sweep,
// _backward_sweep).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "soft_common.cuh"

namespace soft {

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

// The forward sweep of K1, K3, K4 and K6, and K4's exact re-walk: the
// tile's sphere list, then every live plane (object_sweep in
// render/soft_core.py). With culling, the block takes an object when one of
// its pixels' lower bounds on the object's logit clears *m by CULL_LOG_EPS
// (__syncthreads_or); thread 0 writes the decision to gate_row[k] (spheres)
// or gate_row[ns + k] (planes) unless gate_row is null. visit(g, col, sn)
// gets every object taken: its shading-free geometry, its colour and its
// shading normal; it may move *m.
template <typename Visit>
__device__ __forceinline__ void forward_sweep(const SoftParams& p, const float* __restrict__ cam,
                                              const float* __restrict__ sph, const float* s_pl,
                                              const int* __restrict__ lst, int* gate_row, Vec3 d,
                                              Vec3 o, const float* m, Visit&& visit) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_list = __ldg(lst);
  for (int kk = 0; kk < n_list; ++kk) {
    const int k = __ldg(lst + 1 + kk);
    const Sphere sp = load_sphere(sph, p.ns, k);
    if (p.cull) {
      float t2, dss;
      const float lb = sphere_lb_ex(p, sp, d, o, &t2, &dss);
      const int rel = __syncthreads_or((-lb * p.inv_tau - *m) > CULL_LOG_EPS);
      if (gate_row && tid == 0) gate_row[k] = rel ? 1 : 0;
      if (rel) {
        const Geo g = sphere_geo_post(p, sp, t2, dss, d, o);
        visit(g, sp.col, g.n);
      }
    } else {
      if (gate_row && tid == 0) gate_row[k] = 1;
      const Geo g = sphere_geo(p, sp, d, o);
      visit(g, sp.col, g.n);
    }
  }
  const int n_pl = (int)__ldg(cam + C_NPL);
  for (int k = 0; k < n_pl; ++k) {
    const Plane q = load_plane(s_pl, p.np, k);
    if (p.cull) {
      float t, denom, px, pz;
      const float lb = plane_lb_ex(p, q, d, o, &t, &denom, &px, &pz);
      const int rel = __syncthreads_or((-lb * p.inv_tau - *m) > CULL_LOG_EPS);
      if (gate_row && tid == 0) gate_row[p.ns + k] = rel ? 1 : 0;
      if (rel) visit(plane_geo_post(p, q, t, denom, px, pz, d, o), q.col, plane_unit_n(q));
    } else {
      if (gate_row && tid == 0) gate_row[p.ns + k] = 1;
      visit(plane_geo(p, q, d, o), q.col, plane_unit_n(q));
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

// K2's sweep (also K3's backward, and the main sweep of K5 and K6). Writes
// the block's partials: NTFB two-float slots, the twelve camera cotangents
// and, for K3 / K6 (NTFB = 13), the loss from each pixel's loss_px.
// SHADED (K5, K6): object colours are min(255, A + vis B), the ray
// cotangents start from the shadow sweep's (gd, go), and each plane row
// adds to the shadow sweep's partial already in ppl.
template <int NTFB, bool SHADED>
__device__ void backward_sweep(const SoftParams& p, const float* __restrict__ cam,
                               const float* __restrict__ sph, const float* s_pl,
                               const int* __restrict__ lst, const int* gate_row, int tile,
                               int offset, const Ray& r, Vec3 o, float m, float inv_s,
                               const float gv[7], float S, float loss_px, Reduce* sm,
                               float* __restrict__ pvals, float* __restrict__ ppl,
                               float* __restrict__ ptf, float vis, Vec3 gd, Vec3 go) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_list = __ldg(lst);
  for (int kk = 0; kk < n_list; ++kk) {
    const int k = __ldg(lst + 1 + kk);
    if (p.cull && gate_row[k] != 1) continue;  // block-uniform
    const Sphere sp = load_sphere(sph, p.ns, k);
    const ObjOut v = sphere_f(p, sp, r.d, o, vis, SHADED);
    const ObjOut ct = cotangents(p, v, m, inv_s, gv, S);
    float g[7], tot[7];
    Vec3 cd, co;
    sphere_f_vjp(p, sp, r.d, o, ct, g, &cd, &co, vis, SHADED);
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
    const ObjOut v = plane_f(p, q, r.d, o, vis, SHADED);
    const ObjOut ct = cotangents(p, v, m, inv_s, gv, S);
    float g[11], tot[11];
    Vec3 cd, co;
    plane_f_vjp(p, q, r.d, o, ct, g, &cd, &co, vis, SHADED);
    gd.x = gd.x + cd.x;
    gd.y = gd.y + cd.y;
    gd.z = gd.z + cd.z;
    go.x = go.x + co.x;
    go.y = go.y + co.y;
    go.z = go.z + co.z;
    block_sum<11>(g, sm->red, tot);
    if (tid == 0) {
      float* row = ppl + ((size_t)tile * p.np + k) * PL_ROWS;
      for (int i = 0; i < 11; ++i) row[i] = SHADED ? row[i] + tot[i] : tot[i];
    }
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

// Sets the device and, above 48 KB, the dynamic shared memory limit.
template <typename K>
inline int prepare(K kernel, const SoftParams& p, size_t smem) {
  cudaError_t err = cudaSetDevice(p.device);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace soft
