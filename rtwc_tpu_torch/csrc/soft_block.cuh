// Block-level device code shared by the soft kernels (csrc/soft_render.cu,
// csrc/soft_shadow.cu): table loads and the sphere sources of the sweeps,
// the online-softmin step, the forward sweep, the slab and stash of the
// backward sweep (K2, K3, K5, K6), and the launch helpers. One thread per
// pixel, one block per (bh, bw) broad-phase tile. The plain torch twins
// are in render/soft_core.py (block_sum_plain, block_tf_sum_plain,
// _accumulate, object_sweep, _backward_sweep).

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

// Where a forward sweep finds its tile's list row (n, then n sphere
// indices) and the listed spheres: in shared memory, where stage_lists put
// them at block start, so that no listed object costs a chain of dependent
// device-memory loads before its block vote. The staged layout: the list
// row at s_lst [list_stride] ints; entry kk's parameters at s_sph[f *
// (list_stride - 1) + kk], f = 0..STAGED - 1 in load_sphere's order (cx,
// cy, cz, r, colour).
constexpr int STAGED = 7;

struct StagedList {
  const int* s_lst;
  const float* s_sph;
  int stride;  // list_stride - 1: the most entries a row holds
  __device__ int n() const { return s_lst[0]; }
  __device__ int index(int kk) const { return s_lst[1 + kk]; }
  __device__ Sphere sphere(int kk) const {
    Sphere s;
    s.cx = s_sph[kk];
    s.cy = s_sph[stride + kk];
    s.cz = s_sph[2 * stride + kk];
    s.r = s_sph[3 * stride + kk];
    s.col[0] = s_sph[4 * stride + kk];
    s.col[1] = s_sph[5 * stride + kk];
    s.col[2] = s_sph[6 * stride + kk];
    return s;
  }
};

// Copies the tile's list row lst and, with SHADOW_ROW, its shadow list row
// shl (n, then n entries each) and their spheres into shared memory: s_lst
// and s_lst + list_stride, s_sph and s_sph + STAGED * (list_stride - 1),
// StagedList's layout. Thread e takes entry e of the two rows laid end to
// end, so the entries' loads are coalesced and all the spheres' loads are
// in flight at once: one chain of dependent loads a block, not one an
// object. No barrier: the caller's next one (stage_planes') publishes them.
template <bool SHADOW_ROW>
__device__ __forceinline__ void stage_lists(const SoftParams& p, const float* __restrict__ sph,
                                            const int* __restrict__ lst,
                                            const int* __restrict__ shl, int* s_lst,
                                            float* s_sph) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int L = p.list_stride - 1;
  const int n0 = __ldg(lst), n1 = SHADOW_ROW ? __ldg(shl) : 0;
  if (tid == 0) {
    s_lst[0] = n0;
    if (SHADOW_ROW) s_lst[p.list_stride] = n1;
  }
  for (int e = tid; e < n0 + n1; e += blockDim.x * blockDim.y) {
    const int i = e < n0 ? 0 : 1, kk = e < n0 ? e : e - n0;
    const int k = __ldg((i ? shl : lst) + 1 + kk);
    s_lst[i * p.list_stride + 1 + kk] = k;
    const Sphere sp = load_sphere(sph, p.ns, k);
    float* row = s_sph + i * STAGED * L + kk;
    row[0] = sp.cx;
    row[L] = sp.cy;
    row[2 * L] = sp.cz;
    row[3 * L] = sp.r;
    row[4 * L] = sp.col[0];
    row[5 * L] = sp.col[1];
    row[6 * L] = sp.col[2];
  }
}

// The warp butterfly of the block sums: lane 0 ends with its warp's sums.
template <int N>
__device__ __forceinline__ void warp_sum(float v[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_down_sync(FULL, v[i], off);
}

// The warp butterfly of the two-float block sums: lane 0 of each warp
// stores its warp's (hi, lo) pairs at s_red[(warp * N + i) * 2].
template <int N>
__device__ __forceinline__ void warp_tf_sum(const float v[N], float* s_red) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
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
// shading normal; it may move *m. The list and its spheres come from
// `list`, staged by stage_lists. SPHERES false compiles the list's loop out,
// for a tile whose list is empty (K6's plane-only variant).
template <bool SPHERES = true, typename Visit>
__device__ __forceinline__ void forward_sweep(const SoftParams& p, const float* __restrict__ cam,
                                              const StagedList& list, const float* s_pl,
                                              int* gate_row, Vec3 d, Vec3 o, const float* m,
                                              Visit&& visit) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if constexpr (SPHERES) {
    const int n_list = list.n();
    for (int kk = 0; kk < n_list; ++kk) {
      const int k = list.index(kk);
      const Sphere sp = list.sphere(kk);
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

// The camera sum's per-warp (hi, lo) pairs (block_tf_rows).
struct Reduce {
  float tf[MAX_WARPS * NTF * 2];
};

// The slab scheme of the backward sweep (K2, K3, K5, K6): per-object
// partials without a block barrier per object. Each warp reduces its 32
// lanes with a butterfly (warp_sum) and lane 0 parks the warp's N sums in
// slot `used` of the slab, [slot][warp][value], with no barrier. When
// SLAB_SLOTS slots are full, or the sweep ends, one barrier; then the
// block's threads take one (slot, value) pair each, sum it over the warps
// in warp order 0, 1, ... (block_sum_plain's order, so the totals are
// bit-equal to it) and write it to the slot's row; a second barrier frees
// the slab. SLAB_SLOTS = 32: 11.4 KB a block. A tile of the bench's cells
// gates at most 11 objects in a sweep (4K / 200 spheres), so those flush
// once a sweep, and K5 and K6 (with their 27 KB stash) take 41 KB a block,
// a fifth of an SM's 228 KB.
constexpr int SLAB_SLOTS = 32;
constexpr int SLAB_VALS = 11;  // the widest row: a plane of the main sweep

struct Slab {
  float v[SLAB_SLOTS][MAX_WARPS][SLAB_VALS];
  float* dst[SLAB_SLOTS];  // the slot's row in pvals, psh or ppl
  int n[SLAB_SLOTS];       // values in the slot; negative: add them to the row
};

// Sums the `used` slots into their rows; see Slab.
__device__ __forceinline__ void slab_flush(Slab* sb, int& used) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y, nwarps = nthreads >> 5;
  __syncthreads();
  for (int e = tid; e < used * SLAB_VALS; e += nthreads) {
    const int j = e / SLAB_VALS, i = e - j * SLAB_VALS;
    const int n = sb->n[j];
    if (i < (n < 0 ? -n : n)) {
      float a = sb->v[j][0][i];
      for (int w = 1; w < nwarps; ++w) a = a + sb->v[j][w][i];
      float* d = sb->dst[j] + i;
      *d = n < 0 ? *d + a : a;
    }
  }
  __syncthreads();
  used = 0;
}

// One object's N per-pixel values into the slab; the block's total of
// value i goes to dst[i] (add: dst[i] + total) at the next flush.
template <int N>
__device__ __forceinline__ void slab_put(float v[N], Slab* sb, int& used, float* dst, bool add) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  warp_sum<N>(v);
  if (lane == 0)
    for (int i = 0; i < N; ++i) sb->v[used][warp][i] = v[i];
  if (tid == 0) {
    sb->dst[used] = dst;
    sb->n[used] = add ? -N : N;
  }
  if (++used == SLAB_SLOTS) slab_flush(sb, used);
}

// The camera's two-float block sum for the slab scheme: block_tf_sum_plain's
// butterfly and warp order, thread i combining slot i over the warps and
// writing (hi, lo) to out[2 i], N threads at once. Last barrier of the
// kernel: nothing reads s_red after it.
template <int N>
__device__ __forceinline__ void block_tf_rows(const float v[N], float* s_red,
                                              float* __restrict__ out) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nwarps = (blockDim.x * blockDim.y) >> 5;
  warp_tf_sum<N>(v, s_red);
  __syncthreads();
  if (tid < N) {
    float a = s_red[2 * tid], b = s_red[2 * tid + 1];
    for (int w = 1; w < nwarps; ++w)
      tf_combine(a, b, s_red[(w * N + tid) * 2], s_red[(w * N + tid) * 2 + 1], &a, &b);
    out[2 * tid] = a;
    out[2 * tid + 1] = b;
  }
}

// Per-pixel values that K2, K3, K5 and K6 keep in shared memory while their
// sweeps run, [field][MAX_THREADS]: written before a sweep, read where needed, so
// that they hold no register through an object's VJP. Each thread reads and
// writes only its own column, so no barrier guards it; `volatile` keeps the
// compiler from holding the values in registers after all. The row stride
// is the constant MAX_THREADS, not the block's size, so that a field is an
// immediate offset from the thread's column and costs no address register.
enum StashField {
  ST_M, ST_INV_S, ST_S, ST_GV,                  // m, 1/s, S, the 7 output cotangents
  ST_GD = ST_GV + 7, ST_GO = ST_GD + 3,         // the ray cotangents, accumulated
  ST_VX = ST_GO + 3, ST_VY, ST_RINV, ST_LOSS,   // what only the camera sum reads
  ST_VIS, ST_DEPTH, ST_ON, ST_GDEPTH0 = ST_ON + 3, ST_GAW,  // what S needs after the shadow sweep
  ST_FIELDS
};

struct Stash {
  volatile float* col;  // this thread's column
  __device__ explicit Stash(float* s) : col(s + threadIdx.y * blockDim.x + threadIdx.x) {}
  __device__ void put(int f, float v) const { col[f * MAX_THREADS] = v; }
  __device__ float get(int f) const { return col[f * MAX_THREADS]; }
  // gd += cd, go += co, as _backward_sweep accumulates them
  __device__ void add_ray_cotangents(Vec3 cd, Vec3 co) const {
    put(ST_GD, get(ST_GD) + cd.x);
    put(ST_GD + 1, get(ST_GD + 1) + cd.y);
    put(ST_GD + 2, get(ST_GD + 2) + cd.z);
    put(ST_GO, get(ST_GO) + co.x);
    put(ST_GO + 1, get(ST_GO + 1) + co.y);
    put(ST_GO + 2, get(ST_GO + 2) + co.z);
  }
};

// The backward sweep of K2, K3, K5 and K6 (soft_core.py _backward_sweep,
// op for op). SHADOWED (K5, K6): the objects are shaded by vis (rgb = min(255, A +
// vis B)) and each plane row is added to the shadow sweep's partial already
// in ppl; otherwise (K2, K3) the objects are unshaded, vis is unused and each
// plane row is set. Its per-object partials are summed through the slab,
// the camera's (and K3's loss, NTFB = 13) through block_tf_rows; m, 1/s, S,
// the output cotangents, the ray cotangents (seeded by the caller) and the
// loss stay in the stash `st`, so the registers hold the ray, vis and one
// object's adjoint. SPHERES false compiles the list's loop out, as
// forward_sweep's.
template <int NTFB, bool SHADOWED, bool SPHERES = true>
__device__ void backward_sweep_slab(const SoftParams& p, const float* __restrict__ cam,
                                    const float* __restrict__ sph, const float* s_pl,
                                    const int* __restrict__ lst, const int* gate_row, int tile,
                                    int offset, Vec3 d, Vec3 o, float vis, Stash st,
                                    Reduce* sm, Slab* sb, float* __restrict__ pvals,
                                    float* __restrict__ ppl, float* __restrict__ ptf) {
  int used = 0;  // slab slots filled
  if constexpr (SPHERES) {
    const int n_list = __ldg(lst);
    for (int kk = 0; kk < n_list; ++kk) {
      const int k = __ldg(lst + 1 + kk);
      if (p.cull && gate_row[k] != 1) continue;  // block-uniform
      const Sphere sp = load_sphere(sph, p.ns, k);
      const ObjOut v = sphere_f(p, sp, d, o, vis, SHADOWED);
      float gv[7];
      for (int i = 0; i < 7; ++i) gv[i] = st.get(ST_GV + i);
      const ObjOut ct = cotangents(p, v, st.get(ST_M), st.get(ST_INV_S), gv, st.get(ST_S));
      float g[7];
      Vec3 cd, co;
      sphere_f_vjp(p, sp, d, o, ct, g, &cd, &co, vis, SHADOWED);
      st.add_ray_cotangents(cd, co);
      slab_put<7>(g, sb, used, pvals + (size_t)(offset + kk) * 8, false);
    }
  }
  const int n_pl = (int)__ldg(cam + C_NPL);
  for (int k = 0; k < n_pl; ++k) {
    if (p.cull && gate_row[p.ns + k] != 1) continue;
    const Plane q = load_plane(s_pl, p.np, k);
    const ObjOut v = plane_f(p, q, d, o, vis, SHADOWED);
    float gv[7];
    for (int i = 0; i < 7; ++i) gv[i] = st.get(ST_GV + i);
    const ObjOut ct = cotangents(p, v, st.get(ST_M), st.get(ST_INV_S), gv, st.get(ST_S));
    float g[11];
    Vec3 cd, co;
    plane_f_vjp(p, q, d, o, ct, g, &cd, &co, vis, SHADOWED);
    st.add_ray_cotangents(cd, co);
    slab_put<11>(g, sb, used, ppl + ((size_t)tile * p.np + k) * PL_ROWS, SHADOWED);
  }
  if (used > 0) slab_flush(sb, used);
  // camera: position cotangents and the raygen VJP, two-float
  Ray r;
  r.d = d;
  r.vx = st.get(ST_VX);
  r.vy = st.get(ST_VY);
  r.inv = st.get(ST_RINV);
  float v[NTFB];
  v[0] = st.get(ST_GO);
  v[1] = st.get(ST_GO + 1);
  v[2] = st.get(ST_GO + 2);
  raygen_vjp(r, Vec3{st.get(ST_GD), st.get(ST_GD + 1), st.get(ST_GD + 2)}, v + 3);
  if constexpr (NTFB > SLOT_LOSS) v[SLOT_LOSS] = st.get(ST_LOSS);
  block_tf_rows<NTFB>(v, sm->tf, ptf + (size_t)tile * NTF * 2);
}

// The stash's camera-sum fields from the block's ray; returns its direction.
__device__ __forceinline__ Vec3 stash_ray(const Ray& r, Stash st) {
  st.put(ST_VX, r.vx);
  st.put(ST_VY, r.vy);
  st.put(ST_RINV, r.inv);
  return r.d;
}

__device__ __forceinline__ void stage_planes(const SoftParams& p, const float* pl_g, float* s_pl) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int e = tid; e < PL_ROWS * p.np; e += blockDim.x * blockDim.y) s_pl[e] = pl_g[e];
  __syncthreads();
}

// The thread's camera ray in tile (ty, tx) of the grid; block_ray: in the
// block's own tile.
__device__ __forceinline__ Ray tile_ray(const SoftParams& p, const float* cam, int ty, int tx) {
  const float rowf = __ldg(cam + C_ROW0) + (float)(ty * p.bh) + (float)threadIdx.y;
  const float colf = (float)(tx * p.bw) + (float)threadIdx.x;
  return raygen(p, cam, rowf, colf);
}

__device__ __forceinline__ Ray block_ray(const SoftParams& p, const float* cam) {
  return tile_ray(p, cam, blockIdx.y, blockIdx.x);
}

// Sets the device and, where the dynamic shared memory `smem` and the
// kernel's static `static_smem` pass 48 KB together, the dynamic limit.
template <typename K>
inline int prepare(K kernel, const SoftParams& p, size_t smem, size_t static_smem = 0) {
  cudaError_t err = cudaSetDevice(p.device);
  if (err != cudaSuccess) return (int)err;
  if (smem + static_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace soft
