// The broad phase for Hopper (sm_90a): per-tile sphere lists, shadow-occluder
// lists, and the fixed-capacity entry tables of the soft kernels' partials.
//
// Replaces, on the card, the port's broad phase in torch ops
// (render/broad_phase.py, which stays as the plain version): `_tile_cones`,
// `sphere_tile_lists`, `plane_depth_bounds`, `shadow_tile_lists` and
// `_compact_lists`. Its JAX counterpart is rtwc_tpu/render/pallas_soft.py:
// 619-982 (`_build_tile_lists` at :968), XLA device code there, compiled with
// the step into one program; no Pallas kernel. The wrappers are in
// render/list_kernel.py.
//
// Two kernels:
//  tile_lists_kernel<SHADOWS>: one warp a tile, LIST_WARPS tiles a block.
//    Every lane builds the tile's cone from its four padded corner rays
//    (broad_phase._tile_cones, which follows the rays the renderers trace),
//    then the lanes test the live spheres, 32 at a time, and write the
//    tile's [NS + 1] row: slot 0 the count, then the admitted spheres near
//    to far with index order at ties, then the rest in index order
//    (torch.argsort(stable=True) on +inf keys, which fixes the order the
//    kernels resolve exact ties by), and the aux planes t_hi_sph and
//    sky_sph. With SHADOWS it goes on to the plane depth bounds (a plane a
//    lane), the eight balls of the truncated view cone and the occluder
//    test of every live sphere against them (a sphere a lane, the eight
//    balls in registers): no [rows, Tj, 8, NS] temporary reaches device
//    memory. The shadow row lists the kept occluders in index order, then
//    the rest. The warp's ballots place the entries; no block barrier.
//  entry_tables_kernel: one block a tile and list. From the inclusive prefix
//    sums of the lists' counts (a device cumsum) it writes each tile's
//    offset, the sphere of each of its entries into a [T NS] table (the
//    exact worst case, so nothing is ever dropped) and -1 into every slot past
//    the total, which it also writes to device memory: no boolean mask, no
//    host sync.
//
// Float semantics follow render/broad_phase.py as torch runs it on the card,
// op for op: -fmad=false, IEEE sqrtf and division, acosf / asinf / expf /
// log1pf as torch's CUDA kernels call them, and a division by a Python
// scalar as a multiply by its f32 reciprocal (torch's div_true_kernel_cuda
// does that for a CPU scalar). A three-element `.sum(-1)` is summed as
// torch's reduction of three contiguous elements sums it: (x0 + x2) + x1.
//
// What bounds it: the tests. At 3840x2160 with 200 spheres (32400 tiles)
// the view test is about 6.5e6 cone tests of some 45 operations and the
// occluder test 5.2e7 ball tests of some 19; the rows it writes (2 x 26 MB)
// take 16 us at 3.35 TB/s, the tests about 20 us at 67 TFLOP/s. A tile's
// work is a chain of dependent steps (the cone, the tests, the placement,
// the plane bounds, the balls), so what sets its time is latency: a warp a
// tile keeps four tiles in flight where one block a tile, with a barrier at
// every block-wide sum, kept one (on an H100: 0.081 -> 0.029 ms at the
// bench headline, PERF.md section 6).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int S_CX = 0, S_CY = 1, S_CZ = 2, S_R = 3, S_ACTIVE = 7;
constexpr int P_CX = 0, P_CY = 1, P_CZ = 2, P_NX = 3, P_NY = 4, P_NZ = 5, P_HW = 6, P_HH = 7,
              P_ACTIVE = 11;
constexpr int C_RX = 3, C_RY = 4, C_RZ = 5, C_UX = 6, C_UY = 7, C_UZ = 8, C_FX = 9, C_FY = 10,
              C_FZ = 11, C_ROW0 = 14;
constexpr int NB = 8;                 // balls covering a tile's truncated view cone
constexpr unsigned FULL = 0xffffffffu;
// tile_lists_kernel: one warp a tile, LIST_WARPS tiles a block, fewer where
// a warp's 16 NS bytes of shared memory would pass LIST_SMEM a block
constexpr int LIST_WARPS = 4;
constexpr size_t LIST_SMEM = 227 * 1024;

}  // namespace

// Mirror: ListParams in render/list_kernel.py, which rounds every value to f32.
struct ListParams {
  int ns, np;             // table widths
  int ti, tj;             // tile grid
  int bh, bw;             // tile extent
  int width, height;      // full image (NDC math)
  int disable;            // 1: every live sphere in every tile, no aux
  int device;
  float e1, e2;           // projection elements
  float inv_w, inv_h;     // 1 / W, 1 / H
  float r_scale, reach;   // the view test's radius scale and reach (hard: 1, 0)
  float r_scale40, reach40;  // the strict (e^-40) sky test's
  float far;
  float light[3];
  float sub, sky_m;       // (far + 16 tau) / mp, (far + 40 tau) / mp
  float neg_k, inv_k;     // -k, 1 / k (the plane penalty's softplus)
  float mp, flt_eps;
  float cover_lim;        // far - 16 tau - 1
  float keep_s, keep_c;   // sqrt(1 + 16 / ks), 16 / ks (the occluder reach)
};

struct EntryParams {
  int n_tiles, ns, n_lists, device;
};

namespace {

// torch's NaN-propagating minimum / maximum / clamp (binary ops and reductions).
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float tclamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(x * x + y * y + z * z);
}

// torch's logaddexp on the card (LogAddExpKernel.cu), in f32.
__device__ __forceinline__ float logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

struct Cone {
  float d_raw[4][3];  // unnormalised corner directions, corner = 2 r + c
  float axis[3];
  float cos_cone;     // clamped to [-1, 1]
};

// broad_phase._tile_cones for tile (ti, tj).
__device__ Cone tile_cone(const ListParams& p, const float* __restrict__ cam, int ti, int tj) {
  Cone c;
  const float r_lo = __ldg(cam + C_ROW0) + (float)ti * (float)p.bh;
  const float c_lo = (float)tj * (float)p.bw;
  const float rr[2] = {r_lo, (r_lo + (float)p.bh) - 1.0f};
  const float cc[2] = {c_lo, (c_lo + (float)p.bw) - 1.0f};
  const float col0[3] = {__ldg(cam + C_RX), __ldg(cam + C_UX), __ldg(cam + C_FX)};
  const float col1[3] = {__ldg(cam + C_RY), __ldg(cam + C_UY), __ldg(cam + C_FY)};
  const float col2[3] = {__ldg(cam + C_RZ), __ldg(cam + C_UZ), __ldg(cam + C_FZ)};
  float d[4][3];
  for (int r = 0; r < 2; ++r) {
    const float vy = (((float)p.height - 2.0f * rr[r]) * p.inv_h) * p.e2;
    for (int q = 0; q < 2; ++q) {
      const float vx = ((2.0f * cc[q] - (float)p.width) * p.inv_w) * p.e1;
      float* dr = c.d_raw[2 * r + q];
      for (int k = 0; k < 3; ++k) dr[k] = (vx * col0[k] + vy * col1[k]) + col2[k];
      const float n = norm3(dr[0], dr[1], dr[2]);
      for (int k = 0; k < 3; ++k) d[2 * r + q][k] = dr[k] / n;
    }
  }
  float a[3];
  for (int k = 0; k < 3; ++k) a[k] = ((d[0][k] + d[1][k]) + d[2][k]) + d[3][k];
  const float an = norm3(a[0], a[1], a[2]);
  for (int k = 0; k < 3; ++k) c.axis[k] = a[k] / an;
  float cmin = 0.0f;
  for (int q = 0; q < 4; ++q) {
    const float cq = (c.axis[0] * d[q][0] + c.axis[1] * d[q][1]) + c.axis[2] * d[q][2];
    cmin = q == 0 ? cq : tmin(cmin, cq);
  }
  c.cos_cone = tclamp(cmin, -1.0f, 1.0f);
  return c;
}

// Exclusive position of this lane's flag among the flags of every round so
// far (carry) and this round's lower lanes; every lane of the warp calls it
// once a round.
__device__ __forceinline__ int warp_prefix(bool flag, int& carry) {
  const unsigned b = __ballot_sync(FULL, flag);
  const int pos = carry + __popc(b & ((1u << (threadIdx.x & 31)) - 1u));
  carry += __popc(b);
  return pos;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = tmax(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// One tile's list row from the per-sphere keys in s_key (+inf: excluded,
// or listed with an infinite key): the finite keys near to far with index
// order at ties, then every other sphere in index order (a stable argsort).
// count goes to slot 0. The warp's lanes take the spheres in rounds of 32;
// lane l writes and reads s_key and s_pre only at spheres l, l + 32, ...
__device__ void write_sorted_row(int ns, const float* s_key, int* s_pre, int* s_aidx,
                                 float* s_akey, int count, int* __restrict__ row) {
  const int lane = threadIdx.x & 31;
  int n_fin = 0;
  for (int s0 = 0; s0 < ns; s0 += 32) {
    const int s = s0 + lane;
    const float key = s < ns ? s_key[s] : INFINITY;
    const bool fin = s < ns && key < INFINITY;
    const int pos = warp_prefix(fin, n_fin);
    if (s < ns) {
      s_pre[s] = pos;  // finite keys before s
      if (fin) {
        s_aidx[pos] = s;
        s_akey[pos] = key;
      }
    }
  }
  __syncwarp();
  for (int a = lane; a < n_fin; a += 32) {
    const float ka = s_akey[a];
    int rank = 0;  // s_aidx is in index order: b < a is the index tie-break
    for (int b = 0; b < n_fin; ++b) {
      const float kb = s_akey[b];
      rank += (kb < ka || (kb == ka && b < a)) ? 1 : 0;
    }
    row[1 + rank] = s_aidx[a];
  }
  for (int s = lane; s < ns; s += 32)
    if (!(s_key[s] < INFINITY)) row[1 + n_fin + (s - s_pre[s])] = s;
  if (lane == 0) row[0] = count;
  __syncwarp();  // s_key, s_pre, s_aidx and s_akey are free again
}

// A row in index order: the flagged spheres (s_key finite), then the rest.
__device__ void write_index_row(int ns, const float* s_key, int* __restrict__ row) {
  const int lane = threadIdx.x & 31;
  int n_in = 0;
  for (int s0 = 0; s0 < ns; s0 += 32) {
    const int s = s0 + lane;
    const bool in = s < ns && s_key[s] < INFINITY;
    const int pos = warp_prefix(in, n_in);
    if (in) row[1 + pos] = s;
  }
  int n_out = 0;
  for (int s0 = 0; s0 < ns; s0 += 32) {
    const int s = s0 + lane;
    const bool out = s < ns && !(s_key[s] < INFINITY);
    const int pos = warp_prefix(out, n_out);
    if (out) row[1 + n_in + pos] = s;
  }
  if (lane == 0) row[0] = n_in;
  __syncwarp();
}

struct PlaneBounds {
  float t_hi;   // the plane's blended-depth bound over the tile
  bool covered, irrelevant40;
};

// broad_phase.plane_depth_bounds for one plane k and one tile's corners.
__device__ PlaneBounds plane_bounds(const ListParams& p, const float* __restrict__ pl,
                                    const float o[3], const Cone& cone, int k) {
  const int np = p.np;
  const bool active = __ldg(pl + P_ACTIVE * np + k) > 0.5f;
  const float n0 = __ldg(pl + P_NX * np + k), n1 = __ldg(pl + P_NY * np + k),
              n2 = __ldg(pl + P_NZ * np + k);
  const float pc0 = __ldg(pl + P_CX * np + k), pc1 = __ldg(pl + P_CY * np + k),
              pc2 = __ldg(pl + P_CZ * np + k);
  const float hw = __ldg(pl + P_HW * np + k), hh = __ldg(pl + P_HH * np + k);
  const float w0 = pc0 - o[0], w1 = pc1 - o[1], w2 = pc2 - o[2];
  const float num = (w0 * n0 + w1 * n1) + w2 * n2;
  float dn[4], dnorm[4], dn_u[4], t_raw[4], t_norm[4], ex[4], ez[4];
  for (int q = 0; q < 4; ++q) {
    const float* dr = cone.d_raw[q];
    dn[q] = (dr[0] * n0 + dr[1] * n1) + dr[2] * n2;
    dnorm[q] = norm3(dr[0], dr[1], dr[2]);
    dn_u[q] = dn[q] / dnorm[q];
    const float safe = fabsf(dn[q]) < 1e-12f ? -1e-12f : dn[q];
    t_raw[q] = num / safe;
    t_norm[q] = t_raw[q] * dnorm[q];
    ex[q] = (o[0] + dr[0] * t_raw[q]) - pc0;
    ez[q] = (o[2] + dr[2] * t_raw[q]) - pc2;
  }
  bool front_all = true, back_pos = true, t_ok = true;
  for (int q = 0; q < 4; ++q) {
    front_all = front_all && dn_u[q] <= -1e-3f;
    back_pos = back_pos && dn_u[q] >= 1e-3f;
    t_ok = t_ok && t_norm[q] >= 0.0f && t_norm[q] <= p.far;
  }
  const bool sign_ok = front_all || back_pos;
  const bool t_in = sign_ok && t_ok;
  auto irrelevant_at = [&](float m) {
    bool back_all = true, behind = true, ex_hi = true, ex_lo = true, ez_hi = true, ez_lo = true;
    const float xm = hw + m, zm = hh + m;
    for (int q = 0; q < 4; ++q) {
      back_all = back_all && dn_u[q] >= m;
      behind = behind && t_norm[q] <= -m;
      ex_hi = ex_hi && ex[q] >= xm;
      ex_lo = ex_lo && ex[q] <= -xm;
      ez_hi = ez_hi && ez[q] >= zm;
      ez_lo = ez_lo && ez[q] <= -zm;
    }
    const bool oob = front_all && t_in && (ex_hi || ex_lo || ez_hi || ez_lo);
    return back_all || (sign_ok && behind) || oob || !active;
  };
  float dmax = dnorm[0], t_lo = t_raw[0], t_rmax = t_raw[0], ndn = -dn[0];
  float axm = fabsf(ex[0]), azm = fabsf(ez[0]);
  for (int q = 1; q < 4; ++q) {
    dmax = tmax(dmax, dnorm[q]);
    t_lo = tmin(t_lo, t_raw[q]);
    t_rmax = tmax(t_rmax, t_raw[q]);
    ndn = tmin(ndn, -dn[q]);
    axm = tmax(axm, fabsf(ex[q]));
    azm = tmax(azm, fabsf(ez[q]));
  }
  const float t_max = tclamp(t_rmax * dmax, 0.0f, p.far);
  PlaneBounds b;
  b.t_hi = irrelevant_at(p.sub) ? 0.0f : ((front_all && t_in) ? t_max : p.far);
  b.irrelevant40 = irrelevant_at(p.sky_m);
  const float x1 = ndn / dmax - p.flt_eps;
  const float x2 = tmin(t_lo, t_lo * dmax);
  const float x3 = hw - axm;
  const float x4 = hh - azm;
  auto pen = [&](float x) { return logaddexp(p.neg_k * x, 0.0f) * p.inv_k; };
  const float pen_total = p.mp * (((pen(x1) + pen(x2)) + pen(x3)) + pen(x4));
  b.covered = front_all && t_in && active && (t_max + pen_total <= p.cover_lim);
  return b;
}

template <bool SHADOWS>
__global__ void __launch_bounds__(LIST_WARPS * 32)
tile_lists_kernel(ListParams p, const float* __restrict__ cam, const float* __restrict__ sph,
                  const float* __restrict__ pl, int* __restrict__ lists,
                  float* __restrict__ t_hi_out, uint8_t* __restrict__ sky_out,
                  int* __restrict__ shl) {
  // a warp's [NS] keys, [NS] prefix counts, [NS] admitted indices, [NS] their keys
  extern __shared__ float s_mem[];
  const int ns = p.ns, lane = threadIdx.x;
  const int tile = blockIdx.x * blockDim.y + threadIdx.y;  // one warp a tile
  if (tile >= p.ti * p.tj) return;                         // warp-uniform: no block barrier below
  float* s_key = s_mem + (size_t)threadIdx.y * 4 * ns;
  int* s_pre = reinterpret_cast<int*>(s_key + ns);
  int* s_aidx = s_pre + ns;
  float* s_akey = reinterpret_cast<float*>(s_aidx + ns);
  const int ti = tile / p.tj, tj = tile - ti * p.tj;
  const size_t stride = (size_t)ns + 1;
  int* row = lists + (size_t)tile * stride;

  if (p.disable) {  // _compact_lists(active): index order, no aux
    for (int s = lane; s < ns; s += 32)
      s_key[s] = __ldg(sph + S_ACTIVE * ns + s) > 0.5f ? 0.0f : INFINITY;
    write_index_row(ns, s_key, row);
    if (SHADOWS) write_index_row(ns, s_key, shl + (size_t)tile * stride);
    return;
  }

  const Cone cone = tile_cone(p, cam, ti, tj);
  const float cone_ang = acosf(cone.cos_cone);
  const float o[3] = {__ldg(cam + 0), __ldg(cam + 1), __ldg(cam + 2)};

  // -- the view list (broad_phase.sphere_tile_lists)
  float t_hi = 0.0f;
  int cnt = 0, n40 = 0;
  for (int s = lane; s < ns; s += 32) {
    const float r = __ldg(sph + S_R * ns + s);
    const bool act = __ldg(sph + S_ACTIVE * ns + s) > 0.5f;
    const float v0 = __ldg(sph + S_CX * ns + s) - o[0];
    const float v1 = __ldg(sph + S_CY * ns + s) - o[1];
    const float v2 = __ldg(sph + S_CZ * ns + s) - o[2];
    const float dist = norm3(v0, v1, v2);
    const float dcl = tclamp_min(dist, 1e-12f);
    const float u0 = v0 / dcl, u1 = v1 / dcl, u2 = v2 / dcl;
    const float r_eff = r * p.r_scale;
    const float cosang = (cone.axis[0] * u0 + cone.axis[1] * u1) + cone.axis[2] * u2;
    const float ang = acosf(tclamp(cosang, -1.0f, 1.0f));
    const float alpha = asinf(tclamp(r_eff / dcl, 0.0f, 1.0f));
    const bool geom = ang <= cone_ang + alpha;
    const bool near = dist <= r_eff + p.reach;
    const bool incl = (geom || near) && act;
    t_hi = tmax(t_hi, incl ? dist + r : 0.0f);
    const float r_eff40 = r * p.r_scale40;
    const float alpha40 = asinf(tclamp(r_eff40 / dcl, 0.0f, 1.0f));
    const bool incl40 = ((ang <= cone_ang + alpha40) || (dist <= r_eff40 + p.reach40)) && act;
    n40 += incl40 ? 1 : 0;
    cnt += incl ? 1 : 0;
    s_key[s] = incl ? dist : INFINITY;
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(FULL, cnt, off);
    n40 += __shfl_xor_sync(FULL, n40, off);
  }
  // the max over the spheres: lanes past the last sphere hold 0, below every value
  const float t_hi_sph = warp_max(t_hi);
  const bool sky_sph = n40 == 0;
  if (lane == 0) {
    t_hi_out[tile] = t_hi_sph;
    sky_out[tile] = sky_sph ? 1 : 0;
  }
  write_sorted_row(ns, s_key, s_pre, s_aidx, s_akey, cnt, row);
  if (!SHADOWS) return;

  // -- the shadow list (broad_phase.shadow_tile_lists)
  float t_hi_pl = 0.0f;
  bool covered = false, relevant40 = false;
  for (int k = lane; k < p.np; k += 32) {
    const PlaneBounds b = plane_bounds(p, pl, o, cone, k);
    t_hi_pl = k == lane ? b.t_hi : tmax(t_hi_pl, b.t_hi);
    covered = covered || b.covered;
    relevant40 = relevant40 || !b.irrelevant40;
  }
  // amax over the planes: lanes without a plane hold 0, below every bound
  // (each is 0, far or a clamp to [0, far])
  const float t_hi_planes = warp_max(t_hi_pl);
  const bool any_covered = __any_sync(FULL, covered);
  const bool planes_sky = !__any_sync(FULL, relevant40);
  float t_cap = any_covered ? tmax(t_hi_sph, t_hi_planes) + 1.0f : p.far;
  t_cap = tclamp(t_cap, 1.0f, p.far);
  const bool skip = sky_sph && planes_sky;
  const float half = t_cap * 0.0625f;  // t_cap / (2 NB)
  const float cc = cone.cos_cone;
  const float tan_cone = sqrtf(tclamp_min(1.0f - cc * cc, 0.0f)) / tclamp_min(cc, 0.05f);
  float vb[NB][3], vv[NB], R[NB];
  for (int b = 0; b < NB; ++b) {
    const float t_mid = ((float)b * 2.0f + 1.0f) * half;
    const float t_sl = t_mid + half;
    for (int k = 0; k < 3; ++k) vb[b][k] = (o[k] + cone.axis[k] * t_mid) - p.light[k];
    vv[b] = (vb[b][0] * vb[b][0] + vb[b][2] * vb[b][2]) + vb[b][1] * vb[b][1];
    const float a = t_sl * tan_cone;
    R[b] = sqrtf(half * half + a * a);
  }
  for (int s = lane; s < ns; s += 32) {
    const float r = __ldg(sph + S_R * ns + s);
    const bool act = __ldg(sph + S_ACTIVE * ns + s) > 0.5f;
    const float w0 = __ldg(sph + S_CX * ns + s) - p.light[0];
    const float w1 = __ldg(sph + S_CY * ns + s) - p.light[1];
    const float w2 = __ldg(sph + S_CZ * ns + s) - p.light[2];
    const float ww = (w0 * w0 + w2 * w2) + w1 * w1;
    const float r_keep = ((r * p.keep_s + r) + p.keep_c) + 0.02f;
    bool in = false;
    for (int b = 0; b < NB; ++b) {
      const float wv = (vb[b][0] * w0 + vb[b][1] * w1) + vb[b][2] * w2;
      const float t = tclamp(wv / tclamp_min(vv[b], 1e-12f), 0.0f, 1.0f);
      const float d2 = (ww - (2.0f * t) * wv) + (t * t) * vv[b];
      const float d = sqrtf(tclamp_min(d2, 0.0f));
      in = in || (d - R[b] <= r_keep);
    }
    s_key[s] = (in && act && !skip) ? 0.0f : INFINITY;
  }
  write_index_row(ns, s_key, shl + (size_t)tile * stride);
}

__global__ void __launch_bounds__(128)
entry_tables_kernel(EntryParams e, const int* __restrict__ lists0, const int* __restrict__ lists1,
                    const int* __restrict__ ends, int* __restrict__ offsets,
                    int* __restrict__ pidx, int* __restrict__ counts) {
  const int T = e.n_tiles, ns = e.ns;
  const int L = blockIdx.y, t = blockIdx.x;
  const int* row = (L == 0 ? lists0 : lists1) + (size_t)t * (ns + 1);
  const int* end = ends + (size_t)L * T;
  int* tab = pidx + (size_t)L * T * ns;
  const int cnt = __ldg(row);
  const int off = __ldg(end + t) - cnt;
  const int E = __ldg(end + T - 1);
  if (threadIdx.x == 0) offsets[(size_t)L * T + t] = off;
  for (int j = threadIdx.x; j < cnt; j += blockDim.x) tab[off + j] = __ldg(row + 1 + j);
  const long long cap = (long long)T * ns;
  for (int j = threadIdx.x; j < ns; j += blockDim.x) {  // the stripe past the total
    const long long q = (long long)E + (long long)t * ns + j;
    if (q < cap) tab[q] = -1;
  }
  if (t == 0 && threadIdx.x == 0) {
    counts[L] = E;
    if (e.n_lists == 1) counts[1] = 0;
  }
}

}  // namespace

// C entries for ctypes: device pointers of contiguous tensors the wrappers
// (render/list_kernel.py) checked and allocated; `stream` is PyTorch's
// current stream. Each returns the launch's cudaError_t and does not
// synchronise.
extern "C" int rtwc_tile_lists(const float* cam, const float* sph, const float* pl, int* lists,
                               float* t_hi, uint8_t* sky, int* shl, const ListParams* params,
                               void* stream) {
  const ListParams p = *params;
  cudaError_t err = cudaSetDevice(p.device);
  if (err != cudaSuccess) return (int)err;
  const size_t warp_smem = 4 * sizeof(float) * (size_t)p.ns;
  const size_t fit = warp_smem > 0 ? LIST_SMEM / warp_smem : LIST_WARPS;
  const int warps = fit >= LIST_WARPS ? LIST_WARPS : (fit < 1 ? 1 : (int)fit);
  const size_t smem = warps * warp_smem;
  const int n_tiles = p.ti * p.tj, blocks = (n_tiles + warps - 1) / warps;
  const dim3 block(32, warps);
  if (shl != nullptr) {
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(tile_lists_kernel<true>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return (int)err;
    tile_lists_kernel<true><<<blocks, block, smem, (cudaStream_t)stream>>>(p, cam, sph, pl,
                                                                           lists, t_hi, sky, shl);
  } else {
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(tile_lists_kernel<false>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return (int)err;
    tile_lists_kernel<false><<<blocks, block, smem, (cudaStream_t)stream>>>(p, cam, sph, pl,
                                                                            lists, t_hi, sky, shl);
  }
  return (int)cudaGetLastError();
}

extern "C" int rtwc_entry_tables(const int* lists, const int* shl, const int* ends, int* offsets,
                                 int* pidx, int* counts, const EntryParams* params,
                                 void* stream) {
  const EntryParams e = *params;
  cudaError_t err = cudaSetDevice(e.device);
  if (err != cudaSuccess) return (int)err;
  entry_tables_kernel<<<dim3(e.n_tiles, e.n_lists), 128, 0, (cudaStream_t)stream>>>(
      e, lists, shl, ends, offsets, pidx, counts);
  return (int)cudaGetLastError();
}
