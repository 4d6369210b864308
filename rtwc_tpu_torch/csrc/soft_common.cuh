// Device code shared by the soft kernels (csrc/soft_render.cu,
// csrc/soft_shadow.cu): per-object soft intersection + shading, the shadow
// occluder transmittances, ray generation, two-float sums, and the
// hand-written adjoints that take the place of JAX's in-kernel jax.vjp.
//
// Counterpart: rtwc_tpu/render/pallas_soft.py `_make_object_fns` (:99-525,
// the object functions and the shadow functions), `_make_raygen`
// (:527-554), the raygen VJP (:1477-1493) and `_two_sum` / `_tf_combine`
// (:557-568). The plain torch twin of every function here is in
// render/soft_objects.py, in the same op order; keep the two in step.
//
// Adjoints follow JAX's tie rules: maximum / minimum split the gradient
// 0.5 / 0.5 at a tie, clip is maximum-then-minimum, abs has gradient +1 at
// 0, d rsqrt = g * (-0.5 * ans / x), d sqrt = g * (0.5 / ans), and
// d softplus(z) = exp(z - softplus(z)). The file is compiled with
// -fmad=false, so no multiply-add is contracted and the plain version
// computes the same roundings.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define SOFT_HD __host__ __device__ __forceinline__

namespace soft {

// Table rows (render/pack.py).
constexpr int S_CX = 0, S_CY = 1, S_CZ = 2, S_R = 3, S_COLR = 4, S_COLG = 5, S_COLB = 6;
constexpr int SPH_ROWS = 8;
constexpr int P_CX = 0, P_CY = 1, P_CZ = 2, P_NX = 3, P_NY = 4, P_NZ = 5, P_HW = 6, P_HH = 7,
              P_COLR = 8, P_COLG = 9, P_COLB = 10;
constexpr int PL_ROWS = 12;
constexpr int C_POSX = 0, C_POSY = 1, C_POSZ = 2, C_RX = 3, C_NSPH = 12, C_NPL = 13,
              C_ROW0 = 14;
// Output planes (pallas_soft.py:68-69); 10-13 only with shadows.
constexpr int SO_R = 0, SO_G = 1, SO_B = 2, SO_DEPTH = 3, SO_NX = 4, SO_NY = 5, SO_NZ = 6,
              SO_ALPHA = 7, SO_M = 8, SO_S = 9, SO_VIS = 10, SO_DVR = 11;
constexpr int N_PLANES = 10, N_PLANES_SH = 14;
constexpr int NTF = 13, SLOT_LOSS = 12;  // two-float partial slots
constexpr float FLT_EPS = 1.1920929e-07f;
constexpr float INV_255 = (float)(1.0 / 255.0);
constexpr float CULL_LOG_EPS = -16.0f;
constexpr float TRANS_FLOOR = 1e-7f;    // per-occluder transmittance floor (:72)
constexpr float VIS_EARLY_OUT = 1e-7f;  // the all-dark early-out threshold (:995)

}  // namespace soft

// Render constants of one launch; declared with ctypes in
// render/soft_core.py (SoftParams), each value rounded to f32 there.
struct SoftParams {
  int width, height;  // full image (NDC math)
  int hp, wp;         // padded extent
  int bh, bw;         // tile = block extent
  int ns, np;         // table widths
  int list_stride;    // NS + 1
  int cull;           // 1: gate objects (K1, K3) / read the gates (K2)
  int hardness;       // int(specular_hardness)
  int device;
  int loss_h, loss_w; // K3's valid region
  float e1, e2;
  float far, k, mp, inv_tau, bg_logit;
  float light[3], ldc[3], lsc[3], osc[3];
  float dpow, spow, amb;
  float loss_scale;   // 2 / (255^2 * 3 * H * W)
  float ks;           // soft_shadow_k
  float sh_floor;     // -16 / ks: the occluder gates' relevance floor
};

namespace soft {

// 1 / sqrt(x), correctly rounded on the card as on the host: the hardware
// rsqrtf is off by up to 2 ulp, which ill-conditioned pixels amplify, so the
// card's soft render drifted from the host's (PERF.md, section 6). sqrtf and
// the division are IEEE on both, so the plain twin (1 / torch.sqrt) gives
// the same bits on either device.
SOFT_HD float rsqrt_(float x) { return 1.0f / sqrtf(x); }

// -- JAX's tie rules ---------------------------------------------------------
SOFT_HD float max_grad(float x, float v) { return x > v ? 1.0f : (x == v ? 0.5f : 0.0f); }
SOFT_HD float min_grad(float x, float v) { return x < v ? 1.0f : (x == v ? 0.5f : 0.0f); }
SOFT_HD float clip(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }
SOFT_HD float clip_grad(float x, float lo, float hi) {
  return max_grad(x, lo) * min_grad(fmaxf(x, lo), hi);
}
SOFT_HD float abs_grad(float x) { return x >= 0.0f ? 1.0f : -1.0f; }

SOFT_HD float softplus(float z) {
  // logaddexp(z, 0) = max(z, 0) + log1p(exp(-|z|))
  return fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z)));
}
SOFT_HD float pen(const SoftParams& p, float x) { return softplus(-p.k * x) / p.k; }
SOFT_HD float pen_vjp(const SoftParams& p, float x, float ct) {
  const float z = -p.k * x;
  return ct / p.k * expf(z - softplus(z)) * (-p.k);
}

SOFT_HD float pow_int(float x, int n) {
  float result = 1.0f;
  bool have = false;
  float bit = x;
  while (n) {
    if (n & 1) {
      result = have ? result * bit : bit;
      have = true;
    }
    n >>= 1;
    if (n) bit = bit * bit;
  }
  return result;
}
SOFT_HD float dpow_int(float x, int n) { return n == 0 ? 0.0f : pow_int(x, n - 1) * (float)n; }

// -- shading -----------------------------------------------------------------
struct Vec3 {
  float x, y, z;
};

// The colour-independent Blinn-Phong terms (dterm, sterm).
SOFT_HD void shade_terms(const SoftParams& p, Vec3 pt, Vec3 n, Vec3 d, float* dterm,
                         float* sterm) {
  const float ldx0 = p.light[0] - pt.x, ldy0 = p.light[1] - pt.y, ldz0 = p.light[2] - pt.z;
  const float d2 = ldx0 * ldx0 + ldy0 * ldy0 + ldz0 * ldz0;
  const float il = rsqrt_(fmaxf(d2, 1e-20f));
  const float inv_d2 = il * il;
  const float ldx = ldx0 * il, ldy = ldy0 * il, ldz = ldz0 * il;
  const float di = clip(n.x * ldx + n.y * ldy + n.z * ldz, 0.0f, 1.0f);
  *dterm = di * p.dpow * inv_d2;
  const float hx = ldx - d.x, hy = ldy - d.y, hz = ldz - d.z;
  const float ih = rsqrt_(fmaxf(hx * hx + hy * hy + hz * hz, 1e-20f));
  const float si = clip((n.x * hx + n.y * hy + n.z * hz) * ih, 0.0f, 1.0f);
  *sterm = pow_int(si, p.hardness) * p.spow * inv_d2;
}

// Ambient and direct parts per channel in the 0..255 domain:
// rgb_c = min(255, A_c + vis * B_c).
SOFT_HD void parts_from_terms(const SoftParams& p, float dterm, float sterm, const float col[3],
                              float A[3], float B[3]) {
  for (int c = 0; c < 3; ++c) {
    const float cd = col[c] * INV_255;
    A[c] = p.amb * cd * 255.0f;
    B[c] = (dterm * p.ldc[c] * cd + sterm * p.lsc[c] * p.osc[c]) * 255.0f;
  }
}

// shaded: rgb = min(255, A + vis * B); otherwise min(255, A + B).
SOFT_HD void shade(const SoftParams& p, const float col[3], Vec3 pt, Vec3 n, Vec3 d,
                   float rgb[3], float vis = 1.0f, bool shaded = false) {
  float dterm, sterm, A[3], B[3];
  shade_terms(p, pt, n, d, &dterm, &sterm);
  parts_from_terms(p, dterm, sterm, col, A, B);
  for (int c = 0; c < 3; ++c) rgb[c] = fminf(A[c] + (shaded ? vis * B[c] : B[c]), 255.0f);
}

// Reverse of shade: accumulates nothing, writes ct_col, ct_p, ct_n, ct_d.
// vis is a constant here (its cotangent is the value path of K5).
SOFT_HD void shade_vjp(const SoftParams& p, const float col[3], Vec3 pt, Vec3 n, Vec3 d,
                       const float ct_rgb[3], float ct_col[3], Vec3* ct_p, Vec3* ct_n,
                       Vec3* ct_d, float vis = 1.0f, bool shaded = false) {
  const float ldx0 = p.light[0] - pt.x, ldy0 = p.light[1] - pt.y, ldz0 = p.light[2] - pt.z;
  const float d2 = ldx0 * ldx0 + ldy0 * ldy0 + ldz0 * ldz0;
  const float d2m = fmaxf(d2, 1e-20f);
  const float il = rsqrt_(d2m);
  const float inv_d2 = il * il;
  const float ldx = ldx0 * il, ldy = ldy0 * il, ldz = ldz0 * il;
  const float ndl = n.x * ldx + n.y * ldy + n.z * ldz;
  const float di = clip(ndl, 0.0f, 1.0f);
  const float dterm = di * p.dpow * inv_d2;
  const float hx = ldx - d.x, hy = ldy - d.y, hz = ldz - d.z;
  const float hh = hx * hx + hy * hy + hz * hz;
  const float hhm = fmaxf(hh, 1e-20f);
  const float ih = rsqrt_(hhm);
  const float q = n.x * hx + n.y * hy + n.z * hz;
  const float ndh = q * ih;
  const float si = clip(ndh, 0.0f, 1.0f);
  const float pw = pow_int(si, p.hardness);
  const float sterm = pw * p.spow * inv_d2;

  float ct_dterm = 0.0f, ct_sterm = 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float cd = col[c] * INV_255;
    const float b = (dterm * p.ldc[c] * cd + sterm * p.lsc[c] * p.osc[c]) * 255.0f;
    const float v = p.amb * cd * 255.0f + (shaded ? vis * b : b);
    const float g = ct_rgb[c] * min_grad(v, 255.0f);
    const float ct_bin = (shaded ? g * vis : g) * 255.0f;
    ct_dterm = ct_dterm + ct_bin * cd * p.ldc[c];
    ct_sterm = ct_sterm + ct_bin * p.osc[c] * p.lsc[c];
    const float ct_cd = g * 255.0f * p.amb + ct_bin * (dterm * p.ldc[c]);
    ct_col[c] = ct_cd * INV_255;
  }
  float ct_inv_d2 = ct_sterm * (pw * p.spow);
  const float ct_si = ct_sterm * inv_d2 * p.spow * dpow_int(si, p.hardness);
  const float ct_ndh = ct_si * clip_grad(ndh, 0.0f, 1.0f);
  const float ct_q = ct_ndh * ih;
  const float ct_hh = ct_ndh * q * (-0.5f * (ih / hhm)) * max_grad(hh, 1e-20f);
  const float ct_hx = ct_q * n.x + ct_hh * hx * 2.0f;
  const float ct_hy = ct_q * n.y + ct_hh * hy * 2.0f;
  const float ct_hz = ct_q * n.z + ct_hh * hz * 2.0f;
  ct_inv_d2 = ct_inv_d2 + ct_dterm * (di * p.dpow);
  const float ct_ndl = ct_dterm * inv_d2 * p.dpow * clip_grad(ndl, 0.0f, 1.0f);
  ct_n->x = ct_q * hx + ct_ndl * ldx;
  ct_n->y = ct_q * hy + ct_ndl * ldy;
  ct_n->z = ct_q * hz + ct_ndl * ldz;
  const float ct_ldx = ct_hx + ct_ndl * n.x;
  const float ct_ldy = ct_hy + ct_ndl * n.y;
  const float ct_ldz = ct_hz + ct_ndl * n.z;
  const float ct_il = ct_ldx * ldx0 + ct_ldy * ldy0 + ct_ldz * ldz0 + ct_inv_d2 * il * 2.0f;
  const float ct_d2 = ct_il * (-0.5f * (il / d2m)) * max_grad(d2, 1e-20f);
  ct_p->x = -(ct_ldx * il + ct_d2 * ldx0 * 2.0f);
  ct_p->y = -(ct_ldy * il + ct_d2 * ldy0 * 2.0f);
  ct_p->z = -(ct_ldz * il + ct_d2 * ldz0 * 2.0f);
  ct_d->x = -ct_hx;
  ct_d->y = -ct_hy;
  ct_d->z = -ct_hz;
}

// Object function outputs: (t_eff, r, g, b, t_clip, nx, ny, nz).
struct ObjOut {
  float t_eff, rgb[3], t_clip, nx, ny, nz;
};

// -- spheres -----------------------------------------------------------------
struct Sphere {
  float cx, cy, cz, r, col[3];
};

// The ray's closest approach to a sphere: h = d . oc (b = 2 h), q = oc - h d
// and the discriminant 4 (r^2 - q . q). For a unit d that is b^2 - 4c, but
// b^2 and 4c are both about 4 |oc|^2 and cancel to the small disc at a
// silhouette or a near miss, where one ulp of either moves the miss
// penalty by mp / r^2 ulps; q . q carries no such cancellation, and an
// error in h moves q along d, to which q . q is first-order blind.
struct SphereSolve {
  float h, qx, qy, qz, disc;
};

SOFT_HD SphereSolve sphere_solve(Vec3 d, float ocx, float ocy, float ocz, float r) {
  SphereSolve v;
  v.h = d.x * ocx + d.y * ocy + d.z * ocz;
  v.qx = ocx - v.h * d.x;
  v.qy = ocy - v.h * d.y;
  v.qz = ocz - v.h * d.z;
  v.disc = 4.0f * (r * r - (v.qx * v.qx + v.qy * v.qy + v.qz * v.qz));
  return v;
}

// The culling lower bound on t_eff and the solve products (t2, dss).
SOFT_HD float sphere_lb_ex(const SoftParams& p, const Sphere& s, Vec3 d, Vec3 o, float* t2,
                           float* dss) {
  const SphereSolve v = sphere_solve(d, o.x - s.cx, o.y - s.cy, o.z - s.cz, s.r);
  const float b = 2.0f * v.h;
  const float disc = v.disc;
  const float sq = sqrtf(fmaxf(disc, 1e-12f));
  *t2 = 0.5f * (-b - sq);
  const float scale = 1.0f / fmaxf(s.r, 1e-3f);
  *dss = disc * scale * scale;
  return clip(*t2, 0.0f, p.far) + p.mp * (fmaxf(-*dss, 0.0f) + fmaxf(-*t2, 0.0f));
}

// Shading-free intersection: (t_eff, t_clip, normal, hit point).
struct Geo {
  float t_eff, t_clip;
  Vec3 n, pt;
};

// An object's outputs from its shading-free geometry: colour col shaded at
// g.pt with the shading normal sn.
SOFT_HD ObjOut obj_out(const SoftParams& p, const Geo& g, const float col[3], Vec3 sn, Vec3 d,
                       float vis = 1.0f, bool shaded = false) {
  ObjOut out;
  out.t_eff = g.t_eff;
  out.t_clip = g.t_clip;
  out.nx = g.n.x;
  out.ny = g.n.y;
  out.nz = g.n.z;
  shade(p, col, g.pt, sn, d, out.rgb, vis, shaded);
  return out;
}

SOFT_HD Geo sphere_geo_post(const SoftParams& p, const Sphere& s, float t2, float dss, Vec3 d,
                            Vec3 o) {
  Geo g;
  const float p_ = p.mp * (pen(p, dss) + pen(p, t2));
  g.t_clip = clip(t2, 0.0f, p.far);
  g.pt = Vec3{o.x + d.x * g.t_clip, o.y + d.y * g.t_clip, o.z + d.z * g.t_clip};
  const float nxr = g.pt.x - s.cx, nyr = g.pt.y - s.cy, nzr = g.pt.z - s.cz;
  const float inn = rsqrt_(fmaxf(nxr * nxr + nyr * nyr + nzr * nzr, 1e-20f));
  g.t_eff = g.t_clip + p_;
  g.n = Vec3{nxr * inn, nyr * inn, nzr * inn};
  return g;
}

SOFT_HD Geo sphere_geo(const SoftParams& p, const Sphere& s, Vec3 d, Vec3 o) {
  float t2, dss;
  sphere_lb_ex(p, s, d, o, &t2, &dss);
  return sphere_geo_post(p, s, t2, dss, d, o);
}

SOFT_HD ObjOut sphere_f_post(const SoftParams& p, const Sphere& s, float t2, float dss, Vec3 d,
                             Vec3 o, float vis = 1.0f, bool shaded = false) {
  const Geo g = sphere_geo_post(p, s, t2, dss, d, o);
  return obj_out(p, g, s.col, g.n, d, vis, shaded);
}

SOFT_HD ObjOut sphere_f(const SoftParams& p, const Sphere& s, Vec3 d, Vec3 o, float vis = 1.0f,
                        bool shaded = false) {
  float t2, dss;
  sphere_lb_ex(p, s, d, o, &t2, &dss);
  return sphere_f_post(p, s, t2, dss, d, o, vis, shaded);
}

// Cotangents of sphere_f's inputs from its output cotangents `ct`:
// g[0..6] the table rows (cx, cy, cz, r, colr, colg, colb), and the ray
// direction and origin cotangents in *ct_d / *ct_o.
SOFT_HD void sphere_f_vjp(const SoftParams& p, const Sphere& s, Vec3 d, Vec3 o,
                          const ObjOut& ct, float g[7], Vec3* ct_d, Vec3* ct_o, float vis = 1.0f,
                          bool shaded = false) {
  const float ocx = o.x - s.cx, ocy = o.y - s.cy, ocz = o.z - s.cz;
  const SphereSolve v = sphere_solve(d, ocx, ocy, ocz, s.r);
  const float b = 2.0f * v.h;
  const float disc = v.disc;
  const float dm = fmaxf(disc, 1e-12f);
  const float sq = sqrtf(dm);
  const float t2 = 0.5f * (-b - sq);
  const float rm = fmaxf(s.r, 1e-3f);
  const float scale = 1.0f / rm;
  const float u = disc * scale;
  const float dss = u * scale;
  const float t_clip = clip(t2, 0.0f, p.far);
  const Vec3 pt = {o.x + d.x * t_clip, o.y + d.y * t_clip, o.z + d.z * t_clip};
  const float nxr = pt.x - s.cx, nyr = pt.y - s.cy, nzr = pt.z - s.cz;
  const float nn = nxr * nxr + nyr * nyr + nzr * nzr;
  const float nnm = fmaxf(nn, 1e-20f);
  const float inn = rsqrt_(nnm);
  const Vec3 n = {nxr * inn, nyr * inn, nzr * inn};

  float ct_col[3];
  Vec3 ct_p, ct_ns, ct_ds;
  shade_vjp(p, s.col, pt, n, d, ct.rgb, ct_col, &ct_p, &ct_ns, &ct_ds, vis, shaded);
  const float ct_nx = ct.nx + ct_ns.x, ct_ny = ct.ny + ct_ns.y, ct_nz = ct.nz + ct_ns.z;
  const float ct_inn = ct_nx * nxr + ct_ny * nyr + ct_nz * nzr;
  const float ct_nn = ct_inn * (-0.5f * (inn / nnm)) * max_grad(nn, 1e-20f);
  const float ct_nxr = ct_nx * inn + ct_nn * nxr * 2.0f;
  const float ct_nyr = ct_ny * inn + ct_nn * nyr * 2.0f;
  const float ct_nzr = ct_nz * inn + ct_nn * nzr * 2.0f;
  const float ct_px = ct_p.x + ct_nxr, ct_py = ct_p.y + ct_nyr, ct_pz = ct_p.z + ct_nzr;
  const float ct_tclip = ct.t_eff + ct.t_clip + (ct_px * d.x + ct_py * d.y + ct_pz * d.z);
  float ct_t2 = ct_tclip * clip_grad(t2, 0.0f, p.far);
  const float ct_pen = ct.t_eff * p.mp;
  const float ct_dss = pen_vjp(p, dss, ct_pen);
  ct_t2 = ct_t2 + pen_vjp(p, t2, ct_pen);
  const float ct_u = ct_dss * scale;
  const float ct_scale = ct_dss * u + ct_u * disc;
  float ct_r = -ct_scale / (rm * rm) * max_grad(s.r, 1e-3f);
  const float ct_sq = -0.5f * ct_t2;
  const float ct_disc = ct_u * scale + ct_sq * (0.5f / sq) * max_grad(disc, 1e-12f);
  const float ct_w = 4.0f * ct_disc;  // w = r^2 - q . q
  ct_r = ct_r + ct_w * s.r * 2.0f;
  const float ct_qx = -ct_w * v.qx * 2.0f;
  const float ct_qy = -ct_w * v.qy * 2.0f;
  const float ct_qz = -ct_w * v.qz * 2.0f;
  const float ct_h = 2.0f * (-0.5f * ct_t2) - (ct_qx * d.x + ct_qy * d.y + ct_qz * d.z);
  const float ct_ocx = ct_h * d.x + ct_qx;
  const float ct_ocy = ct_h * d.y + ct_qy;
  const float ct_ocz = ct_h * d.z + ct_qz;
  g[0] = -(ct_nxr + ct_ocx);
  g[1] = -(ct_nyr + ct_ocy);
  g[2] = -(ct_nzr + ct_ocz);
  g[3] = ct_r;
  g[4] = ct_col[0];
  g[5] = ct_col[1];
  g[6] = ct_col[2];
  ct_d->x = ct_ds.x + ct_px * t_clip + ct_h * ocx - ct_qx * v.h;
  ct_d->y = ct_ds.y + ct_py * t_clip + ct_h * ocy - ct_qy * v.h;
  ct_d->z = ct_ds.z + ct_pz * t_clip + ct_h * ocz - ct_qz * v.h;
  ct_o->x = ct_px + ct_ocx;
  ct_o->y = ct_py + ct_ocy;
  ct_o->z = ct_pz + ct_ocz;
}

// -- planes ------------------------------------------------------------------
struct Plane {
  float cx, cy, cz, nx, ny, nz, hw, hh, col[3];
};

SOFT_HD float plane_lb_ex(const SoftParams& p, const Plane& q, Vec3 d, Vec3 o, float* t,
                          float* denom, float* px, float* pz) {
  *denom = d.x * q.nx + d.y * q.ny + d.z * q.nz;
  const float num = (q.cx - o.x) * q.nx + (q.cy - o.y) * q.ny + (q.cz - o.z) * q.nz;
  const float safe = fabsf(*denom) < FLT_EPS ? -FLT_EPS : *denom;
  *t = num / safe;
  const float t_clip = clip(*t, 0.0f, p.far);
  *px = o.x + d.x * t_clip;
  *pz = o.z + d.z * t_clip;
  return t_clip + p.mp * (fmaxf(*denom + FLT_EPS, 0.0f) + fmaxf(-*t, 0.0f) +
                          fmaxf(fabsf(*px - q.cx) - q.hw, 0.0f) +
                          fmaxf(fabsf(*pz - q.cz) - q.hh, 0.0f));
}

SOFT_HD Vec3 plane_unit_n(const Plane& q) {
  const float pn_inv = rsqrt_(fmaxf(q.nx * q.nx + q.ny * q.ny + q.nz * q.nz, 1e-20f));
  return Vec3{q.nx * pn_inv, q.ny * pn_inv, q.nz * pn_inv};
}

SOFT_HD Geo plane_geo_post(const SoftParams& p, const Plane& q, float t, float denom, float px,
                           float pz, Vec3 d, Vec3 o) {
  Geo g;
  g.t_clip = clip(t, 0.0f, p.far);
  const float py = o.y + d.y * g.t_clip;
  const float p_ = p.mp * (pen(p, -denom - FLT_EPS) + pen(p, t) + pen(p, q.hw - fabsf(px - q.cx)) +
                           pen(p, q.hh - fabsf(pz - q.cz)));
  g.pt = Vec3{px, py, pz};
  g.t_eff = g.t_clip + p_;
  g.n = Vec3{q.nx, q.ny, q.nz};  // the raw plane normal is what the framebuffer blends
  return g;
}

SOFT_HD Geo plane_geo(const SoftParams& p, const Plane& q, Vec3 d, Vec3 o) {
  float t, denom, px, pz;
  plane_lb_ex(p, q, d, o, &t, &denom, &px, &pz);
  return plane_geo_post(p, q, t, denom, px, pz, d, o);
}

SOFT_HD ObjOut plane_f_post(const SoftParams& p, const Plane& q, float t, float denom, float px,
                            float pz, Vec3 d, Vec3 o, float vis = 1.0f, bool shaded = false) {
  return obj_out(p, plane_geo_post(p, q, t, denom, px, pz, d, o), q.col, plane_unit_n(q), d, vis,
                 shaded);
}

SOFT_HD ObjOut plane_f(const SoftParams& p, const Plane& q, Vec3 d, Vec3 o, float vis = 1.0f,
                       bool shaded = false) {
  float t, denom, px, pz;
  plane_lb_ex(p, q, d, o, &t, &denom, &px, &pz);
  return plane_f_post(p, q, t, denom, px, pz, d, o, vis, shaded);
}

// g[0..10]: cotangents of the table rows (cx, cy, cz, nx, ny, nz, hw, hh,
// colr, colg, colb).
SOFT_HD void plane_f_vjp(const SoftParams& p, const Plane& q, Vec3 d, Vec3 o, const ObjOut& ct,
                         float g[11], Vec3* ct_d, Vec3* ct_o, float vis = 1.0f,
                         bool shaded = false) {
  const float denom = d.x * q.nx + d.y * q.ny + d.z * q.nz;
  const float wx = q.cx - o.x, wy = q.cy - o.y, wz = q.cz - o.z;
  const float num = wx * q.nx + wy * q.ny + wz * q.nz;
  const bool small = fabsf(denom) < FLT_EPS;
  const float safe = small ? -FLT_EPS : denom;
  const float t = num / safe;
  const float t_clip = clip(t, 0.0f, p.far);
  const Vec3 pt = {o.x + d.x * t_clip, o.y + d.y * t_clip, o.z + d.z * t_clip};
  const float a1 = -denom - FLT_EPS;
  const float ex = pt.x - q.cx, ez = pt.z - q.cz;
  const float a3 = q.hw - fabsf(ex);
  const float a4 = q.hh - fabsf(ez);
  const float pn2 = q.nx * q.nx + q.ny * q.ny + q.nz * q.nz;
  const float pn2m = fmaxf(pn2, 1e-20f);
  const float pi = rsqrt_(pn2m);
  const Vec3 un = {q.nx * pi, q.ny * pi, q.nz * pi};

  float ct_col[3];
  Vec3 ct_p, ct_u, ct_ds;
  shade_vjp(p, q.col, pt, un, d, ct.rgb, ct_col, &ct_p, &ct_u, &ct_ds, vis, shaded);
  const float ct_pi = ct_u.x * q.nx + ct_u.y * q.ny + ct_u.z * q.nz;
  const float ct_pn2 = ct_pi * (-0.5f * (pi / pn2m)) * max_grad(pn2, 1e-20f);
  const float ct_pen = ct.t_eff * p.mp;
  const float ct_a1 = pen_vjp(p, a1, ct_pen);
  const float ct_a3 = pen_vjp(p, a3, ct_pen);
  const float ct_a4 = pen_vjp(p, a4, ct_pen);
  const float ct_ex = -ct_a3 * abs_grad(ex);
  const float ct_ez = -ct_a4 * abs_grad(ez);
  const float ct_px = ct_p.x + ct_ex;
  const float ct_py = ct_p.y;
  const float ct_pz = ct_p.z + ct_ez;
  const float ct_tclip = ct.t_eff + ct.t_clip + (ct_px * d.x + ct_py * d.y + ct_pz * d.z);
  const float ct_t = pen_vjp(p, t, ct_pen) + ct_tclip * clip_grad(t, 0.0f, p.far);
  const float ct_num = ct_t / safe;
  const float ct_safe = -ct_t * num / (safe * safe);
  const float ct_denom = (small ? 0.0f : ct_safe) - ct_a1;
  g[0] = ct_num * q.nx - ct_ex;
  g[1] = ct_num * q.ny;
  g[2] = ct_num * q.nz - ct_ez;
  g[3] = ct.nx + ct_u.x * pi + ct_pn2 * q.nx * 2.0f + ct_num * wx + ct_denom * d.x;
  g[4] = ct.ny + ct_u.y * pi + ct_pn2 * q.ny * 2.0f + ct_num * wy + ct_denom * d.y;
  g[5] = ct.nz + ct_u.z * pi + ct_pn2 * q.nz * 2.0f + ct_num * wz + ct_denom * d.z;
  g[6] = ct_a3;
  g[7] = ct_a4;
  g[8] = ct_col[0];
  g[9] = ct_col[1];
  g[10] = ct_col[2];
  ct_d->x = ct_ds.x + ct_px * t_clip + ct_denom * q.nx;
  ct_d->y = ct_ds.y + ct_py * t_clip + ct_denom * q.ny;
  ct_d->z = ct_ds.z + ct_pz * t_clip + ct_denom * q.nz;
  ct_o->x = ct_px - ct_num * q.nx;
  ct_o->y = ct_py - ct_num * q.ny;
  ct_o->z = ct_pz - ct_num * q.nz;
}

// -- shadow occluders (pallas_soft.py:343-525) ---------------------------------
// Each hard shadow-ray reject branch is a sigmoid step of sharpness ks, the
// any-occluder OR a product of per-occluder transmittances, evaluated at
// the softmin-blended hit point. The light ray depends on the hit point
// only, so the sweeps compute it once (light_ray) and each occluder's solve
// gives both its gate bound (the min of the constraint args) and the
// sigmoid arguments.

struct LightRay {
  Vec3 sd;     // unit direction to the light
  float dist;  // distance to the light
  Vec3 so;     // shadow-ray origin, offset 1e-2 along sd
};

SOFT_HD LightRay light_ray(const SoftParams& p, Vec3 pt) {
  const float tlx = p.light[0] - pt.x, tly = p.light[1] - pt.y, tlz = p.light[2] - pt.z;
  const float d2 = fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-12f);
  const float inv = rsqrt_(d2);  // one rsqrt for the sqrt and the divide
  LightRay l;
  l.dist = d2 * inv;
  l.sd = Vec3{tlx * inv, tly * inv, tlz * inv};
  l.so = Vec3{pt.x + l.sd.x * 1e-2f, pt.y + l.sd.y * 1e-2f, pt.z + l.sd.z * 1e-2f};
  return l;
}

// Reverse of light_ray: the hit point's cotangent from those of sd, dist, so.
SOFT_HD Vec3 light_ray_vjp(const SoftParams& p, Vec3 pt, Vec3 ct_sd, float ct_dist, Vec3 ct_so) {
  const float tlx = p.light[0] - pt.x, tly = p.light[1] - pt.y, tlz = p.light[2] - pt.z;
  const float d2r = tlx * tlx + tly * tly + tlz * tlz;
  const float d2 = fmaxf(d2r, 1e-12f);
  const float inv = rsqrt_(d2);
  const float csx = ct_sd.x + ct_so.x * 1e-2f, csy = ct_sd.y + ct_so.y * 1e-2f,
              csz = ct_sd.z + ct_so.z * 1e-2f;
  const float ct_inv = ct_dist * d2 + (csx * tlx + csy * tly + csz * tlz);
  const float ct_d2r = (ct_dist * inv + ct_inv * (-0.5f * (inv / d2))) * max_grad(d2r, 1e-12f);
  return Vec3{ct_so.x - (csx * inv + ct_d2r * tlx * 2.0f), ct_so.y - (csy * inv + ct_d2r * tly * 2.0f),
              ct_so.z - (csz * inv + ct_d2r * tlz * 2.0f)};
}

// prod_i sigmoid(ks a_i) as 1 / prod_i (1 + exp(min(-ks a_i, 20))): one
// division. The product may overflow to inf (5 saturated factors): the
// block is then exactly 0, the saturated value.
template <int N>
SOFT_HD float blocked(const SoftParams& p, const float a[N]) {
  float P = 1.0f;
  for (int i = 0; i < N; ++i) P = P * (1.0f + expf(fminf(-p.ks * a[i], 20.0f)));
  return 1.0f / P;
}

template <int N>
SOFT_HD float transmittance(const SoftParams& p, const float a[N]) {
  return fmaxf(1.0f - blocked<N>(p, a), TRANS_FLOOR);
}

// Cotangents of the sigmoid arguments from the transmittance's, with
// d block / d f_i = -block / f_i: no running product is differentiated, so
// an overflowed product gives block = 0 against finite factors, never
// inf * 0.
template <int N>
SOFT_HD void transmittance_vjp(const SoftParams& p, const float a[N], float ct, float ct_a[N]) {
  float z[N], e[N], f[N];
  float P = 1.0f;
  for (int i = 0; i < N; ++i) {
    z[i] = -p.ks * a[i];
    e[i] = expf(fminf(z[i], 20.0f));
    f[i] = 1.0f + e[i];
    P = P * f[i];
  }
  const float block = 1.0f / P;
  const float ct_block = -(ct * max_grad(1.0f - block, TRANS_FLOOR));
  for (int i = 0; i < N; ++i)
    ct_a[i] = -ct_block * block / f[i] * e[i] * min_grad(z[i], 20.0f) * (-p.ks);
}

// Stage A of the split sphere-occluder gate: the quadratic without its
// root. dss (the scaled discriminant) alone rejects most listed occluders.
SOFT_HD void shadow_sphere_preA(const SoftParams& p, const Sphere& s, const LightRay& l,
                                float* disc, float* dss, float* b) {
  const float ocx = l.so.x - s.cx, ocy = l.so.y - s.cy, ocz = l.so.z - s.cz;
  *b = 2.0f * (l.sd.x * ocx + l.sd.y * ocy + l.sd.z * ocz);
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - s.r * s.r;
  *disc = *b * *b - 4.0f * c;
  const float scale = 1.0f / fmaxf(s.r, 1e-3f);
  *dss = *disc * scale * scale;
}

// Stage B: the roots and the four sigmoid arguments; returns their min.
SOFT_HD float shadow_sphere_preB(float disc, float dss, float b, float dist, float args[4]) {
  const float sq = sqrtf(fmaxf(disc, 1e-12f));
  const float t1 = 0.5f * (-b + sq);
  const float t2 = 0.5f * (-b - sq);
  args[0] = dss;
  args[1] = t1;
  args[2] = t2;
  args[3] = dist - t2;
  return fminf(fminf(args[0], args[3]), fminf(t1, t2));
}

SOFT_HD float shadow_sphere_pre(const SoftParams& p, const Sphere& s, const LightRay& l,
                                float args[4]) {
  float disc, dss, b;
  shadow_sphere_preA(p, s, l, &disc, &dss, &b);
  return shadow_sphere_preB(disc, dss, b, l.dist, args);
}

// The five sigmoid arguments of a plane occluder; returns their min.
SOFT_HD float shadow_plane_pre(const SoftParams& p, const Plane& q, const LightRay& l,
                               float args[5]) {
  const float denom = l.sd.x * q.nx + l.sd.y * q.ny + l.sd.z * q.nz;
  const float num = (q.cx - l.so.x) * q.nx + (q.cy - l.so.y) * q.ny + (q.cz - l.so.z) * q.nz;
  const float safe = fabsf(denom) < FLT_EPS ? -FLT_EPS : denom;
  const float t = num / safe;
  const float ppx = l.so.x + l.sd.x * t;
  const float ppz = l.so.z + l.sd.z * t;
  args[0] = -denom - FLT_EPS;
  args[1] = t;
  args[2] = q.hw - fabsf(ppx - q.cx);
  args[3] = q.hh - fabsf(ppz - q.cz);
  args[4] = l.dist - t;
  return fminf(fminf(args[0], args[1]), fminf(fminf(args[2], args[3]), args[4]));
}

// Per-occluder transmittance in [TRANS_FLOOR, 1] at the hit point pt.
SOFT_HD float shadow_sphere_f(const SoftParams& p, const Sphere& s, Vec3 pt) {
  float args[4];
  shadow_sphere_pre(p, s, light_ray(p, pt), args);
  return transmittance<4>(p, args);
}

SOFT_HD float shadow_plane_f(const SoftParams& p, const Plane& q, Vec3 pt) {
  float args[5];
  shadow_plane_pre(p, q, light_ray(p, pt), args);
  return transmittance<5>(p, args);
}

// Cotangents of shadow_sphere_f's 7 inputs: g[0..3] the table rows (cx, cy,
// cz, r), *ct_pt the hit point's.
SOFT_HD void shadow_sphere_f_vjp(const SoftParams& p, const Sphere& s, Vec3 pt, float ct,
                                 float g[4], Vec3* ct_pt) {
  const LightRay l = light_ray(p, pt);
  const float ocx = l.so.x - s.cx, ocy = l.so.y - s.cy, ocz = l.so.z - s.cz;
  const float b = 2.0f * (l.sd.x * ocx + l.sd.y * ocy + l.sd.z * ocz);
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - s.r * s.r;
  const float disc = b * b - 4.0f * c;
  const float sq = sqrtf(fmaxf(disc, 1e-12f));
  const float t1 = 0.5f * (-b + sq);
  const float t2 = 0.5f * (-b - sq);
  const float rm = fmaxf(s.r, 1e-3f);
  const float scale = 1.0f / rm;
  const float u = disc * scale;
  const float a[4] = {u * scale, t1, t2, l.dist - t2};
  float ct_a[4];
  transmittance_vjp<4>(p, a, ct, ct_a);
  const float ct_t2 = ct_a[2] - ct_a[3];
  const float ct_u = ct_a[0] * scale;
  const float ct_scale = ct_a[0] * u + ct_u * disc;
  float ct_r = -ct_scale / (rm * rm) * max_grad(s.r, 1e-3f);
  const float ct_sq = 0.5f * ct_a[1] - 0.5f * ct_t2;
  const float ct_disc = ct_u * scale + ct_sq * (0.5f / sq) * max_grad(disc, 1e-12f);
  const float ct_b = (-0.5f * ct_a[1] - 0.5f * ct_t2) + ct_disc * b * 2.0f;
  const float ct_c = -4.0f * ct_disc;
  ct_r = ct_r - ct_c * s.r * 2.0f;
  const float ct_dot = 2.0f * ct_b;
  const Vec3 ct_oc = {ct_dot * l.sd.x + ct_c * ocx * 2.0f, ct_dot * l.sd.y + ct_c * ocy * 2.0f,
                      ct_dot * l.sd.z + ct_c * ocz * 2.0f};
  g[0] = -ct_oc.x;
  g[1] = -ct_oc.y;
  g[2] = -ct_oc.z;
  g[3] = ct_r;
  *ct_pt = light_ray_vjp(p, pt, Vec3{ct_dot * ocx, ct_dot * ocy, ct_dot * ocz}, ct_a[3], ct_oc);
}

// g[0..7]: cotangents of the table rows (cx, cy, cz, nx, ny, nz, hw, hh).
SOFT_HD void shadow_plane_f_vjp(const SoftParams& p, const Plane& q, Vec3 pt, float ct,
                                float g[8], Vec3* ct_pt) {
  const LightRay l = light_ray(p, pt);
  const float denom = l.sd.x * q.nx + l.sd.y * q.ny + l.sd.z * q.nz;
  const float wx = q.cx - l.so.x, wy = q.cy - l.so.y, wz = q.cz - l.so.z;
  const float num = wx * q.nx + wy * q.ny + wz * q.nz;
  const bool small = fabsf(denom) < FLT_EPS;
  const float safe = small ? -FLT_EPS : denom;
  const float t = num / safe;
  const float ex = l.so.x + l.sd.x * t - q.cx;
  const float ez = l.so.z + l.sd.z * t - q.cz;
  const float a[5] = {-denom - FLT_EPS, t, q.hw - fabsf(ex), q.hh - fabsf(ez), l.dist - t};
  float ct_a[5];
  transmittance_vjp<5>(p, a, ct, ct_a);
  const float ct_ex = -ct_a[2] * abs_grad(ex);
  const float ct_ez = -ct_a[3] * abs_grad(ez);
  const float ct_t = ct_a[1] - ct_a[4] + ct_ex * l.sd.x + ct_ez * l.sd.z;
  const float ct_num = ct_t / safe;
  const float ct_safe = -ct_t * num / (safe * safe);
  const float ct_denom = (small ? 0.0f : ct_safe) - ct_a[0];
  g[0] = ct_num * q.nx - ct_ex;
  g[1] = ct_num * q.ny;
  g[2] = ct_num * q.nz - ct_ez;
  g[3] = ct_num * wx + ct_denom * l.sd.x;
  g[4] = ct_num * wy + ct_denom * l.sd.y;
  g[5] = ct_num * wz + ct_denom * l.sd.z;
  g[6] = ct_a[2];
  g[7] = ct_a[3];
  *ct_pt = light_ray_vjp(
      p, pt, Vec3{ct_ex * t + ct_denom * q.nx, ct_denom * q.ny, ct_ez * t + ct_denom * q.nz},
      ct_a[4], Vec3{ct_ex - ct_num * q.nx, -ct_num * q.ny, ct_ez - ct_num * q.nz});
}

// -- ray generation (D2) -----------------------------------------------------
struct Ray {
  Vec3 d;
  float vx, vy, inv;
};

SOFT_HD Ray raygen(const SoftParams& p, const float* cam, float rowf, float colf) {
  Ray r;
  const float W = (float)p.width, H = (float)p.height;
  r.vx = (2.0f * colf - W) / W * p.e1;
  r.vy = (H - 2.0f * rowf) / H * p.e2;
  const float* b = cam + C_RX;  // rx ry rz ux uy uz fx fy fz
  const float dx = b[0] * r.vx + b[1] * r.vy + b[2];
  const float dy = b[3] * r.vx + b[4] * r.vy + b[5];
  const float dz = b[6] * r.vx + b[7] * r.vy + b[8];
  r.inv = rsqrt_(dx * dx + dy * dy + dz * dz);
  r.d = Vec3{dx * r.inv, dy * r.inv, dz * r.inv};
  return r;
}

// Per-pixel cotangents of the nine basis scalars (rx, ry, rz, ux, ..., fz)
// from the ray's: d = q * rsqrt(q.q) => dL/dq = inv * (g - (g.d) d).
SOFT_HD void raygen_vjp(const Ray& r, Vec3 gd, float out[9]) {
  const float sd = gd.x * r.d.x + gd.y * r.d.y + gd.z * r.d.z;
  const float g3[3] = {gd.x, gd.y, gd.z};
  const float d3[3] = {r.d.x, r.d.y, r.d.z};
  for (int c = 0; c < 3; ++c) {
    const float gp = r.inv * (g3[c] - d3[c] * sd);
    out[3 * c + 0] = gp * r.vx;
    out[3 * c + 1] = gp * r.vy;
    out[3 * c + 2] = gp;
  }
}

// -- two-float (D3) ----------------------------------------------------------
SOFT_HD void two_sum(float a, float b, float* s, float* err) {
  *s = a + b;
  const float bv = *s - a;
  const float av = *s - bv;
  *err = (a - av) + (b - bv);
}

SOFT_HD void tf_combine(float s1, float e1, float s2, float e2, float* s, float* e) {
  float err;
  two_sum(s1, s2, s, &err);
  *e = e1 + e2 + err;
}

}  // namespace soft
