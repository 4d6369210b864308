// K7: hard display forward render for Hopper (sm_90a).
//
// Replaces rtwc_tpu/render/pallas_kernel.py::_ray_kernel_body (launched by
// pallas_render_packed, pl.pallas_call at pallas_kernel.py:290). Per pixel:
// ray generation, the closest hit over the tile's broad-phase sphere list
// and over all live planes, Blinn-Phong shading, and an optional hard shadow
// ray that sweeps every live sphere and plane. Writes the planar [8, Hp, Wp]
// f32 stack (r, g, b, depth, nx, ny, nz, shading).
//
// Design. One thread traces one pixel; one block covers one broad-phase tile
// of (bh, bw) pixels with threadIdx.x along the width, so each of the eight
// planar stores is coalesced. The block reads its own list row
// lists[tile, 0, :] (count, then indices). Sphere parameters are read
// through __ldg: the index is the same for every thread of the block, so
// each load is a broadcast, and the [8, NS] table (128 KB at NS = 4096) is
// never staged whole in shared memory. The plane table [12, NP] is small and
// is staged in dynamic shared memory. Nothing is allocated here; the
// wrapper (render/hard_kernel.py) allocates the output.
//
// What bounds it. Each ray does O(list length + NP) intersection work, or
// O(NS + NP) with shadows, and stores 32 B. At 1920x1080 the stores are
// 66 MB, about 20 us at 3.35 TB/s, so at display sizes the frame is bound by
// the host loop and the small torch ops around the kernel rather than by the
// kernel. The shadow sweep is the one place where work grows with the whole
// scene; it stops at the first occluder closer than the light (the result
// equals the full minimum sweep's `sh_t < dist_l` test) and is skipped for
// rays that hit nothing, whose shading is masked anyway.
//
// Float semantics follow the JAX kernel and the plain torch version in
// render/hard_kernel.py op for op: IEEE division and sqrtf, rsqrtf where JAX
// has lax.rsqrt, specular power by repeated squaring. The file is compiled
// with -fmad=false so that no multiply-add is contracted: a contracted
// b*b - 4c changes disc by one rounding, and at near-tangent rays that moves
// sqrt(disc), the depth and the normal well past the comparison tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Table rows (render/pack.py).
constexpr int S_CX = 0, S_CY = 1, S_CZ = 2, S_R = 3, S_COLR = 4, S_COLG = 5, S_COLB = 6;
constexpr int P_CX = 0, P_CY = 1, P_CZ = 2, P_NX = 3, P_NY = 4, P_NZ = 5, P_HW = 6,
              P_HH = 7, P_COLR = 8, P_COLG = 9, P_COLB = 10;
constexpr int PL_ROWS = 12;
constexpr int C_POSX = 0, C_POSY = 1, C_POSZ = 2, C_RX = 3, C_RY = 4, C_RZ = 5,
              C_UX = 6, C_UY = 7, C_UZ = 8, C_FX = 9, C_FY = 10, C_FZ = 11, C_ROW0 = 14;
constexpr int O_R = 0, O_G = 1, O_B = 2, O_DEPTH = 3, O_NX = 4, O_NY = 5, O_NZ = 6,
              O_SHADING = 7;
constexpr float MISS = 99999999.0f;        // == 1e8 in f32 (reference.py:27)
constexpr float FLT_EPS = 1.1920929e-07f;  // plane parallel-ray reject

}  // namespace

// Render constants that JAX bakes into the kernel as static values.
// The same layout is declared with ctypes in render/hard_kernel.py.
struct HardParams {
  int width, height;      // full image (NDC math)
  int hp, wp;             // padded output extent
  int bh, bw;             // tile = block extent
  int ns, np;             // table widths
  int list_stride;        // NS + 1
  int shadows;
  int hardness;           // int(specular_hardness)
  int device;
  float e1, e2;
  float light[3];
  float light_diffuse[3];
  float light_specular[3];
  float object_specular[3];
  float diffuse_power, specular_power, ambient;
};

__device__ __forceinline__ float pow_int(float x, int n) {
  // x**n by repeated squaring, the same products as pallas_kernel._pow_int.
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

__device__ __forceinline__ bool sphere_t(const float* __restrict__ sph, int ns, int k,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz, float* t_out) {
  const float scx = __ldg(sph + S_CX * ns + k);
  const float scy = __ldg(sph + S_CY * ns + k);
  const float scz = __ldg(sph + S_CZ * ns + k);
  const float r = __ldg(sph + S_R * ns + k);
  const float ocx = ox - scx, ocy = oy - scy, ocz = oz - scz;
  const float b = 2.0f * (dx * ocx + dy * ocy + dz * ocz);
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
  const float disc = b * b - 4.0f * c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t1 = 0.5f * (-b + sq);
  const float t2 = 0.5f * (-b - sq);
  *t_out = fminf(t1, t2);
  return (disc >= 0.0f) && (t1 >= 0.0f) && (t2 >= 0.0f);
}

__device__ __forceinline__ bool plane_t(const float* pl, int np, int k,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz, float* t_out) {
  const float pcx = pl[P_CX * np + k], pcy = pl[P_CY * np + k], pcz = pl[P_CZ * np + k];
  const float pnx = pl[P_NX * np + k], pny = pl[P_NY * np + k], pnz = pl[P_NZ * np + k];
  const float denom = dx * pnx + dy * pny + dz * pnz;
  const float num = (pcx - ox) * pnx + (pcy - oy) * pny + (pcz - oz) * pnz;
  const float safe = fabsf(denom) < FLT_EPS ? -1.0f : denom;
  const float t = num / safe;
  const float hx = ox + dx * t;
  const float hz = oz + dz * t;
  *t_out = t;
  return (denom < -FLT_EPS) && (t > 0.0f) && (fabsf(hx - pcx) < pl[P_HW * np + k]) &&
         (fabsf(hz - pcz) < pl[P_HH * np + k]);
}

__global__ void __launch_bounds__(1024)
hard_render_kernel(HardParams p, const float* __restrict__ cam, const float* __restrict__ sph,
                   const float* __restrict__ pl_g, const int* __restrict__ counts,
                   const int* __restrict__ lists, float* __restrict__ out) {
  extern __shared__ float s_pl[];  // [12, NP]
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int e = tid; e < PL_ROWS * p.np; e += nthreads) s_pl[e] = pl_g[e];
  __syncthreads();

  const int n_sph = __ldg(counts + 0);
  const int n_pl = __ldg(counts + 1);
  const int ti = blockIdx.y, tj = blockIdx.x;
  const int row = ti * p.bh + threadIdx.y;
  const int col = tj * p.bw + threadIdx.x;

  // --- ray generation -------------------------------------------------------
  const float W = (float)p.width, H = (float)p.height;
  const float rowf = __ldg(cam + C_ROW0) + (float)(ti * p.bh) + (float)threadIdx.y;
  const float colf = (float)(tj * p.bw) + (float)threadIdx.x;
  const float cx = (2.0f * colf - W) / W;
  const float cy = (H - 2.0f * rowf) / H;
  const float vx = cx * p.e1;
  const float vy = cy * p.e2;
  const float ox = __ldg(cam + C_POSX), oy = __ldg(cam + C_POSY), oz = __ldg(cam + C_POSZ);
  float dx = __ldg(cam + C_RX) * vx + __ldg(cam + C_RY) * vy + __ldg(cam + C_RZ);
  float dy = __ldg(cam + C_UX) * vx + __ldg(cam + C_UY) * vy + __ldg(cam + C_UZ);
  float dz = __ldg(cam + C_FX) * vx + __ldg(cam + C_FY) * vy + __ldg(cam + C_FZ);
  const float inv_len = rsqrtf(dx * dx + dy * dy + dz * dz);
  dx = dx * inv_len;
  dy = dy * inv_len;
  dz = dz * inv_len;

  // --- closest hit: the tile's sphere list, then every live plane ----------
  float t_best = MISS, snx = 0.0f, sny = 0.0f, snz = 0.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  const int* lst = lists + (size_t)(ti * (p.wp / p.bw) + tj) * p.list_stride;
  const int n_list = __ldg(lst);
  for (int kk = 0; kk < n_list; ++kk) {
    const int k = __ldg(lst + 1 + kk);
    float t;
    const bool valid = sphere_t(sph, p.ns, k, ox, oy, oz, dx, dy, dz, &t);
    if (valid && t < t_best) {
      t_best = t;
      const float px = ox + dx * t - __ldg(sph + S_CX * p.ns + k);
      const float py = oy + dy * t - __ldg(sph + S_CY * p.ns + k);
      const float pz = oz + dz * t - __ldg(sph + S_CZ * p.ns + k);
      const float n_inv = rsqrtf(px * px + py * py + pz * pz);
      snx = px * n_inv;
      sny = py * n_inv;
      snz = pz * n_inv;
      cr = __ldg(sph + S_COLR * p.ns + k);
      cg = __ldg(sph + S_COLG * p.ns + k);
      cb = __ldg(sph + S_COLB * p.ns + k);
    }
  }
  for (int k = 0; k < n_pl; ++k) {
    float t;
    const bool valid = plane_t(s_pl, p.np, k, ox, oy, oz, dx, dy, dz, &t);
    if (valid && t < t_best) {
      t_best = t;
      snx = s_pl[P_NX * p.np + k];
      sny = s_pl[P_NY * p.np + k];
      snz = s_pl[P_NZ * p.np + k];
      cr = s_pl[P_COLR * p.np + k];
      cg = s_pl[P_COLG * p.np + k];
      cb = s_pl[P_COLB * p.np + k];
    }
  }
  const bool hit = t_best < MISS;

  // --- Blinn-Phong ----------------------------------------------------------
  const float px = ox + dx * t_best;
  const float py = oy + dy * t_best;
  const float pz = oz + dz * t_best;
  float ldx = p.light[0] - px, ldy = p.light[1] - py, ldz = p.light[2] - pz;
  const float d2 = ldx * ldx + ldy * ldy + ldz * ldz;
  const float inv_d2 = 1.0f / d2;
  const float l_inv = rsqrtf(fmaxf(d2, 1e-20f));
  ldx = ldx * l_inv;
  ldy = ldy * l_inv;
  ldz = ldz * l_inv;
  const float ndotl = fminf(fmaxf(snx * ldx + sny * ldy + snz * ldz, 0.0f), 1.0f);

  float light_vis = 1.0f;
  if (p.shadows && hit) {
    const float sox = px + ldx * 1e-3f;
    const float soy = py + ldy * 1e-3f;
    const float soz = pz + ldz * 1e-3f;
    const float dist_l = sqrtf(d2);
    // min over occluders < dist_l  <=>  some occluder t < min(dist_l, MISS)
    const float limit = fminf(dist_l, MISS);
    bool blocked = false;
    for (int k = 0; k < n_sph && !blocked; ++k) {
      float t;
      blocked = sphere_t(sph, p.ns, k, sox, soy, soz, ldx, ldy, ldz, &t) && t < limit;
    }
    for (int k = 0; k < n_pl && !blocked; ++k) {
      float t;
      blocked = plane_t(s_pl, p.np, k, sox, soy, soz, ldx, ldy, ldz, &t) && t < limit;
    }
    light_vis = blocked ? 0.0f : 1.0f;
  }

  const float hx = ldx - dx, hy = ldy - dy, hz = ldz - dz;
  const float h_inv = rsqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-20f));
  const float ndoth = fminf(
      fmaxf(snx * hx * h_inv + sny * hy * h_inv + snz * hz * h_inv, 0.0f), 1.0f);
  const float spec_i = pow_int(ndoth, p.hardness);
  const float diff_term = p.diffuse_power * inv_d2 * ndotl * light_vis;
  const float spec_term = p.specular_power * inv_d2 * spec_i * light_vis;

  const float cols[3] = {cr, cg, cb};
  const size_t plane = (size_t)p.hp * p.wp;
  const size_t pix = (size_t)row * p.wp + col;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float cd = cols[ch] * (float)(1.0 / 255.0);  // as the f32 scalar 1.0/255.0
    const float s = p.ambient * cd + diff_term * p.light_diffuse[ch] * cd +
                    spec_term * p.light_specular[ch] * p.object_specular[ch];
    out[ch * plane + pix] = hit ? fminf(255.0f, s * 255.0f) : 0.0f;
  }
  out[O_DEPTH * plane + pix] = t_best;
  out[O_NX * plane + pix] = hit ? snx : 0.0f;
  out[O_NY * plane + pix] = hit ? sny : 0.0f;
  out[O_NZ * plane + pix] = hit ? snz : 0.0f;
  out[O_SHADING * plane + pix] = hit ? snx : 0.0f;
}

// C entry for ctypes. Pointers are device pointers of contiguous tensors the
// wrapper has checked; `stream` is PyTorch's current stream. Returns the
// cudaError_t of the launch (0 on success). Does not synchronise.
extern "C" int rtwc_hard_render(const float* cam, const float* sph, const float* pl,
                                const int* counts, const int* lists, float* out,
                                const HardParams* params, void* stream) {
  const HardParams p = *params;
  cudaError_t err = cudaSetDevice(p.device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * PL_ROWS * (size_t)p.np;
  dim3 block(p.bw, p.bh);
  dim3 grid(p.wp / p.bw, p.hp / p.bh);
  hard_render_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(p, cam, sph, pl, counts,
                                                                 lists, out);
  return (int)cudaGetLastError();
}
