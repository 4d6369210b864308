// K7: hard display forward render for Hopper (sm_90a).
//
// Replaces rtwc_tpu/render/pallas_kernel.py::_ray_kernel_body (launched by
// pallas_render_packed, pl.pallas_call at pallas_kernel.py:290). Per pixel:
// ray generation, the closest hit over the tile's broad-phase sphere list
// and over all live planes, Blinn-Phong shading, and an optional hard shadow
// ray that stops at the first occluder between its hit point and the light.
// Writes the planar [8, Hp, Wp] f32 stack (r, g, b, depth, nx, ny, nz,
// shading).
//
// Design. One thread traces one pixel; one block covers one broad-phase tile
// of (bh, bw) pixels, at most K7_THREADS and a whole number of warps, with
// threadIdx.x along the width, so each of the eight planar stores is
// coalesced. Nothing is allocated here; the wrapper (render/hard_kernel.py)
// allocates the output.
// - The plane table [12, NP] and the tile's listed spheres (7 floats each,
//   STAGE at a time) are staged in shared memory at block start: the
//   block's threads load the list entries and the spheres' parameters side
//   by side, one chain of dependent loads a block, where each listed sphere
//   used to cost every thread a chain of its own (the entry, then seven
//   loads through it).
// - The shadow cull. With shadows, a pixel's shadow ray used to test every
//   live sphere: O(NS) a pixel whatever the tile sees, and the display path
//   grows the scene by a sphere a second. Now each warp reduces the
//   bounding box of its 32 pixels' hit points (a shuffle butterfly, every
//   lane gets it), then tests every live sphere, one a lane in chunks of
//   32, against that box's hull with the light: a shadow ray of the warp
//   runs from a hit point, within r_box of the box's centre, towards the
//   light, so it lies within r_box + SHADOW_BIAS of the segment from the
//   light to the centre, and a sphere it meets has its centre within r +
//   r_box + SHADOW_BIAS of that segment. The test adds a margin of CULL_REL
//   of the scene's distances (the float error of sphere_t moves a decision
//   by about 1e-3 of |oc|: the square root of its discriminant's relative
//   error) plus CULL_ABS. The admitted spheres are compacted, in index
//   order by ballot, into the warp's occluder list of OCC_CAP entries in
//   shared memory; each hit pixel then sweeps that list and the planes. A
//   warp that admits more than OCC_CAP spheres sweeps every live sphere
//   instead, from device memory: the same exact sweep, no fallback. The
//   shadow test is a boolean any-hit, so a sound cull gives the full
//   sweep's result bit for bit. The plain version (render/hard_kernel.py)
//   runs the same cull with the same operations. A warp needs no block
//   barrier for any of it; a cull over the whole block's box took three
//   barriers a chunk and was 17-20 % slower at 1080p with 20 spheres (3 %
//   faster at 3840x2160 with 200; PERF.md section 6).
//
// What bounds it. Each ray does O(list length + NP) intersection work, and
// with shadows O(admitted occluders + NP), and stores 32 B. At 1920x1080 the
// stores are 66 MB, about 20 us at 3.35 TB/s; at display sizes the frame is
// bound by the host loop and the torch ops around the kernel.
//
// Float semantics follow the JAX kernel and the plain torch version in
// render/hard_kernel.py op for op, but for the camera ray's sphere test
// (camera_sphere_t, the soft kernels' discriminant): IEEE division and sqrtf, a correctly
// rounded 1.0f / sqrtf where JAX has lax.rsqrt (the hardware rsqrtf is off
// by up to 2 ulp, and the plain version's 1 / torch.sqrt is exact), specular
// power by repeated squaring. The file is compiled with -fmad=false so that
// no multiply-add is contracted: the kernel and its plain version are
// bit-equal on the card.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// Table rows (render/pack.py).
constexpr int S_CX = 0, S_CY = 1, S_CZ = 2, S_R = 3, S_COLR = 4;
constexpr int P_CX = 0, P_CY = 1, P_CZ = 2, P_NX = 3, P_NY = 4, P_NZ = 5, P_HW = 6,
              P_HH = 7, P_COLR = 8, P_COLG = 9, P_COLB = 10;
constexpr int PL_ROWS = 12;
constexpr int C_POSX = 0, C_POSY = 1, C_POSZ = 2, C_RX = 3, C_RY = 4, C_RZ = 5,
              C_UX = 6, C_UY = 7, C_UZ = 8, C_FX = 9, C_FY = 10, C_FZ = 11, C_ROW0 = 14;
constexpr int O_R = 0, O_G = 1, O_B = 2, O_DEPTH = 3, O_NX = 4, O_NY = 5, O_NZ = 6,
              O_SHADING = 7;
constexpr float MISS = 99999999.0f;        // == 1e8 in f32 (reference.py:27)
constexpr float FLT_EPS = 1.1920929e-07f;  // plane parallel-ray reject
constexpr float SHADOW_BIAS = 1e-3f;       // shadow origin along the light ray

constexpr int K7_THREADS = 256;  // the largest block: a 16x16 tile
constexpr int K7_WARPS = K7_THREADS / 32;
// Blocks an SM that K7 is built for: 5, at most 48 registers a thread (24 B
// of spill stores). On an H100 at 4 / 5 blocks (60 / 48 registers) it took
// 0.0566 / 0.0557 ms at 1080p with 20 spheres and shadows, 0.0842 /
// 0.0813 at 3840x1000 with 100 spheres (PERF.md section 6).
constexpr int K7_MIN_BLOCKS = 5;
constexpr int STAGE = K7_THREADS;  // list entries staged at once
constexpr int STAGED = 7;          // cx, cy, cz, r, colour: rows 0-6 of the table
constexpr int OCC_CAP = 64;        // a warp's occluder list entries (cx, cy, cz, r)
// The cull's margin (render/hard_kernel.py CULL_REL, CULL_ABS).
constexpr float CULL_REL = 1e-2f, CULL_ABS = 2e-3f;
constexpr unsigned FULL = 0xffffffffu;

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

__device__ __forceinline__ float rsqrt_(float x) { return 1.0f / sqrtf(x); }

// A camera ray against a sphere: the discriminant as 4 (r^2 - q . q), q = oc
// - (d . oc) d (soft_common.cuh sphere_solve). b^2 - 4c cancels at t ~ 90
// and puts the normal off by up to 7e-4, 1e-2 of rgb after shading.
__device__ __forceinline__ bool camera_sphere_t(float scx, float scy, float scz, float r,
                                                float ox, float oy, float oz, float dx,
                                                float dy, float dz, float* t_out) {
  const float ocx = ox - scx, ocy = oy - scy, ocz = oz - scz;
  const float h = dx * ocx + dy * ocy + dz * ocz;
  const float qx = ocx - h * dx, qy = ocy - h * dy, qz = ocz - h * dz;
  const float disc = 4.0f * (r * r - (qx * qx + qy * qy + qz * qz));
  const float b = 2.0f * h;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t1 = 0.5f * (-b + sq);
  const float t2 = 0.5f * (-b - sq);
  *t_out = fminf(t1, t2);
  return (disc >= 0.0f) && (t1 >= 0.0f) && (t2 >= 0.0f);
}

// A shadow ray against a sphere: b^2 - 4c, as JAX's kernel (a decision only).
__device__ __forceinline__ bool sphere_t(float scx, float scy, float scz, float r, float ox,
                                         float oy, float oz, float dx, float dy, float dz,
                                         float* t_out) {
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

// Copies list entries c0 .. c0 + n - 1 of the tile's row and their spheres'
// rows 0-6 into s_sph [STAGED, STAGE]. No barrier.
__device__ __forceinline__ void stage_spheres(const float* __restrict__ sph, int ns,
                                              const int* __restrict__ lst, int c0, int n,
                                              float* s_sph, int tid, int nthreads) {
  for (int e = tid; e < n; e += nthreads) {
    const int k = __ldg(lst + 1 + c0 + e);
#pragma unroll
    for (int f = 0; f < STAGED; ++f) s_sph[f * STAGE + e] = __ldg(sph + f * ns + k);
  }
}

__global__ void __launch_bounds__(K7_THREADS, K7_MIN_BLOCKS)
hard_render_kernel(HardParams p, const float* __restrict__ cam, const float* __restrict__ sph,
                   const float* __restrict__ pl_g, const int* __restrict__ counts,
                   const int* __restrict__ lists, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_pl = smem;                     // [12, NP]
  float* s_sph = smem + PL_ROWS * p.np;   // [STAGED, STAGE]
  __shared__ float s_occ[K7_WARPS][4][OCC_CAP];  // each warp's occluder list
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int lane = tid & 31, warp = tid >> 5;
  const int ti = blockIdx.y, tj = blockIdx.x;
  const int* lst = lists + (size_t)(ti * (p.wp / p.bw) + tj) * p.list_stride;
  const int n_list = __ldg(lst);
  for (int e = tid; e < PL_ROWS * p.np; e += nthreads) s_pl[e] = pl_g[e];
  stage_spheres(sph, p.ns, lst, 0, min(n_list, STAGE), s_sph, tid, nthreads);
  __syncthreads();

  const int n_sph = __ldg(counts + 0);
  const int n_pl = __ldg(counts + 1);
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
  const float inv_len = rsqrt_(dx * dx + dy * dy + dz * dz);
  dx = dx * inv_len;
  dy = dy * inv_len;
  dz = dz * inv_len;

  // --- closest hit: the tile's staged sphere list, then every live plane ---
  float t_best = MISS, snx = 0.0f, sny = 0.0f, snz = 0.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  for (int c0 = 0; c0 < n_list; c0 += STAGE) {
    const int n = min(STAGE, n_list - c0);
    if (c0 > 0) {  // the next chunk, once every thread is done with this one
      __syncthreads();
      stage_spheres(sph, p.ns, lst, c0, n, s_sph, tid, nthreads);
      __syncthreads();
    }
    for (int kk = 0; kk < n; ++kk) {
      const float scx = s_sph[S_CX * STAGE + kk], scy = s_sph[S_CY * STAGE + kk];
      const float scz = s_sph[S_CZ * STAGE + kk];
      float t;
      if (camera_sphere_t(scx, scy, scz, s_sph[S_R * STAGE + kk], ox, oy, oz, dx, dy, dz,
                          &t) &&
          t < t_best) {
        t_best = t;
        const float px = ox + dx * t - scx;
        const float py = oy + dy * t - scy;
        const float pz = oz + dz * t - scz;
        const float n_inv = rsqrt_(px * px + py * py + pz * pz);
        snx = px * n_inv;
        sny = py * n_inv;
        snz = pz * n_inv;
        cr = s_sph[S_COLR * STAGE + kk];
        cg = s_sph[(S_COLR + 1) * STAGE + kk];
        cb = s_sph[(S_COLR + 2) * STAGE + kk];
      }
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
  const float lx = p.light[0], ly = p.light[1], lz = p.light[2];
  float ldx = lx - px, ldy = ly - py, ldz = lz - pz;
  const float d2 = ldx * ldx + ldy * ldy + ldz * ldz;
  const float inv_d2 = 1.0f / d2;
  const float l_inv = rsqrt_(fmaxf(d2, 1e-20f));
  ldx = ldx * l_inv;
  ldy = ldy * l_inv;
  ldz = ldz * l_inv;
  const float ndotl = fminf(fmaxf(snx * ldx + sny * ldy + snz * ldz, 0.0f), 1.0f);

  float light_vis = 1.0f;
  if (p.shadows) {  // block-uniform
    // the bounding box of the warp's hit points: min xyz, max xyz, in every lane
    float bx[6] = {hit ? px : CUDART_INF_F, hit ? py : CUDART_INF_F, hit ? pz : CUDART_INF_F,
                   hit ? px : -CUDART_INF_F, hit ? py : -CUDART_INF_F, hit ? pz : -CUDART_INF_F};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        bx[i] = fminf(bx[i], __shfl_xor_sync(FULL, bx[i], off));
        bx[3 + i] = fmaxf(bx[3 + i], __shfl_xor_sync(FULL, bx[3 + i], off));
      }
    }
    int n_occ = 0;  // spheres the warp's cull admits, in index order
    float(*w_occ)[OCC_CAP] = s_occ[warp];
    if (bx[0] <= bx[3]) {  // some pixel of the warp hits
      const float bcx = 0.5f * (bx[0] + bx[3]), bcy = 0.5f * (bx[1] + bx[4]);
      const float bcz = 0.5f * (bx[2] + bx[5]);
      const float ex = bx[3] - bx[0], ey = bx[4] - bx[1], ez = bx[5] - bx[2];
      const float r_box = 0.5f * sqrtf(ex * ex + ey * ey + ez * ez);
      const float ux = bcx - lx, uy = bcy - ly, uz = bcz - lz;
      const float uu = ux * ux + uy * uy + uz * uz;
      const float u_len = sqrtf(uu);
      const float l_len = sqrtf(lx * lx + ly * ly + lz * lz);
      for (int base = 0; base < n_sph && n_occ <= OCC_CAP; base += 32) {
        const int k = base + lane;
        bool admit = false;
        float scx = 0.0f, scy = 0.0f, scz = 0.0f, r = 0.0f;
        if (k < n_sph) {
          scx = __ldg(sph + S_CX * p.ns + k);
          scy = __ldg(sph + S_CY * p.ns + k);
          scz = __ldg(sph + S_CZ * p.ns + k);
          r = __ldg(sph + S_R * p.ns + k);
          const float wx = scx - lx, wy = scy - ly, wz = scz - lz;
          const float wu = wx * ux + wy * uy + wz * uz;
          const float s = fminf(fmaxf(uu > 0.0f ? wu / uu : 0.0f, 0.0f), 1.0f);
          const float qx = wx - s * ux, qy = wy - s * uy, qz = wz - s * uz;
          const float q2 = qx * qx + qy * qy + qz * qz;
          const float w_len = sqrtf(wx * wx + wy * wy + wz * wz);
          const float reach =
              r + r_box + (CULL_REL * (w_len + u_len + r_box + l_len) + CULL_ABS);
          admit = q2 <= reach * reach;
        }
        const unsigned ballot = __ballot_sync(FULL, admit);
        const int pos = n_occ + __popc(ballot & ((1u << lane) - 1u));
        if (admit && pos < OCC_CAP) {
          w_occ[0][pos] = scx;
          w_occ[1][pos] = scy;
          w_occ[2][pos] = scz;
          w_occ[3][pos] = r;
        }
        n_occ += __popc(ballot);
      }
      __syncwarp();
    }
    if (hit) {
      const float sox = px + ldx * SHADOW_BIAS;
      const float soy = py + ldy * SHADOW_BIAS;
      const float soz = pz + ldz * SHADOW_BIAS;
      const float dist_l = sqrtf(d2);
      // min over occluders < dist_l  <=>  some occluder t < min(dist_l, MISS)
      const float limit = fminf(dist_l, MISS);
      bool blocked = false;
      if (n_occ > OCC_CAP) {  // the list overflowed: every live sphere
        for (int k = 0; k < n_sph && !blocked; ++k) {
          float t;
          blocked = sphere_t(__ldg(sph + S_CX * p.ns + k), __ldg(sph + S_CY * p.ns + k),
                             __ldg(sph + S_CZ * p.ns + k), __ldg(sph + S_R * p.ns + k), sox,
                             soy, soz, ldx, ldy, ldz, &t) && t < limit;
        }
      } else {
        for (int j = 0; j < n_occ && !blocked; ++j) {
          float t;
          blocked = sphere_t(w_occ[0][j], w_occ[1][j], w_occ[2][j], w_occ[3][j], sox, soy, soz,
                             ldx, ldy, ldz, &t) && t < limit;
        }
      }
      for (int k = 0; k < n_pl && !blocked; ++k) {
        float t;
        blocked = plane_t(s_pl, p.np, k, sox, soy, soz, ldx, ldy, ldz, &t) && t < limit;
      }
      light_vis = blocked ? 0.0f : 1.0f;
    }
  }

  const float hx = ldx - dx, hy = ldy - dy, hz = ldz - dz;
  const float h_inv = rsqrt_(fmaxf(hx * hx + hy * hy + hz * hz, 1e-20f));
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
  if (p.bh * p.bw > K7_THREADS || (p.bh * p.bw) % 32 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(p.device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (PL_ROWS * (size_t)p.np + STAGED * STAGE);
  const size_t static_smem = sizeof(float) * K7_WARPS * 4 * OCC_CAP;  // the occluder lists
  if (smem + static_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(hard_render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 block(p.bw, p.bh);
  dim3 grid(p.wp / p.bw, p.hp / p.bh);
  hard_render_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(p, cam, sph, pl, counts,
                                                                 lists, out);
  return (int)cudaGetLastError();
}
