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
// functions and hand-written adjoints in soft_common.cuh; the block sums
// and the forward and backward sweeps in soft_block.cuh.
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
// warp order, by one thread (csrc/soft_block.cuh). soft_grad_reduce sums
// the partials: each of 256 threads walks a fixed chunk in tile order (for
// a sphere: its main-list entries, then the shadow-list entries that the
// shadowed kernels of csrc/soft_shadow.cu write), then a fixed tree. No
// float atomics anywhere: the tables are bit-equal from launch to launch.
//
// What bounds it. Per pixel, K1 does O(list + planes) object evaluations
// (two transcendentals each in the penalties plus an exp per softmin step),
// K2 and K3 a forward replay and a hand-written adjoint per gated object,
// and a few dozen shuffles per gated object per block for the sums. Stores
// are 40 B per pixel (K1); K2 reads 68 B per pixel (9 saved planes, alpha
// unread, and 8 cotangent planes), i.e. 84 / 142 MB at 1080p: about 25 /
// 42 us at 3.35 TB/s. The kernels are compute- and
// latency-bound (registers carry the saved planes, the cotangents and the
// ray residuals), and at the sizes of the train path the torch work around
// them (broad phase, pack, optimiser) is as large. A simple design that is
// right comes first; making it fast is later work.
//
// Float semantics follow the plain versions op for op; compiled with
// -fmad=false (see soft_common.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "soft_block.cuh"

using namespace soft;

struct ReduceParams {
  int ns, np, n_entries, n_tiles, ntf, device;
  int n_sh_entries;  // shadow-list sphere partials (K5, K6); 0 otherwise
};

namespace {

// K1's sweep (also K3's forward): the online softmin over forward_sweep's
// objects, accumulating the first NACC of (rgb, t_clip, normal).
template <int NACC>
__device__ __forceinline__ void softmin_sweep(const SoftParams& p, const float* __restrict__ cam,
                                              const float* __restrict__ sph, const float* s_pl,
                                              const int* __restrict__ lst, int* gate_row, Vec3 d,
                                              Vec3 o, float* m, float* s, float acc[NACC]) {
  forward_sweep(p, cam, sph, s_pl, lst, gate_row, d, o, m,
                [&](const Geo& g, const float* col, Vec3 sn) {
                  accumulate<NACC>(p, obj_out(p, g, col, sn, d), m, s, acc);
                });
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
  softmin_sweep<7>(p, cam, sph, s_pl, lists + (size_t)tile * p.list_stride,
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
  softmin_sweep<3>(p, cam, sph, s_pl, lst, s_gate, r.d, o, &m, &s, acc);
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
                        const int* __restrict__ pidx, const float* __restrict__ psh,
                        const int* __restrict__ pshidx, const float* __restrict__ ppl,
                        const float* __restrict__ ptf, float* __restrict__ dsph,
                        float* __restrict__ dpl, float* __restrict__ dtf) {
  __shared__ float s_a[11][256];
  __shared__ float s_e[256];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  if (b < rp.ns) {  // one sphere: its entries, in tile order, then its shadow entries
    const int k = b;
    const int chunk = max(1, (rp.n_entries + 255) / 256);
    float acc[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const int e1 = min(rp.n_entries, (tid + 1) * chunk);
    for (int e = tid * chunk; e < e1; ++e)
      if (__ldg(pidx + e) == k)
        for (int i = 0; i < 7; ++i) acc[i] = acc[i] + __ldg(pvals + (size_t)e * 8 + i);
    const int chunk_sh = max(1, (rp.n_sh_entries + 255) / 256);
    const int e2 = min(rp.n_sh_entries, (tid + 1) * chunk_sh);
    for (int e = tid * chunk_sh; e < e2; ++e)
      if (__ldg(pshidx + e) == k)
        for (int i = 0; i < 4; ++i) acc[i] = acc[i] + __ldg(psh + (size_t)e * 4 + i);
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

extern "C" int rtwc_soft_grad_reduce(const float* pvals, const int* pidx, const float* psh,
                                     const int* pshidx, const float* ppl, const float* ptf,
                                     float* dsph, float* dpl, float* dtf,
                                     const ReduceParams* params, void* stream) {
  const ReduceParams rp = *params;
  cudaError_t err = cudaSetDevice(rp.device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = rp.ns + rp.np + rp.ntf;
  soft_grad_reduce_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(rp, pvals, pidx, psh, pshidx,
                                                                    ppl, ptf, dsph, dpl, dtf);
  return (int)cudaGetLastError();
}
