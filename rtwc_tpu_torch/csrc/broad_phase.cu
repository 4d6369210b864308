// The broad phase for Hopper (sm_90a): per-tile sphere lists, shadow-occluder
// lists, and the fixed-capacity entry tables of the soft kernels' partials.
//
// Replaces, on the card, the port's broad phase in torch ops
// (render/broad_phase.py, which stays as the plain version): `_tile_cones`,
// `sphere_tile_lists`, `plane_depth_bounds`, `shadow_tile_lists` and
// `_compact_lists`, and the step's bookkeeping of the partials. Its JAX
// counterpart is rtwc_tpu/render/pallas_soft.py:619-982 (`_build_tile_lists`
// at :968), XLA device code there, compiled with the step into one program;
// no Pallas kernel. The wrappers are in render/list_kernel.py.
//
// Two kernels:
//  tile_lists_kernel<SHADOWS>: LIST_WARPS warps a block, as many blocks as
//    the card holds at once; each warp walks tiles. The block's prologue
//    stages, once for all its tiles, what the tests need of each sphere and
//    does not depend on the tile: the direction and distance from the eye,
//    the two radius angles (asinf), the near tests, the occluder terms (w,
//    ww, r_keep), and the spheres' order near to far (index order at ties),
//    in shared memory. A tile then costs its cone, built a corner a lane
//    (broad_phase._tile_cones, the rays the renderers trace); the view test,
//    a sphere a lane; its row, the count and the admitted spheres near to
//    far, placed by walking the staged order (the order torch.argsort(
//    stable=True) gives, which fixes how the kernels resolve exact ties);
//    and the aux planes t_hi_sph and sky_sph. With SHADOWS: the plane depth
//    bounds, computed for a batch of PLANE_BATCH tiles of the warp at once,
//    a (tile, corner) pair a lane, over the live planes in turn (a plane's
//    four softplus penalties on its tile's four lanes); the eight balls of
//    the truncated view cone, a ball a lane, staged in the warp's shared
//    memory; the occluder test, a sphere a lane; and the shadow row, the
//    count and the kept occluders in index order. A row's slots past its
//    count are not written: every card consumer reads a row up to its count
//    (the plain versions mask those slots).
//    Both tests go in two passes. A pre-test settles most spheres with a
//    few fused multiply-adds, far from its threshold by a margin that
//    covers every rounding: for the view, the near tests, or the cosine of
//    the angle to the sphere below cos(cone + max(alpha, alpha40)) by
//    VIEW_MARGIN; for the occluders, the distance from the plane of the
//    light and the tile's view segment (which holds every ball's segment)
//    above max R + r_keep by OCC_REL and OCC_ABS. The rest, marked in a
//    mask of the warp, take the exact test a mask word at a time:
//    broad_phase.py's arithmetic, a sphere a lane: the view test's acosf,
//    and the occluder test against the eight balls, its spheres gathered
//    32 at a time in a queue of the warp. The exact occluder test first
//    evaluates d2 = |w - t v|^2 with fused multiply-adds and a
//    reciprocal and takes the decision from it only where d2 lies farther
//    than KAPPA of the magnitudes (ww + vv + (R + r_keep)^2) from
//    (R + r_keep)^2: the two evaluations of d2 differ by some 20 float32
//    rounding steps of those magnitudes at most, and KAPPA is 2^-12.
//    Elsewhere it runs the division, the sqrt and the compare of d - R with
//    r_keep. No [rows, Tj, 8, NS] temporary reaches device memory; ballots
//    place the entries; no block barrier after the prologue.
//  entry_tables_kernel: one pass from the lists to the soft kernels'
//    tables, ENTRY_THREADS tiles of one list a block. A block scans its
//    tiles' counts, publishes its total, adds its predecessors' totals (each
//    block waits only for blocks before it, which the card starts first) and
//    writes each tile's offset, the sphere of each of its entries into a
//    [T NS] table (the exact worst case, so nothing is ever dropped), and
//    zeroes the rows of the partial tables (pvals [T NS, 8] with the view
//    list, psh [T NS, 4] with the shadow list) that its entries own: the
//    gradient kernels skip a gated-out entry's row and never write pvals'
//    column 7, and every row below the counts is read. The last block
//    writes the totals. Nothing past the totals is written or read on the
//    card (the reduction reads entries below the counts only). A scratch
//    of per-block totals tagged with a launch number (the epoch, advanced
//    by the launch's last block to finish) needs no reset between launches,
//    so the launch replays inside a CUDA graph; launches that share a
//    scratch must not overlap (one stream).
//
// Float semantics follow render/broad_phase.py as torch runs it on the card,
// op for op: -fmad=false, IEEE sqrtf and division, acosf / asinf / expf /
// log1pf as torch's CUDA kernels call them, and a division by a Python
// scalar as a multiply by its f32 reciprocal (torch's div_true_kernel_cuda
// does that for a CPU scalar). A three-element `.sum(-1)` is summed as
// torch's CUDA reduction sums it: over a contiguous last dimension (vv) as
// (x0 + x2) + x1, over a strided one (ww, whose [NS, 3] operand is the
// transposed sphere table) as (x0 + x1) + x2, which for NS = 1 is contiguous
// again.
//
// What bounds it: a tile's chain of dependent steps and the rate at which
// the SMs take the tests' instructions. At 3840x2160 with 200 spheres
// (32400 tiles) the tests are 6.5e6 (tile, sphere) cone tests and 5.2e7
// (tile, ball, sphere) occluder tests, some 1.1 GFLOP in broad_phase.py's
// arithmetic (16 us at 67 TFLOP/s). PERF.md section 6 has the split of the
// time by stage (the LIST_CUT variants below) that chose this design, and
// its times.

#include <cuda_fp16.h>
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
// tile_lists_kernel: warps a block, and the blocks an SM its launch bounds ask
// for (measured on an H100, headline / 4K/200 ms: 2 blocks 0.0184 / 0.105 at
// 90 registers, 3 blocks 0.0176 / 0.090 at 80, 4 blocks 0.0185 / 0.091 at 64
// with 12 B of spill stores; PERF.md section 6)
constexpr int LIST_WARPS = 8;
constexpr int LIST_MIN_BLOCKS = 3;
constexpr size_t LIST_SMEM = 227 * 1024;
// shared memory a staged sphere takes: three float4s and its slot in the order
// (its sort key overlays the warps' scratch while the prologue sorts)
constexpr int SPHERE_BYTES = 52;
// a warp's queue of spheres for the exact occluder test (a power of 2)
constexpr int QUEUE = 64;
// the staged flags of a sphere (the third word of its second float4)
constexpr int F_ACT = 1, F_NEAR = 2, F_NEAR40 = 4, F_FIN = 8;
// the occluder test's fast decision needs |d2 - (R + r_keep)^2| above
// KAPPA (ww + vv + (R + r_keep)^2)
constexpr float KAPPA = 0.000244140625f;  // 2^-12
// the view pre-test rules a sphere out where the cosine of its angle lies
// VIEW_MARGIN below cos(cone + max(alpha, alpha40)) (from that angle's
// cosine and sine staged as halves: 2^-11 of error each), for that sum below
// pi - VIEW_GUARD; the occluder pre-test where its distance from the plane
// of the light and the tile's view segment passes R_max + r_keep by
// OCC_REL of its square plus OCC_ABS of (ww + vv_max)
constexpr float VIEW_MARGIN = 0.00390625f;  // 2^-8
constexpr float VIEW_GUARD = 0.0625f;
constexpr float OCC_REL = 0.015625f;        // 2^-6
constexpr float OCC_ABS = 0.00390625f;      // 2^-8
// entry_tables_kernel: tiles (threads) a block, and a list's blocks at most
// (the scratch of per-block totals holds 2 ENTRY_MAX_BLOCKS)
constexpr int ENTRY_THREADS = 256;
constexpr int ENTRY_MAX_BLOCKS = 1024;

}  // namespace

// Timing cuts (a variant built with -D times the kernel cut short):
// LIST_CUT = k stops each tile of tile_lists_kernel after stage k
// (0 the block's prologue alone, 1 the cone, 2 the view test, 3 the sorted
// row, 4 the plane bounds, 5 the balls, 6 the occluder test, 7 the index
// row: the whole kernel);
// LIST_ROWS=0 keeps the rows' values live without storing them. The
// library's build defines neither.
#ifndef LIST_CUT
#define LIST_CUT 7
#endif
#ifndef LIST_ROWS
#define LIST_ROWS 1
#endif

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

// Keeps v live in a timing cut without storing it.
__device__ __forceinline__ void keep(float v) { asm volatile("" ::"f"(v)); }
__device__ __forceinline__ void keep(int v) { asm volatile("" ::"r"(v)); }
__device__ __forceinline__ void put_row(int* row, int i, int v) {
  if (LIST_ROWS) {
    row[i] = v;
  } else {
    keep(i);
    keep(v);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = tmax(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__host__ __device__ __forceinline__ int mask_words(int ns) { return (ns + 31) / 32; }

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// A warp's float4s of shared memory: its balls (two a ball), then the plane
// bounds of its next PLANE_BATCH tiles (one a tile).
constexpr int PLANE_BATCH = 8;
constexpr int WARP_F4 = 2 * NB + PLANE_BATCH;

// The warps' scratch in 4-byte words: each warp's float4s, three masks and
// queue. The prologue's sort keys (round4(ns) of them) overlay it.
__host__ __device__ __forceinline__ int scratch_words(int ns) {
  return LIST_WARPS * (4 * WARP_F4 + 3 * mask_words(ns) + QUEUE);
}

// Dynamic shared memory of a tile_lists block: the staged spheres, the
// warps' scratch, the order and the block's two masks.
__host__ __device__ __forceinline__ size_t list_smem(int ns) {
  return (size_t)SPHERE_BYTES * ns + (size_t)4 * scratch_words(ns) +
         (size_t)4 * 2 * mask_words(ns);
}

// The block's shared memory, carved as list_smem counts it. The masks hold
// a bit a sphere: the block's of the live spheres and of the sortable ones
// (live at a finite distance); a warp's of its tile's view list, of its
// kept occluders, and of the spheres a pre-test leaves to the exact test.
struct Staged {
  float4* a;        // [ns] u0, u1, u2, alpha
  float4* b;        // [ns] alpha40, dist + r, flags (int bits), cos and sin of
                    //      max(alpha, alpha40) as two halves (the view pre-test's)
  float4* c;        // [ns] w0, w1, w2, r_keep
  float4* warp_f4;  // [LIST_WARPS, WARP_F4]  } the warps' scratch
  unsigned* masks;  // [LIST_WARPS, 3 nw]     }
  int* queues;      // [LIST_WARPS, QUEUE]    }
  float* key;       // [round4(ns)] over the scratch: dist of a sortable sphere, else +inf
  int* order;       // [n_sort] the sortable spheres near to far, index order at ties
  unsigned* act;    // [nw]
  unsigned* fin;    // [nw]
};

__device__ __forceinline__ Staged carve(float4* mem, int ns) {
  Staged st;
  const int nw = mask_words(ns);
  st.a = mem;
  st.b = mem + ns;
  st.c = mem + 2 * ns;
  st.warp_f4 = mem + 3 * ns;
  st.masks = reinterpret_cast<unsigned*>(st.warp_f4 + LIST_WARPS * WARP_F4);
  st.queues = reinterpret_cast<int*>(st.masks + 3 * nw * LIST_WARPS);
  st.key = reinterpret_cast<float*>(st.warp_f4);
  st.order = st.queues + QUEUE * LIST_WARPS;
  st.act = reinterpret_cast<unsigned*>(st.order + ns);
  st.fin = st.act + nw;
  return st;
}

// Two floats as halves in one word, and back.
__device__ __forceinline__ float pack_halves(float x, float y) {
  const __half2 h = __floats2half2_rn(x, y);
  return __uint_as_float(*reinterpret_cast<const unsigned*>(&h));
}
__device__ __forceinline__ float2 unpack_halves(float w) {
  const unsigned u = __float_as_uint(w);
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

__device__ __forceinline__ unsigned valid_bits(int s0, int ns) {
  return ns - s0 >= 32 ? FULL : (1u << (ns - s0)) - 1u;
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// A warp's queue of spheres (QUEUE slots of its shared memory) for a
// test's exact form: push() appends the lanes' flagged spheres, and once
// 32 wait, run() hands them to exact(s), a sphere a lane (s = -1 on idle
// lanes: exact runs on every lane); finish() hands over the rest.
struct WarpQueue {
  int* buf;
  int head, n;
  template <class F>
  __device__ __forceinline__ void push(bool flag, int s, F&& exact) {
    const unsigned b = __ballot_sync(FULL, flag);
    if (flag) buf[(head + n + __popc(b & lanes_below())) & (QUEUE - 1)] = s;
    n += __popc(b);
    __syncwarp();
    if (n >= 32) run(32, exact);
  }
  template <class F>
  __device__ __forceinline__ void run(int k, F&& exact) {
    const int s = (int)threadIdx.x < k ? buf[(head + threadIdx.x) & (QUEUE - 1)] : -1;
    __syncwarp();  // every lane holds its sphere before the slots are reused
    head = (head + k) & (QUEUE - 1);
    n -= k;
    exact(s);
  }
  template <class F>
  __device__ __forceinline__ void finish(F&& exact) {
    if (n > 0) run(n, exact);
  }
};

// The block's prologue: every sphere's tile-independent terms, computed as
// broad_phase.py computes them, its flags, and the order of the sortable
// spheres by (dist, index).
__device__ int stage_spheres(const ListParams& p, const float* __restrict__ cam,
                             const float* __restrict__ sph, const Staged& st) {
  const int ns = p.ns, lane = threadIdx.x;
  const int tid = threadIdx.y * 32 + lane, nthreads = blockDim.y * 32;
  const float o[3] = {__ldg(cam + 0), __ldg(cam + 1), __ldg(cam + 2)};
  for (int s0 = threadIdx.y * 32; s0 < ns; s0 += nthreads) {  // warp-uniform rounds
    const int s = s0 + lane;
    bool act = false, fin = false;
    if (s < ns) {
      const float r = __ldg(sph + S_R * ns + s);
      act = __ldg(sph + S_ACTIVE * ns + s) > 0.5f;
      const float cx = __ldg(sph + S_CX * ns + s), cy = __ldg(sph + S_CY * ns + s),
                  cz = __ldg(sph + S_CZ * ns + s);
      const float v0 = cx - o[0], v1 = cy - o[1], v2 = cz - o[2];
      const float dist = norm3(v0, v1, v2);
      const float dcl = tclamp_min(dist, 1e-12f);
      const float r_eff = r * p.r_scale;
      const float alpha = asinf(tclamp(r_eff / dcl, 0.0f, 1.0f));
      const bool near = dist <= r_eff + p.reach;
      const float r_eff40 = r * p.r_scale40;
      const float alpha40 = asinf(tclamp(r_eff40 / dcl, 0.0f, 1.0f));
      const bool near40 = dist <= r_eff40 + p.reach40;
      const float w0 = cx - p.light[0], w1 = cy - p.light[1], w2 = cz - p.light[2];
      const float r_keep = ((r * p.keep_s + r) + p.keep_c) + 0.02f;
      fin = act && dist < INFINITY;
      const int flags = (act ? F_ACT : 0) | (near ? F_NEAR : 0) | (near40 ? F_NEAR40 : 0) |
                        (fin ? F_FIN : 0);
      const float am = fmaxf(alpha, alpha40);
      st.a[s] = make_float4(v0 / dcl, v1 / dcl, v2 / dcl, alpha);
      st.b[s] = make_float4(alpha40, dist + r, __int_as_float(flags),
                            pack_halves(cosf(am), sinf(am)));
      st.c[s] = make_float4(w0, w1, w2, r_keep);
      st.key[s] = fin ? dist : INFINITY;
    }
    const unsigned wa = __ballot_sync(FULL, act), wf = __ballot_sync(FULL, fin);
    if (lane == 0) {
      st.act[s0 >> 5] = wa;
      st.fin[s0 >> 5] = wf;
    }
  }
  for (int s = ns + tid; s < round4(ns); s += nthreads) st.key[s] = INFINITY;
  __syncthreads();
  int n_sort = 0;
  for (int w = 0; w < mask_words(ns); ++w) n_sort += __popc(st.fin[w]);
  const float4* key4 = reinterpret_cast<const float4*>(st.key);
  for (int s0 = 0; s0 < ns; s0 += nthreads) {  // block-uniform rounds: the loads broadcast
    const int s = s0 + tid;
    const bool fin = s < ns && ((st.fin[s >> 5] >> (s & 31)) & 1u);
    const float k = fin ? st.key[s] : -INFINITY;
    // a sortable sphere's rank: the keys below its own, then the equal ones
    // before it (non-sortable keys are +inf, above every sortable one)
    int lt = 0, eq = 0;
#pragma unroll 4
    for (int j = 0; j < round4(ns) / 4; ++j) {
      const float4 q = key4[j];
      lt += (q.x < k) + (q.y < k) + (q.z < k) + (q.w < k);
      eq += (q.x == k) + (q.y == k) + (q.z == k) + (q.w == k);
    }
    if (eq > 1) {  // a tie: count the equal keys before s
      eq = 0;
      for (int j = 0; j < s; ++j) eq += st.key[j] == k;
      lt += eq;
    }
    if (fin) st.order[lt] = s;
  }
  __syncthreads();
  return n_sort;
}

// A row's listed prefix in index order: the spheres whose bit is set in
// mask, after slot 0, their count. The slots past the count are not
// written (no card consumer reads them).
__device__ void index_row(int ns, const unsigned* mask, int* __restrict__ row) {
  const int lane = threadIdx.x;
  int n_in = 0;
  for (int s0 = 0; s0 < ns; s0 += 32) {
    const unsigned word = mask[s0 >> 5] & valid_bits(s0, ns);
    if ((word >> lane) & 1u) put_row(row, 1 + n_in + __popc(word & lanes_below()), s0 + lane);
    n_in += __popc(word);
  }
  if (lane == 0) put_row(row, 0, n_in);
}

// The view row's count and listed prefix: the listed sortable spheres in
// the staged order (n_fin of them); where a listed sphere is not sortable
// (an infinite distance: count > n_fin), the prefix goes on with the other
// spheres in index order, as a stable sort of +inf keys puts them. The
// slots past the count are not written.
__device__ void sorted_row(int ns, int n_sort, int n_fin, int count, const Staged& st,
                           const unsigned* vmask, int* __restrict__ row) {
  const int lane = threadIdx.x;
  int found = 0;
  for (int k0 = 0; found < n_fin && k0 < n_sort; k0 += 32) {
    const int k = k0 + lane;
    const int s = k < n_sort ? st.order[k] : 0;
    const bool f = k < n_sort && ((vmask[s >> 5] >> (s & 31)) & 1u);
    const unsigned b = __ballot_sync(FULL, f);
    if (f) put_row(row, 1 + found + __popc(b & lanes_below()), s);
    found += __popc(b);
  }
  int n_rest = 0;
  for (int s0 = 0; n_fin + n_rest < count && s0 < ns; s0 += 32) {
    const unsigned word = ~(vmask[s0 >> 5] & st.fin[s0 >> 5]) & valid_bits(s0, ns);
    const int pos = n_fin + n_rest + __popc(word & lanes_below());
    if (((word >> lane) & 1u) && pos < count) put_row(row, 1 + pos, s0 + lane);
    n_rest += __popc(word);
  }
  if (lane == 0) put_row(row, 0, count);
}

// The four lanes of a (plane, corner) group: the group's min / max, the
// same on each of the four.
__device__ __forceinline__ float min4(float v) {
  v = tmin(v, __shfl_xor_sync(FULL, v, 1));
  return tmin(v, __shfl_xor_sync(FULL, v, 2));
}
__device__ __forceinline__ float max4(float v) {
  v = tmax(v, __shfl_xor_sync(FULL, v, 1));
  return tmax(v, __shfl_xor_sync(FULL, v, 2));
}

// broad_phase.plane_depth_bounds for PLANE_BATCH tiles of a warp, tile,
// tile + step, ...: lane l takes tile l / 4 of the batch at corner l % 4
// (the corner ray as _tile_cones builds it), and the four lanes of a tile
// go through the live planes in turn; a plane's four softplus penalties
// are its four lanes'. An inactive plane bounds nothing (irrelevant at any
// margin, never covering), so it is skipped. Writes (t_hi_planes, covered,
// planes_sky, 0) of batch tile j to pbatch[j].
__device__ void plane_batch(const ListParams& p, const float* __restrict__ pl,
                            const float* __restrict__ cam, int tile, int step, float4* pbatch) {
  const int lane = threadIdx.x, q = lane & 3;
  const int t = tile + (lane >> 2) * step;
  const int tt = t < p.ti * p.tj ? t : tile;
  const int ti = tt / p.tj, tj = tt - ti * p.tj;
  const float o[3] = {__ldg(cam + 0), __ldg(cam + 1), __ldg(cam + 2)};
  float dr[3];
  {
    const float r_lo = __ldg(cam + C_ROW0) + (float)ti * (float)p.bh;
    const float c_lo = (float)tj * (float)p.bw;
    const float rr = (q >> 1) ? (r_lo + (float)p.bh) - 1.0f : r_lo;
    const float cc = (q & 1) ? (c_lo + (float)p.bw) - 1.0f : c_lo;
    const float vy = (((float)p.height - 2.0f * rr) * p.inv_h) * p.e2;
    const float vx = ((2.0f * cc - (float)p.width) * p.inv_w) * p.e1;
    const float col0[3] = {__ldg(cam + C_RX), __ldg(cam + C_UX), __ldg(cam + C_FX)};
    const float col1[3] = {__ldg(cam + C_RY), __ldg(cam + C_UY), __ldg(cam + C_FY)};
    const float col2[3] = {__ldg(cam + C_RZ), __ldg(cam + C_UZ), __ldg(cam + C_FZ)};
    for (int k = 0; k < 3; ++k) dr[k] = (vx * col0[k] + vy * col1[k]) + col2[k];
  }
  const float dnorm = norm3(dr[0], dr[1], dr[2]);
  const float dmax = max4(dnorm);
  float t_hi_pl = 0.0f;
  bool covered = false, relevant40 = false;
  const int np = p.np;
  for (int k = 0; k < np; ++k) {
    if (!(__ldg(pl + P_ACTIVE * np + k) > 0.5f)) continue;  // warp-uniform
    const float n0 = __ldg(pl + P_NX * np + k), n1 = __ldg(pl + P_NY * np + k),
                n2 = __ldg(pl + P_NZ * np + k);
    const float pc0 = __ldg(pl + P_CX * np + k), pc1 = __ldg(pl + P_CY * np + k),
                pc2 = __ldg(pl + P_CZ * np + k);
    const float hw = __ldg(pl + P_HW * np + k), hh = __ldg(pl + P_HH * np + k);
    const float num = ((pc0 - o[0]) * n0 + (pc1 - o[1]) * n1) + (pc2 - o[2]) * n2;
    const float dn = (dr[0] * n0 + dr[1] * n1) + dr[2] * n2;
    const float dn_u = dn / dnorm;
    const float safe = fabsf(dn) < 1e-12f ? -1e-12f : dn;
    const float t_raw = num / safe;
    const float t_norm = t_raw * dnorm;
    const float ex = (o[0] + dr[0] * t_raw) - pc0;
    const float ez = (o[2] + dr[2] * t_raw) - pc2;
    // the predicates' all-of-four over the corners: one AND of their bits
    // across the tile's four lanes
    auto bits_at = [&](float m, int at) {
      const float xm = hw + m, zm = hh + m;
      return ((unsigned)(dn_u >= m) | (unsigned)(t_norm <= -m) << 1 |
              (unsigned)(ex >= xm) << 2 | (unsigned)(ex <= -xm) << 3 |
              (unsigned)(ez >= zm) << 4 | (unsigned)(ez <= -zm) << 5) << at;
    };
    unsigned bits = (unsigned)(dn_u <= -1e-3f) | (unsigned)(dn_u >= 1e-3f) << 1 |
                    (unsigned)(t_norm >= 0.0f && t_norm <= p.far) << 2 | bits_at(p.sub, 3) |
                    bits_at(p.sky_m, 9);
    bits &= __shfl_xor_sync(FULL, bits, 1);
    bits &= __shfl_xor_sync(FULL, bits, 2);
    const bool front_all = bits & 1u;
    const bool sign_ok = front_all || (bits & 2u);
    const bool t_in = sign_ok && (bits & 4u);
    auto irrelevant = [&](int at) {  // the plane is live here
      const unsigned m = bits >> at;
      const bool oob = front_all && t_in && (m & 0x3cu);  // ex or ez out of range
      return (m & 1u) || (sign_ok && (m & 2u)) || oob;
    };
    const float t_lo = min4(t_raw);
    const float t_max = tclamp(max4(t_raw) * dmax, 0.0f, p.far);
    const float ndn = min4(-dn);
    const float axm = max4(fabsf(ex)), azm = max4(fabsf(ez));
    // lane q of the tile takes penalty q + 1 of the four
    const float x = q == 0 ? ndn / dmax - p.flt_eps
                  : q == 1 ? tmin(t_lo, t_lo * dmax)
                  : q == 2 ? hw - axm : hh - azm;
    const float pen = logaddexp(p.neg_k * x, 0.0f) * p.inv_k;
    const int g = lane & 28;
    const float pen_total = p.mp * (((__shfl_sync(FULL, pen, g) + __shfl_sync(FULL, pen, g + 1)) +
                                      __shfl_sync(FULL, pen, g + 2)) + __shfl_sync(FULL, pen, g + 3));
    // amax over the planes: 0 below every bound (each is 0, far or a clamp to [0, far])
    const float th = irrelevant(3) ? 0.0f : ((front_all && t_in) ? t_max : p.far);
    t_hi_pl = tmax(t_hi_pl, th);
    covered = covered || (front_all && t_in && (t_max + pen_total <= p.cover_lim));
    relevant40 = relevant40 || !irrelevant(9);
  }
  if (q == 0 && t < p.ti * p.tj)
    pbatch[lane >> 2] = make_float4(t_hi_pl, covered ? 1.0f : 0.0f, relevant40 ? 0.0f : 1.0f, 0.0f);
}

template <bool SHADOWS>
__global__ void __launch_bounds__(LIST_WARPS * 32, LIST_MIN_BLOCKS)
tile_lists_kernel(ListParams p, const float* __restrict__ cam, const float* __restrict__ sph,
                  const float* __restrict__ pl, int* __restrict__ lists,
                  float* __restrict__ t_hi_out, uint8_t* __restrict__ sky_out,
                  int* __restrict__ shl) {
  extern __shared__ float4 s_mem[];
  const int ns = p.ns, lane = threadIdx.x, n_tiles = p.ti * p.tj;
  const Staged st = carve(s_mem, ns);
  const int n_sort = stage_spheres(p, cam, sph, st);
  if (LIST_CUT == 0) {
    keep(n_sort);
    return;
  }
  const int nw = mask_words(ns);
  unsigned* vmask = st.masks + (size_t)threadIdx.y * 3 * nw;
  unsigned* smask = vmask + nw;
  unsigned* mmask = smask + nw;  // the spheres left to the exact test
  float4* balls = st.warp_f4 + threadIdx.y * WARP_F4;
  float4* pbatch = balls + 2 * NB;  // t_hi_planes, covered, planes_sky of a batch's tiles
  const int step = gridDim.x * blockDim.y;
  const size_t stride = (size_t)ns + 1;
  const float o[3] = {__ldg(cam + 0), __ldg(cam + 1), __ldg(cam + 2)};
  const float col0[3] = {__ldg(cam + C_RX), __ldg(cam + C_UX), __ldg(cam + C_FX)};
  const float col1[3] = {__ldg(cam + C_RY), __ldg(cam + C_UY), __ldg(cam + C_FY)};
  const float col2[3] = {__ldg(cam + C_RZ), __ldg(cam + C_UZ), __ldg(cam + C_FZ)};
  const float row0 = __ldg(cam + C_ROW0);

  int it = 0;  // the warp's tiles so far
  for (int tile = blockIdx.x * blockDim.y + threadIdx.y; tile < n_tiles; tile += step, ++it) {
    __syncwarp();  // the warp's masks and balls are free again
    if (SHADOWS && !p.disable && LIST_CUT >= 4 && it % PLANE_BATCH == 0) {
      plane_batch(p, pl, cam, tile, step, pbatch);
      __syncwarp();  // pbatch
    }
    int* row = lists + (size_t)tile * stride;
    if (p.disable) {  // _compact_lists(active): index order, no aux
      index_row(ns, st.act, row);
      if (SHADOWS) index_row(ns, st.act, shl + (size_t)tile * stride);
      continue;
    }
    const int ti = tile / p.tj, tj = tile - ti * p.tj;

    // -- the cone (broad_phase._tile_cones): lane l builds corner q = l & 3
    const int q = lane & 3;
    const float r_lo = row0 + (float)ti * (float)p.bh;
    const float c_lo = (float)tj * (float)p.bw;
    const float rr = (q >> 1) ? (r_lo + (float)p.bh) - 1.0f : r_lo;
    const float cc = (q & 1) ? (c_lo + (float)p.bw) - 1.0f : c_lo;
    const float vy = (((float)p.height - 2.0f * rr) * p.inv_h) * p.e2;
    const float vx = ((2.0f * cc - (float)p.width) * p.inv_w) * p.e1;
    float dr[3], d[3];
    for (int k = 0; k < 3; ++k) dr[k] = (vx * col0[k] + vy * col1[k]) + col2[k];
    const float dnorm = norm3(dr[0], dr[1], dr[2]);
    for (int k = 0; k < 3; ++k) d[k] = dr[k] / dnorm;
    float axis[3];
    {
      float a[3];
      for (int k = 0; k < 3; ++k)
        a[k] = ((__shfl_sync(FULL, d[k], 0) + __shfl_sync(FULL, d[k], 1)) +
                __shfl_sync(FULL, d[k], 2)) + __shfl_sync(FULL, d[k], 3);
      const float an = norm3(a[0], a[1], a[2]);
      for (int k = 0; k < 3; ++k) axis[k] = a[k] / an;
    }
    const float cq = (axis[0] * d[0] + axis[1] * d[1]) + axis[2] * d[2];
    const float cmin = tmin(tmin(tmin(__shfl_sync(FULL, cq, 0), __shfl_sync(FULL, cq, 1)),
                                 __shfl_sync(FULL, cq, 2)), __shfl_sync(FULL, cq, 3));
    const float cos_cone = tclamp(cmin, -1.0f, 1.0f);
    const float cone_ang = acosf(cos_cone);
    if (LIST_CUT == 1) {
      keep(cone_ang);
      keep(dr[0] + axis[q % 3]);
      continue;
    }

    // -- the view list (broad_phase.sphere_tile_lists). A pre-test settles the
    // spheres the near tests admit and those far outside the cone; the rest
    // take the exact test (acosf)
    float t_hi = 0.0f;
    int cnt = 0, n40 = 0, n_fin = 0;
    auto admit = [&](int s, bool incl, bool incl40, float tv) {  // every lane
      const unsigned wi = __ballot_sync(FULL, incl);
      if (incl) atomicOr(vmask + (s >> 5), 1u << (s & 31));
      cnt += __popc(wi);
      n40 += __popc(__ballot_sync(FULL, incl40));
      n_fin += __popc(__ballot_sync(FULL, incl && ((st.fin[s >> 5] >> (s & 31)) & 1u)));
      t_hi = tmax(t_hi, incl ? tv : 0.0f);
    };
    const float ax0 = axis[0], ax1 = axis[1], ax2 = axis[2];
    auto exact_view = [&, ax0, ax1, ax2, cone_ang](int s) {
      bool incl = false, incl40 = false;
      float tv = 0.0f;
      if (s >= 0) {
        const float4 a = st.a[s], b = st.b[s];
        const int flags = __float_as_int(b.z);
        const bool act = flags & F_ACT;
        const float cosang = (ax0 * a.x + ax1 * a.y) + ax2 * a.z;
        const float ang = acosf(tclamp(cosang, -1.0f, 1.0f));
        incl = ((ang <= cone_ang + a.w) || (flags & F_NEAR)) && act;
        incl40 = ((ang <= cone_ang + b.x) || (flags & F_NEAR40)) && act;
        tv = b.y;
      }
      admit(s, incl, incl40, tv);
    };
    const float sin_cone = sinf(cone_ang);
#pragma unroll 2
    for (int s0 = 0; s0 < ns; s0 += 32) {  // no barrier in the rounds: they overlap
      const int s = s0 + lane, sc = s < ns ? s : 0;
      const float4 a = st.a[sc], b = st.b[sc];
      const float2 d = unpack_halves(b.w);
      const int flags = s < ns ? __float_as_int(b.z) : 0;
      const bool act = flags & F_ACT;
      const bool in = act && (flags & F_NEAR) && (flags & F_NEAR40);
      t_hi = tmax(t_hi, in ? b.y : 0.0f);
      const float am = fmaxf(a.w, b.x);
      const float cosa = __fmaf_rn(ax2, a.z, __fmaf_rn(ax1, a.y, ax0 * a.x));
      const float c_th = __fmaf_rn(cos_cone, d.x, -sin_cone * d.y);
      const bool out = (flags & (F_NEAR | F_NEAR40)) == 0 &&
                       cone_ang + am < 3.14159265f - VIEW_GUARD && cosa < c_th - VIEW_MARGIN;
      const bool maybe = act && !in && !out;
      const unsigned wi = __ballot_sync(FULL, in), wm = __ballot_sync(FULL, maybe);
      if (lane == 0) {
        vmask[s0 >> 5] = wi;
        mmask[s0 >> 5] = wm;
      }
      cnt += __popc(wi);
      n40 += __popc(wi);
      n_fin += __popc(wi & st.fin[s0 >> 5]);
    }
    __syncwarp();  // vmask, mmask
    for (int s0 = 0; s0 < ns; s0 += 32) {  // the exact test, a mask word at a time
      const unsigned word = mmask[s0 >> 5];
      if (word != 0u) exact_view((word >> lane) & 1u ? s0 + lane : -1);
    }
    // the max over the spheres: lanes past the last sphere hold 0, below every value
    const float t_hi_sph = warp_max(t_hi);
    const bool sky_sph = n40 == 0;
    if (lane == 0) {
      t_hi_out[tile] = t_hi_sph;
      sky_out[tile] = sky_sph ? 1 : 0;
    }
    __syncwarp();  // vmask
    if (LIST_CUT == 2) {
      keep(cnt + n_fin);
      continue;
    }
    sorted_row(ns, n_sort, n_fin, cnt, st, vmask, row);
    if (!SHADOWS || LIST_CUT == 3) continue;

    // -- the plane depth bounds (broad_phase.plane_depth_bounds), from the
    // warp's batch
    const float4 pb = pbatch[it % PLANE_BATCH];
    const float t_hi_planes = pb.x;
    const bool any_covered = pb.y != 0.0f;
    const bool planes_sky = pb.z != 0.0f;
    float t_cap = any_covered ? tmax(t_hi_sph, t_hi_planes) + 1.0f : p.far;
    t_cap = tclamp(t_cap, 1.0f, p.far);
    const bool skip = sky_sph && planes_sky;
    if (LIST_CUT == 4) {
      keep(t_cap);
      keep(skip ? 1 : 0);
      continue;
    }

    // -- the balls of the truncated view cone: lane b < NB stages ball b
    const float half = t_cap * 0.0625f;  // t_cap / (2 NB)
    if (lane < NB) {
      const float tan_cone =
          sqrtf(tclamp_min(1.0f - cos_cone * cos_cone, 0.0f)) / tclamp_min(cos_cone, 0.05f);
      const float t_mid = ((float)lane * 2.0f + 1.0f) * half;
      const float t_sl = t_mid + half;
      float vb[3];
      for (int k = 0; k < 3; ++k) vb[k] = (o[k] + axis[k] * t_mid) - p.light[k];
      const float vv = (vb[0] * vb[0] + vb[2] * vb[2]) + vb[1] * vb[1];
      const float a = t_sl * tan_cone;
      balls[2 * lane] = make_float4(vb[0], vb[1], vb[2], vv);
      balls[2 * lane + 1] =
          make_float4(sqrtf(half * half + a * a), __frcp_rn(tclamp_min(vv, 1e-12f)), 0.0f, 0.0f);
    }
    __syncwarp();  // balls
    if (LIST_CUT == 5) {
      keep(balls[lane & 15].x);
      continue;
    }

    // -- the occluder test (broad_phase.shadow_tile_lists). A pre-test rules
    // out the spheres far from the plane of the light and the tile's view
    // segment, which holds every ball's segment; the rest take the test
    // against the balls
    for (int w = lane; w < nw; w += 32) smask[w] = 0u;
    float r_max = 0.0f, vv_max = 0.0f;
    for (int j = 0; j < NB; ++j) {
      r_max = fmaxf(r_max, balls[2 * j + 1].x);
      vv_max = fmaxf(vv_max, balls[2 * j].w);
    }
    float pn[3];
    bool cull = false;
    {
      const float4 a = balls[0], b = balls[2 * (NB - 1)];
      pn[0] = a.y * b.z - a.z * b.y;
      pn[1] = a.z * b.x - a.x * b.z;
      pn[2] = a.x * b.y - a.y * b.x;
      const float nn = (pn[0] * pn[0] + pn[1] * pn[1]) + pn[2] * pn[2];
      // far from parallel (else no pre-test): the plane's normal is good to 2^-10
      cull = nn > 9.5367431640625e-7f * (a.w * b.w);  // 2^-20
      const float inv = rsqrtf(nn);
      for (int k = 0; k < 3; ++k) pn[k] *= inv;
    }
    __syncwarp();  // smask
    // the test against the balls, a sphere a lane, of the spheres the
    // pre-test leaves (gathered 32 at a time in the warp's queue)
    auto exact_occ = [&](int s) {
      bool kept = false;
      if (s >= 0) {
        const float4 c = st.c[s];
        const float r_keep = c.w;
        const float ww = p.ns == 1 ? (c.x * c.x + c.z * c.z) + c.y * c.y
                                   : (c.x * c.x + c.y * c.y) + c.z * c.z;
        for (int j = 0; j < NB && !kept; ++j) {
          const float4 v = balls[2 * j], rb = balls[2 * j + 1];
          const float R = rb.x;
          // the fast decision: d2 within some 20 rounding steps of the magnitudes
          const float wva = __fmaf_rn(v.z, c.z, __fmaf_rn(v.y, c.y, v.x * c.x));
          const float ta = __saturatef(wva * rb.y);
          const float d2a = __fmaf_rn(ta, __fmaf_rn(ta, v.w, -2.0f * wva), ww);
          const float rk = R + r_keep;
          const float s2 = rk * rk;
          const float margin = KAPPA * ((ww + v.w) + s2);
          const float diff = d2a - s2;
          kept = diff < -margin;
          if (!kept && !(diff > margin)) {  // near the threshold (or NaN): the exact test
            const float wv = (v.x * c.x + v.y * c.y) + v.z * c.z;
            const float t = tclamp(wv / tclamp_min(v.w, 1e-12f), 0.0f, 1.0f);
            const float d2 = (ww - (2.0f * t) * wv) + (t * t) * v.w;
            kept = sqrtf(tclamp_min(d2, 0.0f)) - R <= r_keep;
          }
        }
      }
      if (kept) atomicOr(smask + (s >> 5), 1u << (s & 31));
    };
    if (!skip) {
#pragma unroll 2
      for (int s0 = 0; s0 < ns; s0 += 32) {  // no barrier in the rounds: they overlap
        const int s = s0 + lane, sc = s < ns ? s : 0;
        const float4 b = st.b[sc], c = st.c[sc];
        const bool act = s < ns && (__float_as_int(b.z) & F_ACT);
        const float pd = __fmaf_rn(pn[2], c.z, __fmaf_rn(pn[1], c.y, pn[0] * c.x));
        const float ww = __fmaf_rn(c.z, c.z, __fmaf_rn(c.y, c.y, c.x * c.x));
        const float bound = r_max + c.w;
        const bool maybe = act && !(cull && pd * pd > __fmaf_rn(bound * bound, 1.0f + OCC_REL,
                                                                  OCC_ABS * (ww + vv_max)));
        const unsigned wm = __ballot_sync(FULL, maybe);
        if (lane == 0) mmask[s0 >> 5] = wm;
      }
      __syncwarp();  // mmask
      WarpQueue queue{st.queues + threadIdx.y * QUEUE, 0, 0};
      for (int s0 = 0; s0 < ns; s0 += 32) {
        const unsigned word = mmask[s0 >> 5];
        if (word != 0u) queue.push((word >> lane) & 1u, s0 + lane, exact_occ);
      }
      queue.finish(exact_occ);
    }
    __syncwarp();  // smask
    if (LIST_CUT == 6) continue;
    index_row(ns, smask, shl + (size_t)tile * stride);
  }
}

__global__ void __launch_bounds__(ENTRY_THREADS)
entry_tables_kernel(EntryParams e, const int* __restrict__ lists0, const int* __restrict__ lists1,
                    int* __restrict__ offsets, int* __restrict__ pidx, int* __restrict__ counts,
                    float4* __restrict__ pvals, float4* __restrict__ psh,
                    unsigned long long* status, unsigned* ctl) {
  __shared__ int s_incl[ENTRY_THREADS];  // inclusive sums of the block's counts
  __shared__ int s_warp[ENTRY_THREADS / 32];
  __shared__ int s_base;
  __shared__ unsigned s_epoch;
  const int T = e.n_tiles, ns = e.ns, L = blockIdx.y, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* lists = L ? lists1 : lists0;
  if (tid == 0) s_epoch = *reinterpret_cast<volatile unsigned*>(ctl);
  const int t = b * ENTRY_THREADS + tid;
  const int cnt = t < T ? __ldg(lists + (size_t)t * (ns + 1)) : 0;
  int x = cnt;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < ENTRY_THREADS / 32 ? s_warp[lane] : 0;
    for (int off = 1; off < ENTRY_THREADS / 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w += y;
    }
    if (lane < ENTRY_THREADS / 32) s_warp[lane] = w;
  }
  __syncthreads();
  const int incl = x + (warp ? s_warp[warp - 1] : 0);
  const int agg = s_warp[ENTRY_THREADS / 32 - 1];
  s_incl[tid] = incl;
  // publish this block's total, tagged with the launch, then add those
  // of the blocks before it
  const unsigned long long tag = (unsigned long long)(s_epoch + 1u) << 32;
  volatile unsigned long long* st = status + (size_t)L * ENTRY_MAX_BLOCKS;
  if (tid == 0) st[b] = tag | (unsigned)agg;
  if (warp == 0) {
    int base = 0;
    for (int j0 = 0; j0 < b; j0 += 32) {
      const int j = j0 + lane;
      unsigned long long w = tag;
      if (j < b) {
        do {
          w = st[j];
        } while ((w & 0xffffffff00000000ull) != tag);
      }
      int v = j < b ? (int)(unsigned)w : 0;
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
      base += v;
    }
    if (lane == 0) s_base = base;
  }
  __syncthreads();
  const int base = s_base;
  if (t < T) offsets[(size_t)L * T + t] = base + incl - cnt;
  int* tab = pidx + (size_t)L * T * ns + base;
  const int* first = lists + (size_t)b * ENTRY_THREADS * (ns + 1);
  // entry i belongs to tile k, the first with s_incl[k] > i (the number of
  // inclusive sums <= i, in a fixed-step search), at slot i - s_incl[k - 1];
  // four entries' loads in flight a thread
#pragma unroll 4
  for (int i = tid; i < agg; i += ENTRY_THREADS) {
    int k = 0;
#pragma unroll
    for (int step = ENTRY_THREADS / 2; step > 0; step >>= 1)
      if (s_incl[k + step - 1] <= i) k += step;
    const int excl = k ? s_incl[k - 1] : 0;
    tab[i] = __ldg(first + (size_t)k * (ns + 1) + 1 + (i - excl));
  }
  float4* rows = L ? psh : pvals;  // [T NS, 8] or [T NS, 4] f32: 2 or 1 float4 a row
  if (rows != nullptr) {
    const int per = L ? 1 : 2;
    float4* dst = rows + (size_t)base * per;
    for (int i = tid; i < agg * per; i += ENTRY_THREADS) dst[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (b == (int)gridDim.x - 1 && tid == 0) {
    counts[L] = base + agg;
    if (e.n_lists == 1) counts[1] = 0;
  }
  __syncthreads();  // this block has read every total it needs
  if (tid == 0) {
    __threadfence();
    const unsigned done = atomicAdd(ctl + 1, 1u);
    if (done == gridDim.x * gridDim.y - 1) {  // the last block: the next launch's epoch
      ctl[1] = 0u;
      __threadfence();
      atomicExch(ctl, s_epoch + 1u);
    }
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
  const size_t smem = list_smem(p.ns);
  if (smem > LIST_SMEM || scratch_words(p.ns) < round4(p.ns)) return (int)cudaErrorInvalidValue;
  const int n_tiles = p.ti * p.tj;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, p.device)))
    return (int)err;
  const dim3 block(32, LIST_WARPS);
  const auto launch = [&](auto kernel) -> cudaError_t {
    cudaError_t e;
    if (smem > 48 * 1024 &&
        (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, LIST_WARPS * 32, smem)))
      return e;
    const int want = (n_tiles + LIST_WARPS - 1) / LIST_WARPS;
    const int fit = sms * (per_sm > 0 ? per_sm : 1);
    const int blocks = want < fit ? want : fit;
    kernel<<<blocks > 0 ? blocks : 1, block, smem, (cudaStream_t)stream>>>(p, cam, sph, pl, lists,
                                                                          t_hi, sky, shl);
    return cudaGetLastError();
  };
  return (int)(shl != nullptr ? launch(tile_lists_kernel<true>) : launch(tile_lists_kernel<false>));
}

extern "C" int rtwc_entry_tables(const int* lists, const int* shl, int* offsets, int* pidx,
                                 int* counts, float* pvals, float* psh, void* scratch,
                                 const EntryParams* params, void* stream) {
  const EntryParams e = *params;
  cudaError_t err = cudaSetDevice(e.device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (e.n_tiles + ENTRY_THREADS - 1) / ENTRY_THREADS;
  if (blocks < 1 || blocks > ENTRY_MAX_BLOCKS) return (int)cudaErrorInvalidValue;
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  unsigned* ctl = reinterpret_cast<unsigned*>(status + 2 * ENTRY_MAX_BLOCKS);
  entry_tables_kernel<<<dim3(blocks, e.n_lists), ENTRY_THREADS, 0, (cudaStream_t)stream>>>(
      e, lists, shl, offsets, pidx, counts, reinterpret_cast<float4*>(pvals),
      reinterpret_cast<float4*>(psh), status, ctl);
  return (int)cudaGetLastError();
}
