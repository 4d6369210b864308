// The console frame's heads on the card (sm_90a): the supersampled planes of
// K7 straight to the cells the ANSI encoder takes, in one pass.
//
// Replaces no Pallas kernel: the JAX package's box filter and mode heads
// are XLA ops (rtwc_tpu/render/reference.py downsample_framebuffer,
// rtwc_tpu/heads/modes.py, rtwc_tpu/heads/ansi256.py), and so were the
// port's, as some thirty torch kernels a frame (a mean over strided views of
// all six fields, the hit-mask products, the quantiser's int64 arithmetic,
// gathers and a stack). This kernel computes the same cells from K7's padded
// planar output [8, Hp, Wp] f32 (planes r, g, b, depth, nx, ny, nz, shading:
// render/hard_kernel.py O_*). The wrapper and its plain version, which is
// that chain of torch ops itself, are in heads/device_heads.py.
//
// Contract, op for op with downsample_framebuffer then framebuffer_to_cells
// as torch runs them on the card: a subpixel hits where depth <= far; at
// ss > 1 each field is multiplied by the hit mask and its ss x ss subpixels
// summed in the order of torch's CUDA mean (`torch_sum`: for 2x2, (top left
// + bottom left) + (top right + bottom right)), then scaled by torch's
// factor (outputs / inputs, in float); hitf is the hit fraction, a cell hits
// where hitf >= 0.5 and is visible where hitf > 0; depth is the mean over
// hits (sum / max(hitf, 1 / ss^2), MISS where hitf is 0); the normals are
// renormalised (safe_normalize: (x^2 + z^2) + y^2, torch's order for a sum
// of three, clamped at 1e-20, rsqrtf). At ss = 1 the subpixel is the cell.
// Then the mode's head: colours clamped to [0, 255] and truncated; the
// ANSI-256 quantiser (ansi256_from_rgb: exact greys from the grey LUT, else
// the nearer by the red-mean distance of the grey LUT's pick for the
// luminance and the 6x6x6 cube's, the cube only where strictly nearer);
// the ASCII glyph ramp[clamp(ceil(s * 67), 1, 67)], ramp[0] where depth >
// far, a space where the cell misses. The sums, the scale and the division
// are single float32 operations: the file is built with -fmad=false, so
// no multiply-add is contracted.
//
// Design. One thread a cell, a block of HEADS_THREADS cells along a row:
// neighbouring threads take neighbouring cells, so at ss = 2 a warp reads 2
// x 64 consecutive floats of each plane it needs as float2 loads, 256 bytes
// a row and plane. A thread reads only its mode's planes, once, and writes
// its cell's three outputs; nothing is written between the planes and the
// cells. The tables (palette, grey LUT, cube levels and thresholds, the
// ramp) are in constant memory. Other ss take a general path of scalar loads
// in the same summation order.
//
// What bounds it: bytes. Per cell it reads ss^2 subpixels of 4 planes (the
// pixel modes: r, g, b, depth; the normals: nx, ny, nz, depth) or 5 (the
// ASCII modes: and shading), 4 B each, and writes kind, colour and glyph as
// int32 (the colour three of them in the truecolor modes). At 1920x500 cells
// and ss = 2: bit_pixel 61.44 MB read + 11.52 MB written (21.8 us at 3.35
// TB/s); rgb_pixel and rgb_normals 61.44 + 19.20 MB (24.1 us); bit_ascii
// 76.80 + 11.52 MB (26.4 us); rgb_ascii 76.80 + 19.20 MB (28.7 us). The
// quantiser is some hundred integer operations a cell, far below the card's
// rate; its table reads are per-thread indices into constant memory.

#include <cuda_runtime.h>
#include <stdint.h>

// Mirror of `class HeadsParams` in heads/device_heads.py.
struct HeadsParams {
  int h, w;          // the cells
  int ss;            // subpixels a cell along each side
  int hp, wp;        // the planes' padded extent
  int mode;          // BIT_ASCII .. RGB_NORMALS
  int device;
  float far;         // a subpixel hits where depth <= far
  float factor1;     // torch's mean scale of a one-plane pool: (h w) / (H W) in float
  float factor3;     // of a three-plane pool: (3 h w) / (3 H W)
  float min_denom;   // 1 / ss^2 in float: the depth mean's least divisor
};

namespace {

constexpr int O_R = 0, O_G = 1, O_B = 2, O_DEPTH = 3, O_NX = 4, O_NY = 5, O_NZ = 6,
              O_SHADING = 7;
constexpr int BIT_ASCII = 0, BIT_PIXEL = 1, RGB_ASCII = 2, RGB_PIXEL = 3, RGB_NORMALS = 4;
constexpr float MISS = 99999999.0f;  // == 1e8 in f32 (render/reference.py MISS_DISTANCE)
constexpr int HEADS_THREADS = 128;
constexpr int MAX_SS = 8;            // the general path's largest ss
constexpr int NUM_ASCII = 68;
constexpr int SPACE = 32;

// The xterm palette as 0xRRGGBB (heads/ansi256.py ANSI_PALETTE).
__constant__ unsigned int PALETTE[256] = {
    0x000000, 0xCD0000, 0x00CD00, 0xCDCD00, 0x0000EE, 0xCD00CD, 0x00CDCD, 0xE5E5E5,
    0x7F7F7F, 0xFF0000, 0x00FF00, 0xFFFF00, 0x5C5CFF, 0xFF00FF, 0x00FFFF, 0xFFFFFF,
    0x000000, 0x00005F, 0x000087, 0x0000AF, 0x0000D7, 0x0000FF, 0x005F00, 0x005F5F,
    0x005F87, 0x005FAF, 0x005FD7, 0x005FFF, 0x008700, 0x00875F, 0x008787, 0x0087AF,
    0x0087D7, 0x0087FF, 0x00AF00, 0x00AF5F, 0x00AF87, 0x00AFAF, 0x00AFD7, 0x00AFFF,
    0x00D700, 0x00D75F, 0x00D787, 0x00D7AF, 0x00D7D7, 0x00D7FF, 0x00FF00, 0x00FF5F,
    0x00FF87, 0x00FFAF, 0x00FFD7, 0x00FFFF, 0x5F0000, 0x5F005F, 0x5F0087, 0x5F00AF,
    0x5F00D7, 0x5F00FF, 0x5F5F00, 0x5F5F5F, 0x5F5F87, 0x5F5FAF, 0x5F5FD7, 0x5F5FFF,
    0x5F8700, 0x5F875F, 0x5F8787, 0x5F87AF, 0x5F87D7, 0x5F87FF, 0x5FAF00, 0x5FAF5F,
    0x5FAF87, 0x5FAFAF, 0x5FAFD7, 0x5FAFFF, 0x5FD700, 0x5FD75F, 0x5FD787, 0x5FD7AF,
    0x5FD7D7, 0x5FD7FF, 0x5FFF00, 0x5FFF5F, 0x5FFF87, 0x5FFFAF, 0x5FFFD7, 0x5FFFFF,
    0x870000, 0x87005F, 0x870087, 0x8700AF, 0x8700D7, 0x8700FF, 0x875F00, 0x875F5F,
    0x875F87, 0x875FAF, 0x875FD7, 0x875FFF, 0x878700, 0x87875F, 0x878787, 0x8787AF,
    0x8787D7, 0x8787FF, 0x87AF00, 0x87AF5F, 0x87AF87, 0x87AFAF, 0x87AFD7, 0x87AFFF,
    0x87D700, 0x87D75F, 0x87D787, 0x87D7AF, 0x87D7D7, 0x87D7FF, 0x87FF00, 0x87FF5F,
    0x87FF87, 0x87FFAF, 0x87FFD7, 0x87FFFF, 0xAF0000, 0xAF005F, 0xAF0087, 0xAF00AF,
    0xAF00D7, 0xAF00FF, 0xAF5F00, 0xAF5F5F, 0xAF5F87, 0xAF5FAF, 0xAF5FD7, 0xAF5FFF,
    0xAF8700, 0xAF875F, 0xAF8787, 0xAF87AF, 0xAF87D7, 0xAF87FF, 0xAFAF00, 0xAFAF5F,
    0xAFAF87, 0xAFAFAF, 0xAFAFD7, 0xAFAFFF, 0xAFD700, 0xAFD75F, 0xAFD787, 0xAFD7AF,
    0xAFD7D7, 0xAFD7FF, 0xAFFF00, 0xAFFF5F, 0xAFFF87, 0xAFFFAF, 0xAFFFD7, 0xAFFFFF,
    0xD70000, 0xD7005F, 0xD70087, 0xD700AF, 0xD700D7, 0xD700FF, 0xD75F00, 0xD75F5F,
    0xD75F87, 0xD75FAF, 0xD75FD7, 0xD75FFF, 0xD78700, 0xD7875F, 0xD78787, 0xD787AF,
    0xD787D7, 0xD787FF, 0xD7AF00, 0xD7AF5F, 0xD7AF87, 0xD7AFAF, 0xD7AFD7, 0xD7AFFF,
    0xD7D700, 0xD7D75F, 0xD7D787, 0xD7D7AF, 0xD7D7D7, 0xD7D7FF, 0xD7FF00, 0xD7FF5F,
    0xD7FF87, 0xD7FFAF, 0xD7FFD7, 0xD7FFFF, 0xFF0000, 0xFF005F, 0xFF0087, 0xFF00AF,
    0xFF00D7, 0xFF00FF, 0xFF5F00, 0xFF5F5F, 0xFF5F87, 0xFF5FAF, 0xFF5FD7, 0xFF5FFF,
    0xFF8700, 0xFF875F, 0xFF8787, 0xFF87AF, 0xFF87D7, 0xFF87FF, 0xFFAF00, 0xFFAF5F,
    0xFFAF87, 0xFFAFAF, 0xFFAFD7, 0xFFAFFF, 0xFFD700, 0xFFD75F, 0xFFD787, 0xFFD7AF,
    0xFFD7D7, 0xFFD7FF, 0xFFFF00, 0xFFFF5F, 0xFFFF87, 0xFFFFAF, 0xFFFFD7, 0xFFFFFF,
    0x080808, 0x121212, 0x1C1C1C, 0x262626, 0x303030, 0x3A3A3A, 0x444444, 0x4E4E4E,
    0x585858, 0x626262, 0x6C6C6C, 0x767676, 0x808080, 0x8A8A8A, 0x949494, 0x9E9E9E,
    0xA8A8A8, 0xB2B2B2, 0xBCBCBC, 0xC6C6C6, 0xD0D0D0, 0xDADADA, 0xE4E4E4, 0xEEEEEE,
};

// ansi256_from_grey (heads/ansi256.py GREY_LUT).
__constant__ unsigned char GREY_LUT[256] = {
    16,  16,  16,  16,  16,  232, 232, 232, 232, 232, 232, 232, 232, 232, 233, 233,
    233, 233, 233, 233, 233, 233, 233, 233, 234, 234, 234, 234, 234, 234, 234, 234,
    234, 234, 235, 235, 235, 235, 235, 235, 235, 235, 235, 235, 236, 236, 236, 236,
    236, 236, 236, 236, 236, 236, 237, 237, 237, 237, 237, 237, 237, 237, 237, 237,
    238, 238, 238, 238, 238, 238, 238, 238, 238, 238, 239, 239, 239, 239, 239, 239,
    239, 239, 239, 239, 240, 240, 240, 240, 240, 240, 240, 240, 59,  59,  59,  59,
    59,  241, 241, 241, 241, 241, 241, 241, 242, 242, 242, 242, 242, 242, 242, 242,
    242, 242, 243, 243, 243, 243, 243, 243, 243, 243, 243, 244, 244, 244, 244, 244,
    244, 244, 244, 244, 102, 102, 102, 102, 102, 245, 245, 245, 245, 245, 245, 246,
    246, 246, 246, 246, 246, 246, 246, 246, 246, 247, 247, 247, 247, 247, 247, 247,
    247, 247, 247, 248, 248, 248, 248, 248, 248, 248, 248, 248, 145, 145, 145, 145,
    145, 249, 249, 249, 249, 249, 249, 250, 250, 250, 250, 250, 250, 250, 250, 250,
    250, 251, 251, 251, 251, 251, 251, 251, 251, 251, 251, 252, 252, 252, 252, 252,
    252, 252, 252, 252, 188, 188, 188, 188, 188, 253, 253, 253, 253, 253, 253, 254,
    254, 254, 254, 254, 254, 254, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 231, 231, 231, 231, 231, 231, 231, 231, 231,
};

// The cube's levels and each channel's thresholds (heads/ansi256.py
// _CUBE_LEVELS, _THRESH_R / _G / _B).
__constant__ int CUBE_LEVELS[6] = {0, 95, 135, 175, 215, 255};
__constant__ int THRESH[3][5] = {
    {38, 115, 155, 196, 235}, {36, 116, 154, 195, 235}, {35, 115, 155, 195, 235}};

// The ASCII luminance ramp (heads/ascii.py ASCII_RAMP).
__constant__ char RAMP[NUM_ASCII + 1] =
    " .`^\",:;Il!i><~+_-?*][}{1)(|/tfjrxnuvczmwXYUJCLqpdbkhao#%ZO8B$0QM&W@";

// The sum of n values v(0..n-1) in the order of torch's CUDA reduction of n
// inputs a output along the reduction's fastest dimension: block_width =
// min(last power of two <= n, 32) lanes; lane t sums its inputs t, t + bw,
// ... into four accumulators (thread_reduce's vt0 = 4), which it adds in
// turn; the lanes are then added by shuffles at offsets bw / 2, ..., 2, 1.
// Read on the card against torch's mean at ss 2, 3 and 4 (PERF.md).
template <class F>
__device__ __forceinline__ float torch_sum(int n, F v) {
  int bw = 1;
  while (bw * 2 <= n && bw < 32) bw *= 2;
  float part[32];
  for (int t = 0; t < bw; ++t) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int idx = t;
    while (idx + 3 * bw < n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = acc[i] + v(idx + i * bw);
      idx += 4 * bw;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (idx < n) {
        acc[i] = acc[i] + v(idx);
        idx += bw;
      }
    }
    part[t] = ((acc[0] + acc[1]) + acc[2]) + acc[3];
  }
  for (int off = bw / 2; off > 0; off >>= 1)
    for (int t = 0; t < off; ++t) part[t] = part[t] + part[t + off];
  return part[0];
}

// A cell's pooled fields.
struct Pooled {
  float hitf, depth, shading, v0, v1, v2;  // v: rgb, or the normal
};

// The cell's fields at ss = 2: float2 loads of the two subpixel rows of each
// plane, the 2x2 sums as torch_sum adds them: each column, then the two.
template <int MODE>
__device__ __forceinline__ Pooled pool_2x2(const float* __restrict__ planes, size_t plane,
                                           size_t o, int wp, const HeadsParams& p) {
  const auto ld = [&](int pl, int row) {
    return *reinterpret_cast<const float2*>(planes + pl * plane + o + static_cast<size_t>(row) * wp);
  };
  const float2 d0 = ld(O_DEPTH, 0), d1 = ld(O_DEPTH, 1);
  const float m00 = d0.x <= p.far ? 1.f : 0.f, m01 = d0.y <= p.far ? 1.f : 0.f;
  const float m10 = d1.x <= p.far ? 1.f : 0.f, m11 = d1.y <= p.far ? 1.f : 0.f;
  const auto sum = [&](float2 a, float2 b) {
    return (a.x * m00 + b.x * m10) + (a.y * m01 + b.y * m11);
  };
  Pooled c;
  c.hitf = ((m00 + m10) + (m01 + m11)) * p.factor1;
  c.depth = c.shading = 0.f;
  constexpr bool ascii = MODE == BIT_ASCII || MODE == RGB_ASCII;
  if (ascii) {
    const float denom = fmaxf(c.hitf, p.min_denom);
    c.depth = c.hitf > 0.f ? (sum(d0, d1) * p.factor1) / denom : MISS;
    c.shading = sum(ld(O_SHADING, 0), ld(O_SHADING, 1)) * p.factor1;
  }
  const int p0 = MODE == RGB_NORMALS ? O_NX : O_R;
  c.v0 = sum(ld(p0, 0), ld(p0, 1)) * p.factor3;
  c.v1 = sum(ld(p0 + 1, 0), ld(p0 + 1, 1)) * p.factor3;
  c.v2 = sum(ld(p0 + 2, 0), ld(p0 + 2, 1)) * p.factor3;
  return c;
}

// Any other ss > 1: scalar loads, the same fields in torch_sum's order over
// the subpixels k = col + ss * row.
template <int MODE>
__device__ __forceinline__ Pooled pool_general(const float* __restrict__ planes, size_t plane,
                                               size_t o, int wp, const HeadsParams& p) {
  const int ss = p.ss, n = ss * ss;
  const auto at = [&](int pl, int k) {
    return planes[pl * plane + o + static_cast<size_t>(k / ss) * wp + k % ss];
  };
  const auto mask = [&](int k) { return at(O_DEPTH, k) <= p.far ? 1.f : 0.f; };
  const auto pooled = [&](int pl, float factor) {
    return torch_sum(n, [&](int k) { return at(pl, k) * mask(k); }) * factor;
  };
  Pooled c;
  c.hitf = torch_sum(n, mask) * p.factor1;
  c.depth = c.shading = 0.f;
  if (MODE == BIT_ASCII || MODE == RGB_ASCII) {
    const float denom = fmaxf(c.hitf, p.min_denom);
    c.depth = c.hitf > 0.f ? pooled(O_DEPTH, p.factor1) / denom : MISS;
    c.shading = pooled(O_SHADING, p.factor1);
  }
  const int p0 = MODE == RGB_NORMALS ? O_NX : O_R;
  c.v0 = pooled(p0, p.factor3);
  c.v1 = pooled(p0 + 1, p.factor3);
  c.v2 = pooled(p0 + 2, p.factor3);
  return c;
}

// (uint8_t) of a float: clamp to [0, 255], truncate (modes.py _trunc_u8).
__device__ __forceinline__ int trunc_u8(float x) {
  return static_cast<int>(fminf(fmaxf(x, 0.f), 255.f));
}

// The red-mean weighted squared distance (ansi256.py _distance).
__device__ __forceinline__ int distance(int r, int g, int b, int pr, int pg, int pb) {
  const int r_sum = r + pr, dr = r - pr, dg = g - pg, db = b - pb;
  return (1024 + r_sum) * dr * dr + 2048 * dg * dg + (1534 - r_sum) * db * db;
}

// ansi256_from_rgb of integer channels in [0, 255]. The luminance sum peaks
// at 4286578688, past int32: it is summed in unsigned 32 bits.
__device__ __forceinline__ int ansi256(int r, int g, int b) {
  if (r == g && g == b) return GREY_LUT[r];
  const unsigned lum = (3567664u * static_cast<unsigned>(r) + 11998547u * static_cast<unsigned>(g) +
                        1211005u * static_cast<unsigned>(b) + (1u << 23)) >> 24;
  const int grey = GREY_LUT[lum];
  const unsigned pc = PALETTE[grey];
  const int grey_dist = distance(r, g, b, pc >> 16, (pc >> 8) & 0xFF, pc & 0xFF);
  int ir = 0, ig = 0, ib = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    ir += r >= THRESH[0][k];
    ig += g >= THRESH[1][k];
    ib += b >= THRESH[2][k];
  }
  const int cube_dist = distance(r, g, b, CUBE_LEVELS[ir], CUBE_LEVELS[ig], CUBE_LEVELS[ib]);
  return cube_dist < grey_dist ? 16 + 36 * ir + 6 * ig + ib : grey;
}

// The glyph of a hit cell (ascii.py ascii_indices, modes.py _ascii_chars).
__device__ __forceinline__ int ascii_glyph(float shading, float depth, float far) {
  int idx = static_cast<int>(ceilf(shading * static_cast<float>(NUM_ASCII - 1)));
  idx = min(max(idx, 1), NUM_ASCII - 1);
  return RAMP[depth > far ? 0 : idx];
}

template <int MODE>
__global__ void __launch_bounds__(HEADS_THREADS)
    cell_heads_kernel(const float* __restrict__ planes, HeadsParams p, int* __restrict__ kind,
                      int* __restrict__ color, int* __restrict__ glyph) {
  const int j = blockIdx.x * HEADS_THREADS + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= p.w) return;
  const size_t plane = static_cast<size_t>(p.hp) * p.wp;
  const size_t o = static_cast<size_t>(i) * p.ss * p.wp + static_cast<size_t>(j) * p.ss;
  constexpr bool ascii = MODE == BIT_ASCII || MODE == RGB_ASCII;
  Pooled c;
  if (p.ss == 2) {
    c = pool_2x2<MODE>(planes, plane, o, p.wp, p);
  } else if (p.ss == 1) {  // the subpixel is the cell: nothing pooled, no renormalisation
    c.depth = planes[O_DEPTH * plane + o];
    c.hitf = c.depth <= p.far ? 1.f : 0.f;
    c.shading = ascii ? planes[O_SHADING * plane + o] : 0.f;
    const int p0 = MODE == RGB_NORMALS ? O_NX : O_R;
    c.v0 = planes[p0 * plane + o];
    c.v1 = planes[(p0 + 1) * plane + o];
    c.v2 = planes[(p0 + 2) * plane + o];
  } else {
    c = pool_general<MODE>(planes, plane, o, p.wp, p);
  }
  if (MODE == RGB_NORMALS && p.ss > 1) {  // safe_normalize
    const float sq = (c.v0 * c.v0 + c.v2 * c.v2) + c.v1 * c.v1;
    const float inv = rsqrtf(fmaxf(sq, 1e-20f));
    c.v0 = c.v0 * inv;
    c.v1 = c.v1 * inv;
    c.v2 = c.v2 * inv;
  }
  const bool visible = c.hitf > 0.f, hit = c.hitf >= 0.5f;
  const size_t cell = static_cast<size_t>(i) * p.w + j;
  kind[cell] = ascii && hit ? 1 : 0;
  glyph[cell] = ascii && hit ? ascii_glyph(c.shading, c.depth, p.far) : SPACE;
  if (MODE == BIT_ASCII || MODE == BIT_PIXEL) {
    color[cell] = visible ? ansi256(trunc_u8(c.v0), trunc_u8(c.v1), trunc_u8(c.v2)) : 16;
  } else {
    if (MODE == RGB_NORMALS) {  // normal * 255
      c.v0 = c.v0 * 255.f;
      c.v1 = c.v1 * 255.f;
      c.v2 = c.v2 * 255.f;
    }
    color[3 * cell] = visible ? trunc_u8(c.v0) : 0;
    color[3 * cell + 1] = visible ? trunc_u8(c.v1) : 0;
    color[3 * cell + 2] = visible ? trunc_u8(c.v2) : 0;
  }
}

template <int MODE>
cudaError_t launch(const float* planes, const HeadsParams& p, int* kind, int* color, int* glyph,
                   cudaStream_t stream) {
  const dim3 grid((p.w + HEADS_THREADS - 1) / HEADS_THREADS, p.h);
  cell_heads_kernel<MODE><<<grid, HEADS_THREADS, 0, stream>>>(planes, p, kind, color, glyph);
  return cudaGetLastError();
}

}  // namespace

// planes [8, hp, wp] f32 (K7's output); kind, glyph [h, w] int32; color [h,
// w] int32 in the ANSI-256 modes, [h, w, 3] in the truecolor ones. At ss = 2
// the planes and wp must allow float2 loads (8-byte aligned, wp even).
// Returns a cudaError_t (0 on success).
extern "C" int rtwc_cell_heads(const float* planes, int* kind, int* color, int* glyph,
                               const HeadsParams* params, void* stream) {
  const HeadsParams p = *params;
  if (p.h < 1 || p.w < 1 || p.h > 65535 || p.ss < 1 || p.ss > MAX_SS ||
      static_cast<long long>(p.h) * p.ss > p.hp || static_cast<long long>(p.w) * p.ss > p.wp)
    return (int)cudaErrorInvalidValue;
  if (p.ss == 2 && ((p.wp & 1) || (reinterpret_cast<uintptr_t>(planes) & 7)))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(p.device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.mode) {
    case BIT_ASCII: return (int)launch<BIT_ASCII>(planes, p, kind, color, glyph, s);
    case BIT_PIXEL: return (int)launch<BIT_PIXEL>(planes, p, kind, color, glyph, s);
    case RGB_ASCII: return (int)launch<RGB_ASCII>(planes, p, kind, color, glyph, s);
    case RGB_PIXEL: return (int)launch<RGB_PIXEL>(planes, p, kind, color, glyph, s);
    case RGB_NORMALS: return (int)launch<RGB_NORMALS>(planes, p, kind, color, glyph, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
