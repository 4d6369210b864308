// The console frame's ANSI escape stream, encoded on the card (sm_90a).
//
// Replaces no Pallas kernel: the JAX package encodes its cells on the host
// (rtwc_tpu/heads/encode.py, and the C++ loop rtwc_tpu/io/native/
// ansi_encoder.cpp, which the port keeps for cells on the host:
// heads/encode.py, io/native.py). It was added because that loop, run on
// the host for every frame, set the console's pace while the card sat
// idle; here the stream is built where the cells are, and the host receives
// the finished bytes. The wrappers and the plain version are in
// heads/device_encode.py.
//
// Contract (encode.py's encode_frame_numpy, byte for byte): an SGR escape
// only where (kind, colour) differs from the previous cell in row-major
// order, carried across rows, the first cell always; ESC[{3|4}8;5;{idx}m
// (256 colours) or ESC[{3|4}8;2;{r};{g};{b}m (truecolor), '3' where kind is
// 1, decimal digits with no leading zeros; the glyph's byte; one '\n' after
// each row. A cell takes 1 to 12 bytes (20 in truecolor), a row one more.
//
// Two launches, a block a row:
//  ansi_row_bytes_kernel<TC>: each block sums its row's bytes, a cell a
//    thread, and writes the sum (with the '\n') to row_len[row].
//  ansi_write_kernel<TC>: each block adds row_len of the rows before its
//    own (its offset in the stream), then walks its row in chunks of
//    ENC_THREADS x CPT cells: a thread takes CPT consecutive cells, reads
//    them with 16-byte loads where the row allows (W a multiple of 4),
//    computes each cell's change flag against the cell before (at a row's
//    start, the last cell of the row before) and its byte count; a
//    block-wide scan of the threads' counts places each thread's bytes in
//    a chunk buffer in shared memory, and the block copies the chunk to the
//    stream with 4-byte stores, neighbouring threads on neighbouring words.
//    The last row's block writes the stream's length.
// And, for the download, ansi_copy_kernel: the stream's first `length`
// bytes and the length, read on the card, written into pinned host memory
// through its device-mapped address, so the host needs no length to start
// the copy and the copy moves the stream (1.2 MB at 1920x500 in ANSI-256)
// and not its bound (11.5 MB).
//
// What bounds it: memory. It reads the cells twice (once for the counts,
// without the glyphs, once to write; 11.5 MB a pass at 1920x500 in
// ANSI-256, the second mostly from L2) and writes the stream once, at most
// 11.5 MB (19.2 MB in truecolor): some 4-7 us of bytes at 3.35 TB/s. There
// is no arithmetic worth a tensor core: a few compares and digit splits a
// cell. Nothing reads the host, so the launches run inside a CUDA graph.
// The copy is bound by the host link: the stream's bytes over PCIe.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int ENC_THREADS = 256;                  // threads a block
constexpr int CPT = 4;                            // consecutive cells a thread, a chunk
constexpr int CHUNK = ENC_THREADS * CPT;          // cells a chunk
constexpr int NW = ENC_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int ndigits(int v) { return v >= 100 ? 3 : (v >= 10 ? 2 : 1); }

__device__ __forceinline__ uint8_t* put_dec(uint8_t* p, int v) {
  if (v >= 100) {
    *p++ = static_cast<uint8_t>('0' + v / 100);
    *p++ = static_cast<uint8_t>('0' + (v / 10) % 10);
    *p++ = static_cast<uint8_t>('0' + v % 10);
  } else if (v >= 10) {
    *p++ = static_cast<uint8_t>('0' + v / 10);
    *p++ = static_cast<uint8_t>('0' + v % 10);
  } else {
    *p++ = static_cast<uint8_t>('0' + v);
  }
  return p;
}

// A cell's (kind, colour): c1 = c2 = 0 in 256 colours.
struct Key {
  int k, c0, c1, c2;
};

__device__ __forceinline__ bool differs(const Key& a, const Key& b) {
  return a.k != b.k || a.c0 != b.c0 || a.c1 != b.c1 || a.c2 != b.c2;
}

template <bool TC>
__device__ __forceinline__ Key load_key(const int* __restrict__ kind,
                                        const int* __restrict__ color, int64_t i) {
  if (TC) return Key{kind[i], color[3 * i], color[3 * i + 1], color[3 * i + 2]};
  return Key{kind[i], color[i], 0, 0};
}

// The escape's bytes (no glyph).
template <bool TC>
__device__ __forceinline__ int escape_bytes(const Key& c) {
  return TC ? 10 + ndigits(c.c0) + ndigits(c.c1) + ndigits(c.c2) : 8 + ndigits(c.c0);
}

template <bool TC>
__device__ __forceinline__ uint8_t* put_escape(uint8_t* p, const Key& c) {
  *p++ = 0x1B;
  *p++ = '[';
  *p++ = c.k == 1 ? '3' : '4';
  *p++ = '8';
  *p++ = ';';
  *p++ = TC ? '2' : '5';
  *p++ = ';';
  p = put_dec(p, c.c0);
  if (TC) {
    *p++ = ';';
    p = put_dec(p, c.c1);
    *p++ = ';';
    p = put_dec(p, c.c2);
  }
  *p++ = 'm';
  return p;
}

__device__ __forceinline__ long long warp_sum64(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The sum of v over the block, in every thread; `red` is NW words of
// shared memory, free again when it returns.
__device__ __forceinline__ long long block_sum64(long long v, long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum64(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  long long s = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) s += red[w];
  __syncthreads();
  return s;
}

// The exclusive prefix of v over the block's threads; *total gets the
// block's sum. `part` is NW words of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int v, int* part, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int pw = part[w];
    before += w < warp ? pw : 0;
    sum += pw;
  }
  *total = sum;
  return before + x - v;
}

template <bool TC>
__global__ void __launch_bounds__(ENC_THREADS)
    ansi_row_bytes_kernel(const int* __restrict__ kind, const int* __restrict__ color,
                          int64_t W, int* __restrict__ row_len) {
  __shared__ long long red[NW];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * W;
  int bytes = 0;
  for (int64_t j = threadIdx.x; j < W; j += ENC_THREADS) {
    const int64_t i = row0 + j;
    const Key c = load_key<TC>(kind, color, i);
    const bool change = i == 0 || differs(c, load_key<TC>(kind, color, i - 1));
    bytes += 1 + (change ? escape_bytes<TC>(c) : 0);
  }
  const long long sum = block_sum64(bytes, red);
  if (threadIdx.x == 0) row_len[blockIdx.x] = static_cast<int>(sum) + 1;
}

template <bool TC>
__global__ void __launch_bounds__(ENC_THREADS)
    ansi_write_kernel(const int* __restrict__ kind, const int* __restrict__ color,
                      const int* __restrict__ glyph, int64_t H, int64_t W, int vec,
                      const int* __restrict__ row_len, uint8_t* __restrict__ out,
                      long long* __restrict__ length) {
  constexpr int L = TC ? 20 : 12;  // a cell's most bytes
  __shared__ uint8_t stage[CHUNK * L + 1];
  __shared__ long long red[NW];
  __shared__ int part[NW];
  const int64_t r = blockIdx.x;
  const int t = threadIdx.x;

  long long before = 0;  // the stream's bytes before this row
  for (int64_t q = t; q < r; q += ENC_THREADS) before += row_len[q];
  long long off = block_sum64(before, red);
  if (r == H - 1 && t == 0) *length = off + row_len[r];

  const int64_t row0 = r * W;
  for (int64_t c0 = 0; c0 < W; c0 += CHUNK) {
    const int64_t j0 = c0 + static_cast<int64_t>(t) * CPT;  // this thread's first cell
    Key key[CPT];
    int gl[CPT];
    int n = 0;  // cells of the row this thread holds
    if (vec && j0 + CPT <= W) {
      const int64_t i = row0 + j0;  // a multiple of 4: W is
      const int4 k4 = *reinterpret_cast<const int4*>(kind + i);
      const int4 g4 = *reinterpret_cast<const int4*>(glyph + i);
      key[0].k = k4.x, key[1].k = k4.y, key[2].k = k4.z, key[3].k = k4.w;
      gl[0] = g4.x, gl[1] = g4.y, gl[2] = g4.z, gl[3] = g4.w;
      if (TC) {
        const int4* cp = reinterpret_cast<const int4*>(color + 3 * i);
        const int4 a = cp[0], b = cp[1], c = cp[2];
        key[0].c0 = a.x, key[0].c1 = a.y, key[0].c2 = a.z;
        key[1].c0 = a.w, key[1].c1 = b.x, key[1].c2 = b.y;
        key[2].c0 = b.z, key[2].c1 = b.w, key[2].c2 = c.x;
        key[3].c0 = c.y, key[3].c1 = c.z, key[3].c2 = c.w;
      } else {
        const int4 a = *reinterpret_cast<const int4*>(color + i);
        key[0].c0 = a.x, key[1].c0 = a.y, key[2].c0 = a.z, key[3].c0 = a.w;
#pragma unroll
        for (int m = 0; m < CPT; ++m) key[m].c1 = key[m].c2 = 0;
      }
      n = CPT;
    } else {
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        if (j0 + m < W) {
          key[m] = load_key<TC>(kind, color, row0 + j0 + m);
          gl[m] = glyph[row0 + j0 + m];
          n = m + 1;
        }
      }
    }
    int bytes = 0;
    bool change[CPT];
    if (n > 0) {
      const int64_t i0 = row0 + j0;
      change[0] = i0 == 0 || differs(key[0], load_key<TC>(kind, color, i0 - 1));
#pragma unroll
      for (int m = 1; m < CPT; ++m) change[m] = m < n && differs(key[m], key[m - 1]);
#pragma unroll
      for (int m = 0; m < CPT; ++m)
        if (m < n) bytes += 1 + (change[m] ? escape_bytes<TC>(key[m]) : 0);
      if (j0 + n == W) bytes += 1;  // the row's '\n'
    }
    int total;
    const int at = block_exclusive_scan(bytes, part, &total);
    if (n > 0) {
      uint8_t* p = stage + at;
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        if (m < n) {
          if (change[m]) p = put_escape<TC>(p, key[m]);
          *p++ = static_cast<uint8_t>(gl[m]);
        }
      }
      if (j0 + n == W) *p = '\n';
    }
    __syncthreads();
    // the chunk to the stream: bytes up to a 4-byte boundary, whole words,
    // the rest
    uint8_t* o = out + off;
    const int head = min(total, static_cast<int>((4 - (off & 3)) & 3));
    const int words = (total - head) >> 2;
    if (t < head) o[t] = stage[t];
    uint32_t* ow = reinterpret_cast<uint32_t*>(o + head);
    for (int w = t; w < words; w += ENC_THREADS) {
      const uint8_t* s = stage + head + 4 * w;
      ow[w] = static_cast<uint32_t>(s[0]) | static_cast<uint32_t>(s[1]) << 8 |
              static_cast<uint32_t>(s[2]) << 16 | static_cast<uint32_t>(s[3]) << 24;
    }
    const int tail = head + 4 * words;
    if (tail + t < total) o[tail + t] = stage[tail + t];
    off += total;
    __syncthreads();  // the stage and `part` are reused by the next chunk
  }
}

// The stream's first `length` bytes (at most cap) and the length itself into
// pinned host memory, through its device-mapped address: 16-byte words a
// thread, neighbouring threads on neighbouring words, then the last bytes.
__global__ void __launch_bounds__(ENC_THREADS)
    ansi_copy_kernel(const uint8_t* __restrict__ src, const long long* __restrict__ length,
                     uint8_t* __restrict__ dst, long long* __restrict__ dst_len, long long cap) {
  const long long n = min(*length, cap);
  const long long words = n >> 4;
  const long long stride = static_cast<long long>(gridDim.x) * ENC_THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * ENC_THREADS + threadIdx.x;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (long long w = first; w < words; w += stride) d[w] = s[w];
  if (first < 16 && 16 * words + first < n) dst[16 * words + first] = src[16 * words + first];
  if (first == 0) *dst_len = n;
}

}  // namespace

// kind, glyph [H*W] int32; color [H*W] (truecolor == 0) or [H*W*3] int32;
// row_len [H] int32 scratch; out: capacity H * (W * (truecolor ? 20 : 12) + 1)
// bytes; length [1] int64. Returns a cudaError_t (0 on success).
extern "C" int rtwc_ansi_encode(const int* kind, const int* color, const int* glyph,
                                int* row_len, uint8_t* out, long long* length, long long H,
                                long long W, int truecolor, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H < 1 || W < 1 || H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = W % 4 == 0 && aligned(kind) && aligned(color) && aligned(glyph);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(H));
  if (truecolor) {
    ansi_row_bytes_kernel<true><<<grid, ENC_THREADS, 0, s>>>(kind, color, W, row_len);
    if ((err = cudaGetLastError())) return (int)err;
    ansi_write_kernel<true><<<grid, ENC_THREADS, 0, s>>>(kind, color, glyph, H, W, vec, row_len,
                                                         out, length);
  } else {
    ansi_row_bytes_kernel<false><<<grid, ENC_THREADS, 0, s>>>(kind, color, W, row_len);
    if ((err = cudaGetLastError())) return (int)err;
    ansi_write_kernel<false><<<grid, ENC_THREADS, 0, s>>>(kind, color, glyph, H, W, vec, row_len,
                                                          out, length);
  }
  return (int)cudaGetLastError();
}

// src [cap] uint8 and length [1] int64 on the card (rtwc_ansi_encode's out
// and length); dst [cap] uint8 and dst_len [1] int64 in pinned host memory,
// both 16-byte aligned. Copies the stream's first `length` bytes and the
// length, on `stream`, without the host reading the length. Returns a
// cudaError_t (0 on success).
extern "C" int rtwc_ansi_copy(const uint8_t* src, const long long* length, uint8_t* dst,
                              long long* dst_len, long long cap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  void* mapped[2] = {nullptr, nullptr};
  void* host[2] = {dst, dst_len};
  for (int i = 0; i < 2; ++i) {
    cudaPointerAttributes attr;
    if ((err = cudaPointerGetAttributes(&attr, host[i]))) return (int)err;
    if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr)
      return (int)cudaErrorInvalidHostPointer;
    mapped[i] = attr.devicePointer;
  }
  if ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(mapped[0])) & 15)
    return (int)cudaErrorMisalignedAddress;
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))) return (int)err;
  ansi_copy_kernel<<<2 * sms, ENC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      src, length, static_cast<uint8_t*>(mapped[0]), static_cast<long long*>(mapped[1]), cap);
  return (int)cudaGetLastError();
}
