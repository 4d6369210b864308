// Native ANSI escape-stream encoder with run-length minimization.
//
// The TPU-native framework's equivalent of the reference's host hot loop:
// RayTracingManager::Minimize8bit / MinimizeRGB (RayTracingManager.cu:167-319)
// which run-length-compress the device-produced fixed-stride char framebuffer
// before the console blit. Here the device produces compact (kind, color,
// glyph) cell arrays instead of pre-formatted escape bytes, and this single
// C++ pass formats + minimizes in one go.
//
// Contract (must match encode.py::encode_frame_numpy byte-for-byte; fuzzed
// in tests/test_native.py):
//   - one SGR escape only when (kind, color) differs from the previously
//     emitted cell, carried across rows; first cell always emits;
//   - 256-color cells: ESC[{3|4}8;5;{idx}m + glyph  (<= 12 B/cell);
//   - truecolor cells: ESC[{3|4}8;2;{r};{g};{b}m + glyph (<= 20 B/cell);
//   - decimal components drop leading zeros; one '\n' after each row.
//
// Build: g++ -O3 -march=native -shared -fPIC (see native/__init__.py).

#include <cstdint>
#include <cstring>

namespace {

inline uint8_t* put_u8_dec(uint8_t* p, int32_t v) {
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

}  // namespace

extern "C" {

// kind: [H*W] 0 = background ('48'), 1 = foreground ('38')
// color: [H*W] (truecolor == 0) or [H*W*3] (truecolor != 0)
// charcode: [H*W] glyph byte
// out: capacity >= H*W*20 + H
// returns bytes written
int64_t rtwc_encode_frame(const int32_t* kind, const int32_t* color,
                          const int32_t* charcode, int64_t H, int64_t W,
                          int32_t truecolor, uint8_t* out) {
  uint8_t* p = out;
  int32_t last_kind = -1;
  int32_t last_c0 = -1, last_c1 = -1, last_c2 = -1;
  const int64_t n = H * W;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t k = kind[i];
    int32_t c0, c1 = 0, c2 = 0;
    if (truecolor) {
      c0 = color[3 * i];
      c1 = color[3 * i + 1];
      c2 = color[3 * i + 2];
    } else {
      c0 = color[i];
    }
    const bool change =
        k != last_kind || c0 != last_c0 || c1 != last_c1 || c2 != last_c2;
    if (change) {
      last_kind = k;
      last_c0 = c0;
      last_c1 = c1;
      last_c2 = c2;
      *p++ = 0x1B;
      *p++ = '[';
      *p++ = k ? '3' : '4';
      *p++ = '8';
      *p++ = ';';
      if (truecolor) {
        *p++ = '2';
        *p++ = ';';
        p = put_u8_dec(p, c0);
        *p++ = ';';
        p = put_u8_dec(p, c1);
        *p++ = ';';
        p = put_u8_dec(p, c2);
      } else {
        *p++ = '5';
        *p++ = ';';
        p = put_u8_dec(p, c0);
      }
      *p++ = 'm';
    }
    *p++ = static_cast<uint8_t>(charcode[i]);
    if ((i + 1) % W == 0) *p++ = '\n';
  }
  return static_cast<int64_t>(p - out);
}

}  // extern "C"
