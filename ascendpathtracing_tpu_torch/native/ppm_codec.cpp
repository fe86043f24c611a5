// Native PPM writer: fused color-plane decode (sub-pixel averaging +
// vertical flip + clip, data_visualization.py:20-58 semantics) and ASCII
// P3 text encode (data_visualization.py:11-17 raster order).
//
// This plays the role of the reference's C++ host I/O layer
// (src/data_utils.h WriteFile + scripts/data_visualization.py): the text
// encode is the one host-side step that is Python-loop-bound (measured
// ~0.5 s per megapixel in CPython vs ~20 ms here).  Bit-exact with
// utils/io.decode_color + encode_ppm (same summation order: mean over
// each group of `samples`, then mean of the 4 groups, in float64).
//
// ABI: plain C, consumed via ctypes (accel/native.py).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// value -> "ddd " appended at p; returns chars written (uint8 range)
static inline int put_u8(char *p, unsigned v) {
  if (v >= 100) {
    p[0] = static_cast<char>('0' + v / 100);
    p[1] = static_cast<char>('0' + (v / 10) % 10);
    p[2] = static_cast<char>('0' + v % 10);
    p[3] = ' ';
    return 4;
  }
  if (v >= 10) {
    p[0] = static_cast<char>('0' + v / 10);
    p[1] = static_cast<char>('0' + v % 10);
    p[2] = ' ';
    return 3;
  }
  p[0] = static_cast<char>('0' + v);
  p[1] = ' ';
  return 2;
}

}  // namespace

extern "C" {

// planes: float32 [3, width*height*4*samples] (the color.bin layout).
// out/max_len: caller-allocated text buffer.  Returns bytes written, or
// -1 if the buffer is too small.
int64_t apt_encode_ppm(const float *planes, int32_t width, int32_t height,
                       int32_t samples, char *out, int64_t max_len) {
  const int64_t w = width, h = height, s = samples;
  if (w > h) return -2;  // encode order indexes pixel row i < h (like the
                         // reference's square-image assumption)
  const int64_t spp4 = 4 * s;
  const int64_t n = w * h * spp4;  // rays per plane
  char *p = out;
  char *end = out + max_len;

  int hdr = std::snprintf(p, static_cast<size_t>(end - p), "P3\n%d %d\n255\n",
                          width, height);
  if (hdr < 0 || p + hdr >= end) return -1;
  p += hdr;

  // Python writes line i (i in 0..w) holding img[a, i, :] for a in 0..w,
  // where img[x, y, c] = decode(c, x, h-1-y).  Worst case per value is 4
  // chars ("255 ") plus "\n" per line.
  for (int64_t i = 0; i < w; ++i) {
    if (p + w * 3 * 4 + 2 > end) return -1;
    for (int64_t a = 0; a < w; ++a) {
      const int64_t jj = h - 1 - i;  // vertical flip of the pixel row
      for (int64_t c = 0; c < 3; ++c) {
        const float *base = planes + c * n + (a * h + jj) * spp4;
        // mean over each group of s, then mean of the 4 groups — the
        // same sequential float64 order as np.mean on a small axis
        double quad = 0.0;
        for (int g = 0; g < 4; ++g) {
          double acc = 0.0;
          for (int64_t t = 0; t < s; ++t)
            acc += static_cast<double>(base[g * s + t]);
          quad += acc / static_cast<double>(s);
        }
        double v = quad / 4.0;
        v = std::min(std::max(v, 0.0), 1.0) * 255.0;
        p += put_u8(p, static_cast<unsigned>(static_cast<uint8_t>(v)));
      }
    }
    *p++ = '\n';
  }
  return p - out;
}

}  // extern "C"
