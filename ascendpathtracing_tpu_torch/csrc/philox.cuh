// Counter-based random numbers of the path-tracing kernels (render_pt.cu,
// mesh_pt.cu): Philox4x32-10 and the per-sample uniform reader.  The TPU
// kernels draw from the TPU's hardware PRNG, which nothing else
// reproduces; these are ops/rng.py's numbers, key (seed, 0), counter
// (pixel, layer, block, 0), four uniforms (bits >> 8) * 2^-24 per call.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Philox4x32-10 (Salmon et al., SC 2011), as ops/rng.philox4x32.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The uniforms of one (pixel, layer) sample, numbered q = 0, 1, ...
// The words of the last Philox block are kept, so consecutive q cost one
// Philox call per four.
template <typename T>
struct SampleUniforms {
  const T* buf;         // &uniforms[layer][0][pixel], or nullptr: Philox
  long long stride;     // the buffer's step from q to q + 1 (W * H)
  uint32_t pixel, layer, seed;
  uint32_t block;       // the block held in w; 0xffffffff for none
  uint4 w;

  __device__ __forceinline__ T operator()(int q) {
    if (buf != nullptr) return buf[q * stride];
    const uint32_t b = static_cast<uint32_t>(q) >> 2;
    if (b != block) {
      w = philox4x32_10(make_uint4(pixel, layer, b, 0u), seed, 0u);
      block = b;
    }
    return word(w, q & 3);
  }

  // Uniforms q, q + 1 and q + 2, where q - 1 was the last one drawn: they
  // lie in its block and at most one more, so one Philox call at most,
  // made at one place (the bounce's draws do not each inline a call that
  // diverging lanes would take one after another).
  __device__ __forceinline__ void three(int q, T& a, T& b, T& c) {
    if (buf != nullptr) {
      a = buf[q * stride];
      b = buf[(q + 1) * stride];
      c = buf[(q + 2) * stride];
      return;
    }
    const uint4 held = w;
    const uint32_t last = static_cast<uint32_t>(q + 2) >> 2;
    if (last != block) {
      w = philox4x32_10(make_uint4(pixel, layer, last, 0u), seed, 0u);
      block = last;
    }
    a = word(static_cast<uint32_t>(q) >> 2 == last ? w : held, q & 3);
    b = word(static_cast<uint32_t>(q + 1) >> 2 == last ? w : held, (q + 1) & 3);
    c = word(w, (q + 2) & 3);
  }

  static __device__ __forceinline__ T word(const uint4& v, int i) {
    const uint32_t bits = i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
    return T(bits >> 8) * T(1.0 / 16777216.0);
  }
};

}  // namespace
