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
    const int i = q & 3;
    const uint32_t bits = i == 0 ? w.x : (i == 1 ? w.y : (i == 2 ? w.z : w.w));
    return T(bits >> 8) * T(1.0 / 16777216.0);
  }
};

}  // namespace
