// Hand-written Hopper (sm_90a) kernel of the chunk-grid traversal:
// closest hit of rays [6, N] against a mesh cut into fixed-size chunks
// under 1-3 levels of boxes, for float and double.  It replaces
// _wbvh_kernel of ascendpathtracing_tpu/ops/pallas_wbvh.py (with its
// helpers compact_worklist and streamed_chunk_loop).
//
// Build (ops/build.py runs this at first use, into build/):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libwbvh.so wbvh.cu
//
// PARITY RULE, as in render_ref.cu: -fmad=false and never
// --use_fast_math; the Pallas kernel's op order (chunk_walk.cuh), so the
// plain twin (ops/wbvh_kernels.intersect_chunks_plain) gives the same
// tmin, slot, attributes and counts bit for bit.
//
// Design: one thread per ray walks the grid (chunk_walk.cuh) and keeps
// the running (tmin, slot).  The box tables go to shared memory when they
// fit (s4: 340 boxes x 24 B); triangle rows (s4: 491 KB) stay in global
// memory and are read through the read-only cache.  The TPU kernel's
// residency modes, ray tiles and 128-box flag blocks have no counterpart:
// any N, any group size.  The 11 winner attributes are read from the
// winning row once after the walk (the Pallas kernel carries them through
// its loop; the values are the same copies).  Outputs: tmin [N] (1e20 on
// a miss), slot [N] int32 (0 on a miss), optionally attrs [11, N] and
// per-ray counts [3, N] int32 (chunks tested, supers hit, super-supers
// hit) in place of the TPU's per-tile [3, n_tiles].
//
// Bound on the H100: FP32/FP64 instruction throughput and divergence.
// Per ray ~20 flops per box tested and ~30 per triangle; the walk length
// varies per ray, so a warp runs as long as its longest walk.  HBM
// traffic is the rays (24 B) and outputs (8-60 B) per ray; the rows are
// re-read from L1/L2.

#include <cuda_runtime.h>

#include <cstdint>

#include "chunk_walk.cuh"
#include "sphere_hit.cuh"  // BLOCK, miss_t

namespace {

template <typename T>
struct WbvhParams {
  ChunkGrid g;
  long long n;
  T eps;
  int tpc, stride;
  bool shared_boxes;
};

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    wbvh_kernel(const T* __restrict__ rays, const float* __restrict__ tris,
                T* __restrict__ tmin_out, int32_t* __restrict__ hit_out,
                T* __restrict__ attrs_out, int32_t* __restrict__ stats_out,
                const WbvhParams<T> p) {
  extern __shared__ float smem[];
  const ChunkGrid g = boxes_to_shared(p.g, smem, p.shared_boxes);
  const long long i = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= p.n) return;
  const long long n = p.n;
  const RayInv<T> r = make_ray(rays[i], rays[n + i], rays[2 * n + i],
                               rays[3 * n + i], rays[4 * n + i], rays[5 * n + i]);
  T tmin = miss_t<T>();
  int slot = -1;
  WalkCounts cnt = {0, 0, 0};
  walk_chunks(
      g, r, [&](int c) { test_chunk(tris, p.stride, c, p.tpc, r, p.eps, tmin, slot); },
      cnt);
  tmin_out[i] = tmin;
  hit_out[i] = slot < 0 ? 0 : slot;
  if (attrs_out != nullptr) {
    const float* row = tris + static_cast<long long>(slot < 0 ? 0 : slot) * p.stride;
    for (int a = 0; a < N_ATTR; ++a) {
      attrs_out[a * n + i] = slot < 0 ? T(0) : T(__ldg(row + TRI_F + a));
    }
  }
  if (stats_out != nullptr) {
    stats_out[i] = cnt.k;
    stats_out[n + i] = cnt.ks;
    stats_out[2 * n + i] = cnt.kss;
  }
}

template <typename T>
int launch_wbvh(const void* rays, const void* cboxes, const void* sboxes,
                const void* ssboxes, const void* tris, void* tmin, void* hit,
                void* attrs, void* stats, long long n, int n_chunks,
                int n_supers, int n_supers2, int tris_per_chunk,
                int supers_per, int supers2_per, int stride, double eps,
                void* stream) {
  WbvhParams<T> p;
  p.g.cboxes = static_cast<const float*>(cboxes);
  p.g.sboxes = static_cast<const float*>(sboxes);
  p.g.ssboxes = static_cast<const float*>(ssboxes);
  p.g.n_chunks = n_chunks;
  p.g.n_supers = n_supers;
  p.g.n_supers2 = n_supers2;
  p.g.supers_per = supers_per;
  p.g.supers2_per = supers2_per;
  const int err = check_grid(p.g, tris_per_chunk);
  if (err != 0) return err;
  if (n < 1 || tris == nullptr || (stride != TRI_F && stride != TRI_ATTR_F) ||
      (attrs != nullptr && stride != TRI_ATTR_F)) {
    return cudaErrorInvalidValue;
  }
  p.n = n;
  p.eps = static_cast<T>(eps);
  p.tpc = tris_per_chunk;
  p.stride = stride;
  p.shared_boxes = boxes_fit_shared(p.g);
  const size_t smem = p.shared_boxes ? static_cast<size_t>(box_bytes(p.g)) : 0;
  const auto grid = static_cast<unsigned>((n + BLOCK - 1) / BLOCK);
  wbvh_kernel<T><<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rays), static_cast<const float*>(tris),
      static_cast<T*>(tmin), static_cast<int32_t*>(hit), static_cast<T*>(attrs),
      static_cast<int32_t*>(stats), p);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError()
// after the launch (0 = success); the wrapper raises on anything else.
// Pointers and the stream arrive as void*; attrs and stats may be null.
extern "C" {

int apt_wbvh_attr_count() { return N_ATTR; }
const char* apt_wbvh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#define APT_WBVH(SUFFIX, T)                                                    \
  int apt_wbvh_##SUFFIX(const void* rays, const void* cboxes,                  \
                        const void* sboxes, const void* ssboxes,               \
                        const void* tris, void* tmin, void* hit, void* attrs,  \
                        void* stats, long long n, int n_chunks, int n_supers,  \
                        int n_supers2, int tris_per_chunk, int supers_per,     \
                        int supers2_per, int stride, double eps,               \
                        void* stream) {                                        \
    return launch_wbvh<T>(rays, cboxes, sboxes, ssboxes, tris, tmin, hit,      \
                          attrs, stats, n, n_chunks, n_supers, n_supers2,      \
                          tris_per_chunk, supers_per, supers2_per, stride,     \
                          eps, stream);                                        \
  }

APT_WBVH(f32, float)
APT_WBVH(f64, double)

}  // extern "C"
