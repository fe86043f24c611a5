// Hand-written Hopper (sm_90a) kernel of the stackless BVH traversal:
// closest hit of float32 rays [6, N] against a DFS-ordered binary BVH
// with miss links.  It replaces _traverse_kernel of
// ascendpathtracing_tpu/ops/pallas_bvh.py.
//
// Build (ops/build.py runs this at first use, into build/):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libbvh.so bvh.cu
//
// PARITY RULE, as in render_ref.cu: -fmad=false and never
// --use_fast_math; the Pallas kernel's op order (pallas_bvh.py:78-117), so
// the plain twin (ops/bvh_kernels.intersect_bvh_plain) gives the same tmin
// and hit bit for bit.
//
// Design.  The TPU kernel walks the node array in lockstep (a scalar loop
// over nodes, each ray's divergence kept in a skip cursor, a global
// min(skip) jump) because Mosaic has no per-lane gather.  A ray is active
// at node i iff its cursor is <= i, and the loop only moves forward, so
// each ray visits exactly the nodes of its own stackless walk, in the same
// increasing order.  Here one thread per ray runs that walk directly:
//   p <- (box hit at an inner node) ? p + 1 : miss[p]
// The box test uses the ray's running tmin (tnear < tmin); at a leaf whose
// box it hits, the ray tests the leaf's count (<= max_leaf) triangles in
// order with Moller-Trumbore and keeps a strictly smaller t.  Nodes and
// triangles are read through the read-only cache (__ldg); no shared-memory
// staging.  Outputs: tmin [N] (1e20 on a miss), hit [N] int32 (the
// leaf-order triangle index, 0 on a miss).  Any N.
//
// Bound on the H100: FP32 instruction throughput and divergence.  Per ray
// ~20 flops per node visited and ~30 per triangle tested; a warp runs as
// long as its longest walk.  HBM traffic is the rays (24 B) and outputs
// (8 B) per ray; the tables (s4, max_leaf 64: 253 nodes x 36 B, 5,120
// triangles x 36 B) stay in L1/L2.

#include <cuda_runtime.h>

#include <cstdint>

#include "chunk_walk.cuh"  // nan_min/nan_max, RayInv, make_ray, box_hit
#include "sphere_hit.cuh"  // BLOCK, miss_t

namespace {

struct BvhParams {
  long long n;
  int n_nodes, max_leaf;
  float eps;
};

// Moller-Trumbore of triangle row (v0 xyz, e1 xyz, e2 xyz) in the Pallas
// kernel's op order (pallas_bvh.py:93-113); replaces (tmin, hit) when the
// triangle is hit at t < tmin.
__device__ __forceinline__ void test_triangle(const float* __restrict__ tri,
                                              int tidx, const RayInv<float>& r,
                                              float eps, float& tmin,
                                              int& hit) {
  const float ax = __ldg(tri + 0);
  const float ay = __ldg(tri + 1);
  const float az = __ldg(tri + 2);
  const float e1x = __ldg(tri + 3);
  const float e1y = __ldg(tri + 4);
  const float e1z = __ldg(tri + 5);
  const float e2x = __ldg(tri + 6);
  const float e2y = __ldg(tri + 7);
  const float e2z = __ldg(tri + 8);
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool parallel = fabsf(det) < 1e-12f;
  const float invd = parallel ? 0.0f : 1.0f / det;
  const float tx = r.ox - ax;
  const float ty = r.oy - ay;
  const float tz = r.oz - az;
  const float u = (tx * px + ty * py + tz * pz) * invd;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * invd;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * invd;
  if (!parallel && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > eps &&
      t < tmin) {
    tmin = t;
    hit = tidx;
  }
}

__global__ void __launch_bounds__(BLOCK)
    bvh_kernel(const float* __restrict__ rays, const float* __restrict__ nodesf,
               const int32_t* __restrict__ nodesi, const float* __restrict__ tris,
               float* __restrict__ tmin_out, int32_t* __restrict__ hit_out,
               const BvhParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= p.n) return;
  const long long n = p.n;
  const RayInv<float> r = make_ray(rays[i], rays[n + i], rays[2 * n + i],
                                   rays[3 * n + i], rays[4 * n + i], rays[5 * n + i]);
  float tmin = miss_t<float>();
  int hit = 0;
  int node = 0;
  while (node < p.n_nodes) {
    float b[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) b[k] = __ldg(nodesf + 6 * node + k);
    const int first = __ldg(nodesi + 3 * node);
    const int count = __ldg(nodesi + 3 * node + 1);
    const int miss = __ldg(nodesi + 3 * node + 2);
    // _traverse_kernel's box_hit: tfar >= max(tnear, 0) && tnear < tmin,
    // decided before the leaf's triangles update tmin.
    const bool box = box_hit<true>(b, r, tmin);
    const bool leaf = count > 0;
    if (box && leaf) {
      const int c = count < p.max_leaf ? count : p.max_leaf;
      for (int k = 0; k < c; ++k) {
        test_triangle(tris + 9LL * (first + k), first + k, r, p.eps, tmin, hit);
      }
    }
    node = (box && !leaf) ? node + 1 : miss;
  }
  tmin_out[i] = tmin;
  hit_out[i] = hit;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError()
// after the launch (0 = success); the wrapper raises on anything else.
extern "C" {

const char* apt_bvh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int apt_bvh_f32(const void* rays, const void* nodesf, const void* nodesi,
                const void* tris, void* tmin, void* hit, long long n,
                int n_nodes, int n_tris, int max_leaf, double eps,
                void* stream) {
  if (n < 1 || n_nodes < 1 || n_tris < 1 || max_leaf < 1) {
    return cudaErrorInvalidValue;
  }
  BvhParams p;
  p.n = n;
  p.n_nodes = n_nodes;
  p.max_leaf = max_leaf;
  p.eps = static_cast<float>(eps);
  const auto grid = static_cast<unsigned>((n + BLOCK - 1) / BLOCK);
  bvh_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays), static_cast<const float*>(nodesf),
      static_cast<const int32_t*>(nodesi), static_cast<const float*>(tris),
      static_cast<float*>(tmin), static_cast<int32_t*>(hit), p);
  return cudaGetLastError();
}

}  // extern "C"
