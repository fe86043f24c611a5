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
// The walk.  The TPU kernel walks the node array in lockstep (a scalar
// loop over nodes, each ray's divergence kept in a skip cursor, a global
// min(skip) jump) because Mosaic has no per-lane gather.  A ray is active
// at node i iff its cursor is <= i, and the loop only moves forward, so
// each ray visits exactly the nodes of its own stackless walk, in the same
// increasing order.  Here each lane runs that walk for its ray:
//   node <- (box hit at an inner node) ? node + 1 : miss[node]
// with the box test gated by the ray's running tmin (tnear < tmin).
//
// The leaves.  A thread that tests its leaf's triangles one after another
// keeps its warp waiting: on the bounce-1 rays of the s4 cell (max_leaf
// 64) a few percent of the rays enter a leaf, and a warp ran their 64-128
// tests in sequence while ~30 lanes idled (54x the byte bound).  So the
// warp pools its leaf tests:
//
// 1. Each lane advances over nodes until it stands at a leaf whose box it
//    hits, or leaves the tree.
// 2. Each leaf lane has c = min(count, max_leaf) tests; a shuffle scan
//    of the c gives each its offset in the warp's sum.  Where the lanes'
//    own tests would fill at least half of the warp's max(c) steps (a
//    coherent warp, most lanes in a leaf), each lane tests its own leaf
//    in order, as the per-thread walk does.  Else the leaf lanes are
//    listed in lane order (__ballot_sync and a __popc prefix).
// 3. The warp runs the listed (ray, triangle) pairs 32 a round; a lane
//    finds its pair's entry from a __reduce_or_sync mask of the entries
//    that start in the round, reads the ray from the entry's lane with
//    __shfl_sync, runs Moller-Trumbore in the Pallas kernel's op order,
//    and folds a hit into the entry's lexicographic minimum of (key(t),
//    leaf-order index), one 64-bit word in shared memory (a
//    compare-and-swap loop, min_key).  key is warp_walk.cuh's
//    order-preserving t_bits<true> (eps may be <= 0, so t may be <= 0;
//    -0 counts as +0).
// 4. Each leaf lane takes the minimum where its key is below its tmin's,
//    a winner at t == 0 taking its t again from its row (the sign of its
//    zero), and moves to miss[node].
//
// Why this is the per-thread walk's answer bit for bit: within one leaf,
// the strict t < tmin in increasing index keeps the smallest t below the
// entry tmin and the lowest index among equal t; the lexicographic
// minimum of the hits, accepted where it beats the entry tmin, is the same
// pair, whatever order the pairs ran in.  The next node's box test then
// sees the same tmin, so every ray visits the same nodes.  (The twin keeps
// the first of a leaf's smallest t and accepts it if it beats tmin: the
// same pair again.)
//
// Memory: nodes (36 B) and triangle rows (36 B) are read through the
// read-only cache; at the s4 cell (253 nodes, 5,120 triangles) they stay
// in L1 and L2.  A copy of the node table to shared memory in every
// block, and a grid of resident blocks whose warps loop over tiles (so
// that a block copies it once), were both slower (PERF.md, section 6).
// Outputs: tmin [N] (1e20 on a miss), hit [N] int32 (the leaf-order
// triangle index, 0 on a miss).  Any N.
//
// Bound on the H100: HBM traffic is the rays (24 B) and outputs (8 B) per
// ray; ~20 operations per node visited and ~30 per triangle tested.

#include <cuda_runtime.h>

#include <cstdint>

#include "chunk_walk.cuh"  // nan_min/nan_max, RayInv, make_ray, box_hit
#include "sphere_hit.cuh"  // BLOCK, miss_t
#include "warp_walk.cuh"   // WARP, FULL_MASK, lane_id, t_bits, from_bits

namespace {

struct BvhParams {
  long long n;
  int n_nodes, max_leaf;
  float eps;
};

// Words of one node: bmin xyz, bmax xyz (float), then first, count, miss
// (int) in a second table.
constexpr int NODE_F = 6, NODE_I = 3;
constexpr unsigned long long NO_KEY = ~0ull;

// The leaf entries of one warp's pooled tests.
struct WarpLeaves {
  int2 entry[WARP];               // (first triangle - first pair, lane)
  unsigned long long best[WARP];  // key(t) << 32 | index, the entry's minimum
};

// Moller-Trumbore of triangle row (v0 xyz, e1 xyz, e2 xyz) in the Pallas
// kernel's op order (pallas_bvh.py:93-113): true where the ray hits it at
// t > eps.
__device__ __forceinline__ bool triangle_t(const float* __restrict__ tri, float ox, float oy,
                                           float oz, float dx, float dy, float dz, float eps,
                                           float& t) {
  const float ax = __ldg(tri + 0);
  const float ay = __ldg(tri + 1);
  const float az = __ldg(tri + 2);
  const float e1x = __ldg(tri + 3);
  const float e1y = __ldg(tri + 4);
  const float e1z = __ldg(tri + 5);
  const float e2x = __ldg(tri + 6);
  const float e2y = __ldg(tri + 7);
  const float e2z = __ldg(tri + 8);
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool parallel = fabsf(det) < 1e-12f;
  const float invd = parallel ? 0.0f : 1.0f / det;
  const float tx = ox - ax;
  const float ty = oy - ay;
  const float tz = oz - az;
  const float u = (tx * px + ty * py + tz * pz) * invd;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (dx * qx + dy * qy + dz * qz) * invd;
  t = (e2x * qx + e2y * qy + e2z * qz) * invd;
  return !parallel && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > eps;
}

// *word = min(*word, key) for a word in shared memory, by compare and
// swap: atomicMin on a 64-bit shared word lost minima on the H100
// (chip_smoke's card tests of this kernel; the CAS loop passes them).
__device__ __forceinline__ void min_key(unsigned long long* word, unsigned long long key) {
  unsigned long long cur = *word;
  while (key < cur) {
    const unsigned long long seen = atomicCAS(word, cur, key);
    if (seen == cur) break;
    cur = seen;
  }
}

__global__ void __launch_bounds__(BLOCK)
    bvh_kernel(const float* __restrict__ rays, const float* __restrict__ nodesf,
               const int32_t* __restrict__ nodesi, const float* __restrict__ tris,
               float* __restrict__ tmin_out, int32_t* __restrict__ hit_out,
               const BvhParams p) {
  __shared__ WarpLeaves leaves[BLOCK / WARP];
  WarpLeaves& L = leaves[threadIdx.x / WARP];
  const int lane = lane_id();
  const long long n = p.n;
  const long long w = static_cast<long long>(blockIdx.x) * (BLOCK / WARP) + threadIdx.x / WARP;
  if (w * WARP >= n) return;  // the whole warp
  const long long i = w * WARP + lane;
  const bool mine = i < n;
  const RayInv<float> r = mine ? make_ray(rays[i], rays[n + i], rays[2 * n + i],
                                          rays[3 * n + i], rays[4 * n + i], rays[5 * n + i])
                               : make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
  float tmin = miss_t<float>();
  int hit = 0;
  int node = mine ? 0 : p.n_nodes;
  for (;;) {
    // 1. To the next leaf whose box the ray hits (_traverse_kernel's
    // box_hit: tfar >= max(tnear, 0) && tnear < tmin), or out.
    int first = 0, count = 0;
    while (node < p.n_nodes) {
      float b[NODE_F];
#pragma unroll
      for (int a = 0; a < NODE_F; ++a) b[a] = __ldg(nodesf + NODE_F * node + a);
      const bool box = box_hit<true>(b, r, tmin);
      first = __ldg(nodesi + NODE_I * node);
      count = __ldg(nodesi + NODE_I * node + 1);
      if (box && count > 0) break;
      node = box ? node + 1 : __ldg(nodesi + NODE_I * node + 2);
    }
    const bool at_leaf = node < p.n_nodes;
    const unsigned at = __ballot_sync(FULL_MASK, at_leaf);
    if (at == 0) break;
    const int c = at_leaf ? (count < p.max_leaf ? count : p.max_leaf) : 0;
    const int cmax = __reduce_max_sync(FULL_MASK, static_cast<unsigned>(c));
    int end = c;  // inclusive scan of the tests
#pragma unroll
    for (int o = 1; o < WARP; o <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, end, o);
      if (lane >= o) end += v;
    }
    const int total = __shfl_sync(FULL_MASK, end, WARP - 1);
    if (2 * total > WARP * cmax) {
      // The lanes' own leaves fill at least half of each of cmax steps:
      // each lane tests its leaf in order, keeping a strictly smaller t.
      for (int k = 0; k < c; ++k) {
        float t;
        if (triangle_t(tris + 9LL * (first + k), r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, p.eps, t) &&
            t < tmin) {
          tmin = t;
          hit = first + k;
        }
      }
    } else {
      // 2. The leaf entries in lane order: (first - start, lane), where
      // start is the entry's first pair in the warp's sum.
      const int e = __popc(at & ((1u << lane) - 1u));
      const int start = end - c;
      if (at_leaf) {
        L.entry[e] = make_int2(first - start, lane);
        L.best[e] = NO_KEY;
      }
      __syncwarp();
      // 3. The pooled (ray, triangle) pairs, 32 a round.  Pair g is in
      // the last entry starting at or before g: `entries` counts those
      // starting at or before base, bit j of m one starting at base+1+j.
      int entries = 1;
      for (int base = 0; base < total; base += WARP) {
        const int sj = start - base - 1;
        const unsigned m = __reduce_or_sync(
            FULL_MASK, at_leaf && sj >= 0 && sj < WARP ? 1u << sj : 0u);
        const int k = entries - 1 + __popc(m & ((1u << lane) - 1u));
        entries += __popc(m);
        const int2 ent = L.entry[k];
        const float ox = __shfl_sync(FULL_MASK, r.ox, ent.y);
        const float oy = __shfl_sync(FULL_MASK, r.oy, ent.y);
        const float oz = __shfl_sync(FULL_MASK, r.oz, ent.y);
        const float dx = __shfl_sync(FULL_MASK, r.dx, ent.y);
        const float dy = __shfl_sync(FULL_MASK, r.dy, ent.y);
        const float dz = __shfl_sync(FULL_MASK, r.dz, ent.y);
        const int tidx = ent.x + base + lane;
        float t;
        if (base + lane < total &&
            triangle_t(tris + 9LL * tidx, ox, oy, oz, dx, dy, dz, p.eps, t)) {
          min_key(&L.best[k], t_bits<true>(t) << 32 | static_cast<unsigned>(tidx));
        }
      }
      __syncwarp();
      // 4. Each leaf lane takes its minimum if it beats tmin.
      if (at_leaf) {
        const unsigned long long b = L.best[e];
        if (b != NO_KEY && (b >> 32) < t_bits<true>(tmin)) {
          hit = static_cast<int>(b & 0xffffffffu);
          from_bits<true>(b >> 32, tmin);
          if (tmin == 0.0f) {  // the sign of a winning zero, from its row
            triangle_t(tris + 9LL * hit, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, p.eps, tmin);
          }
        }
      }
      __syncwarp();  // the entries are read before the next leaves write them
    }
    if (at_leaf) node = __ldg(nodesi + NODE_I * node + 2);
  }
  if (mine) {
    tmin_out[i] = tmin;
    hit_out[i] = hit;
  }
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
