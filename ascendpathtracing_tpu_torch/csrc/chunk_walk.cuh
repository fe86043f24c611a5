// The chunk grid's tests and tables, shared by the warp walk
// (warp_walk.cuh) of the traversal kernel (wbvh.cu) and of the fused
// sphere+mesh path tracer (mesh_pt.cu), and by the BVH kernel (bvh.cu):
// the slab test of a box, the precomputed-plane triangle test, the box
// tables of 1-3 levels (ops/chunk_grid.py builds them) and their copy to
// shared memory.  Same parity rule as the kernels: -fmad=false, IEEE
// division, the Pallas kernels' op order (pallas_wbvh.py:293-329 and
// :626-651).
//
// Order.  The Pallas kernels list the hit chunks of a ray tile in
// increasing chunk index (compact_worklist: supers in order, then each
// hit super's chunks) and keep the running minimum with a strict
// t < tmin, so the lowest slot wins a tie; the plain twin
// (ops/wbvh_kernels.walk_plain) walks each ray that way, and the warp
// walk's lexicographic (t, slot) minimum gives the same winners.  Gating
// is per ray: a chunk is tested for a ray when that ray's own slab test
// passes (the Pallas kernels list it for the whole 1024/2048-ray tile
// when any lane's test passes); the two differ only if a ray hits a
// triangle inside a box its own slab test rejects by rounding.  The
// twin gates per ray too, so kernel and twin stay bitwise equal.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TRI_F = 13;       // v0 xyz, n xyz, s1 xyz, s2 xyz, d0
constexpr int TRI_ATTR_F = 24;  // + unit normal, albedo, emission, 2 one-hots
constexpr int N_ATTR = TRI_ATTR_F - TRI_F;  // 11 winner attribute planes
// Boxes go to dynamic shared memory when they fit in this (s4: 340 boxes,
// 8 KB); larger tables are read from global memory through L1.
constexpr int MAX_SHARED_BOX_BYTES = 40 * 1024;

// min/max that return NaN when either side is NaN (jnp.minimum/maximum,
// torch.minimum/maximum): a NaN slab bound then fails the test.
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a < b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// box_hit's min and max: nan_min and nan_max.
struct NanMinMax {
  template <typename T>
  static __device__ __forceinline__ T lo(T a, T b) {
    return nan_min(a, b);
  }
  template <typename T>
  static __device__ __forceinline__ T hi(T a, T b) {
    return nan_max(a, b);
  }
};

// A ray with the slab test's inverse direction, 1 / (d == 0 ? 1e-30 : d).
template <typename T>
struct RayInv {
  T ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

template <typename T>
__device__ __forceinline__ RayInv<T> make_ray(T ox, T oy, T oz, T dx, T dy,
                                              T dz) {
  RayInv<T> r;
  r.ox = ox;
  r.oy = oy;
  r.oz = oz;
  r.dx = dx;
  r.dy = dy;
  r.dz = dz;
  r.ix = T(1) / (dx == T(0) ? T(1e-30) : dx);
  r.iy = T(1) / (dy == T(0) ? T(1e-30) : dy);
  r.iz = T(1) / (dz == T(0) ? T(1e-30) : dz);
  return r;
}

// The slab interval [tnear, tfar] of box b (min xyz, max xyz; float32,
// widened to T) along the ray; MM gives the NaN-propagating min and max.
template <typename MM, typename T>
__device__ __forceinline__ void slab(const float* b, const RayInv<T>& r, T& tnear,
                                     T& tfar) {
  const T t1x = (T(b[0]) - r.ox) * r.ix;
  const T t2x = (T(b[3]) - r.ox) * r.ix;
  const T t1y = (T(b[1]) - r.oy) * r.iy;
  const T t2y = (T(b[4]) - r.oy) * r.iy;
  const T t1z = (T(b[2]) - r.oz) * r.iz;
  const T t2z = (T(b[5]) - r.oz) * r.iz;
  tnear = MM::hi(MM::hi(MM::lo(t1x, t2x), MM::lo(t1y, t2y)), MM::lo(t1z, t2z));
  tfar = MM::lo(MM::lo(MM::hi(t1x, t2x), MM::hi(t1y, t2y)), MM::hi(t1z, t2z));
}

// Slab test of box b: _slab, or with kBounded the mesh path tracer's
// entry bound tnear < gate as well (_slab_tmin).
template <bool kBounded, typename MM = NanMinMax, typename T>
__device__ __forceinline__ bool box_hit(const float* b, const RayInv<T>& r,
                                        T gate) {
  T tnear, tfar;
  slab<MM>(b, r, tnear, tfar);
  const bool hit = tfar >= MM::hi(tnear, T(0));
  return kBounded ? (hit && tnear < gate) : hit;
}

// A triangle row read at each use through the read-only cache (any row):
// v0 xyz, n xyz, s1 xyz, s2 xyz, d0 at [0, 13).
struct RowRef {
  const float* __restrict__ p;
  __device__ __forceinline__ float operator[](int i) const { return __ldg(p + i); }
};

// The precomputed-plane test of one triangle row (a RowRef, or values
// already loaded) against a ray: t = (d0 - n.o) / (n.d) with no guard (a
// zero pad row gives 0/0 = NaN, which fails every compare), w = (o - v0)
// + t d, u = s1.w, v = s2.w.  True where the ray hits with t > eps.  The
// row is float32, widened to T.
template <typename T, typename Row>
__device__ __forceinline__ bool tri_hit(const Row& q, T ox, T oy, T oz, T dx,
                                        T dy, T dz, T eps, T& t) {
  const T nx = T(q[3]);
  const T ny = T(q[4]);
  const T nz = T(q[5]);
  const T nd = nx * dx + ny * dy + nz * dz;
  const T no = nx * ox + ny * oy + nz * oz;
  t = (T(q[12]) - no) / nd;
  const T wx = (ox - T(q[0])) + t * dx;
  const T wy = (oy - T(q[1])) + t * dy;
  const T wz = (oz - T(q[2])) + t * dz;
  const T u = T(q[6]) * wx + T(q[7]) * wy + T(q[8]) * wz;
  const T v = T(q[9]) * wx + T(q[10]) * wy + T(q[11]) * wz;
  return u >= T(0) && v >= T(0) && u + v <= T(1) && t > eps;
}

// The box tables of a chunk grid and its level sizes.  n_supers == 0: one
// level; n_supers2 == 0: at most two (n_chunks == n_supers * supers_per
// and n_supers == n_supers2 * supers2_per where a level exists).
struct ChunkGrid {
  const float* cboxes;
  const float* sboxes;
  const float* ssboxes;
  int n_chunks, n_supers, n_supers2, supers_per, supers2_per;
};

// A walk that records no counts.
struct NoCounts {
  __device__ __forceinline__ void chunk(int) const {}
  __device__ __forceinline__ void super(int) const {}
  __device__ __forceinline__ void super2(int) const {}
};

// Bytes of the grid's boxes, and whether they go to shared memory.
inline long long box_bytes(const ChunkGrid& g) {
  return 6LL * sizeof(float) * (g.n_chunks + g.n_supers + g.n_supers2);
}

inline bool boxes_fit_shared(const ChunkGrid& g) {
  return box_bytes(g) <= MAX_SHARED_BOX_BYTES;
}

// The block copies the boxes into dynamic shared memory `smem` when
// `use` (uniform over the block) and syncs; returns the grid to walk.
__device__ __forceinline__ ChunkGrid boxes_to_shared(ChunkGrid g, float* smem,
                                                     bool use) {
  if (use) {
    const int nc = 6 * g.n_chunks;
    const int ns = 6 * g.n_supers;
    const int nss = 6 * g.n_supers2;
    for (int i = threadIdx.x; i < nc + ns + nss; i += blockDim.x) {
      smem[i] = i < nc ? g.cboxes[i]
                       : (i < nc + ns ? g.sboxes[i - nc] : g.ssboxes[i - nc - ns]);
    }
    g.cboxes = smem;
    g.sboxes = smem + nc;
    g.ssboxes = smem + nc + ns;
  }
  __syncthreads();
  return g;
}

// Host-side check of a grid's sizes; 0 or an error code.
inline int check_grid(const ChunkGrid& g, int tpc) {
  if (g.n_chunks < 1 || tpc < 1 || g.n_supers < 0 || g.n_supers2 < 0 ||
      g.cboxes == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (g.n_supers && (g.sboxes == nullptr || g.supers_per < 1 ||
                     g.n_supers * g.supers_per != g.n_chunks)) {
    return cudaErrorInvalidValue;
  }
  if (g.n_supers2 && (g.n_supers == 0 || g.ssboxes == nullptr ||
                      g.supers2_per < 1 ||
                      g.n_supers2 * g.supers2_per != g.n_supers)) {
    return cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace
