// The chunk-grid walk shared by the traversal kernel (wbvh.cu) and the
// fused sphere+mesh path tracer (mesh_pt.cu): the slab test of a box, the
// precomputed-plane triangle test, and a per-thread walk over 1-3 levels
// of boxes (ops/chunk_grid.py builds the tables).  Same parity rule as
// the kernels: -fmad=false, IEEE division, the Pallas kernels' op order
// (pallas_wbvh.py:293-329 and :626-651).
//
// Order.  The Pallas kernels list the hit chunks of a ray tile in
// increasing chunk index (compact_worklist: supers in order, then each
// hit super's chunks) and keep the running minimum with a strict
// t < tmin, so the lowest slot wins a tie.  The walk visits chunks in
// that same increasing order.  Gating is per ray: a chunk is tested for
// a ray when that ray's own slab test passes (the Pallas kernels list it
// for the whole 1024/2048-ray tile when any lane's test passes); the
// two differ only if a ray hits a triangle inside a box its own slab
// test rejects by rounding.  The plain twin (ops/wbvh_kernels.py) gates
// per ray too, so kernel and twin stay bitwise equal.

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

// Slab test of box b (min xyz, max xyz; float32, widened to T).
// kBounded adds the mesh path tracer's entry bound tnear < gate
// (_slab_tmin); otherwise it is _slab.
template <bool kBounded, typename T>
__device__ __forceinline__ bool box_hit(const float* b, const RayInv<T>& r,
                                        T gate) {
  const T t1x = (T(b[0]) - r.ox) * r.ix;
  const T t2x = (T(b[3]) - r.ox) * r.ix;
  const T t1y = (T(b[1]) - r.oy) * r.iy;
  const T t2y = (T(b[4]) - r.oy) * r.iy;
  const T t1z = (T(b[2]) - r.oz) * r.iz;
  const T t2z = (T(b[5]) - r.oz) * r.iz;
  const T tnear =
      nan_max(nan_max(nan_min(t1x, t2x), nan_min(t1y, t2y)), nan_min(t1z, t2z));
  const T tfar =
      nan_min(nan_min(nan_max(t1x, t2x), nan_max(t1y, t2y)), nan_max(t1z, t2z));
  const bool hit = tfar >= nan_max(tnear, T(0));
  return kBounded ? (hit && tnear < gate) : hit;
}

// The triangles of chunk c against the ray: t = (d0 - n.o) / (n.d) with
// no guard (a zero pad row gives 0/0 = NaN, which fails every compare),
// w = (o - v0) + t d, u = s1.w, v = s2.w.  A hit with t < tmin replaces
// the running winner.  Rows are float32, widened to T, `stride` floats
// apart; read through the read-only cache.
template <typename T>
__device__ __forceinline__ void test_chunk(const float* __restrict__ tris,
                                           int stride, int c, int tpc,
                                           const RayInv<T>& r, T eps,
                                           T& tmin, int& slot) {
  const int base = c * tpc;
  for (int j = 0; j < tpc; ++j) {
    const float* row = tris + static_cast<long long>(base + j) * stride;
    const T nx = T(__ldg(row + 3));
    const T ny = T(__ldg(row + 4));
    const T nz = T(__ldg(row + 5));
    const T nd = nx * r.dx + ny * r.dy + nz * r.dz;
    const T no = nx * r.ox + ny * r.oy + nz * r.oz;
    const T t = (T(__ldg(row + 12)) - no) / nd;
    const T wx = (r.ox - T(__ldg(row + 0))) + t * r.dx;
    const T wy = (r.oy - T(__ldg(row + 1))) + t * r.dy;
    const T wz = (r.oz - T(__ldg(row + 2))) + t * r.dz;
    const T u = T(__ldg(row + 6)) * wx + T(__ldg(row + 7)) * wy +
                T(__ldg(row + 8)) * wz;
    const T v = T(__ldg(row + 9)) * wx + T(__ldg(row + 10)) * wy +
                T(__ldg(row + 11)) * wz;
    if (u >= T(0) && v >= T(0) && u + v <= T(1) && t > eps && t < tmin) {
      tmin = t;
      slot = base + j;
    }
  }
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

// Per-ray walk counts: chunks tested, supers hit, super-supers hit (the
// Pallas kernels' per-tile worklist length k and phase-A trip counts).
struct WalkCounts {
  int k, ks, kss;

  __device__ __forceinline__ void chunk(int) { ++k; }
  __device__ __forceinline__ void super(int) { ++ks; }
  __device__ __forceinline__ void super2(int) { ++kss; }
};

// A walk that records nothing.
struct NoCounts {
  __device__ __forceinline__ void chunk(int) const {}
  __device__ __forceinline__ void super(int) const {}
  __device__ __forceinline__ void super2(int) const {}
};

// Calls chunk(c) for every chunk whose box the ray enters, in increasing
// c; a chunk is reached only through a hit super (and super-super).
// cnt.chunk / super / super2 hear of each box the ray enters.
template <bool kBounded, typename T, typename ChunkFn, typename Counts>
__device__ __forceinline__ void walk_chunks(const ChunkGrid& g,
                                            const RayInv<T>& r, T gate,
                                            ChunkFn&& chunk, Counts&& cnt) {
  auto chunks = [&](int c0, int c1) {
    for (int c = c0; c < c1; ++c) {
      if (box_hit<kBounded>(g.cboxes + 6 * c, r, gate)) {
        cnt.chunk(c);
        chunk(c);
      }
    }
  };
  auto supers = [&](int s0, int s1) {
    for (int s = s0; s < s1; ++s) {
      if (box_hit<kBounded>(g.sboxes + 6 * s, r, gate)) {
        cnt.super(s);
        chunks(s * g.supers_per, (s + 1) * g.supers_per);
      }
    }
  };
  if (g.n_supers == 0) {
    chunks(0, g.n_chunks);
  } else if (g.n_supers2 == 0) {
    supers(0, g.n_supers);
  } else {
    for (int s2 = 0; s2 < g.n_supers2; ++s2) {
      if (box_hit<kBounded>(g.ssboxes + 6 * s2, r, gate)) {
        cnt.super2(s2);
        supers(s2 * g.supers2_per, (s2 + 1) * g.supers2_per);
      }
    }
  }
}

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
