// The chunk-grid walk of the fused sphere+mesh path tracer (mesh_pt.cu)
// and of the traversal kernel (wbvh.cu), done by a warp for its 32 rays
// together.  Same parity rule as the kernels:
// -fmad=false, IEEE division; the box and triangle tests are
// chunk_walk.cuh's box_hit and tri_hit, op for op (the boxes' min and
// max as single instructions, HwNanMinMax).
//
// A walk per thread (each lane looping over its own chunk list, as the
// twin ops/wbvh_kernels.walk_plain walks each ray) makes a warp run the
// union of its lanes' chunk lists one after another: at the s4 cell ~7.5 chunks x 16 triangle tests per
// bounce where each lane needs ~0.24 x 16 (PERF.md: the kstats record of
// that cell).  Here the warp pools its lanes' work in shared memory:
//
// 1. Each lane tests its ray against the root box, the union of the top
//    level's boxes, and the lanes that enter it are listed.
// 2. Level by level, the warp expands each listed (lane, box) entry over
//    the box's children, 32 (ray, child box) pairs a step, and lists a
//    (lane, child) entry for every child box the ray enters: the top
//    level's boxes under the root, then the supers under a super-super,
//    the chunks under a super.  A list is __ballot_sync + a __popc prefix
//    into a queue in shared memory.
// 3. The warp expands the (lane, chunk) entries over the chunks'
//    triangles, 32 (ray, triangle) pairs a step, and keeps each ray's
//    lexicographic minimum of (t, slot) in shared memory.
//
// The steps take the shallowest level that has work and room in the
// queue below it, so the queues fill before they are worked off; each
// holds QUEUE_CAP entries, and none is dropped.  A lane reads the ray of
// the pair it tests from the ray's own lane with __shfl_sync.
//
// The root only filters: a box nests in the root, and the slab test is
// monotone in the box's bounds through rounding, so a ray that enters a
// box enters the root; where the root's test meets a NaN the ray counts
// as entering.  Boxes are gated (kBounded) by the ray's sphere tmin in
// the path tracer, never by a running triangle minimum
// (pallas_mesh_pt.py:310-321), and not at all in the traversal kernel
// (as in the twin's walk_plain), so the set of pairs tested does not
// depend on the order they run in.  The minimum: an atomicMin on a key
// of t that orders as its value (t_bits), then, among the pairs at that
// key, an atomicMin on the slot.  That is the smallest t below the gate
// and the lowest slot on a tie, whatever the order of the pairs: the
// per-thread walk's strict t < tmin in increasing slot order gives the
// same answer.  In the traversal kernel, whose eps may be negative, a
// winner at t == 0 takes its t again from its row, which gives the sign
// of its zero back.

#pragma once

#include <cuda_runtime.h>

#include <climits>

#include "chunk_walk.cuh"

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
// Entries of one warp's queue (4 bytes each).  A step appends at most 32,
// so a queue is worked off when it holds more than QUEUE_CAP - 32.
constexpr int QUEUE_CAP = 128;
constexpr unsigned long long NO_T = ~0ull;

// One warp's worklist in shared memory.  An entry is item << 5 | lane.
struct WarpList {
  int roots[WARP];                  // the lanes whose ray enters the root
  int queue[3][QUEUE_CAP];          // (lane, box) entries of levels 1-3
  unsigned long long best_t[WARP];  // each ray's smallest t so far, as bits
  int best_slot[WARP];              // the lowest slot at that t
  float root[6];                    // the union of the top level's boxes
};

// The root is computed where the top level has at most this many boxes
// (each warp reads them once); above, every ray counts as entering it.
constexpr int ROOT_MAX_BOXES = 4096;

// Queue overflows since the last reset: [0] the queues of box entries
// above the chunks, [1] the chunk queue (one count each time a warp
// filled one).
__device__ unsigned long long queue_overflows[2];

// The key of t that atomicMin orders: in the path tracer (kAnyT false) a
// valid t is finite and > eps > 0, so its bit pattern orders as its value;
// in the traversal kernel (kAnyT, any eps) the bits with the sign bit
// flipped, all bits for a negative t, and -0 taken as +0.
template <bool kAnyT>
__device__ __forceinline__ unsigned long long t_bits(float t) {
  if constexpr (!kAnyT) return __float_as_uint(t);
  const unsigned b = __float_as_uint(t + 0.0f);  // -0 + 0 == +0
  return (b >> 31) ? ~b : (b | 0x80000000u);
}
template <bool kAnyT>
__device__ __forceinline__ unsigned long long t_bits(double t) {
  if constexpr (!kAnyT) return static_cast<unsigned long long>(__double_as_longlong(t));
  const auto b = static_cast<unsigned long long>(__double_as_longlong(t + 0.0));
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}
template <bool kAnyT>
__device__ __forceinline__ void from_bits(unsigned long long k, float& t) {
  const auto b = static_cast<unsigned>(k);
  t = __uint_as_float(!kAnyT ? b : ((b >> 31) ? (b & 0x7fffffffu) : ~b));
}
template <bool kAnyT>
__device__ __forceinline__ void from_bits(unsigned long long k, double& t) {
  t = __longlong_as_double(static_cast<long long>(
      !kAnyT ? k : ((k >> 63) ? (k & 0x7fffffffffffffffull) : ~k)));
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & (WARP - 1); }

// The warp walk's box tests take min.NaN / max.NaN for float (one
// instruction where nan_min and nan_max take three): the same NaN rule,
// and a sign of zero they may differ in changes no compare, so the same
// hits.
struct HwNanMinMax {
  static __device__ __forceinline__ float lo(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
  }
  static __device__ __forceinline__ float hi(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
  }
  static __device__ __forceinline__ double lo(double a, double b) { return nan_min(a, b); }
  static __device__ __forceinline__ double hi(double a, double b) { return nan_max(a, b); }
};

// Appends `value` for every lane where `pred`, in lane order; n (the
// queue's length, the same on every lane) grows by their count.
__device__ __forceinline__ void push(int* queue, int& n, bool pred, int value) {
  const unsigned m = __ballot_sync(FULL_MASK, pred);
  if (pred) queue[n + __popc(m & ((1u << lane_id()) - 1u))] = value;
  n += __popc(m);
}

// A row of a 16-byte aligned table of 24-float rows (96 bytes, so every
// row is aligned), loaded at once: three 16-byte loads and one float
// through the read-only cache.
struct RowVals {
  float v[13];
  __device__ __forceinline__ float operator[](int i) const { return v[i]; }
};

__device__ __forceinline__ RowVals load_row16(const float* __restrict__ row) {
  const float4* q = reinterpret_cast<const float4*>(row);
  const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
  return RowVals{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w, __ldg(row + 12)}};
}

// The rows of a triangle table, by slot: 24-float rows from a 16-byte
// aligned table (load_row16), or rows of any stride read at each use
// through the read-only cache (RowRef; the 13-float rows, or a table
// that is not aligned).
struct Rows24 {
  const float* __restrict__ p;
  __device__ __forceinline__ RowVals operator()(int slot) const {
    return load_row16(p + static_cast<long long>(slot) * TRI_ATTR_F);
  }
};

struct RowsStrided {
  const float* __restrict__ p;
  int stride;
  __device__ __forceinline__ RowRef operator()(int slot) const {
    return RowRef{p + static_cast<long long>(slot) * stride};
  }
};

// Per-ray walk counts for the traversal kernel's stats: chunks tested,
// supers hit, super-supers hit (the twin's counts), in the
// warp's [3][WARP] shared counters; a lane counts for the ray of lane
// `lane` with an integer shared-memory atomicAdd (a sum of ones has no
// order).
struct RayCounts {
  int* c;
  int lane;

  __device__ __forceinline__ void chunk(int) const { atomicAdd(c + lane, 1); }
  __device__ __forceinline__ void super(int) const { atomicAdd(c + WARP + lane, 1); }
  __device__ __forceinline__ void super2(int) const { atomicAdd(c + 2 * WARP + lane, 1); }
};

// The stats marks of another lane's ray (for a box that lane's ray enters).
__device__ __forceinline__ NoCounts shfl_marks(NoCounts, int) { return NoCounts(); }

__device__ __forceinline__ RayCounts shfl_marks(RayCounts m, int src) {
  m.lane = src;
  return m;
}

template <typename Marks>
__device__ __forceinline__ Marks shfl_marks(Marks m, int src) {
  m.w = reinterpret_cast<unsigned*>(
      __shfl_sync(FULL_MASK, reinterpret_cast<unsigned long long>(m.w), src));
  return m;
}

// One step's (ray, triangle) candidates into their rays' minima: t first,
// then the slot among the pairs at the minimum t.  A step that lowers a
// ray's t voids the slot kept for the larger t.
template <bool kAnyT, typename T>
__device__ __forceinline__ void min_pairs(WarpList& L, bool ok, int src, T t, int slot) {
  const unsigned long long tb = ok ? t_bits<kAnyT>(t) : NO_T;
  const unsigned long long before = ok ? L.best_t[src] : NO_T;
  __syncwarp();
  if (ok) atomicMin(&L.best_t[src], tb);
  __syncwarp();
  const bool win = ok && tb == L.best_t[src];
  if (win && tb < before) L.best_slot[src] = INT_MAX;
  __syncwarp();
  if (win) atomicMin(&L.best_slot[src], slot);
}

// The root box of each warp (L.root) from the grid's top level, once per
// launch; the warp calls it together.
__device__ __forceinline__ void init_root(const ChunkGrid& g, WarpList& L) {
  const float* top = g.n_supers2 ? g.ssboxes : (g.n_supers ? g.sboxes : g.cboxes);
  const int n = g.n_supers2 ? g.n_supers2 : (g.n_supers ? g.n_supers : g.n_chunks);
  const float inf = __int_as_float(0x7f800000);
  float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
  if (n > ROOT_MAX_BOXES) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = -inf;
      hi[a] = inf;
    }
  } else {
    // min and max over both corners: the slab test swaps an inverted box's
    for (int b = lane_id(); b < n; b += WARP) {
      for (int a = 0; a < 3; ++a) {
        lo[a] = fminf(lo[a], fminf(top[6 * b + a], top[6 * b + a + 3]));
        hi[a] = fmaxf(hi[a], fmaxf(top[6 * b + a], top[6 * b + a + 3]));
      }
    }
    for (int o = WARP / 2; o > 0; o >>= 1) {
      for (int a = 0; a < 3; ++a) {
        lo[a] = fminf(lo[a], __shfl_xor_sync(FULL_MASK, lo[a], o));
        hi[a] = fmaxf(hi[a], __shfl_xor_sync(FULL_MASK, hi[a], o));
      }
    }
  }
  if (lane_id() == 0) {
    for (int a = 0; a < 3; ++a) {
      L.root[a] = lo[a];
      L.root[a + 3] = hi[a];
    }
  }
  __syncwarp();
}

// box_hit<kBounded>'s test of the root, true also where it meets a NaN.
template <bool kBounded, typename T>
__device__ __forceinline__ bool enters_root(const float* b, const RayInv<T>& r, T gate) {
  T tnear, tfar;
  slab<HwNanMinMax>(b, r, tnear, tfar);
  return !(tfar < HwNanMinMax::hi(tnear, T(0))) && !(kBounded && tnear >= gate);
}

// The walk over a grid of D box levels (1: chunks; 2: supers, chunks; 3:
// super-supers, supers, chunks).  Level 0 lists the lanes in the root,
// level i (1..D) the (lane, box) entries of box level i - 1 (from the
// top); n[i] entries, c[i] of their n[i] * per(i) pairs done.
template <int D, bool kBounded, typename T, typename Rows, typename Marks>
__device__ __forceinline__ void walk_levels(const ChunkGrid& g, WarpList& L,
                                            const Rows& rows, int tpc,
                                            const RayInv<T>& r, T gate, T eps,
                                            bool live, const Marks& marks) {
  const int lane = lane_id();
  // box level k (0 the top): its boxes, and its boxes under one entry of
  // level k (the root's: all of the top level's)
  const float* boxes[D];
  int per[D];
  if constexpr (D == 3) {
    boxes[0] = g.ssboxes;
    per[0] = g.n_supers2;
  }
  if constexpr (D >= 2) {
    boxes[D - 2] = g.sboxes;
    per[D - 2] = D == 3 ? g.supers2_per : g.n_supers;
  }
  boxes[D - 1] = g.cboxes;
  per[D - 1] = D == 1 ? g.n_chunks : g.supers_per;
  int n[D + 1], c[D + 1];
#pragma unroll
  for (int i = 0; i <= D; ++i) n[i] = c[i] = 0;
  push(L.roots, n[0], live && enters_root<kBounded>(L.root, r, gate), lane);
  for (;;) {
#pragma unroll
    for (int i = 1; i <= D; ++i) {  // a queue worked off starts again
      if (c[i] >= n[i] * (i < D ? per[i] : tpc)) n[i] = c[i] = 0;
    }
    // The shallowest level with pairs left and room below steps until it
    // has neither; the levels above it then have no work or no room.
    bool stepped = false;
#pragma unroll
    for (int k = 0; k < D; ++k) {  // box level k: level k's entries expand
      if (stepped) continue;
      const int* in = k == 0 ? L.roots : L.queue[k - 1];
      __syncwarp();  // level k's entries are written, the reads of level k + 1 done
      while (c[k] < n[k] * per[k] && n[k + 1] <= QUEUE_CAP - WARP) {
        stepped = true;
        const int i = c[k] + lane;
        const bool on = i < n[k] * per[k];
        int src = 0, box = 0;
        if (on) {
          const int e = in[i / per[k]];
          src = e & (WARP - 1);
          box = (e >> 5) * per[k] + i % per[k];
        }
        c[k] += WARP;
        RayInv<T> b;
        b.ox = __shfl_sync(FULL_MASK, r.ox, src);
        b.oy = __shfl_sync(FULL_MASK, r.oy, src);
        b.oz = __shfl_sync(FULL_MASK, r.oz, src);
        b.ix = __shfl_sync(FULL_MASK, r.ix, src);
        b.iy = __shfl_sync(FULL_MASK, r.iy, src);
        b.iz = __shfl_sync(FULL_MASK, r.iz, src);
        const T gt = __shfl_sync(FULL_MASK, gate, src);
        const Marks m = shfl_marks(marks, src);
        const bool hit = on && box_hit<kBounded, HwNanMinMax>(boxes[k] + 6 * box, b, gt);
        if (hit) {
          if (k == D - 1) {
            m.chunk(box);
          } else if (k == D - 2) {
            m.super(box);
          } else {
            m.super2(box);
          }
        }
        push(L.queue[k], n[k + 1], hit, box << 5 | src);
        if (n[k + 1] > QUEUE_CAP - WARP && lane == 0) {
          atomicAdd(&queue_overflows[k == D - 1 ? 1 : 0], 1ull);
        }
      }
    }
    if (stepped) continue;
    if (c[D] >= n[D] * tpc) break;  // nothing left
    // The chunk entries' (ray, triangle) pairs, 32 a step.
    __syncwarp();  // the chunk entries are written
    do {
      const int i = c[D] + lane;
      const bool on = i < n[D] * tpc;
      int src = 0, slot = 0;
      if (on) {
        const int e = L.queue[D - 1][i / tpc];
        src = e & (WARP - 1);
        slot = (e >> 5) * tpc + i % tpc;
      }
      c[D] += WARP;
      const T ox = __shfl_sync(FULL_MASK, r.ox, src);
      const T oy = __shfl_sync(FULL_MASK, r.oy, src);
      const T oz = __shfl_sync(FULL_MASK, r.oz, src);
      const T dx = __shfl_sync(FULL_MASK, r.dx, src);
      const T dy = __shfl_sync(FULL_MASK, r.dy, src);
      const T dz = __shfl_sync(FULL_MASK, r.dz, src);
      const T gt = __shfl_sync(FULL_MASK, gate, src);
      T t = T(0);
      const bool ok = on && tri_hit(rows(slot), ox, oy, oz, dx, dy, dz, eps, t) && t < gt;
      if (__any_sync(FULL_MASK, ok)) min_pairs<!kBounded>(L, ok, src, t, slot);
    } while (c[D] < n[D] * tpc);
  }
}

// The warp's walk: every lane calls it together, `live` false on a lane
// with no ray.  r is the lane's ray; `gate` the t a triangle must beat
// and, with kBounded, the entry bound of every box; rows(slot) a row of
// the [C*T, *] table.  Returns the lane's winning slot, -1 where no
// triangle beats the gate; tmin takes the winner's t.  marks hears of
// each box the ray enters (super-supers, supers, chunks).  L.root is
// init_root's.
template <bool kBounded, typename T, typename Rows, typename Marks>
__device__ __forceinline__ int walk_grid_warp(const ChunkGrid& g, WarpList& L,
                                              const Rows& rows, int tpc,
                                              const RayInv<T>& r, T gate, T eps,
                                              bool live, const Marks& marks, T& tmin) {
  const int lane = lane_id();
  L.best_t[lane] = NO_T;
  L.best_slot[lane] = INT_MAX;
  if (g.n_supers2) {
    walk_levels<3, kBounded>(g, L, rows, tpc, r, gate, eps, live, marks);
  } else if (g.n_supers) {
    walk_levels<2, kBounded>(g, L, rows, tpc, r, gate, eps, live, marks);
  } else {
    walk_levels<1, kBounded>(g, L, rows, tpc, r, gate, eps, live, marks);
  }
  __syncwarp();
  const unsigned long long b = L.best_t[lane];
  if (b == NO_T) return -1;
  const int slot = L.best_slot[lane];
  from_bits<!kBounded>(b, tmin);
  if constexpr (!kBounded) {  // the sign of a winning zero, from its row
    if (tmin == T(0)) tri_hit(rows(slot), r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, eps, tmin);
  }
  return slot;
}

// The path tracer's walk: boxes gated by the ray's sphere tmin `gate`,
// tris the [C*T, 24] rows (16-byte aligned).
template <typename T, typename Marks>
__device__ __forceinline__ int walk_chunks_warp(const ChunkGrid& g, WarpList& L,
                                                const float* __restrict__ tris,
                                                int tpc,
                                                const RayInv<T>& r, T gate,
                                                T eps, bool live, const Marks& marks,
                                                T& tmin) {
  return walk_grid_warp<true>(g, L, Rows24{tris}, tpc, r, gate, eps, live, marks, tmin);
}

}  // namespace
