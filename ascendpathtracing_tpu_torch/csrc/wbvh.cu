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
// Design: a warp walks the grid for its 32 rays together
// (warp_walk.cuh's walk_grid_warp): a root box per warp filters the rays,
// (lane, box) queues in shared memory pool the warp's boxes level by
// level, the warp tests 32 (ray, triangle) pairs a step, and each ray
// keeps the lexicographic (t, slot) minimum.  The boxes are not gated
// (the twin's slab test), so the pairs tested do not depend on their
// order and the winners are the twin's per-ray walk's, bit for bit.  A
// walk per thread runs, in each warp, the union of its 32 lanes' chunk
// lists one after another; on incoherent rays (the bounce-loop renderer's bounces
// 1-7, which are not sorted) that is most of a warp's time.  The box
// tables go to shared memory when they fit (s4: 340 boxes x 24 B; up to
// 40 KB, with the warps' queues past the 48 KB a launch gets without
// asking, so the launch asks); triangle rows (s4: 491 KB) stay in global
// memory: 24-float rows in three 16-byte loads and one float, other
// strides (13-float rows) a float at a time, through the read-only cache.
// The TPU kernel's residency modes, ray tiles and 128-box flag blocks have
// no counterpart: any N, any group size.  The 11 winner attributes are
// read from the winning row once after the walk (the Pallas kernel
// carries them through its loop; the values are the same copies).
// Outputs: tmin [N] (1e20 on a miss), slot [N] int32 (0 on a miss),
// optionally attrs [11, N] and per-ray counts [3, N] int32 (chunks
// tested, supers hit, super-supers hit; the walk's RayCounts, kept per
// warp in shared memory) in place of the TPU's per-tile [3, n_tiles].
// The times a warp filled a queue and worked it off before going on are
// counted (apt_wbvh_queue_overflows); no entry is dropped.
//
// The debug dump (_wbvh_kernel's debug=True, pallas_wbvh.py:602-607):
// the instantiation with kDump marks, for each tile of debug_tile rays
// (the Pallas kernel's ray tile), the chunks some ray of the tile enters
// (debug_dump.cuh), and dump_wbvh_tiles_kernel prints "wbvh tile worklist
// k: <count>" for every tile in order with device printf, a batch of
// DUMP_LINES lines a launch, each batch synchronized and flushed to
// stdout before the next (the printf buffer holds about 1 MB).  The
// outputs are the same bit for bit; the instantiations without it keep
// their code.
//
// Bound on the H100: FP32/FP64 instruction throughput.  Per ray ~20
// flops per box tested and ~30 per triangle: the root box, the top level
// for the rays that enter the root, each hit box's children, each entered
// chunk's triangles.  HBM traffic is the rays (24 B) and outputs (8-60 B)
// per ray; the rows are re-read from L1/L2.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

#include "chunk_walk.cuh"
#include "sphere_hit.cuh"  // BLOCK, miss_t
#include "warp_walk.cuh"
#include "debug_dump.cuh"  // DumpMarks, WithDump, count_bits

namespace {

template <typename T>
struct WbvhParams {
  ChunkGrid g;
  long long n;
  T eps;
  int tpc, stride;
  bool shared_boxes;
};

// The debug dump's chunk bits: [tiles, words], a tile of `tile` rays.
struct TileDump {
  unsigned* bits;
  int words;
  long long tile;
};

// Lines a dump_wbvh_tiles_kernel launch prints at most.
constexpr long long DUMP_LINES = 8192;

template <typename T, typename Rows, bool kStats, bool kDump>
__global__ void __launch_bounds__(BLOCK)
    wbvh_kernel(const T* __restrict__ rays, const Rows rows, const float* __restrict__ tris,
                T* __restrict__ tmin_out, int32_t* __restrict__ hit_out,
                T* __restrict__ attrs_out, int32_t* __restrict__ stats_out,
                const WbvhParams<T> p, const TileDump dump) {
  extern __shared__ float smem[];
  __shared__ WarpList lists[BLOCK / WARP];
  __shared__ int counts[kStats ? BLOCK / WARP : 1][3 * WARP];
  const ChunkGrid g = boxes_to_shared(p.g, smem, p.shared_boxes);  // syncs
  const int w = threadIdx.x / WARP, lane = lane_id();
  WarpList& L = lists[w];
  init_root(g, L);
  const long long i = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  const long long n = p.n;
  const bool live = i < n;
  // the whole warp walks; a lane past N carries a ray that never enters
  const RayInv<T> r = live ? make_ray(rays[i], rays[n + i], rays[2 * n + i], rays[3 * n + i],
                                      rays[4 * n + i], rays[5 * n + i])
                           : make_ray(T(0), T(0), T(0), T(1), T(1), T(1));
  int* cnt = counts[kStats ? w : 0];
  if (kStats) {
    cnt[lane] = cnt[WARP + lane] = cnt[2 * WARP + lane] = 0;
    __syncwarp();
  }
  T tmin = miss_t<T>();
  int slot;
  if constexpr (kDump) {
    const DumpMarks dm{live ? dump.bits + i / dump.tile * dump.words : nullptr};
    if constexpr (kStats) {
      slot = walk_grid_warp<false>(g, L, rows, p.tpc, r, miss_t<T>(), p.eps, live,
                                   WithDump<RayCounts>{RayCounts{cnt, lane}, dm}, tmin);
    } else {
      slot = walk_grid_warp<false>(g, L, rows, p.tpc, r, miss_t<T>(), p.eps, live, dm, tmin);
    }
  } else if constexpr (kStats) {
    slot = walk_grid_warp<false>(g, L, rows, p.tpc, r, miss_t<T>(), p.eps, live,
                                 RayCounts{cnt, lane}, tmin);
  } else {
    slot = walk_grid_warp<false>(g, L, rows, p.tpc, r, miss_t<T>(), p.eps, live,
                                 NoCounts(), tmin);
  }
  if (!live) return;
  tmin_out[i] = tmin;
  hit_out[i] = slot < 0 ? 0 : slot;
  if (attrs_out != nullptr) {
    const float* row = tris + static_cast<long long>(slot < 0 ? 0 : slot) * p.stride;
    for (int a = 0; a < N_ATTR; ++a) {
      attrs_out[a * n + i] = slot < 0 ? T(0) : T(__ldg(row + TRI_F + a));
    }
  }
  if (kStats) {  // the walk ends with __syncwarp: every count is in
    stats_out[i] = cnt[lane];
    stats_out[n + i] = cnt[WARP + lane];
    stats_out[2 * n + i] = cnt[2 * WARP + lane];
  }
}

// The debug dump's lines: "wbvh tile worklist k" of tiles [first, first
// + n), from their chunk bits.
__global__ void dump_wbvh_tiles_kernel(const unsigned* bits, int words, long long first,
                                       long long n) {
  for (long long t = first; t < first + n; ++t) {
    printf("wbvh tile worklist k: %d\n", count_bits(bits + t * words, words));
  }
}

// Launches one instantiation with `smem` bytes of dynamic shared memory
// (the boxes'), asking for them past the default 48 KB.
template <typename T, typename Rows, bool kStats, bool kDump>
cudaError_t launch_one(const Rows& rows, const WbvhParams<T>& p, size_t smem,
                       cudaStream_t st, const T* rays, const float* tris, T* tmin,
                       int32_t* hit, T* attrs, int32_t* stats, const TileDump& dump) {
  const cudaError_t e = cudaFuncSetAttribute(wbvh_kernel<T, Rows, kStats, kDump>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const auto grid = static_cast<unsigned>((p.n + BLOCK - 1) / BLOCK);
  wbvh_kernel<T, Rows, kStats, kDump><<<grid, BLOCK, smem, st>>>(rays, rows, tris, tmin, hit,
                                                                attrs, stats, p, dump);
  return cudaSuccess;
}

template <typename T, typename Rows, bool kDump>
cudaError_t launch_stats(const Rows& rows, const WbvhParams<T>& p, size_t smem,
                         cudaStream_t st, const T* rays, const float* tris, T* tmin,
                         int32_t* hit, T* attrs, int32_t* stats, const TileDump& dump) {
  return stats != nullptr
             ? launch_one<T, Rows, true, kDump>(rows, p, smem, st, rays, tris, tmin, hit, attrs,
                                                stats, dump)
             : launch_one<T, Rows, false, kDump>(rows, p, smem, st, rays, tris, tmin, hit,
                                                 attrs, stats, dump);
}

template <typename T, typename Rows>
cudaError_t launch_rows(const Rows& rows, const WbvhParams<T>& p, size_t smem,
                        cudaStream_t st, const T* rays, const float* tris, T* tmin,
                        int32_t* hit, T* attrs, int32_t* stats, const TileDump& dump) {
  return dump.bits != nullptr
             ? launch_stats<T, Rows, true>(rows, p, smem, st, rays, tris, tmin, hit, attrs,
                                           stats, dump)
             : launch_stats<T, Rows, false>(rows, p, smem, st, rays, tris, tmin, hit, attrs,
                                            stats, dump);
}

template <typename T>
int launch_wbvh(const void* rays, const void* cboxes, const void* sboxes,
                const void* ssboxes, const void* tris, void* tmin, void* hit,
                void* attrs, void* stats, long long n, int n_chunks,
                int n_supers, int n_supers2, int tris_per_chunk,
                int supers_per, int supers2_per, int stride, double eps,
                void* debug_bits, long long debug_tile, void* stream) {
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
      (attrs != nullptr && stride != TRI_ATTR_F) || n_chunks >= (1 << 26) ||
      (debug_bits != nullptr && debug_tile < 1)) {
    return cudaErrorInvalidValue;  // a queue entry holds its box in 26 bits
  }
  const TileDump dump{static_cast<unsigned*>(debug_bits), (n_chunks + 31) / 32, debug_tile};
  p.n = n;
  p.eps = static_cast<T>(eps);
  p.tpc = tris_per_chunk;
  p.stride = stride;
  p.shared_boxes = boxes_fit_shared(p.g);
  const size_t smem = p.shared_boxes ? static_cast<size_t>(box_bytes(p.g)) : 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto tr = static_cast<const float*>(tris);
  const auto ry = static_cast<const T*>(rays);
  auto* tm = static_cast<T*>(tmin);
  auto* ht = static_cast<int32_t*>(hit);
  auto* at = static_cast<T*>(attrs);
  auto* sc = static_cast<int32_t*>(stats);
  const bool row16 = stride == TRI_ATTR_F && (reinterpret_cast<uintptr_t>(tris) & 15u) == 0u;
  cudaError_t e =
      row16 ? launch_rows<T>(Rows24{tr}, p, smem, st, ry, tr, tm, ht, at, sc, dump)
            : launch_rows<T>(RowsStrided{tr, stride}, p, smem, st, ry, tr, tm, ht, at, sc,
                             dump);
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e != cudaSuccess || dump.bits == nullptr) return e;
  const long long tiles = (n + debug_tile - 1) / debug_tile;
  for (long long first = 0; first < tiles; first += DUMP_LINES) {
    const long long lines = tiles - first < DUMP_LINES ? tiles - first : DUMP_LINES;
    dump_wbvh_tiles_kernel<<<1, 1, 0, st>>>(dump.bits, dump.words, first, lines);
    e = cudaGetLastError();
    if (e == cudaSuccess) e = cudaStreamSynchronize(st);  // prints the batch
    if (e != cudaSuccess) return e;
    fflush(stdout);
  }
  return cudaSuccess;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError()
// after the launch (0 = success); the wrapper raises on anything else.
// Pointers and the stream arrive as void*; attrs and stats may be null.
// debug_bits (uint32 [ceil(N / debug_tile), ceil(C / 32)], zeroed) is
// null, or the debug dump's chunk bits; with it the call prints the dump
// and returns after the stream has synchronized.
extern "C" {

int apt_wbvh_attr_count() { return N_ATTR; }

// The worklist's capacity (entries per queue per warp).
int apt_wbvh_queue_cap() { return QUEUE_CAP; }

// The queue overflows since the last reset into out[2] (box queues above
// the chunks, chunk queue; after the device is idle), then zeroes them.
int apt_wbvh_queue_overflows(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, queue_overflows, sizeof(queue_overflows));
  if (e != cudaSuccess) return e;
  const unsigned long long zero[2] = {0, 0};
  return cudaMemcpyToSymbol(queue_overflows, zero, sizeof(zero));
}
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
                        void* debug_bits, long long debug_tile, void* stream) {\
    return launch_wbvh<T>(rays, cboxes, sboxes, ssboxes, tris, tmin, hit,      \
                          attrs, stats, n, n_chunks, n_supers, n_supers2,      \
                          tris_per_chunk, supers_per, supers2_per, stride,     \
                          eps, debug_bits, debug_tile, stream);                \
  }

APT_WBVH(f32, float)
APT_WBVH(f64, double)

}  // extern "C"
