// Hand-written Hopper (sm_90a) kernel of the fully fused sphere+mesh path
// tracer: camera rays, random numbers, the spheres, the chunk-grid walk
// of a triangle mesh, diffuse/mirror/glass shading, Russian roulette and
// the per-pixel mean over the sample layers, in one launch, for float
// and double.  It replaces _mesh_pt_kernel of
// ascendpathtracing_tpu/ops/pallas_mesh_pt.py, with its replay residuals
// (with_residuals: wid and resv, pt_trace.cuh's Residuals), its screen
// coordinates (with_camera: suv, CameraResiduals) and its per-cell walk
// record (with_stats: kstats, CellStats below) and its debug dump
// (DumpStats below).
//
// Build (ops/build.py runs this at first use, into build/):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libmesh_pt.so mesh_pt.cu
//
// PARITY RULE, as in render_pt.cu.  The sample (camera ray, bounce,
// shading, RR) is pt_trace.cuh, the same code as the sphere kernel's,
// and the random stream is keyed exactly as render_pt keys its own
// (philox.cuh), so a mesh that no ray reaches gives render_pt's image
// bit for bit.  The plain twin (ops/mesh_pt_kernels.render_pt_mesh_plain)
// gives the same image, wid, resv, suv and kstats.
//
// Each bounce: the spheres first (closest_hit, strict <), then the chunk
// walk gated by the tmin after the spheres, before the triangles
// (pallas_mesh_pt.py:310-321; never the running triangle tmin); a
// triangle needs a strictly smaller t than the sphere.  The winner is a
// sphere index or a triangle slot; its shading values are read once from
// the sphere table or from the slot's 24-float row (unit normal 13-15,
// not renormalized; albedo 16-18; emission 19-21; the material one-hots
// 22-23 as > 0.5; an origin offset of eps, since a triangle has r2 = 0).
//
// What bounded it on the H100: FP32 instruction throughput under
// divergence.  The TPU kernel is coherent by construction: it compacts
// one worklist per 2048-lane tile (compact_worklist) and tests each
// listed chunk for the whole tile.  A thread per pixel that walks its own chunk list and
// its own paths leaves a warp running the union of its lanes' chunks
// (~7.5 x 16 triangle tests per bounce at the s4 cell where a lane needs
// ~0.24 x 16) and, for every sample layer, its longest path.  So:
//
// - Path regeneration (pt_trace.cuh's render_pixel_regen): one loop per
//   warp in which every lane advances its path by one bounce; a lane
//   whose path ends begins its pixel's next sample layer, at most one
//   layer ahead of the warp's slowest lane, so the warp meets at every
//   hit query and costs about the sum of its lanes' bounces.
// - A per-warp worklist (warp_walk.cuh): the spheres stay per lane; the
//   lanes whose ray enters the root box (the union of the grid's top
//   level) expand over the top level's boxes, (lane, box) entries over
//   their children's boxes and (lane, chunk) entries over the chunks'
//   triangles, 32 pairs a step, from queues in shared memory.
//
// What bounds it now: the per-lane spheres and shading, and the steps of
// the walk (shuffles, box and triangle tests, the queues); chip_smoke.py's
// mesh_times phase times the same paths with the spheres alone and with
// the mesh out of reach.  The residual stores add 32 bytes per
// sample-bounce (17.2 GB at 1024^2 x 64 spp x 8 bounces); lanes at most
// one layer apart keep a layer plane's stores close enough in time to
// merge in the L2.
//
// Tie-break: the box gate is the sphere tmin, so the set of (ray,
// triangle) pairs tested does not depend on the order they run in, and
// each ray keeps the lexicographic minimum of (t, slot) over that set
// (an atomicMin on t's bits, then one on the slot among the pairs at that
// t).  The per-thread walk's strict t < tmin in increasing slot order
// picks the same pair, so the result is bitwise the twin's by
// construction.
//
// Memory: the [10, S] spheres and the warps' queues (16,576 bytes a block) in
// shared memory, the boxes in dynamic shared memory when they fit (s4: 8
// KB), the triangle rows in global memory through the read-only cache,
// 16 bytes a load (s4: 320 chunks x 16 x 96 B = 491 KB).
//
// The residual store is a template parameter (the Sink), not a runtime
// branch: render_pt_mesh_kernel<T, NoResiduals, NoStats> is the
// forward-only kernel, <T, Residuals<T>, NoStats> the training forward
// and <T, CameraResiduals<T>, NoStats> the camera path's.  The stats are
// a second template parameter: NoStats records nothing.
//
// with_stats (pallas_mesh_pt.py:329-342): for each cell (a tile of
// stats_tile pixels x one sample layer, cell = tile * spp4 + layer) and
// bounce, the number of chunks, supers and super-supers whose box some
// live path of the cell enters (the walk's gate included): the Pallas
// kernel's worklist length k and phase-A hit counts, unions over the
// cell's lanes.  Each box a ray enters sets its bit in a scratch
// [cells, bounces, words] (the chunks' words, then the supers', then the
// super-supers') with one atomicOr, made for the ray's own cell and
// bounce whichever lane tests the box, and kstats_kernel then counts the
// bits.  The union of the rays' sets equals the Pallas count where child
// boxes nest in their parents (the slab test is monotone in the box
// bounds, so that holds through rounding); a grid with pad boxes ([-1,
// 1]^3 after the slab test's swap) outside their parent can list more on
// the TPU.  The build log shows the registers of every instantiation;
// apt_mesh_pt_blocks_per_sm their resident blocks.
//
// debug (pallas_mesh_pt.py:343-350 and 550-555): the Stats DumpStats
// (over NoStats, or over CellStats with with_stats) marks the chunks that
// the live paths of grid cell (0, 0) (pixels [0, debug_tile) of sample
// layer 0) enter at each bounce, as with_stats marks a cell's
// (debug_dump.cuh), and counts those paths alive after each bounce
// (pt_trace.cuh's goes_on); dump_mesh_pt_kernel then prints per bounce
// "mesh_pt worklist k: <count>" and "mesh_pt alive: <count>.0" with
// device printf, the Pallas kernel's two lines.  Path regeneration runs
// other sample layers in the same warp at once, so the marks and counts
// are kept by (layer, bounce) and only layer 0 is recorded.  The image
// and residuals are the same bit for bit; the instantiations without it
// keep their code.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

#include "pt_trace.cuh"
#include "warp_walk.cuh"
#include "debug_dump.cuh"  // DumpMarks, WithDump, count_bits

namespace {

// with_stats: the boxes one (cell, bounce) entered, as bits of its
// words.  Each lane sets its own bit with one atomicOr (a reduction: no
// value returns, so no lane waits).  An OR has no order and sets a bit
// once however often it comes, so no lanes need to be converged or
// grouped; and marks are rare (about half a box per path-bounce at the
// s4 cell), so aggregating them per warp saves nothing.
struct CellMarks {
  unsigned* w;  // the (cell, bounce)'s first word
  int ws, wss;  // the first word of the supers' and of the super-supers' bits

  __device__ __forceinline__ void chunk(int c) const { mark(c >> 5, c & 31); }
  __device__ __forceinline__ void super(int s) const { mark(ws + (s >> 5), s & 31); }
  __device__ __forceinline__ void super2(int s) const { mark(wss + (s >> 5), s & 31); }

  __device__ __forceinline__ void mark(int word, int bit) const {
    atomicOr(w + word, 1u << bit);
  }
};

// The stats of one thread's pixel: where its cells' words start.
struct CellStats {
  using Marks = CellMarks;
  unsigned* bits;  // [cells, bounces, words], zeroed by the launcher
  int words, ws, wss, bounces, spp4, tile;
  long long cell0;  // the pixel's tile * spp4

  __device__ __forceinline__ void begin(long long pix) { cell0 = pix / tile * spp4; }
  __device__ __forceinline__ CellMarks at(int layer, int k) const {
    return CellMarks{bits + ((cell0 + layer) * bounces + k) * words, ws, wss};
  }
  __device__ __forceinline__ void goes_on(long long, int, int) const {}
};

struct NoStats {
  using Marks = NoCounts;
  __device__ __forceinline__ void begin(long long) {}
  __device__ __forceinline__ NoCounts at(int, int) const { return NoCounts(); }
  __device__ __forceinline__ void goes_on(long long, int, int) const {}
};

// The debug dump over a Base stats (NoStats or CellStats): the chunk
// marks of grid cell (0, 0) by bounce, and its paths alive after each
// bounce, recorded for sample layer 0 of the pixels [0, tile).
struct MeshDump {
  unsigned* bits;  // [bounces, words]: the chunks' bits, zeroed by the wrapper
  int* alive;      // [bounces], zeroed by the wrapper
  int words;
  long long tile;
};

template <typename Base>
struct DumpStats {
  Base base;
  MeshDump dump;
  bool first;  // the thread's pixel lies in the dumped cell

  __device__ __forceinline__ void begin(long long pix) {
    base.begin(pix);
    first = pix < dump.tile;
  }
  __device__ __forceinline__ WithDump<typename Base::Marks> at(int layer, int k) const {
    return WithDump<typename Base::Marks>{
        base.at(layer, k),
        DumpMarks{first && layer == 0 ? dump.bits + static_cast<long long>(k) * dump.words
                                      : nullptr}};
  }
  __device__ __forceinline__ void goes_on(long long, int layer, int k) const {
    if (first && layer == 0) atomicAdd(dump.alive + k, 1);
  }
};

// Spheres + a chunk-grid mesh of 24-float attribute rows; the warp walks
// the mesh together (warp_walk.cuh).
template <typename T, typename Stats>
struct MeshScene {
  Spheres<T> sph;
  ChunkGrid g;
  const float* tris;  // [C*T, TRI_ATTR_F]
  int tpc;
  Stats stats;
  WarpList* list;  // this warp's

  __device__ __forceinline__ bool hit_warp(bool live, T ox, T oy, T oz, T dx,
                                           T dy, T dz, T eps, T& tmin,
                                           Winner& w, int layer, int k) const {
    w.sphere = sph.hit(ox, oy, oz, dx, dy, dz, eps, tmin);
    const RayInv<T> r = make_ray(ox, oy, oz, dx, dy, dz);
    const T gate = tmin;  // after the spheres, before the triangles
    w.slot = walk_chunks_warp(g, *list, tris, tpc, r, gate, eps, live,
                              stats.at(layer, k), tmin);
    return live && (w.sphere >= 0 || w.slot >= 0);
  }

  // A path that goes on after bounce k (the debug dump's alive count).
  __device__ __forceinline__ void goes_on(long long pix, int layer, int k) const {
    stats.goes_on(pix, layer, k);
  }

  __device__ __forceinline__ Surface<T> surface(const Winner& w, T hx, T hy,
                                                T hz) const {
    if (w.slot < 0) return sph.surface(w.sphere, hx, hy, hz);
    const float* row = tris + static_cast<long long>(w.slot) * TRI_ATTR_F;
    Surface<T> s;
    s.nx = T(__ldg(row + 13));
    s.ny = T(__ldg(row + 14));
    s.nz = T(__ldg(row + 15));
    s.ar = T(__ldg(row + 16));
    s.ag = T(__ldg(row + 17));
    s.ab = T(__ldg(row + 18));
    s.er = T(__ldg(row + 19));
    s.eg = T(__ldg(row + 20));
    s.eb = T(__ldg(row + 21));
    s.r2 = T(0);
    s.diff = T(__ldg(row + 22)) > T(0.5);
    s.refr = T(__ldg(row + 23)) > T(0.5);
    return s;
  }
};

// ---------------------------------------------------------------------------
// The fused sphere+mesh path tracer.  out [3, W*H]: per-pixel means over
// the spp4 sample layers; pixel p is column p / H, row p % H.
// ---------------------------------------------------------------------------
// __launch_bounds__(BLOCK, MinBlocks): ptxas fits the registers to
// MinBlocks resident blocks of 256 threads per SM (65,536 registers: 1
// block up to 255 a thread, 2 up to 128, 3 up to 80).  Left to itself
// ptxas gives the float instantiations 88-101 registers (two blocks per
// SM); asked for three blocks, the forward, residual and camera ones fit
// 78-80 registers without spills and run the s4 frame faster on an H100,
// while the stats ones (99-101) would spill, so they keep one.  The
// double instantiations (120-140 registers) serve the parity and FD
// gates.
template <typename T, typename Sink, typename Stats>
struct MinBlocks {
  static constexpr int value = 1;
};
template <typename Sink>
struct MinBlocks<float, Sink, NoStats> {
  static constexpr int value = 3;
};

template <typename T, typename Sink, typename Stats>
__global__ void __launch_bounds__(BLOCK, (MinBlocks<T, Sink, Stats>::value))
    render_pt_mesh_kernel(const T* __restrict__ scene,
                          const int32_t* __restrict__ materials,
                          const float* __restrict__ tris,
                          T* __restrict__ out, const PtParams<T> p,
                          const ChunkGrid grid, int s_count, int tpc,
                          bool shared_boxes, const Sink sink, const Stats stats) {
  __shared__ T sc[PLANES][MAX_S];
  __shared__ int mat[MAX_S];
  __shared__ WarpList lists[BLOCK / WARP];
  extern __shared__ float smem[];
  if (static_cast<int>(threadIdx.x) < s_count) {
    mat[threadIdx.x] = materials[threadIdx.x];
  }
  MeshScene<T, Stats> world;
  world.g = boxes_to_shared(grid, smem, shared_boxes);  // syncs
  load_scene(sc, scene, s_count);                       // syncs
  const long long pix = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  world.sph.sc = sc;
  world.sph.mat = mat;
  world.sph.count = s_count;
  world.tris = tris;
  world.tpc = tpc;
  world.stats = stats;
  world.stats.begin(pix);
  world.list = &lists[threadIdx.x / WARP];
  init_root(world.g, *world.list);
  render_pixel_regen(world, p, pix, out, sink);
}

// kstats [3 * bounces, cells] from the marks of each (cell, bounce): rows
// k (chunks), bounces + k (supers), 2 * bounces + k (super-supers), in
// the Pallas kernel's layout (pallas_mesh_pt.py:340-342).
__global__ void __launch_bounds__(BLOCK)
    kstats_kernel(const unsigned* __restrict__ bits, long long cells, int bounces,
                  int wc, int wsn, int wssn, int32_t* __restrict__ kstats) {
  const long long i = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= cells * bounces) return;  // i = cell * bounces + k
  const long long cell = i / bounces;
  const int k = static_cast<int>(i % bounces);
  const unsigned* w = bits + i * (wc + wsn + wssn);
  int n[3] = {0, 0, 0};
  for (int j = 0; j < wc; ++j) n[0] += __popc(w[j]);
  for (int j = 0; j < wsn; ++j) n[1] += __popc(w[wc + j]);
  for (int j = 0; j < wssn; ++j) n[2] += __popc(w[wc + wsn + j]);
  for (int level = 0; level < 3; ++level) {
    kstats[(static_cast<long long>(level) * bounces + k) * cells + cell] = n[level];
  }
}

// The debug dump's lines: per bounce, "mesh_pt worklist k" (the chunk
// bits of cell (0, 0)) and "mesh_pt alive" (the Pallas kernel's float32
// sum of its 0/1 lanes).
__global__ void dump_mesh_pt_kernel(const MeshDump dump, int bounces) {
  for (int k = 0; k < bounces; ++k) {
    printf("mesh_pt worklist k: %d\n",
           count_bits(dump.bits + static_cast<long long>(k) * dump.words, dump.words));
    printf("mesh_pt alive: %d.0\n", dump.alive[k]);
  }
}

struct Launch {
  unsigned grid;
  size_t smem;
  cudaStream_t stream;
  int s_count, tpc;
  bool shared_boxes;
};

// Launches the instantiation for (T, Sink, Stats), its boxes in l.smem
// bytes of dynamic shared memory: with the warps' queues that may pass
// the 48 KB a launch gets without asking.
template <typename T, typename Sink, typename Stats>
void launch_stats(const Launch& l, const T* sc, const int32_t* mt, const float* tr,
                  T* o, const PtParams<T>& p, const ChunkGrid& g, const Sink& sink,
                  const Stats& stats) {
  const cudaError_t e = cudaFuncSetAttribute(render_pt_mesh_kernel<T, Sink, Stats>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(l.smem));
  if (e != cudaSuccess) return;  // the launcher's cudaGetLastError reports it
  render_pt_mesh_kernel<T, Sink, Stats><<<l.grid, BLOCK, l.smem, l.stream>>>(
      sc, mt, tr, o, p, g, l.s_count, l.tpc, l.shared_boxes, sink, stats);
}

template <typename T, typename Sink>
void launch_sink(const Launch& l, const T* sc, const int32_t* mt, const float* tr,
                 T* o, const PtParams<T>& p, const ChunkGrid& g, const Sink& sink,
                 const CellStats* stats, const MeshDump* dump) {
  if (dump != nullptr) {
    if (stats == nullptr) {
      launch_stats(l, sc, mt, tr, o, p, g, sink, DumpStats<NoStats>{NoStats(), *dump, false});
    } else {
      launch_stats(l, sc, mt, tr, o, p, g, sink, DumpStats<CellStats>{*stats, *dump, false});
    }
  } else if (stats == nullptr) {
    launch_stats(l, sc, mt, tr, o, p, g, sink, NoStats());
  } else {
    launch_stats(l, sc, mt, tr, o, p, g, sink, *stats);
  }
}

inline int words_of(int boxes) { return (boxes + 31) / 32; }

// The instantiations of one sink: without stats, with stats, with the
// debug dump, with both.
template <typename T, typename Sink>
void sink_kernels(const void** out) {
  out[0] = reinterpret_cast<const void*>(render_pt_mesh_kernel<T, Sink, NoStats>);
  out[1] = reinterpret_cast<const void*>(render_pt_mesh_kernel<T, Sink, CellStats>);
  out[2] = reinterpret_cast<const void*>(render_pt_mesh_kernel<T, Sink, DumpStats<NoStats>>);
  out[3] = reinterpret_cast<const void*>(render_pt_mesh_kernel<T, Sink, DumpStats<CellStats>>);
}

constexpr int KERNELS_PER_TYPE = 12;

// Resident blocks per SM of the instantiations of type T at `smem` bytes
// of dynamic shared memory into out[12]: (forward, residuals, camera) x
// (without, with stats, with the debug dump, with both).
template <typename T>
int blocks_per_sm(size_t smem, int* out) {
  const void* kernels[KERNELS_PER_TYPE];
  sink_kernels<T, NoResiduals>(kernels);
  sink_kernels<T, Residuals<T>>(kernels + 4);
  sink_kernels<T, CameraResiduals<T>>(kernels + 8);
  for (int i = 0; i < KERNELS_PER_TYPE; ++i) {
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + i, kernels[i], BLOCK, smem);
    if (e != cudaSuccess) return e;
  }
  return 0;
}

template <typename T>
int launch_mesh_pt(const void* scene, const void* materials,
                   const void* cboxes, const void* sboxes,
                   const void* ssboxes, const void* tris,
                   const void* uniforms, void* out, void* wid, void* resv,
                   void* suv, void* kstats, void* marks, int stats_tile,
                   void* debug_bits, void* debug_alive, long long debug_tile,
                   int width, int height,
                   int spp4, int s_count, int n_chunks, int n_supers,
                   int n_supers2, int tris_per_chunk, int supers_per,
                   int supers2_per, int bounces, int rr_depth, double eps,
                   unsigned seed, const double* cam, void* stream) {
  if (s_count < 1 || s_count > MAX_S || tris == nullptr ||
      reinterpret_cast<uintptr_t>(tris) % 16 != 0 ||  // load_row16
      (wid == nullptr) != (resv == nullptr) ||
      (suv != nullptr && wid == nullptr && bounces > 0) ||
      (kstats == nullptr) != (marks == nullptr) ||
      (debug_bits == nullptr) != (debug_alive == nullptr) ||
      (debug_bits != nullptr && debug_tile < 1)) {
    return cudaErrorInvalidValue;
  }
  ChunkGrid g;
  g.cboxes = static_cast<const float*>(cboxes);
  g.sboxes = static_cast<const float*>(sboxes);
  g.ssboxes = static_cast<const float*>(ssboxes);
  g.n_chunks = n_chunks;
  g.n_supers = n_supers;
  g.n_supers2 = n_supers2;
  g.supers_per = supers_per;
  g.supers2_per = supers2_per;
  int err = check_grid(g, tris_per_chunk);
  if (err != 0) return err;
  // queue entries carry chunk << 5; a queue expands to QUEUE_CAP x
  // (chunks an entry, tris_per_chunk) items, counted in int
  if (n_chunks > (1 << 24) || tris_per_chunk > (1 << 24)) return cudaErrorInvalidValue;
  PtParams<T> p;
  err = make_pt_params(p, uniforms, width, height, spp4, bounces, rr_depth,
                       eps, seed, cam);
  if (err != 0) return err;
  Launch l;
  l.shared_boxes = boxes_fit_shared(g);
  l.smem = l.shared_boxes ? static_cast<size_t>(box_bytes(g)) : 0;
  l.grid = static_cast<unsigned>((p.n_pix + BLOCK - 1) / BLOCK);
  l.stream = static_cast<cudaStream_t>(stream);
  l.s_count = s_count;
  l.tpc = tris_per_chunk;
  CellStats stats;
  long long cells = 0;
  const int wc = words_of(n_chunks), wsn = words_of(n_supers), wssn = words_of(n_supers2);
  if (kstats != nullptr) {
    if (stats_tile < 1 || p.n_pix % stats_tile != 0) return cudaErrorInvalidValue;
    cells = p.n_pix / stats_tile * spp4;
    stats.bits = static_cast<unsigned*>(marks);
    stats.words = wc + wsn + wssn;
    stats.ws = wc;
    stats.wss = wc + wsn;
    stats.bounces = bounces;
    stats.spp4 = spp4;
    stats.tile = stats_tile;
    stats.cell0 = 0;
    const cudaError_t e = cudaMemsetAsync(
        marks, 0, cells * bounces * stats.words * sizeof(unsigned), l.stream);
    if (e != cudaSuccess) return e;
  }
  const CellStats* st = kstats != nullptr ? &stats : nullptr;
  const MeshDump dump{static_cast<unsigned*>(debug_bits), static_cast<int*>(debug_alive), wc,
                      debug_tile};
  const MeshDump* dp = debug_bits != nullptr ? &dump : nullptr;
  const auto sc = static_cast<const T*>(scene);
  const auto mt = static_cast<const int32_t*>(materials);
  const auto tr = static_cast<const float*>(tris);
  const auto o = static_cast<T*>(out);
  if (wid == nullptr && suv == nullptr) {
    launch_sink(l, sc, mt, tr, o, p, g, NoResiduals(), st, dp);
  } else {
    Residuals<T> res;
    res.wid = static_cast<int32_t*>(wid);
    res.resv = static_cast<T*>(resv);
    res.plane = static_cast<long long>(spp4) * p.n_pix;
    res.at = 0;
    res.s_count = s_count;
    if (suv == nullptr) {
      launch_sink(l, sc, mt, tr, o, p, g, res, st, dp);
    } else {
      CameraResiduals<T> cres;
      static_cast<Residuals<T>&>(cres) = res;
      cres.suv = static_cast<T*>(suv);
      launch_sink(l, sc, mt, tr, o, p, g, cres, st, dp);
    }
  }
  if (kstats != nullptr && cells * bounces > 0) {
    kstats_kernel<<<static_cast<unsigned>((cells * bounces + BLOCK - 1) / BLOCK), BLOCK, 0,
                    l.stream>>>(static_cast<const unsigned*>(marks), cells, bounces, wc,
                                wsn, wssn, static_cast<int32_t*>(kstats));
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || dp == nullptr || bounces == 0) return e;
  dump_mesh_pt_kernel<<<1, 1, 0, l.stream>>>(dump, bounces);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaStreamSynchronize(l.stream);  // prints the lines
  fflush(stdout);
  return e;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError()
// after the launch (0 = success); the wrapper raises on anything else.
// cam points at 11 host doubles; pointers and the stream arrive as void*.
// wid and resv are both null (forward only) or both set (residuals); suv
// (with_camera) needs them, unless there are no bounces (then both are
// empty, and null).  kstats [3 * bounces, cells] int32 and marks
// (scratch of cells * bounces * words uint32, words = ceil(C / 32) +
// ceil(Cs / 32) + ceil(Css / 32)) are both null or both set (with_stats,
// stats_tile pixels a cell).  debug_bits (uint32 [bounces, ceil(C /
// 32)], zeroed) and debug_alive (int32 [bounces], zeroed) are both null,
// or the debug dump's scratch over the pixels [0, debug_tile) of sample
// layer 0; with them the call prints the dump and returns after the
// stream has synchronized.
extern "C" {

int apt_mesh_pt_max_spheres() { return MAX_S; }
const char* apt_mesh_pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#define APT_MESH_PT(SUFFIX, T)                                                 \
  int apt_render_pt_mesh_##SUFFIX(                                             \
      const void* scene, const void* materials, const void* cboxes,           \
      const void* sboxes, const void* ssboxes, const void* tris,              \
      const void* uniforms, void* out, void* wid, void* resv, void* suv,     \
      void* kstats, void* marks, int stats_tile, void* debug_bits,           \
      void* debug_alive, long long debug_tile, int width, int height,        \
      int spp4, int s_count, int n_chunks, int n_supers, int n_supers2,      \
      int tris_per_chunk, int supers_per, int supers2_per, int bounces,       \
      int rr_depth, double eps, unsigned seed, const double* cam,             \
      void* stream) {                                                         \
    return launch_mesh_pt<T>(scene, materials, cboxes, sboxes, ssboxes, tris, \
                             uniforms, out, wid, resv, suv, kstats, marks,    \
                             stats_tile, debug_bits, debug_alive, debug_tile, \
                             width, height, spp4, s_count,                    \
                             n_chunks, n_supers, n_supers2, tris_per_chunk,   \
                             supers_per, supers2_per, bounces, rr_depth, eps, \
                             seed, cam, stream);                              \
  }

APT_MESH_PT(f32, float)
APT_MESH_PT(f64, double)

// Resident blocks per SM of every instantiation at `smem` bytes of dynamic
// shared memory (the boxes'), out[24]: float then double, each (forward,
// residuals, camera) x (without, with stats, with the debug dump, with
// both).
int apt_mesh_pt_blocks_per_sm(long long smem, int* out) {
  const int err = blocks_per_sm<float>(static_cast<size_t>(smem), out);
  return err != 0 ? err
                  : blocks_per_sm<double>(static_cast<size_t>(smem), out + KERNELS_PER_TYPE);
}

// The worklist's capacity (entries per queue per warp).
int apt_mesh_pt_queue_cap() { return QUEUE_CAP; }

// The queue overflows since the last reset into out[2] (super queue,
// chunk queue; after the device is idle), then zeroes them.
int apt_mesh_pt_queue_overflows(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, queue_overflows, sizeof(queue_overflows));
  if (e != cudaSuccess) return e;
  const unsigned long long zero[2] = {0, 0};
  return cudaMemcpyToSymbol(queue_overflows, zero, sizeof(zero));
}

}  // extern "C"
