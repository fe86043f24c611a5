// Hand-written Hopper (sm_90a) kernel of the fully fused sphere+mesh path
// tracer: camera rays, random numbers, the spheres, the chunk-grid walk
// of a triangle mesh, diffuse/mirror/glass shading, Russian roulette and
// the per-pixel mean over the sample layers, in one launch, for float
// and double.  It replaces _mesh_pt_kernel of
// ascendpathtracing_tpu/ops/pallas_mesh_pt.py, with its replay residuals
// (with_residuals: wid and resv, pt_trace.cuh's Residuals), its screen
// coordinates (with_camera: suv, CameraResiduals) and its per-cell walk
// record (with_stats: kstats, CellStats below); the debug dump is not
// ported.
//
// Build (ops/build.py runs this at first use, into build/):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libmesh_pt.so mesh_pt.cu
//
// PARITY RULE, as in render_pt.cu.  The sample (camera, bounce loop,
// shading, RR, pixel loop) is pt_trace.cuh, the same code as the sphere
// kernel's, and the random stream is keyed exactly as render_pt keys its
// own (philox.cuh), so a mesh that no ray reaches gives render_pt's image
// bit for bit.  The plain twin (ops/mesh_pt_kernels.render_pt_mesh_plain)
// gives the same image.
//
// Each bounce: the spheres first (closest_hit, strict <), then the chunk
// walk (chunk_walk.cuh) gated by the tmin after the spheres, before the
// triangles (pallas_mesh_pt.py:310-321; never the running triangle tmin),
// with the strict t < tmin running minimum, so a triangle needs a
// strictly smaller t than the sphere.  The winner is a sphere index or a
// triangle slot; its shading values are read once from the sphere table
// or from the slot's 24-float row (unit normal 13-15, not renormalized;
// albedo 16-18; emission 19-21; the material one-hots 22-23 as > 0.5; an
// origin offset of eps, since a triangle has r2 = 0).  The Pallas kernel
// carries the same values through its loop.  A dead path leaves the loop
// (the Pallas kernel's -inf gate of dead lanes).
//
// Design: one thread per pixel, layers in order, as render_pt.cu; the
// [10, S] spheres in shared memory, the boxes in dynamic shared memory
// when they fit (s4: 8 KB), the triangle rows in global memory through
// the read-only cache (s4: 320 chunks x 16 x 96 B = 491 KB).
//
// Bound on the H100: FP32 instruction throughput and divergence.  Per
// sample-bounce ~14*S flops for the spheres, ~20 per box tested and ~30
// per triangle tested; paths in a warp walk different chunk lists and
// end at different bounces, so a warp runs as long as its longest path.
// The residual stores add 32 bytes per sample-bounce (17.2 GB at
// 1024^2 x 64 spp x 8 bounces): coalesced, one write per value.
//
// The residual store is a template parameter (the Sink), not a runtime
// branch: render_pt_mesh_kernel<T, NoResiduals, NoStats> is the
// forward-only kernel, unchanged, <T, Residuals<T>, NoStats> the training
// forward and <T, CameraResiduals<T>, NoStats> the camera path's.  The
// stats are a second template parameter: NoStats records nothing.
//
// with_stats (pallas_mesh_pt.py:329-342): for each cell (a tile of
// stats_tile pixels x one sample layer, cell = tile * spp4 + layer) and
// bounce, the number of chunks, supers and super-supers whose box some
// live path of the cell enters (the chunk walk's gate included): the
// Pallas kernel's worklist length k and phase-A hit counts, unions over
// the cell's lanes.  Each box a ray enters sets its bit in a scratch
// [cells, bounces, words] (the chunks' words, then the supers', then the
// super-supers') with one atomicOr, and kstats_kernel then counts the
// bits.  The union of the
// rays' sets equals the Pallas count where child boxes nest in their
// parents (the slab test is monotone in the box bounds, so that holds
// through rounding); a grid with pad boxes ([-1, 1]^3 after the slab
// test's swap) outside their parent can list more on the TPU.  The build
// log shows the registers of every instantiation.

#include <cuda_runtime.h>

#include <cstdint>

#include "chunk_walk.cuh"
#include "pt_trace.cuh"

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
  unsigned* bits;  // [cells, bounces, words], zeroed by the launcher
  int words, ws, wss, bounces, spp4, tile;
  long long cell0;  // the pixel's tile * spp4

  __device__ __forceinline__ void begin(long long pix) { cell0 = pix / tile * spp4; }
  __device__ __forceinline__ CellMarks at(int layer, int k) const {
    return CellMarks{bits + ((cell0 + layer) * bounces + k) * words, ws, wss};
  }
};

struct NoStats {
  __device__ __forceinline__ void begin(long long) {}
  __device__ __forceinline__ NoCounts at(int, int) const { return NoCounts(); }
};

// Spheres + a chunk-grid mesh of 24-float attribute rows.
template <typename T, typename Stats>
struct MeshScene {
  Spheres<T> sph;
  ChunkGrid g;
  const float* tris;  // [C*T, TRI_ATTR_F]
  int tpc;
  Stats stats;

  __device__ __forceinline__ bool hit(T ox, T oy, T oz, T dx, T dy, T dz,
                                      T eps, T& tmin, Winner& w, int layer,
                                      int k) const {
    w.sphere = sph.hit(ox, oy, oz, dx, dy, dz, eps, tmin);
    const RayInv<T> r = make_ray(ox, oy, oz, dx, dy, dz);
    const T gate = tmin;  // after the spheres, before the triangles
    int slot = -1;
    walk_chunks<true>(
        g, r, gate,
        [&](int c) { test_chunk(tris, TRI_ATTR_F, c, tpc, r, eps, tmin, slot); },
        stats.at(layer, k));
    w.slot = slot;
    return w.sphere >= 0 || slot >= 0;
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
// __launch_bounds__(BLOCK, 1): with the block size alone, ptxas (CUDA
// 12.9) caps this kernel at 48 (f32) / 80 (f64) registers and spills;
// one resident block per SM lifts the cap (75 / 106 registers, no spills).
// The float forward and residual kernels fit 80 registers, so three
// blocks per SM.  The float camera kernel took 89 registers and ran two
// blocks per SM (the s4 frame 314 ms instead of 264 ms on an H100 80GB
// HBM3 at 700 W); MinBlocks asks ptxas for three, which gives 80
// registers, no spills and the residual kernel's frame time again
// (chip_smoke times the two in turns).
template <typename T, typename Sink, typename Stats>
struct MinBlocks {
  static constexpr int value = 1;
};
template <>
struct MinBlocks<float, CameraResiduals<float>, NoStats> {
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
  extern __shared__ float smem[];
  if (static_cast<int>(threadIdx.x) < s_count) {
    mat[threadIdx.x] = materials[threadIdx.x];
  }
  MeshScene<T, Stats> world;
  world.g = boxes_to_shared(grid, smem, shared_boxes);  // syncs
  load_scene(sc, scene, s_count);                       // syncs
  const long long pix = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (pix >= p.n_pix) return;
  world.sph.sc = sc;
  world.sph.mat = mat;
  world.sph.count = s_count;
  world.tris = tris;
  world.tpc = tpc;
  world.stats = stats;
  world.stats.begin(pix);
  render_pixel(world, p, pix, out, sink);
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

struct Launch {
  unsigned grid;
  size_t smem;
  cudaStream_t stream;
  int s_count, tpc;
  bool shared_boxes;
};

template <typename T, typename Sink>
void launch_sink(const Launch& l, const T* sc, const int32_t* mt, const float* tr,
                 T* o, const PtParams<T>& p, const ChunkGrid& g, const Sink& sink,
                 const CellStats* stats) {
  if (stats == nullptr) {
    render_pt_mesh_kernel<T, Sink, NoStats><<<l.grid, BLOCK, l.smem, l.stream>>>(
        sc, mt, tr, o, p, g, l.s_count, l.tpc, l.shared_boxes, sink, NoStats());
  } else {
    render_pt_mesh_kernel<T, Sink, CellStats><<<l.grid, BLOCK, l.smem, l.stream>>>(
        sc, mt, tr, o, p, g, l.s_count, l.tpc, l.shared_boxes, sink, *stats);
  }
}

inline int words_of(int boxes) { return (boxes + 31) / 32; }

template <typename T>
int launch_mesh_pt(const void* scene, const void* materials,
                   const void* cboxes, const void* sboxes,
                   const void* ssboxes, const void* tris,
                   const void* uniforms, void* out, void* wid, void* resv,
                   void* suv, void* kstats, void* marks, int stats_tile,
                   int width, int height,
                   int spp4, int s_count, int n_chunks, int n_supers,
                   int n_supers2, int tris_per_chunk, int supers_per,
                   int supers2_per, int bounces, int rr_depth, double eps,
                   unsigned seed, const double* cam, void* stream) {
  if (s_count < 1 || s_count > MAX_S || tris == nullptr ||
      (wid == nullptr) != (resv == nullptr) || (suv != nullptr && wid == nullptr) ||
      (kstats == nullptr) != (marks == nullptr)) {
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
  const auto sc = static_cast<const T*>(scene);
  const auto mt = static_cast<const int32_t*>(materials);
  const auto tr = static_cast<const float*>(tris);
  const auto o = static_cast<T*>(out);
  if (wid == nullptr) {
    launch_sink(l, sc, mt, tr, o, p, g, NoResiduals(), st);
  } else {
    Residuals<T> res;
    res.wid = static_cast<int32_t*>(wid);
    res.resv = static_cast<T*>(resv);
    res.plane = static_cast<long long>(spp4) * p.n_pix;
    res.at = 0;
    res.s_count = s_count;
    if (suv == nullptr) {
      launch_sink(l, sc, mt, tr, o, p, g, res, st);
    } else {
      CameraResiduals<T> cres;
      static_cast<Residuals<T>&>(cres) = res;
      cres.suv = static_cast<T*>(suv);
      launch_sink(l, sc, mt, tr, o, p, g, cres, st);
    }
  }
  if (kstats != nullptr && cells * bounces > 0) {
    kstats_kernel<<<static_cast<unsigned>((cells * bounces + BLOCK - 1) / BLOCK), BLOCK, 0,
                    l.stream>>>(static_cast<const unsigned*>(marks), cells, bounces, wc,
                                wsn, wssn, static_cast<int32_t*>(kstats));
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError()
// after the launch (0 = success); the wrapper raises on anything else.
// cam points at 11 host doubles; pointers and the stream arrive as void*.
// wid and resv are both null (forward only) or both set (residuals); suv
// (with_camera) needs them.  kstats [3 * bounces, cells] int32 and marks
// (scratch of cells * bounces * words uint32, words = ceil(C / 32) +
// ceil(Cs / 32) + ceil(Css / 32)) are both null or both set (with_stats,
// stats_tile pixels a cell).
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
      void* kstats, void* marks, int stats_tile, int width, int height,      \
      int spp4, int s_count, int n_chunks, int n_supers, int n_supers2,      \
      int tris_per_chunk, int supers_per, int supers2_per, int bounces,       \
      int rr_depth, double eps, unsigned seed, const double* cam,             \
      void* stream) {                                                         \
    return launch_mesh_pt<T>(scene, materials, cboxes, sboxes, ssboxes, tris, \
                             uniforms, out, wid, resv, suv, kstats, marks,    \
                             stats_tile, width, height, spp4, s_count,        \
                             n_chunks, n_supers, n_supers2, tris_per_chunk,   \
                             supers_per, supers2_per, bounces, rr_depth, eps, \
                             seed, cam, stream);                              \
  }

APT_MESH_PT(f32, float)
APT_MESH_PT(f64, double)

}  // extern "C"
