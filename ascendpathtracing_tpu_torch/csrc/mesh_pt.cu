// Hand-written Hopper (sm_90a) kernel of the fully fused sphere+mesh path
// tracer: camera rays, random numbers, the spheres, the chunk-grid walk
// of a triangle mesh, diffuse/mirror/glass shading, Russian roulette and
// the per-pixel mean over the sample layers, in one launch, for float
// and double.  It replaces _mesh_pt_kernel of
// ascendpathtracing_tpu/ops/pallas_mesh_pt.py, with its replay residuals
// (with_residuals: wid and resv, pt_trace.cuh's Residuals); the camera,
// stats and debug outputs are not ported.
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
// branch: render_pt_mesh_kernel<T, NoResiduals> is the forward-only
// kernel, unchanged, and <T, Residuals<T>> the training forward.  The
// build log shows the registers of both.

#include <cuda_runtime.h>

#include <cstdint>

#include "chunk_walk.cuh"
#include "pt_trace.cuh"

namespace {

// Spheres + a chunk-grid mesh of 24-float attribute rows.
template <typename T>
struct MeshScene {
  Spheres<T> sph;
  ChunkGrid g;
  const float* tris;  // [C*T, TRI_ATTR_F]
  int tpc;

  __device__ __forceinline__ bool hit(T ox, T oy, T oz, T dx, T dy, T dz,
                                      T eps, T& tmin, Winner& w) const {
    w.sphere = sph.hit(ox, oy, oz, dx, dy, dz, eps, tmin);
    const RayInv<T> r = make_ray(ox, oy, oz, dx, dy, dz);
    const T gate = tmin;  // after the spheres, before the triangles
    int slot = -1;
    WalkCounts cnt = {0, 0, 0};
    walk_chunks<true>(
        g, r, gate,
        [&](int c) { test_chunk(tris, TRI_ATTR_F, c, tpc, r, eps, tmin, slot); },
        cnt);
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
template <typename T, typename Sink>
__global__ void __launch_bounds__(BLOCK, 1)
    render_pt_mesh_kernel(const T* __restrict__ scene,
                          const int32_t* __restrict__ materials,
                          const float* __restrict__ tris,
                          T* __restrict__ out, const PtParams<T> p,
                          const ChunkGrid grid, int s_count, int tpc,
                          bool shared_boxes, const Sink sink) {
  __shared__ T sc[PLANES][MAX_S];
  __shared__ int mat[MAX_S];
  extern __shared__ float smem[];
  if (static_cast<int>(threadIdx.x) < s_count) {
    mat[threadIdx.x] = materials[threadIdx.x];
  }
  MeshScene<T> world;
  world.g = boxes_to_shared(grid, smem, shared_boxes);  // syncs
  load_scene(sc, scene, s_count);                       // syncs
  const long long pix = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (pix >= p.n_pix) return;
  world.sph.sc = sc;
  world.sph.mat = mat;
  world.sph.count = s_count;
  world.tris = tris;
  world.tpc = tpc;
  render_pixel(world, p, pix, out, sink);
}

template <typename T>
int launch_mesh_pt(const void* scene, const void* materials,
                   const void* cboxes, const void* sboxes,
                   const void* ssboxes, const void* tris,
                   const void* uniforms, void* out, void* wid, void* resv,
                   int width, int height,
                   int spp4, int s_count, int n_chunks, int n_supers,
                   int n_supers2, int tris_per_chunk, int supers_per,
                   int supers2_per, int bounces, int rr_depth, double eps,
                   unsigned seed, const double* cam, void* stream) {
  if (s_count < 1 || s_count > MAX_S || tris == nullptr ||
      (wid == nullptr) != (resv == nullptr)) {
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
  const bool shared_boxes = boxes_fit_shared(g);
  const size_t smem = shared_boxes ? static_cast<size_t>(box_bytes(g)) : 0;
  const auto grid = static_cast<unsigned>((p.n_pix + BLOCK - 1) / BLOCK);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto sc = static_cast<const T*>(scene);
  const auto mt = static_cast<const int32_t*>(materials);
  const auto tr = static_cast<const float*>(tris);
  const auto o = static_cast<T*>(out);
  if (wid == nullptr) {
    render_pt_mesh_kernel<T, NoResiduals><<<grid, BLOCK, smem, st>>>(
        sc, mt, tr, o, p, g, s_count, tris_per_chunk, shared_boxes,
        NoResiduals());
  } else {
    Residuals<T> res;
    res.wid = static_cast<int32_t*>(wid);
    res.resv = static_cast<T*>(resv);
    res.plane = static_cast<long long>(spp4) * p.n_pix;
    res.at = 0;
    res.s_count = s_count;
    render_pt_mesh_kernel<T, Residuals<T>><<<grid, BLOCK, smem, st>>>(
        sc, mt, tr, o, p, g, s_count, tris_per_chunk, shared_boxes, res);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError()
// after the launch (0 = success); the wrapper raises on anything else.
// cam points at 11 host doubles; pointers and the stream arrive as void*.
// wid and resv are both null (forward only) or both set (residuals).
extern "C" {

int apt_mesh_pt_max_spheres() { return MAX_S; }
const char* apt_mesh_pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#define APT_MESH_PT(SUFFIX, T)                                                 \
  int apt_render_pt_mesh_##SUFFIX(                                             \
      const void* scene, const void* materials, const void* cboxes,           \
      const void* sboxes, const void* ssboxes, const void* tris,              \
      const void* uniforms, void* out, void* wid, void* resv, int width,     \
      int height, int spp4,                                                   \
      int s_count, int n_chunks, int n_supers, int n_supers2,                 \
      int tris_per_chunk, int supers_per, int supers2_per, int bounces,       \
      int rr_depth, double eps, unsigned seed, const double* cam,             \
      void* stream) {                                                         \
    return launch_mesh_pt<T>(scene, materials, cboxes, sboxes, ssboxes, tris, \
                             uniforms, out, wid, resv, width, height, spp4,   \
                             s_count,                                         \
                             n_chunks, n_supers, n_supers2, tris_per_chunk,   \
                             supers_per, supers2_per, bounces, rr_depth, eps, \
                             seed, cam, stream);                              \
  }

APT_MESH_PT(f32, float)
APT_MESH_PT(f64, double)

}  // extern "C"
