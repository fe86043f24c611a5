// Hand-written Hopper (sm_90a) kernel of the fully fused sphere path
// tracer: camera rays, random numbers, the bounce loop with diffuse,
// mirror and glass, Russian roulette, and the per-pixel mean over the
// sample layers, in one launch, for float and double.  It replaces
// _render_pt_kernel of ascendpathtracing_tpu/ops/pallas_kernels.py.
//
// Build (ops/build.py runs this at first use, into build/):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o librender_pt.so render_pt.cu
//
// PARITY RULE, as in render_ref.cu: -fmad=false and never
// --use_fast_math; IEEE sqrt and division; 1/sqrt(x) wherever the Pallas
// kernel has rsqrt; full-precision sincosf.  The expressions keep the
// Pallas kernel's op order term for term, so the plain twin
// (ops/pt_kernels.render_pt_plain: the same ops and the same random
// stream in torch) gives the same image.
//
// Random numbers.  The TPU's hardware PRNG is replaced by Philox4x32-10
// (ops/rng.py): key (seed, 0), counter (pixel, layer, block, 0), four
// uniforms (bits >> 8) * 2^-24 per call.  A sample's uniforms are
// numbered as the Pallas kernel consumes them: 0-1 for the camera's tent
// filter, then 2 + 3k + {0, 1, 2} for bounce k.  Keyed by counter, a path
// that ends early skips its later draws without shifting anyone else's.
// An optional [spp4, 2 + 3*bounces, W*H] buffer replaces Philox (parity
// tests at small sizes).
//
// Design: one thread per pixel loops over the spp4 sample layers in
// order and adds L / spp4 to registers that are written once: the Pallas
// kernel's accumulation order, no atomics, and an image that repeats bit
// for bit.  The [10, S] scene and the materials sit in shared memory.  A
// path leaves the bounce loop at a miss, when Russian roulette ends it
// (from there on the Pallas kernel's lanes carry only masked values), or
// when its throughput is exactly zero (pt_trace.cuh's render_pixel: the
// black front wall and the light of cornell8 and smallpt9 have albedo
// (0, 0, 0), and the later bounces of such a path would add exactly +0;
// the exit is taken only where the block found every emission and albedo
// of the scene finite).  Each material computes only its own BSDF.  Any
// W*H: the last block is guarded (Pallas needs W*H to be a multiple of
// its tile).  The sample itself (camera, bounce, pixel loop) is
// pt_trace.cuh, shared with the sphere+mesh kernel (mesh_pt.cu), so a
// mesh that no ray reaches gives this kernel's image bit for bit.
//
// Path regeneration (pt_trace.cuh's render_pixel_regen, the mesh
// kernel's loop: a lane begins its pixel's next layer as its path ends)
// was measured here and not kept: the steps a warp takes fall from the
// longest path of each layer to about the largest of its lanes' sums,
// but every step then pays for the lanes that make a camera ray and for
// Philox calls at other bounces than their neighbours', and the frame
// took longer than this loop (PERF.md, section 6).
//
// The debug dump (_render_pt_kernel's debug=True, pallas_kernels.py:
// 493-499): the instantiation with AliveDump (pt_trace.cuh) counts the
// paths of grid cell (0, 0) (pixels [0, debug_tile), sample layer 0)
// alive after each bounce, without the zero-throughput exit, and
// dump_pt_alive_kernel prints "pt_pallas alive: <count>.0" per bounce
// with device printf, the Pallas kernel's float32 sum.  The image is the
// same bit for bit; the instantiation without it keeps its code.
//
// Bound on the H100: FP32 throughput, about 20*S + 60 operations per live
// sample-bounce and 40 per camera ray against 12 B of HBM per pixel; with
// -fmad=false no multiply-add fuses, so the card issues at most half the
// 67 TFLOP/s the bound assumes.  Divergence between the three materials
// and the exits, and registers against occupancy (MinBlocks below; see
// `nvcc --resource-usage` in the build log), decide how much of it it
// reaches.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

// MAX_S, PLANES, BLOCK, load_scene, closest_hit (sphere_hit.cuh);
// Philox (philox.cuh); PtParams, Spheres, camera_path, bounce_path,
// render_pixel.
#include "pt_trace.cuh"

namespace {

// The scene of the sphere path tracer: spheres only.
template <typename T>
struct SphereScene {
  Spheres<T> sph;

  __device__ __forceinline__ bool hit(T ox, T oy, T oz, T dx, T dy, T dz,
                                      T eps, T& tmin, Winner& w, int, int) const {
    w.sphere = sph.hit(ox, oy, oz, dx, dy, dz, eps, tmin);
    w.slot = -1;
    return w.sphere >= 0;
  }

  __device__ __forceinline__ Surface<T> surface(const Winner& w, T hx, T hy,
                                                T hz) const {
    return sph.surface(w.sphere, hx, hy, hz);
  }
};

// ---------------------------------------------------------------------------
// The fused path tracer.  Replaces _render_pt_kernel of
// ascendpathtracing_tpu/ops/pallas_kernels.py.  out [3, W*H]: per-pixel
// means over the spp4 sample layers; pixel p is column i = p / H, row
// j = p % H, as the Pallas kernel's.
// ---------------------------------------------------------------------------
// __launch_bounds__(BLOCK, MinBlocks): ptxas fits the registers to
// MinBlocks resident blocks of 256 threads per SM (65,536 registers: 4
// blocks up to 64 a thread); the double instantiation serves the parity
// tests, and the debug one (AliveDump) the dump, which keeps its
// registers free of the cap rather than spill.
template <typename T, typename Dump>
struct MinBlocks {
  static constexpr int value = 1;
};
template <>
struct MinBlocks<float, NoPathDump> {
  static constexpr int value = 4;
};

template <typename T, typename Dump>
__global__ void __launch_bounds__(BLOCK, (MinBlocks<T, Dump>::value))
    render_pt_kernel(const T* __restrict__ scene,
                     const int32_t* __restrict__ materials,
                     T* __restrict__ out, const PtParams<T> p, int s_count,
                     const Dump dump) {
  __shared__ T sc[PLANES][MAX_S];
  __shared__ int mat[MAX_S];
  const int tid = static_cast<int>(threadIdx.x);
  if (tid < s_count) mat[tid] = materials[tid];
  load_scene(sc, scene, s_count);  // also syncs for mat
  // The zero-throughput exit needs every emission and albedo (planes 4-9)
  // finite.
  const bool finite =
      __syncthreads_and(tid >= 6 * s_count || isfinite(sc[4 + tid / s_count][tid % s_count]));
  const long long pix = static_cast<long long>(blockIdx.x) * BLOCK + tid;
  if (pix >= p.n_pix) return;
  SphereScene<T> world;
  world.sph.sc = sc;
  world.sph.mat = mat;
  world.sph.count = s_count;
  render_pixel(world, p, pix, out, finite, dump);
}

// The debug dump's lines: "pt_pallas alive" after each bounce, the Pallas
// kernel's float32 sum of its 0/1 lanes.
__global__ void dump_pt_alive_kernel(const int* alive, int bounces) {
  for (int k = 0; k < bounces; ++k) printf("pt_pallas alive: %d.0\n", alive[k]);
}

template <typename T>
int launch_pt(const void* scene, const void* materials, const void* uniforms,
              void* out, int width, int height, int spp4, int s_count,
              int bounces, int rr_depth, double eps, unsigned seed,
              const double* cam, void* debug_alive, long long debug_tile,
              void* stream) {
  if (s_count < 1 || s_count > MAX_S || (debug_alive != nullptr && debug_tile < 1)) {
    return cudaErrorInvalidValue;
  }
  PtParams<T> p;
  const int err = make_pt_params(p, uniforms, width, height, spp4, bounces,
                                 rr_depth, eps, seed, cam);
  if (err != 0) return err;
  const auto grid = static_cast<unsigned>((p.n_pix + BLOCK - 1) / BLOCK);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto sc = static_cast<const T*>(scene);
  const auto mt = static_cast<const int32_t*>(materials);
  if (debug_alive == nullptr) {
    render_pt_kernel<T, NoPathDump><<<grid, BLOCK, 0, st>>>(sc, mt, static_cast<T*>(out), p,
                                                            s_count, NoPathDump());
  } else {
    const AliveDump dump{static_cast<int*>(debug_alive), debug_tile};
    render_pt_kernel<T, AliveDump><<<grid, BLOCK, 0, st>>>(sc, mt, static_cast<T*>(out), p,
                                                           s_count, dump);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || bounces == 0) return e;
    dump_pt_alive_kernel<<<1, 1, 0, st>>>(dump.alive, bounces);
    e = cudaGetLastError();
    if (e == cudaSuccess) e = cudaStreamSynchronize(st);  // prints the lines
    fflush(stdout);
    return e;
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError()
// after the launch (0 = success); the wrapper raises on anything else.
// cam points at 11 host doubles; pointers and the stream arrive as void*.
// debug_alive (int32 [bounces], zeroed) is null, or the debug dump's
// counts over the pixels [0, debug_tile) of sample layer 0; with it the
// call prints the dump and returns after the stream has synchronized.
extern "C" {

int apt_pt_max_spheres() { return MAX_S; }
const char* apt_pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int apt_render_pt_f32(const void* scene, const void* materials,
                      const void* uniforms, void* out, int width, int height,
                      int spp4, int s_count, int bounces, int rr_depth,
                      double eps, unsigned seed, const double* cam,
                      void* debug_alive, long long debug_tile, void* stream) {
  return launch_pt<float>(scene, materials, uniforms, out, width, height, spp4,
                          s_count, bounces, rr_depth, eps, seed, cam,
                          debug_alive, debug_tile, stream);
}
int apt_render_pt_f64(const void* scene, const void* materials,
                      const void* uniforms, void* out, int width, int height,
                      int spp4, int s_count, int bounces, int rr_depth,
                      double eps, unsigned seed, const double* cam,
                      void* debug_alive, long long debug_tile, void* stream) {
  return launch_pt<double>(scene, materials, uniforms, out, width, height,
                           spp4, s_count, bounces, rr_depth, eps, seed, cam,
                           debug_alive, debug_tile, stream);
}

}  // extern "C"
