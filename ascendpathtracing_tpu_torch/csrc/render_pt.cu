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
// kernel has rsqrt; full-precision sinf/cosf.  The expressions keep the
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
// path leaves the bounce loop at a miss or when Russian roulette ends it
// (from there on the Pallas kernel's lanes carry only masked values), and
// each material computes only its own BSDF.  Any W*H: the last block is
// guarded (Pallas needs W*H to be a multiple of its tile).  The sample
// itself (camera, bounce loop, pixel loop) is pt_trace.cuh, shared with
// the sphere+mesh kernel (mesh_pt.cu), so a mesh that no ray reaches
// gives this kernel's image bit for bit.
//
// Bound on the H100: FP32 throughput, about 14*S + 150 flops per sample-bounce
// against 12 B of HBM per pixel.  Divergence between the three materials
// and the RR exits, and registers against occupancy, decide how much of
// the peak it reaches; see `nvcc --resource-usage` in the build log.

#include <cuda_runtime.h>

#include <cstdint>

// MAX_S, PLANES, BLOCK, load_scene, closest_hit (sphere_hit.cuh);
// Philox (philox.cuh); PtParams, Spheres, trace_sample, render_pixel.
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
template <typename T>
__global__ void __launch_bounds__(BLOCK)
    render_pt_kernel(const T* __restrict__ scene,
                     const int32_t* __restrict__ materials,
                     T* __restrict__ out, const PtParams<T> p, int s_count) {
  __shared__ T sc[PLANES][MAX_S];
  __shared__ int mat[MAX_S];
  if (static_cast<int>(threadIdx.x) < s_count) {
    mat[threadIdx.x] = materials[threadIdx.x];
  }
  load_scene(sc, scene, s_count);  // also syncs for mat
  const long long pix = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (pix >= p.n_pix) return;
  SphereScene<T> world;
  world.sph.sc = sc;
  world.sph.mat = mat;
  world.sph.count = s_count;
  render_pixel(world, p, pix, out);
}

template <typename T>
int launch_pt(const void* scene, const void* materials, const void* uniforms,
              void* out, int width, int height, int spp4, int s_count,
              int bounces, int rr_depth, double eps, unsigned seed,
              const double* cam, void* stream) {
  if (s_count < 1 || s_count > MAX_S) return cudaErrorInvalidValue;
  PtParams<T> p;
  const int err = make_pt_params(p, uniforms, width, height, spp4, bounces,
                                 rr_depth, eps, seed, cam);
  if (err != 0) return err;
  const auto grid = static_cast<unsigned>((p.n_pix + BLOCK - 1) / BLOCK);
  render_pt_kernel<T><<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(scene), static_cast<const int32_t*>(materials),
      static_cast<T*>(out), p, s_count);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError()
// after the launch (0 = success); the wrapper raises on anything else.
// cam points at 11 host doubles; pointers and the stream arrive as void*.
extern "C" {

int apt_pt_max_spheres() { return MAX_S; }
const char* apt_pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int apt_render_pt_f32(const void* scene, const void* materials,
                      const void* uniforms, void* out, int width, int height,
                      int spp4, int s_count, int bounces, int rr_depth,
                      double eps, unsigned seed, const double* cam,
                      void* stream) {
  return launch_pt<float>(scene, materials, uniforms, out, width, height, spp4,
                          s_count, bounces, rr_depth, eps, seed, cam, stream);
}
int apt_render_pt_f64(const void* scene, const void* materials,
                      const void* uniforms, void* out, int width, int height,
                      int spp4, int s_count, int bounces, int rr_depth,
                      double eps, unsigned seed, const double* cam,
                      void* stream) {
  return launch_pt<double>(scene, materials, uniforms, out, width, height,
                           spp4, s_count, bounces, rr_depth, eps, seed, cam,
                           stream);
}

}  // extern "C"
