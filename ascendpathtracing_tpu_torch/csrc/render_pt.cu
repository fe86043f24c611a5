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
// guarded (Pallas needs W*H to be a multiple of its tile).
//
// Bound on the H100: FP32 throughput, about 14*S + 150 flops per sample-bounce
// against 12 B of HBM per pixel.  Divergence between the three materials
// and the RR exits, and registers against occupancy, decide how much of
// the peak it reaches; see `nvcc --resource-usage` in the build log.

#include <cuda_runtime.h>

#include <cstdint>

// MAX_S, PLANES, BLOCK, load_scene and closest_hit.
#include "sphere_hit.cuh"

namespace {

constexpr int DIFF = 0;  // scenes.DIFF; any code but DIFF and REFR is SPEC
constexpr int REFR = 2;  // scenes.REFR
constexpr int CAM = 11;  // px py pz dx0 dy0 dz0 cxx cyx cyy cyz push

template <typename T>
struct PtParams {
  T cam[CAM];           // camera.Camera().basis(W, H) and origin push
  T eps;
  T inv_spp;            // 1 / spp4
  const T* uniforms;    // [spp4, nu, n_pix], or nullptr for Philox
  long long n_pix;      // W * H
  int width, height, spp4, s_count, bounces, rr_depth, nu;
  uint32_t seed;
};

__device__ __forceinline__ float cosv(float x) { return cosf(x); }
__device__ __forceinline__ double cosv(double x) { return cos(x); }
__device__ __forceinline__ float sinv(float x) { return sinf(x); }
__device__ __forceinline__ double sinv(double x) { return sin(x); }

template <typename T>
__device__ __forceinline__ T maxv(T a, T b) {
  return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T minv(T a, T b) {
  return a < b ? a : b;
}

template <typename T>
__device__ __forceinline__ T absv(T a) {
  return a < T(0) ? -a : a;
}

// Philox4x32-10 (Salmon et al., SC 2011), as ops/rng.philox4x32.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The uniforms of one (pixel, layer) sample, numbered q = 0, 1, ...
// The words of the last Philox block are kept, so consecutive q cost one
// Philox call per four.
template <typename T>
struct SampleUniforms {
  const T* buf;         // &uniforms[layer][0][pixel], or nullptr: Philox
  long long stride;     // the buffer's step from q to q + 1 (W * H)
  uint32_t pixel, layer, seed;
  uint32_t block;       // the block held in w; 0xffffffff for none
  uint4 w;

  __device__ __forceinline__ T operator()(int q) {
    if (buf != nullptr) return buf[q * stride];
    const uint32_t b = static_cast<uint32_t>(q) >> 2;
    if (b != block) {
      w = philox4x32_10(make_uint4(pixel, layer, b, 0u), seed, 0u);
      block = b;
    }
    const int i = q & 3;
    const uint32_t bits = i == 0 ? w.x : (i == 1 ? w.y : (i == 2 ? w.z : w.w));
    return T(bits >> 8) * T(1.0 / 16777216.0);
  }
};

// One sample of pixel (pi, pj) in sample layer `layer` -> its radiance.
// The Pallas kernel's camera (pallas_kernels.py:293-308) and bounce
// (:330-500), with the RR phase from bounce rr_depth (:503-525).
template <typename T>
__device__ __forceinline__ void trace_sample(T (*sc)[MAX_S], const int* mat,
                                             const PtParams<T>& p, int layer,
                                             T pi, T pj,
                                             SampleUniforms<T>& u, T& lr,
                                             T& lg, T& lb) {
  // ---- camera ray: tent-filter jitter on the (sy, sx) sub-pixel -------
  const int s = p.spp4 / 4;
  const int sy = layer / (2 * s);
  const int sx = (layer / s) % 2;
  const T r1 = T(2) * u(0);
  const T r2 = T(2) * u(1);
  const T jx = r1 < T(1) ? root(r1) - T(1) : T(1) - root(maxv(T(2) - r1, T(0)));
  const T jy = r2 < T(1) ? root(r2) - T(1) : T(1) - root(maxv(T(2) - r2, T(0)));
  const T su = ((T(sx) + T(0.5) + jx) / T(2) + pi) / T(p.width) - T(0.5);
  const T sv = ((T(sy) + T(0.5) + jy) / T(2) + pj) / T(p.height) - T(0.5);
  const T* c = p.cam;
  const T ddx = su * c[6] + sv * c[7] + c[3];
  const T ddy = sv * c[8] + c[4];
  const T ddz = sv * c[9] + c[5];
  T ox = c[0] + ddx * c[10];
  T oy = c[1] + ddy * c[10];
  T oz = c[2] + ddz * c[10];
  const T inv = T(1) / root(ddx * ddx + ddy * ddy + ddz * ddz);
  T dx = ddx * inv, dy = ddy * inv, dz = ddz * inv;

  T tr = T(1), tg = T(1), tb = T(1);
  lr = T(0);
  lg = T(0);
  lb = T(0);
  for (int k = 0; k < p.bounces; ++k) {
    T tmin;
    const int win = closest_hit(sc, p.s_count, ox, oy, oz, dx, dy, dz, p.eps, tmin);
    if (win < 0) break;  // a miss ends the path

    const T hx = ox + dx * tmin;
    const T hy = oy + dy * tmin;
    const T hz = oz + dz * tmin;
    T nx = hx - sc[1][win];
    T ny = hy - sc[2][win];
    T nz = hz - sc[3][win];
    const T n2 = nx * nx + ny * ny + nz * nz;
    const T ninv = n2 > T(0) ? T(1) / root(n2) : T(0);
    nx = nx * ninv;
    ny = ny * ninv;
    nz = nz * ninv;
    const T dn = dx * nx + dy * ny + dz * nz;
    const bool into = dn < T(0);
    const T sgn = into ? T(1) : T(-1);
    const T nlx = nx * sgn, nly = ny * sgn, nlz = nz * sgn;

    lr = lr + tr * sc[4][win];
    lg = lg + tg * sc[5][win];
    lb = lb + tb * sc[6][win];

    const int q = 2 + 3 * k;  // this bounce's uniforms: q, q + 1, q + 2
    const int m = mat[win];
    T ndx, ndy, ndz;
    T scl = T(1);
    if (m == DIFF) {
      // Cosine hemisphere sample, not renormalized (pallas :406-426).
      const T u0 = u(q);
      const T u1 = u(q + 1);
      const T phi = T(2.0 * 3.14159265358979) * u0;
      const T r2sq = root(u1);
      const bool flip = absv(nlx) > T(0.1);
      const T axx = flip ? T(0) : T(1);
      const T axy = flip ? T(1) : T(0);
      T ux = axy * nlz;
      T uy = (-axx) * nlz;
      T uz = axx * nly - axy * nlx;
      const T un = T(1) / root(maxv(ux * ux + uy * uy + uz * uz, T(1e-20)));
      ux = ux * un;
      uy = uy * un;
      uz = uz * un;
      const T vx = nly * uz - nlz * uy;
      const T vy = nlz * ux - nlx * uz;
      const T vz = nlx * uy - nly * ux;
      const T cw = root(maxv(T(1) - u1, T(0)));
      const T cphi = cosv(phi) * r2sq;
      const T sphi = sinv(phi) * r2sq;
      ndx = ux * cphi + vx * sphi + nlx * cw;
      ndy = uy * cphi + vy * sphi + nly * cw;
      ndz = uz * cphi + vz * sphi + nlz * cw;
    } else {
      // Mirror reflection about the geometric normal (pallas :428-430).
      const T td = T(2) * dn;
      ndx = dx - td * nx;
      ndy = dy - td * ny;
      ndz = dz - td * nz;
      if (m == REFR) {
        // Dielectric, IOR 1.5, Schlick Fresnel (pallas :432-457).
        constexpr double kR0 = (0.5 * 0.5) / (2.5 * 2.5);
        const T u0 = u(q);
        const T nnt = into ? T(1.0 / 1.5) : T(1.5);
        const T ddn = dx * nlx + dy * nly + dz * nlz;
        const T cos2t = T(1) - nnt * nnt * (T(1) - ddn * ddn);
        const bool tir = cos2t < T(0);
        const T sqc = root(maxv(cos2t, T(0)));
        const T coef = sgn * (ddn * nnt + sqc);
        T tdx = dx * nnt - nx * coef;
        T tdy = dy * nnt - ny * coef;
        T tdz = dz * nnt - nz * coef;
        const T tinv =
            T(1) / root(maxv(tdx * tdx + tdy * tdy + tdz * tdz, T(1e-20)));
        tdx = tdx * tinv;
        tdy = tdy * tinv;
        tdz = tdz * tinv;
        const T cth = T(1) - (into ? -ddn : tdx * nx + tdy * ny + tdz * nz);
        const T re = T(kR0) + T(1.0 - kR0) * cth * cth * cth * cth * cth;
        const T pp = T(0.25) + T(0.5) * re;
        const bool pick_refl = (u0 < pp) || tir;
        if (!pick_refl) {
          ndx = tdx;
          ndy = tdy;
          ndz = tdz;
        }
        scl = tir ? T(1) : (pick_refl ? re / pp : (T(1) - re) / (T(1) - pp));
      }
    }
    tr = tr * sc[7][win] * scl;
    tg = tg * sc[8][win] * scl;
    tb = tb * sc[9][win] * scl;

    if (k >= p.rr_depth) {  // Russian roulette (pallas :469-476)
      const T pmax = minv(maxv(maxv(maxv(tr, tg), tb), T(0.1)), T(0.95));
      if (!(u(q + 2) < pmax)) break;
      const T pinv = T(1) / pmax;
      tr = tr * pinv;
      tg = tg * pinv;
      tb = tb * pinv;
    }

    // Scale-aware offset, 0 for glass (pallas :482-491); the float32
    // REL_OFFSET in both instantiations.
    const T off = m == REFR ? T(0) : maxv(p.eps, T(1e-6) * root(sc[0][win]));
    ox = hx + nlx * off;
    oy = hy + nly * off;
    oz = hz + nlz * off;
    dx = ndx;
    dy = ndy;
    dz = ndz;
  }
}

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
                     T* __restrict__ out, const PtParams<T> p) {
  __shared__ T sc[PLANES][MAX_S];
  __shared__ int mat[MAX_S];
  if (static_cast<int>(threadIdx.x) < p.s_count) {
    mat[threadIdx.x] = materials[threadIdx.x];
  }
  load_scene(sc, scene, p.s_count);  // also syncs for mat
  const long long pix = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (pix >= p.n_pix) return;

  SampleUniforms<T> u;
  u.stride = p.n_pix;
  u.pixel = static_cast<uint32_t>(pix);
  u.seed = p.seed;
  const T pi = T(pix / p.height);
  const T pj = T(pix % p.height);
  T ar = T(0), ag = T(0), ab = T(0);
  for (int a = 0; a < p.spp4; ++a) {
    u.buf = p.uniforms == nullptr
                ? nullptr
                : p.uniforms + static_cast<long long>(a) * p.nu * p.n_pix + pix;
    u.layer = static_cast<uint32_t>(a);
    u.block = 0xffffffffu;
    T lr, lg, lb;
    trace_sample(sc, mat, p, a, pi, pj, u, lr, lg, lb);
    ar = ar + lr * p.inv_spp;
    ag = ag + lg * p.inv_spp;
    ab = ab + lb * p.inv_spp;
  }
  out[pix] = ar;
  out[p.n_pix + pix] = ag;
  out[2 * p.n_pix + pix] = ab;
}

template <typename T>
int launch_pt(const void* scene, const void* materials, const void* uniforms,
              void* out, int width, int height, int spp4, int s_count,
              int bounces, int rr_depth, double eps, unsigned seed,
              const double* cam, void* stream) {
  if (width < 1 || height < 1 || spp4 < 4 || spp4 % 4 != 0 || s_count < 1 ||
      s_count > MAX_S || bounces < 0 || rr_depth < 0 || cam == nullptr) {
    return cudaErrorInvalidValue;
  }
  const long long n = static_cast<long long>(width) * height;
  if (n > 0xffffffffLL) return cudaErrorInvalidValue;  // 32-bit counter word
  PtParams<T> p;
  for (int i = 0; i < CAM; ++i) p.cam[i] = static_cast<T>(cam[i]);
  p.eps = static_cast<T>(eps);
  p.inv_spp = static_cast<T>(1.0 / spp4);
  p.uniforms = static_cast<const T*>(uniforms);
  p.n_pix = n;
  p.width = width;
  p.height = height;
  p.spp4 = spp4;
  p.s_count = s_count;
  p.bounces = bounces;
  p.rr_depth = rr_depth;
  p.nu = 2 + 3 * bounces;
  p.seed = seed;
  const auto grid = static_cast<unsigned>((n + BLOCK - 1) / BLOCK);
  render_pt_kernel<T><<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(scene), static_cast<const int32_t*>(materials),
      static_cast<T*>(out), p);
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
