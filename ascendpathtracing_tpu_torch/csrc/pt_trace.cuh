// The path-tracing sample shared by the fused kernels (render_pt.cu for
// spheres, mesh_pt.cu for spheres + a chunk-grid mesh): the camera ray
// with tent-filter jitter, the bounce loop with diffuse, mirror and
// glass, Russian roulette, and the per-pixel mean over the sample layers.
// The scene is a template parameter: its hit() finds the nearest winner
// of a ray and its surface() returns what the shading needs from it.
// Same parity rule as the kernels: -fmad=false, never --use_fast_math;
// IEEE sqrt and division; 1/sqrt(x) wherever the Pallas kernels have
// rsqrt; full-precision sinf/cosf; the Pallas kernels' op order term for
// term (pallas_kernels.py:293-525, pallas_mesh_pt.py:195-556).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "sphere_hit.cuh"

namespace {

constexpr int DIFF = 0;  // scenes.DIFF; any code but DIFF and REFR is SPEC
constexpr int REFR = 2;  // scenes.REFR
constexpr int CAM = 11;  // px py pz dx0 dy0 dz0 cxx cyx cyy cyz push

template <typename T>
struct PtParams {
  T cam[CAM];           // camera position, unit direction, cx.x, cy, push
  T eps;
  T inv_spp;            // 1 / spp4
  const T* uniforms;    // [spp4, nu, n_pix], or nullptr for Philox
  long long n_pix;      // W * H
  int width, height, spp4, bounces, rr_depth, nu;
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

// The winner of one bounce: a sphere index and a triangle slot, -1 where
// none (a triangle winner leaves the sphere index as the spheres found
// it; the slot decides).
struct Winner {
  int sphere, slot;
};

// What the shading needs from the winner.
template <typename T>
struct Surface {
  T nx, ny, nz;  // unit geometric normal
  T er, eg, eb;  // emission
  T ar, ag, ab;  // albedo
  T r2;          // squared radius for the origin offset; 0 for triangles
  bool diff, refr;
};

// The [10, S] sphere table in shared memory and its materials.
template <typename T>
struct Spheres {
  T (*sc)[MAX_S];
  const int* mat;
  int count;

  __device__ __forceinline__ int hit(T ox, T oy, T oz, T dx, T dy, T dz,
                                     T eps, T& tmin) const {
    return closest_hit(sc, count, ox, oy, oz, dx, dy, dz, eps, tmin);
  }

  // Sphere normal normalize(hit - center), 0 where the squared norm is 0.
  __device__ __forceinline__ Surface<T> surface(int win, T hx, T hy,
                                                T hz) const {
    Surface<T> s;
    const T nx = hx - sc[1][win];
    const T ny = hy - sc[2][win];
    const T nz = hz - sc[3][win];
    const T n2 = nx * nx + ny * ny + nz * nz;
    const T ninv = n2 > T(0) ? T(1) / root(n2) : T(0);
    s.nx = nx * ninv;
    s.ny = ny * ninv;
    s.nz = nz * ninv;
    s.er = sc[4][win];
    s.eg = sc[5][win];
    s.eb = sc[6][win];
    s.ar = sc[7][win];
    s.ag = sc[8][win];
    s.ab = sc[9][win];
    s.r2 = sc[0][win];
    const int m = mat[win];
    s.diff = m == DIFF;
    s.refr = m == REFR;
    return s;
  }
};

// One sample of pixel (pi, pj) in sample layer `layer` -> its radiance.
// The surfaces' material flags are exclusive (a sphere has one code; a
// triangle row's one-hots come from one code).
template <typename T, typename Scene>
__device__ __forceinline__ void trace_sample(const Scene& scene,
                                             const PtParams<T>& p, int layer,
                                             T pi, T pj, SampleUniforms<T>& u,
                                             T& lr, T& lg, T& lb) {
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
    Winner w;
    if (!scene.hit(ox, oy, oz, dx, dy, dz, p.eps, tmin, w)) break;  // a miss ends the path

    const T hx = ox + dx * tmin;
    const T hy = oy + dy * tmin;
    const T hz = oz + dz * tmin;
    const Surface<T> sf = scene.surface(w, hx, hy, hz);
    const T nx = sf.nx, ny = sf.ny, nz = sf.nz;
    const T dn = dx * nx + dy * ny + dz * nz;
    const bool into = dn < T(0);
    const T sgn = into ? T(1) : T(-1);
    const T nlx = nx * sgn, nly = ny * sgn, nlz = nz * sgn;

    lr = lr + tr * sf.er;
    lg = lg + tg * sf.eg;
    lb = lb + tb * sf.eb;

    const int q = 2 + 3 * k;  // this bounce's uniforms: q, q + 1, q + 2
    T ndx, ndy, ndz;
    T scl = T(1);
    if (sf.diff) {
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
      if (sf.refr) {
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
    tr = tr * sf.ar * scl;
    tg = tg * sf.ag * scl;
    tb = tb * sf.ab * scl;

    if (k >= p.rr_depth) {  // Russian roulette (pallas :469-476)
      const T pmax = minv(maxv(maxv(maxv(tr, tg), tb), T(0.1)), T(0.95));
      if (!(u(q + 2) < pmax)) break;
      const T pinv = T(1) / pmax;
      tr = tr * pinv;
      tg = tg * pinv;
      tb = tb * pinv;
    }

    // Scale-aware offset, 0 for glass (pallas :482-491); the float32
    // REL_OFFSET in both instantiations; r2 = 0 keeps the eps floor.
    const T off = sf.refr ? T(0) : maxv(p.eps, T(1e-6) * root(sf.r2));
    ox = hx + nlx * off;
    oy = hy + nly * off;
    oz = hz + nlz * off;
    dx = ndx;
    dy = ndy;
    dz = ndz;
  }
}

// One thread's pixel: the spp4 sample layers in order, each adding
// L / spp4 to registers written once to out [3, W*H] (pixel p is column
// p / H, row p % H, as the Pallas kernels'): no atomics, and an image
// that repeats bit for bit.
template <typename T, typename Scene>
__device__ __forceinline__ void render_pixel(const Scene& scene,
                                             const PtParams<T>& p,
                                             long long pix, T* out) {
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
    trace_sample(scene, p, a, pi, pj, u, lr, lg, lb);
    ar = ar + lr * p.inv_spp;
    ag = ag + lg * p.inv_spp;
    ab = ab + lb * p.inv_spp;
  }
  out[pix] = ar;
  out[p.n_pix + pix] = ag;
  out[2 * p.n_pix + pix] = ab;
}

// PtParams from the launcher's host arguments; 0 or an error code.
template <typename T>
int make_pt_params(PtParams<T>& p, const void* uniforms, int width,
                   int height, int spp4, int bounces, int rr_depth,
                   double eps, unsigned seed, const double* cam) {
  if (width < 1 || height < 1 || spp4 < 4 || spp4 % 4 != 0 || bounces < 0 ||
      rr_depth < 0 || cam == nullptr) {
    return cudaErrorInvalidValue;
  }
  const long long n = static_cast<long long>(width) * height;
  if (n > 0xffffffffLL) return cudaErrorInvalidValue;  // 32-bit counter word
  for (int i = 0; i < CAM; ++i) p.cam[i] = static_cast<T>(cam[i]);
  p.eps = static_cast<T>(eps);
  p.inv_spp = static_cast<T>(1.0 / spp4);
  p.uniforms = static_cast<const T*>(uniforms);
  p.n_pix = n;
  p.width = width;
  p.height = height;
  p.spp4 = spp4;
  p.bounces = bounces;
  p.rr_depth = rr_depth;
  p.nu = 2 + 3 * bounces;
  p.seed = seed;
  return 0;
}

}  // namespace
