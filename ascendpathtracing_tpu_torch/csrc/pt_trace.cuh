// The path-tracing sample shared by the fused kernels (render_pt.cu for
// spheres, mesh_pt.cu for spheres + a chunk-grid mesh): the camera ray
// with tent-filter jitter, one bounce with diffuse, mirror and glass and
// Russian roulette, and the per-pixel mean over the sample layers, as a
// per-thread loop (render_pixel) or a warp's loop with path regeneration
// (render_pixel_regen).  The scene is a template parameter: its hit() or
// hit_warp() finds the nearest winner of a ray (told the sample layer and
// bounce) and its surface() returns what the shading needs from it.
// Same parity rule as the kernels: -fmad=false, never --use_fast_math;
// IEEE sqrt and division; 1/sqrt(x) wherever the Pallas kernels have
// rsqrt; full-precision sincosf; the Pallas kernels' op order term for
// term (pallas_kernels.py:293-525, pallas_mesh_pt.py:195-556).

#pragma once

#include <cuda_runtime.h>

#include <climits>
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

// sin and cos of one angle at once (one range reduction); the card tests
// hold the values bitwise to the twins' torch.sin and torch.cos.
__device__ __forceinline__ void sincosv(float x, float& s, float& c) { sincosf(x, &s, &c); }
__device__ __forceinline__ void sincosv(double x, double& s, double& c) { sincos(x, &s, &c); }

// max and min that give NaN where either side is NaN, as the twins'
// torch.maximum, clamp and clamp_min (and the Pallas kernels' jnp.maximum
// and clip) do: a NaN throughput then fails Russian roulette's u < pmax
// and ends the path there.  One min.NaN / max.NaN instruction for float.
__device__ __forceinline__ float maxv(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float minv(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ double maxv(double a, double b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ double minv(double a, double b) { return (a < b || a != a) ? a : b; }

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

// Where the bounce loop puts its replay residuals.  NoResiduals (the
// default) stores nothing and compiles to the forward-only kernel;
// Residuals writes each bounce's winner code and the values the replay
// backward needs (pallas_mesh_pt.py:514-532); CameraResiduals also each
// sample's screen coordinates (with_camera, pallas_mesh_pt.py:211-216).
struct NoResiduals {
  __device__ __forceinline__ void begin(long long, int, long long) {}
  template <typename T>
  __device__ __forceinline__ void camera(T, T) const {}
  template <typename T>
  __device__ __forceinline__ void store(int, const Winner&, const Surface<T>&,
                                        T) const {}
  __device__ __forceinline__ void fill_dead(int, int) const {}
};

// wid [bounces, spp4, n_pix] int32: the winner code of each bounce (sphere
// index, S + triangle slot, -1 where the path took no bounce); resv
// [bounces, 7, spp4, n_pix]: the winner's albedo and emission and the
// detached scalar s = glass rscale x RR weight, zeros on dead bounces.
// Offsets are 64-bit: resv has more than 2^31 elements at full size.
// Neighbouring threads are neighbouring pixels, so the stores coalesce.
template <typename T>
struct Residuals {
  int32_t* wid;
  T* resv;
  long long plane;  // spp4 * n_pix: the stride of one bounce, one resv row
  long long at;     // layer * n_pix + pixel
  int s_count;      // S: triangle slot c has the code S + c

  __device__ __forceinline__ void begin(long long pix, int layer,
                                        long long n_pix) {
    at = static_cast<long long>(layer) * n_pix + pix;
  }
  __device__ __forceinline__ void store(int k, const Winner& w,
                                        const Surface<T>& sf, T s) const {
    wid[k * plane + at] = w.slot >= 0 ? s_count + w.slot : w.sphere;
    T* r = resv + 7LL * k * plane + at;
    r[0] = sf.ar;
    r[plane] = sf.ag;
    r[2 * plane] = sf.ab;
    r[3 * plane] = sf.er;
    r[4 * plane] = sf.eg;
    r[5 * plane] = sf.eb;
    r[6 * plane] = s;
  }
  __device__ __forceinline__ void fill_dead(int k0, int k1) const {
    for (int k = k0; k < k1; ++k) {
      wid[k * plane + at] = -1;
      T* r = resv + 7LL * k * plane + at;
      for (int j = 0; j < 7; ++j) r[j * plane] = T(0);
    }
  }
  __device__ __forceinline__ void camera(T, T) const {}
};

// suv [2, spp4, n_pix]: the (su, sv) the sample's primary ray was made
// from, stored once per sample beside the residuals, coalesced as wid.
template <typename T>
struct CameraResiduals : Residuals<T> {
  T* suv;

  __device__ __forceinline__ void camera(T su, T sv) const {
    suv[this->at] = su;
    suv[this->plane + this->at] = sv;
  }
};

// The `debug` dump's count of paths alive after each bounce (the Pallas
// kernels' lane mask: the ray hit something and Russian roulette kept the
// path), over grid cell (0, 0) of the Pallas kernels: pixels [0, tile) of
// sample layer 0.  NoPathDump counts nothing and keeps render_pixel's
// zero-throughput exit; AliveDump turns the exit off, since a Pallas lane
// with zero throughput stays alive until a miss or Russian roulette ends
// it (the exit leaves the image bit for bit: render_pixel says why).
struct NoPathDump {
  static constexpr bool kZeroExit = true;
  __device__ __forceinline__ void goes_on(long long, int, int) const {}
};

struct AliveDump {
  static constexpr bool kZeroExit = false;
  int* alive;      // [bounces], zeroed by the wrapper
  long long tile;  // the pixels of the Pallas kernel's cell

  __device__ __forceinline__ void goes_on(long long pix, int layer, int k) const {
    if (layer == 0 && pix < tile) atomicAdd(alive + k, 1);
  }
};

// One path between bounces: the ray of its next bounce, its throughput
// and the radiance gathered so far.
template <typename T>
struct Path {
  T ox, oy, oz, dx, dy, dz;
  T tr, tg, tb;
  T lr, lg, lb;
};

// The camera ray of pixel (pi, pj) in sample layer `layer`: tent-filter
// jitter on the (sy, sx) sub-pixel; the sink keeps its (su, sv).
template <typename T, typename Sink>
__device__ __forceinline__ Path<T> camera_path(const PtParams<T>& p, int layer,
                                               T pi, T pj, SampleUniforms<T>& u,
                                               const Sink& sink) {
  const int s = p.spp4 / 4;
  const int sy = layer / (2 * s);
  const int sx = (layer / s) % 2;
  const T r1 = T(2) * u(0);
  const T r2 = T(2) * u(1);
  const T jx = r1 < T(1) ? root(r1) - T(1) : T(1) - root(maxv(T(2) - r1, T(0)));
  const T jy = r2 < T(1) ? root(r2) - T(1) : T(1) - root(maxv(T(2) - r2, T(0)));
  const T su = ((T(sx) + T(0.5) + jx) / T(2) + pi) / T(p.width) - T(0.5);
  const T sv = ((T(sy) + T(0.5) + jy) / T(2) + pj) / T(p.height) - T(0.5);
  sink.camera(su, sv);
  const T* c = p.cam;
  const T ddx = su * c[6] + sv * c[7] + c[3];
  const T ddy = sv * c[8] + c[4];
  const T ddz = sv * c[9] + c[5];
  Path<T> path;
  path.ox = c[0] + ddx * c[10];
  path.oy = c[1] + ddy * c[10];
  path.oz = c[2] + ddz * c[10];
  const T inv = T(1) / root(ddx * ddx + ddy * ddy + ddz * ddz);
  path.dx = ddx * inv;
  path.dy = ddy * inv;
  path.dz = ddz * inv;
  path.tr = T(1);
  path.tg = T(1);
  path.tb = T(1);
  path.lr = T(0);
  path.lg = T(0);
  path.lb = T(0);
  return path;
}

// Bounce k of a path whose ray hit winner w at tmin: emission, the BSDF
// sample, throughput, Russian roulette, the residual store and the next
// ray.  Returns false where Russian roulette ended the path; the next ray
// is made all the same and goes unread (no branch around it: render_pt's
// kernel keeps the registers and the time of its per-thread sample that
// way).  The surfaces' material flags are exclusive (a sphere has one
// code; a triangle row's one-hots come from one code).
template <typename T, typename Scene, typename Sink>
__device__ __forceinline__ bool bounce_path(const Scene& scene,
                                            const PtParams<T>& p, Path<T>& path,
                                            int k, T tmin, const Winner& w,
                                            SampleUniforms<T>& u,
                                            const Sink& sink) {
  const T dx = path.dx, dy = path.dy, dz = path.dz;
  const T hx = path.ox + dx * tmin;
  const T hy = path.oy + dy * tmin;
  const T hz = path.oz + dz * tmin;
  const Surface<T> sf = scene.surface(w, hx, hy, hz);
  const T nx = sf.nx, ny = sf.ny, nz = sf.nz;
  const T dn = dx * nx + dy * ny + dz * nz;
  const bool into = dn < T(0);
  const T sgn = into ? T(1) : T(-1);
  const T nlx = nx * sgn, nly = ny * sgn, nlz = nz * sgn;

  path.lr = path.lr + path.tr * sf.er;
  path.lg = path.lg + path.tg * sf.eg;
  path.lb = path.lb + path.tb * sf.eb;

  T u0, u1, u2;  // this bounce's uniforms, 2 + 3k, 3 + 3k and 4 + 3k
  u.three(2 + 3 * k, u0, u1, u2);
  T ndx, ndy, ndz;
  T scl = T(1);
  if (sf.diff) {
    // Cosine hemisphere sample, not renormalized (pallas :406-426).
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
    T sinp, cosp;
    sincosv(phi, sinp, cosp);
    const T cphi = cosp * r2sq;
    const T sphi = sinp * r2sq;
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
  path.tr = path.tr * sf.ar * scl;
  path.tg = path.tg * sf.ag * scl;
  path.tb = path.tb * sf.ab * scl;

  T s_res = scl;  // the residual's detached scalar
  bool goes_on = true;
  if (k >= p.rr_depth) {  // Russian roulette (pallas :469-476)
    const T pmax =
        minv(maxv(maxv(maxv(path.tr, path.tg), path.tb), T(0.1)), T(0.95));
    if (!(u2 < pmax)) {
      goes_on = false;
    } else {
      const T pinv = T(1) / pmax;
      path.tr = path.tr * pinv;
      path.tg = path.tg * pinv;
      path.tb = path.tb * pinv;
      s_res = scl * pinv;
    }
  }
  // The bounce on which RR ends the path is live: its winner is stored
  // with s = scl and no 1/pmax.
  sink.store(k, w, sf, s_res);
  // Scale-aware offset, 0 for glass (pallas :482-491); the float32
  // REL_OFFSET in both instantiations; r2 = 0 keeps the eps floor.
  const T off = sf.refr ? T(0) : maxv(p.eps, T(1e-6) * root(sf.r2));
  path.ox = hx + nlx * off;
  path.oy = hy + nly * off;
  path.oz = hz + nlz * off;
  path.dx = ndx;
  path.dy = ndy;
  path.dz = ndz;
  return goes_on;
}

// Points the uniform reader and the sink at sample layer a of pixel pix.
template <typename T, typename Sink>
__device__ __forceinline__ void begin_sample(const PtParams<T>& p, long long pix,
                                             int a, SampleUniforms<T>& u,
                                             Sink& sink) {
  u.buf = p.uniforms == nullptr
              ? nullptr
              : p.uniforms + static_cast<long long>(a) * p.nu * p.n_pix + pix;
  u.layer = static_cast<uint32_t>(a);
  u.block = 0xffffffffu;
  sink.begin(pix, a, p.n_pix);
}

// One thread's pixel (render_pt.cu): the spp4 sample layers in order,
// each path run to its end, each adding L / spp4 to registers written once
// to out [3, W*H] (pixel p is column p / H, row p % H, as the Pallas
// kernels'): no atomics, and an image that repeats bit for bit.  The
// scene's hit(ray, eps, tmin, winner, layer, k) is the thread's own.
//
// The zero-throughput exit: where `finite` (every emission and albedo of
// the scene is finite), a path whose throughput is exactly zero in all
// three channels ends there.  Each later bounce would add tr x e = +-0 to
// its radiance and keep tr x a x s = +-0 (s, the glass and RR weights, is
// finite wherever its uniform lies in [0, 1)), and L + +-0 == L bit for
// bit (L is never -0: it starts at +0, and a sum that cancels rounds to
// +0), so the image does not change.  A NaN or inf value turns it off, and
// so does the debug dump (AliveDump).
template <typename T, typename Scene, typename Dump = NoPathDump>
__device__ __forceinline__ void render_pixel(const Scene& scene,
                                             const PtParams<T>& p,
                                             long long pix, T* out, bool finite,
                                             const Dump& dump = Dump()) {
  NoResiduals sink;
  SampleUniforms<T> u;
  u.stride = p.n_pix;
  u.pixel = static_cast<uint32_t>(pix);
  u.seed = p.seed;
  // The pixel's column and row are worked out again for each sample: two
  // registers fewer through the loop.
  const uint32_t h = static_cast<uint32_t>(p.height);  // u.pixel is pix
  T ar = T(0), ag = T(0), ab = T(0);
  for (int a = 0; a < p.spp4; ++a) {
    begin_sample(p, pix, a, u, sink);
    Path<T> path = camera_path(p, a, T(u.pixel / h), T(u.pixel % h), u, sink);
    for (int k = 0; k < p.bounces; ++k) {
      T tmin;
      Winner w;
      // a miss ends the path
      if (!scene.hit(path.ox, path.oy, path.oz, path.dx, path.dy, path.dz,
                     p.eps, tmin, w, a, k)) {
        break;
      }
      if (!bounce_path(scene, p, path, k, tmin, w, u, sink) ||
          (Dump::kZeroExit && finite && path.tr == T(0) && path.tg == T(0) &&
           path.tb == T(0))) {
        break;
      }
      dump.goes_on(pix, a, k);
    }
    ar = ar + path.lr * p.inv_spp;
    ag = ag + path.lg * p.inv_spp;
    ab = ab + path.lb * p.inv_spp;
  }
  out[pix] = ar;
  out[p.n_pix + pix] = ag;
  out[2 * p.n_pix + pix] = ab;
}

// render_pixel's result for a scene whose hit is warp-collective:
// hit_warp(live, ray, eps, tmin, winner, layer, k) is called by all 32
// lanes of the warp together, `live` false on a lane with no ray to
// trace.  Path regeneration: each step of the loop advances every lane's
// path by one bounce; a lane whose path ends (a miss, Russian roulette,
// the last bounce) finishes that sample (L / spp4 into its registers,
// the dead bounces' residuals) and begins its pixel's next layer, so the
// warp meets at every hit query and costs about the sum of its lanes'
// bounces, not the sum over layers of its longest path.  A lane runs at
// most one layer ahead of the warp's slowest.  Each lane keeps one pixel
// and takes its layers 0..spp4-1 in order, so the per-pixel sum and the
// image are render_pixel's bit for bit.  Lanes past n_pix only take part
// in the queries.
template <typename T, typename Scene, typename Sink>
__device__ __forceinline__ void render_pixel_regen(const Scene& scene,
                                                   const PtParams<T>& p,
                                                   long long pix, T* out,
                                                   Sink sink) {
  const bool mine = pix < p.n_pix;
  SampleUniforms<T> u;
  u.stride = p.n_pix;
  u.pixel = static_cast<uint32_t>(pix);
  u.seed = p.seed;
  // The pixel's column and row are worked out again for each sample: two
  // registers fewer through the loop.
  const auto begin = [&](int layer) {
    begin_sample(p, pix, layer, u, sink);
    const uint32_t h = static_cast<uint32_t>(p.height);  // u.pixel is pix
    return camera_path(p, layer, T(u.pixel / h), T(u.pixel % h), u, sink);
  };
  T ar = T(0), ag = T(0), ab = T(0);
  int a = 0, k = 0;  // the lane's sample layer and its path's next bounce
  Path<T> path = {};
  bool work = mine;      // layers left to take
  bool waiting = false;  // layer a not begun yet
  if (work) path = begin(a);
  while (__any_sync(0xffffffffu, work)) {
    const bool live = work && !waiting && k < p.bounces;
    T tmin;
    Winner w;
    const bool hit = scene.hit_warp(live, path.ox, path.oy, path.oz, path.dx,
                                    path.dy, path.dz, p.eps, tmin, w, a, k);
    bool goes_on = false;
    if (live && hit) {
      goes_on = bounce_path(scene, p, path, k, tmin, w, u, sink);
      if (goes_on) scene.goes_on(pix, a, k);  // the debug dump's alive count
      ++k;
    }
    if (work && !waiting && (!goes_on || k == p.bounces)) {
      // The path ended (a miss, RR, its last bounce): finish its sample.
      sink.fill_dead(k, p.bounces);
      ar = ar + path.lr * p.inv_spp;
      ag = ag + path.lg * p.inv_spp;
      ab = ab + path.lb * p.inv_spp;
      work = ++a < p.spp4;
      waiting = work;
    }
    // A lane begins its next layer once no lane of the warp is on an
    // earlier layer than the one it finished: at most one layer ahead, so
    // that a warp's residual stores of one layer plane come close
    // together in time and merge in the L2.
    const int oldest = __reduce_min_sync(0xffffffffu, work && !waiting ? a : INT_MAX);
    if (waiting && a - 1 <= oldest) {
      path = begin(a);
      k = 0;
      waiting = false;
    }
  }
  if (mine) {
    out[pix] = ar;
    out[p.n_pix + pix] = ag;
    out[2 * p.n_pix + pix] = ab;
  }
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
