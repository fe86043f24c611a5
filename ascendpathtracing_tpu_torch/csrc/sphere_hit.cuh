// Device code shared by the sphere kernels (render_ref.cu, render_pt.cu):
// sizes, the [10, S] scene table in shared memory, and the closest-hit
// loop.  Same parity rule as the kernels that include it: compile with
// -fmad=false, never --use_fast_math; sqrt stays IEEE round-to-nearest.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int MAX_S = 16;   // spheres a scene may have
constexpr int PLANES = 10;  // scene planes: r2 x y z ex ey ez cr cg cb
constexpr int BLOCK = 256;  // threads per block, every kernel

template <typename T>
__device__ __forceinline__ T miss_t() {
  return T(1e20);  // the oracle's MISS_T, rounded to T
}

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// Copies the [10, S] scene into the block's shared table sc[plane][s].
template <typename T>
__device__ __forceinline__ void load_scene(T (*sc)[MAX_S],
                                           const T* __restrict__ scene,
                                           int s_count) {
  for (int i = threadIdx.x; i < PLANES * s_count; i += BLOCK) {
    sc[i / s_count][i % s_count] = scene[i];
  }
  __syncthreads();
}

// Nearest sphere along the ray.  Running minimum with strict < so the
// lowest index wins a tie (the reference's tie-break).  Returns the
// winner, or -1 on a miss, when tmin stays at the sentinel.
template <typename T>
__device__ __forceinline__ int closest_hit(T (*sc)[MAX_S], int s_count,
                                           T ox, T oy, T oz, T dx, T dy,
                                           T dz, T eps, T& tmin) {
  const T miss = miss_t<T>();
  tmin = miss;
  int win = -1;
  for (int s = 0; s < s_count; ++s) {
    const T r2 = sc[0][s];
    const T ocx = sc[1][s] - ox;
    const T ocy = sc[2][s] - oy;
    const T ocz = sc[3][s] - oz;
    const T b = ocx * dx + ocy * dy + ocz * dz;
    const T c = ocx * ocx + ocy * ocy + ocz * ocz - r2;
    const T det = b * b - c;
    const bool valid = det >= T(0);
    const T sq = root(valid ? det : T(0));
    const T t0 = b - sq;
    const T t1 = b + sq;
    const T t = (valid && t0 > eps) ? t0 : ((valid && t1 > eps) ? t1 : miss);
    if (t < tmin) {
      tmin = t;
      win = s;
    }
  }
  return win;
}

}  // namespace
