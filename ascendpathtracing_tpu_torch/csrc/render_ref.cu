// Hand-written Hopper (sm_90a) kernels of the reference-semantics render:
// the forward, the forward that also stores each bounce's winner, the
// replay backward and the recompute backward, each for float and double.
// They replace the four reference kernels of
// ascendpathtracing_tpu/ops/pallas_kernels.py.
//
// Build (ops/build.py runs this at first use, into build/):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o librender_ref.so render_ref.cu
//
// PARITY RULE: compile this file with -fmad=false and never with
// --use_fast_math.  By default nvcc contracts a*b+c into one FMA, which
// rounds once where the NumPy oracle and the plain PyTorch twins round
// twice; that alone breaks the bitwise checks against both.  sqrt and
// division must stay IEEE round-to-nearest (nvcc's default -prec-sqrt and
// -prec-div), and the normal is scaled by 1/sqrt(n2), never rsqrt.  The
// expressions below keep the op order of _render_ref_kernel term for term.
//
// Layout, as the JAX package's SoA: rays [6, N] (ox oy oz dx dy dz),
// scene [10, S] (r2 x y z ex ey ez cr cg cb), colors [3, N],
// idx [bounces, N] int32 with S encoding a miss, scene gradient [10, S].
//
// Design: one thread per ray, the whole bounce loop in registers, the
// 10 x S scene table in shared memory.  S is a runtime argument up to
// MAX_S; light index, bounces and eps are arguments.  The backward
// kernels reduce across blocks in two deterministic passes: each block
// writes its partial sums to [n_blocks, NV] scratch, and
// reduce_partials_kernel sums them in a fixed order, so two runs give
// bitwise-equal gradients.  No float atomics.  The kernels allocate
// nothing; the Python wrappers pass outputs and scratch.
//
// Registers: the backward kernels keep 3 * MAX_S product-rule
// accumulators per thread (the per-sphere loops are unrolled to MAX_S so
// they stay in registers); see `nvcc --resource-usage` in the build log
// (build/ascendpathtracing_tpu_torch/*.log) for the count and spills.

#include <cuda_runtime.h>

#include <cstdint>

// MAX_S, PLANES, BLOCK, load_scene and closest_hit.
#include "sphere_hit.cuh"

namespace {

constexpr int WARPS = BLOCK / 32;
constexpr int NV = 3 + 3 * MAX_S;     // partial sums per block: 3 emission
                                      // + 3 x MAX_S albedo (c * MAX_S + s)

// hit = o + d*t; n = normalize(hit - center); d' = d - 2 (d.n) n; o' = hit.
// On a miss hit ~ 1e20, n2 overflows to inf in float and inv comes out 0,
// leaving d unchanged, as in the oracle.
template <typename T>
__device__ __forceinline__ void specular_bounce(T& ox, T& oy, T& oz, T& dx,
                                                T& dy, T& dz, T tmin, T cx,
                                                T cy, T cz) {
  const T hx = ox + dx * tmin;
  const T hy = oy + dy * tmin;
  const T hz = oz + dz * tmin;
  T nx = hx - cx;
  T ny = hy - cy;
  T nz = hz - cz;
  const T n2 = nx * nx + ny * ny + nz * nz;
  const T inv = n2 > T(0) ? T(1) / root(n2) : T(0);
  nx = nx * inv;
  ny = ny * inv;
  nz = nz * inv;
  const T dn = dx * nx + dy * ny + dz * nz;
  const T td = T(2) * dn;
  dx = dx - td * nx;
  dy = dy - td * ny;
  dz = dz - td * nz;
  ox = hx;
  oy = hy;
  oz = hz;
}

// One bounce of the product rule: dt[c][s] = d tput_c / d albedo[s]_c.
// dt' = dt * m + (alive && s == gid) * tput, then tput' = tput * m, with
// m = albedo[gid] while alive and 1 once the ray has ended.
template <typename T>
__device__ __forceinline__ void product_rule_step(T (&dt)[3][MAX_S],
                                                  T (&tput)[3],
                                                  T (*sc)[MAX_S],
                                                  int s_count, int gid,
                                                  bool alive) {
  const T mr = alive ? sc[7][gid] : T(1);
  const T mg = alive ? sc[8][gid] : T(1);
  const T mb = alive ? sc[9][gid] : T(1);
#pragma unroll
  for (int s = 0; s < MAX_S; ++s) {
    if (s < s_count) {
      const T pick = (alive && s == gid) ? T(1) : T(0);
      dt[0][s] = dt[0][s] * mr + pick * tput[0];
      dt[1][s] = dt[1][s] * mg + pick * tput[1];
      dt[2][s] = dt[2][s] * mb + pick * tput[2];
    }
  }
  tput[0] = tput[0] * mr;
  tput[1] = tput[1] * mg;
  tput[2] = tput[2] * mb;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sums each thread's contributions over the block and writes the block's
// NV partials.  Contributions: g_c * tput_c (emission of the light) and
// g_c * emission_c * dt[c][s] (albedo).  Threads past N pass in_range =
// false and contribute zeros; every thread of the block must call this.
template <typename T>
__device__ __forceinline__ void write_block_partials(
    const T (&dt)[3][MAX_S], const T (&tput)[3], T (*sc)[MAX_S],
    const T* __restrict__ g, int64_t n, int64_t r, bool in_range, int s_count,
    int light, T* __restrict__ partial) {
  __shared__ T red[WARPS][NV];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T gc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gc[c] = in_range ? g[c * n + r] : T(0);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T e = warp_sum(gc[c] * tput[c]);
    if (lane == 0) red[warp][c] = e;
    const T ge = gc[c] * sc[4 + c][light];
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      if (s < s_count) {
        const T a = warp_sum(ge * dt[c][s]);
        if (lane == 0) red[warp][3 + c * MAX_S + s] = a;
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < NV; j += BLOCK) {
    if (j >= 3 && (j - 3) % MAX_S >= s_count) continue;  // sphere >= S
    T acc = red[0][j];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) acc += red[w][j];
    partial[static_cast<int64_t>(blockIdx.x) * NV + j] = acc;
  }
}

// ---------------------------------------------------------------------------
// Forward.  Replaces _render_ref_kernel (kWithIdx = false) and
// _render_ref_fwd_idx_kernel (kWithIdx = true) of
// ascendpathtracing_tpu/ops/pallas_kernels.py.  Bound on the H100: FP32
// ALU, about S*14+30 flops per ray-bounce against 36 B of HBM per ray
// (read 6 planes, write 3), plus 4 B per ray-bounce for idx.
// ---------------------------------------------------------------------------
template <typename T, bool kWithIdx>
__global__ void __launch_bounds__(BLOCK)
    render_ref_fwd_kernel(const T* __restrict__ rays,
                          const T* __restrict__ scene, T* __restrict__ out,
                          int32_t* __restrict__ idx, int64_t n, int s_count,
                          int light, int bounces, T eps) {
  __shared__ T sc[PLANES][MAX_S];
  load_scene(sc, scene, s_count);
  const int64_t r = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (r >= n) return;

  T ox = rays[r], oy = rays[n + r], oz = rays[2 * n + r];
  T dx = rays[3 * n + r], dy = rays[4 * n + r], dz = rays[5 * n + r];
  T tr = T(1), tg = T(1), tb = T(1);
  bool alive = true;
  const int last = s_count - 1;
  for (int k = 0; k < bounces; ++k) {
    T tmin;
    const int win = closest_hit(sc, s_count, ox, oy, oz, dx, dy, dz, eps, tmin);
    if (kWithIdx) idx[static_cast<int64_t>(k) * n + r] = win < 0 ? s_count : win;
    // A miss takes the last sphere's shading but is never a light hit.
    const int gid = win < 0 ? last : win;
    specular_bounce(ox, oy, oz, dx, dy, dz, tmin, sc[1][gid], sc[2][gid],
                    sc[3][gid]);
    alive = alive && win != light;
    if (alive) {
      tr = tr * sc[7][gid];
      tg = tg * sc[8][gid];
      tb = tb * sc[9][gid];
    }
  }
  out[r] = tr * sc[4][light];
  out[n + r] = tg * sc[5][light];
  out[2 * n + r] = tb * sc[6][light];
}

// ---------------------------------------------------------------------------
// Replay backward.  Replaces _render_ref_bwd_replay_kernel of
// ascendpathtracing_tpu/ops/pallas_kernels.py: no intersection, the albedo
// product chain is rebuilt from the stored winners.  Bound on the H100:
// HBM, 4*B bytes of idx plus 12 B of cotangent per ray, against about
// 6*S+6 flops per ray-bounce, then the block reduction of NV sums.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(BLOCK)
    render_ref_bwd_replay_kernel(const T* __restrict__ scene,
                                 const int32_t* __restrict__ idx,
                                 const T* __restrict__ g,
                                 T* __restrict__ partial, int64_t n,
                                 int s_count, int light, int bounces) {
  __shared__ T sc[PLANES][MAX_S];
  load_scene(sc, scene, s_count);
  const int64_t r = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  const bool in_range = r < n;

  T tput[3] = {T(1), T(1), T(1)};
  T dt[3][MAX_S] = {};
  if (in_range) {
    const int last = s_count - 1;
    bool alive = true;
    for (int k = 0; k < bounces; ++k) {
      const int id = idx[static_cast<int64_t>(k) * n + r];
      // id == S is a miss: the last sphere's albedo, never a light hit.
      alive = alive && id != light;
      const int gid = (id >= 0 && id < s_count) ? id : last;
      product_rule_step(dt, tput, sc, s_count, gid, alive);
    }
  }
  write_block_partials(dt, tput, sc, g, n, r, in_range, s_count, light,
                       partial);
}

// ---------------------------------------------------------------------------
// Recompute backward (replay = False).  Replaces _render_ref_bwd_kernel of
// ascendpathtracing_tpu/ops/pallas_kernels.py: reruns the forward's device
// code while carrying the product-rule accumulators, and needs no residual.
// Bound on the H100: FP32 ALU, the forward's flops plus the 6*S+6 of the
// product rule per ray-bounce; HBM is 36 B per ray.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(BLOCK)
    render_ref_bwd_recompute_kernel(const T* __restrict__ rays,
                                    const T* __restrict__ scene,
                                    const T* __restrict__ g,
                                    T* __restrict__ partial, int64_t n,
                                    int s_count, int light, int bounces,
                                    T eps) {
  __shared__ T sc[PLANES][MAX_S];
  load_scene(sc, scene, s_count);
  const int64_t r = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  const bool in_range = r < n;

  T tput[3] = {T(1), T(1), T(1)};
  T dt[3][MAX_S] = {};
  if (in_range) {
    T ox = rays[r], oy = rays[n + r], oz = rays[2 * n + r];
    T dx = rays[3 * n + r], dy = rays[4 * n + r], dz = rays[5 * n + r];
    const int last = s_count - 1;
    bool alive = true;
    for (int k = 0; k < bounces; ++k) {
      T tmin;
      const int win =
          closest_hit(sc, s_count, ox, oy, oz, dx, dy, dz, eps, tmin);
      const int gid = win < 0 ? last : win;
      specular_bounce(ox, oy, oz, dx, dy, dz, tmin, sc[1][gid], sc[2][gid],
                      sc[3][gid]);
      alive = alive && win != light;
      product_rule_step(dt, tput, sc, s_count, gid, alive);
    }
  }
  write_block_partials(dt, tput, sc, g, n, r, in_range, s_count, light,
                       partial);
}

// Second pass of both backwards: one block per element of grad[10, S].
// Rows 0-3, and rows 4-6 off the light column, are exact zeros (the
// render depends on geometry only through discrete winners).  The others
// sum their column of the [n_blocks, NV] partials: each thread walks a
// fixed stride, then a fixed tree.  The order never changes, so repeated
// runs are bitwise equal.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
    reduce_partials_kernel(const T* __restrict__ partial, int64_t n_blocks,
                           int s_count, int light, T* __restrict__ grad) {
  const int p = blockIdx.x / s_count;
  const int s = blockIdx.x % s_count;
  int j = -1;
  if (p >= 4 && p <= 6 && s == light) j = p - 4;
  if (p >= 7) j = 3 + (p - 7) * MAX_S + s;
  if (j < 0) {
    if (threadIdx.x == 0) grad[blockIdx.x] = T(0);
    return;  // uniform over the block
  }
  T acc = T(0);
  for (int64_t b = threadIdx.x; b < n_blocks; b += BLOCK) {
    acc += partial[b * NV + j];
  }
  __shared__ T red[BLOCK];
  red[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int w = BLOCK / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) grad[blockIdx.x] = red[0];
}

bool bad_args(long long n, int s_count, int light, int bounces) {
  return n < 0 || s_count < 1 || s_count > MAX_S || light < 0 ||
         light >= s_count || bounces < 0;
}

unsigned grid_for(long long n) {
  return static_cast<unsigned>((n + BLOCK - 1) / BLOCK);
}

template <typename T>
int launch_fwd(const void* rays, const void* scene, void* out, void* idx,
               long long n, int s_count, int light, int bounces, double eps,
               void* stream) {
  if (bad_args(n, s_count, light, bounces)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const T*>(rays);
  const auto* sp = static_cast<const T*>(scene);
  auto* op = static_cast<T*>(out);
  if (idx != nullptr) {
    render_ref_fwd_kernel<T, true><<<grid_for(n), BLOCK, 0, st>>>(
        rp, sp, op, static_cast<int32_t*>(idx), n, s_count, light, bounces,
        static_cast<T>(eps));
  } else {
    render_ref_fwd_kernel<T, false><<<grid_for(n), BLOCK, 0, st>>>(
        rp, sp, op, nullptr, n, s_count, light, bounces, static_cast<T>(eps));
  }
  return cudaGetLastError();
}

template <typename T>
int launch_reduce(const void* partial, long long n, int s_count, int light,
                  void* grad, cudaStream_t st) {
  reduce_partials_kernel<T><<<PLANES * s_count, BLOCK, 0, st>>>(
      static_cast<const T*>(partial), (n + BLOCK - 1) / BLOCK, s_count, light,
      static_cast<T*>(grad));
  return cudaGetLastError();
}

template <typename T>
int launch_bwd_replay(const void* scene, const void* idx, const void* g,
                      void* partial, void* grad, long long n, int s_count,
                      int light, int bounces, void* stream) {
  if (bad_args(n, s_count, light, bounces)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    render_ref_bwd_replay_kernel<T><<<grid_for(n), BLOCK, 0, st>>>(
        static_cast<const T*>(scene), static_cast<const int32_t*>(idx),
        static_cast<const T*>(g), static_cast<T*>(partial), n, s_count, light,
        bounces);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_reduce<T>(partial, n, s_count, light, grad, st);
}

template <typename T>
int launch_bwd_recompute(const void* rays, const void* scene, const void* g,
                         void* partial, void* grad, long long n, int s_count,
                         int light, int bounces, double eps, void* stream) {
  if (bad_args(n, s_count, light, bounces)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    render_ref_bwd_recompute_kernel<T><<<grid_for(n), BLOCK, 0, st>>>(
        static_cast<const T*>(rays), static_cast<const T*>(scene),
        static_cast<const T*>(g), static_cast<T*>(partial), n, s_count, light,
        bounces, static_cast<T>(eps));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_reduce<T>(partial, n, s_count, light, grad, st);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each entry point returns
// cudaGetLastError() after its launches (0 = success); the wrapper raises
// on anything else.  Pointers and the stream arrive as void*.
extern "C" {

int apt_block_size() { return BLOCK; }
int apt_max_spheres() { return MAX_S; }
int apt_partial_width() { return NV; }
const char* apt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int apt_render_ref_fwd_f32(const void* rays, const void* scene, void* out,
                           void* idx, long long n, int s_count, int light,
                           int bounces, double eps, void* stream) {
  return launch_fwd<float>(rays, scene, out, idx, n, s_count, light, bounces,
                           eps, stream);
}
int apt_render_ref_fwd_f64(const void* rays, const void* scene, void* out,
                           void* idx, long long n, int s_count, int light,
                           int bounces, double eps, void* stream) {
  return launch_fwd<double>(rays, scene, out, idx, n, s_count, light, bounces,
                            eps, stream);
}
int apt_render_ref_bwd_replay_f32(const void* scene, const void* idx,
                                  const void* g, void* partial, void* grad,
                                  long long n, int s_count, int light,
                                  int bounces, void* stream) {
  return launch_bwd_replay<float>(scene, idx, g, partial, grad, n, s_count,
                                  light, bounces, stream);
}
int apt_render_ref_bwd_replay_f64(const void* scene, const void* idx,
                                  const void* g, void* partial, void* grad,
                                  long long n, int s_count, int light,
                                  int bounces, void* stream) {
  return launch_bwd_replay<double>(scene, idx, g, partial, grad, n, s_count,
                                   light, bounces, stream);
}
int apt_render_ref_bwd_recompute_f32(const void* rays, const void* scene,
                                     const void* g, void* partial, void* grad,
                                     long long n, int s_count, int light,
                                     int bounces, double eps, void* stream) {
  return launch_bwd_recompute<float>(rays, scene, g, partial, grad, n,
                                     s_count, light, bounces, eps, stream);
}
int apt_render_ref_bwd_recompute_f64(const void* rays, const void* scene,
                                     const void* g, void* partial, void* grad,
                                     long long n, int s_count, int light,
                                     int bounces, double eps, void* stream) {
  return launch_bwd_recompute<double>(rays, scene, g, partial, grad, n,
                                      s_count, light, bounces, eps, stream);
}

}  // extern "C"
