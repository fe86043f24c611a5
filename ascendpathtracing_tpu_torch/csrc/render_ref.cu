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
// Design: one thread per ray, the whole bounce loop in registers.  The
// forward and the recompute backward are issue bound (about 40 SASS
// instructions per ray-sphere test under the parity rule), so their
// design removes instructions:
// - S is a template argument: the launchers dispatch S = 1..MAX_S to
//   instantiations whose sphere loops are fully unrolled with no guard,
//   and both backwards keep 3 * S product-rule accumulators, not
//   3 * MAX_S.
// - The closest-hit loop reads r2, x, y, z from a constant bank
//   (hit_bank_*): with S and the sphere index known at compile time they
//   are constant operands of the FADDs and FMULs, with no load and no
//   address arithmetic.  The launcher copies them there from the scene on
//   the launch's stream (a device-to-device copy: kernel parameters would
//   give the same operands but need the scene on the host, a copy back and
//   a wait per launch).  The winner's centre and albedo, read at a
//   per-lane index, come from the block's [10, S] table in shared memory.
// - No sqrt of an invalid discriminant: valid ? root(valid ? det : 1) : 0
//   equals root(valid ? det : 0) bit for bit, but never hands sqrt the
//   exact 0 that IEEE sqrtf sends to its called slow path (nvcc makes it a
//   branch that invalid lanes skip).
// The replay backward has no intersection: it rebuilds the albedo product
// chain from the stored winners, so its bounce is the product rule alone
// and its design removes that rule's instructions too (see the kernel).
// The backward kernels reduce across blocks in two deterministic passes:
// each block writes its 3 + 3S partial sums to column blockIdx.x of a
// [3 + 3S, n_blocks] scratch, and reduce_partials_kernel sums each row in
// a fixed order, so two runs give bitwise-equal gradients.  No float
// atomics.  The kernels allocate nothing; the Python wrappers pass
// outputs and scratch.
//
// Registers: see `nvcc --resource-usage` in the build log
// (build/ascendpathtracing_tpu_torch/*.log) for the count and spills.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <type_traits>

// MAX_S, PLANES, BLOCK, root, miss_t.
#include "sphere_hit.cuh"

namespace {

constexpr int WARPS = BLOCK / 32;
constexpr int HIT_PLANES = 4;         // r2 x y z: the closest-hit loop's

// The closest-hit loop's scene scalars, [HIT_PLANES][S] (plane * S + s),
// for the launch that follows their copy (with_hit_bank).
__constant__ float hit_bank_f32[HIT_PLANES * MAX_S];
__constant__ double hit_bank_f64[HIT_PLANES * MAX_S];

template <typename T>
__device__ __forceinline__ T bank(int i) {
  if constexpr (std::is_same_v<T, float>) {
    return hit_bank_f32[i];
  } else {
    return hit_bank_f64[i];
  }
}

// Copies the [10, S] scene into the block's shared table sc[plane][s].
template <int S, typename T>
__device__ __forceinline__ void load_scene_fixed(T (*sc)[S],
                                                 const T* __restrict__ scene) {
  for (int i = threadIdx.x; i < PLANES * S; i += BLOCK) {
    sc[i / S][i % S] = scene[i];
  }
  __syncthreads();
}

// Nearest of the S spheres of the constant bank along the ray, in
// closest_hit's op order (sphere_hit.cuh): a running minimum with strict <
// so the lowest index wins a tie.  As the oracle's and the twin's argmin,
// the minimum starts at sphere 0's t, so tmin is the least t even past the
// miss distance (in double, a ray 1e20 away after a miss can meet a sphere
// further still; the bounce takes that t).  Returns the winner, or -1 on a
// miss, when tmin >= the miss distance.
template <int S, typename T>
__device__ __forceinline__ int closest_hit_bank(T ox, T oy, T oz, T dx, T dy,
                                                T dz, T eps, T& tmin) {
  const T miss = miss_t<T>();
  int win = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const T r2 = bank<T>(s);
    const T ocx = bank<T>(S + s) - ox;
    const T ocy = bank<T>(2 * S + s) - oy;
    const T ocz = bank<T>(3 * S + s) - oz;
    const T b = ocx * dx + ocy * dy + ocz * dz;
    const T c = ocx * ocx + ocy * ocy + ocz * ocz - r2;
    const T det = b * b - c;
    const bool valid = det >= T(0);
    // == root(valid ? det : 0) bit for bit, without sqrt(0)'s slow path.
    const T sq = valid ? root(valid ? det : T(1)) : T(0);
    const T t0 = b - sq;
    const T t1 = b + sq;
    const T t = (valid && t0 > eps) ? t0 : ((valid && t1 > eps) ? t1 : miss);
    if (s == 0 || t < tmin) {
      tmin = t;
      win = s;
    }
  }
  return tmin < miss ? win : -1;
}

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
// dt' = dt * m + pick_s * tput, then tput' = tput * m, with m =
// albedo[gid] while alive and 1 once the ray has ended, and pick_s = 1
// where alive && s == gid, else 0.  pick_s * tput_c is one of two products
// taken once per bounce and channel and selected per entry: 0 * tput_c (a
// zero of tput's sign; NaN for an infinite or NaN tput) and 1 * tput_c.
// nvcc folds 1 * x to x, which differs from the product at most in a
// NaN's payload; tput is 1 or the output of a multiply, whose NaN is
// already the canonical one, so every entry keeps its bits.
template <int S, typename T>
__device__ __forceinline__ void product_rule_step(T (&dt)[3][S], T (&tput)[3],
                                                  T (*sc)[S], int gid,
                                                  bool alive) {
  T m[3], zero[3], one[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    m[c] = alive ? sc[7 + c][gid] : T(1);
    zero[c] = T(0) * tput[c];
    one[c] = T(1) * tput[c];
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool pick = alive && s == gid;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dt[c][s] = dt[c][s] * m[c] + (pick ? one[c] : zero[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) tput[c] = tput[c] * m[c];
}

// The warp's sums of P values per lane (P a multiple of 32), scattered:
// afterwards lane L holds in v[0, P/32) the sums of values (P/32) * L + i.
// Each step halves the values a lane keeps (the upper half where bit O of
// the lane is set): lanes L and L ^ O swap the halves the other keeps and
// add (O = 16, 8, .., 1),
// about P shuffles in all where P warp sums take 5P.  Each value's sum is
// the tree of a __shfl_down_sync warp sum (offsets 16, 8, .., 1: lanes
// that differ in bit 4 first, then bit 3, ...), and float addition
// commutes, so it has that warp sum's bits.
template <int O, int H, typename T, int P>
__device__ __forceinline__ void warp_reduce_scatter(T (&v)[P], int lane) {
  if constexpr (O > 0) {
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const T send = up ? v[i] : v[i + H];
      const T keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    warp_reduce_scatter<O / 2, H / 2>(v, lane);
  }
}

// The ray's cotangent g[:, r], zeros for a thread past N.
template <typename T>
__device__ __forceinline__ void load_cotangent(T (&gc)[3],
                                               const T* __restrict__ g,
                                               int64_t n, int64_t r,
                                               bool in_range) {
#pragma unroll
  for (int c = 0; c < 3; ++c) gc[c] = in_range ? g[c * n + r] : T(0);
}

// Sums each thread's contributions over the block and writes the block's
// 3 + 3S partials to column blockIdx.x of the [3 + 3S, gridDim.x]
// scratch: row c, g_c * tput_c (emission of the light); row 3 + c*S + s,
// g_c * emission_c * dt[c][s] (albedo), gc the ray's cotangent.  Threads
// past N pass in_range = false and gc = 0 and contribute zeros (not 0 *
// emission, NaN for an infinite emission); every thread of the block must
// call this.  The warps' sums (warp_reduce_scatter) meet in shared
// memory, and each row's are added in warp order.
template <int S, typename T>
__device__ __forceinline__ void write_block_partials(
    const T (&dt)[3][S], const T (&tput)[3], T (*sc)[S], const T (&gc)[3],
    bool in_range, int light, T* __restrict__ partial) {
  constexpr int V = 3 + 3 * S;
  constexpr int P = 32 * ((V + 31) / 32);  // padded to whole lanes
  __shared__ T red[WARPS][V];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T v[P];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v[c] = gc[c] * tput[c];
    const T ge = in_range ? gc[c] * sc[4 + c][light] : T(0);
#pragma unroll
    for (int s = 0; s < S; ++s) v[3 + c * S + s] = ge * dt[c][s];
  }
#pragma unroll
  for (int i = V; i < P; ++i) v[i] = T(0);
  warp_reduce_scatter<16, P / 2>(v, lane);
  const int first = (P / 32) * lane;
#pragma unroll
  for (int i = 0; i < P / 32; ++i) {
    if (first + i < V) red[warp][first + i] = v[i];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < V; j += BLOCK) {
    T acc = red[0][j];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) acc += red[w][j];
    partial[static_cast<int64_t>(j) * gridDim.x + blockIdx.x] = acc;
  }
}

// ---------------------------------------------------------------------------
// Forward.  Replaces _render_ref_kernel (kWithIdx = false) and
// _render_ref_fwd_idx_kernel (kWithIdx = true) of
// ascendpathtracing_tpu/ops/pallas_kernels.py.  Bound on the H100: FP32
// issue, about S*14+30 flops per ray-bounce against 36 B of HBM per ray
// (read 6 planes, write 3), plus 4 B per ray-bounce for idx.
// ---------------------------------------------------------------------------
template <typename T, bool kWithIdx, int S>
__global__ void __launch_bounds__(BLOCK)
    render_ref_fwd_kernel(const T* __restrict__ rays,
                          const T* __restrict__ scene, T* __restrict__ out,
                          int32_t* __restrict__ idx, int64_t n, int light,
                          int bounces, T eps) {
  __shared__ T sc[PLANES][S];
  load_scene_fixed<S>(sc, scene);
  const int64_t r = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (r >= n) return;

  T ox = rays[r], oy = rays[n + r], oz = rays[2 * n + r];
  T dx = rays[3 * n + r], dy = rays[4 * n + r], dz = rays[5 * n + r];
  T tr = T(1), tg = T(1), tb = T(1);
  bool alive = true;
  for (int k = 0; k < bounces; ++k) {
    T tmin;
    const int win = closest_hit_bank<S>(ox, oy, oz, dx, dy, dz, eps, tmin);
    if (kWithIdx) idx[static_cast<int64_t>(k) * n + r] = win < 0 ? S : win;
    // A miss takes the last sphere's shading but is never a light hit.
    const int gid = win < 0 ? S - 1 : win;
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
// 6*S+6 flops per ray-bounce, then the block reduction of 3 + 3S sums.
// Under the parity rule no multiply-add fuses, so the bounce is issue
// bound well above the byte bound; the design removes instructions:
// - S is a template argument (launch_bwd_replay dispatches S = 1..MAX_S):
//   3 x S accumulators in registers with no guard, not 3 x MAX_S.
// - One 0 * tput and one 1 * tput per bounce and channel, selected per
//   accumulator (product_rule_step), not a multiply per accumulator.
// - A ray's winners are loaded kUnroll bounces at a time ahead of their
//   product-rule steps, so their loads overlap, and its cotangent before
//   the bounces, which hide its latency.
// - The epilogue scatters the warp's sums (warp_reduce_scatter), about
//   3 + 3S shuffles a lane where 3 + 3S warp sums take five times that.
// Dead rays run on: a ray that ended still multiplies by 1 and adds
// 0 * tput, whose -0 and NaN (0 * inf) the twin's gradient keeps.
// ---------------------------------------------------------------------------
constexpr int kUnroll = 8;  // the main path's bounces

// One replayed bounce of winner id: id == S is a miss, which takes the
// last sphere's albedo and is never a light hit.
template <int S, typename T>
__device__ __forceinline__ void replay_step(T (&dt)[3][S], T (&tput)[3],
                                            T (*sc)[S], int light, int id,
                                            bool& alive) {
  alive = alive && id != light;
  product_rule_step(dt, tput, sc, (id >= 0 && id < S) ? id : S - 1, alive);
}

// __launch_bounds__(BLOCK, 1): left to its own register target, ptxas
// spilled in some instantiations (float S = 7; double S = 5, 7, 11, 12);
// asked for one resident block per SM only, it spills in none, and the
// float S = 8 kernel takes 64 registers (4 blocks of 256 per SM, as at the
// 52 to 58 it took unasked).  Asking for 5 blocks (48 registers) spilled
// in the bounce loop and was slower.
template <typename T, int S>
__global__ void __launch_bounds__(BLOCK, 1)
    render_ref_bwd_replay_kernel(const T* __restrict__ scene,
                                 const int32_t* __restrict__ idx,
                                 const T* __restrict__ g,
                                 T* __restrict__ partial, int64_t n,
                                 int light, int bounces) {
  __shared__ T sc[PLANES][S];
  load_scene_fixed<S>(sc, scene);
  const int64_t r = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  const bool in_range = r < n;

  T tput[3] = {T(1), T(1), T(1)};
  T dt[3][S] = {};
  T gc[3];
  load_cotangent(gc, g, n, r, in_range);  // in flight during the bounces
  if (in_range) {
    bool alive = true;
    const int32_t* __restrict__ ids = idx + r;
    int k = 0;
    for (; k + kUnroll <= bounces; k += kUnroll) {
      int id[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        id[j] = ids[static_cast<int64_t>(k + j) * n];
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        replay_step(dt, tput, sc, light, id[j], alive);
      }
    }
    for (; k < bounces; ++k) {
      replay_step(dt, tput, sc, light, ids[static_cast<int64_t>(k) * n],
                  alive);
    }
  }
  write_block_partials(dt, tput, sc, gc, in_range, light, partial);
}

// ---------------------------------------------------------------------------
// Recompute backward (replay = False).  Replaces _render_ref_bwd_kernel of
// ascendpathtracing_tpu/ops/pallas_kernels.py: reruns the forward's device
// code while carrying the product-rule accumulators, and needs no residual.
// Bound on the H100: FP32 issue, the forward's flops plus the 6*S+6 of the
// product rule per ray-bounce; HBM is 36 B per ray.
// ---------------------------------------------------------------------------
// __launch_bounds__(BLOCK, RecomputeMinBlocks): ptxas fits the registers to
// that many resident 256-thread blocks per SM (65,536 registers).
template <typename T, int S>
struct RecomputeMinBlocks {
  static constexpr int value = 1;
};

template <typename T, int S>
__global__ void __launch_bounds__(BLOCK, (RecomputeMinBlocks<T, S>::value))
    render_ref_bwd_recompute_kernel(const T* __restrict__ rays,
                                    const T* __restrict__ scene,
                                    const T* __restrict__ g,
                                    T* __restrict__ partial, int64_t n,
                                    int light, int bounces, T eps) {
  __shared__ T sc[PLANES][S];
  load_scene_fixed<S>(sc, scene);
  const int64_t r = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  const bool in_range = r < n;

  T tput[3] = {T(1), T(1), T(1)};
  T dt[3][S] = {};
  if (in_range) {
    T ox = rays[r], oy = rays[n + r], oz = rays[2 * n + r];
    T dx = rays[3 * n + r], dy = rays[4 * n + r], dz = rays[5 * n + r];
    bool alive = true;
    for (int k = 0; k < bounces; ++k) {
      T tmin;
      const int win = closest_hit_bank<S>(ox, oy, oz, dx, dy, dz, eps, tmin);
      const int gid = win < 0 ? S - 1 : win;
      specular_bounce(ox, oy, oz, dx, dy, dz, tmin, sc[1][gid], sc[2][gid],
                      sc[3][gid]);
      alive = alive && win != light;
      product_rule_step(dt, tput, sc, gid, alive);
    }
  }
  T gc[3];
  load_cotangent(gc, g, n, r, in_range);
  write_block_partials(dt, tput, sc, gc, in_range, light, partial);
}

// Second pass of both backwards: one block per row j of the [3 + 3S,
// n_blocks] partials, which sums the row into its element of grad[10, S]
// (row c: grad[4 + c][light]; row 3 + c*S + s: grad[7 + c][s]): each
// thread walks a fixed stride of consecutive blocks, then a fixed tree.
// The order never changes, so repeated runs are bitwise equal.  Rows 0-3,
// and rows 4-6 off the light column, are exact zeros (the render depends
// on geometry only through discrete winners); block 0 writes them.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
    reduce_partials_kernel(const T* __restrict__ partial, int64_t n_blocks,
                           int s_count, int light, T* __restrict__ grad) {
  const int j = blockIdx.x;
  if (j == 0) {
    for (int i = threadIdx.x; i < 7 * s_count; i += BLOCK) {
      if (i < 4 * s_count || i % s_count != light) grad[i] = T(0);
    }
  }
  const T* __restrict__ row = partial + static_cast<int64_t>(j) * n_blocks;
  T acc = T(0);
#pragma unroll 8
  for (int64_t b = threadIdx.x; b < n_blocks; b += BLOCK) acc += row[b];
  __shared__ T red[BLOCK];
  red[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int w = BLOCK / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int e = j - 3;  // the albedo rows: channel e / S, sphere e % S
    grad[j < 3 ? (4 + j) * s_count + light
               : (7 + e / s_count) * s_count + e % s_count] = red[0];
  }
}

bool bad_args(long long n, int s_count, int light, int bounces) {
  return n < 0 || s_count < 1 || s_count > MAX_S || light < 0 ||
         light >= s_count || bounces < 0;
}

unsigned grid_for(long long n) {
  return static_cast<unsigned>((n + BLOCK - 1) / BLOCK);
}

// Calls f(std::integral_constant<int, S>{}) for S == s_count (1..MAX_S,
// checked by bad_args).
template <int S = 1, typename F>
void with_sphere_count(int s_count, F&& f) {
  if constexpr (S == MAX_S) {
    f(std::integral_constant<int, S>{});
  } else if (s_count == S) {
    f(std::integral_constant<int, S>{});
  } else {
    with_sphere_count<S + 1>(s_count, f);
  }
}

// The constant bank is one per device.  Before its copy, a launch's stream
// waits for the last kernel that read the bank, on whatever stream (an
// event recorded after each such kernel), so launches on concurrent
// streams never read each other's scene.  The mutex orders host threads
// (ctypes releases the GIL).
constexpr int MAX_DEVICES = 64;
std::mutex bank_mutex;
cudaEvent_t bank_read[MAX_DEVICES] = {};

// Copies the scene's r2, x, y, z planes ([4, S], the first 4 * S values
// of [10, S]) into the bank on `st`, runs `launch` (which launches one
// kernel that reads the bank on `st`) and records that the bank was read.
template <typename T, typename F>
int with_hit_bank(const T* scene, int s_count, cudaStream_t st, F&& launch) {
  const std::lock_guard<std::mutex> lock(bank_mutex);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  cudaEvent_t& read = bank_read[dev];
  if (read == nullptr) {
    err = cudaEventCreateWithFlags(&read, cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
  }
  err = cudaStreamWaitEvent(st, read, 0);
  if (err != cudaSuccess) return err;
  const size_t bytes = sizeof(T) * HIT_PLANES * s_count;
  if constexpr (std::is_same_v<T, float>) {
    err = cudaMemcpyToSymbolAsync(hit_bank_f32, scene, bytes, 0,
                                  cudaMemcpyDeviceToDevice, st);
  } else {
    err = cudaMemcpyToSymbolAsync(hit_bank_f64, scene, bytes, 0,
                                  cudaMemcpyDeviceToDevice, st);
  }
  if (err != cudaSuccess) return err;
  launch();
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cudaEventRecord(read, st);
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
  auto* ip = static_cast<int32_t*>(idx);
  const T e = static_cast<T>(eps);
  return with_hit_bank(sp, s_count, st, [&] {
    with_sphere_count(s_count, [&](auto size) {
      constexpr int S = decltype(size)::value;
      if (ip != nullptr) {
        render_ref_fwd_kernel<T, true, S><<<grid_for(n), BLOCK, 0, st>>>(
            rp, sp, op, ip, n, light, bounces, e);
      } else {
        render_ref_fwd_kernel<T, false, S><<<grid_for(n), BLOCK, 0, st>>>(
            rp, sp, op, nullptr, n, light, bounces, e);
      }
    });
  });
}

template <typename T>
int launch_reduce(const void* partial, long long n, int s_count, int light,
                  void* grad, cudaStream_t st) {
  reduce_partials_kernel<T><<<3 + 3 * s_count, BLOCK, 0, st>>>(
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
    with_sphere_count(s_count, [&](auto size) {
      constexpr int S = decltype(size)::value;
      render_ref_bwd_replay_kernel<T, S><<<grid_for(n), BLOCK, 0, st>>>(
          static_cast<const T*>(scene), static_cast<const int32_t*>(idx),
          static_cast<const T*>(g), static_cast<T*>(partial), n, light,
          bounces);
    });
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
    const auto* rp = static_cast<const T*>(rays);
    const auto* sp = static_cast<const T*>(scene);
    const auto* gp = static_cast<const T*>(g);
    auto* pp = static_cast<T*>(partial);
    const T e = static_cast<T>(eps);
    const int err = with_hit_bank(sp, s_count, st, [&] {
      with_sphere_count(s_count, [&](auto size) {
        constexpr int S = decltype(size)::value;
        render_ref_bwd_recompute_kernel<T, S><<<grid_for(n), BLOCK, 0, st>>>(
            rp, sp, gp, pp, n, light, bounces, e);
      });
    });
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
