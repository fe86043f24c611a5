// Hand-written Hopper (sm_90a) kernel of the fused mesh renderer's replay
// rows: one chunk of sample layers of the residuals that mesh_pt.cu's
// forward stores -> the per-sample-bounce gradient rows [6, B, L, P]
// (ga, rows 0-2; ge, rows 3-5) that diff/mesh_fused.replay_backward hands
// to the segment-sum (segsum.cu).
//
// It replaces no Pallas kernel: the JAX package leaves replay_backward's
// product chain (ascendpathtracing_tpu/diff/mesh_fused.py) to XLA, which
// fuses it into one pass.  The port ran it as ~110 plain-torch launches a
// chunk, each full-size temporary through HBM; this kernel is that chain
// in one pass, the temporaries in registers.  ops/replay_kernels.py holds
// the wrapper and the plain twin (replay_rows_plain), whose operation
// order it follows, so the rows equal the twin's bit for bit in float and
// double:
//   live_b   = wid_b >= 0 ? 1 : 0                       (livef)
//   m_b      = live_b > 0 ? a_b * s_b : 1
//   e_live_b = e_b * live_b
//   T_{B-1}  = 0,  T_b = e_live_{b+1} + m_{b+1} * T_{b+1}  (suffix)
//   tput_{-1} = 1, tput_b = tput_{b-1} * m_b
//   ge_b     = (g * live_b) * tput_{b-1}
//   ga_b     = (((g * live_b) * s_b) * tput_{b-1}) * T_b
// every product and sum rounded on its own (__fmul_rn / __fadd_rn, and
// -fmad=false besides).
//
// Build (ops/build.py runs this at first use, into build/):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libmesh_replay.so mesh_replay.cu
//
// Layout.  wid int32 [B, spp4, P] and resv [B, 7, spp4, P] (a, e, s) are
// the whole residual arrays, read in place: the chunk is the layers
// [layer0, layer0 + L), found by its offset and the strides, so no copy of
// the slice is made.  g_cell [3, P] is the cotangent already scaled by
// 1 / spp4.  rows [6, B, L, P] is the chunk's own, contiguous.
//
// Bound on the H100: bytes.  Each sample-bounce reads its winner (4
// bytes) and seven residuals and writes six rows: 56 bytes in float (108
// in double), about a dozen operations, so the card's HBM sets the least
// time (1.26 ms for a chunk of 8 layers x 8 bounces x 1,048,576 pixels at
// the measured 2,992 GB/s).
//
// Design.  A thread takes one (layer, pixel) sample: blockIdx.x the
// pixels, a warp 32 neighbouring ones, so every load and store of a warp
// is one coalesced 128-byte line (256 in double); blockIdx.y the layer.
// B is a template argument for B = 1..MAX_UNROLLED (the launcher
// dispatches on the runtime count), so the bounce loops unroll and the
// chain lives in registers.  Loads in flight: a thread issues all of its
// 8 B loads (64 at B = 8) before the first use of any of them, the
// residuals with the evict-first hint (__ldcs: read once a step), so
// each warp has 8 B independent lines outstanding and a few resident
// blocks an SM cover HBM's latency many times over.  Then loop 1 runs
// backwards for the suffix T, loop 2 forwards, carrying tput and storing
// each bounce's six rows.  Bounce counts above MAX_UNROLLED (mesh_pt.cu
// takes any) go to the B = 0 instantiation, which reads B at run time in
// two passes: the backward pass stores each T_b in its ga rows, the
// forward pass reads it back (the same thread's own stores) and
// overwrites it with ga; about twice the bytes.

#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_UNROLLED = 16;
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

// Strides in elements: a bounce of wid and a residual row of resv are
// `plane` = spp4 * P apart; a (row, bounce) of rows is `out_plane` = L * P.
struct Chunk {
  long long pix, plane, layer0_off, out_plane;
  int layers, bounces;
};

template <typename T, int B>
__global__ void __launch_bounds__(BLOCK)
    replay_rows_kernel(const int* __restrict__ wid, const T* __restrict__ resv,
                       const T* __restrict__ g_cell, T* __restrict__ rows, const Chunk c) {
  const long long p = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (p >= c.pix) return;
  const T g[3] = {g_cell[p], g_cell[c.pix + p], g_cell[2 * c.pix + p]};
  for (int l = blockIdx.y; l < c.layers; l += gridDim.y) {
    const int* w_at = wid + c.layer0_off + static_cast<long long>(l) * c.pix + p;
    const T* r_at = resv + c.layer0_off + static_cast<long long>(l) * c.pix + p;
    T* o_at = rows + static_cast<long long>(l) * c.pix + p;
    if constexpr (B > 0) {
      int w[B];
      T v[B][7];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        w[b] = __ldcs(w_at + b * c.plane);
#pragma unroll
        for (int k = 0; k < 7; ++k) v[b][k] = __ldcs(r_at + (7LL * b + k) * c.plane);
      }
      T live[B], m[B][3], suffix[B][3];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        live[b] = w[b] >= 0 ? T(1) : T(0);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) m[b][ch] = live[b] > T(0) ? mul(v[b][ch], v[b][6]) : T(1);
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) suffix[B - 1][ch] = T(0);
#pragma unroll
      for (int b = B - 2; b >= 0; --b) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          suffix[b][ch] = add(mul(v[b + 1][3 + ch], live[b + 1]),
                              mul(m[b + 1][ch], suffix[b + 1][ch]));
        }
      }
      T tput[3] = {T(1), T(1), T(1)};
#pragma unroll
      for (int b = 0; b < B; ++b) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const T gl = mul(g[ch], live[b]);
          o_at[(3LL * B + ch * B + b) * c.out_plane] = mul(gl, tput[ch]);
          o_at[(static_cast<long long>(ch) * B + b) * c.out_plane] =
              mul(mul(mul(gl, v[b][6]), tput[ch]), suffix[b][ch]);
          tput[ch] = mul(tput[ch], m[b][ch]);
        }
      }
    } else {
      const int nb = c.bounces;
      T suffix[3] = {T(0), T(0), T(0)};
      for (int b = nb - 1; b >= 0; --b) {
        for (int ch = 0; ch < 3; ++ch) {
          o_at[(static_cast<long long>(ch) * nb + b) * c.out_plane] = suffix[ch];
        }
        if (b == 0) break;
        const bool alive = __ldcs(w_at + b * c.plane) >= 0;
        const T live = alive ? T(1) : T(0);
        const T s = __ldcs(r_at + (7LL * b + 6) * c.plane);
        for (int ch = 0; ch < 3; ++ch) {
          const T a = __ldcs(r_at + (7LL * b + ch) * c.plane);
          const T e = __ldcs(r_at + (7LL * b + 3 + ch) * c.plane);
          const T m = live > T(0) ? mul(a, s) : T(1);
          suffix[ch] = add(mul(e, live), mul(m, suffix[ch]));
        }
      }
      T tput[3] = {T(1), T(1), T(1)};
      for (int b = 0; b < nb; ++b) {
        const T live = __ldcs(w_at + b * c.plane) >= 0 ? T(1) : T(0);
        const T s = __ldcs(r_at + (7LL * b + 6) * c.plane);
        for (int ch = 0; ch < 3; ++ch) {
          const T a = __ldcs(r_at + (7LL * b + ch) * c.plane);
          T* ga = o_at + (static_cast<long long>(ch) * nb + b) * c.out_plane;
          const T gl = mul(g[ch], live);
          o_at[(3LL * nb + ch * nb + b) * c.out_plane] = mul(gl, tput[ch]);
          *ga = mul(mul(mul(gl, s), tput[ch]), *ga);
          tput[ch] = mul(tput[ch], live > T(0) ? mul(a, s) : T(1));
        }
      }
    }
  }
}

// Calls f(std::integral_constant<int, B>{}) for B == bounces (1..
// MAX_UNROLLED), else with B = 0 (the run-time count).
template <int B = 1, typename F>
void with_bounces(int bounces, F&& f) {
  if constexpr (B > MAX_UNROLLED) {
    f(std::integral_constant<int, 0>{});
  } else if (bounces == B) {
    f(std::integral_constant<int, B>{});
  } else {
    with_bounces<B + 1>(bounces, f);
  }
}

template <typename T>
int launch_replay_rows(const void* wid, const void* resv, const void* g_cell, void* rows,
                       int bounces, long long spp4, long long pix, int layer0, int layers,
                       void* stream) {
  if (bounces < 1 || pix < 1 || layers < 1 || layer0 < 0 || layer0 + layers > spp4 ||
      (pix + BLOCK - 1) / BLOCK > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  const Chunk c{pix, spp4 * pix, layer0 * pix, layers * pix, layers, bounces};
  const dim3 grid(static_cast<unsigned>((pix + BLOCK - 1) / BLOCK),
                  static_cast<unsigned>(layers < MAX_GRID_Y ? layers : MAX_GRID_Y));
  auto st = static_cast<cudaStream_t>(stream);
  with_bounces(bounces, [&](auto size) {
    constexpr int B = decltype(size)::value;
    replay_rows_kernel<T, B><<<grid, BLOCK, 0, st>>>(
        static_cast<const int*>(wid), static_cast<const T*>(resv),
        static_cast<const T*>(g_cell), static_cast<T*>(rows), c);
  });
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes (ops/replay_kernels.py).  The launch is on
// `stream`; the return value is cudaGetLastError() after it (0 =
// success), or cudaErrorInvalidValue for arguments it does not take.
extern "C" {

const char* apt_replay_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int apt_replay_max_unrolled() { return MAX_UNROLLED; }

#define APT_REPLAY_ROWS(SUFFIX, T)                                                  \
  int apt_replay_rows_##SUFFIX(const void* wid, const void* resv, const void* g_cell, \
                               void* rows, int bounces, long long spp4, long long pix, \
                               int layer0, int layers, void* stream) {              \
    return launch_replay_rows<T>(wid, resv, g_cell, rows, bounces, spp4, pix, layer0, \
                                 layers, stream);                                    \
  }

APT_REPLAY_ROWS(f32, float)
APT_REPLAY_ROWS(f64, double)

}  // extern "C"
