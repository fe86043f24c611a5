// Hand-written Hopper (sm_90a) kernels of the roofline ceiling probes.
// They replace the three Pallas kernels of measure_ceilings in
// benchmarks/roofline.py:
//   chain_kernel (:76)  -> chain_kernel<Op>: the FP32 issue rate of one op
//   copy_kernel  (:185) -> copy_kernel: HBM copy bandwidth
//   read_kernel  (:201) -> read_partials_kernel + read_reduce_kernel: HBM
//                          read bandwidth
// utils/roofline.measure_ceilings times them and turns the times into the
// card's measured ceilings (issue slots a second, the sqrt and division
// weights in slots, bytes a second); utils/roofline.bound composes bounds
// from those.  ops/ceiling_kernels.py holds the wrappers and plain twins.
//
// Build (ops/build.py runs this at first use, into build/):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libceiling.so ceiling.cu
// with the port's flags, so the chains price what the port's kernels
// issue: no multiply-add is contracted, sqrtf and '/' are IEEE.
//
// chain_kernel<Op>.  A thread per element e of a [34, n] float32 input:
// 32 independent streams s_j = x[j, e], c = x[32, e], d = x[33, e].  Each
// of `steps` trips applies the op UNROLL (8) times to every stream, the
// recurrence of roofline.py:81-106; then acc = s_0; acc += s_1; ... in
// stream order, as :110-113 sum them.  `steps` comes at run time and the
// trip loop stays rolled (#pragma unroll 1), so nvcc can neither fold nor
// unroll it; the 256 steps inside a trip are unrolled, and 32 independent
// chains cover the latency of a dependent op, so the warp schedulers
// issue back to back.  Bound: operations (the input is read once).  The
// ops (a, the stream; IEEE round to nearest throughout):
//   mul        a * c                  (informational: the TPU reassociated it)
//   fma        a * c + d, unfused     (__fmul_rn, __fadd_rn: what -fmad=false
//                                      makes of every a * b + c in the port)
//   cmpsel     a > c ? a - d : a + d
//   mix        b = a * c; b > d ? b - d : a + d
//   sqrt       sqrtf(a) * c           (MUFU.RSQ and fix-ups; fixed point c^2)
//   div        c / a                  (MUFU.RCP and fix-ups; period 2)
//   fma_fused  __fmaf_rn(a, c, d)     (one FFMA, which -fmad=false leaves
//                                      alone; informational only)
// chip_smoke.py counts each chain's SASS per step (cuobjdump -sass).
//
// copy_kernel: y = x * scale, a 16-byte load and store a thread (x and y
// 16-byte aligned, n a multiple of 4).  Bound: bytes, each read once and
// written once.
//
// read_partials_kernel + read_reduce_kernel: x [nb, 8, sub] (sub % 128
// == 0) -> out [8, 128], out[r, l] = sum over b and k of
// x[b, r, k * 128 + l], the JAX kernel's layout.  Output row r has
// nb * sub / 128 rows of 128 floats (512 bytes); CTA (c, r) sums its
// contiguous share of them, each warp every eighth row, each lane four
// floats with a 16-byte load (four rows' loads in flight; a row past the
// share adds +0, which leaves every sum as it is, the first added to
// +0), then its 8 warps in order into partials
// [ctas, 8, 128]; read_reduce_kernel adds the ctas partials of each
// output, a warp an output, in a fixed order.  No floating-point atomics:
// the sums repeat bit for bit.  Bound: bytes, the input read once.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kStreams = 32;
constexpr int kUnroll = 8;
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kRows = 8;    // the read's output rows
constexpr int kLanes = 128; // and its lanes
constexpr int kInFlight = 4; // the read's loads in flight a lane

enum Op { kMul, kFma, kCmpSel, kMix, kSqrt, kDiv, kFmaFused, kNumOps };

template <int kOp>
__device__ __forceinline__ float chain_step(float a, float c, float d) {
  if constexpr (kOp == kMul) {
    return __fmul_rn(a, c);
  } else if constexpr (kOp == kFma) {
    return __fadd_rn(__fmul_rn(a, c), d);
  } else if constexpr (kOp == kCmpSel) {
    return a > c ? a - d : a + d;
  } else if constexpr (kOp == kMix) {
    const float b = __fmul_rn(a, c);
    return b > d ? b - d : a + d;
  } else if constexpr (kOp == kSqrt) {
    return __fmul_rn(sqrtf(a), c);
  } else if constexpr (kOp == kDiv) {
    return c / a;
  } else {
    return __fmaf_rn(a, c, d);
  }
}

// At least one resident block: ptxas then gives the division chain the
// registers its 32 live streams need across the slow path's call (78);
// at its default it capped it at 64 and kept streams in local memory
// inside the trip loop.
template <int kOp>
__global__ void __launch_bounds__(kBlock, 1)
    chain_kernel(const float* __restrict__ x, float* __restrict__ out, long long n, int steps) {
  const long long e = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (e >= n) return;
  float s[kStreams];
#pragma unroll
  for (int j = 0; j < kStreams; ++j) s[j] = x[j * n + e];
  const float c = x[kStreams * n + e];
  const float d = x[(kStreams + 1) * n + e];
#pragma unroll 1
  for (int i = 0; i < steps; ++i) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kStreams; ++j) s[j] = chain_step<kOp>(s[j], c, d);
    }
  }
  float acc = s[0];
#pragma unroll
  for (int j = 1; j < kStreams; ++j) acc = __fadd_rn(acc, s[j]);
  out[e] = acc;
}

using ChainKernel = void (*)(const float*, float*, long long, int);
constexpr ChainKernel kChains[kNumOps] = {
    chain_kernel<kMul>,  chain_kernel<kFma>, chain_kernel<kCmpSel>,  chain_kernel<kMix>,
    chain_kernel<kSqrt>, chain_kernel<kDiv>, chain_kernel<kFmaFused>};

__global__ void __launch_bounds__(kBlock)
    copy_kernel(const float4* __restrict__ x, float4* __restrict__ y, long long n4, float scale) {
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * kBlock) {
    float4 v = x[i];
    v.x = __fmul_rn(v.x, scale);
    v.y = __fmul_rn(v.y, scale);
    v.z = __fmul_rn(v.z, scale);
    v.w = __fmul_rn(v.w, scale);
    y[i] = v;
  }
}

// Row q of output row r (0 <= q < nb * k_rows) is x's row (b, r, k) with
// b = q / k_rows, k = q % k_rows: 32 float4s at ((b * 8 + r) * k_rows + k) * 32.
__global__ void __launch_bounds__(kBlock)
    read_partials_kernel(const float4* __restrict__ x, float* __restrict__ partials,
                         long long nb, long long k_rows, long long per_cta) {
  const int c = blockIdx.x, r = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long q_end = min(static_cast<long long>(c + 1) * per_cta, nb * k_rows);
  long long q = static_cast<long long>(c) * per_cta + warp;
  long long b = q / k_rows, k = q - b * k_rows;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  // kInFlight rows a trip: their loads issue before the first add
  for (; q < q_end; q += kInFlight * kWarps) {
    float4 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      v[u] = q + u * kWarps < q_end ? x[((b * kRows + r) * k_rows + k) * (kLanes / 4) + lane]
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      for (k += kWarps; k >= k_rows; k -= k_rows) ++b;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      acc.x = __fadd_rn(acc.x, v[u].x);
      acc.y = __fadd_rn(acc.y, v[u].y);
      acc.z = __fadd_rn(acc.z, v[u].z);
      acc.w = __fadd_rn(acc.w, v[u].w);
    }
  }
  __shared__ float4 sums[kWarps][kLanes / 4];
  sums[warp][lane] = acc;
  __syncthreads();
  if (threadIdx.x < kLanes) {
    const float* s = reinterpret_cast<const float*>(sums);
    float t = s[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, s[w * kLanes + threadIdx.x]);
    partials[(static_cast<long long>(c) * kRows + r) * kLanes + threadIdx.x] = t;
  }
}

// A warp per output i = r * 128 + l: lane j adds partials j, j + 32, ...
// in order, then a shuffle tree (offsets 16, 8, 4, 2, 1) adds the lanes.
__global__ void __launch_bounds__(kBlock)
    read_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out, int ctas) {
  const int i = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  float t = 0.f;
  for (int c = lane; c < ctas; c += 32) {
    t = __fadd_rn(t, partials[static_cast<long long>(c) * kRows * kLanes + i]);
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) {
    t = __fadd_rn(t, __shfl_down_sync(0xffffffffu, t, offset));
  }
  if (lane == 0) out[i] = t;
}

constexpr long long kMaxGrid = 1LL << 30;

unsigned int grid_for(long long items) {
  return static_cast<unsigned int>(std::min((items + kBlock - 1) / kBlock, kMaxGrid));
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each launcher returns
// cudaGetLastError() after its launches (0 = success); the wrapper raises
// on anything else.
extern "C" {

const char* apt_ceiling_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The library's compile-time sizes: out[4] = threads a block, streams,
// unroll, ops.
void apt_ceiling_sizes(int* out) {
  out[0] = kBlock;
  out[1] = kStreams;
  out[2] = kUnroll;
  out[3] = kNumOps;
}

// Resident blocks an SM of the current device holds of op's chain kernel.
int apt_ceiling_chain_blocks_per_sm(int op, int* blocks) {
  if (op < 0 || op >= kNumOps) return cudaErrorInvalidValue;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kChains[op], kBlock, 0);
}

int apt_ceiling_chain(int op, const float* x, float* out, long long n, int steps, void* stream) {
  if (op < 0 || op >= kNumOps || n < 0 || steps < 0) return cudaErrorInvalidValue;
  if (n > 0) {
    kChains[op]<<<grid_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(x, out, n, steps);
  }
  return cudaGetLastError();
}

// x and y 16-byte aligned, n a multiple of 4.
int apt_ceiling_copy(const float* x, float* y, long long n, float scale, void* stream) {
  if (n < 0 || n % 4 != 0 || reinterpret_cast<std::uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(y) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  if (n > 0) {
    copy_kernel<<<grid_for(n / 4), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), n / 4, scale);
  }
  return cudaGetLastError();
}

// x [nb, 8, sub] float32, 16-byte aligned, sub % 128 == 0; partials
// [ctas, 8, 128]; out [8, 128].
int apt_ceiling_read(const float* x, float* partials, float* out, long long nb, long long sub,
                     int ctas, void* stream) {
  if (nb < 1 || sub < kLanes || sub % kLanes != 0 || ctas < 1 ||
      reinterpret_cast<std::uintptr_t>(x) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const long long k_rows = sub / kLanes;
  const long long per_cta = (nb * k_rows + ctas - 1) / ctas;
  read_partials_kernel<<<dim3(ctas, kRows), kBlock, 0, s>>>(
      reinterpret_cast<const float4*>(x), partials, nb, k_rows, per_cta);
  read_reduce_kernel<<<(kRows * kLanes) / kWarps, kBlock, 0, s>>>(partials, out, ctas);
  return cudaGetLastError();
}

}  // extern "C"
