// Hand-written Hopper (sm_90a) kernels of the roofline ceiling probes.
// They replace the three Pallas kernels of measure_ceilings in
// benchmarks/roofline.py:
//   chain_kernel (:76)  -> chain_kernel<Op>: the FP32 issue rate of one op
//   copy_kernel  (:185) -> copy_kernel: HBM copy bandwidth
//   read_kernel  (:201) -> read_kernel: HBM read bandwidth
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
// read_kernel: x [nb, 8, sub] (sub % 128 == 0) -> out [8, 128],
// out[r, l] = sum over b and k of x[b, r, k * 128 + l], the JAX kernel's
// layout.  Bound: bytes, the input read once.  In memory order x is
// nb * 8 * sub / 128 rows of 128 floats (512 bytes): run j = rows
// [j * kr, (j + 1) * kr) (kr = sub / 128) is x[j / 8, j % 8], so row q
// adds into output row (q / kr) % 8.  One launch:
// - An even, persistent split.  The grid is the CTAs the card holds at
//   once (SMs x cudaOccupancyMaxActiveBlocksPerMultiprocessor, at most
//   1,024), each with a contiguous share of the rows: CTA c takes
//   [c * base + min(c, rem), ...) with base = rows / ctas, rem = rows %
//   ctas, so shares differ by at most one row (ops/ceiling_kernels.
//   read_shares mirrors it) and the CTAs end at about the same time.  A
//   CTA walks its share a run at a time, the output row fixed within a
//   run, so crossing a (b, r) boundary costs one compare a run, not one
//   a load.  Row counts fit 32 bits (the launcher checks), so the
//   reduction's index arithmetic divides in 32 bits.
// - Loads.  A warp reads a whole row (a lane 16 bytes: four 128-byte
//   lines, coalesced), the warps of a CTA rows w, w + 8, ... of the run,
//   kReadLoads (8) rows in flight a lane (the last trip's predicated, not
//   one latency each), then the adds; the address advances by a pointer
//   increment of 8 rows.  The loads take the non-coherent path without
//   allocating in L1 (ld.global.nc.L1::no_allocate: each byte is read
//   once).  With 4 CTAs an SM that is 128 KB in flight on each SM,
//   several times the ~20 KB a 3.35 TB/s memory at ~700 ns needs.  Plain
//   unrolled loads rather than a TMA ring: each byte is used once, by the
//   thread that loaded it, so a shared-memory stage would only add a copy
//   and barriers.
// - Sums.  A warp's running sum of each output row lives in shared memory
//   ([warp][r][lane], 32 KB), loaded at the start of a run and stored at
//   its end; at the end of its share the CTA adds its 8 warps in order
//   into its partial [8, 128] of each output row it touched (scratch
//   partials [ctas, 8, 128]; rows it did not touch stay unwritten).
// - Two levels of tickets (int32 atomicAdd after a __threadfence, each
//   counting rows).  The grid is cut into 8 ranges of CTAs [ctas v / 8,
//   ctas (v + 1) / 8).  The CTA whose rows complete output row r's rows
//   in its range v closes (v, r): warp w adds, in CTA order, the partials
//   of r of the CTAs of sub-range w of the range (at most 16 CTAs, their
//   loads issued together) that touched r, the 8 warp sums are added in
//   order into range_sums[v, r], and it adds the range's rows of r to
//   r's ticket; the CTA that completes r's rows adds the ranges' sums of
//   r in range order into out[r].  Each ticket is set back to 0 by the
//   CTA that completed it.  One CTA adding every partial of r alone (~200
//   at the probe's shape, in batches of 8 loads, a memory latency each)
//   kept the card busy for microseconds after the last CTA's loads; the
//   ranges spread that work over the CTAs that finish, most of it while
//   others still read.  ops/ceiling_kernels.read_sum_ordered is the whole
//   order in torch.
// - Programmatic dependent launch (Hopper).  The launch allows the next
//   kernel on the stream to start early, and every CTA signals at once
//   (griddepcontrol.launch_dependents), so the next read's CTAs take the
//   SMs this grid's CTAs leave and read x while this grid's last tickets
//   and sums finish; before it touches the partials, range sums and
//   tickets a CTA waits (griddepcontrol.wait) until the previous grid has
//   ended.  A read that follows any other kernel starts after it ends, as
//   without the attribute (other kernels do not signal), so the read
//   never sees x before the kernel that wrote it has finished.
// No floating-point atomics: the order of every add is fixed by the
// shape and the grid, so the sums repeat bit for bit.  The tickets
// (kTickets int32, zero) are kept by the wrapper with the partials and
// range sums for each (device, stream): calls on one stream run in order
// and each leaves the tickets at 0 for the next; calls on two streams
// use two sets, so no memset launches and no two calls share a ticket.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kStreams = 32;
constexpr int kUnroll = 8;
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kRows = 8;    // the read's output rows
constexpr int kLanes = 128; // and its lanes
constexpr int kReadLoads = 8; // the read's rows in flight a lane
constexpr int kRowVec = kLanes / 4; // float4s a row
constexpr int kRanges = 8;  // the read's reduction: CTA ranges, a warp a sub-range of each
constexpr int kMaxSub = 16; // CTAs of a sub-range at most
constexpr int kMaxReadCtas = kRanges * kWarps * kMaxSub; // 1,024
constexpr int kTickets = kRanges * kRows + kRows;        // [range][r], then [r]

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

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// A 16-byte load of data read once: the non-coherent path, no L1 line.
__device__ __forceinline__ float4 load_once(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// Row counts fit 32 bits (the launcher checks rows < 2^31), so the
// reduction's index arithmetic divides in 32 bits.
// CTA c's share of the rows: [start(c), start(c + 1)).
__device__ __forceinline__ unsigned share_start(unsigned c, unsigned base, unsigned rem) {
  return c * base + min(c, rem);
}

// The output rows that rows [s, e) add into, a bit each
// (ops/ceiling_kernels.read_touched).
__device__ __forceinline__ unsigned touched_rows(unsigned s, unsigned e, unsigned k_rows) {
  if (e <= s) return 0u;
  const unsigned j0 = s / k_rows, j1 = (e - 1) / k_rows;
  if (j1 - j0 >= kRows - 1) return (1u << kRows) - 1;
  unsigned m = 0u;
  for (unsigned j = j0; j <= j1; ++j) m |= 1u << (j % kRows);
  return m;
}

// Rows q < n that add into output row r: (q / k_rows) % 8 == r.
__device__ __forceinline__ unsigned rows_before(unsigned n, unsigned k_rows, unsigned r) {
  const unsigned period = kRows * k_rows, m = n % period;
  return n / period * k_rows + min(m > r * k_rows ? m - r * k_rows : 0u, k_rows);
}

__global__ void __launch_bounds__(kBlock)
    read_kernel(const float4* __restrict__ x, float* __restrict__ partials,
                float* __restrict__ range_sums, int* __restrict__ tickets,
                float* __restrict__ out, unsigned k_rows, unsigned base, unsigned rem) {
  __shared__ float4 sums[kWarps][kRows][kRowVec];  // a warp's sum of each output row
  __shared__ int rows_of[kRows];                    // rows of each output row in the share
  __shared__ int closes[kRows], finishes[kRows];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const unsigned c = blockIdx.x, ctas = gridDim.x;
  const unsigned s = share_start(c, base, rem), e = share_start(c + 1, base, rem);
  // the next launch on this stream may start as this grid's CTAs exit
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  for (int r = 0; r < kRows; ++r) sums[warp][r][lane] = zero;
  if (threadIdx.x < kRows) rows_of[threadIdx.x] = 0;
  __syncthreads();

  // The share a run at a time: rows [a, a_end) add into output row r.
  unsigned j = s / k_rows;
  for (unsigned a = s; a < e; ++j) {
    const unsigned a_end = min(e, (j + 1) * k_rows);
    const unsigned r = j % kRows;
    const unsigned here = a_end - a;
    // this warp's rows a + warp, a + warp + 8, ..., kReadLoads loads at a
    // time (the last trip's too, u < n)
    int n = here > warp ? static_cast<int>((here - warp + kWarps - 1) / kWarps) : 0;
    const float4* p = x + static_cast<std::size_t>(a + warp) * kRowVec + lane;
    float4 acc = sums[warp][r][lane];
    for (; n > 0; n -= kReadLoads) {
      float4 v[kReadLoads];
#pragma unroll
      for (int u = 0; u < kReadLoads; ++u) {
        v[u] = u < n ? load_once(p + u * kWarps * kRowVec) : zero;
      }
#pragma unroll
      for (int u = 0; u < kReadLoads; ++u) {
        if (u < n) acc = add4(acc, v[u]);
      }
      p += kReadLoads * kWarps * kRowVec;
    }
    sums[warp][r][lane] = acc;
    if (threadIdx.x == 0) rows_of[r] += static_cast<int>(here);
    a = a_end;
  }
  __syncthreads();

  // The partials, range sums and tickets are the previous launch's until
  // it has ended.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // The CTA's partial of each output row it touched: its warps in order.
  const float* sf = reinterpret_cast<const float*>(sums);  // [warp][r][128]
  for (int i = threadIdx.x; i < kRows * kLanes; i += kBlock) {
    const int r = i / kLanes, l = i % kLanes;
    if (rows_of[r] == 0) continue;
    float t = sf[r * kLanes + l];
    for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, sf[(w * kRows + r) * kLanes + l]);
    partials[(static_cast<long long>(c) * kRows + r) * kLanes + l] = t;
  }
  __threadfence();
  __syncthreads();

  // Level 1: CTA c's range v = [ctas v / 8, ctas (v + 1) / 8).  The CTA
  // that reads the last rows of output row r in its range closes (v, r).
  unsigned v = 0;
  while (ctas * (v + 1) / kRanges <= c) ++v;
  const unsigned lo = ctas * v / kRanges, hi = ctas * (v + 1) / kRanges;
  const unsigned range_s = share_start(lo, base, rem), range_e = share_start(hi, base, rem);
  if (threadIdx.x < kRows) {
    const unsigned r = threadIdx.x;
    const int mine = rows_of[r];
    const int in_range =
        static_cast<int>(rows_before(range_e, k_rows, r) - rows_before(range_s, k_rows, r));
    closes[r] = mine > 0 && atomicAdd(&tickets[v * kRows + r], mine) + mine == in_range;
  }
  __syncthreads();
  unsigned close = 0u;
  for (int r = 0; r < kRows; ++r) close |= closes[r] ? 1u << r : 0u;
  if (close == 0u) return;  // the same for every thread of the CTA
  __threadfence();
  // warp w: the n <= kMaxSub CTAs [a, a + n) of sub-range w; for each
  // output row it closes, the partials of those that touched it in CTA
  // order, kReadLoads loads in flight
  const unsigned a = lo + (hi - lo) * warp / kWarps;
  const unsigned n = lo + (hi - lo) * (warp + 1) / kWarps - a;
  const unsigned mine =
      lane < n ? touched_rows(share_start(a + lane, base, rem),
                              share_start(a + lane + 1, base, rem), k_rows) & close
               : 0u;
  const float4* parts = reinterpret_cast<const float4*>(partials);
  for (int r = 0; r < kRows; ++r) {
    if (!(close >> r & 1u)) continue;
    unsigned mask = __ballot_sync(0xffffffffu, mine >> r & 1u);
    float4 acc = zero;
    while (mask) {
      float4 p[kReadLoads];
      bool has[kReadLoads];
#pragma unroll
      for (int u = 0; u < kReadLoads; ++u) {
        has[u] = mask != 0u;
        const long long cu = a + (has[u] ? __ffs(mask) - 1 : 0);
        mask &= mask - 1u;
        p[u] = has[u] ? __ldcg(parts + (cu * kRows + r) * kRowVec + lane) : zero;
      }
#pragma unroll
      for (int u = 0; u < kReadLoads; ++u) {
        if (has[u]) acc = add4(acc, p[u]);
      }
    }
    sums[warp][r][lane] = acc;
  }
  __syncthreads();
  // the range's sum of each closed output row: the 8 warps in order
  for (int i = threadIdx.x; i < kRows * kLanes; i += kBlock) {
    const int r = i / kLanes, l = i % kLanes;
    if (!(close >> r & 1u)) continue;
    float t = sf[r * kLanes + l];
    for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, sf[(w * kRows + r) * kLanes + l]);
    range_sums[(v * kRows + r) * kLanes + l] = t;
  }
  __threadfence();
  __syncthreads();

  // Level 2: the CTA that closes the last range of output row r adds the
  // ranges' sums of r in range order (warp r).
  if (threadIdx.x < kRows) {
    const unsigned r = threadIdx.x;
    bool last = false;
    if (close >> r & 1u) {
      tickets[v * kRows + r] = 0;
      const int in_range =
          static_cast<int>(rows_before(range_e, k_rows, r) - rows_before(range_s, k_rows, r));
      last = atomicAdd(&tickets[kRanges * kRows + r], in_range) + in_range ==
             static_cast<int>((base * ctas + rem) / kRows);
    }
    finishes[r] = last;
  }
  __syncthreads();
  const unsigned r = warp;
  if (!finishes[r]) return;
  __threadfence();
  // lane u < 8: does range u hold rows of r (is its sum a term)?
  const unsigned us = share_start(ctas * (lane % kRanges) / kRanges, base, rem),
                 ue = share_start(ctas * (lane % kRanges + 1) / kRanges, base, rem);
  const unsigned terms = __ballot_sync(
      0xffffffffu, lane < kRanges && rows_before(ue, k_rows, r) > rows_before(us, k_rows, r));
  const float4* ranges = reinterpret_cast<const float4*>(range_sums);
  float4 rs[kRanges];
#pragma unroll
  for (int u = 0; u < kRanges; ++u) {
    rs[u] = terms >> u & 1u ? __ldcg(ranges + (u * kRows + r) * kRowVec + lane) : zero;
  }
  float4 t = zero;
#pragma unroll
  for (int u = 0; u < kRanges; ++u) {
    if (terms >> u & 1u) t = add4(t, rs[u]);
  }
  reinterpret_cast<float4*>(out)[r * kRowVec + lane] = t;
  if (lane == 0) tickets[kRanges * kRows + r] = 0;
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

// The read's grid on the current device: out[0] = resident blocks an SM
// holds of its kernel, out[1] = the most CTAs its grid may have, out[2] =
// its tickets (int32).
int apt_ceiling_read_grid(int* out) {
  out[1] = kMaxReadCtas;
  out[2] = kTickets;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, read_kernel, kBlock, 0);
}

// x [nb, 8, sub] float32, 16-byte aligned, sub % 128 == 0, nb * 8 * sub /
// 128 < 2^31; 1 <= ctas <= 1,024; partials [ctas, 8, 128]; range_sums
// [8, 8, 128]; tickets [kTickets] int32, zero (each launch leaves them zero);
// out [8, 128], 16-byte aligned.
int apt_ceiling_read(const float* x, float* partials, float* range_sums, int* tickets, float* out,
                     long long nb, long long sub, int ctas, void* stream) {
  if (nb < 1 || sub < kLanes || sub % kLanes != 0 || ctas < 1 || ctas > kMaxReadCtas ||
      nb * kRows * (sub / kLanes) >= (1LL << 31) ||
      reinterpret_cast<std::uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(out) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const long long k_rows = sub / kLanes, rows = nb * kRows * k_rows;
  cudaLaunchAttribute overlap[1];
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(kBlock);
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = overlap;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, read_kernel, reinterpret_cast<const float4*>(x), partials, range_sums, tickets,
      out, static_cast<unsigned>(k_rows), static_cast<unsigned>(rows / ctas),
      static_cast<unsigned>(rows % ctas));
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // extern "C"
