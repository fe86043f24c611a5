// Hand-written Hopper (sm_90a) kernels of the segment-sum
//   acc[s, r] += sum of vals[r, n] over seg[n] == s,   0 <= s < n_slots,
// with seg [N] int32, vals [R <= 8, N] float or double, and acc
// [n_slots, R] double.  They replace both TPU kernels of
// ascendpathtracing_tpu/ops/pallas_histogram.py, which share this
// contract: _paged_kernel (the occupancy-gated one-hot MXU histogram,
// segment_rows_paged, with its occupancy count kocc) and _hist_kernel
// (the dense one-hot histogram, segment_rows_matmul).  Ids outside
// [0, n_slots) are dropped.
//
// Build (ops/build.py runs this at first use, into build/):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libsegsum.so segsum.cu
//
// Bound on the H100: bytes.  The work is one add per row and value; the
// least time is seg + vals read once (N * (4 + R * sizeof(T)) bytes) and
// acc written once, at 3.35 TB/s.  The mesh replay's rows go mostly to
// the 9 sphere ids, in long runs of equal ids (neighbouring pixels of one
// bounce), so a sum per id across the whole stream must not serialise on
// a few addresses.
//
// Deterministic: the sums repeat bit for bit on the same inputs and the
// same card, as the TPU kernels' fixed grid order does.  No atomic takes
// part in them; the order of every addition is fixed by the rows'
// positions and by G, which depends only on the shapes and the card's SM
// count (apt_segsum_groups).  Three kernels, launched in order:
//   1. kocc_kernel (segment_rows_paged only): one CTA per block of
//      sample_block rows flags in shared memory the slot blocks (seg >>
//      log2(slot_block), in [0, ceil(n_slots / slot_block))) its rows
//      touch and writes their count, the TPU kernel's kocc.  Ids in
//      [n_slots, n_jb * slot_block) flag their block, as on the TPU.
//   2. sum_kernel: G CTAs; CTA g takes a contiguous range of tiles of
//      2048 rows and owns the float64 accumulator part[g] [n_slots, R] in
//      device memory.  Per tile: a stable block radix sort of (slot, row)
//      on the slot (cub::BlockRadixSort), so each slot's rows are one run
//      in row order; per value row r, a segmented scan in float64 over the
//      sorted rows (each thread's 8 rows in order, then cub::BlockScan's
//      fixed tree across threads); the last row of each run adds the
//      run's total to part[g].  A slot has one run per tile, so no two
//      threads write one entry, and a barrier orders the tiles.
//   3. reduce_kernel: acc[s, r] += part[0][s, r] + ... + part[G-1][s, r],
//      in g order.
// The accumulator is float64 for both instantiations: a hot segment of
// the replay collects the rows of tens of thousands of tiles per launch,
// and a float running sum of that many terms drifts by ~1e-5 relative.
// The wrapper returns the sums in the dtype of vals.  part is scratch the
// wrapper allocates: G * n_slots * R doubles, G at most 4 per SM and
// within a 1 GiB budget (fewer for very many slots, which then take
// longer).  The occupancy flags (n_jb bits) live in shared memory, which
// bounds n_slots to 131072 slot blocks.

#include <cuda_runtime.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include <cstdint>

namespace {

constexpr int SEG_BLOCK = 256;
constexpr int ITEMS = 8;                   // rows per thread of a tile
constexpr int TILE = SEG_BLOCK * ITEMS;    // rows per sorted tile
constexpr int MAX_FLAG_WORDS = 4096;       // 131072 slot blocks
constexpr int GROUPS_PER_SM = 4;
constexpr long long PART_BYTES = 1LL << 30;  // budget of the G accumulators
constexpr unsigned FULL = 0xffffffffu;

// 1. kocc per block of sample_block rows.  The flags are set with
// shared-memory atomicOr: an OR does not depend on its order.
__global__ void __launch_bounds__(SEG_BLOCK)
    kocc_kernel(const int32_t* __restrict__ seg, long long n, int log2_sb,
                int sample_block, int n_jb, int32_t* __restrict__ kocc) {
  extern __shared__ unsigned bits[];
  const int nwords = (n_jb + 31) >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * sample_block;
  for (int i = threadIdx.x; i < nwords; i += SEG_BLOCK) bits[i] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < sample_block; i += SEG_BLOCK) {
    const long long row = row0 + i;
    if (row < n) {
      // The shift is arithmetic, so negative ids give negative blocks.
      const int c = seg[row] >> log2_sb;
      if (c >= 0 && c < n_jb) atomicOr(&bits[c >> 5], 1u << (c & 31));
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    int total = 0;
    for (int w = threadIdx.x; w < nwords; w += 32) total += __popc(bits[w]);
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_down_sync(FULL, total, off);
    }
    if (threadIdx.x == 0) kocc[blockIdx.x] = total;
  }
}

// The open run of a segmented scan: its sum so far, and whether it
// started (a head) inside the span the value covers.
struct Run {
  double sum;
  int head;
};

struct RunOp {
  __device__ __forceinline__ Run operator()(const Run& a, const Run& b) const {
    return Run{b.head ? b.sum : a.sum + b.sum, a.head | b.head};
  }
};

// 2. Per-CTA sums over contiguous tiles into part[blockIdx.x].
template <typename T>
__global__ void __launch_bounds__(SEG_BLOCK)
    sum_kernel(const int32_t* __restrict__ seg, const T* __restrict__ vals,
               long long n, int r_count, int n_slots, int key_bits,
               long long n_tiles, double* __restrict__ part) {
  using Sort = cub::BlockRadixSort<unsigned, SEG_BLOCK, ITEMS, int>;
  using Scan = cub::BlockScan<Run, SEG_BLOCK>;
  __shared__ union {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
  } tmp;
  __shared__ unsigned first_key[SEG_BLOCK], last_key[SEG_BLOCK];
  const unsigned sentinel = static_cast<unsigned>(n_slots);  // dropped rows
  const int tid = threadIdx.x;
  double* acc = part + static_cast<long long>(blockIdx.x) * n_slots * r_count;
  const long long t0 = n_tiles * blockIdx.x / gridDim.x;
  const long long t1 = n_tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long t = t0; t < t1; ++t) {
    const long long row0 = t * TILE;
    // Blocked arrangement: thread tid holds tile rows tid * ITEMS + j.
    unsigned key[ITEMS];
    int local[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = tid * ITEMS + j;
      const long long row = row0 + i;
      const int s = row < n ? seg[row] : -1;
      key[j] = (s >= 0 && s < n_slots) ? static_cast<unsigned>(s) : sentinel;
      local[j] = i;
    }
    // Stable: equal slots keep their row order.  The result is blocked
    // too: thread tid holds sorted positions tid * ITEMS + j.
    Sort(tmp.sort).Sort(key, local, 0, key_bits);
    first_key[tid] = key[0];
    last_key[tid] = key[ITEMS - 1];
    __syncthreads();  // also ends the sort's use of tmp
    unsigned heads = 0u, tails = 0u;  // bit j: sorted row j starts / ends a run
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const unsigned prev =
          j > 0 ? key[j - 1] : (tid > 0 ? last_key[tid - 1] : FULL);
      const unsigned next = j < ITEMS - 1
                                ? key[j + 1]
                                : (tid < SEG_BLOCK - 1 ? first_key[tid + 1] : FULL);
      if (key[j] != prev) heads |= 1u << j;
      if (key[j] != next) tails |= 1u << j;
    }
    for (int r = 0; r < r_count; ++r) {
      const T* vr = vals + static_cast<long long>(r) * n + row0;
      double v[ITEMS];
      double run = 0.0;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const double x = key[j] != sentinel ? static_cast<double>(vr[local[j]]) : 0.0;
        run = (heads >> j) & 1u ? x : run + x;
        v[j] = run;
      }
      Run prefix;
      Scan(tmp.scan).ExclusiveScan(Run{run, heads != 0u}, prefix, Run{0.0, 1}, RunOp());
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        // No head at or before j in this thread: the run began in an
        // earlier thread, whose part the scan carries in.
        if ((heads & ((2u << j) - 1u)) == 0u) v[j] = prefix.sum + v[j];
        if (((tails >> j) & 1u) && key[j] != sentinel) {
          double* a = acc + static_cast<long long>(key[j]) * r_count + r;
          *a = *a + v[j];
        }
      }
      // tmp is reused by the next scan or sort; the adds of this tile
      // are visible to every thread of the CTA before the next tile's.
      __syncthreads();
    }
  }
}

// 3. acc += the G per-CTA sums, in g order.
__global__ void __launch_bounds__(SEG_BLOCK)
    reduce_kernel(const double* __restrict__ part, int groups, long long m,
                  double* __restrict__ acc) {
  const long long e = static_cast<long long>(blockIdx.x) * SEG_BLOCK + threadIdx.x;
  if (e >= m) return;
  double s = 0.0;
  for (int g = 0; g < groups; ++g) s = s + part[g * m + e];
  acc[e] = acc[e] + s;
}

long long tiles_of(long long n) { return (n + TILE - 1) / TILE; }

// G: the number of per-CTA accumulators, from the shapes and the current
// device's SM count only.
int groups_for(long long n, int r_count, int n_slots) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms < 1 || n <= 0 || r_count < 1 || n_slots < 1) {
    return 0;
  }
  long long g = tiles_of(n);
  if (g > static_cast<long long>(GROUPS_PER_SM) * sms) g = GROUPS_PER_SM * sms;
  const long long per = static_cast<long long>(n_slots) * r_count * sizeof(double);
  const long long fit = PART_BYTES / per;
  if (g > fit) g = fit;
  return static_cast<int>(g < 1 ? 1 : g);
}

template <typename T>
int launch_segsum(const void* seg, const void* vals, long long n, int r_count,
                  int n_slots, int slot_block, int sample_block, void* acc,
                  void* kocc, void* part, int groups, void* stream) {
  if (n < 0 || r_count < 1 || r_count > 8 || n_slots < 1 || slot_block < 1 ||
      (slot_block & (slot_block - 1)) != 0 || sample_block < 32 ||
      sample_block % 32 != 0 || seg == nullptr || vals == nullptr ||
      acc == nullptr) {
    return cudaErrorInvalidValue;
  }
  int log2_sb = 0;
  while ((1 << log2_sb) < slot_block) ++log2_sb;
  const long long n_jb = (static_cast<long long>(n_slots) + slot_block - 1) / slot_block;
  const long long n_sb = (n + sample_block - 1) / sample_block;
  if ((n_jb + 31) / 32 > MAX_FLAG_WORDS || n_sb > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const long long n_tiles = tiles_of(n);
  if (part == nullptr || groups < 1 || groups > n_tiles) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto sg = static_cast<const int32_t*>(seg);
  if (kocc != nullptr) {
    const int nwords = static_cast<int>((n_jb + 31) / 32);
    kocc_kernel<<<static_cast<unsigned>(n_sb), SEG_BLOCK, nwords * sizeof(unsigned), st>>>(
        sg, n, log2_sb, sample_block, static_cast<int>(n_jb),
        static_cast<int32_t*>(kocc));
  }
  const long long m = static_cast<long long>(n_slots) * r_count;
  cudaError_t e = cudaMemsetAsync(part, 0, groups * m * sizeof(double), st);
  if (e != cudaSuccess) return e;
  int key_bits = 1;  // enough bits for the sentinel id n_slots
  while ((1LL << key_bits) <= n_slots) ++key_bits;
  sum_kernel<T><<<static_cast<unsigned>(groups), SEG_BLOCK, 0, st>>>(
      sg, static_cast<const T*>(vals), n, r_count, n_slots, key_bits, n_tiles,
      static_cast<double*>(part));
  reduce_kernel<<<static_cast<unsigned>((m + SEG_BLOCK - 1) / SEG_BLOCK), SEG_BLOCK, 0, st>>>(
      static_cast<const double*>(part), groups, m, static_cast<double*>(acc));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError()
// after the launches (0 = success); the wrapper raises on anything else.
// acc [n_slots, R] double is added into (the caller zeroes it once); kocc
// [ceil(N / sample_block)] int32 may be null; part is scratch of
// apt_segsum_groups(N, R, n_slots) * n_slots * R doubles.
extern "C" {

const char* apt_segsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int apt_segsum_groups(long long n, int r_count, int n_slots) {
  return groups_for(n, r_count, n_slots);
}

#define APT_SEGSUM(SUFFIX, T)                                                \
  int apt_segsum_##SUFFIX(const void* seg, const void* vals, long long n,   \
                          int r_count, int n_slots, int slot_block,         \
                          int sample_block, void* acc, void* kocc,          \
                          void* part, int groups, void* stream) {           \
    return launch_segsum<T>(seg, vals, n, r_count, n_slots, slot_block,     \
                            sample_block, acc, kocc, part, groups, stream); \
  }

APT_SEGSUM(f32, float)
APT_SEGSUM(f64, double)

}  // extern "C"
