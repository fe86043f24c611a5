// Hand-written Hopper (sm_90a) kernel of the segment-sum
//   acc[s, r] += sum of vals[r, n] over seg[n] == s,   0 <= s < n_slots,
// with seg [N] int32, vals [R <= 8, N] float or double, and acc
// [n_slots, R] double.  It replaces both TPU kernels of
// ascendpathtracing_tpu/ops/pallas_histogram.py, which share this contract: _paged_kernel (the occupancy-gated one-hot
// MXU histogram, segment_rows_paged) and _hist_kernel (the dense one-hot
// histogram, segment_rows_matmul).  Ids outside [0, n_slots) are dropped.
//
// Build (ops/build.py runs this at first use, into build/):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libsegsum.so segsum.cu
//
// Bound on the H100: bytes.  The work is one add per row and value; the
// least time is seg + vals read once (N * (4 + R * sizeof(T)) bytes) and
// acc written once, at 3.35 TB/s.  The risk is contention: the mesh
// replay's rows go mostly to the 9 sphere ids, in long runs of equal ids
// (neighbouring pixels of one bounce), and atomics on 9 global addresses
// would serialise.
//
// Design: one CTA of 256 threads per block of `sample_block` rows (the
// TPU grid's sample block).  The CTA
//   1. flags in shared memory the slot blocks (seg >> log2(slot_block),
//      in [0, ceil(n_slots / slot_block))) that its rows touch: their
//      count is the TPU kernel's `kocc`, the same number;
//   2. gives the first k_cap flagged blocks (ascending; the hot sphere
//      block 0 first) a slot_block x R tile of T in shared memory;
//   3. reduces each warp's runs of equal ids with a segmented shuffle
//      (rows are consecutive across the lanes), so one lane per run adds
//      the run's sum: to the tile with a shared-memory atomic, or, for a
//      slot block without a tile, to acc with a global atomic;
//   4. flushes the tiles with one global atomicAdd per nonzero entry.
// The global accumulator is double for both instantiations: a hot
// segment of the replay collects one partial sum from each of tens of
// thousands of CTAs per launch, and a float running sum of that many
// terms drifts by ~1e-5 relative, while in double the partials (each a
// float tile sum over at most sample_block rows) add without drift.  The
// wrapper returns the sums in the dtype of vals.
// The accumulator is in device memory, so unlike the TPU kernel there is
// no VMEM ceiling on the slot count; only the occupancy flags (n_jb bits)
// live in shared memory, which bounds n_slots to 131072 slot blocks.
// Atomics take the sums in a run-to-run order, so results equal a
// sequential sum only to rounding; a deterministic two-pass version is
// future work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SEG_BLOCK = 256;
constexpr int TILE_BYTES = 32768;     // shared memory for the tiles
constexpr int MAX_TILES = 16;
constexpr int MAX_FLAG_WORDS = 4096;  // 131072 slot blocks
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(SEG_BLOCK)
    segsum_kernel(const int32_t* __restrict__ seg, const T* __restrict__ vals,
                  long long n, int r_count, int n_slots, int log2_sb,
                  int sample_block, int n_jb, int k_cap,
                  double* __restrict__ acc, int32_t* __restrict__ kocc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_nlist;
  const int sb = 1 << log2_sb;
  const int tile_row = sb * r_count;  // one slot block's tile
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int nwords = (n_jb + 31) >> 5;
  unsigned* bits = reinterpret_cast<unsigned*>(tile + k_cap * tile_row);
  int* list = reinterpret_cast<int*>(bits + nwords);
  const int lane = threadIdx.x & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * sample_block;

  // 1. Occupancy flags of the slot blocks.  The shift is arithmetic, so
  // negative ids give negative blocks; ids in [n_slots, n_jb * sb) flag
  // their block (as on the TPU) but are dropped from the sums.
  for (int i = threadIdx.x; i < nwords; i += SEG_BLOCK) bits[i] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < sample_block; i += SEG_BLOCK) {
    const long long row = row0 + i;
    if (row < n) {
      const int c = seg[row] >> log2_sb;
      if (c >= 0 && c < n_jb) atomicOr(&bits[c >> 5], 1u << (c & 31));
    }
  }
  __syncthreads();

  // 2. kocc, and the first k_cap flagged blocks in ascending order.
  if (threadIdx.x < 32) {
    int total = 0;
    for (int w = lane; w < nwords; w += 32) total += __popc(bits[w]);
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_down_sync(FULL, total, off);
    }
    if (lane == 0) {
      if (kocc != nullptr) kocc[blockIdx.x] = total;
      int m = 0;
      for (int w = 0; w < nwords && m < k_cap; ++w) {
        unsigned b = bits[w];
        while (b != 0u && m < k_cap) {
          list[m++] = w * 32 + __ffs(b) - 1;
          b &= b - 1u;
        }
      }
      s_nlist = m;
    }
  }
  __syncthreads();
  const int nlist = s_nlist;
  for (int i = threadIdx.x; i < nlist * tile_row; i += SEG_BLOCK) tile[i] = T(0);
  __syncthreads();

  // 3. The rows: warp w of pass j takes rows j * 256 + 32 w + lane, so a
  // warp's lanes are consecutive rows.  sample_block is a multiple of 32,
  // so a warp is in or out of the block as a whole.
  for (int base = 0; base < sample_block; base += SEG_BLOCK) {
    if (base + static_cast<int>(threadIdx.x & ~31u) >= sample_block) break;
    const long long row = row0 + base + threadIdx.x;
    int key = -1;  // the slot, or -1 for a row that is dropped
    if (row < n) {
      const int s = seg[row];
      if (s >= 0 && s < n_slots) key = s;
    }
    const int prev = __shfl_up_sync(FULL, key, 1);
    const bool head = lane == 0 || prev != key;
    const unsigned heads = __ballot_sync(FULL, head);
    const unsigned above = lane == 31 ? 0u : heads & (FULL << (lane + 1));
    const int end = above != 0u ? __ffs(above) - 1 : 32;  // my run's end
    int t = -1;
    if (head && key >= 0) {
      const int c = key >> log2_sb;
      for (int m = 0; m < nlist; ++m) {
        if (list[m] == c) {
          t = m;
          break;
        }
      }
    }
    for (int r = 0; r < r_count; ++r) {
      T v = key >= 0 ? vals[static_cast<long long>(r) * n + row] : T(0);
      // Segmented suffix sum: the run's head ends with the run's total.
      for (int off = 1; off < 32; off <<= 1) {
        const T o = __shfl_down_sync(FULL, v, off);
        if (lane + off < end) v += o;
      }
      if (head && key >= 0) {
        if (t >= 0) {
          atomicAdd(&tile[t * tile_row + (key & (sb - 1)) * r_count + r], v);
        } else {
          atomicAdd(&acc[static_cast<long long>(key) * r_count + r],
                    static_cast<double>(v));
        }
      }
    }
  }
  __syncthreads();

  // 4. Flush the tiles: entry (t, j, r) is acc[list[t] * sb + j, r].
  for (int e = threadIdx.x; e < nlist * tile_row; e += SEG_BLOCK) {
    const T v = tile[e];
    if (v != T(0)) {
      const int t = e / tile_row;
      atomicAdd(&acc[static_cast<long long>(list[t]) * tile_row + (e - t * tile_row)],
                static_cast<double>(v));
    }
  }
}

template <typename T>
int launch_segsum(const void* seg, const void* vals, long long n, int r_count,
                  int n_slots, int slot_block, int sample_block, void* acc,
                  void* kocc, void* stream) {
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
  if (n_sb == 0) return cudaSuccess;
  const size_t tile_bytes = static_cast<size_t>(slot_block) * r_count * sizeof(T);
  int k_cap = static_cast<int>(TILE_BYTES / tile_bytes);
  if (k_cap > MAX_TILES) k_cap = MAX_TILES;
  const int nwords = static_cast<int>((n_jb + 31) / 32);
  const size_t smem = k_cap * tile_bytes + nwords * sizeof(unsigned) +
                      k_cap * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        segsum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  segsum_kernel<T><<<static_cast<unsigned>(n_sb), SEG_BLOCK, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seg), static_cast<const T*>(vals), n,
      r_count, n_slots, log2_sb, sample_block, static_cast<int>(n_jb), k_cap,
      static_cast<double*>(acc), static_cast<int32_t*>(kocc));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError()
// after the launch (0 = success); the wrapper raises on anything else.
// acc [n_slots, R] double is added into (the caller zeroes it once); kocc
// [ceil(N / sample_block)] int32 may be null.
extern "C" {

const char* apt_segsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#define APT_SEGSUM(SUFFIX, T)                                                \
  int apt_segsum_##SUFFIX(const void* seg, const void* vals, long long n,   \
                          int r_count, int n_slots, int slot_block,         \
                          int sample_block, void* acc, void* kocc,          \
                          void* stream) {                                   \
    return launch_segsum<T>(seg, vals, n, r_count, n_slots, slot_block,     \
                            sample_block, acc, kocc, stream);               \
  }

APT_SEGSUM(f32, float)
APT_SEGSUM(f64, double)

}  // extern "C"
