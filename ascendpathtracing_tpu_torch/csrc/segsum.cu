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
// the 9 sphere ids (in long runs on the camera bounce, runs of ~2 rows
// after) and the rest to 5,120 triangle slots; the plane gathers'
// backward rows go 96% to slot 0 (the rays that miss) and the rest to the
// 5,120 slots.  So the rows are read once, in row order and coalesced
// (16-byte loads of seg and of each value row, the next tile's issued
// before the current one is applied); equal ids are joined where they
// sit together, in runs; and the few hot ids, the ids below 16, are
// summed per lane pair in shared memory apart from the many cold ones.
//
// Deterministic: the sums repeat bit for bit on the same inputs and the
// same card, as the TPU kernels' fixed grid order does.  No floating-point
// atomic takes part in them; the order of every addition is fixed by the
// rows' positions and by G, which depends only on the shapes and the
// card's SM count (apt_segsum_groups); ops/histogram_kernels.
// segment_rows_ordered repeats it in plain torch.  Three kernels, in
// order:
//   1. kocc_kernel (segment_rows_paged only): one CTA per block of
//      sample_block rows sets in shared memory one bit per slot block
//      (seg >> log2(slot_block), in [0, ceil(n_slots / slot_block))) its
//      rows touch, and writes their count, the TPU kernel's kocc.  Ids in
//      [n_slots, n_jb * slot_block) flag their block, as on the TPU.  An
//      OR has no order; a warp joins its lanes' bits of one word first, so
//      the sphere ids' rows do not queue on one word.
//   2. sum_kernel: G x S CTAs of 16 warps (S = ceil(R / 2)).  CTAs (g, *)
//      take the same contiguous range of whole blocks of sample_block rows;
//      CTA (g, j) sums its value rows [2 j, 2 j + 2).  It walks its range
//      in tiles of 4096 rows: warp w holds tile rows [256 w, 256 w + 256),
//      lane l eight consecutive rows of those.  Per tile and value row:
//      a. each thread folds its rows into runs of equal ids, in float64 and
//         in row order; a run starts (a head) where the id changes and at
//         each warp's first row, and ends (a tail) where it changes and at
//         each warp's last row;
//      b. a warp-segmented inclusive scan by shuffles (a fixed Hillis-
//         Steele tree of 5 steps) carries each thread's open run into the
//         lanes that continue it, so every tail holds its run's total;
//      c. a tail of a hot id is added to its lane pair's sum of that id
//         (the even lane's tails first, then the odd lane's, each in row
//         order); a tail of a cold id is listed in shared memory, per warp
//         in row order (a shuffle scan of the lanes' counts).
//      After a barrier, warp w reads the warps' lists in order, 32 ids a
//      step, and its lane 0 adds the entries of the cold ids the warp owns
//      (id % 16 == w, so no two warps write one accumulator entry) one by
//      one, in list order, to the CTA's accumulator: in shared memory where
//      [n_slots, 2] doubles fit beside the lists, else part[g] itself.  At the end the lane pairs' hot
//      sums are added up (each lane eight pairs in order, then a
//      butterfly over the lanes) into the accumulator, which goes to
//      part[g] [n_slots, R].
//   3. reduce_kernel: acc[s, r] += part[0][s, r] + ... + part[G-1][s, r],
//      in g order.
// The sums are float64 for both instantiations: a hot segment of the
// replay collects the runs of tens of thousands of tiles per launch, and
// a float running sum of that many terms drifts by ~1e-5 relative.  The
// wrapper returns the sums in the dtype of vals.  part is scratch the
// wrapper allocates: G * n_slots * R doubles (G about one per SM over S,
// and within a 1 GiB budget).  The occupancy flags (n_jb bits) live in
// shared memory, which bounds n_slots to 131072 slot blocks.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SEG_BLOCK = 512;
constexpr int WARPS = SEG_BLOCK / 32;      // the owners of the cold ids, id % WARPS
constexpr int ITEMS = 8;                   // consecutive rows per thread
constexpr int WARP_ROWS = 32 * ITEMS;      // rows per warp of a tile
constexpr int TILE = SEG_BLOCK * ITEMS;    // rows per tile
constexpr int MAX_ROWS = 8;
constexpr int RC_MAX = 2;                  // value rows a CTA sums
constexpr int HOT = 16;                    // ids below it are summed per lane pair
constexpr int PAIRS = SEG_BLOCK / 2;       // a hot sum per two lanes
constexpr int MAX_FLAG_WORDS = 4096;       // 131072 slot blocks
// Shared memory a CTA may take (the H100's 227 KB per block, less a
// margin for the static arrays), and what stays of it for a shared
// accumulator of the cold ids.
constexpr long long SMEM_BYTES = 232448 - 1024;
constexpr long long COLD_BYTES =
    SMEM_BYTES - HOT * RC_MAX * PAIRS * 8 - RC_MAX * TILE * 8 - TILE * 4;
constexpr long long PART_BYTES = 1LL << 30;  // budget of the G accumulators
constexpr unsigned FULL = 0xffffffffu;
constexpr int DROP = -1;  // the key of a dropped row

// 1. kocc per block of sample_block rows.
__global__ void __launch_bounds__(SEG_BLOCK)
    kocc_kernel(const int32_t* __restrict__ seg, long long n, int log2_sb,
                int sample_block, int n_jb, int32_t* __restrict__ kocc) {
  extern __shared__ unsigned bits[];
  const int nwords = (n_jb + 31) >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * sample_block;
  for (int i = threadIdx.x; i < nwords; i += SEG_BLOCK) bits[i] = 0u;
  __syncthreads();
  // The thread's bits of its first word go in one OR, those of other
  // words one by one; the warp's bits of lane 0's word in one OR.
  int word = -1;
  unsigned mine = 0u;
  for (int i = threadIdx.x; i < sample_block; i += SEG_BLOCK) {
    const long long row = row0 + i;
    // The shift is arithmetic, so negative ids give negative blocks.
    const int c = row < n ? seg[row] >> log2_sb : -1;
    if (c < 0 || c >= n_jb) continue;
    if (word < 0) word = c >> 5;
    if (c >> 5 == word) {
      mine |= 1u << (c & 31);
    } else {
      atomicOr(&bits[c >> 5], 1u << (c & 31));
    }
  }
  const unsigned has = __ballot_sync(FULL, word >= 0);
  const int w0 = __shfl_sync(FULL, word, has ? __ffs(has) - 1 : 0);
  const unsigned joint = __reduce_or_sync(FULL, word == w0 ? mine : 0u);
  if (word >= 0 && word != w0) atomicOr(&bits[word], mine);
  if (lane == 0 && has != 0u) atomicOr(&bits[w0], joint);
  __syncthreads();
  if (threadIdx.x < 32) {
    int total = 0;
    for (int w = threadIdx.x; w < nwords; w += 32) total += __popc(bits[w]);
    total = __reduce_add_sync(FULL, total);
    if (threadIdx.x == 0) kocc[blockIdx.x] = total;
  }
}

// ITEMS consecutive values at a 16-byte aligned address.
__device__ __forceinline__ void load_items(const int32_t* p, int (&x)[ITEMS]) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
  x[4] = b.x;
  x[5] = b.y;
  x[6] = b.z;
  x[7] = b.w;
}
__device__ __forceinline__ void load_items(const float* p, float (&x)[ITEMS]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
  x[4] = b.x;
  x[5] = b.y;
  x[6] = b.z;
  x[7] = b.w;
}
__device__ __forceinline__ void load_items(const double* p, double (&x)[ITEMS]) {
#pragma unroll
  for (int i = 0; i < ITEMS / 2; ++i) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p) + i);
    x[2 * i] = a.x;
    x[2 * i + 1] = a.y;
  }
}

struct SumParams {
  long long n, n_units;
  int r_count, n_slots, unit;  // unit: rows of a sample block
  int rc;                      // value rows per CTA (blockIdx.y takes [y rc, y rc + rc))
};

// A tile's seg values and the CTA's value rows, in registers: whole
// threads load 16 bytes at a time where kVec (seg and every value row
// aligned at every tile row), else a value at a time; rows past t1 read
// as dropped.
template <typename T, bool kVec>
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ seg,
                                          const T* __restrict__ vals, long long n,
                                          long long row, long long t1, int rc,
                                          int (&raw)[ITEMS], T (&x)[RC_MAX][ITEMS]) {
  if (kVec && row + ITEMS <= t1) {
    load_items(seg + row, raw);
#pragma unroll
    for (int r = 0; r < RC_MAX; ++r) {
      if (r < rc) load_items(vals + r * n + row, x[r]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const bool in = row + j < t1;
      raw[j] = in ? seg[row + j] : DROP;
#pragma unroll
      for (int r = 0; r < RC_MAX; ++r) {
        if (r < rc) x[r][j] = in ? vals[r * n + row + j] : T(0);
      }
    }
  }
}

// 2. CTA (g, j): the sums of value rows [j rc, j rc + rc) over a
// contiguous range of sample blocks into its accumulator (shared memory
// where kShared, else part[g] itself), then into part[g].
template <typename T, bool kVec, bool kShared>
__global__ void __launch_bounds__(SEG_BLOCK, 1)
    sum_kernel(const int32_t* __restrict__ seg, const T* __restrict__ vals,
               const SumParams p, double* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int r0 = blockIdx.y * p.rc;
  const int rc = p.r_count - r0 < p.rc ? p.r_count - r0 : p.rc;  // this CTA's rows
  // Each lane pair's sums of the hot ids [HOT][rc][PAIRS]; the cold
  // entries of a tile, their values [rc][TILE] and ids [TILE]; where
  // kShared the accumulator [n_slots][rc].
  double* hot_t = reinterpret_cast<double*>(smem_raw);
  double* list_v = hot_t + HOT * rc * PAIRS;
  double* acc_s = list_v + rc * TILE;
  int* list_k = reinterpret_cast<int*>(acc_s + (kShared ? p.n_slots * rc : 0));
  __shared__ int list_n[WARPS];  // a warp's cold entries
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n = p.n;
  const long long rbeg = p.n_units * blockIdx.x / gridDim.x * p.unit;
  const long long rend_u = p.n_units * (blockIdx.x + 1) / gridDim.x * p.unit;
  const long long rend = rend_u < n ? rend_u : n;
  // part[g], and the accumulator: entry (s, r) at acc[s * stride + r]
  double* part_g = part + static_cast<long long>(blockIdx.x) * p.n_slots * p.r_count;
  double* acc = kShared ? acc_s : part_g + r0;
  const int stride = kShared ? rc : p.r_count;
  const int hot = p.n_slots < HOT ? p.n_slots : HOT;
  for (int i = tid; i < HOT * rc * PAIRS; i += SEG_BLOCK) hot_t[i] = 0.0;
  if (kShared) {
    for (int i = tid; i < p.n_slots * rc; i += SEG_BLOCK) acc_s[i] = 0.0;
  }
  const T* vr = vals + static_cast<long long>(r0) * n;
  int raw[ITEMS];
  T x[RC_MAX][ITEMS];
  const int lane_row = warp * WARP_ROWS + lane * ITEMS;
  if (rbeg < rend) {
    load_tile<T, kVec>(seg, vr, n, rbeg + lane_row, rbeg + TILE < rend ? rbeg + TILE : rend,
                       rc, raw, x);
  }
  for (long long t0 = rbeg; t0 < rend; t0 += TILE) {
    const long long t1 = t0 + TILE < rend ? t0 + TILE : rend;
    int key[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      key[j] = raw[j] >= 0 && raw[j] < p.n_slots ? raw[j] : DROP;
    }
    // Heads and tails of the runs, within the warp; the tails of kept
    // ids, hot and cold.
    const int prev = __shfl_up_sync(FULL, key[ITEMS - 1], 1);
    const int next = __shfl_down_sync(FULL, key[0], 1);
    unsigned head = 0u, emit_hot = 0u, emit_cold = 0u;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const bool first = j == 0 && lane == 0, last = j == ITEMS - 1 && lane == 31;
      if (first || key[j] != (j > 0 ? key[j - 1] : prev)) head |= 1u << j;
      const bool tail = last || key[j] != (j < ITEMS - 1 ? key[j + 1] : next);
      if (tail && key[j] != DROP) {
        if (key[j] < hot) {
          emit_hot |= 1u << j;
        } else {
          emit_cold |= 1u << j;
        }
      }
    }
    // The thread's cold list positions: an inclusive scan of the counts.
    const int count = __popc(emit_cold);
    int incl = count;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    const int total = __shfl_sync(FULL, incl, 31);
    const int pos0 = warp * WARP_ROWS + incl - count;
    __syncthreads();  // the previous tile's list is applied
    if (lane == 0) list_n[warp] = total;
    {
      int q = pos0;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        if ((emit_cold >> j) & 1u) list_k[q++] = key[j];
      }
    }
#pragma unroll
    for (int r = 0; r < RC_MAX; ++r) {  // unrolled: x stays in registers
      if (r >= rc) break;
      double v[ITEMS];
      double run = 0.0;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const double xj = static_cast<double>(x[r][j]);
        run = (j == 0 || ((head >> j) & 1u)) ? xj : run + xj;
        v[j] = run;
      }
      // Segmented inclusive scan of (open run, has a head) over the lanes.
      double s = run;
      int h = head != 0u;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double su = __shfl_up_sync(FULL, s, off);
        const int hu = __shfl_up_sync(FULL, h, off);
        if (lane >= off) {
          if (!h) s = su + s;
          h |= hu;
        }
      }
      const double carry = __shfl_up_sync(FULL, s, 1);  // the run open before this lane
      int q = pos0;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        // No head at or before j in this thread: the run began in an
        // earlier lane (never lane 0, whose first row is a head).
        v[j] = (head & ((2u << j) - 1u)) == 0u ? carry + v[j] : v[j];
        if ((emit_cold >> j) & 1u) list_v[r * TILE + q++] = v[j];
      }
      // The hot tails into the lane pair's sums: the even lane's, then the
      // odd lane's, each in row order.
#pragma unroll
      for (int odd = 0; odd < 2; ++odd) {
        if ((lane & 1) == odd) {
#pragma unroll
          for (int j = 0; j < ITEMS; ++j) {
            if ((emit_hot >> j) & 1u) {
              double* a = &hot_t[(key[j] * rc + r) * PAIRS + (tid >> 1)];
              *a = *a + v[j];
            }
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();  // the tile's list is complete
    if (t1 < rend) {  // the next tile's loads fly while this one is applied
      const long long u1 = t1 + TILE < rend ? t1 + TILE : rend;
      load_tile<T, kVec>(seg, vr, n, t1 + lane_row, u1, rc, raw, x);
    }
    // Warp `warp` applies the cold entries it owns (id % 16 == warp), in
    // list order: the warps' lists one after another.
    int start[WARPS];  // where each warp's list starts in that order
    int n_cold = 0;
#pragma unroll
    for (int u = 0; u < WARPS; ++u) {
      start[u] = n_cold;
      n_cold += list_n[u];
    }
    auto place = [&](int f) {  // entry f of that order -> its place in the list
      int at = f;              // start[0] == 0
#pragma unroll
      for (int u = 1; u < WARPS; ++u) at = f >= start[u] ? u * WARP_ROWS + (f - start[u]) : at;
      return at;
    };
    for (int e0 = 0; e0 < n_cold; e0 += 32) {
      const int f = e0 + lane;
      const int at = f < n_cold ? place(f) : 0;
      const int k = f < n_cold ? list_k[at] : DROP;
      // lane 0 adds the owned entries one by one, in order
      for (unsigned own = __ballot_sync(FULL, k >= 0 && (k & (WARPS - 1)) == warp);
           own != 0u; own &= own - 1u) {
        const int i = __ffs(own) - 1;
        const int ki = __shfl_sync(FULL, k, i), ai = __shfl_sync(FULL, at, i);
        if (lane == 0) {
          double* a = acc + ki * stride;
          for (int r = 0; r < rc; ++r) a[r] = a[r] + list_v[r * TILE + ai];
        }
      }
    }
  }
  // The hot ids: warp w sums (id, r) for id * rc + r = w, w + 16, ...:
  // lane l the lane pairs l, l + 32, ..., l + 224 in order, then the
  // lanes in a butterfly (xor 16, 8, 4, 2, 1); the accumulator takes it.
  __syncthreads();
  for (int i = warp; i < hot * rc; i += WARPS) {
    double sum = 0.0;
    for (int t = lane; t < PAIRS; t += 32) sum = sum + hot_t[i * PAIRS + t];
    for (int off = 16; off > 0; off >>= 1) sum = sum + __shfl_xor_sync(FULL, sum, off);
    const int id = i / rc, r = i - id * rc;
    if (lane == 0) acc[id * stride + r] = acc[id * stride + r] + sum;
  }
  if (kShared) {  // into part[g]'s columns r0 .. r0 + rc
    __syncthreads();
    for (int i = tid; i < p.n_slots * rc; i += SEG_BLOCK) {
      const int id = i / rc;
      part_g[static_cast<long long>(id) * p.r_count + r0 + (i - id * rc)] = acc_s[i];
    }
  }
}

// 3. acc += the G per-CTA sums, in g order.
__global__ void __launch_bounds__(256)
    reduce_kernel(const double* __restrict__ part, int groups, long long m,
                  double* __restrict__ acc) {
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= m) return;
  double s = 0.0;
  for (int g = 0; g < groups; ++g) s = s + part[g * m + e];
  acc[e] = acc[e] + s;
}

// The launch's shape, from the shapes and the current device's SM count
// only: G groups of rows, S splits of the value rows of rc <= RC_MAX rows
// each, and whether the accumulator fits in shared memory.
struct Plan {
  int groups, splits, rc;
  bool shared;
};

Plan plan_for(long long n, int r_count, int n_slots, int sample_block) {
  Plan pl = {0, 1, r_count, false};
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms < 1 || n <= 0 || r_count < 1 || r_count > MAX_ROWS || n_slots < 1 ||
      sample_block < 1) {
    return pl;
  }
  pl.splits = (r_count + RC_MAX - 1) / RC_MAX;
  pl.rc = (r_count + pl.splits - 1) / pl.splits;
  pl.shared = static_cast<long long>(n_slots) * pl.rc * 8 <= COLD_BYTES;
  long long g = (n + sample_block - 1) / sample_block;
  const long long per_sm = sms / pl.splits > 0 ? sms / pl.splits : 1;
  if (g > per_sm) g = per_sm;
  const long long per = static_cast<long long>(n_slots) * r_count * sizeof(double);
  const long long fit = PART_BYTES / per;
  if (g > fit) g = fit;
  pl.groups = static_cast<int>(g < 1 ? 1 : g);
  return pl;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0u; }

template <typename T, bool kVec, bool kShared>
cudaError_t launch_sum(const int32_t* seg, const T* vals, const SumParams& p, const Plan& pl,
                       double* part, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(HOT) * pl.rc * PAIRS * sizeof(double) +
                      static_cast<size_t>(pl.rc) * TILE * sizeof(double) +
                      (kShared ? static_cast<size_t>(p.n_slots) * pl.rc * sizeof(double) : 0) +
                      TILE * sizeof(int);
  const cudaError_t e = cudaFuncSetAttribute(sum_kernel<T, kVec, kShared>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(pl.groups), static_cast<unsigned>(pl.splits));
  sum_kernel<T, kVec, kShared><<<grid, SEG_BLOCK, smem, st>>>(seg, vals, p, part);
  return cudaSuccess;
}

template <typename T>
int launch_segsum(const void* seg, const void* vals, long long n, int r_count,
                  int n_slots, int slot_block, int sample_block, void* acc,
                  void* kocc, void* part, int groups, void* stream) {
  if (n < 0 || r_count < 1 || r_count > MAX_ROWS || n_slots < 1 || slot_block < 1 ||
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
  const Plan pl = plan_for(n, r_count, n_slots, sample_block);
  if (part == nullptr || groups != pl.groups || groups < 1) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto sg = static_cast<const int32_t*>(seg);
  if (kocc != nullptr) {
    const int nwords = static_cast<int>((n_jb + 31) / 32);
    kocc_kernel<<<static_cast<unsigned>(n_sb), SEG_BLOCK, nwords * sizeof(unsigned), st>>>(
        sg, n, log2_sb, sample_block, static_cast<int>(n_jb), static_cast<int32_t*>(kocc));
  }
  SumParams p;
  p.n = n;
  p.n_units = n_sb;
  p.r_count = r_count;
  p.n_slots = n_slots;
  p.unit = sample_block;
  p.rc = pl.rc;
  const long long m = static_cast<long long>(n_slots) * r_count;
  cudaError_t e = cudaSuccess;
  if (!pl.shared) {  // the accumulators are part itself; shared ones overwrite it
    e = cudaMemsetAsync(part, 0, groups * m * sizeof(double), st);
    if (e != cudaSuccess) return e;
  }
  const auto v = static_cast<const T*>(vals);
  // 16-byte loads where seg and every value row are aligned at each tile
  // row (tile rows are multiples of 32)
  constexpr int per16 = 16 / sizeof(T);
  const bool vec = aligned16(seg) && aligned16(vals) && n % per16 == 0;
  auto pt = static_cast<double*>(part);
  if (pl.shared) {
    e = vec ? launch_sum<T, true, true>(sg, v, p, pl, pt, st)
            : launch_sum<T, false, true>(sg, v, p, pl, pt, st);
  } else {
    e = vec ? launch_sum<T, true, false>(sg, v, p, pl, pt, st)
            : launch_sum<T, false, false>(sg, v, p, pl, pt, st);
  }
  if (e != cudaSuccess) return e;
  reduce_kernel<<<static_cast<unsigned>((m + 255) / 256), 256, 0, st>>>(
      static_cast<const double*>(part), groups, m, static_cast<double*>(acc));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError()
// after the launches (0 = success); the wrapper raises on anything else.
// acc [n_slots, R] double is added into (the caller zeroes it once); kocc
// [ceil(N / sample_block)] int32 may be null; part is scratch of
// apt_segsum_groups(N, R, n_slots, sample_block) * n_slots * R doubles.
extern "C" {

const char* apt_segsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int apt_segsum_groups(long long n, int r_count, int n_slots, int sample_block) {
  return plan_for(n, r_count, n_slots, sample_block).groups;
}

// The kernel's layout, for the plain model of its order
// (ops/histogram_kernels.segment_rows_ordered): out[4] = rows per thread,
// warps per CTA, value rows per CTA at most, hot ids.
void apt_segsum_layout(int* out) {
  out[0] = ITEMS;
  out[1] = WARPS;
  out[2] = RC_MAX;
  out[3] = HOT;
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
