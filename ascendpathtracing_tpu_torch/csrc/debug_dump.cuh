// The chunk-worklist part of the `debug` dumps of wbvh.cu (_wbvh_kernel's
// "wbvh tile worklist k") and mesh_pt.cu (_mesh_pt_kernel's "mesh_pt
// worklist k").  A Pallas kernel's worklist k is the length of the chunk
// worklist it compacts for a cell (compact_worklist): the number of chunks
// whose box some ray of the cell enters, a union over the cell's lanes,
// not a per-ray count.  Here each box a ray of a dumped cell enters sets
// its bit in the cell's words with one atomicOr (an OR has no order and
// sets a bit once however often it comes), whichever lane of the warp
// walk tests the box, and the dump's print counts the bits once every
// block has finished.  The union of the rays' sets equals the Pallas
// count where child boxes nest in their parents (mesh_pt.cu's with_stats
// says why); a grid whose pad boxes lie outside their super can list more
// on the TPU.
//
// The debug instantiation of each kernel is a template argument, so the
// instantiations without it keep their code; its counts go to small
// buffers the wrapper zeroes, and a one-thread launch on the same stream
// prints the lines with device printf in the Pallas kernel's order.

#pragma once

#include <cuda_runtime.h>

#include "warp_walk.cuh"

namespace {

// The dump's chunk marks: w is the first word of the ray's cell's chunk
// bits, null where the ray is in no dumped cell.  Supers and super-supers
// are not counted.
struct DumpMarks {
  unsigned* w;

  __device__ __forceinline__ void chunk(int c) const {
    if (w != nullptr) atomicOr(w + (c >> 5), 1u << (c & 31));
  }
  __device__ __forceinline__ void super(int) const {}
  __device__ __forceinline__ void super2(int) const {}
};

// A kernel's own marks (its stats) and the dump's together.
template <typename A>
struct WithDump {
  A a;
  DumpMarks d;

  __device__ __forceinline__ void chunk(int c) const {
    a.chunk(c);
    d.chunk(c);
  }
  __device__ __forceinline__ void super(int s) const { a.super(s); }
  __device__ __forceinline__ void super2(int s) const { a.super2(s); }
};

// warp_walk.cuh's shfl_marks for the pair: each part as its own.
template <typename A>
__device__ __forceinline__ WithDump<A> shfl_marks(WithDump<A> m, int src) {
  const A a = shfl_marks(m.a, src);
  const DumpMarks d = shfl_marks(m.d, src);
  return WithDump<A>{a, d};
}

// The number of bits set in words[0, n).
__device__ __forceinline__ int count_bits(const unsigned* words, int n) {
  int k = 0;
  for (int j = 0; j < n; ++j) k += __popc(words[j]);
  return k;
}

}  // namespace
