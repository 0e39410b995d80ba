// K3 ring_slice: the owner-side bulk pop, one launch for every lane and up
// to eight payload leaves.
//
// Replaces the TPU kernel repro/kernels/queue_push/kernel.py::ring_slice.
// For every lane l and leaf: out[l, i] = buf[l, (lo[l] + size[l] - n[l] +
// i) mod cap] for i < n[l], zero for n[l] <= i < max_n: the newest n rows,
// oldest first (n pre-clamped to size).  Serves pop_bulk (the solver
// worker's batch pop).
//
// Bound: the bytes, each live ring row read once and each output row
// written once (3.35 TB/s), and below that the floor of about 2.5-3 us
// that every launch pays.  At the solver's shapes (three 4-byte leaves, 64
// lanes of 8-row pops) the floor is all of it, so the design's aim is one
// launch per payload tree, not one per leaf.
//
// Design (ring_copy.cuh): K1's copy with another start row.  The Pallas
// kernel prefetched lo, size and n as scalars and cut the rows out of two
// concatenated ring blocks.  Here a CTA takes an 8 KB chunk of one lane's
// output block and forms the start lo + size - n from the lane's cursors in
// int32: lo mod cap plus (size - n) mod cap through wrap_add, so lo + size
// past 2^31 (a ring near 2^31 rows) never overflows.  It then copies the
// live part as at most two contiguous runs out of the ring, 16 bytes a
// thread, and zero-fills the rest.

#include "../ring_copy.cuh"

namespace {

__global__ void __launch_bounds__(ringcopy::kThreads)
    ring_slice_kernel(const __grid_constant__ ringcopy::RingTree tree,
                      const int* __restrict__ lo, const int* __restrict__ size,
                      const int* __restrict__ n, int lanes, int cap,
                      int max_n) {
  const ringcopy::RingLeaf leaf = tree.leaf[blockIdx.z];
  const int rb = leaf.row_bytes;
  const int block = max_n * rb;  // bytes of one lane's output block
  const int c0 = blockIdx.x * ringcopy::kChunk;
  if (c0 >= block) return;
  const int c1 = c0 + min(ringcopy::kChunk, block - c0);
  const int ring_bytes = cap * rb;
  for (int l = blockIdx.y; l < lanes; l += gridDim.y) {
    const int live = min(max(n[l], 0), max_n) * rb;
    const int start =
        ringcopy::wrap_add(ringcopy::py_mod(lo[l], cap),
                           ringcopy::py_mod(size[l] - n[l], cap), cap);
    ringcopy::gather_chunk(leaf.src + (int64_t)l * ring_bytes,
                           leaf.dst + (int64_t)l * block, start, live, rb,
                           ring_bytes, c0, c1);
  }
}

}  // namespace

extern "C" int rk_ring_slice(ringcopy::RingTree tree, const int* lo,
                             const int* size, const int* n, int lanes, int cap,
                             int max_n, void* stream) {
  dim3 grid;
  if (cap < 1 || !ringcopy::grid_for(tree, lanes, max_n, &grid)) {
    return (int)cudaErrorInvalidValue;
  }
  ring_slice_kernel<<<grid, ringcopy::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(tree, lo, size, n,
                                                           lanes, cap, max_n);
  return (int)cudaGetLastError();
}
