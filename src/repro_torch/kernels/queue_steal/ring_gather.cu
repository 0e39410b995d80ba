// K1 ring_gather: the steal-side ring-segment read, one launch for every
// lane and up to eight payload leaves.
//
// Replaces the TPU kernel repro/kernels/queue_steal/kernel.py::ring_gather.
// For every lane l and leaf: out[l, i] = buf[l, (lo[l] + i) mod cap] for
// i < n[l], zero for n[l] <= i < max_steal.  Serves steal / steal_exact
// (masked) and the compact exchange's raw window (n = max_steal).
//
// Bound: the bytes, each live ring row read once and each output row
// written once (3.35 TB/s), and below that a floor of about 2.5-3 us that
// every launch pays, however little it moves.  At the solver's shapes
// (4-byte rows, 64 lanes of at most 8,192 rows) the floor is most of it.
//
// Design (ring_copy.cuh): the Pallas kernel aligned DMA windows to the
// dynamic cut with scalar prefetch and cut the segment out of two
// concatenated blocks.  Here a CTA takes an 8 KB chunk of one lane's
// output block, turns lo and n into byte offsets once, and copies the
// live part as at most two contiguous runs out of the ring (more only
// when max_steal > cap and the segment laps the ring), 16 bytes a thread,
// then zero-fills the rest.  All leaves of a payload tree go in one launch.

#include "../ring_copy.cuh"

namespace {

__global__ void __launch_bounds__(ringcopy::kThreads)
    ring_gather_kernel(const __grid_constant__ ringcopy::RingTree tree,
                       const int* __restrict__ lo, const int* __restrict__ n,
                       int lanes, int cap, int max_steal) {
  const ringcopy::RingLeaf leaf = tree.leaf[blockIdx.z];
  const int rb = leaf.row_bytes;
  const int block = max_steal * rb;  // bytes of one lane's output block
  const int c0 = blockIdx.x * ringcopy::kChunk;
  if (c0 >= block) return;
  const int c1 = c0 + min(ringcopy::kChunk, block - c0);
  const int ring_bytes = cap * rb;
  for (int l = blockIdx.y; l < lanes; l += gridDim.y) {
    const int live = min(max(n[l], 0), max_steal) * rb;
    ringcopy::gather_chunk(leaf.src + (int64_t)l * ring_bytes,
                           leaf.dst + (int64_t)l * block,
                           ringcopy::py_mod(lo[l], cap), live, rb, ring_bytes,
                           c0, c1);
  }
}

}  // namespace

extern "C" int rk_ring_gather(ringcopy::RingTree tree, const int* lo,
                              const int* n, int lanes, int cap, int max_steal,
                              void* stream) {
  dim3 grid;
  if (cap < 1 || !ringcopy::grid_for(tree, lanes, max_steal, &grid)) {
    return (int)cudaErrorInvalidValue;
  }
  ring_gather_kernel<<<grid, ringcopy::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      tree, lo, n, lanes, cap, max_steal);
  return (int)cudaGetLastError();
}

extern "C" const char* rk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
