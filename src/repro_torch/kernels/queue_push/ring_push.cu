// K2 ring_scatter: the owner-side bulk push, in place, one launch for every
// lane and up to eight payload leaves (K3 ring_slice, the bulk pop, is
// ring_slice.cu).
//
// Replaces the TPU kernel repro/kernels/queue_push/kernel.py::ring_scatter.
// In place, for every lane l and leaf: buf[l, (start[l] + i) mod cap] =
// batch[l, i] for i < min(n[l], max_push, cap), with start taken mod cap
// as Python's `%` takes it (a negative start counts from the ring's end);
// every other ring byte keeps its contents.  Serves push (the solver
// worker's child splice, the runtime's seed push) and the dense exchange's
// thief splice (up to max_steal rows a lane).
//
// Bound: the bytes, each spliced row read once and written once (3.35
// TB/s), and below that a floor of about 2.5-3 us that every launch pays.
// At the solver's shapes (three 4-byte leaves, 64 lanes of at most 128-row
// pushes) the floor is all of it, so the design's aim is one launch per
// payload tree, not one per leaf.
//
// Design (ring_copy.cuh): K4's splice with the lane's own batch as the
// source.  The Pallas kernel cut each aligned ring block out of two batch
// blocks with a dynamic_slice and rewrote whole ring blocks (read-modify-
// write through input_output_aliases).  Here a CTA takes an 8 KB chunk of
// one lane's batch, exits after one cursor load if the push is shorter,
// and otherwise forms the start byte in int32 (start mod cap, times the
// row's bytes, plus the chunk's offset through wrap_add) and copies the
// chunk as at most two contiguous runs into the ring, 16 bytes a thread:
// scatter_chunk, which K4 shares.  Only live rows are touched, and as at
// most cap rows are written no run laps the ring, so no two CTAs write the
// same byte.

#include "../ring_copy.cuh"

namespace {

__global__ void __launch_bounds__(ringcopy::kThreads)
    ring_scatter_kernel(const __grid_constant__ ringcopy::RingTree tree,
                        const int* __restrict__ start,
                        const int* __restrict__ n, int lanes, int cap,
                        int max_push) {
  const ringcopy::RingLeaf leaf = tree.leaf[blockIdx.z];
  const int rb = leaf.row_bytes;
  const int span = min(max_push, cap);
  const int c0 = blockIdx.x * ringcopy::kChunk;
  if (c0 >= span * rb) return;  // past this leaf's extent: no cursor load
  const int ring_bytes = cap * rb;
  for (int l = blockIdx.y; l < lanes; l += gridDim.y) {
    const int live = min(max(n[l], 0), span) * rb;
    if (c0 >= live) continue;
    ringcopy::scatter_chunk(leaf.dst + (int64_t)l * ring_bytes,
                            leaf.src + (int64_t)l * max_push * rb,
                            ringcopy::py_mod(start[l], cap), rb, ring_bytes,
                            c0, c0 + min(ringcopy::kChunk, live - c0));
  }
}

}  // namespace

extern "C" int rk_ring_scatter(ringcopy::RingTree tree, const int* start,
                               const int* n, int lanes, int cap, int max_push,
                               void* stream) {
  dim3 grid;
  if (cap < 1 || max_push < 1 ||
      !ringcopy::grid_for(tree, lanes, min(max_push, cap), &grid)) {
    return (int)cudaErrorInvalidValue;
  }
  ring_scatter_kernel<<<grid, ringcopy::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      tree, start, n, lanes, cap, max_push);
  return (int)cudaGetLastError();
}
