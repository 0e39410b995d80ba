// K4 ring_transfer: the compact exchange's thief-side cut-and-splice, in
// place, one launch for every lane and up to eight payload leaves.
//
// Replaces the TPU kernel repro/kernels/queue_transfer/kernel.py::ring_transfer.
// In place: buf[l, (head[l] + i) mod cap] = gathered[src_row[l]*max_steal + i]
// for i < min(n[l], max_steal, cap); every other ring row keeps its
// contents.  `gathered` is the (src_rows)-row stack of every lane's raw
// window (W * max_steal rows), shared by all thieves, so the selected
// victim block is never built as a tensor of its own.  As in the plain
// version (Python indexing), a source row past the stack reads its last
// row, and a negative src_row counts from the stack's end: its rows start
// at src_rows + src_row * max_steal (row src_row + W of a stack of W
// windows).  A lane with rows to splice whose rows would start before the
// stack (src_row < -W), where the plain version's indexing raises, traps:
// the launch fails and PyTorch raises at the next synchronisation (the
// wrapper raises for CPU tensors; a read-back on the card would stall
// every call).  A lane with n = 0 reads nothing and is not checked.
//
// Bound: the bytes, each spliced row read once and written once (3.35
// TB/s), and below that a floor of about 2.5-3 us that every launch pays.
// In the solver a superstep splices about 15 rows into each of about 11
// thieves, so the floor is all of it.
//
// Design (ring_copy.cuh): the Pallas kernel aligned both the source and
// the ring DMA windows to their dynamic offsets with scalar prefetch and
// cut each ring block out of two source blocks.  Here a CTA takes an 8 KB
// chunk of one lane's splice, exits after one cursor load if the splice is
// shorter, and otherwise turns head and src_row into byte offsets once and
// copies the chunk as at most two contiguous runs into the ring, 16 bytes a
// thread: ring_copy.cuh's scatter_chunk, which K2 ring_scatter shares.
// All leaves of a payload tree go in one launch.

#include "../ring_copy.cuh"

namespace {

// The part of a splice whose rows lie past the stack: `len` bytes of the
// stack's last row `last` repeated, starting `off` bytes into the row.
// Kept out of line: no solver splice takes it.
__device__ __noinline__ void repeat_row(uint8_t* __restrict__ ring,
                                        int ring_bytes, int pos,
                                        const uint8_t* __restrict__ last,
                                        int rb, int off, int len) {
  while (len > 0) {
    const int run = min(rb - off, len);
    pos = ringcopy::put(ring, ring_bytes, pos, last + off, run);
    len -= run;
    off = 0;
  }
}

__global__ void __launch_bounds__(ringcopy::kThreads)
    ring_transfer_kernel(const __grid_constant__ ringcopy::RingTree tree,
                         const int* __restrict__ head,
                         const int* __restrict__ src_row,
                         const int* __restrict__ n, int lanes, int cap,
                         int src_rows, int max_steal) {
  const ringcopy::RingLeaf leaf = tree.leaf[blockIdx.z];
  const int rb = leaf.row_bytes;
  const int span = min(max_steal, cap);
  const int c0 = blockIdx.x * ringcopy::kChunk;
  if (c0 >= span * rb) return;
  const int ring_bytes = cap * rb;
  for (int l = blockIdx.y; l < lanes; l += gridDim.y) {
    const int live = min(max(n[l], 0), span);
    if (c0 >= live * rb) continue;
    const int c1 = c0 + min(ringcopy::kChunk, live * rb - c0);
    uint8_t* ring = leaf.dst + (int64_t)l * ring_bytes;
    int64_t first = (int64_t)src_row[l] * max_steal;
    if (first < 0) first += src_rows;
    if (first < 0) __trap();
    // bytes of the splice that read the stack; the rest repeats its last row
    const int direct =
        (int)min((int64_t)live, max((int64_t)src_rows - first, (int64_t)0)) *
        rb;
    // bytes [c0, e) read the stack, through the scatter K2 shares
    const int e = min(c1, max(c0, direct));
    const int pos = ringcopy::scatter_chunk(
        ring, leaf.src + first * rb, ringcopy::py_mod(head[l], cap), rb,
        ring_bytes, c0, e);
    if (e < c1) {
      const uint8_t* last = leaf.src + (int64_t)(src_rows - 1) * rb;
      repeat_row(ring, ring_bytes, pos, last, rb, (e - direct) % rb, c1 - e);
    }
  }
}

}  // namespace

extern "C" int rk_ring_transfer(ringcopy::RingTree tree, const int* head,
                                const int* src_row, const int* n, int lanes,
                                int cap, int src_rows, int max_steal,
                                void* stream) {
  dim3 grid;
  if (cap < 1 || src_rows < 1 || max_steal < 1 ||
      !ringcopy::grid_for(tree, lanes, min(max_steal, cap), &grid)) {
    return (int)cudaErrorInvalidValue;
  }
  ring_transfer_kernel<<<grid, ringcopy::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      tree, head, src_row, n, lanes, cap, src_rows, max_steal);
  return (int)cudaGetLastError();
}
