// K4 ring_transfer: the compact exchange's thief-side cut-and-splice, one
// launch for all lanes.
//
// Replaces the TPU kernel repro/kernels/queue_transfer/kernel.py::ring_transfer.
// In place: buf[l, (head[l] + i) mod cap] = gathered[src_row[l]*max_steal + i]
// for i < min(n[l], max_steal, cap); every other ring row keeps its
// contents.  `gathered` is the (W * max_steal)-row stack of every lane's raw
// window, shared by all thieves, so the selected victim block is never
// built as a tensor of its own.  A source row past the stack reads its last
// row, as the plain version does.
//
// Design: the Pallas kernel aligned both the source and the ring DMA
// windows to their dynamic offsets with scalar prefetch and cut each ring
// block out of two source blocks.  Here each thread reads its lane's
// cursors from device memory and computes both its source row and its
// physical ring row; only the n live rows are read and written.
//
// Bound: device bytes read plus written over 3.35 TB/s.  At the solver's
// shapes (4-byte rows, a few rows per thief) the launch latency dominates
// that bound.

#include "../ring_rows.cuh"

namespace {

template <typename T>
__global__ void ring_transfer_kernel(T* __restrict__ buf,
                                     const T* __restrict__ gathered,
                                     const int* __restrict__ head,
                                     const int* __restrict__ src_row,
                                     const int* __restrict__ n, int lanes,
                                     int cap, int64_t src_rows, int max_steal,
                                     int64_t wpr) {
  for (int l = blockIdx.y; l < lanes; l += gridDim.y) {
    int64_t live = n[l];
    if (live > max_steal) live = max_steal;
    if (live > cap) live = cap;
    const int64_t total = live * wpr;
    const int64_t at = head[l];
    const int64_t src0 = (int64_t)src_row[l] * max_steal;
    T* ring = buf + (int64_t)l * cap * wpr;
    for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
         t += (int64_t)gridDim.x * blockDim.x) {
      const int64_t i = t / wpr;
      const int64_t w = t - i * wpr;
      int64_t s = src0 + i;
      if (s > src_rows - 1) s = src_rows - 1;
      ring[ring::wrap(at + i, cap) * wpr + w] = gathered[s * wpr + w];
    }
  }
}

}  // namespace

extern "C" int rk_ring_transfer(void* buf, const void* gathered,
                                const int* head, const int* src_row,
                                const int* n, int lanes, int cap,
                                int64_t src_rows, int max_steal, int64_t wpr,
                                int word_bytes, void* stream) {
  const dim3 grid = ring::grid_for((int64_t)max_steal * wpr, lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RING_DISPATCH_WORD(word_bytes,
                     ring_transfer_kernel<T><<<grid, ring::kThreads, 0, s>>>(
                         static_cast<T*>(buf), static_cast<const T*>(gathered),
                         head, src_row, n, lanes, cap, src_rows, max_steal,
                         wpr));
  return (int)cudaGetLastError();
}
