// K2 ring_scatter: the owner-side bulk push, one launch for all lanes (K3
// ring_slice, the bulk pop, is ring_slice.cu).
//
// K2 replaces the TPU kernel repro/kernels/queue_push/kernel.py::ring_scatter.
// In place: buf[l, (start[l] + i) mod cap] = batch[l, i] for
// i < min(n[l], max_push, cap); every other ring row keeps its contents.
// Serves push (the solver worker's child splice) and the dense exchange's
// thief splice.
//
// Design: the Pallas kernel cut each aligned ring block out of two batch
// blocks with a dynamic_slice and rewrote whole ring blocks (read-modify-
// write through input_output_aliases).  Here each thread computes its own
// physical row from the lane's cursors in device memory and touches only
// the n live rows, so no ring row outside the splice is read or written and
// distinct rows never race (n <= cap).
//
// Bound: device bytes read plus written over 3.35 TB/s.  At the solver's
// shapes (4-byte rows, 128-row pushes) the launch latency dominates that
// bound.

#include "../ring_rows.cuh"

namespace {

template <typename T>
__global__ void ring_scatter_kernel(T* __restrict__ buf,
                                    const T* __restrict__ batch,
                                    const int* __restrict__ start,
                                    const int* __restrict__ n, int lanes,
                                    int cap, int max_push, int64_t wpr) {
  for (int l = blockIdx.y; l < lanes; l += gridDim.y) {
    int64_t live = n[l];
    if (live > max_push) live = max_push;
    if (live > cap) live = cap;
    const int64_t total = live * wpr;
    const int64_t head = start[l];
    T* ring = buf + (int64_t)l * cap * wpr;
    const T* src = batch + (int64_t)l * max_push * wpr;
    for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
         t += (int64_t)gridDim.x * blockDim.x) {
      const int64_t i = t / wpr;
      const int64_t w = t - i * wpr;
      ring[ring::wrap(head + i, cap) * wpr + w] = src[t];
    }
  }
}

}  // namespace

extern "C" int rk_ring_scatter(void* buf, const void* batch, const int* start,
                               const int* n, int lanes, int cap, int max_push,
                               int64_t wpr, int word_bytes, void* stream) {
  const dim3 grid = ring::grid_for((int64_t)max_push * wpr, lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RING_DISPATCH_WORD(word_bytes,
                     ring_scatter_kernel<T><<<grid, ring::kThreads, 0, s>>>(
                         static_cast<T*>(buf), static_cast<const T*>(batch),
                         start, n, lanes, cap, max_push, wpr));
  return (int)cudaGetLastError();
}
