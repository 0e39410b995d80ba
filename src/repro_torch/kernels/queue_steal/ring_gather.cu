// K1 ring_gather: the steal-side ring-segment read, one launch for all lanes.
//
// Replaces the TPU kernel repro/kernels/queue_steal/kernel.py::ring_gather.
// For every lane l: out[l, i] = buf[l, (lo[l] + i) mod cap] for i < n[l],
// zero for n[l] <= i < max_steal.  Serves steal / steal_exact (masked) and
// the compact exchange's raw window (n = max_steal).
//
// Design: the Pallas kernel aligned DMA windows to the dynamic cut with
// scalar prefetch and cut the segment out of two concatenated blocks.  On
// Hopper each thread reads its lane's cursors from device memory and
// computes its physical row itself, so no block straddles anything.
//
// Bound: device bytes read plus written over 3.35 TB/s (one read of each
// live row, one write of each output row, the two cursor vectors).  At the
// solver's shapes (4-byte rows) the launch latency dominates that bound.

#include "../ring_rows.cuh"

namespace {

template <typename T>
__global__ void ring_gather_kernel(const T* __restrict__ buf,
                                   const int* __restrict__ lo,
                                   const int* __restrict__ n,
                                   T* __restrict__ out, int lanes, int cap,
                                   int rows, int64_t wpr) {
  for (int l = blockIdx.y; l < lanes; l += gridDim.y) {
    ring::gather_rows<T>(buf + (int64_t)l * cap * wpr,
                         out + (int64_t)l * rows * wpr, lo[l], n[l], cap, rows,
                         wpr);
  }
}

}  // namespace

extern "C" int rk_ring_gather(const void* buf, const int* lo, const int* n,
                              void* out, int lanes, int cap, int rows,
                              int64_t wpr, int word_bytes, void* stream) {
  const dim3 grid = ring::grid_for((int64_t)rows * wpr, lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RING_DISPATCH_WORD(word_bytes,
                     ring_gather_kernel<T><<<grid, ring::kThreads, 0, s>>>(
                         static_cast<const T*>(buf), lo, n,
                         static_cast<T*>(out), lanes, cap, rows, wpr));
  return (int)cudaGetLastError();
}

extern "C" const char* rk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
