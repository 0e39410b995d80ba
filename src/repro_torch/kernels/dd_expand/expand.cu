// K5 dd_expand: both arcs of a decision-diagram layer in one elementwise
// pass, for any number of node pools at once.
//
// Replaces the TPU kernel repro/kernels/dd_expand/kernel.py::expand.  On
// int32 nodes (state s, value v), `rows` pools of `W` nodes each:
//   0-arc: (s, v)          if s >= 0, else (-1, -2^30)
//   1-arc: (s - w, v + p)  if s >= w (and s >= 0), else (-1, -2^30)
// written as row r's children [0-arcs | 1-arcs]: node (r, i) goes to
// r * 2W + i and r * 2W + W + i.  With one row that is the JAX package's
// `expand_layer_bulk` layout; with the solver's (B, W) pools it is
// core/dd/diagram.expand_layer's.  Integer arithmetic wraps as PyTorch's
// does, so the result equals the plain version bit for bit.
//
// Design: the Pallas kernel took w and p as scalar-prefetch arguments so
// one compiled kernel serves every layer.  Here w and p are read through
// device pointers (the solver's weights[i], profits[i], 0-d views of a
// tensor on the card), so the host never waits for them; a null pointer
// takes the value argument instead.  One thread per node, grid-stride.
//
// Bound: bytes — each node's state and value read once and its four
// children written once, over 3.35 TB/s; at the solver's pools (a few
// thousand nodes) launch latency dominates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNeg = -(1 << 30);

__global__ void __launch_bounds__(kThreads)
    expand_kernel(const int* __restrict__ s, const int* __restrict__ v,
                  const int* __restrict__ w_ptr, long long w_val,
                  const int* __restrict__ p_ptr, long long p_val,
                  int* __restrict__ s_out, int* __restrict__ v_out, int n,
                  int W) {
  const int w = w_ptr ? *w_ptr : (int)w_val;
  const int p = p_ptr ? *p_ptr : (int)p_val;
  for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < n;
       idx += gridDim.x * kThreads) {
    const int r = idx / W, i = idx - r * W;
    const int st = s[idx], va = v[idx];
    const bool live = st >= 0, feas = live && st >= w;
    const int64_t o = (int64_t)r * 2 * W + i;
    s_out[o] = live ? st : -1;
    v_out[o] = live ? va : kNeg;
    s_out[o + W] = feas ? (int)((unsigned)st - (unsigned)w) : -1;
    v_out[o + W] = feas ? (int)((unsigned)va + (unsigned)p) : kNeg;
  }
}

}  // namespace

// n = rows * W nodes; w_ptr / p_ptr may be null (then w_val / p_val).
extern "C" int dd_expand(const void* s, const void* v, const void* w_ptr,
                         long long w_val, const void* p_ptr, long long p_val,
                         void* s_out, void* v_out, int n, int W,
                         void* stream) {
  if (n == 0) return 0;
  if (W <= 0 || n % W != 0) return (int)cudaErrorInvalidValue;
  int64_t blocks = ((int64_t)n + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;  // grid-stride past that
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  expand_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const int*>(s), static_cast<const int*>(v),
      static_cast<const int*>(w_ptr), w_val, static_cast<const int*>(p_ptr),
      p_val, static_cast<int*>(s_out), static_cast<int*>(v_out), n, W);
  return (int)cudaGetLastError();
}
