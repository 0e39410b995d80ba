// K5 redesigned: the whole DD explore of a batch of subproblems in one
// launch, with K5's arc rule applied in registers at every layer.
//
// Replaces the TPU kernel repro/kernels/dd_expand/kernel.py::expand together
// with the decision-diagram reductions the solver runs around it
// (repro/core/dd/diagram.py, bnb.py).  For each of B subproblems (layer,
// state, value, valid) it computes what
// repro_torch.core.dd.bnb.explore_batch_plain computes, bit for bit:
//   - the restricted DD over layers layer..n_vars-1 (keep the top W nodes
//     by value after merging duplicate states): primal = its best value;
//   - the relaxed DD (keep the top W-1, merge the rest into one node of
//     max state and max value): dual = its best value;
//   - the exact DD until more than W distinct states survive a layer; then
//     the parent pool is the frontier, whose live nodes are the children
//     (layer, state, value), slot by slot; if it never overflows the
//     subproblem is exact and primal = dual = its optimum;
//   - rows with valid = 0 give primal = dual = -2^30, exact = 0 and dead
//     children, and cost no work.
// Each layer expands every live node (s, v) of a pool into the 0-arc child
// (s, v) and, when s >= w, the 1-arc child (s - w, v + p); dead slots hold
// (-1, -2^30).  int32 wraps as PyTorch's does.
//
// Bound: a few hundred KB and a few tens of millions of integer
// operations at the solver's batch (512 subproblems, W 16, 30 layers): a
// microsecond or less either way, so the launch floor dominates.  The
// earlier design paid that floor about 5,300 times a superstep (K5 once
// per layer and pool, tens of small PyTorch launches around each); this
// pays it once.
//
// Design: one CTA of three warps per subproblem, one warp per DD (restricted,
// relaxed, exact).  Lane j holds slot j of its warp's pool (W <= 32) and so
// the layer's children j (0-arc) and W + j (1-arc).  The reference merges
// duplicates with a lexsort on (state, value, index) and keeps the last
// of each state, then takes top_k by value with ties to the lower sorted
// position, i.e. to the lower state.  Here both are counted, not sorted:
// a child is kept when no other child of its state has a larger value, or
// the same value and a larger index (W shuffled rounds); a kept child's
// slot is the number of kept children with a larger value, or the same
// value and a smaller state (W more rounds).  Slots past K (W, or W-1 for
// the relaxed DD) are dropped; the relaxed DD's merged node is two warp
// max-reductions over the kept children not placed.  The exact warp stops
// at its first overflow.  Nothing leaves the CTA but the outputs.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);
constexpr int kDead = -1;
constexpr int kMaxWidth = 32;
constexpr int kWarps = 3;
constexpr unsigned kAll = 0xffffffffu;

enum Mode { kRestricted = 0, kRelaxed = 1, kExact = 2 };

struct Node {
  int s, v;
};

__device__ __forceinline__ Node dead() { return Node{kDead, kNeg}; }

// One layer of the pool this warp holds (lane j: slot j for j < W): both
// arcs of every node with (w, p), duplicates merged, the top K kept (and,
// for the relaxed DD, the rest merged into slot W - 1).  Returns this
// lane's new slot; `overflow` (exact DD) is whether more than W distinct
// states survived.  `ss` and `sv` are the warp's W slots in shared memory.
template <int kMode>
__device__ __forceinline__ Node dd_layer(Node me, int lane, int W, int w,
                                         int p, int* ss, int* sv,
                                         bool* overflow) {
  // K5's arc rule: children lane (0-arc) and W + lane (1-arc)
  const bool live = lane < W && me.s >= 0;
  const bool feas = live && me.s >= w;
  const Node c0 = live ? me : dead();
  const Node c1 =
      feas ? Node{(int)((unsigned)me.s - (unsigned)w),
                  (int)((unsigned)me.v + (unsigned)p)}
           : dead();

  // Merge duplicate states: keep a child when no child of its state has a
  // larger value, or the same value and a larger index.
  bool k0 = c0.s >= 0, k1 = c1.s >= 0;
  for (int src = 0; src < W; ++src) {
    const int s0 = __shfl_sync(kAll, c0.s, src);
    const int v0 = __shfl_sync(kAll, c0.v, src);
    const int s1 = __shfl_sync(kAll, c1.s, src);
    const int v1 = __shfl_sync(kAll, c1.v, src);
    // src's 0-arc has index src, its 1-arc W + src > every 0-arc index
    k0 = k0 && !(s0 == c0.s && (v0 > c0.v || (v0 == c0.v && src > lane)));
    k0 = k0 && !(s1 == c0.s && v1 >= c0.v);
    k1 = k1 && !(s0 == c1.s && v0 > c1.v);
    k1 = k1 && !(s1 == c1.s && (v1 > c1.v || (v1 == c1.v && src > lane)));
  }

  // Rank the kept children of value > -2^30 by (value desc, state asc);
  // the others stay out of every slot (the reference's top_k reads them as
  // dead).
  const int e0 = k0 && c0.v > kNeg ? c0.v : kNeg;
  const int e1 = k1 && c1.v > kNeg ? c1.v : kNeg;
  int r0 = 0, r1 = 0;
  for (int src = 0; src < W; ++src) {
    const int s0 = __shfl_sync(kAll, c0.s, src);
    const int v0 = __shfl_sync(kAll, e0, src);
    const int s1 = __shfl_sync(kAll, c1.s, src);
    const int v1 = __shfl_sync(kAll, e1, src);
    r0 += (v0 > e0 || (v0 == e0 && s0 < c0.s)) +
          (v1 > e0 || (v1 == e0 && s1 < c0.s));
    r1 += (v0 > e1 || (v0 == e1 && s0 < c1.s)) +
          (v1 > e1 || (v1 == e1 && s1 < c1.s));
  }
  const int K = kMode == kRelaxed ? W - 1 : W;
  const bool put0 = e0 > kNeg && r0 < K, put1 = e1 > kNeg && r1 < K;

  if (lane < W) {
    ss[lane] = kDead;
    sv[lane] = kNeg;
  }
  __syncwarp();
  if (put0) {
    ss[r0] = c0.s;
    sv[r0] = c0.v;
  }
  if (put1) {
    ss[r1] = c1.s;
    sv[r1] = c1.v;
  }
  __syncwarp();
  Node out = lane < W ? Node{ss[lane], sv[lane]} : dead();
  __syncwarp();

  if (kMode == kRelaxed) {
    // The kept children not placed merge into slot W - 1: max state, and
    // max value over all 2W child positions with the others read as
    // -2^30 (so -2^30 counts unless every position is merged).
    const bool rest0 = k0 && !put0, rest1 = k1 && !put1;
    const int ms = __reduce_max_sync(
        kAll, max(rest0 ? c0.s : kDead, rest1 ? c1.s : kDead));
    int mv = __reduce_max_sync(
        kAll, max(rest0 ? c0.v : INT_MIN, rest1 ? c1.v : INT_MIN));
    const int n_rest = __popc(__ballot_sync(kAll, rest0)) +
                       __popc(__ballot_sync(kAll, rest1));
    if (n_rest < 2 * W) mv = max(mv, kNeg);
    if (lane == W - 1) out = n_rest > 0 ? Node{ms, mv} : dead();
  }
  if (kMode == kExact) {
    *overflow = __popc(__ballot_sync(kAll, k0)) +
                    __popc(__ballot_sync(kAll, k1)) > W;
  }
  return out;
}

// max over the W slots of (state >= 0 ? value : -2^30), on every lane
__device__ __forceinline__ int best(Node me, int lane, int W) {
  return __reduce_max_sync(kAll,
                           lane < W ? (me.s >= 0 ? me.v : kNeg) : INT_MIN);
}

__global__ void __launch_bounds__(kWarps * 32)
    explore_kernel(const int* __restrict__ layer,
                   const int* __restrict__ state,
                   const int* __restrict__ value,
                   const uint8_t* __restrict__ valid,
                   const int* __restrict__ weights,
                   const int* __restrict__ profits, int n_vars, int W,
                   int* __restrict__ primal, int* __restrict__ dual,
                   uint8_t* __restrict__ exact, int* __restrict__ ch_layer,
                   int* __restrict__ ch_state, int* __restrict__ ch_value) {
  __shared__ int ss[kWarps][kMaxWidth], sv[kWarps][kMaxWidth];
  __shared__ int bound[2];  // the restricted and relaxed DDs' best values
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t o = (int64_t)b * W + lane;  // this lane's child slot
  if (!valid[b]) {  // an invalid row produces nothing
    if (warp == 0 && lane == 0) {
      primal[b] = dual[b] = kNeg;
      exact[b] = 0;
    }
    if (warp == 0 && lane < W) {
      ch_layer[o] = -1;
      ch_state[o] = kDead;
      ch_value[o] = kNeg;
    }
    return;
  }
  const int first = max(layer[b], 0);  // layers before it are no-ops
  const Node root = lane == 0 ? Node{state[b], value[b]} : dead();
  bool dummy;

  if (warp < 2) {
    Node me = root;
    for (int i = first; i < n_vars; ++i) {
      const int w = __ldg(weights + i), p = __ldg(profits + i);
      me = warp == 0 ? dd_layer<kRestricted>(me, lane, W, w, p, ss[0],
                                             sv[0], &dummy)
                     : dd_layer<kRelaxed>(me, lane, W, w, p, ss[1], sv[1],
                                          &dummy);
    }
    const int m = best(me, lane, W);
    if (lane == 0) bound[warp] = m;
  }
  __syncthreads();
  if (warp < 2) return;

  // The exact DD, frozen at the parent pool of its first overflow.
  Node pool = root, frontier = root;
  int f_layer = -1;
  for (int i = first; i < n_vars; ++i) {
    bool overflow;
    const Node next = dd_layer<kExact>(pool, lane, W, __ldg(weights + i),
                                       __ldg(profits + i), ss[2], sv[2],
                                       &overflow);
    if (overflow) {
      frontier = pool;
      f_layer = i;
      break;
    }
    pool = next;
  }
  const bool was_exact = f_layer < 0;
  const int exact_value = best(pool, lane, W);
  if (lane == 0) {
    primal[b] = was_exact ? exact_value : bound[0];
    dual[b] = was_exact ? exact_value : bound[1];
    exact[b] = was_exact;
  }
  if (lane < W) {
    const bool child = !was_exact && frontier.s >= 0;
    ch_layer[o] = child ? f_layer : -1;
    ch_state[o] = child ? frontier.s : kDead;
    ch_value[o] = child ? frontier.v : kNeg;
  }
}

}  // namespace

// B subproblems of width W (2 <= W <= 32) over n_vars layers; valid and
// exact are bytes (torch.bool), everything else int32.
extern "C" int dd_explore(const void* layer, const void* state,
                          const void* value, const void* valid,
                          const void* weights, const void* profits,
                          int n_vars, int W, int B, void* primal, void* dual,
                          void* exact, void* ch_layer, void* ch_state,
                          void* ch_value, void* stream) {
  if (W < 2 || W > kMaxWidth) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  explore_kernel<<<(unsigned)B, kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(layer), static_cast<const int*>(state),
      static_cast<const int*>(value), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(weights), static_cast<const int*>(profits),
      n_vars, W, static_cast<int*>(primal), static_cast<int*>(dual),
      static_cast<uint8_t*>(exact), static_cast<int*>(ch_layer),
      static_cast<int*>(ch_state), static_cast<int*>(ch_value));
  return (int)cudaGetLastError();
}
