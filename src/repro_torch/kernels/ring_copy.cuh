// The ring-copy primitive shared by K1 ring_gather, K2 ring_scatter, K3
// ring_slice and K4 ring_transfer: K1 and K3 read the ring
// (gather_chunk), K2 and K4 write it (scatter_chunk).
//
// The kernels move one segment per lane between the lane's ring of `cap`
// rows and a dense block: ring rows (start + i) mod cap for i < live.  Rows
// are contiguous `row_bytes`, so in bytes the ring is a circular buffer of
// cap * row_bytes bytes whose segment begins at byte start * row_bytes, and
// the move is a memcpy of at most two contiguous byte ranges (more only
// where a K1 segment laps a ring smaller than it).  Everything is done in
// bytes: one path serves float32, int32 and bfloat16 rows of any width.
//
// Work split: one CTA of kThreads per (chunk of kChunk bytes of the lane's
// dense side, lane, leaf).  A CTA turns its lane's cursors into byte
// offsets once, in int32 (the wrappers refuse a ring, block or stack of
// 2^31 bytes or more), then copies its chunk run by run; no word is
// indexed with `/` or `%`.  128 threads and 8 KB chunks timed best among
// 4-32 KB chunks of 128-512 threads at the solver's shapes, and plain
// loads beat a TMA bulk copy staged through shared memory (PERF.md §6).
//
// A run is stored 16 bytes a thread (`uint4`): a scalar head up to the
// destination's 16-byte boundary, aligned vector stores, a scalar tail,
// with every load of a thread issued before its first store.  A write
// that wraps the ring copies its two runs at once, each by a share of the
// CTA's warps.
// The source side of a run generally sits at another offset mod 16 (a
// 4-byte row starts at 0, 4, 8 or 12), so loads are aligned `uint4`s and
// each stored vector is assembled from two of them with __funnelshift_r.
//
// One launch moves up to kMaxLeaves payload leaves, passed by value in a
// RingTree (kernel parameter space, no device array of pointers); a larger
// tree takes one launch per kMaxLeaves leaves (the wrappers split it).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ringcopy {

constexpr int kThreads = 128;
constexpr int kChunk = 8192;  // bytes of one lane's dense side per CTA
constexpr int kMaxLeaves = 8;

// One payload leaf: K1 and K3 read the ring `src` into the blocks `dst`;
// K2 reads the batch `src` and K4 the window stack `src` into the ring
// `dst`.
struct RingLeaf {
  const uint8_t* src;
  uint8_t* dst;
  int row_bytes;
};

struct RingTree {
  RingLeaf leaf[kMaxLeaves];
  int count;
};

// x mod m in [0, m), also for negative x (Python's `%`, as the plain
// versions compute it).
__device__ __forceinline__ int py_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

// (base + b) mod ring for 0 <= base < ring and 0 <= b < 2^31, without
// overflowing int32.
__device__ __forceinline__ int wrap_add(int base, int b, int ring) {
  unsigned pos = (unsigned)base + (unsigned)(b % ring);
  if (pos >= (unsigned)ring) pos -= (unsigned)ring;
  return (int)pos;
}

// Bytes 4 Q + shift / 8 to 4 Q + shift / 8 + 15 of the 32 in `a`, `b`
// (little-endian words).
template <int Q>
__device__ __forceinline__ uint4 realign(const uint4 a, const uint4 b,
                                         int shift) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  return make_uint4(__funnelshift_r(w[Q], w[Q + 1], shift),
                    __funnelshift_r(w[Q + 1], w[Q + 2], shift),
                    __funnelshift_r(w[Q + 2], w[Q + 3], shift),
                    __funnelshift_r(w[Q + 3], w[Q + 4], shift));
}

// out[k] = the 16 bytes 16 k + 4 Q + shift / 8 past the aligned `in`, for
// k < nvec, by threads t of nt.  The second load of a vector reads the
// aligned block holding its last byte, so nothing outside the source's
// 16-byte blocks is read.
template <int Q, bool kAligned>
__device__ __forceinline__ void copy_vectors(uint4* __restrict__ out,
                                             const uint4* __restrict__ in,
                                             int nvec, int shift, int t,
                                             int nt) {
  auto load = [&](int k) {
    if constexpr (kAligned) return __ldg(in + k);
    else return realign<Q>(__ldg(in + k), __ldg(in + k + 1), shift);
  };
  for (int k = t; k < nvec; k += 2 * nt) {
    const uint4 v = load(k);
    const int k2 = k + nt;
    if (k2 < nvec) {
      const uint4 v2 = load(k2);
      out[k] = v;
      out[k2] = v2;
    } else {
      out[k] = v;
    }
  }
}

// The 16-byte body of copy_bytes: nvec vectors from `src` to the aligned
// `dst`, by threads t of nt.
__device__ __forceinline__ void copy_body(uint8_t* __restrict__ dst,
                                          const uint8_t* __restrict__ src,
                                          int nvec, int t, int nt) {
  uint4* out = reinterpret_cast<uint4*>(dst);
  const int mis = (int)((uintptr_t)src & 15u);
  const uint4* in = reinterpret_cast<const uint4*>(src - mis);
  const int shift = (mis & 3) * 8;
  switch (mis >> 2) {  // the same for every thread of a warp
    case 0:
      if (mis == 0) {
        copy_vectors<0, true>(out, in, nvec, 0, t, nt);
      } else {
        copy_vectors<0, false>(out, in, nvec, shift, t, nt);
      }
      break;
    case 1:
      copy_vectors<1, false>(out, in, nvec, shift, t, nt);
      break;
    case 2:
      copy_vectors<2, false>(out, in, nvec, shift, t, nt);
      break;
    default:
      copy_vectors<3, false>(out, in, nvec, shift, t, nt);
      break;
  }
}

// dst[i] = src[i] for i < len, by threads t = 0 .. nt - 1 of the CTA (nt
// >= 16): stores aligned to dst, loads realigned in registers.  The scalar
// head and tail are loaded before the body and stored after it, so no load
// waits for a store.
__device__ __forceinline__ void copy_bytes(uint8_t* __restrict__ dst,
                                           const uint8_t* __restrict__ src,
                                           int len, int t, int nt) {
  int head = (int)((16u - ((uintptr_t)dst & 15u)) & 15u);
  if (head > len) head = len;
  const int nvec = (len - head) >> 4;
  const int tail = (len - head) & 15;
  const int at = head + (nvec << 4);  // where the tail starts
  uint8_t h = 0, e = 0;
  if (t < head) h = src[t];
  if (t < tail) e = src[at + t];
  if (nvec > 0) copy_body(dst + head, src + head, nvec, t, nt);
  if (t < head) dst[t] = h;
  if (t < tail) dst[at + t] = e;
}

// dst[i] = 0 for i < len, by the CTA's threads.
__device__ __forceinline__ void zero_bytes(uint8_t* __restrict__ dst,
                                           int len) {
  const int t = threadIdx.x;
  int head = (int)((16u - ((uintptr_t)dst & 15u)) & 15u);
  if (head > len) head = len;
  if (t < head) dst[t] = 0;
  dst += head;
  len -= head;
  const int nvec = len >> 4;
  const int tail = len & 15;
  if (t < tail) dst[(nvec << 4) + t] = 0;
  uint4* out = reinterpret_cast<uint4*>(dst);
  for (int k = t; k < nvec; k += kThreads) out[k] = make_uint4(0, 0, 0, 0);
}

// One CTA's part of a K1 / K3 read, for one lane and leaf: bytes [c0, c1)
// of the lane's dense block `out` are the ring's rows start_row + i (mod
// cap) up to byte `live`, zero after.  The live part is at most two
// contiguous runs out of the ring (more only where a segment laps a ring
// smaller than it).
__device__ __forceinline__ void gather_chunk(const uint8_t* __restrict__ ring,
                                             uint8_t* __restrict__ out,
                                             int start_row, int live, int rb,
                                             int ring_bytes, int c0, int c1) {
  const int end = min(c1, live);
  int b = c0;
  if (b < end) {
    int pos = wrap_add(start_row * rb, b, ring_bytes);
    while (b < end) {
      const int run = min(end - b, ring_bytes - pos);
      copy_bytes(out + b, ring + pos, run, threadIdx.x, kThreads);
      b += run;
      pos = 0;
    }
  }
  if (b < c1) zero_bytes(out + b, c1 - b);
}

// Write `len` <= ring_bytes bytes from `src` into the circular `ring` of
// `ring_bytes` bytes at byte `pos`; returns the position after them.
// Where the bytes wrap, the two runs are copied at once, each by a share of
// the CTA's warps in proportion to its length, so the second run's loads
// do not wait for the first run's stores.
__device__ __forceinline__ int put(uint8_t* __restrict__ ring, int ring_bytes,
                                   int pos, const uint8_t* __restrict__ src,
                                   int len) {
  const int first = min(len, ring_bytes - pos);
  uint8_t* dst = ring + pos;
  int n = len, t = threadIdx.x, nt = kThreads;
  if (first < len) {  // one inlined copy serves both runs
    constexpr int kWarps = kThreads / 32;
    const int w1 = (int)(((int64_t)kWarps * first + len / 2) / len);
    const int split = 32 * min(max(w1, 1), kWarps - 1);
    if (t < split) {
      n = first;
      nt = split;
    } else {
      dst = ring;
      src += first;
      n = len - first;
      t -= split;
      nt = kThreads - split;
    }
  }
  copy_bytes(dst, src, n, t, nt);
  if (first < len) return len - first;
  return pos + len == ring_bytes ? 0 : pos + len;
}

// One CTA's part of a K2 / K4 write, for one lane and leaf: bytes [c0, c1)
// of the lane's dense block `in` go to the ring's rows start_row + i (mod
// cap), i.e. to ring byte (start_row * rb + c0) mod ring_bytes onwards.
// With c1 - c0 <= ring_bytes that is at most two contiguous runs.
// Returns the ring position after the last byte written.
__device__ __forceinline__ int scatter_chunk(uint8_t* __restrict__ ring,
                                             const uint8_t* __restrict__ in,
                                             int start_row, int rb,
                                             int ring_bytes, int c0, int c1) {
  const int pos = wrap_add(start_row * rb, c0, ring_bytes);
  return put(ring, ring_bytes, pos, in + c0, c1 - c0);
}

// Launch shape: x chunks of the largest leaf's `rows` rows, y lanes (the
// kernels stride over the rest), z leaves.  Refuses an empty or oversized
// tree.
inline bool grid_for(const RingTree& tree, int lanes, int rows, dim3* grid) {
  if (tree.count < 1 || tree.count > kMaxLeaves || lanes < 1 || rows < 1) {
    return false;
  }
  int64_t widest = 0;
  for (int i = 0; i < tree.count; ++i) {
    if (tree.leaf[i].row_bytes < 1) return false;
    const int64_t bytes = (int64_t)rows * tree.leaf[i].row_bytes;
    if (bytes > widest) widest = bytes;
  }
  *grid = dim3((unsigned)((widest + kChunk - 1) / kChunk),
               (unsigned)(lanes < 65535 ? lanes : 65535),
               (unsigned)tree.count);
  return true;
}

}  // namespace ringcopy
