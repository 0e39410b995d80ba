// K7 ssd_scan on Hopper's tensor cores: the bfloat16 route of ops.ssd at
// head dim 64, state width 64 or 128 and chunks of 64 to 256 (a multiple
// of 64); every other shape, and float32, stays on the SIMT kernel of
// ssd_scan.cu (on tensor cores float32 means TF32, which the float32
// tolerance does not admit).
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py::ssd_scan
// (kernel.py:80).  Same function as ssd_scan.cu: at the model layout x (B,
// S, nh, 64), dt (B, S, nh), a and D (nh,), Bm and Cm (B, S, ns), chunk Q,
// per chunk with the float32 state (64, ns) carried from chunk to chunk:
//   cs_i   = cumsum(dt * a) within the chunk                    (float64)
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//          + exp(cs_i) (C_i . state) + D x_i
//   state' = state exp(cs_last) + sum_j x_j dt_j exp(cs_last - cs_j) B_j^T
// y in bfloat16, the final state in float32 (B, nh, 64, ns).  The cumsum
// and every difference of it are float64, exponentiated in float32, and
// never as a ratio of exponentials; a ragged last chunk counts its missing
// positions as dt = 0 (TMA fills their x, B and C rows with zeros).  Three
// operands of the products are not inputs, and none is rounded to a single
// bf16: each is split into bf16 parts, one wgmma a part, into a float32
// accumulator.  G o L and x dt exp(cs_last - cs) go in three (high,
// middle, low: about 24 bits), the incoming state in two (about 16 bits;
// three would not fit launch 2's shared memory).  So y and the state are
// the plain version's to about float32's precision, summed in another
// order: y lands on the plain version's bf16 value except where that
// order puts a sum on the other side of a bf16 rounding boundary.
//
// Bound: per (batch, chunk) C B^T over the causal pairs once (B and C are
// per batch), per head the causal half of (G L) x, C state^T and the state
// update, at the dense bf16 tensor-core peak, or the bytes of x, dt, Bm,
// Cm, y and the final state at 3.35 TB/s, whichever is larger: at the
// serving shapes the bytes.  What this design moves beyond them: launch 1
// reads B once per head (from L2), launch 2 reads x and the incoming state
// once per query tile.
//
// Design: the Pallas kernel made the chunk a sequential grid dimension
// and carried the state in VMEM scratch.  Here the chunk-parallel form of
// the SSD paper (Dao & Gu, arXiv:2405.21060, section 6) in two launches:
//
// 1. ssd_state_kernel, one CTA (one warpgroup) per (batch, head), walks
//    the sequence in 64-row blocks through a ring of TMA stages (x rows
//    and Bm rows) and keeps the state in wgmma accumulators (64 x ns,
//    float32).  Per chunk it computes the float64 cumsum (a block scan,
//    dt loaded a chunk ahead) and scales the state by exp(cs_last); per
//    block it adds (x w)^T B, w_j = dt_j exp(cs_last - cs_j), with
//    m64nNSk16 wgmmas in the register form: A = (x w)^T built from the
//    swizzled x tile, B = Bm read MN-major through the transpose bit.
//    Before each chunk after the first it writes the incoming state for
//    launch 2, as a bf16 high part and the bf16 rest, and each chunk's
//    cumsum and masked dt; at the end the final state in float32.  This
//    walk is the only sequential step: a few wgmmas per block.
// 2. ssd_output_kernel, one CTA per (batch, chunk, 64-row query tile,
//    group of 8 heads), heaviest tile first.  Two warpgroups, four heads
//    each, share the tile's C rows and the chunk's B rows up to the tile
//    (TMA).  Each forms G = C B^T for its tile once, in registers (KR =
//    qt + 1 key blocks of 64 x 64, float32), and per head:
//      acc  = C state_in^T (wgmma, both operands K-major from shared
//             memory, the state's two parts), rows scaled by exp(cs_i);
//      acc += (G o L) x per half key block: G o L is formed on the
//             accumulator fragments and its three parts are the A operands
//             of register-form wgmmas (x read MN-major).  On the diagonal
//             block L is one exponential per pair; below it, exp(cs_i -
//             cs_j) = exp(cs_i - cs_m) exp(cs_m - cs_j) with the block's
//             last key m, which lies between every such j and i: both
//             factors are exponentials of float64 differences and at most
//             1, formed once per row and key, not per pair;
//      y    = acc + D x, gathered across each quad by shuffles and stored
//             16 bytes a thread.
//    KR is a template parameter, chosen by a switch at entry: a wgmma
//    under a run-time branch on it is serialised by ptxas (C7519).  A
//    warpgroup's head inputs (x rows, cumsum and dt) come by TMA and bulk
//    copies into two buffers of its own, the second pair taking the place
//    of B's rows once G is formed; a head's incoming state into one slot
//    of its own, loaded for the next head once C state^T is done.
//
// Tiles: all TMA boxes are 64 x 64 bf16 (128-byte rows, 128-byte swizzle,
// the layout the wgmma descriptors name).  At Q 256 launch 1 takes 52 KB
// of shared memory (ns 128, two stages; three CTAs an SM) or 53 KB (ns 64,
// three stages; four CTAs); launch 2 takes 225 KB (ns 128), one.
// Registers, spills and shared memory per instance: scripts/ptxas_report.py,
// in PERF.md.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../hopper.cuh"

namespace {

using namespace hopper;

constexpr int kHD = 64;            // head dim: one 64-row wgmma tile
constexpr int kTile = 64;          // query rows, key rows, TMA box rows
constexpr int kRowB = 128;         // bytes of a swizzled row: 64 bf16
constexpr int kBox = kTile * kRowB;  // one 64 x 64 box, 8 KB
constexpr int kMaxQ = 256;
constexpr int kStateThreads = 128;  // launch 1: one warpgroup
constexpr int kOutThreads = 256;    // launch 2: two warpgroups
constexpr int kHeadsPerWG = 4;
// Launch 2's factors of the key blocks below the diagonal, per warpgroup:
// a row factor and a key factor for each of up to 3 blocks of 64.
constexpr int kFacBytes = 2 * (kMaxQ - 64) * 4;
constexpr int kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A quad (threads q = lane % 4 of one accumulator row) holds a bf16 row as
// v[jj] = columns 8 jj + 2 q, + 1; returns this thread's 16 bytes of group
// gr: columns 8 (4 gr + q) .. + 7, gathered from the quad by shuffles, so
// that a row is stored 16 bytes a thread instead of 4.
template <int N>
__device__ __forceinline__ uint4 quad_row(const uint32_t (&v)[N], int gr,
                                          int q) {
  uint32_t o[4];  // o[t]: word q ^ t of the 16 bytes
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int src = q ^ t;  // the sender's word for this thread's group
    uint32_t send = v[4 * gr];
#pragma unroll
    for (int k = 1; k < 4; ++k) send = src == k ? v[4 * gr + k] : send;
    o[t] = t == 0 ? send : __shfl_xor_sync(0xffffffffu, send, t);
  }
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = q ^ k;
    w[k] = o[0];
#pragma unroll
    for (int u = 1; u < 4; ++u) w[k] = t == u ? o[u] : w[k];
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Byte offset of element (row, col) of a tile of 64-column, 128-byte rows
// written by TMA with the 128-byte swizzle (the tile 1024-byte aligned).
__device__ __forceinline__ int swz(int row, int col) {
  return row * kRowB + ((((col >> 3) ^ row) & 7) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ float2 bf16x2_at(const uint8_t* tile, int row,
                                            int col) {  // col even
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(tile + swz(row, col)));
}

// Launch 1's ring of 64-row stages: as deep as four CTAs an SM allow
// (at ns 128, two stages, kept at three CTAs).
__host__ __device__ constexpr int state_stages(int ns) {
  return ns == 128 ? 2 : 3;
}

// Shared-memory layouts, in bytes from a 1024-byte aligned base.
struct StateSmem {
  int stage_bytes, cs, w, part, bar, total;
  __host__ __device__ StateSmem(int ns, int Q) {
    stage_bytes = kBox * (1 + ns / 64);     // 64 rows: x, then B's chunks
    cs = state_stages(ns) * stage_bytes;    // Q doubles
    w = cs + Q * 8;                         // Q floats: dt, then w
    part = w + Q * 4;                       // 4 doubles: warp totals
    bar = part + 32;                        // one per stage
    total = bar + 8 * state_stages(ns);
  }
};

struct OutSmem {
  int c, s, s_bytes, keys, buf, buf_bytes, x, cs, dt, bar, fac, total;
  __host__ __device__ OutSmem(int ns, int Q) {
    const int nch = ns / 64;
    c = 0;                                  // the tile's C rows
    s = c + nch * kBox;                     // per warpgroup, a head's
    s_bytes = 2 * nch * kBox;               // incoming state: high part,
                                            // then low
    buf = s + 2 * s_bytes;                  // four head buffers:
    x = 0;                                  //   Q x rows
    cs = x + Q * kRowB;                     //   Q doubles
    dt = cs + Q * 8;                        //   Q floats
    buf_bytes = (dt + Q * 4 + 1023) / 1024 * 1024;  // swizzle atoms
    keys = buf + 2 * buf_bytes;             // nch chunks of Q B rows, in
                                            // buffers 2 and 3 until G is
                                            // formed
    bar = buf + 4 * buf_bytes;              // bars: in, buf[0 .. 3], s[0, 1]
    fac = bar + 64;                         // per warpgroup: the factors
    total = fac + 2 * kFacBytes;            // below the diagonal
  }
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// ---------------------------------------------------------- launch 1

// Launch 1's CTAs an SM: at ns 128 three, so that x w's three parts fit
// in registers (168 a thread) without spilling.
__host__ __device__ constexpr int state_ctas(int ns) {
  return ns == 128 ? 3 : 4;
}

template <int NS>
__global__ void __launch_bounds__(kStateThreads, state_ctas(NS))
    ssd_state_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_b,
                     const float* __restrict__ dt, const float* __restrict__ A,
                     double* __restrict__ cs_out, float* __restrict__ dt_out,
                     __nv_bfloat16* __restrict__ s_out,
                     float* __restrict__ fin, int S, int nh, int Q) {
  constexpr int kStages = state_stages(NS);
  extern __shared__ uint8_t smem_raw[];
  const StateSmem L(NS, Q);
  uint8_t* base = aligned_smem(smem_raw);
  double* cs_s = reinterpret_cast<double*>(base + L.cs);
  float* w_s = reinterpret_cast<float*>(base + L.w);
  double* part = reinterpret_cast<double*>(base + L.part);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bar);

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int nc = (S + Q - 1) / Q, nt = Q / kTile, n_blocks = nc * nt;
  const float a = A[h];
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Row block t of the walk (chunk t / nt, rows 64 (t % nt) ..) into stage
  // t % kStages: its x rows, then its Bm rows in 64-column chunks.
  auto load_block = [&](int t) {
    uint8_t* st = base + (t % kStages) * L.stage_bytes;
    uint64_t* bar = &full[t % kStages];
    const int row = (t / nt) * Q + (t % nt) * kTile;
    mbar_expect_tx(bar, L.stage_bytes);
    tma_load_4d(st, &map_x, bar, 0, h, row, b);
    for (int ch = 0; ch < NS / 64; ++ch)
      tma_load_3d(st + (1 + ch) * kBox, &map_b, bar, ch * 64, row, b);
  };
  if (tid == 0)
    for (int t = 0; t < min(kStages, n_blocks); ++t) load_block(t);

  // acc: the state, row d = 16 warp + g + 8 i, column n = 8 j + 2 q + c in
  // register 4 j + 2 i + c (hopper.cuh).
  float acc[NS / 2];
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) acc[i] = 0.f;
  const int per = (Q + kStateThreads - 1) / kStateThreads;  // 1 or 2
  // This thread's dt of chunk c, loaded a chunk ahead.
  auto load_dt = [&](int c, float (&dv)[2]) {
    const int c0 = c * Q, len = min(Q, S - c0);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int j = tid * per + p;
      dv[p] = c < nc && p < per && j < len
                  ? dt[((int64_t)b * S + c0 + j) * nh + h]
                  : 0.f;
    }
  };
  float dv_next[2];
  load_dt(0, dv_next);

  for (int c = 0; c < nc; ++c) {
    const int64_t bch = ((int64_t)b * nc + c) * nh + h;
    if (c > 0) {  // the incoming state of chunk c, for launch 2: rows
                  // 0 .. 63 its bf16 high part, rows 64 .. 127 the rest
      __nv_bfloat16* so = s_out + bch * 2 * kHD * NS;
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t v[NS / 8];
#pragma unroll
          for (int j = 0; j < NS / 8; ++j) {
            const float a0 = acc[4 * j + 2 * i], a1 = acc[4 * j + 2 * i + 1];
            v[j] = pack_bf16x2(a0, a1);
            if (part == 1) {
              const float2 hf = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&v[j]));
              v[j] = pack_bf16x2(a0 - hf.x, a1 - hf.y);
            }
          }
#pragma unroll
          for (int gr = 0; gr < NS / 32; ++gr)
            *reinterpret_cast<uint4*>(
                so + (part * kHD + 16 * warp + g + 8 * i) * NS +
                8 * (4 * gr + q)) = quad_row(v, gr, q);
        }
    }
    // The cumsum of dt * a in float64: `per` positions a thread, a warp
    // scan, then the warps' totals.
    const float dv[2] = {dv_next[0], dv_next[1]};
    load_dt(c + 1, dv_next);
    double run = 0.0, v[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      run += (double)(dv[p] * a);
      v[p] = run;
    }
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0;
    if (lane == 31) part[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) excl += part[w];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int j = tid * per + p;
      if (p < per && j < Q) {
        cs_s[j] = excl + v[p];
        w_s[j] = dv[p];
        cs_out[bch * Q + j] = excl + v[p];
        dt_out[bch * Q + j] = dv[p];
      }
    }
    __syncthreads();
    const double cs_last = cs_s[Q - 1];  // = cs at len - 1: dt = 0 past it
    for (int j = tid; j < Q; j += kStateThreads)
      w_s[j] *= expf((float)(cs_last - cs_s[j]));
    const float seg = expf((float)cs_last);
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) acc[i] *= seg;
    __syncthreads();

    // state += (x w)^T B, one 64-row block at a time.  A = (x w)^T: row d,
    // column j; four bf16x2 registers per 16 columns, x w split into three
    // bf16 parts (three wgmmas), so the state keeps about 24 bits of x w,
    // not 8.
    const int d0 = 16 * warp + g;
    for (int r = 0; r < nt; ++r) {
      const int t = c * nt + r, s = t % kStages;
      const uint8_t* Xs = base + s * L.stage_bytes;
      mbar_wait(&full[s], (t / kStages) & 1);
      uint32_t af[3][16];  // high, middle, low
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // columns +0 / +8
          const int jl = 16 * kk + 2 * q + 8 * half, j = r * kTile + jl;
          const float w0 = w_s[j], w1 = w_s[j + 1];
#pragma unroll
          for (int i = 0; i < 2; ++i) {  // rows d0 / d0 + 8
            const int d = d0 + 8 * i;
            const float x0 = __bfloat162float(*reinterpret_cast<
                const __nv_bfloat16*>(Xs + swz(jl, d)));
            const float x1 = __bfloat162float(*reinterpret_cast<
                const __nv_bfloat16*>(Xs + swz(jl + 1, d)));
            float v0 = x0 * w0, v1 = x1 * w1;
#pragma unroll
            for (int part = 0; part < 3; ++part) {
              const uint32_t pv = pack_bf16x2(v0, v1);
              const float2 pf = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&pv));
              af[part][4 * kk + 2 * half + i] = pv;
              v0 -= pf.x;  // exact: the rest of x w
              v1 -= pf.y;
            }
          }
        }
      }
      const uint32_t b_addr = smem_addr(Xs + kBox);
      fence_regs(acc);
#pragma unroll
      for (int part = 0; part < 3; ++part) fence_regs(af[part]);
      wgmma_fence();
#pragma unroll
      for (int part = 2; part >= 0; --part)  // smallest first
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<NS>(acc, af[part][4 * kk], af[part][4 * kk + 1],
                       af[part][4 * kk + 2], af[part][4 * kk + 3],
                       gmma_desc(b_addr + kk * 16 * kRowB, kBox, 1024, 1), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncthreads();  // the stage is free
      if (tid == 0 && t + kStages < n_blocks)
        load_block(t + kStages);
    }
  }

  float* fo = fin + ((int64_t)b * nh + h) * kHD * NS;
#pragma unroll
  for (int j = 0; j < NS / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(fo + (16 * warp + g + 8 * i) * NS + 8 * j +
                                 2 * q) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
}

// ---------------------------------------------------------- launch 2

// Work item w (heaviest first: by query tile from the last, then chunk,
// batch and head group).
struct OutItem {
  int qt, c, b, hg;
};
__device__ __forceinline__ OutItem out_item(int w, int B, int nc, int ng,
                                            int nt) {
  const int hg = w % ng;
  w /= ng;
  const int b = w % B;
  w /= B;
  const int c = w % nc;
  return {nt - 1 - w / nc, c, b, hg};
}

// One work item of launch 2, its tile seeing KR key blocks (KR = qt + 1):
// a compile-time count, so that no wgmma sits under a branch on it (ptxas
// would serialise them) and G holds only KR blocks.
template <int NS, int KR>
__device__ __forceinline__ void output_item(
    const CUtensorMap& map_x, const CUtensorMap& map_b,
    const CUtensorMap& map_c, const CUtensorMap& map_s,
    const double* __restrict__ cs, const float* __restrict__ dtm,
    const float* __restrict__ D, __nv_bfloat16* __restrict__ y,
    const OutItem it, int S, int nh, int Q) {
  constexpr int NCH = NS / 64;
  extern __shared__ uint8_t smem_raw[];
  const OutSmem L(NS, Q);
  uint8_t* base = aligned_smem(smem_raw);
  uint64_t* bar_in = reinterpret_cast<uint64_t*>(base + L.bar);
  const int nc = (S + Q - 1) / Q;
  const int c0 = it.c * Q, len = min(Q, S - c0), i_lo = it.qt * kTile;

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), lane = tid % 32;
  const int wg = warp / 4, g = lane / 4, q = lane % 4;
  const bool leader = tid % 128 == 0;
  const int h_lo = (it.hg * 2 + wg) * kHeadsPerWG;
  const int n_heads = max(0, min(kHeadsPerWG, nh - h_lo));
  if (tid == 0) {
    for (int i = 0; i < 7; ++i) mbar_init(bar_in + i, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Head k of this warpgroup into buffer wg + 2 (k % 2): its x rows up to
  // the tile, cumsum and dt.
  auto load_head = [&](int k) {
    const int h = h_lo + k, bi = wg + 2 * (k % 2);
    uint8_t* buf = base + L.buf + bi * L.buf_bytes;
    uint64_t* bar = bar_in + 1 + bi;
    const int64_t bch = ((int64_t)it.b * nc + it.c) * nh + h;
    mbar_expect_tx(bar, KR * kBox + KR * kTile * 12);
    for (int r = 0; r < KR; ++r)
      tma_load_4d(buf + L.x + r * kBox, &map_x, bar, 0, h, c0 + r * kTile,
                  it.b);
    bulk_load(buf + L.cs, cs + bch * Q, KR * kTile * 8, bar);
    bulk_load(buf + L.dt, dtm + bch * Q, KR * kTile * 4, bar);
  };
  // Head k's incoming state (chunks after the first), both parts, into
  // the warpgroup's one state slot: C state^T comes first in a head's
  // work, so the next head's state loads while this one's (G o L) x runs.
  auto load_state = [&](int k) {
    const int64_t bch = ((int64_t)it.b * nc + it.c) * nh + h_lo + k;
    uint8_t* slot = base + L.s + wg * L.s_bytes;
    uint64_t* bar = bar_in + 5 + wg;
    mbar_expect_tx(bar, 2 * NCH * kBox);
    for (int part = 0; part < 2; ++part)
      for (int ch = 0; ch < NCH; ++ch)
        tma_load_3d(slot + (part * NCH + ch) * kBox, &map_s, bar, ch * 64,
                    part * kHD, (int)bch);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_in, NCH * kBox * (1 + KR));
    for (int ch = 0; ch < NCH; ++ch) {
      tma_load_3d(base + L.c + ch * kBox, &map_c, bar_in, ch * 64,
                  c0 + i_lo, it.b);
      for (int r = 0; r < KR; ++r)
        tma_load_3d(base + L.keys + ch * Q * kRowB + r * kBox, &map_b, bar_in,
                    ch * 64, c0 + r * kTile, it.b);
    }
  }
  if (leader && n_heads > 0) {
    load_head(0);
    if (it.c > 0) load_state(0);
  }

  const uint32_t c_addr = smem_addr(base + L.c);
  const uint32_t k_addr = smem_addr(base + L.keys);

  // G = C B^T for the tile's rows against key blocks 0 .. KR - 1, once for
  // all heads: block kb in G[kb] (accumulator layout of hopper.cuh).
  float G[KR][32];
  mbar_wait(bar_in, 0);
  if (n_heads > 0) {
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < KR; ++kb) {
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32 + (kk / 4) * kBox;
        wgmma_ss<64>(G[kb], gmma_desc(c_addr + off, 16, 1024, 1),
                     gmma_desc(k_addr + (kk / 4) * Q * kRowB + kb * kBox +
                                   (kk % 4) * 32,
                               16, 1024, 1),
                     kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int kb = 0; kb < KR; ++kb) fence_regs(G[kb]);
  }
  __syncthreads();  // B's rows are read: buffers 2 and 3 are free
  if (n_heads == 0) return;  // no barrier below involves the other group
  if (leader && n_heads > 1) load_head(1);

  const int i0 = i_lo + 16 * (warp % 4) + g;  // rows i0, i0 + 8 (in chunk)
  float* fa = reinterpret_cast<float*>(base + L.fac + wg * kFacBytes);
  float* fb = fa + (kMaxQ - 64);
  const uint32_t s_addr = smem_addr(base + L.s + wg * L.s_bytes);
  for (int k = 0; k < n_heads; ++k) {
    const int h = h_lo + k, bi = wg + 2 * (k % 2);
    const uint8_t* buf = base + L.buf + bi * L.buf_bytes;
    const uint32_t x_addr = smem_addr(buf + L.x);
    const double* css = reinterpret_cast<const double*>(buf + L.cs);
    const float* dts = reinterpret_cast<const float*>(buf + L.dt);
    const uint8_t* Xs = buf + L.x;
    mbar_wait(bar_in + 1 + bi, (k / 2) & 1);
    const double csi[2] = {css[i0], css[i0 + 8]};
    float acc[32];
    if (it.c > 0) {  // exp(cs_i) (C_i . state_in), high part then low
      mbar_wait(bar_in + 5 + wg, k & 1);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < NS / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32 + (kk / 4) * kBox;
          wgmma_ss<64>(acc, gmma_desc(c_addr + off, 16, 1024, 1),
                       gmma_desc(s_addr + part * NCH * kBox + off, 16, 1024,
                                 1),
                       part > 0 || kk > 0);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      const float e[2] = {expf((float)csi[0]), expf((float)csi[1])};
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= e[(i / 2) % 2];
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    }
    // Below the diagonal, key block kb's pivot m = 64 kb + 63 lies between
    // every key j of the block and every row i of the tile, so exp(cs_i -
    // cs_j) = exp(cs_i - cs_m) exp(cs_m - cs_j): two exponentials of
    // float64 differences, each at most 1, formed once per row and once
    // per key (fa, fb) instead of once per pair.
    for (int e = tid % 128; e < (KR - 1) * kTile; e += 128) {
      const double piv = css[(e / kTile) * kTile + kTile - 1];
      fa[e] = expf((float)(css[i_lo + e % kTile] - piv));
      fb[e] = expf((float)(piv - css[e])) * dts[e];
    }
    // fa, fb written; every warp of the group is past the state slot.
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (leader && it.c > 0 && k + 1 < n_heads) load_state(k + 1);
    // acc += (G o L) x over the key blocks at or below the diagonal, G o L
    // as three bf16 parts (high, middle, low: about 24 bits of it), half
    // a key block (32 keys, 8 registers a part) at a time.
#pragma unroll
    for (int kb = 0; kb < KR; ++kb) {
      const bool diag = kb == KR - 1;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t pf[3][8];
#pragma unroll
        for (int mm = 0; mm < 8; ++mm) {  // registers 2 m, 2 m + 1
          const int m = 8 * half + mm, jj = m / 2, r = m % 2;
          const int j = kb * kTile + 8 * jj + 2 * q, i = i0 + 8 * r;
          float p[2];
          if (diag) {  // per pair, the upper triangle masked
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const float l =
                  ex2((float)(csi[r] - css[j + cc]) * kLog2e) * dts[j + cc];
              p[cc] = j + cc > i ? 0.f : G[kb][2 * m + cc] * l;
            }
          } else {
            const float ga = fa[kb * kTile + i - i_lo];
            const float2 gb = *reinterpret_cast<const float2*>(fb + j);
            p[0] = G[kb][2 * m] * ga * gb.x;
            p[1] = G[kb][2 * m + 1] * ga * gb.y;
          }
#pragma unroll
          for (int part = 0; part < 3; ++part) {
            pf[part][mm] = pack_bf16x2(p[0], p[1]);
            const float2 pv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&pf[part][mm]));
            p[0] -= pv.x;  // exact: the rest of p
            p[1] -= pv.y;
          }
        }
        fence_regs(acc);
#pragma unroll
        for (int part = 0; part < 3; ++part) fence_regs(pf[part]);
        wgmma_fence();
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
          for (int part = 2; part >= 0; --part)  // smallest first
            wgmma_rs<64>(acc, pf[part][4 * k2], pf[part][4 * k2 + 1],
                         pf[part][4 * k2 + 2], pf[part][4 * k2 + 3],
                         gmma_desc(x_addr + (kb * kTile +
                                             (2 * half + k2) * 16) * kRowB,
                                   Q * kRowB, 1024, 1),
                         1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
    }
    // y = acc + D x, 16 bytes a thread; rows past the chunk's end are
    // dropped.
    const float Dh = D[h];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      uint32_t v[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 xv = bf16x2_at(Xs, i, 8 * jj + 2 * q);
        v[jj] = pack_bf16x2(acc[4 * jj + 2 * r] + Dh * xv.x,
                            acc[4 * jj + 2 * r + 1] + Dh * xv.y);
      }
      __nv_bfloat16* yrow = y + (((int64_t)it.b * S + c0 + i) * nh + h) * kHD;
#pragma unroll
      for (int gr = 0; gr < 2; ++gr) {
        const uint4 out = quad_row(v, gr, q);  // every lane shuffles
        if (i < len)
          *reinterpret_cast<uint4*>(yrow + 8 * (4 * gr + q)) = out;
      }
    }
    // The warpgroup is done with this buffer: load its head after next.
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (leader && k + 2 < n_heads) load_head(k + 2);
  }
}

template <int NS>
__global__ void __launch_bounds__(kOutThreads, 1)
    ssd_output_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_b,
                      const __grid_constant__ CUtensorMap map_c,
                      const __grid_constant__ CUtensorMap map_s,
                      const double* __restrict__ cs,
                      const float* __restrict__ dtm,
                      const float* __restrict__ D,
                      __nv_bfloat16* __restrict__ y, int B, int S, int nh,
                      int Q) {
  const int nc = (S + Q - 1) / Q;
  const int ng = (nh + 2 * kHeadsPerWG - 1) / (2 * kHeadsPerWG);
  const OutItem it = out_item(blockIdx.x, B, nc, ng, Q / kTile);
  if (it.qt * kTile >= min(Q, S - it.c * Q)) return;  // past a ragged end
  switch (it.qt) {
#define SSD_ITEM(QT)                                                      \
  case QT:                                                                \
    output_item<NS, QT + 1>(map_x, map_b, map_c, map_s, cs, dtm, D, y, it, \
                            S, nh, Q);                                    \
    break;
    SSD_ITEM(0)
    SSD_ITEM(1)
    SSD_ITEM(2)
    SSD_ITEM(3)
#undef SSD_ITEM
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; the kernel library links only
// the runtime, so it is looked up once through the runtime.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first, the innermost
// contiguous) with 64 x 1 ... x 64 boxes: 64 elements of dim 0 and 64 rows
// of dim `row_dim`, 128-byte swizzle; reads past the ends come in as zeros.
bool encode(CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims, int row_dim) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  cuuint64_t strides[3];
  cuuint64_t stride = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  cuuint32_t box[4] = {64, 1, 1, 1};
  box[row_dim] = kTile;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
int allow_smem(Kernel kernel, bool* done) {  // once per instance and process
  if (*done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) *done = true;
  return (int)err;
}

template <int NS>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, void* y, void* fin, void* cs,
           void* dtm, void* s_in, int B, int S, int nh, int Q,
           cudaStream_t stream) {
  static bool set_state = false, set_out = false;
  int err = allow_smem(ssd_state_kernel<NS>, &set_state);
  if (err == 0) err = allow_smem(ssd_output_kernel<NS>, &set_out);
  if (err != 0) return err;
  const int nc = (S + Q - 1) / Q;
  const cuuint64_t dx[4] = {kHD, (cuuint64_t)nh, (cuuint64_t)S,
                            (cuuint64_t)B};
  const cuuint64_t dbc[3] = {NS, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t ds[3] = {NS, 2 * kHD, (cuuint64_t)B * nc * nh};
  CUtensorMap mx, mb, mc, ms;
  if (!encode(&mx, x, 4, dx, 2) || !encode(&mb, Bm, 3, dbc, 1) ||
      !encode(&mc, Cm, 3, dbc, 1) || !encode(&ms, s_in, 3, ds, 1))
    return (int)cudaErrorInvalidValue;
  ssd_state_kernel<NS>
      <<<dim3((unsigned)nh, (unsigned)B), kStateThreads,
         StateSmem(NS, Q).total + 1024, stream>>>(
          mx, mb, static_cast<const float*>(dt),
          static_cast<const float*>(A), static_cast<double*>(cs),
          static_cast<float*>(dtm), static_cast<__nv_bfloat16*>(s_in),
          static_cast<float*>(fin), S, nh, Q);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int ng = (nh + 2 * kHeadsPerWG - 1) / (2 * kHeadsPerWG);
  const int64_t items = (int64_t)(Q / kTile) * nc * B * ng;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  ssd_output_kernel<NS>
      <<<(unsigned)items, kOutThreads, OutSmem(NS, Q).total + 1024,
         stream>>>(mx, mb, mc, ms, static_cast<const double*>(cs),
                   static_cast<const float*>(dtm),
                   static_cast<const float*>(D),
                   static_cast<__nv_bfloat16*>(y), B, S, nh, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// The dynamic shared memory launch `which` (1: states, 2: output) asks for
// at state width ns and chunk Q, for scripts/ptxas_report.py (ptxas
// reports only static shared memory).
extern "C" int ss_ssd_scan_wgmma_smem(int which, int ns, int Q) {
  return 1024 + (which == 1 ? StateSmem(ns, Q).total : OutSmem(ns, Q).total);
}

// bfloat16 x, Bm, Cm and y (16-byte aligned), float32 dt, A, D and the
// final state; scratch from the wrapper: cs (B, nc, nh, Q) float64, dtm
// (B, nc, nh, Q) float32 and s_in (B, nc, nh, 2, 64, ns) bfloat16 (high and
// low parts), nc = ceil(S / Q).  Two launches.
extern "C" int ss_ssd_scan_wgmma(const void* x, const void* dt, const void* A,
                                 const void* Bm, const void* Cm,
                                 const void* D, void* y, void* fin, void* cs,
                                 void* dtm, void* s_in, int B, int S, int nh,
                                 int hd, int ns, int Q, void* stream) {
  if (B == 0 || nh == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd != kHD || Q < kTile || Q > kMaxQ || Q % kTile != 0 || B > 65535 ||
      nh > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm | (uintptr_t)y |
       (uintptr_t)cs | (uintptr_t)dtm | (uintptr_t)s_in) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (S == 0)  // no token: the final state is zero
    return (int)cudaMemsetAsync(fin, 0, (size_t)B * nh * hd * ns * 4, s);
  switch (ns) {
    case 64:
      return launch<64>(x, dt, A, Bm, Cm, D, y, fin, cs, dtm, s_in, B, S, nh,
                        Q, s);
    case 128:
      return launch<128>(x, dt, A, Bm, Cm, D, y, fin, cs, dtm, s_in, B, S, nh,
                         Q, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
