// K6 flash_attention on Hopper's tensor cores: the bfloat16 route of
// ops.mha (float32 stays on the SIMT kernel of flash_attention.cu, since on
// tensor cores float32 means TF32, about three decimal digits, which cannot
// hold the JAX package's 2e-5 float32 tolerance).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (kernel.py:100).  Same function as flash_attention.cu:
//   o[b, s, h] = softmax_t(mask(softcap(q[b, s, h] . k[b, t, h / (H / K)]
//                                       * scale))) . v[b, t, h / (H / K)]
// at the model layout q (B, S, H, hd), k and v (B, T, K, hd), bfloat16 in
// and out, float32 logits, softmax and accumulation; queries right-aligned
// (q_pos = s + T - S), `causal` (k_pos <= q_pos), `window` (k_pos > q_pos -
// window), softcap = tanh(x / c) * c, scale 1 / sqrt(hd).  The running max
// starts at -1e30, masked probabilities are zeroed and the denominator is
// clamped at 1e-30, so a row that sees no key comes out as 0 (also from a
// CTA whose every KV tile is skipped).  One difference from the plain
// version, as in SDPA: P is rounded to bfloat16 before P V.
//
// Bound: the two products, 4 hd flops per visible (q, k) pair, at the dense
// bf16 tensor-core peak (989 TFLOP/s), or the bytes of q, k, v and o at
// 3.35 TB/s, whichever is larger; at prefill lengths it is the flops.  So
// both products run on the tensor cores (wgmma), operands arrive by TMA
// without costing the math warps instructions, the logits never leave
// registers, and no CTA waits for its start:
//
// - A work item is (batch, head, query block of BQ = 64 WG rows), ordered
//   by query block from the last, so the heaviest causal items come first;
//   the blocks end at row S, so a partial block is the lightest.  One
//   persistent CTA per SM takes items blockIdx.x, + gridDim.x, ...: WG
//   consumer warpgroups of 64 query rows each, which share every K / V
//   tile, and one producer warp.
// - The producer's first thread loads an item's Q block (two buffers, so
//   the next item's Q arrives while this one's is in use) and its K and V
//   tiles of BK keys by cp.async.bulk.tensor into a ring of STAGES stages
//   that runs on across items, K and V each completing on its own mbarrier;
//   a stage is reused when every consumer has released it.  So one item's
//   loads overlap the previous item's last products and its stores.
// - Tensor maps describe the model layout as it is, 4-D (hd, heads, seq,
//   batch); a box is one head's 64-element (128-byte) column chunk of BQ or
//   BK rows, written with the 128-byte swizzle (hd 32: 32 elements, 64-byte
//   swizzle) that the wgmma descriptors name.  Rows past S or T and columns
//   past hd (hd 112: the second chunk's last 16) come in as zeros.  GQA
//   reads KV head h / (H / K) through the head coordinate; nothing is
//   repeated.
// - Per KV tile a consumer issues S = Q K^T (wgmma m64nBKk16, Q and K
//   K-major from shared memory), runs the softmax on the accumulator
//   fragments in registers (row max and sum over the four threads of a row,
//   shfl_xor 1 and 2; exp2 on the special-function unit with log2(e) and
//   the scale in one FMA), and issues O += P V (wgmma m64nHDPk16 in the
//   register form: P, converted pairwise to bf16x2, is already the A
//   fragment; V is read MN-major through the transpose bit).  The three
//   consumers run out of step, so one's softmax overlaps the others'
//   products.  HDP is hd rounded up to the swizzle chunk (112 -> 128; the
//   zero columns are dropped on store).
// - KV tiles that the masks hide from the whole query block are skipped
//   (kv_tile_range below, line for line ops.kv_tile_range); a consumer also
//   skips the products of the block's tiles that its own 64 rows cannot see
//   (and all of them when its rows lie before row 0).  Masks apply only on
//   tiles that the diagonal, the window edge or T cut for a consumer's
//   rows, and O is rescaled only when a row's max moved.
// - The output is written from registers, bf16x2 per thread, rows past S
//   dropped.
//
// Tiles: a thread holds O (HDP / 2 registers) and S (BK / 2; P takes its
// place) in at most 128 registers: the compiler spreads the SM's 65,536
// over the CTA's threads rounded up to whole warpgroups, 512 for three
// consumers and the producer warp (256 and 255 a thread for hd 256's one
// consumer).  hd 32 and 64: WG 3, BK 128, 4 stages, 89 and 177 KB of shared
// memory; hd 112 and 128: WG 3, BK 64, 3 stages, 193 KB; hd 256: WG 1, BK
// 64, 2 stages, 193 KB.  Registers and spills per head dim:
// scripts/ptxas_report.py, recorded in PERF.md.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tile {
  // Consumer warpgroups of 64 query rows; hd 256 takes one, so that its 128
  // accumulator registers a thread fit beside the logits.
  static constexpr int WG = HD == 256 ? 1 : 3;
  static constexpr int BQ = 64 * WG;             // query rows per CTA
  static constexpr int THREADS = 128 * WG + 32;  // + the producer warp
  static constexpr int CW = HD == 32 ? 32 : 64;  // elements of a swizzled row
  static constexpr int SWZ = HD == 32 ? 2 : 1;   // descriptor: 64B / 128B
  static constexpr int NCH = (HD + CW - 1) / CW;  // column chunks
  static constexpr int HDP = NCH * CW;            // padded head dim
  static constexpr int BK = HD <= 64 ? 128 : 64;  // keys per KV tile
  static constexpr int STAGES = HD == 256 ? 2 : HD <= 64 ? 4 : 3;
  static constexpr int ROW_B = CW * 2;      // bytes of a chunk row
  static constexpr int ATOM_B = 8 * ROW_B;  // one swizzle atom: 8 rows
  static constexpr int Q_CHUNK = BQ * ROW_B;
  static constexpr int KV_CHUNK = BK * ROW_B;
  static constexpr int Q_BYTES = NCH * Q_CHUNK;
  static constexpr int KV_BYTES = NCH * KV_CHUNK;  // one K or V tile
  static constexpr int BARS = 4 + 3 * STAGES;
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS;  // + alignment
};

// The KV tiles [first, last) that query rows q0 .. q0 + rows - 1 (cut to
// 0 .. S - 1) can see; ops.kv_tile_range line for line.
__host__ __device__ inline int2 kv_tile_range(int q0, int rows, int S, int T,
                                              int causal, int has_window,
                                              int window, int bk) {
  const int q_last = min(q0 + rows, S) - 1 + (T - S);
  int k_end = T;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (has_window) k_begin = max(0, max(q0, 0) + (T - S) - window + 1);
  const int first = k_begin / bk;
  const int last = k_end <= 0 ? 0 : (k_end + bk - 1) / bk;
  return make_int2(first, max(first, last));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The masks and the softmax's scale, as the kernel was launched.
struct Softmax {
  int T, t_off, causal, has_window, window, has_softcap;
  float softcap, cap_in, sl2;
};

// Online softmax of one BK-key tile starting at key k0 on the accumulator
// fragments sc of S = Q K^T (this thread's rows row0 and row0 + 8; wg_lo is
// the warpgroup's first row): updates the running max m and sum l, rescales
// the output accumulator acc, and leaves P in pf as the bf16x2 A fragments
// of P V.
template <int BK, int NACC>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             uint32_t (&pf)[BK / 4],
                                             float (&acc)[NACC], float (&m)[2],
                                             float (&l)[2], const Softmax& a,
                                             int k0, int wg_lo, int row0,
                                             int qd) {
  // Does the diagonal, the window edge or T cut this tile for any of the
  // warpgroup's rows?
  const int p_lo = wg_lo + a.t_off, p_hi = wg_lo + 63 + a.t_off;
  const bool masked = k0 + BK > a.T || (a.causal && k0 + BK - 1 > p_lo) ||
                      (a.has_window && k0 <= p_hi - a.window);
  if (a.has_softcap) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      sc[i] = tanhf(sc[i] * a.cap_in) * a.softcap;
  }
  if (masked) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {  // register 4 jj + 2 r + c
      const int k_pos = k0 + 8 * (i / 4) + 2 * qd + i % 2;
      const int q_pos = row0 + 8 * ((i / 2) % 2) + a.t_off;
      const bool ok = k_pos < a.T && (!a.causal || k_pos <= q_pos) &&
                      (!a.has_window || k_pos > q_pos - a.window);
      if (!ok) sc[i] = kNegInf;
    }
  }
  float mx[2] = {m[0], m[1]}, corr[2], mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2((m[r] - mx[r]) * a.sl2);
    m[r] = mx[r];
    mb[r] = m[r] * a.sl2;
  }
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) {
    const int r = i % 2;
    float p0 = ex2(fmaf(sc[2 * i], a.sl2, -mb[r]));
    float p1 = ex2(fmaf(sc[2 * i + 1], a.sl2, -mb[r]));
    if (masked) {
      p0 = sc[2 * i] == kNegInf ? 0.f : p0;
      p1 = sc[2 * i + 1] == kNegInf ? 0.f : p1;
    }
    rs[r] += p0 + p1;
    pf[i] = pack_bf16x2(p0, p1);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
  // Rescale O only where a max moved (most tiles past the first few leave
  // every row's max where it was).
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] *= corr[(i / 2) % 2];
  }
}

// Work item w of a launch (ordered heaviest first: by query block from the
// last, then by batch and head): its batch, head and first query row.  The
// blocks end at row S, so a partial block is the first, which sees the
// fewest keys (its rows before 0 come in as zeros and are not stored).
struct Item {
  int b, h, q0;
};
__device__ __forceinline__ Item item_of(int w, int BH, int H, int S,
                                        int bq) {
  const int bh = w % BH;
  return {bh / H, bh % H, S - (w / BH + 1) * bq};
}

template <int HD>
__global__ void __launch_bounds__(Tile<HD>::THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       __nv_bfloat16* __restrict__ o, int B, int S, int T,
                       int H, int K, int n_qblocks, float scale, int causal,
                       int has_window, int window, int has_softcap,
                       float softcap) {
  using C = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  // Swizzled tiles must sit on 1024-byte boundaries of the shared space.
  uint8_t* Qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = Qs + 2 * C::Q_BYTES;  // two Q buffers: items alternate
  uint8_t* Vs = Ks + C::STAGES * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + C::STAGES * C::KV_BYTES);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + C::STAGES;
  uint64_t* empty = v_full + C::STAGES;

  const int BH = B * H, n_items = BH * n_qblocks;
  const int t_off = T - S;
  // The warp index through a shuffle, so the compiler knows it is uniform
  // across the warp: wgmma in a branch it cannot prove uniform gets
  // serialized.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], C::WG);
    }
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], C::WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Each CTA takes items blockIdx.x, + gridDim.x, ...; KV tiles run through
  // the ring in one sequence (tile `it`) across items.
  if (warp == 4 * C::WG) {
    // The producer warp: its first lane issues every copy, running ahead
    // into the next item while the consumers finish this one.
    if (lane == 0) {
      int it = 0, n = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
        const int qb = n % 2;
        if (n >= 2) mbar_wait(&q_empty[qb], (n / 2 - 1) & 1);
        const Item x = item_of(w, BH, H, S, C::BQ);
        const int2 range = kv_tile_range(x.q0, C::BQ, S, T, causal,
                                         has_window, window, C::BK);
        const int kh = x.h / (H / K);
        if (range.y > range.x) {
          mbar_expect_tx(&q_full[qb], C::Q_BYTES);
          for (int c = 0; c < C::NCH; ++c)
            tma_load_4d(Qs + qb * C::Q_BYTES + c * C::Q_CHUNK, &map_q,
                        &q_full[qb], c * C::CW, x.h, x.q0, x.b);
        } else {
          mbar_arrive(&q_full[qb]);  // nothing to load: keep the count
        }
        for (int kt = range.x; kt < range.y; ++kt, ++it) {
          const int s = it % C::STAGES;
          if (it >= C::STAGES) mbar_wait(&empty[s], (it / C::STAGES - 1) & 1);
          mbar_expect_tx(&k_full[s], C::KV_BYTES);
          for (int c = 0; c < C::NCH; ++c)
            tma_load_4d(Ks + s * C::KV_BYTES + c * C::KV_CHUNK, &map_k,
                        &k_full[s], c * C::CW, kh, kt * C::BK, x.b);
          mbar_expect_tx(&v_full[s], C::KV_BYTES);
          for (int c = 0; c < C::NCH; ++c)
            tma_load_4d(Vs + s * C::KV_BYTES + c * C::KV_CHUNK, &map_v,
                        &v_full[s], c * C::CW, kh, kt * C::BK, x.b);
        }
      }
    }
  } else {
    // A consumer warpgroup: rows wg_lo .. wg_lo + 63 of an item; this
    // thread holds rows row0 and row0 + 8 of them (the accumulator layout
    // in hopper.cuh).
    const int wg = warp / 4, g = lane / 4, qd = lane % 4;
    const bool leader = threadIdx.x % 128 == 0;
    // Logits stay unscaled (softcapped if asked) until the exponential,
    // which takes them times sl2 in one FMA.
    const Softmax sm{T, t_off, causal, has_window, window, has_softcap,
                     softcap, scale / softcap,
                     has_softcap ? kLog2e : scale * kLog2e};
    float acc[C::HDP / 2], sc[C::BK / 2];
    uint32_t pf[C::BK / 4];  // P as bf16x2: the A fragments of P V
    int it = 0, n = 0;

    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
      const int qb = n % 2;
      mbar_wait(&q_full[qb], (n / 2) & 1);
      const Item x = item_of(w, BH, H, S, C::BQ);
      const int2 range = kv_tile_range(x.q0, C::BQ, S, T, causal,
                                       has_window, window, C::BK);
      const int n_tiles = range.y - range.x;
      const int wg_lo = x.q0 + 64 * wg;
      const int row0 = wg_lo + 16 * (warp % 4) + g;
      const uint32_t q_addr =
          smem_addr(Qs + qb * C::Q_BYTES) + wg * 64 * C::ROW_B;
      // The tiles this warpgroup's own rows see (none if they all lie
      // before 0); it still waits for and releases the block's other tiles.
      const int2 mine = wg_lo + 64 > 0 ? kv_tile_range(wg_lo, 64, S, T,
                                                       causal, has_window,
                                                       window, C::BK)
                                       : make_int2(0, 0);
#pragma unroll
      for (int i = 0; i < C::HDP / 2; ++i) acc[i] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

      for (int t = it; t < it + n_tiles; ++t) {  // t: the tile in the ring
        const int s = t % C::STAGES, kt = range.x + t - it;
        const uint32_t parity = (t / C::STAGES) & 1;
        const bool used = kt >= mine.x && kt < mine.y;
        mbar_wait(&k_full[s], parity);
        if (used) {  // S = Q K^T and its softmax
          const uint32_t k_addr = smem_addr(Ks + s * C::KV_BYTES);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const int c = kk * 16 / C::CW;  // column chunk, bytes into it
            const uint32_t off = (kk * 16 % C::CW) * 2;
            wgmma_ss<C::BK>(sc,
                            gmma_desc(q_addr + c * C::Q_CHUNK + off, 16,
                                      C::ATOM_B, C::SWZ),
                            gmma_desc(k_addr + c * C::KV_CHUNK + off, 16,
                                      C::ATOM_B, C::SWZ),
                            kk > 0);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(sc);
          softmax_tile<C::BK>(sc, pf, acc, m, l, sm, kt * C::BK, wg_lo, row0,
                              qd);
        }
        mbar_wait(&v_full[s], parity);
        if (used) {  // O += P V
          const uint32_t v_addr = smem_addr(Vs + s * C::KV_BYTES);
          fence_regs(acc);
          fence_regs(pf);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < C::BK / 16; ++kk)
            wgmma_rs<C::HDP>(acc, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                             pf[4 * kk + 3],
                             gmma_desc(v_addr + kk * 16 * C::ROW_B,
                                       C::KV_CHUNK, C::ATOM_B, C::SWZ),
                             1);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(acc);
        }
        if (leader) mbar_arrive(&empty[s]);
      }
      it += n_tiles;
      if (leader) mbar_arrive(&q_empty[qb]);  // Q of this item is done

      const int64_t row_stride = (int64_t)H * HD;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = row0 + 8 * r;
        if (row < 0) continue;
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        __nv_bfloat16* orow =
            o + ((int64_t)x.b * S + row) * row_stride + x.h * HD;
#pragma unroll
        for (int jj = 0; jj < C::HDP / 8; ++jj) {
          if (8 * jj >= HD) break;  // hd 112: the padding columns
          *reinterpret_cast<uint32_t*>(orow + 8 * jj + 2 * qd) = pack_bf16x2(
              acc[4 * jj + 2 * r] * inv, acc[4 * jj + 2 * r + 1] * inv);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in the driver library; the kernel library
// links only the runtime, so it is looked up once through the runtime.
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

// A (hd, heads, seq, batch) bf16 tensor map with (cw, 1, rows, 1) boxes.
bool encode(CUtensorMap* map, const void* base, int hd, int heads, int seq,
            int batch, int cw, int rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)seq * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cw, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int T_len, int H, int K, float scale, int causal, int has_window,
           int window, int has_softcap, float softcap, cudaStream_t stream) {
  using C = Tile<HD>;
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const CUtensorMapSwizzle swz = C::SWZ == 1 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap mq, mk, mv;
  if (!encode(&mq, q, HD, H, S, B, C::CW, C::BQ, swz) ||
      !encode(&mk, k, HD, K, T_len, B, C::CW, C::BK, swz) ||
      !encode(&mv, v, HD, K, T_len, B, C::CW, C::BK, swz))
    return (int)cudaErrorInvalidValue;
  static int n_sm = 0;  // persistent CTAs: one per SM
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_qblocks = (S + C::BQ - 1) / C::BQ;
  if ((int64_t)B * H * n_qblocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int n_items = B * H * n_qblocks;
  flash_wgmma_kernel<HD>
      <<<n_items < n_sm ? n_items : n_sm, C::THREADS, C::SMEM, stream>>>(
          mq, mk, mv, static_cast<__nv_bfloat16*>(o), B, S, T_len, H, K,
          n_qblocks, scale, causal, has_window, window, has_softcap,
          softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// The dynamic shared memory a launch at head dim hd asks for (0: no such
// instance), for scripts/ptxas_report.py: ptxas reports only static.
extern "C" int fa_flash_attention_wgmma_smem(int hd) {
  switch (hd) {
    case 32: return Tile<32>::SMEM;
    case 64: return Tile<64>::SMEM;
    case 112: return Tile<112>::SMEM;
    case 128: return Tile<128>::SMEM;
    case 256: return Tile<256>::SMEM;
    default: return 0;
  }
}

// bfloat16 q, k, v and o, each 16-byte aligned.  window / softcap are read
// only when has_window / has_softcap are set.
extern "C" int fa_flash_attention_wgmma(const void* q, const void* k,
                                        const void* v, void* o, int B, int S,
                                        int T_len, int H, int K, int hd,
                                        float scale, int causal,
                                        int has_window, int window,
                                        int has_softcap, float softcap,
                                        void* stream) {
  if (S == 0 || B == 0 || H == 0) return 0;
  if (K <= 0 || H % K != 0 || (int64_t)B * H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_len == 0)  // no key at all: every row is 0
    return (int)cudaMemsetAsync(o, 0, (size_t)B * S * H * hd * 2, s);
  switch (hd) {
#define FA_CASE(HD)                                                 \
  case HD:                                                          \
    return launch<HD>(q, k, v, o, B, S, T_len, H, K, scale, causal, \
                      has_window, window, has_softcap, softcap, s);
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(112)
    FA_CASE(128)
    FA_CASE(256)
#undef FA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
