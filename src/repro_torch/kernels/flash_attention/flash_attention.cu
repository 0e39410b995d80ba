// K6 flash_attention: online-softmax attention for prefill, one launch for
// all (batch, head, query block) tiles.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention.  At the model layout, q (B, S, H, hd) and k, v
// (B, T, K, hd):
//   o[b, s, h] = softmax_t(mask(softcap(q[b, s, h] . k[b, t, h / (H / K)]
//                                       * scale))) . v[b, t, h / (H / K)]
// with float32 accumulation, queries right-aligned (q_pos = s + T - S),
// `causal` (k_pos <= q_pos), `window` (k_pos > q_pos - window),
// softcap = tanh(x / c) * c, and the output in q's dtype.  As in the TPU
// kernel, the running max starts at -1e30, masked probabilities are zeroed
// and the denominator is clamped at 1e-30, so a row with no visible key
// comes out as 0.
//
// Design: the Pallas kernel made the KV-block loop the last (sequential)
// grid dimension and kept (m, l, acc) in VMEM scratch across grid steps.
// On Hopper the blocks run in parallel and in no order, so each CTA owns
// one (b, h, 64-query block) and walks the KV blocks itself, with (m, l,
// acc) in registers: the 256 threads form a 16 x 16 grid, thread (ty, tx)
// holds query rows ty + 16 i (i < 4) and, of each row, logits columns
// tx + 16 j and output columns tx + 16 j.  Q and each 64-key K / V tile
// are staged in shared memory as float32 (padded rows: no bank conflicts),
// the probabilities pass through shared memory between the two products.
// GQA reads KV head h / (H / K) directly; nothing is repeated.  KV tiles
// that the causal / window masks hide from the whole query block are
// skipped (they would contribute exactly nothing).
//
// Bound: the two products, 4 * hd flops per visible (q, k) pair, over the
// card's dense bf16 tensor-core peak, or the bytes of q, k, v and o over
// 3.35 TB/s, whichever is larger.  This kernel multiplies on the FP32 cores
// from shared memory (no wgmma, no TMA), so it runs well above that bound.
// It serves ops.mha's float32 route: on tensor cores float32 means TF32,
// about three decimal digits, too coarse for the 2e-5 float32 tolerance.
// bfloat16 goes to the tensor-core kernel (flash_attention_wgmma.cu); this
// kernel's bfloat16 instances stay reachable through fa_flash_attention
// (ops.mha_simt) so that the earlier design can be timed beside it.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Max / sum over the 16 threads of one row (lanes tx = 0..15 of a warp
// half share ty).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int T_len,
                 int H, int K, float scale, int causal, int has_window,
                 int window, int has_softcap, float softcap) {
  constexpr int LD = HD + 1;   // padded smem row of Q, K, V
  constexpr int LP = kBK + 1;  // padded smem row of P
  constexpr int DJ = HD / 16;  // output columns per thread and row
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int t_off = T_len - S;
  const int64_t q_row = (int64_t)H * HD, kv_row = (int64_t)K * HD;
  const T* qb = q + (int64_t)b * S * q_row + (int64_t)h * HD;
  const T* kb = k + (int64_t)b * T_len * kv_row + (int64_t)kh * HD;
  const T* vb = v + (int64_t)b * T_len * kv_row + (int64_t)kh * HD;
  T* ob = o + (int64_t)b * S * q_row + (int64_t)h * HD;

  for (int idx = threadIdx.x; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx - r * HD;
    const int s = q0 + r;
    Qs[r * LD + d] = s < S ? load_f32(qb + (int64_t)s * q_row + d) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // The keys any row of this block can see.
  const int q_last = min(q0 + kBQ, S) - 1 + t_off;
  int k_end = T_len;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (has_window) k_begin = max(0, q0 + t_off - window + 1);

  for (int kt = (k_begin / kBK) * kBK; kt < k_end; kt += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < kBK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx - r * HD;
      const int t = kt + r;
      const bool in = t < T_len;
      Ks[r * LD + d] = in ? load_f32(kb + (int64_t)t * kv_row + d) : 0.f;
      Vs[r * LD + d] = in ? load_f32(vb + (int64_t)t * kv_row + d) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i + t_off;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = kt + tx + 16 * j;
        float x = sc[i][j] * scale;
        if (has_softcap) x = tanhf(x / softcap) * softcap;
        ok[j] = k_pos < T_len && (!causal || k_pos <= q_pos) &&
                (!has_window || k_pos > q_pos - window);
        sc[i][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      store_f32(ob + (int64_t)s * q_row + tx + 16 * j, acc[i][j] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int T_len, int H, int K, float scale, int causal, int has_window,
           int window, int has_softcap, float softcap, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (HD + 1) + kBQ * (kBK + 1));
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, H, K, scale,
      causal, has_window, window, has_softcap, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int S, int T_len, int H, int K, float scale, int causal,
              int has_window, int window, int has_softcap, float softcap,
              cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, T_len, H, K, scale, causal,
                           has_window, window, has_softcap, softcap, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, T_len, H, K, scale, causal,
                           has_window, window, has_softcap, softcap, s);
    case 112:  // zamba2-7b's shared attention (3,584 / 32 heads)
      return launch<T, 112>(q, k, v, o, B, S, T_len, H, K, scale, causal,
                            has_window, window, has_softcap, softcap, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, T_len, H, K, scale, causal,
                            has_window, window, has_softcap, softcap, s);
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, T_len, H, K, scale, causal,
                            has_window, window, has_softcap, softcap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window / softcap are read only when
// has_window / has_softcap are set.
extern "C" int fa_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int S, int T_len, int H,
                                  int K, int hd, int dtype, float scale,
                                  int causal, int has_window, int window,
                                  int has_softcap, float softcap,
                                  void* stream) {
  if (S == 0 || B == 0 || H == 0) return 0;
  if (K <= 0 || H % K != 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, B, S, T_len, H, K, scale, causal,
                            has_window, window, has_softcap, softcap, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, T_len, H, K, scale,
                                    causal, has_window, window, has_softcap,
                                    softcap, s);
  return (int)cudaErrorInvalidValue;
}
