// K7 ssd_scan: the Mamba2 SSD chunked scan for prefill, one launch for all
// (batch, head) pairs, on the FP32 cores: the float32 route of ops.ssd and
// the bfloat16 shapes that the tensor-core kernel (ssd_scan_wgmma.cu) does
// not take; in bfloat16 also its earlier design, timed beside it.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py::ssd_scan.  At
// the model layout, x (B, S, nh, hd), dt (B, S, nh), a and D (nh,), Bm and
// Cm (B, S, ns), chunk Q.  Per chunk of Q positions, with the float32
// state (hd, ns) carried from chunk to chunk (zero before the first):
//   cs_i   = cumsum(dt * a) within the chunk
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//          + exp(cs_i) (C_i . state) + D x_i
//   state' = state exp(cs_last) + sum_j x_j dt_j exp(cs_last - cs_j) B_j^T
// y in x's dtype, the final state in float32 (B, nh, hd, ns).  A ragged
// last chunk (S % Q != 0) is masked here: its missing positions count as
// dt = 0, which is what the plain version's zero padding computes.  The
// cumsum and its differences are float64 (then exp in float32), as in the
// plain version: at chunk 256 the cumsum reaches about -170, where a
// float32 step is 1.5e-5, and its rounding would be the scan's largest
// error.
//
// Design: the Pallas kernel made the chunk the last (sequential) grid
// dimension and carried the state in VMEM scratch.  On Hopper the blocks
// run in parallel and in no order, so each CTA owns one (b, h) and walks
// the chunks itself, the state in shared memory.  The (Q, Q) block does
// not fit (Q = 256: 256 KB in float32), so it is never held: query rows
// go in 64-row tiles, and each tile meets the 64-key blocks at or below
// the diagonal only (the blocks above it are skipped).  For each pair the
// 256 threads (16 x 16) form G = C B^T on a 64 x 64 tile, scale it by
// exp(cs_i - cs_j) dt_j — always an exponential of a difference, never a
// ratio of exponentials, which would underflow to 0 / 0 — and accumulate
// G x into registers.  Bm and Cm are per batch: every head reads the
// batch's rows, nothing is broadcast per head.  All products run on the
// FP32 cores from padded shared-memory tiles (no bank conflicts).
//
// Bound: per (b, h) and chunk, the causal half of C B^T and of (G L) x,
// plus C state^T and the state update, over the card's dense bf16
// tensor-core peak, or the bytes of x, dt, Bm, Cm, y and the final state
// over 3.35 TB/s, whichever is larger.  This first version uses no
// tensor cores (no wgmma, no TMA) and recomputes C B^T for every head of
// a batch, so it runs well above that bound.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;          // query rows per tile, keys per block
constexpr int kThreads = 256;   // 16 x 16
constexpr int kMaxNS = 128;     // state width: 8 columns of 16 per thread
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ D,
               T* __restrict__ y, float* __restrict__ fin, int S, int nh,
               int ns, int Q) {
  constexpr int LX = HD + 1;            // padded smem row of X
  constexpr int LP = kT + 1;            // padded smem row of P
  constexpr int DJ = (HD + 15) / 16;    // x / state rows per thread
  constexpr int NK = kMaxNS / 16;       // state columns per thread
  const int LN = ns + 1;                // padded smem row of C, B, state
  extern __shared__ double smem_d[];
  double* cs = smem_d;                  // (Q,) within-chunk cumsum
  double* part = cs + Q;                // (kThreads,) scan partials
  float* St = reinterpret_cast<float*>(part + kThreads);  // (HD, LN) state
  float* Cs = St + HD * LN;             // (kT, LN) C rows of a query tile
  float* Bs = Cs + kT * LN;             // (kT, LN) B rows of a key block
  float* Xs = Bs + kT * LN;             // (kT, LX) x rows of a key block
  float* Ps = Xs + kT * LX;             // (kT, LP) masked G L tile
  float* dts = Ps + kT * LP;            // (Q,) dt of the chunk

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a = A[h], Dh = D[h];
  const int64_t x_row = (int64_t)nh * HD;
  const T* xb = x + (int64_t)b * S * x_row + (int64_t)h * HD;
  T* yb = y + (int64_t)b * S * x_row + (int64_t)h * HD;
  const float* dtb = dt + (int64_t)b * S * nh + h;
  const T* Bb = Bm + (int64_t)b * S * ns;
  const T* Cb = Cm + (int64_t)b * S * ns;

  for (int e = tid; e < HD * LN; e += kThreads) St[e] = 0.f;

  // Rows [r0, r0 + kT) of an (S, ns) matrix of this batch into a padded
  // tile; rows past the chunk's end are zero.
  auto load_ns = [&](float* dst, const T* src, int r0, int end) {
    for (int idx = tid; idx < kT * ns; idx += kThreads) {
      const int r = idx / ns, n = idx - r * ns;
      dst[r * LN + n] =
          r0 + r < end ? load_f32(src + (int64_t)(r0 + r) * ns + n) : 0.f;
    }
  };

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int len = min(Q, S - c0);
    __syncthreads();  // the previous chunk is done with cs, dts and St
    for (int t = tid; t < Q; t += kThreads)
      dts[t] = t < len ? dtb[(int64_t)(c0 + t) * nh] : 0.f;
    __syncthreads();
    // Inclusive cumsum of dt * a: each thread a run of `per` positions,
    // then a scan over the threads' totals.
    const int per = (Q + kThreads - 1) / kThreads;
    const int t0 = min(tid * per, Q), t1 = min(t0 + per, Q);
    double run = 0.0;
    for (int t = t0; t < t1; ++t) {
      run += (double)(dts[t] * a);
      cs[t] = run;
    }
    part[tid] = run;
    __syncthreads();
    for (int off = 1; off < kThreads; off <<= 1) {
      const double v = tid >= off ? part[tid - off] : 0.0;
      __syncthreads();
      part[tid] += v;
      __syncthreads();
    }
    const double before = tid > 0 ? part[tid - 1] : 0.0;
    for (int t = t0; t < t1; ++t) cs[t] += before;
    __syncthreads();
    const double cs_last = cs[len - 1];

    // y, one 64-row query tile at a time, against the carried state.
    for (int i0 = 0; i0 < len; i0 += kT) {
      __syncthreads();  // the previous tile's readers of Cs are done
      load_ns(Cs, Cb + (int64_t)c0 * ns, i0, len);
      float acc[4][DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

      for (int j0 = 0; j0 <= i0; j0 += kT) {
        __syncthreads();  // the previous block's readers are done
        load_ns(Bs, Bb + (int64_t)c0 * ns, j0, len);
        for (int idx = tid; idx < kT * HD; idx += kThreads) {
          const int r = idx / HD, d = idx - r * HD;
          Xs[r * LX + d] =
              j0 + r < len ? load_f32(xb + (int64_t)(c0 + j0 + r) * x_row + d)
                           : 0.f;
        }
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < ns; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * LN + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * LN + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int il = i0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int jl = j0 + tx + 16 * j;
            Ps[(ty + 16 * i) * LP + tx + 16 * j] =
                (jl <= il && il < len)
                    ? g[i][j] * expf((float)(cs[il] - cs[jl])) * dts[jl]
                    : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int c = 0; c < kT; ++c) {
          float p[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * LP + c];
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            const int d = tx + 16 * j;
            const float xv = d < HD ? Xs[c * LX + d] : 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], xv, acc[i][j]);
          }
        }
      }

      // The carried state's contribution, C_i . state_d, and the skip.
      float inter[4][DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) inter[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < ns; ++n) {
        float cv[4], sv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * LN + n];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int d = tx + 16 * j;
          sv[j] = d < HD ? St[d * LN + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j)
            inter[i][j] = fmaf(cv[i], sv[j], inter[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int il = i0 + ty + 16 * i;
        if (il >= len) continue;
        const float decay = expf((float)cs[il]);
        const int64_t row = (int64_t)(c0 + il) * x_row;
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int d = tx + 16 * j;
          if (d >= HD) continue;
          const float xi = load_f32(xb + row + d);
          store_f32(yb + row + d, acc[i][j] + decay * inter[i][j] + Dh * xi);
        }
      }
    }

    // The state update: state exp(cs_last) + (x dt exp(cs_last - cs))^T B,
    // thread (ty, tx) owning state rows ty + 16 i and columns tx + 16 k.
    __syncthreads();  // every reader of the old state is done
    const float seg = expf((float)cs_last);
    float sacc[DJ][NK];
#pragma unroll
    for (int i = 0; i < DJ; ++i)
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const int d = ty + 16 * i, n = tx + 16 * k;
        sacc[i][k] = (d < HD && n < ns) ? St[d * LN + n] * seg : 0.f;
      }
    for (int j0 = 0; j0 < len; j0 += kT) {
      __syncthreads();  // the previous block's readers are done
      load_ns(Bs, Bb + (int64_t)c0 * ns, j0, len);
      for (int idx = tid; idx < kT * HD; idx += kThreads) {
        const int r = idx / HD, d = idx - r * HD;
        const int jl = j0 + r;
        Xs[r * LX + d] =
            jl < len ? load_f32(xb + (int64_t)(c0 + jl) * x_row + d) *
                           (dts[jl] * expf((float)(cs_last - cs[jl])))
                     : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kT; ++j) {
        float xv[DJ], bv[NK];
#pragma unroll
        for (int i = 0; i < DJ; ++i) {
          const int d = ty + 16 * i;
          xv[i] = d < HD ? Xs[j * LX + d] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int n = tx + 16 * k;
          bv[k] = n < ns ? Bs[j * LN + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < DJ; ++i)
#pragma unroll
          for (int k = 0; k < NK; ++k) sacc[i][k] = fmaf(xv[i], bv[k], sacc[i][k]);
      }
    }
#pragma unroll
    for (int i = 0; i < DJ; ++i)
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const int d = ty + 16 * i, n = tx + 16 * k;
        if (d < HD && n < ns) St[d * LN + n] = sacc[i][k];
      }
  }

  __syncthreads();
  float* fb = fin + ((int64_t)b * nh + h) * HD * ns;
  for (int e = tid; e < HD * ns; e += kThreads) {
    const int d = e / ns, n = e - d * ns;
    fb[e] = St[d * LN + n];
  }
}

template <typename T, int HD>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, void* y, void* fin, int B, int S,
           int nh, int ns, int Q, cudaStream_t stream) {
  const size_t smem =
      sizeof(double) * ((size_t)Q + kThreads) +
      sizeof(float) * ((size_t)(HD + 2 * kT) * (ns + 1) + kT * (HD + 1) +
                       kT * (kT + 1) + (size_t)Q);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((unsigned)nh, (unsigned)B);
  ssd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(fin), S, nh, ns, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* x, const void* dt, const void* A,
              const void* Bm, const void* Cm, const void* D, void* y,
              void* fin, int B, int S, int nh, int ns, int Q,
              cudaStream_t s) {
  switch (hd) {
    case 8:
      return launch<T, 8>(x, dt, A, Bm, Cm, D, y, fin, B, S, nh, ns, Q, s);
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, D, y, fin, B, S, nh, ns, Q, s);
    case 32:
      return launch<T, 32>(x, dt, A, Bm, Cm, D, y, fin, B, S, nh, ns, Q, s);
    case 64:
      return launch<T, 64>(x, dt, A, Bm, Cm, D, y, fin, B, S, nh, ns, Q, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of x, Bm, Cm and y: 0 float32, 1 bfloat16; dt, A, D and the final
// state are float32.
extern "C" int ss_ssd_scan(const void* x, const void* dt, const void* A,
                           const void* Bm, const void* Cm, const void* D,
                           void* y, void* fin, int B, int S, int nh, int hd,
                           int ns, int Q, int dtype, void* stream) {
  if (B == 0 || nh == 0) return 0;
  if (Q < 1 || ns < 1 || ns > kMaxNS || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, x, dt, A, Bm, Cm, D, y, fin, B, S, nh, ns, Q,
                            s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, x, dt, A, Bm, Cm, D, y, fin, B, S, nh,
                                    ns, Q, s);
  return (int)cudaErrorInvalidValue;
}
