// B4: prefill attention (GQA, causal and/or sliding window) for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` of the JAX package
// (src/repro/kernels/flash_attention.py:84).  Plain version:
// `flash_attention_ref` in kernels/ref.py, which it follows, queries
// end-aligned with the keys (query i sits at absolute position
// i + Sk - Sq), not the Pallas kernel's start alignment.
//
// What bounds it on the H100: operations.  4*B*H*D*(kept query-key pairs)
// flops against 2 bytes per flop or less, far above the card's ~20
// flop/byte ridge for f32 CUDA-core math (67 TFLOP/s over 3.35 TB/s).
// The f32 path must stay f32 (no TF32: it would move results past the
// 3e-5 tolerance), so the roof is the CUDA cores' 67 TFLOP/s.
//
// What the design does about it:
//  * One block per (query tile, head, batch).  The block loops over the
//    key tiles itself and keeps the online softmax (m, l, acc) in
//    registers, so nothing but the output is written; K/V tiles are staged
//    in shared memory and read from there by every query row of the tile.
//  * GQA: query head h reads KV head h / (H / Hkv) in place, no copy.
//  * Key tiles wholly in the future (causal) or wholly before the window
//    are never loaded: the loop bounds come from absolute indices.  Query
//    tiles run heaviest first (blockIdx.x reversed) so the causal
//    triangle's long tiles start early.
//  * Register tiling: 128 threads as 16 row groups x 8 column groups; a
//    thread holds a TM x TS tile of scores and a TM x TN tile of the output
//    (TM = BQ/16, TS = BK/8, TN = D/8), so each shared-memory load feeds
//    several FMAs.  Q and K rows are padded by one float (no bank
//    conflicts on the strided reads); row statistics are reduced across
//    the 8 lanes of a row group with shuffles.
//  * f32 FMA throughout (explicit fmaf: the build uses -fmad=false); bf16
//    inputs are widened to f32 when staged and the output rounded once.
// Reads the model's layout (B, S, heads, D) directly; no transpose.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D, int BQ, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
          size_t(BQ) * (BK + 1));
}

template <int D, int BQ, int BK, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
          int Hkv, int causal, int window, float scale) {
  constexpr int TM = BQ / 16;   // query rows per thread
  constexpr int TS = BK / 8;    // key columns per thread
  constexpr int TN = D / 8;     // output columns per thread
  constexpr int DP = D + 1;     // padded row stride of Qs and Ks
  constexpr int BKP = BK + 1;   // padded row stride of Ps
  static_assert(BQ % 16 == 0 && BK % 8 == 0 && D % 8 == 0, "tile shape");

  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x DP, pre-scaled
  float* Ks = Qs + BQ * DP;     // BK x DP
  float* Vs = Ks + BK * DP;     // BK x D
  float* Ps = Vs + BK * D;      // BQ x BKP, probabilities of the tile

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - int(blockIdx.x)) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid >> 3;      // row group 0..15
  const int tx = tid & 7;       // column group 0..7
  const int off = Sk - Sq;      // absolute position of query row i: i + off

  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)Hkv * D;
  const T* qb = q + (long long)b * Sq * q_stride + (long long)h * D;
  const T* kb = k + (long long)b * Sk * kv_stride + (long long)hk * D;
  const T* vb = v + (long long)b * Sk * kv_stride + (long long)hk * D;

  for (int e = tid * 4; e < BQ * D; e += kThreads * 4) {
    const int r = e / D, c = e % D;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < Sq) load4(qb + (q0 + r) * q_stride + c, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) Qs[r * DP + c + i] = x[i] * scale;
  }

  // The key range any row of this tile keeps.
  const int qa_lo = q0 + off;
  const int qa_hi = min(q0 + BQ, Sq) - 1 + off;
  const int k_begin = window ? max(0, qa_lo - window + 1) : 0;
  const int k_end = causal ? min(Sk, qa_hi + 1) : Sk;

  float m[TM], l[TM], acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    for (int e = tid * 4; e < BK * D; e += kThreads * 4) {
      const int r = e / D, c = e % D;
      float xk[4] = {0.f, 0.f, 0.f, 0.f}, xv[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + r < Sk) {
        load4(kb + (k0 + r) * kv_stride + c, xk);
        load4(vb + (k0 + r) * kv_stride + c, xv);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        Ks[r * DP + c + i] = xk[i];
        Vs[r * D + c + i] = xv[i];
      }
    }
    __syncthreads();

    float s[TM][TS];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TS; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[TM], kv[TS];
#pragma unroll
      for (int i = 0; i < TM; ++i) qv[i] = Qs[(ty * TM + i) * DP + d];
#pragma unroll
      for (int j = 0; j < TS; ++j) kv[j] = Ks[(tx + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qa = q0 + ty * TM + i + off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        const int ka = k0 + tx + 8 * j;
        const bool ok = ka < Sk && (!causal || ka <= qa) &&
                        (!window || ka > qa - window);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      // a row with no key kept so far keeps m = -inf; exp(-inf) = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        const float p = expf(s[i][j] - m_use);
        Ps[(ty * TM + i) * BKP + tx + 8 * j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[TM], vv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) pv[i] = Ps[(ty * TM + i) * BKP + j];
#pragma unroll
      for (int c = 0; c < TN; ++c) vv[c] = Vs[j * D + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* ob = o + (long long)b * Sq * q_stride + (long long)h * D;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty * TM + i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < TN; ++c)
      store1(ob + r * q_stride + tx + 8 * c, acc[i][c] / denom);
  }
}

template <int D, int BQ, int BK, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int Hkv, int causal,
                   int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BQ, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D, BQ, BK, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<D, BQ, BK, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, Hkv, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int Sq, int Sk, int H, int Hkv,
                     int causal, int window, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<64, 64, 64, T>(q, k, v, o, B, Sq, Sk, H, Hkv, causal,
                                   window, scale, stream);
    case 128:
      return launch<128, 64, 64, T>(q, k, v, o, B, Sq, Sk, H, Hkv, causal,
                                    window, scale, stream);
    case 256:
      return launch<256, 32, 32, T>(q, k, v, o, B, Sq, Sk, H, Hkv, causal,
                                    window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, o: (B, Sq, H, D); k, v: (B, Sk,
// Hkv, D); all contiguous.  Returns the launch's cudaError_t.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* o, int B, int Sq,
                                     int Sk, int H, int Hkv, int D, int causal,
                                     int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, o, B, Sq, Sk, H, Hkv, causal, window,
                           scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, H, Hkv, causal,
                                   window, scale, s);
  return cudaErrorInvalidValue;
}
