// B4's gradient: the backward of prefill attention (GQA, causal and/or
// sliding window, or no mask) in float32 or bfloat16, for sm_90a.
//
// Replaces no TPU kernel.  The JAX package trains attention in XLA
// (src/repro/models/attention.py:163-180) and differentiates it with
// jax.grad; the port runs every training attention call through B4
// (csrc/flash_attention.cu), whose output carries no autograd graph, so
// the gradient the reference takes by autodiff needs a kernel of its own.
// Plain version: `flash_attention_bwd_ref` in kernels/ref.py, which this
// follows step for step:
//   P = exp(scale q k^T - lse)      (lse from the forward, per query row)
//   delta = rowsum(dO o O)
//   dP = dO V^T,  dS = P o (dP - delta)
//   dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO
// with dK and dV summed over the query heads of each KV head's group.
// Masks as the plain version's: queries end-aligned with the keys (query
// i sits at absolute position i + Sk - Sq), `causal` keeps keys <= the
// query's position, `window` > 0 keeps keys > position - window.
//
// What bounds it on the H100: operations, five products of 2 D flops per
// kept query-key pair and head (S, dP, dV, dK, dQ), against 4 bytes (f32)
// or 2 (bf16) per element read once.  This kernel runs them as f32 FMAs on
// the CUDA cores (67 TFLOP/s), with sums in f32 in a fixed order: no
// atomics, so the gradient is the same bit for bit from run to run.
//
// The element type T of q, k, v, O, dO and of dQ, dK, dV is a template
// argument: float (`flash_bwd_dq<64, float>`) or __nv_bfloat16 (the bf16
// compute path, Hymba's attention).  bf16 elements are widened exactly as
// they land in shared memory; everything after that (P, dP, dS, the three
// products, delta) is the f32 kernel's arithmetic, and dQ, dK and dV are
// rounded to bf16 once, as they are written.  The lse is f32 either way
// (from B4's forward at its flush; the bf16 forward writes it from its
// base-2 softmax).
//
// Two launches a call, on one stream:
//  * `flash_bwd_dq<D>`, one block per (query tile, head, batch), heaviest
//    causal tile first: computes delta for its rows (written out for the
//    second launch), then loops over the key tiles the mask keeps: S and dP
//    in registers, P and dS, dS through shared memory, dQ += dS K in
//    registers; dQ written once.
//  * `flash_bwd_dkdv<D>`, one block per (key tile, KV head, batch): loops
//    over the group's query heads and, for each, the query tiles the mask
//    keeps: S^T and dP^T in registers, P^T and dS^T through shared memory,
//    dV += P^T dO and dK += dS^T Q in registers; dK and dV written once.
// Tiles of 64 query rows by 64 keys, 256 threads as a 16 x 16 grid, each
// thread a 4 x 4 block of every 64 x 64 product: rows ty + 16 i of the
// tile, and columns tx + 16 j of S-shaped products (conflict-free
// shared reads of whole rows as float4 along D) or tx * 4 + j of the
// (rows, D) accumulators (float4 reads of contiguous columns).  Shared
// rows are padded to D + 4 floats.  Tiles are copied into shared memory
// by plain float4 loads (rows past the end as zeros).  Q is scaled by
// 1/sqrt(D) in f32 as it lands, as the forward does, so dK needs no
// further scale.  Head dim 64 only.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;          // query rows and keys per tile
constexpr int kThreads = 256;   // a 16 x 16 grid of threads

template <int D>
struct BwdTile {
  static constexpr int P = D + 4;                    // padded row, floats
  static constexpr size_t kFloats = size_t(kB) * P;  // one tile buffer
};

// Four consecutive elements (16-byte aligned in f32, 8-byte in bf16) as
// f32, and four f32 values stored as four elements (rounded once in bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  // a bf16 is the top 16 bits of an f32
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                 *reinterpret_cast<uint32_t*>(&hi));
}

// Rows r0 .. r0 + 63 of a row-major matrix of T (row r at src + r *
// stride) into dst (64 x P floats), times `mul`; rows >= n are zeros.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int r0, int n,
                                          float mul) {
  constexpr int P = BwdTile<D>::P;
  constexpr int CH = D / 4;  // 4-element chunks per row
  for (int e = threadIdx.x; e < kB * CH; e += kThreads) {
    const int r = e / CH, c = (e % CH) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = load4(src + (long long)(r0 + r) * stride + c);
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
    *reinterpret_cast<float4*>(dst + r * P + c) = x;
  }
}

// Whether query position qa keeps key kk.
__device__ __forceinline__ bool kept(int qa, int kk, int Sk, int causal,
                                     int window) {
  return kk < Sk && (!causal || kk <= qa) && (!window || kk > qa - window);
}

// c[i][j] += a_i . b_j over D: a_i = row ra + 16 i of A, b_j = row
// rb + 16 j of B (both 64 x P in shared memory).
template <int D>
__device__ __forceinline__ void rows_dot(float (&c)[4][4], const float* A,
                                         const float* B, int ra, int rb) {
  constexpr int P = BwdTile<D>::P;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (ra + 16 * i) * P + d);
      b[i] = *reinterpret_cast<const float4*>(B + (rb + 16 * i) * P + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[i][j] = fmaf(a[i].x, b[j].x, c[i][j]);
        c[i][j] = fmaf(a[i].y, b[j].y, c[i][j]);
        c[i][j] = fmaf(a[i].z, b[j].z, c[i][j]);
        c[i][j] = fmaf(a[i].w, b[j].w, c[i][j]);
      }
  }
}

// c[i][j] += sum_r X[ra + 16 i][r] Y[r][cb + j] over the 64 rows r of Y:
// X is a 64 x 64 tile (P-padded) indexed [row][r], Y is 64 x P indexed
// [r][column].
template <int D>
__device__ __forceinline__ void tile_mul(float (&c)[4][4], const float* X,
                                         const float* Y, int ra, int cb) {
  constexpr int P = BwdTile<D>::P;
#pragma unroll 2
  for (int r = 0; r < kB; r += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = *reinterpret_cast<const float4*>(X + (ra + 16 * i) * P + r);
      y[i] = *reinterpret_cast<const float4*>(Y + (r + i) * P + cb);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xs[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        c[i][0] = fmaf(xs[rr], y[rr].x, c[i][0]);
        c[i][1] = fmaf(xs[rr], y[rr].y, c[i][1]);
        c[i][2] = fmaf(xs[rr], y[rr].z, c[i][2]);
        c[i][3] = fmaf(xs[rr], y[rr].w, c[i][3]);
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&c)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
}

// Shared memory: Q (scaled), dO, K (first O, for delta), V, dS.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const float* __restrict__ lse, const T* __restrict__ dout,
             T* __restrict__ dq, float* __restrict__ delta, int Sq, int Sk,
             int H, int Hkv, int causal, int window, float scale) {
  using Tile = BwdTile<D>;
  constexpr int P = Tile::P;
  extern __shared__ __align__(16) float smem_bwd[];
  float* Qs = smem_bwd;
  float* dOs = Qs + Tile::kFloats;
  float* Ks = dOs + Tile::kFloats;
  float* Vs = Ks + Tile::kFloats;
  float* dSs = Vs + Tile::kFloats;
  __shared__ float lse_s[kB], delta_s[kB];

  const int n_qt = (Sq + kB - 1) / kB;
  const int q0 = (n_qt - 1 - int(blockIdx.x)) * kB;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int off = Sk - Sq;  // query row i sits at i + off
  const long long qs = (long long)H * D, ks = (long long)Hkv * D;
  const long long qbase = (long long)b * Sq * qs + (long long)h * D;
  const long long kbase = (long long)b * Sk * ks + (long long)hk * D;
  const long long rbase = ((long long)b * H + h) * Sq;  // lse, delta rows

  load_tile<D>(Qs, q + qbase, qs, q0, Sq, scale);
  load_tile<D>(dOs, dout + qbase, qs, q0, Sq, 1.f);
  load_tile<D>(Ks, o + qbase, qs, q0, Sq, 1.f);
  __syncthreads();
  {
    // delta = rowsum(dO o O): four threads a row, D / 4 columns each, then
    // two shuffles (a fixed order)
    const int r = tid >> 2, c0 = (tid & 3) * (D / 4);
    float s = 0.f;
#pragma unroll 4
    for (int c = 0; c < D / 4; ++c)
      s = fmaf(dOs[r * P + c0 + c], Ks[r * P + c0 + c], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if ((tid & 3) == 0) {
      const bool in = q0 + r < Sq;
      delta_s[r] = s;
      lse_s[r] = in ? lse[rbase + q0 + r] : 0.f;
      if (in) delta[rbase + q0 + r] = s;
    }
  }
  __syncthreads();  // O's space becomes K's
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = lse_s[ty + 16 * i];
    delta_r[i] = delta_s[ty + 16 * i];
  }

  // the key range any row of this tile keeps, in whole tiles
  const int qa_lo = q0 + off;
  const int qa_hi = min(q0 + kB, Sq) - 1 + off;
  const int k_begin = window ? max(0, qa_lo - window + 1) : 0;
  const int k_end = causal ? min(Sk, qa_hi + 1) : Sk;

  float acc[4][4];  // dQ / scale: rows ty + 16 i, columns tx * 4 + j
  zero<D>(acc);
  for (int k0 = (k_begin / kB) * kB; k0 < k_end; k0 += kB) {
    load_tile<D>(Ks, k + kbase, ks, k0, Sk, 1.f);
    load_tile<D>(Vs, v + kbase, ks, k0, Sk, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero<D>(s);
    zero<D>(dp);
    rows_dot<D>(s, Qs, Ks, ty, tx);    // scale q . k
    rows_dot<D>(dp, dOs, Vs, ty, tx);  // dO . v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k0 + tx + 16 * j;
        float p = 0.f;
        if (qr < Sq && kept(qr + off, kk, Sk, causal, window))
          p = expf(s[i][j] - lse_r[i]);
        dSs[(ty + 16 * i) * P + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    tile_mul<D>(acc, dSs, Ks, ty, tx * 4);  // dS K
    __syncthreads();  // the next tile overwrites K, V and dS
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < Sq)
      store4(dq + qbase + r * qs + tx * 4, scale * acc[i][0],
             scale * acc[i][1], scale * acc[i][2], scale * acc[i][3]);
  }
}

// Shared memory: K, V, Q (scaled), dO, P^T, dS^T.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ lse,
               const float* __restrict__ delta, const T* __restrict__ dout,
               T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
               int Hkv, int causal, int window, float scale) {
  using Tile = BwdTile<D>;
  constexpr int P = Tile::P;
  extern __shared__ __align__(16) float smem_bwd[];
  float* Ks = smem_bwd;
  float* Vs = Ks + Tile::kFloats;
  float* Qs = Vs + Tile::kFloats;
  float* dOs = Qs + Tile::kFloats;
  float* Ps = dOs + Tile::kFloats;
  float* dSs = Ps + Tile::kFloats;
  __shared__ float lse_s[kB], delta_s[kB];

  const int k0 = blockIdx.x * kB;  // causal: the heaviest tile first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int off = Sk - Sq;
  const long long qs = (long long)H * D, ks = (long long)Hkv * D;
  const long long kbase = (long long)b * Sk * ks + (long long)hk * D;

  load_tile<D>(Ks, k + kbase, ks, k0, Sk, 1.f);
  load_tile<D>(Vs, v + kbase, ks, k0, Sk, 1.f);

  // the query rows any key of this tile is kept by
  const int q_begin = causal ? max(0, k0 - off) : 0;
  const int q_end = window ? min(Sq, k0 + kB - 1 + window - off) : Sq;

  float dk_acc[4][4], dv_acc[4][4];  // rows ty + 16 i, columns tx * 4 + j
  zero<D>(dk_acc);
  zero<D>(dv_acc);
  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const long long qbase = (long long)b * Sq * qs + (long long)h * D;
    const long long rbase = ((long long)b * H + h) * Sq;
    for (int q0 = (q_begin / kB) * kB; q0 < q_end; q0 += kB) {
      __syncthreads();  // the previous tile's Q, dO, P and dS are read
      load_tile<D>(Qs, q + qbase, qs, q0, Sq, scale);
      load_tile<D>(dOs, dout + qbase, qs, q0, Sq, 1.f);
      if (tid < kB) {
        const bool in = q0 + tid < Sq;
        lse_s[tid] = in ? lse[rbase + q0 + tid] : 0.f;
        delta_s[tid] = in ? delta[rbase + q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      zero<D>(s);
      zero<D>(dp);
      rows_dot<D>(s, Ks, Qs, ty, tx);    // S^T: keys ty + 16 i, queries tx + 16 j
      rows_dot<D>(dp, Vs, dOs, ty, tx);  // dP^T
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const int qr = q0 + qc;
        const float l = lse_s[qc], dl = delta_s[qc];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = k0 + ty + 16 * i;
          float p = 0.f;
          if (qr < Sq && kept(qr + off, kk, Sk, causal, window))
            p = expf(s[i][j] - l);
          Ps[(ty + 16 * i) * P + qc] = p;
          dSs[(ty + 16 * i) * P + qc] = p * (dp[i][j] - dl);
        }
      }
      __syncthreads();
      tile_mul<D>(dv_acc, Ps, dOs, ty, tx * 4);  // P^T dO
      tile_mul<D>(dk_acc, dSs, Qs, ty, tx * 4);  // dS^T (scale Q)
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r < Sk) {
      const long long e = kbase + r * ks + tx * 4;
      store4(dk + e, dk_acc[i][0], dk_acc[i][1], dk_acc[i][2], dk_acc[i][3]);
      store4(dv + e, dv_acc[i][0], dv_acc[i][1], dv_acc[i][2], dv_acc[i][3]);
    }
  }
}

template <int D, typename T>
cudaError_t launch_bwd(const void* q_, const void* k_, const void* v_,
                       const void* o_, const float* lse, const void* dout_,
                       void* dq_, void* dk_, void* dv_, float* delta, int B,
                       int Sq, int Sk, int H, int Hkv, int causal, int window,
                       float scale, cudaStream_t stream) {
  const T *q = static_cast<const T*>(q_), *k = static_cast<const T*>(k_),
          *v = static_cast<const T*>(v_), *o = static_cast<const T*>(o_),
          *dout = static_cast<const T*>(dout_);
  T *dq = static_cast<T*>(dq_), *dk = static_cast<T*>(dk_),
    *dv = static_cast<T*>(dv_);
  const int dq_smem = int(5 * BwdTile<D>::kFloats * sizeof(float));
  const int kv_smem = int(6 * BwdTile<D>::kFloats * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<D, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq<D, T><<<dim3((Sq + kB - 1) / kB, H, B), kThreads, dq_smem,
                       stream>>>(q, k, v, o, lse, dout, dq, delta, Sq, Sk, H,
                                 Hkv, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<D, T><<<dim3((Sk + kB - 1) / kB, Hkv, B), kThreads,
                         kv_smem, stream>>>(q, k, v, lse, delta, dout, dk, dv,
                                            Sq, Sk, H, Hkv, causal, window,
                                            scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the type of q, k, v, o, dout and of
// dq, dk, dv.  q, o, dout, dq: (B, Sq, H, D); k, v, dk, dv: (B, Sk, Hkv,
// D); lse and delta (scratch, written here): (B, H, Sq) f32; all
// contiguous.  Two launches (dq, then dk and dv).  Returns the first
// failing launch's cudaError_t.
extern "C" int repro_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int B, int Sq, int Sk, int H, int Hkv, int D, int causal,
    int window, float scale, void* stream) {
  if (D != 64) return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<64, float>(q, k, v, o, l, dout, dq, dk, dv, dl, B, Sq,
                                 Sk, H, Hkv, causal, window, scale, s);
  if (dtype == 1)
    return launch_bwd<64, __nv_bfloat16>(q, k, v, o, l, dout, dq, dk, dv, dl,
                                         B, Sq, Sk, H, Hkv, causal, window,
                                         scale, s);
  return cudaErrorInvalidValue;
}
