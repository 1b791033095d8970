// B5: decode attention, one query token per head against a KV cache with
// a per-row valid length, for sm_90a.
//
// Replaces the Pallas TPU kernel `decode_attention` of the JAX package
// (src/repro/kernels/decode_attention.py:66).  Plain version:
// `decode_attention_ref` in kernels/ref.py.
//
// What bounds it on the H100: bytes.  Each valid cache position is read
// once (K and V: 2 * Hkv * D elements per position and row) for about one
// flop per byte, against a ridge of ~20 flop/byte; the roof is 3.35 TB/s.
//
// What the design does about it:
//  * The cache is read in the model's layout (B, L, Hkv, D) directly, and
//    nothing at or past length[b] is read.
//  * One block serves a KV head's whole query-head group (G = H / Hkv),
//    so each cache position is read from memory once, not G times.
//  * Split-L (flash-decoding): one (batch, KV head) pair is far too little
//    parallelism for 132 SMs (SmolLM at batch 8 has 40 such pairs), so the
//    cache is cut into n_split ranges of `split_len` positions, one block
//    each; the wrapper picks split_len so that about four blocks per SM
//    are in flight.  Each block writes its partial (m, l, acc) to a scratch
//    buffer and a second, tiny kernel merges the splits per (row, head).
//    With n_split == 1 the first kernel writes the output itself.
//  * Inside a block, 64-position chunks of K and V are staged in shared
//    memory with 16-byte coalesced loads; scores (G x 64), the per-head
//    online softmax and the accumulator (G x D, in shared memory) are
//    computed from there, so G is a runtime value and no register array
//    depends on it.
//  * f32 math throughout (explicit fmaf); bf16 caches are widened when
//    staged and the output rounded once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;     // cache positions staged per iteration
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
size_t smem_bytes(int G) {
  return sizeof(float) * (size_t(kChunk) * (D + 1) + size_t(kChunk) * D +
                          2 * size_t(G) * D + size_t(G) * kChunk +
                          3 * size_t(G));
}

// grid (n_split, Hkv, B).  q, out: (B, H, D); k, v: (B, L, Hkv, D).
// part_acc: (B, H, n_split, D) and part_ml: (B, H, n_split, 2) f32 when
// n_split > 1 (the split's unnormalised acc, and its m and l).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
decode_split(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ length,
             T* __restrict__ out, float* __restrict__ part_acc,
             float* __restrict__ part_ml, int L, int H, int Hkv,
             int split_len, float scale) {
  const int G = H / Hkv;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int DP = D + 1;

  extern __shared__ float smem[];
  float* Ks = smem;                 // kChunk x DP
  float* Vs = Ks + kChunk * DP;     // kChunk x D
  float* Qs = Vs + kChunk * D;      // G x D, pre-scaled
  float* Acc = Qs + G * D;          // G x D
  float* Ss = Acc + G * D;          // G x kChunk
  float* Ms = Ss + G * kChunk;      // G running max
  float* Ls = Ms + G;               // G running sum
  float* Cs = Ls + G;               // G rescale of the chunk

  const int len = min(length[b], L);
  const int start = split * split_len;
  const int stop = min(start + split_len, len);

  const T* qb = q + ((long long)b * H + (long long)hk * G) * D;
  for (int e = tid; e < G * D; e += kThreads) {
    Qs[e] = load1(qb + e) * scale;
    Acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = -INFINITY;
    Ls[g] = 0.f;
  }

  const long long row = (long long)Hkv * D;
  const T* kb = k + (long long)b * L * row + (long long)hk * D;
  const T* vb = v + (long long)b * L * row + (long long)hk * D;

  for (int p0 = start; p0 < stop; p0 += kChunk) {
    const int n = min(kChunk, stop - p0);
    __syncthreads();  // Qs/Acc ready; the previous chunk's reads are done
    for (int e = tid * 4; e < kChunk * D; e += kThreads * 4) {
      const int r = e / D, c = e % D;
      float xk[4] = {0.f, 0.f, 0.f, 0.f}, xv[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < n) {
        load4(kb + (p0 + r) * row + c, xk);
        load4(vb + (p0 + r) * row + c, xv);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        Ks[r * DP + c + i] = xk[i];
        Vs[r * D + c + i] = xv[i];
      }
    }
    __syncthreads();

    for (int it = tid; it < G * kChunk; it += kThreads) {
      const int g = it / kChunk, p = it % kChunk;
      float s = -INFINITY;
      if (p < n) {
        s = 0.f;
        const float* qg = Qs + g * D;
        const float* kp = Ks + p * DP;
#pragma unroll 16
        for (int d = 0; d < D; ++d) s = fmaf(qg[d], kp[d], s);
      }
      Ss[it] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* sg = Ss + g * kChunk;
      float mx = -INFINITY;
      for (int p = lane; p < kChunk; p += 32) mx = fmaxf(mx, sg[p]);
      mx = warp_max(mx);                 // finite: the chunk has n >= 1
      const float m_new = fmaxf(Ms[g], mx);
      float sum = 0.f;
      for (int p = lane; p < kChunk; p += 32) {
        const float e = expf(sg[p] - m_new);
        sg[p] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(Ms[g] - m_new);
        Ls[g] = Ls[g] * corr + sum;
        Ms[g] = m_new;
        Cs[g] = corr;
      }
    }
    __syncthreads();

    for (int it = tid; it < G * D; it += kThreads) {
      const int g = it / D, d = it % D;
      const float* sg = Ss + g * kChunk;
      float a = Acc[it] * Cs[g];
      for (int p = 0; p < n; ++p) a = fmaf(sg[p], Vs[p * D + d], a);
      Acc[it] = a;
    }
  }
  __syncthreads();

  const long long bh0 = (long long)b * H + (long long)hk * G;
  if (n_split == 1) {
    for (int it = tid; it < G * D; it += kThreads) {
      const int g = it / D;
      store1(out + bh0 * D + it, Acc[it] / fmaxf(Ls[g], 1e-30f));
    }
    return;
  }
  for (int it = tid; it < G * D; it += kThreads) {
    const int g = it / D, d = it % D;
    part_acc[((bh0 + g) * n_split + split) * D + d] = Acc[it];
  }
  for (int g = tid; g < G; g += kThreads) {
    part_ml[((bh0 + g) * n_split + split) * 2] = Ms[g];
    part_ml[((bh0 + g) * n_split + split) * 2 + 1] = Ls[g];
  }
}

// grid (B * H), block D: merge the n_split partials of one (row, head).
// A split with no position has m = -inf, l = 0 and weighs 0.
template <typename T>
__global__ void decode_combine(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml,
                               T* __restrict__ out, int n_split, int D) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + bh * n_split * 2;
  float M = -INFINITY;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, ml[2 * s]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(ml[2 * s] - M);
    l = fmaf(ml[2 * s + 1], w, l);
    a = fmaf(part_acc[(bh * n_split + s) * D + d], w, a);
  }
  store1(out + bh * D + d, a / fmaxf(l, 1e-30f));
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* length, void* out, float* part_acc,
                   float* part_ml, int B, int L, int H, int Hkv, int split_len,
                   float scale, cudaStream_t stream, int* launched) {
  const int G = H / Hkv;
  const size_t smem = smem_bytes<D>(G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const int n_split = (L + split_len - 1) / split_len;
  decode_split<D, T><<<dim3(n_split, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, static_cast<T*>(out), part_acc,
      part_ml, L, H, Hkv, split_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  *launched = 1;
  if (n_split == 1) return err;
  decode_combine<T><<<B * H, D, 0, stream>>>(part_acc, part_ml,
                                             static_cast<T*>(out), n_split, D);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 2;
  return err;
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const int* length, void* out, float* part_acc,
                     float* part_ml, int B, int L, int H, int Hkv,
                     int split_len, float scale, cudaStream_t stream,
                     int* launched) {
  switch (D) {
    case 64:
      return launch<64, T>(q, k, v, length, out, part_acc, part_ml, B, L, H,
                           Hkv, split_len, scale, stream, launched);
    case 128:
      return launch<128, T>(q, k, v, length, out, part_acc, part_ml, B, L, H,
                            Hkv, split_len, scale, stream, launched);
    case 256:
      return launch<256, T>(q, k, v, length, out, part_acc, part_ml, B, L, H,
                            Hkv, split_len, scale, stream, launched);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, out: (B, H, D); k, v: (B, L, Hkv,
// D); length: (B,) int32 with 1 <= length[b] (values past L read as L).
// The cache is cut into n = ceil(L / split_len) splits of split_len
// positions; part_acc: (B, H, n, D) f32 and part_ml: (B, H, n, 2) f32 are
// scratch for n > 1 (unused when n == 1).  Writes the number of kernels it
// launched (1, or 2 with the combine pass) to *launched and returns the
// launches' cudaError_t.
extern "C" int repro_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, const int* length,
                                      void* out, float* part_acc,
                                      float* part_ml, int B, int L, int H,
                                      int Hkv, int D, int split_len,
                                      float scale, void* stream,
                                      int* launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (split_len < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, length, out, part_acc, part_ml, B, L,
                           H, Hkv, split_len, scale, s, launched);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, length, out, part_acc,
                                   part_ml, B, L, H, Hkv, split_len, scale, s,
                                   launched);
  return cudaErrorInvalidValue;
}
