// Eq. (20) server-consensus kernels for Hopper (sm_90a):
//
//     z' = z - alpha_z * (phi_mean + psi * sum_i s_i * sign(z - w_i) / n)
//
// They replace the three Pallas TPU kernels of the JAX package's
// kernels/sign_agg.py:
//   B1 repro_sign_agg        <- sign_agg               (_kernel)
//   B2 repro_sign_agg_weighted <- sign_agg_weighted    (_weighted_kernel)
//   B3 repro_sign_agg_int8   <- sign_agg_weighted_int8 (_int8_kernel)
//
// Bound on the H100: bytes.  Each kernel reads the (C, D) message matrix
// once plus z and phi_mean, and writes z'; a few flops per element of W
// are far below the card's compute rate.  Design: one thread per column
// d; it walks the C rows in order, so a warp's loads of row i are 32
// neighbouring addresses (coalesced), and the sum is the strict row-order
// left-fold of the plain versions (kernels/ref.py).  Every operation uses
// an explicit round-to-nearest intrinsic (no FMA contraction), so the
// result equals the plain fold bit for bit.  Nothing is staged in shared
// memory: each element of W is used once.
//
// Plain C interface for ctypes: each entry returns the cudaError_t of the
// launch (0 = success) and takes the stream as a pointer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// jnp.sign: +-1 off zero; the operand itself at +-0 and NaN (NaN stays NaN)
__device__ __forceinline__ float jsign(float d) {
  return d > 0.f ? 1.f : (d < 0.f ? -1.f : d);
}

// z - alpha_z * (phi + psi * sum / n), one rounding per operation
__device__ __forceinline__ float epilogue(float zf, float phif, float sum,
                                          float n, float psi, float alpha_z) {
  const float dz = __fadd_rn(phif, __fmul_rn(psi, __fdiv_rn(sum, n)));
  return __fsub_rn(zf, __fmul_rn(alpha_z, dz));
}

template <typename T>
__global__ void sign_agg_kernel(const T* __restrict__ z,
                                const T* __restrict__ W,
                                const T* __restrict__ phi,
                                T* __restrict__ out, int C, int64_t D,
                                float psi, float alpha_z) {
  const int64_t d = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const float zf = to_f32(z[d]);
  float acc = 0.f;
  for (int i = 0; i < C; ++i) {
    acc = __fadd_rn(acc, jsign(__fsub_rn(zf, to_f32(W[(int64_t)i * D + d]))));
  }
  out[d] = from_f32<T>(epilogue(zf, to_f32(phi[d]), acc, (float)C, psi,
                                alpha_z));
}

template <typename T>
__global__ void sign_agg_weighted_kernel(const T* __restrict__ z,
                                         const T* __restrict__ W,
                                         const T* __restrict__ phi,
                                         const float* __restrict__ weights,
                                         T* __restrict__ out, int C,
                                         int64_t D, float n, float psi,
                                         float alpha_z) {
  const int64_t d = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const float zf = to_f32(z[d]);
  float acc = 0.f;
  for (int i = 0; i < C; ++i) {
    const float s = jsign(__fsub_rn(zf, to_f32(W[(int64_t)i * D + d])));
    acc = __fadd_rn(acc, __fmul_rn(weights[i], s));
  }
  out[d] = from_f32<T>(epilogue(zf, to_f32(phi[d]), acc, n, psi, alpha_z));
}

// scale == nullptr: the unweighted message, an exact int32 sum
template <typename T>
__global__ void sign_agg_int8_kernel(const T* __restrict__ z,
                                     const int8_t* __restrict__ payload,
                                     const T* __restrict__ phi,
                                     const float* __restrict__ scale,
                                     T* __restrict__ out, int C, int64_t D,
                                     float n, float psi, float alpha_z) {
  const int64_t d = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float sum;
  if (scale == nullptr) {
    int acc = 0;
    for (int i = 0; i < C; ++i) acc += (int)payload[(int64_t)i * D + d];
    sum = (float)acc;
  } else {
    float acc = 0.f;
    for (int i = 0; i < C; ++i) {
      acc = __fadd_rn(acc, __fmul_rn(scale[i],
                                     (float)payload[(int64_t)i * D + d]));
    }
    sum = acc;
  }
  out[d] = from_f32<T>(epilogue(to_f32(z[d]), to_f32(phi[d]), sum, n, psi,
                                alpha_z));
}

inline unsigned blocks_for(int64_t D) {
  return (unsigned)((D + kThreads - 1) / kThreads);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (z, W, phi_mean and out share it)
extern "C" int repro_sign_agg(int dtype, const void* z, const void* W,
                              const void* phi, void* out, int C,
                              long long D, float psi, float alpha_z,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    sign_agg_kernel<float><<<blocks_for(D), kThreads, 0, s>>>(
        (const float*)z, (const float*)W, (const float*)phi, (float*)out, C,
        D, psi, alpha_z);
  } else if (dtype == 1) {
    sign_agg_kernel<__nv_bfloat16><<<blocks_for(D), kThreads, 0, s>>>(
        (const __nv_bfloat16*)z, (const __nv_bfloat16*)W,
        (const __nv_bfloat16*)phi, (__nv_bfloat16*)out, C, D, psi, alpha_z);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_sign_agg_weighted(int dtype, const void* z,
                                       const void* W, const void* phi,
                                       const void* weights, void* out, int C,
                                       long long D, int n, float psi,
                                       float alpha_z, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    sign_agg_weighted_kernel<float><<<blocks_for(D), kThreads, 0, s>>>(
        (const float*)z, (const float*)W, (const float*)phi,
        (const float*)weights, (float*)out, C, D, (float)n, psi, alpha_z);
  } else if (dtype == 1) {
    sign_agg_weighted_kernel<__nv_bfloat16>
        <<<blocks_for(D), kThreads, 0, s>>>(
            (const __nv_bfloat16*)z, (const __nv_bfloat16*)W,
            (const __nv_bfloat16*)phi, (const float*)weights,
            (__nv_bfloat16*)out, C, D, (float)n, psi, alpha_z);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_sign_agg_int8(int dtype, const void* z,
                                   const void* payload, const void* phi,
                                   const void* scale, void* out, int C,
                                   long long D, int n, float psi,
                                   float alpha_z, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    sign_agg_int8_kernel<float><<<blocks_for(D), kThreads, 0, s>>>(
        (const float*)z, (const int8_t*)payload, (const float*)phi,
        (const float*)scale, (float*)out, C, D, (float)n, psi, alpha_z);
  } else if (dtype == 1) {
    sign_agg_int8_kernel<__nv_bfloat16><<<blocks_for(D), kThreads, 0, s>>>(
        (const __nv_bfloat16*)z, (const int8_t*)payload,
        (const __nv_bfloat16*)phi, (const float*)scale, (__nv_bfloat16*)out,
        C, D, (float)n, psi, alpha_z);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
