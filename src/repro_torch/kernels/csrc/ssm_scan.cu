// B6: the diagonal linear recurrence h_t = a_t * h_{t-1} + b_t of the Mamba
// mixer, for sm_90a.
//
// Replaces the Pallas TPU kernel `ssm_scan` of the JAX package
// (src/repro/kernels/ssm_scan.py:44), which always starts from h_0 = 0;
// this one also takes an initial state h0, so the model can carry h from
// one chunk of the sequence to the next.  Plain version: `ssm_scan_ref` in
// kernels/ref.py.
//
// What bounds it on the H100: bytes.  Each element of a and b is read once
// and each element of hs written once (12 bytes per element in f32) for
// two flops, against a ridge of ~20 flop/byte; the roof is 3.35 TB/s.
//
// What the design does about it:
//  * The B * D * N chains are independent.  One thread owns one chain
//    (b, d, n), keeps h in a register and walks t itself: the Pallas
//    kernel's sequential chunk axis (h in VMEM scratch between grid steps)
//    becomes this loop, since blocks on Hopper run in no order.
//  * Consecutive threads own consecutive d * N + n, so each step's load of
//    a_t or b_t by a warp is 32 consecutive elements (128 bytes in f32) and
//    so is its store of hs_t.
//  * Latency: the loads of the next kUnroll steps are issued before the
//    arithmetic of the current kUnroll steps, so 2 * kUnroll loads per
//    thread are in flight while it computes.
//  * Bitwise parity with the plain version: h = __fadd_rn(__fmul_rn(a, h), b),
//    the two roundings of `a_t * h` then `+ b_t`, never one fused FMA
//    (-fmad=false besides).  bf16 inputs are widened exactly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;    // steps loaded ahead per thread

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// grid (ceil(DN / kThreads), B).  a, b, hs: (B, S, D, N) with DN = D * N;
// h0: (B, D, N) f32 or nullptr (zeros).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                const float* __restrict__ h0, float* __restrict__ hs, int S,
                long long DN) {
  const long long dn = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (dn >= DN) return;
  const long long base = (long long)blockIdx.y * S * DN + dn;
  const T* ap = a + base;
  const T* bp = b + base;
  float* hp = hs + base;
  float h = h0 ? h0[(long long)blockIdx.y * DN + dn] : 0.f;

  float a_cur[kUnroll], b_cur[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    a_cur[u] = u < S ? load1(ap + u * DN) : 0.f;
    b_cur[u] = u < S ? load1(bp + u * DN) : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float a_nxt[kUnroll], b_nxt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + kUnroll + u;
      a_nxt[u] = t < S ? load1(ap + t * DN) : 0.f;
      b_nxt[u] = t < S ? load1(bp + t * DN) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        h = __fadd_rn(__fmul_rn(a_cur[u], h), b_cur[u]);
        hp[(t0 + u) * DN] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a_cur[u] = a_nxt[u];
      b_cur[u] = b_nxt[u];
    }
  }
}

}  // namespace

// dtype 0: a and b f32; 1: bf16.  h0 may be null.  Returns cudaError_t.
extern "C" int repro_ssm_scan(int dtype, const void* a, const void* b,
                              const void* h0, void* hs, int B, int S,
                              long long DN, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)((DN + kThreads - 1) / kThreads), (unsigned)B);
  if (dtype == 0) {
    ssm_scan_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)a, (const float*)b, (const float*)h0, (float*)hs, S,
        DN);
  } else if (dtype == 1) {
    ssm_scan_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (const float*)h0,
        (float*)hs, S, DN);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
