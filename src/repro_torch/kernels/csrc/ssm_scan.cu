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
//
// B6's backward, `ssm_scan_bwd_kernel`, replaces no TPU kernel: the JAX
// package differentiates its scan (src/repro/models/ssm.py:93,
// `_assoc_scan`) with jax.grad, and the port trains Hymba's Mamba heads
// through this kernel, whose output carries no autograd graph.  Plain
// version: `ssm_scan_bwd_ref` in kernels/ref.py.  It is the reverse
// recurrence, one thread per chain walking t downwards as the forward
// walks it upwards (1-indexed, h_0 the initial state):
//   g_S = dhs_S,  g_t = dhs_t + a_{t+1} g_{t+1}
//   da_t = g_t h_{t-1},  db_t = g_t,  dh0 = a_1 g_1
// from a, the forward's hs (for h_{t-1}), h0 and dhs, which it takes as
// given (the model's chunk loop feeds hs_S into the next chunk as h0, so
// autograd has already added that gradient into dhs_S).  Bytes bound it:
// a, hs and dhs read once, da and db written once (20 bytes per element
// in f32), two multiplies and an add per element.  The same layout and
// coalescing as the forward, with the next 16 steps' loads in flight (one
// thread per chain leaves few warps at B = 1); each product and sum
// rounded on its own, so it equals the plain version bit for bit.  da and
// db are in a's dtype (rounded once from f32), dh0 in f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;    // steps loaded ahead per thread
constexpr int kUnrollBwd = 16;  // the backward's (three loads a step)

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
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

// grid (ceil(DN / kThreads), B).  a, da, db: (B, S, D, N) of T; hs, dhs:
// (B, S, D, N) f32; h0: (B, D, N) f32 or nullptr (zeros); dh0: (B, D, N)
// f32.  Step u = 0 .. S - 1 of the walk is time t = S - 1 - u (0-indexed),
// which needs a_{t+1} (none at u = 0), dhs_t, and h_{t-1}: hs_{t-1}, or the
// initial state at t = 0.  Every load is unconditional, from an index
// clamped into [0, S) (a value past either end is loaded and not used), so
// the next kUnrollBwd steps' loads are all in flight before the current
// steps' arithmetic: written with bounds-checked loads, the kernel ran at
// 23 % of its bound (PERF.md §6).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const T* __restrict__ a, const float* __restrict__ hs,
                    const float* __restrict__ h0,
                    const float* __restrict__ dhs, T* __restrict__ da,
                    T* __restrict__ db, float* __restrict__ dh0, int S,
                    long long DN) {
  const long long dn = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (dn >= DN) return;
  const long long base = (long long)blockIdx.y * S * DN + dn;
  const T* ap = a + base;
  const float* hp = hs + base;
  const float* gp = dhs + base;
  T* dap = da + base;
  T* dbp = db + base;
  const float h_init = h0 ? h0[(long long)blockIdx.y * DN + dn] : 0.f;

  float a_cur[kUnrollBwd], d_cur[kUnrollBwd], h_cur[kUnrollBwd];
#pragma unroll
  for (int u = 0; u < kUnrollBwd; ++u) {
    const int t = max(S - 1 - u, 0);
    a_cur[u] = load1(ap + (long long)min(t + 1, S - 1) * DN);
    d_cur[u] = __ldg(gp + (long long)t * DN);
    h_cur[u] = __ldg(hp + (long long)max(t - 1, 0) * DN);
  }
  float g = 0.f;
  for (int u0 = 0; u0 < S; u0 += kUnrollBwd) {
    float a_nxt[kUnrollBwd], d_nxt[kUnrollBwd], h_nxt[kUnrollBwd];
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      const int t = max(S - 1 - (u0 + kUnrollBwd + u), 0);
      a_nxt[u] = load1(ap + (long long)min(t + 1, S - 1) * DN);
      d_nxt[u] = __ldg(gp + (long long)t * DN);
      h_nxt[u] = __ldg(hp + (long long)max(t - 1, 0) * DN);
    }
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      const int t = S - 1 - (u0 + u);
      if (t >= 0) {
        g = u0 + u == 0 ? d_cur[u]
                        : __fadd_rn(d_cur[u], __fmul_rn(a_cur[u], g));
        const float h_prev = t > 0 ? h_cur[u] : h_init;
        store1(dap + (long long)t * DN, __fmul_rn(g, h_prev));
        store1(dbp + (long long)t * DN, g);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      a_cur[u] = a_nxt[u];
      d_cur[u] = d_nxt[u];
      h_cur[u] = h_nxt[u];
    }
  }
  dh0[(long long)blockIdx.y * DN + dn] = __fmul_rn(load1(ap), g);
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

// B6's backward.  dtype 0: a, da, db f32; 1: bf16.  hs, dhs, dh0 f32; h0
// may be null (zeros).  One launch.  Returns cudaError_t.
extern "C" int repro_ssm_scan_bwd(int dtype, const void* a, const void* hs,
                                  const void* h0, const void* dhs, void* da,
                                  void* db, void* dh0, int B, int S,
                                  long long DN, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)((DN + kThreads - 1) / kThreads), (unsigned)B);
  if (dtype == 0) {
    ssm_scan_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)a, (const float*)hs, (const float*)h0,
        (const float*)dhs, (float*)da, (float*)db, (float*)dh0, S, DN);
  } else if (dtype == 1) {
    ssm_scan_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)a, (const float*)hs, (const float*)h0,
        (const float*)dhs, (__nv_bfloat16*)da, (__nv_bfloat16*)db,
        (float*)dh0, S, DN);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
