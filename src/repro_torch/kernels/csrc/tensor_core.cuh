// The tensor-core and copy helpers that B4's forward
// (csrc/flash_attention.cu) and backward (csrc/flash_attention_bwd.cu)
// share: cp.async copies, ldmatrix, mma.sync in bf16 (m16n8k16) and TF32
// (m16n8k8), exp2, and the bf16 hi/lo split of f32 values that lets a
// product of them run on the bf16 tensor cores.  Device functions only;
// each .cu that includes this header is its own library, and
// kernels/_build.py hashes the headers of csrc/ with it.
//
// Fragment layouts (lane = 4 g + t): an m16n8 accumulator holds rows g
// and g + 8 at columns 2t and 2t + 1 (c[0], c[1] for row g; c[2], c[3]
// for row g + 8).  bf16 m16n8k16: A holds rows g, g + 8 at columns 2t,
// 2t + 1 (a[0], a[1]) and 2t + 8, 2t + 9 (a[2], a[3]); B holds k rows 2t,
// 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of column g.  So two accumulator
// tiles side by side are an A fragment as they stand.  TF32 m16n8k8: A
// holds rows g, g + 8 at column t (a[0], a[1]) and t + 4 (a[2], a[3]); B
// holds k rows t (b0) and t + 4 (b1) of column g.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (nothing
// is read from src then).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8 and receives, in r[j], its two elements of matrix j.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same with each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b: a 16x16 row-major, b 16x8 column-major, bf16 in, f32 sum.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, flushing results below 2^-126 to 0 (only p < 2^-126 changes,
// far below what a bf16 output can show).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Two f32 values (adjacent columns) as packed bf16 halves: hi = bf16(p),
// lo = bf16(p - hi); p - hi is exact in f32.
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi,
                                        uint32_t& lo) {
  hi = bits(__floats2bfloat162_rn(p0, p1));
  // the halves back in f32: a bf16 is the top 16 bits of an f32
  const float h0 = __uint_as_float(hi << 16);
  const float h1 = __uint_as_float(hi & 0xffff0000u);
  lo = bits(__floats2bfloat162_rn(p0 - h0, p1 - h1));
}

// c += a b: a 16x8 row-major, b 8x8 column-major, tf32 in, f32 sum.
__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
