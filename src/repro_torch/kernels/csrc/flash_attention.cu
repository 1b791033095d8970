// B4: prefill attention (GQA, causal and/or sliding window) for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` of the JAX package
// (src/repro/kernels/flash_attention.py:84).  Plain version:
// `flash_attention_ref` in kernels/ref.py, which it follows, queries
// end-aligned with the keys (query i sits at absolute position
// i + Sk - Sq), not the Pallas kernel's start alignment.  Two kernels, by
// dtype, behind one entry point.
//
// What bounds it on the H100: operations, 4*B*H*D flops per kept
// query-key pair against 2 bytes per flop or less.
//
// float32: `flash_fwd`, CUDA-core SIMT.  The f32 path must stay f32 (no
// TF32: it would move results past the 3e-5 tolerance), so the roof is
// the CUDA cores' 67 TFLOP/s.
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
//  * f32 FMA throughout (explicit fmaf: the build uses -fmad=false).
//
// bfloat16: `flash_fwd_bf16`, tensor cores; the roof is 989 TFLOP/s of
// bf16 mma.  The same grid, GQA reads, tile skipping and heaviest-first
// order as the f32 kernel, and the FlashAttention-2 structure:
//  * Each warp owns 32 query rows at D=64 (each K/V fragment feeds two
//    mma's; ~235 registers, two 4-warp blocks per SM) and 16 at D=128 and
//    256.  Q is staged once and kept in registers as mma A fragments
//    (ldmatrix.x4).
//  * K and V tiles are double-buffered in shared memory by cp.async.cg
//    16-byte copies (zero-filled past Sk): the next tile's copies are in
//    flight during this tile's mma's.  Rows are padded by 8 bf16 (16
//    bytes), so the 8 row addresses of each ldmatrix fall in distinct
//    bank groups.  K is read with ldmatrix, V with ldmatrix.trans.
//  * S = Q K^T by mma.sync m16n8k16 bf16 -> f32, then times 1/sqrt(D) in
//    f32 (a bf16 pre-scale of Q would add a rounding the plain version
//    does not have: 1/sqrt(128) is no power of two).  The mask is applied
//    element by element only on tiles that cross the diagonal, the window
//    edge or Sk.
//  * The online softmax stays in registers: row max over the 4 lanes of a
//    quad by two shuffles, exp2 with log2(e) folded into the scale, the
//    row sum kept per lane and reduced once at the end.
//  * P V: the S accumulators become A fragments in registers (no trip
//    through shared memory).  P is split into hi = bf16(p) and lo =
//    bf16(p - hi), two mma's on the same V fragment (all hi mma's of a
//    k-step, then all lo ones).  P rounded once to bf16 leaves about 2 %
//    of the outputs past the one-rounding bound the kernel is held to
//    (chip_smoke.py::attn_tol), the split none
//    (tests/test_torch_flash_bf16.py).  It costs 1.5x the mma work.
//  * f32 accumulation; the output is rounded to bf16 once.
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

template <int D, int BQ, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
          size_t(BQ) * (BK + 1));
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
          int H, int Hkv, int causal, int window, float scale) {
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
  const float* qb = q + (long long)b * Sq * q_stride + (long long)h * D;
  const float* kb = k + (long long)b * Sk * kv_stride + (long long)hk * D;
  const float* vb = v + (long long)b * Sk * kv_stride + (long long)hk * D;

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

  float* ob = o + (long long)b * Sq * q_stride + (long long)h * D;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty * TM + i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < TN; ++c)
      ob[r * q_stride + tx + 8 * c] = acc[i][c] / denom;
  }
}

template <int D, int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int Hkv, int causal,
                   int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BQ, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<D, BQ, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, Hkv,
      causal, window, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(int D, const void* q, const void* k, const void* v,
                         void* o, int B, int Sq, int Sk, int H, int Hkv,
                         int causal, int window, float scale,
                         cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<64, 64, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, causal,
                                window, scale, stream);
    case 128:
      return launch<128, 64, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, causal,
                                 window, scale, stream);
    case 256:
      return launch<256, 32, 32>(q, k, v, o, B, Sq, Sk, H, Hkv, causal,
                                 window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------
// bfloat16 on tensor cores
// ---------------------------------------------------------------------

using bf16 = __nv_bfloat16;

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
// far below what the bf16 output can show).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Two probabilities (adjacent keys) as packed bf16 halves: hi = bf16(p),
// lo = bf16(p - hi); p - hi is exact in f32.
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi,
                                        uint32_t& lo) {
  hi = bits(__floats2bfloat162_rn(p0, p1));
  // the halves back in f32: a bf16 is the top 16 bits of an f32
  const float h0 = __uint_as_float(hi << 16);
  const float h1 = __uint_as_float(hi & 0xffff0000u);
  lo = bits(__floats2bfloat162_rn(p0 - h0, p1 - h1));
}

// Tile shape: BQ query rows per block, BK keys per tile, WARPS warps of
// MT 16-row mma tiles each; shared rows padded to D + 8 bf16.
template <int D, int BQ, int BK, int WARPS>
struct TcTile {
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int MT = BQ / (16 * WARPS);
  static constexpr int DP = D + 8;
  static constexpr size_t kSmem = sizeof(bf16) * size_t(BQ + 4 * BK) * DP;
};

template <int D, int BQ, int BK, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, 1)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
               int Sk, int H, int Hkv, int causal, int window,
               float scale_log2) {
  using Tile = TcTile<D, BQ, BK, WARPS>;
  constexpr int NT = Tile::kThreads, MT = Tile::MT, DP = Tile::DP;
  constexpr int CH = D / 8;    // 16-byte chunks per row
  constexpr int KD = D / 16;   // k-steps of S = Q K^T
  constexpr int NS = BK / 8;   // 8-key column tiles of S
  constexpr int KK = BK / 16;  // k-steps of P V
  constexpr int NO = D / 8;    // 8-wide column tiles of the output
  static_assert(MT >= 1 && MT * 16 * WARPS == BQ && BK % 16 == 0 &&
                D % 16 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x DP
  bf16* Ks = Qs + BQ * DP;                       // 2 stages x BK x DP
  bf16* Vs = Ks + 2 * BK * DP;                   // 2 stages x BK x DP

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - int(blockIdx.x)) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) * MT * 16;  // the warp's first row in the tile
  const int g = lane >> 2;              // fragment row (and row + 8)
  const int t = lane & 3;               // fragment column pair
  const int off = Sk - Sq;              // query row i sits at i + off

  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)Hkv * D;
  const bf16* qb = q + (long long)b * Sq * q_stride + (long long)h * D;
  const bf16* kb = k + (long long)b * Sk * kv_stride + (long long)hk * D;
  const bf16* vb = v + (long long)b * Sk * kv_stride + (long long)hk * D;

  // Copies: this thread moves the 16 bytes at column cc of rows cr,
  // cr + RS, cr + 2 RS, ...; rows past the end are zero-filled.
  constexpr int RS = NT / CH;
  static_assert(NT % CH == 0 && BQ % RS == 0 && BK % RS == 0, "copy shape");
  const int cr = tid / CH, cc = (tid % CH) * 8;
#pragma unroll
  for (int i = 0; i < BQ / RS; ++i) {
    const int r = cr + i * RS;
    cp_async16(smem_addr(Qs + r * DP + cc),
               qb + (long long)min(q0 + r, Sq - 1) * q_stride + cc,
               q0 + r < Sq);
  }
  cp_async_commit();
  const uint32_t kdst = smem_addr(Ks + cr * DP + cc);
  const uint32_t vdst = smem_addr(Vs + cr * DP + cc);
  auto load_kv = [&](int k0, int stage) {
#pragma unroll
    for (int i = 0; i < BK / RS; ++i) {
      const int r = k0 + cr + i * RS;
      // a row past Sk reads nothing; its address stays inside the tensor
      const long long o = (long long)min(r, Sk - 1) * kv_stride + cc;
      const uint32_t d = uint32_t((stage * BK + i * RS) * DP * sizeof(bf16));
      cp_async16(kdst + d, kb + o, r < Sk);
      cp_async16(vdst + d, vb + o, r < Sk);
    }
  };

  // The key range any row of this tile keeps, in whole tiles.
  const int qa_lo = q0 + off;
  const int qa_hi = min(q0 + BQ, Sq) - 1 + off;
  const int k_begin = window ? max(0, qa_lo - window + 1) : 0;
  const int k_end = causal ? min(Sk, qa_hi + 1) : Sk;
  const int kt0 = k_begin / BK;
  const int n_kt = (k_end + BK - 1) / BK - kt0;

  if (n_kt > 0) load_kv(kt0 * BK, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed; the first K/V tile may still fly
  __syncthreads();
  uint32_t qf[MT][KD][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      ldsm_x4(qf[mt][kd], smem_addr(Qs + (wr + mt * 16 + (lane & 15)) * DP +
                                    kd * 16 + (lane >> 4) * 8));

  // This lane's ldmatrix row addresses in K (keys lane % 8 + 8 (lane / 16),
  // d 8 (lane / 8 % 2)) and in V (keys lane % 8 + 8 (lane / 8 % 2),
  // d 8 (lane / 16)) of stage 0; see the mma fragment layouts.
  constexpr uint32_t kStage = uint32_t(BK * DP * sizeof(bf16));
  const uint32_t k_ld = smem_addr(Ks + ((lane & 7) + (lane >> 4) * 8) * DP +
                                  ((lane >> 3) & 1) * 8);
  const uint32_t v_ld = smem_addr(Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) *
                                           DP +
                                  (lane >> 4) * 8);

  float m[MT][2], l[MT][2], acc[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m[mt][hr] = -INFINITY;
      l[mt][hr] = 0.f;  // this lane's share of the row sum
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0.f;
  }

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = (kt0 + it) * BK;
    const int stage = it & 1;
    if (it + 1 < n_kt) load_kv(k0 + BK, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const uint32_t ks = k_ld + stage * kStage, vs = v_ld + stage * kStage;

    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][j][i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        // keys np*16 + 0..15 at d = kd*16 + 0..15: B fragments of two
        // 8-key column tiles
        uint32_t kf[4];
        ldsm_x4(kf, ks + uint32_t((np * 16 * DP + kd * 16) * sizeof(bf16)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(s[mt][2 * np], qf[mt][kd], kf[0], kf[1]);
          mma16816(s[mt][2 * np + 1], qf[mt][kd], kf[2], kf[3]);
        }
      }

    // Mask element by element only where the mask cuts into this tile
    // for some row of the warp (the diagonal, the window edge, Sk).
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + wr + off) ||
        (window && k0 <= q0 + wr + MT * 16 - 1 + off - window)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          // the keys query qa keeps, relative to this lane's first column
          const int qa = q0 + wr + mt * 16 + g + 8 * hr + off;
          const int first = (window ? qa - window + 1 : 0) - (k0 + 2 * t);
          const int last = (causal ? min(qa, Sk - 1) : Sk - 1) - (k0 + 2 * t);
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (j * 8 + c < first || j * 8 + c > last)
                s[mt][j][2 * hr + c] = -INFINITY;
        }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {  // rows g and g + 8 of the mma tile
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * hr], s[mt][j][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][hr], mx);
        // a row with no key kept so far keeps m = -inf; exp2(-inf) = 0
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float ms = m_use * scale_log2;
        const float corr = exp2_ftz(m[mt][hr] * scale_log2 - ms);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[mt][j][2 * hr + c];
            x = exp2_ftz(fmaf(x, scale_log2, -ms));
            rs += x;
          }
        l[mt][hr] = l[mt][hr] * corr + rs;
        m[mt][hr] = m_new;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[mt][n][2 * hr] *= corr;
          acc[mt][n][2 * hr + 1] *= corr;
        }
      }
    }

#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      // P of keys kk*16 + 0..15 as A fragments, hi and lo halves
      uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_p(s[mt][2 * kk][0], s[mt][2 * kk][1], ph[mt][0], pl[mt][0]);
        split_p(s[mt][2 * kk][2], s[mt][2 * kk][3], ph[mt][1], pl[mt][1]);
        split_p(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1], ph[mt][2],
                pl[mt][2]);
        split_p(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3], ph[mt][3],
                pl[mt][3]);
      }
      // V of keys kk*16 + 0..15, transposed: B fragments of every 8-wide
      // output column tile, two per ldmatrix
      uint32_t vf[NO / 2][4];
#pragma unroll
      for (int np = 0; np < NO / 2; ++np)
        ldsm_x4_t(vf[np],
                  vs + uint32_t((kk * 16 * DP + np * 16) * sizeof(bf16)));
      // the hi pass over all output tiles, then the lo pass, so no two
      // mma's in a row wait on one accumulator
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int np = 0; np < NO / 2; ++np)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint32_t (&a)[4] = half ? pl[mt] : ph[mt];
            mma16816(acc[mt][2 * np], a, vf[np][0], vf[np][1]);
            mma16816(acc[mt][2 * np + 1], a, vf[np][2], vf[np][3]);
          }
    }
    __syncthreads();  // this stage is read; the next-but-one load reuses it
  }

  bf16* ob = o + (long long)b * Sq * q_stride + (long long)h * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float sum = l[mt][hr];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float denom = fmaxf(sum, 1e-30f);
      const int r = q0 + wr + mt * 16 + g + 8 * hr;
      if (r >= Sq) continue;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(ob + r * q_stride + n * 8 +
                                           2 * t) =
            __floats2bfloat162_rn(acc[mt][n][2 * hr] / denom,
                                  acc[mt][n][2 * hr + 1] / denom);
    }
}

template <int D, int BQ, int BK, int WARPS>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Sk, int H, int Hkv, int causal,
                        int window, float scale, cudaStream_t stream) {
  using Tile = TcTile<D, BQ, BK, WARPS>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<D, BQ, BK, WARPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(Tile::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_bf16<D, BQ, BK, WARPS><<<grid, Tile::kThreads, Tile::kSmem,
                                     stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, H, Hkv,
      causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// The bf16 tiles <D, BQ, BK, WARPS> by head dim; PERF.md (PR 15) has
// what the alternatives measured.
cudaError_t dispatch_bf16(int D, const void* q, const void* k, const void* v,
                          void* o, int B, int Sq, int Sk, int H, int Hkv,
                          int causal, int window, float scale,
                          cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_bf16<64, 128, 64, 4>(q, k, v, o, B, Sq, Sk, H, Hkv,
                                         causal, window, scale, stream);
    case 128:
      return launch_bf16<128, 64, 64, 4>(q, k, v, o, B, Sq, Sk, H, Hkv,
                                         causal, window, scale, stream);
    case 256:
      return launch_bf16<256, 64, 32, 4>(q, k, v, o, B, Sq, Sk, H, Hkv,
                                         causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (`flash_fwd`), 1 = bfloat16 (`flash_fwd_bf16`).
// q, o: (B, Sq, H, D); k, v: (B, Sk, Hkv, D); all contiguous.  Returns
// the launch's cudaError_t.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* o, int B, int Sq,
                                     int Sk, int H, int Hkv, int D, int causal,
                                     int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_f32(D, q, k, v, o, B, Sq, Sk, H, Hkv, causal, window,
                        scale, s);
  if (dtype == 1)
    return dispatch_bf16(D, q, k, v, o, B, Sq, Sk, H, Hkv, causal, window,
                         scale, s);
  return cudaErrorInvalidValue;
}
