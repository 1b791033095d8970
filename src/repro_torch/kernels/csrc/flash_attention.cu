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
// Both kernels optionally write each row's log-sum-exp of the scaled
// logits at the flush, in f32, for B4's backward
// (csrc/flash_attention_bwd.cu): the f32 kernel m + ln l, the bf16 kernel,
// whose softmax runs in base 2, ln 2 (m_2 + log2 l).  Serving passes a null
// pointer, and the output is the same bit for bit either way.
//
// float32: `flash_fwd_tf32x3`, tensor cores by 3xTF32, at every head dim
// (64, 128, 256).  One TF32 rounding of the operands moves results past
// the 3e-5 bound the kernel is held to.  So each operand x is split into
// hi = tf32(x) and lo = tf32(x - hi), and each product is lo*hi + hi*lo +
// hi*hi (lo*lo dropped), which holds it (tests/test_torch_flash_tf32.py
// repeats the recipe on the CPU).  The roof is 3x the kept flops over the
// TF32 tensor cores' 494.7 TFLOP/s; the f32 CUDA cores' 67 TFLOP/s over
// the kept flops was the roof of the SIMT kernel this one replaced.
//  * The bf16 kernel's grid, GQA reads, tile skipping, heaviest-first order
//    and edge-tile mask (below).  A warp owns 16 query rows.
//  * Q is scaled in f32, as the plain version does, then split.  At D=64
//    its halves stay in registers; at 128 and 256 they do not fit beside
//    the accumulators, and each key tile reads Q from shared memory and
//    splits it again.
//  * ldmatrix on f32 rows read as b16 pairs gives the m16n8k8 tf32
//    fragments of Q (A) and K (B).  ldmatrix.trans moves 16-bit halves, so
//    it cannot transpose f32 V: V's B fragments are plain 32-bit shared
//    loads.  Rows are padded by 4 floats, so each ldmatrix phase and each
//    V load hits 32 distinct banks.
//  * K and V tiles are double-buffered by cp.async.cg (zero-filled past
//    Sk) and split once per block as they land: each thread splits the
//    chunks it copied itself (visible to it after cp.async.wait_group, so
//    no extra barrier), hi in place and lo into a second array.  Split per
//    fragment in registers, every warp repeated the work, and the splits
//    took ~40 % of the kernel's time: at D=64, tiles (64, 64), B=4,
//    S=4096, 15/5 heads, causal, 3.28 ms against 1.94 ms for a copy that
//    issued the same mma's with no split instructions (H100 80GB HBM3,
//    700 W; PERF.md §6, "Every variant timed"; the probe copies are not in
//    the repo).  The price is 1.5x the K/V shared memory.  At D=64 Q's
//    staging space is the lo arrays'.
//  * Tiles (BQ, BK): D=64 (128, 64), D=128 (128, 32), D=256 (64, 16), 16
//    query rows per warp; at each, one block of 8 or 4 warps per SM (by
//    registers or shared memory).
//  * P stays in registers: the S accumulator holds keys 2t, 2t + 1 where
//    the A fragment wants t, t + 4, so the keys of a k-step are relabeled
//    and V is read at keys 2t, 2t + 1.
//  * Per k-step of each product, the cross terms of every accumulator go
//    first, then hi*hi.  The tensor cores truncate their f32 sums, so each
//    key tile's P V is summed in registers of its own and added to the
//    output by one rounded f32 add: one mma chain over the whole row grew
//    its error with the row's length (PERF.md §6; chip_smoke.py's
//    long-row check fails on it).  At D=256 those registers spill
//    (ptxas: 255 registers, 356 bytes of spill stores).  Softmax,
//    corrections and acc / l stay f32, with expf(s - m) (the build keeps
//    -fmad=false).
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

#include "tensor_core.cuh"  // cp.async, ldmatrix, mma.sync, the splits

namespace {

// ---------------------------------------------------------------------
// bfloat16 on tensor cores
// ---------------------------------------------------------------------

using bf16 = __nv_bfloat16;

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
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
               int causal, int window, float scale_log2) {
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
      // the row's log-sum-exp of the scaled logits, for the backward: the
      // softmax above runs in base 2 on the unscaled logits (p = 2^(s
      // scale_log2 - m scale_log2)), so lse = ln 2 (m scale_log2 +
      // log2 l), taken from the final m and l; O does not depend on it
      if (lse != nullptr && t == 0)
        lse[((long long)b * H + h) * Sq + r] =
            0.69314718055994531f * (m[mt][hr] * scale_log2 + log2f(sum));
    }
}

template <int D, int BQ, int BK, int WARPS>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int Sq, int Sk, int H, int Hkv,
                        int causal, int window, float scale,
                        cudaStream_t stream) {
  using Tile = TcTile<D, BQ, BK, WARPS>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<D, BQ, BK, WARPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(Tile::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_bf16<D, BQ, BK, WARPS><<<grid, Tile::kThreads, Tile::kSmem,
                                     stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Sq, Sk, H,
      Hkv, causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// The bf16 tiles <D, BQ, BK, WARPS> by head dim; PERF.md (PR 15) has
// what the alternatives measured.
cudaError_t dispatch_bf16(int D, const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int Sq, int Sk, int H,
                          int Hkv, int causal, int window, float scale,
                          cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_bf16<64, 128, 64, 4>(q, k, v, o, lse, B, Sq, Sk, H, Hkv,
                                         causal, window, scale, stream);
    case 128:
      return launch_bf16<128, 64, 64, 4>(q, k, v, o, lse, B, Sq, Sk, H, Hkv,
                                         causal, window, scale, stream);
    case 256:
      return launch_bf16<256, 64, 32, 4>(q, k, v, o, lse, B, Sq, Sk, H, Hkv,
                                         causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------
// float32 on tensor cores: 3xTF32
// ---------------------------------------------------------------------

// x rounded to tf32 (round to nearest, ties away from zero), returned as
// the bits of an f32 whose low 13 bits are zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// hi = tf32(x), lo = tf32(x - hi); x - hi is exact in f32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split_tf32(const uint32_t (&x)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), hi[i], lo[i]);
}

// The four floats at p (shared) become their hi halves in place; their lo
// halves go to lo.
__device__ __forceinline__ void split_tf32_4(float* p, float* lo) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  uint32_t in[4] = {x.x, x.y, x.z, x.w}, hi[4], l[4];
  split_tf32(in, hi, l);
  *reinterpret_cast<uint4*>(p) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// Tile shape: BQ query rows per block, 16 per warp; BK keys per tile;
// shared rows padded to D + 4 floats.  Shared memory: K and V in two
// stages (their hi halves once split), the lo halves of the current tile,
// and Q; at D=64 Q's halves are kept in registers, and Q's staging space
// is the lo halves' (BQ <= 2 BK).
template <int D, int BQ, int BK>
struct F32Tile {
  static constexpr int kWarps = BQ / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int DP = D + 4;
  static constexpr bool kQReg = D == 64;
  static constexpr size_t kSmem =
      sizeof(float) * size_t(6 * BK + (kQReg ? 0 : BQ)) * DP;
};

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(F32Tile<D, BQ, BK>::kThreads, 1)
flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                 int causal, int window, float scale) {
  using Tile = F32Tile<D, BQ, BK>;
  constexpr int NT = Tile::kThreads, DP = Tile::DP;
  constexpr int CH = D / 4;    // 16-byte chunks per row
  constexpr int KD = D / 8;    // k-steps of S = Q K^T
  constexpr int NS = BK / 8;   // 8-key column tiles of S = k-steps of P V
  constexpr int NO = D / 8;    // 8-wide column tiles of the output
  constexpr int NG = 8;        // output tiles per V pass
  constexpr bool kQReg = Tile::kQReg;  // Q's halves stay in registers
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && D % 64 == 0 &&
                (!kQReg || BQ <= 2 * BK), "tile shape");

  extern __shared__ __align__(16) float smem_f32[];
  float* Ks = smem_f32;          // 2 stages x BK x DP
  float* Vs = Ks + 2 * BK * DP;  // 2 stages x BK x DP
  float* Kl = Vs + 2 * BK * DP;  // BK x DP, lo halves of this tile's K
  float* Vl = Kl + BK * DP;      // BK x DP, lo halves of this tile's V
  float* Qs = kQReg ? Kl : Vl + BK * DP;  // BQ x DP, pre-scaled

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - int(blockIdx.x)) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) * 16;  // the warp's first row in the tile
  const int g = lane >> 2;         // fragment row (and row + 8)
  const int t = lane & 3;          // fragment column
  const int off = Sk - Sq;         // query row i sits at i + off

  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)Hkv * D;
  const float* qb = q + (long long)b * Sq * q_stride + (long long)h * D;
  const float* kb = k + (long long)b * Sk * kv_stride + (long long)hk * D;
  const float* vb = v + (long long)b * Sk * kv_stride + (long long)hk * D;

  // K/V copies: this thread moves the 16 bytes at column cc of rows cr,
  // cr + RS, ...; rows past Sk are zero-filled.
  constexpr int RS = NT / CH;
  static_assert(NT % CH == 0 && BK % RS == 0, "copy shape");
  const int cr = tid / CH, cc = (tid % CH) * 4;
  const uint32_t kdst = smem_addr(Ks + cr * DP + cc);
  const uint32_t vdst = smem_addr(Vs + cr * DP + cc);
  auto load_kv = [&](int k0, int stage) {
#pragma unroll
    for (int i = 0; i < BK / RS; ++i) {
      const int r = k0 + cr + i * RS;
      // a row past Sk reads nothing; its address stays inside the tensor
      const long long o = (long long)min(r, Sk - 1) * kv_stride + cc;
      const uint32_t d = uint32_t((stage * BK + i * RS) * DP * sizeof(float));
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
  // Q times the scale in f32, as the plain version computes it, while the
  // first K/V tile flies
  for (int e = tid * 4; e < BQ * D; e += NT * 4) {
    const int r = e / D, c = e % D;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq)
      x = *reinterpret_cast<const float4*>(qb + (q0 + r) * q_stride + c);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(Qs + r * DP + c) = x;
  }
  __syncthreads();

  // ldmatrix on f32 rows read as pairs of b16: an 8x8 b16 matrix is 8 rows
  // of 4 floats, and lane i receives row i / 4, float i % 4 -- the
  // m16n8k8 tf32 layouts.  Q's A fragment of k-step kd: rows g, g + 8 at
  // columns t, t + 4; lane i addresses row i % 8 + 8 (i / 8 % 2), column
  // 4 (i / 16).  K's B fragments (key g, d t and t + 4) of two 8-key
  // tiles: key i % 8 + 8 (i / 16), d 4 (i / 8 % 2), hi and lo halves from
  // their two arrays.
  const uint32_t q_ld = smem_addr(Qs + (wr + (lane & 7) + ((lane >> 3) & 1) * 8)
                                           * DP + (lane >> 4) * 4);
  auto q_frag = [&](int kd, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    uint32_t x[4];
    ldsm_x4(x, q_ld + uint32_t(kd * 8 * sizeof(float)));
    split_tf32(x, hi, lo);
  };
  uint32_t qh[kQReg ? KD : 1][4], ql[kQReg ? KD : 1][4];
  if (kQReg) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) q_frag(kd, qh[kd], ql[kd]);
    __syncthreads();  // Q's space becomes the lo halves'
  }
  constexpr uint32_t kStage = uint32_t(BK * DP * sizeof(float));
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * DP + ((lane >> 3) & 1) * 4;
  const uint32_t k_ld = smem_addr(Ks + k_off), kl_ld = smem_addr(Kl + k_off);
  // V's B fragment of P V (see the key order below): keys 2t and 2t + 1 of
  // the k-step, column g of the output tile; plain 32-bit loads
  const int v_off = 2 * t * DP + g;

  float m[2], l[2], acc[NO][4];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    m[hr] = -INFINITY;
    l[hr] = 0.f;  // this lane's share of the row sum
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = (kt0 + it) * BK;
    const int stage = it & 1;
    if (it + 1 < n_kt) load_kv(k0 + BK, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of this tile have landed
    // Split the chunks this thread copied (its own copies are visible to it
    // without a barrier): hi in place, lo beside, once for the whole block.
#pragma unroll
    for (int i = 0; i < BK / RS; ++i) {
      const int r = (cr + i * RS) * DP + cc;
      split_tf32_4(Ks + stage * BK * DP + r, Kl + r);
      split_tf32_4(Vs + stage * BK * DP + r, Vl + r);
    }
    __syncthreads();
    const uint32_t ks = k_ld + stage * kStage;

    // S = Q K^T: per k-step the three products of every 8-key tile, cross
    // terms first (lo(Q) hi(K), hi(Q) lo(K), hi(Q) hi(K))
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qfh[4], qfl[4];
      if (kQReg) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qfh[i] = qh[kQReg ? kd : 0][i];
          qfl[i] = ql[kQReg ? kd : 0][i];
        }
      } else {
        q_frag(kd, qfh, qfl);
      }
      uint32_t kh[NS / 2][4], kl[NS / 2][4];
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        const uint32_t o = uint32_t((np * 16 * DP + kd * 8) * sizeof(float));
        ldsm_x4(kh[np], ks + o);
        ldsm_x4(kl[np], kl_ld + o);
      }
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          const uint32_t (&a)[4] = pass == 0 ? qfl : qfh;
          const uint32_t (&bb)[4] = pass == 1 ? kl[np] : kh[np];
          mma1688(s[2 * np], a, bb[0], bb[1]);
          mma1688(s[2 * np + 1], a, bb[2], bb[3]);
        }
    }

    // Mask element by element only where the mask cuts into this tile
    // for some row of the warp (the diagonal, the window edge, Sk).
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + wr + off) ||
        (window && k0 <= q0 + wr + 15 + off - window)) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        // the keys query qa keeps, relative to this lane's first column
        const int qa = q0 + wr + g + 8 * hr + off;
        const int first = (window ? qa - window + 1 : 0) - (k0 + 2 * t);
        const int last = (causal ? min(qa, Sk - 1) : Sk - 1) - (k0 + 2 * t);
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (j * 8 + c < first || j * 8 + c > last)
              s[j][2 * hr + c] = -INFINITY;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {  // rows g and g + 8 of the mma tile
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      // a row with no key kept so far keeps m = -inf; exp(-inf) = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[hr] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[j][2 * hr + c];
          x = expf(x - m_use);
          rs += x;
        }
      l[hr] = l[hr] * corr + rs;
      m[hr] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * hr] *= corr;
        acc[n][2 * hr + 1] *= corr;
      }
    }

    // O += P V, k-step j = the 8 keys of S tile j.  The S accumulator holds
    // keys 2t, 2t + 1 where the A fragment wants t, t + 4; the sum over
    // keys does not care about their order, so the k-step's key slot t is
    // key 2t and slot t + 4 is key 2t + 1: P's A fragment is (s0, s2, s1,
    // s3) with no shuffle, and V's B fragment is read at keys 2t, 2t + 1.
    // By groups of NG output tiles, P split again per group; the tile's
    // products are summed in pv, then added to acc in f32 (see the header).
    const float* vh_s = Vs + stage * BK * DP + v_off;
    const float* vl_s = Vl + v_off;
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += NG) {
      float pv[NG][4];
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[n][i] = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        uint32_t vh[NG][2], vl[NG][2];
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = (j * 8 + r) * DP + (n0 + n) * 8;
            vh[n][r] = __float_as_uint(vh_s[e]);
            vl[n][r] = __float_as_uint(vl_s[e]);
          }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            const uint32_t (&a)[4] = pass == 0 ? pl : ph;
            const uint32_t (&bb)[2] = pass == 1 ? vl[n] : vh[n];
            mma1688(pv[n], a, bb[0], bb[1]);
          }
      }
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n0 + n][i] += pv[n][i];
    }
    __syncthreads();  // this tile is read: the next split and the
                      // next-but-one load reuse its space
  }

  float* ob = o + (long long)b * Sq * q_stride + (long long)h * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float sum = l[hr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float denom = fmaxf(sum, 1e-30f);
    const int r = q0 + wr + g + 8 * hr;
    if (r >= Sq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(ob + r * q_stride + n * 8 + 2 * t) =
          make_float2(acc[n][2 * hr] / denom, acc[n][2 * hr + 1] / denom);
    // the row's log-sum-exp of the scaled logits, for the backward
    // (csrc/flash_attention_bwd.cu); O above does not depend on it
    if (lse != nullptr && t == 0)
      lse[((long long)b * H + h) * Sq + r] = m[hr] + logf(sum);
  }
}

template <int D, int BQ, int BK>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Sq, int Sk, int H, int Hkv,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  using Tile = F32Tile<D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32x3<D, BQ, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(Tile::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_tf32x3<D, BQ, BK><<<grid, Tile::kThreads, Tile::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, H,
      Hkv, causal, window, scale);
  return cudaGetLastError();
}

// The f32 tiles <D, BQ, BK> by head dim (BQ / 16 warps); PERF.md §6 has
// what the alternatives measured.  tests/test_torch_flash_tf32.py (the
// recipe's keys per tile) and chip_smoke.py (the kernel's ptxas label)
// read the tiles from these case lines: keep one `launch_f32<D, BQ, BK>`
// per case.
cudaError_t dispatch_f32(int D, const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int Sq, int Sk, int H,
                         int Hkv, int causal, int window, float scale,
                         cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_f32<64, 128, 64>(q, k, v, o, lse, B, Sq, Sk, H, Hkv,
                                     causal, window, scale, stream);
    case 128:
      return launch_f32<128, 128, 32>(q, k, v, o, lse, B, Sq, Sk, H, Hkv,
                                      causal, window, scale, stream);
    case 256:
      return launch_f32<256, 64, 16>(q, k, v, o, lse, B, Sq, Sk, H, Hkv,
                                     causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (`flash_fwd_tf32x3`), 1 = bfloat16 (`flash_fwd_bf16`).
// q, o: (B, Sq, H, D); k, v: (B, Sk, Hkv, D); all contiguous.  lse: null,
// or a (B, H, Sq) f32 output of each row's log-sum-exp of the scaled
// logits (either dtype).  Returns the launch's cudaError_t.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* o, void* lse, int B,
                                     int Sq, int Sk, int H, int Hkv, int D,
                                     int causal, int window, float scale,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_f32(D, q, k, v, o, static_cast<float*>(lse), B, Sq, Sk,
                        H, Hkv, causal, window, scale, s);
  if (dtype == 1)
    return dispatch_bf16(D, q, k, v, o, static_cast<float*>(lse), B, Sq, Sk,
                         H, Hkv, causal, window, scale, s);
  return cudaErrorInvalidValue;
}
