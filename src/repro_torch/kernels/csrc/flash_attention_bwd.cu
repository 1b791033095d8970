// B4's gradient: the backward of prefill attention (GQA, causal and/or
// sliding window, or no mask) in float32 or bfloat16, for sm_90a, on the
// tensor cores (mma.sync).
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
// or 2 (bf16) per element read once: the bf16 tensor cores' 989 TFLOP/s,
// or in f32 three TF32 products for each (494.7 TFLOP/s).  The design is
// bounded as much by what the gradient is held to: 1e-5 + 1e-4 |plain|
// elementwise (bf16: plus one bf16 ulp of the plain value), and the same
// bits from run to run.
//  * bf16 (`<64,bf16>`).  S and dP take one mma.sync m16n8k16 pass each:
//    their operands are bf16 as given, so the products are exact and
//    summed in f32.  P and dS are f32 in registers; rounded once to bf16
//    as mma operands they leave 12 % of dQ past the bound at 1 x 512, 5/1
//    heads, causal (tests/test_torch_flash_bwd.py pins it).  So each is
//    split into hi = bf16(x) and lo = bf16(x - hi), and each product that
//    takes it (dV += P^T dO, dK += dS^T Q, dQ += dS K) runs two passes, hi
//    then lo: 8 bf16 passes for the 5 products.  The softmax's exp is
//    ex2.approx with log2(e) folded into the scale and the lse, far inside
//    one bf16 ulp.
//  * f32 (`<64,float>`).  One TF32 product misses the bound (TF32 rounds
//    at 2^-11 relative, five times 1e-4), so all five products are 3xTF32
//    on mma.sync m16n8k8: each operand split into hi = tf32(x) and lo =
//    tf32(x - hi), each k-step lo*hi, hi*lo, then hi*hi (lo*lo dropped),
//    as the forward.  Streamed tiles are split once per block as they land
//    (each thread its own cp.async chunks: hi in place, lo in a second
//    array), P and dS in registers, the block's fixed operand (Q and dO in
//    dq, K and V in dkdv) per fragment as each warp reads its own rows.
//    exp is expf.
//  * Both: the tensor cores truncate their f32 sums, and one mma chain
//    over the 320 tiles x 8 passes of a KV head's dK at Hymba-1.5B's shape
//    missed even the bf16 bound.  So every tile's dQ, dK and dV product is
//    summed in fresh registers and added to the running sum by one rounded
//    f32 add.
//
// No atomics, so the gradient is the same bit for bit from run to run.
// Three launches a call, on one stream:
//  * `flash_bwd_dq<D,T>`, one block per (64 query rows, head, batch),
//    heaviest causal tile first: computes delta for its rows (written out
//    for the second launch), then loops over the key tiles the mask keeps
//    (bf16 64 keys, f32 32): S and dP, P and dS in registers, dQ += dS K;
//    dQ written once.
//  * `flash_bwd_dkdv<D,T>`, one block per (64 keys, query head, batch):
//    loops over the query tiles the mask keeps (bf16 64 rows, f32 32):
//    S^T = K Q^T and dP^T = V dO^T, so that the accumulators are key-major
//    and become the A operands of dV += P^T dO and dK += dS^T Q as they
//    stand; that head's dK and dV written once, in f32, to a (2, B, Sk, H,
//    D) scratch.  A block per KV head, looping over the group's heads,
//    gave the heaviest block (key tile 0 at Hymba-1.5B's shape) 5 x 64
//    query tiles against 197 per block slot on average (52,000 over 132
//    SMs x 2).
//  * `flash_bwd_dkdv_sum<D,T>` sums each KV head's G partials in head
//    order (a fixed order), scales dK in bf16, and rounds dK and dV once to
//    T.  The scratch costs 2 B Sk H D floats (52 MB at Hymba's shape).
// Four warps a block, 16 rows (dq: queries, dkdv: keys) each.  The
// block's fixed operand (dq: Q, dO; dkdv: K, V) is copied once; the
// streamed one (dq: K, V; dkdv: Q, dO, lse, delta) is double-buffered by
// cp.async (zero-filled past the end), the next tile in flight while this
// one is used.  Shared rows are padded by 16 bytes (8 bf16, 4 floats), so
// each ldmatrix phase hits distinct banks.  bf16 B operands that the
// product wants transposed (K in dS K, dO and Q in dkdv) are read by
// ldmatrix.trans; f32 ones by plain 32-bit loads (ldmatrix.trans moves
// 16-bit halves), with the columns of an accumulator's k-step relabeled
// (slot t is column 2t, slot t + 4 column 2t + 1) so that no shuffle is
// needed.  The mask (S = -inf, so P = 0) is applied element by element
// only on tiles that cross the diagonal, the window edge, Sq or Sk (a
// select on every element was slower).  The scale
// 1/sqrt(64) = 1/8 is a power of two: bf16 scales S, dQ and dK in f32
// (exact), f32 scales Q as it lands, as the plain version does.  Head dim
// 64 only.  ptxas: dq 168 registers in bf16 (capped at 170 for three
// blocks an SM), 156 in f32; dkdv 241 and 228 (two blocks an SM); no
// spills.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"  // cp.async, ldmatrix, mma.sync, the splits

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlock = 16 * kWarps;  // dq: query rows, dkdv: keys
constexpr float kLog2e = 1.4426950408889634f;

// Shared rows padded by 16 bytes; BS rows per streamed tile; dynamic
// shared memory: the fixed operand's two tiles (kBlock rows each), the
// streamed operand's two in two stages, and in f32 their lo halves.
template <int D, typename T>
struct BwdTile {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int DP = D + 16 / int(sizeof(T));
  static constexpr int BS = kF32 ? 32 : 64;
  static constexpr size_t kSmem =
      sizeof(T) * size_t(2 * kBlock + (kF32 ? 6 : 4) * BS) * DP;
  // dq blocks per SM: bf16 3 (registers capped at 170, no spill), f32 2
  // (shared memory)
  static constexpr int kDqBlocks = kF32 ? 2 : 3;
};

// hi = tf32(x), lo = tf32(x - hi), with tf32 rounding to nearest, ties
// away from zero: cvt.rna.tf32.f32's values, by two integer operations on
// the bits (add half of the dropped 13 bits' unit, clear them).  ptxas
// expands cvt.rna.tf32.f32 into a longer instruction sequence.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_rna(float x, uint32_t& hi,
                                          uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split_rna(const uint32_t (&x)[4],
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_rna(__uint_as_float(x[i]), hi[i], lo[i]);
}
// The four floats at p (shared), times mul, become their hi halves in
// place; their lo halves go to lo.
__device__ __forceinline__ void split_rna_4(float* p, float* lo,
                                            float mul = 1.f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  uint32_t hi[4], l[4];
  split_rna(x.x * mul, hi[0], l[0]);
  split_rna(x.y * mul, hi[1], l[1]);
  split_rna(x.z * mul, hi[2], l[2]);
  split_rna(x.w * mul, hi[3], l[3]);
  *reinterpret_cast<uint4*>(p) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// 4 bytes global -> shared, asynchronously; zero when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0));
}

// s + the dot product of 8 bf16 pairs (one 16-byte load each), in order.
__device__ __forceinline__ float dot8(uint4 x, uint4 y, float s) {
  const uint32_t a[4] = {x.x, x.y, x.z, x.w}, c[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s = fmaf(__uint_as_float(a[i] << 16), __uint_as_float(c[i] << 16), s);
    s = fmaf(__uint_as_float(a[i] & 0xffff0000u),
             __uint_as_float(c[i] & 0xffff0000u), s);
  }
  return s;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The mask on NS accumulator tiles of S (queries as rows, keys as
// columns): -inf, so that P = 0, where query position qa (this lane's row
// g; qa + 8 for row g + 8) does not keep key k (this lane's column 2t is
// key k2t, and column j * 8 + c of the tiles is key k2t + j * 8 + c).
template <int NS>
__device__ __forceinline__ void mask_rows(float (&s)[NS][4], int qa, int k2t,
                                          int Sk, int causal, int window) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int a = qa + 8 * hr;
    // the keys query a keeps, relative to this lane's first column
    const int first = (window ? a - window + 1 : 0) - k2t;
    const int last = (causal ? min(a, Sk - 1) : Sk - 1) - k2t;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (j * 8 + c < first || j * 8 + c > last)
          s[j][2 * hr + c] = -INFINITY;
  }
}

// The same on S^T (keys as rows, queries as columns): key (this lane's
// row g; key + 8 for row g + 8) against query row q2t + j * 8 + c (this
// lane's column 2t is query row q2t), at position row + off; query rows
// past Sq are masked too.
template <int NS>
__device__ __forceinline__ void mask_cols(float (&st)[NS][4], int key,
                                          int q2t, int Sq, int off,
                                          int causal, int window) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kk = key + 8 * hr;
    // the query rows that keep key kk, relative to this lane's first column
    const int first = (causal ? kk - off : 0) - q2t;
    const int last = (window ? min(kk + window - 1 - off, Sq - 1) : Sq - 1) -
                     q2t;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (j * 8 + c < first || j * 8 + c > last)
          st[j][2 * hr + c] = -INFINITY;
  }
}

// An accumulator tile pair (columns 0-7, 8-15) as the hi and lo halves of
// an m16n8k16 A fragment.
__device__ __forceinline__ void split_a16(const float (&c0)[4],
                                          const float (&c1)[4],
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  split_p(c0[0], c0[1], hi[0], lo[0]);
  split_p(c0[2], c0[3], hi[1], lo[1]);
  split_p(c1[0], c1[1], hi[2], lo[2]);
  split_p(c1[2], c1[3], hi[3], lo[3]);
}

// An accumulator tile (8 columns) as the hi and lo halves of an m16n8k8
// A fragment, its columns relabeled: slot t is column 2t, slot t + 4
// column 2t + 1.
__device__ __forceinline__ void split_a8(const float (&c)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split_rna(c[0], hi[0], lo[0]);
  split_rna(c[2], hi[1], lo[1]);
  split_rna(c[1], hi[2], lo[2]);
  split_rna(c[3], hi[3], lo[3]);
}

// part = a (2 KK 8-column tiles of this warp's 16 rows, split into bf16 hi
// and lo halves) times the 16 KK x D bf16 tile read transposed by
// ldmatrix.trans from this lane's row address bt; the hi pass over every
// output tile, then the lo pass.
template <int KK, int NO, int DP>
__device__ __forceinline__ void bf16x2_times_tile(float (&part)[NO][4],
                                                  const float (&a)[2 * KK][4],
                                                  uint32_t bt) {
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    uint32_t ah[4], al[4], b[NO / 2][4];
    split_a16(a[2 * kk], a[2 * kk + 1], ah, al);
#pragma unroll
    for (int np = 0; np < NO / 2; ++np)
      ldsm_x4_t(b[np], bt + uint32_t((kk * 16 * DP + np * 16) * sizeof(bf16)));
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        const uint32_t (&x)[4] = half ? al : ah;
        mma16816(part[2 * np], x, b[np][0], b[np][1]);
        mma16816(part[2 * np + 1], x, b[np][2], b[np][3]);
      }
  }
}

// part = a (NS relabeled 8-column tiles of this warp's 16 rows) times the
// BS x D tile whose hi and lo halves are at bh and bl, offset to this
// lane's rows 2t, 2t + 1 and column g; 3xTF32, cross terms first.
template <int NS, int NO, int DP>
__device__ __forceinline__ void tf32x3_times_tile(float (&part)[NO][4],
                                                  const float (&a)[NS][4],
                                                  const float* bh,
                                                  const float* bl) {
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    uint32_t ah[4], al[4];
    split_a8(a[j], ah, al);
    uint32_t hb[NO][2], lb[NO][2];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = (j * 8 + r) * DP + n * 8;
        hb[n][r] = __float_as_uint(bh[e]);
        lb[n][r] = __float_as_uint(bl[e]);
      }
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const uint32_t (&x)[4] = pass == 0 ? al : ah;
        const uint32_t (&y)[2] = pass == 1 ? lb[n] : hb[n];
        mma1688(part[n], x, y[0], y[1]);
      }
  }
}

// This warp's rows r0, r0 + 8 of a dkdv block's dK and dV sums (keys as
// rows; columns 2t, 2t + 1 of each 8-wide tile) into the f32 per-head
// partials part: (2, B, Sk, H, D), dK's then dV's; keys past Sk are
// dropped.
template <int D>
__device__ __forceinline__ void store_part(float* __restrict__ part,
                                           const float (&dk)[D / 8][4],
                                           const float (&dv)[D / 8][4],
                                           int B, int Sk, int H, int h, int b,
                                           int r0, int t) {
  const long long half = (long long)B * Sk * H * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    if (r >= Sk) continue;
    const long long e = (((long long)b * Sk + r) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      store2(part + e + n * 8, dk[n][2 * hr], dk[n][2 * hr + 1]);
      store2(part + half + e + n * 8, dv[n][2 * hr], dv[n][2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------------------
// bfloat16
// ---------------------------------------------------------------------

template <int D>
__device__ __forceinline__ void dq_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ o,
    const float* __restrict__ lse, const bf16* __restrict__ dout,
    bf16* __restrict__ dq, float* __restrict__ delta, int Sq, int Sk, int H,
    int Hkv, int causal, int window, float scale) {
  using Tile = BwdTile<D, bf16>;
  constexpr int DP = Tile::DP, BQ = kBlock, BK = Tile::BS;
  constexpr int CH = D / 8;            // 16-byte chunks per row
  constexpr int RS = kThreads / CH;    // rows per pass of the copies
  constexpr int KD = D / 16;           // k-steps of S and dP
  constexpr int NS = BK / 8;           // 8-key column tiles of S
  constexpr int NO = D / 8;            // 8-wide column tiles of dQ
  static_assert(kThreads % CH == 0 && BK % RS == 0 && BQ % RS == 0 &&
                D % 16 == 0 && BK % 16 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(bwd_smem);  // BQ x DP
  bf16* dOs = Qs + BQ * DP;                      // BQ x DP
  bf16* Ks = dOs + BQ * DP;                      // 2 stages x BK x DP
  bf16* Vs = Ks + 2 * BK * DP;                   // 2 stages x BK x DP
  __shared__ float delta_s[BQ];

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - int(blockIdx.x)) * BQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31;
  const int wr = (tid >> 5) * 16;  // the warp's first row in the tile
  const int g = lane >> 2, t = lane & 3;
  const int off = Sk - Sq;  // query row i sits at i + off
  const long long qs = (long long)H * D, ks = (long long)Hkv * D;
  const long long qbase = (long long)b * Sq * qs + (long long)h * D;
  const long long kbase = (long long)b * Sk * ks + (long long)hk * D;
  const long long rbase = ((long long)b * H + h) * Sq;  // lse, delta rows

  // Copies: this thread moves the 16 bytes at column cc of rows cr,
  // cr + RS, ...; rows past the end are zero-filled, their addresses kept
  // inside the tensor.
  const int cr = tid / CH, cc = (tid % CH) * 8;
#pragma unroll
  for (int i = 0; i < BQ / RS; ++i) {
    const int r = cr + i * RS;
    const long long e = qbase + (long long)min(q0 + r, Sq - 1) * qs + cc;
    cp_async16(smem_addr(Qs + r * DP + cc), q + e, q0 + r < Sq);
    cp_async16(smem_addr(dOs + r * DP + cc), dout + e, q0 + r < Sq);
  }
  cp_async_commit();
  const uint32_t kdst = smem_addr(Ks + cr * DP + cc);
  const uint32_t vdst = smem_addr(Vs + cr * DP + cc);
  auto load_kv = [&](int k0, int stage) {
#pragma unroll
    for (int i = 0; i < BK / RS; ++i) {
      const int r = k0 + cr + i * RS;
      const long long e = kbase + (long long)min(r, Sk - 1) * ks + cc;
      const uint32_t d = uint32_t((stage * BK + i * RS) * DP * sizeof(bf16));
      cp_async16(kdst + d, k + e, r < Sk);
      cp_async16(vdst + d, v + e, r < Sk);
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

  {
    // delta = rowsum(dO o O): two threads a row, D / 2 columns each from
    // device memory, then one shuffle (a fixed order)
    const int r = tid >> 1;
    float s = 0.f;
    if (q0 + r < Sq) {
      const long long e = qbase + (long long)(q0 + r) * qs + (tid & 1) * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8)
        s = dot8(*reinterpret_cast<const uint4*>(dout + e + c),
                 *reinterpret_cast<const uint4*>(o + e + c), s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = s;
      if (q0 + r < Sq) delta[rbase + q0 + r] = s;
    }
  }
  // this lane's rows' lse in base 2; rows past Sq get +inf, so P = 0
  float lse_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + wr + g + 8 * hr;
    lse_r[hr] = r < Sq ? lse[rbase + r] * kLog2e : INFINITY;
  }
  cp_async_wait<1>();  // Q and dO have landed; the first K/V tile may fly
  __syncthreads();
  // Q and dO as A fragments, kept in registers
  uint32_t qf[KD][4], df[KD][4];
  {
    const int a = (wr + (lane & 15)) * DP + (lane >> 4) * 8;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      ldsm_x4(qf[kd], smem_addr(Qs + a + kd * 16));
      ldsm_x4(df[kd], smem_addr(dOs + a + kd * 16));
    }
  }
  const float delta_r[2] = {delta_s[wr + g], delta_s[wr + g + 8]};
  const float scale_log2 = scale * kLog2e;

  // ldmatrix row addresses of stage 0: K and V as the B operands of S and
  // dP (key lane % 8 + 8 (lane / 16), d 8 (lane / 8 % 2)); K transposed
  // as the B operand of dS K (key lane % 8 + 8 (lane / 8 % 2), d 8 (lane /
  // 16)).
  constexpr uint32_t kStage = uint32_t(BK * DP * sizeof(bf16));
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * DP + ((lane >> 3) & 1) * 8;
  const int t_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * DP + (lane >> 4) * 8;
  const uint32_t kb_ld = smem_addr(Ks + b_off), vb_ld = smem_addr(Vs + b_off);
  const uint32_t kt_ld = smem_addr(Ks + t_off);

  float acc[NO][4];  // dQ / scale
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = (kt0 + it) * BK;
    const int stage = it & 1;
    if (it + 1 < n_kt) load_kv(k0 + BK, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const uint32_t so = stage * kStage;

    // S = Q K^T and dP = dO V^T, one bf16 pass each
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        const uint32_t o_ = so + uint32_t((np * 16 * DP + kd * 16) * sizeof(bf16));
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, kb_ld + o_);
        ldsm_x4(vf, vb_ld + o_);
        mma16816(s[2 * np], qf[kd], kf[0], kf[1]);
        mma16816(s[2 * np + 1], qf[kd], kf[2], kf[3]);
        mma16816(dp[2 * np], df[kd], vf[0], vf[1]);
        mma16816(dp[2 * np + 1], df[kd], vf[2], vf[3]);
      }

    // P, then dS = P (dP - delta) in dp; the mask (S = -inf, so P = 0)
    // element by element only where it cuts into this tile for some row of
    // the warp
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + wr + off) ||
        (window && k0 <= q0 + wr + 15 + off - window))
      mask_rows<NS>(s, q0 + wr + g + off, k0 + 2 * t, Sk, causal, window);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2_ftz(s[j][2 * hr + c] * scale_log2 - lse_r[hr]);
          dp[j][2 * hr + c] = p * (dp[j][2 * hr + c] - delta_r[hr]);
        }

    // dQ += dS K, dS split into bf16 hi and lo halves: this tile's product
    // in fresh registers, then one f32 add
    float part[NO][4];
    bf16x2_times_tile<BK / 16, NO, DP>(part, dp, kt_ld + so);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i];
    __syncthreads();  // this stage is read; the next-but-one load reuses it
  }

  bf16* dqb = dq + qbase;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + wr + g + 8 * hr;
    if (r >= Sq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(dqb + r * qs + n * 8 + 2 * t, scale * acc[n][2 * hr],
             scale * acc[n][2 * hr + 1]);
  }
}

template <int D>
__device__ __forceinline__ void dkdv_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ lse,
    const float* __restrict__ delta, const bf16* __restrict__ dout,
    float* __restrict__ part, int B, int Sq, int Sk, int H, int Hkv,
    int causal, int window, float scale) {
  using Tile = BwdTile<D, bf16>;
  constexpr int DP = Tile::DP, BK = kBlock, BQ = Tile::BS;
  constexpr int CH = D / 8, RS = kThreads / CH;
  constexpr int KD = D / 16;           // k-steps of S^T and dP^T
  constexpr int NS = BQ / 8;           // 8-query column tiles of S^T
  constexpr int NO = D / 8;            // 8-wide column tiles of dK, dV
  static_assert(kThreads % CH == 0 && BK % RS == 0 && BQ % RS == 0 &&
                kThreads >= 2 * BQ && BQ % 16 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(bwd_smem);  // BK x DP
  bf16* Vs = Ks + BK * DP;                       // BK x DP
  bf16* Qs = Vs + BK * DP;                       // 2 stages x BQ x DP
  bf16* dOs = Qs + 2 * BQ * DP;                  // 2 stages x BQ x DP
  __shared__ float lse_s[2][BQ], delta_s[2][BQ];

  const int k0 = blockIdx.x * BK;  // causal: the heaviest tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31;
  const int wk = (tid >> 5) * 16;  // the warp's first key in the tile
  const int g = lane >> 2, t = lane & 3;
  const int off = Sk - Sq;
  const long long qs = (long long)H * D, ks = (long long)Hkv * D;
  const long long kbase = (long long)b * Sk * ks + (long long)hk * D;
  const long long qbase = (long long)b * Sq * qs + (long long)h * D;
  const long long rbase = ((long long)b * H + h) * Sq;

  const int cr = tid / CH, cc = (tid % CH) * 8;
#pragma unroll
  for (int i = 0; i < BK / RS; ++i) {
    const int r = cr + i * RS;
    const long long e = kbase + (long long)min(k0 + r, Sk - 1) * ks + cc;
    cp_async16(smem_addr(Ks + r * DP + cc), k + e, k0 + r < Sk);
    cp_async16(smem_addr(Vs + r * DP + cc), v + e, k0 + r < Sk);
  }
  cp_async_commit();

  // the query rows any key of this tile is kept by, in whole tiles
  const int q_begin = causal ? max(0, k0 - off) : 0;
  const int q_end = window ? min(Sq, k0 + BK - 1 + window - off) : Sq;
  const int qt0 = q_begin / BQ;
  const int n_qt = q_end > q_begin ? (q_end + BQ - 1) / BQ - qt0 : 0;
  const uint32_t qdst = smem_addr(Qs + cr * DP + cc);
  const uint32_t ddst = smem_addr(dOs + cr * DP + cc);
  auto load_q = [&](int q0, int stage) {
#pragma unroll
    for (int i = 0; i < BQ / RS; ++i) {
      const int r = q0 + cr + i * RS;
      const long long e = qbase + (long long)min(r, Sq - 1) * qs + cc;
      const uint32_t d = uint32_t((stage * BQ + i * RS) * DP * sizeof(bf16));
      cp_async16(qdst + d, q + e, r < Sq);
      cp_async16(ddst + d, dout + e, r < Sq);
    }
    if (tid < 2 * BQ) {  // the tile's lse and delta, one float a thread
      const int r = tid % BQ;
      const long long e = rbase + min(q0 + r, Sq - 1);
      if (tid < BQ)
        cp_async4(smem_addr(&lse_s[stage][r]), lse + e, q0 + r < Sq);
      else
        cp_async4(smem_addr(&delta_s[stage][r]), delta + e, q0 + r < Sq);
    }
  };
  if (n_qt > 0) load_q(qt0 * BQ, 0);
  cp_async_commit();
  cp_async_wait<1>();  // K and V have landed
  __syncthreads();
  // K and V as A fragments (this warp's 16 keys), read from shared memory
  // at each k-step: held in registers, they pushed dkdv to 255 registers
  // and a spill
  const int a_off = (wk + (lane & 15)) * DP + (lane >> 4) * 8;
  const uint32_t ka_ld = smem_addr(Ks + a_off), va_ld = smem_addr(Vs + a_off);
  const float scale_log2 = scale * kLog2e;

  // Q and dO as the B operands of S^T and dP^T (query lane % 8 + 8 (lane /
  // 16), d 8 (lane / 8 % 2)), and transposed as those of dS^T Q and P^T dO
  // (query lane % 8 + 8 (lane / 8 % 2), d 8 (lane / 16)); stage 0
  constexpr uint32_t kStage = uint32_t(BQ * DP * sizeof(bf16));
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * DP + ((lane >> 3) & 1) * 8;
  const int t_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * DP + (lane >> 4) * 8;
  const uint32_t qb_ld = smem_addr(Qs + b_off), ob_ld = smem_addr(dOs + b_off);
  const uint32_t qt_ld = smem_addr(Qs + t_off), ot_ld = smem_addr(dOs + t_off);

  float dk_acc[NO][4], dv_acc[NO][4];  // dK / scale, dV
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;

  for (int it = 0; it < n_qt; ++it) {
    const int stage = it & 1;
    const int q0 = (qt0 + it) * BQ;
    if (it + 1 < n_qt) load_q(q0 + BQ, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const uint32_t so = stage * kStage;

    // S^T = K Q^T and dP^T = V dO^T: keys as rows, queries as columns
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t kf[4], vf[4];
      ldsm_x4(kf, ka_ld + uint32_t(kd * 16 * sizeof(bf16)));
      ldsm_x4(vf, va_ld + uint32_t(kd * 16 * sizeof(bf16)));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        const uint32_t o_ = so + uint32_t((np * 16 * DP + kd * 16) * sizeof(bf16));
        uint32_t qb[4], ob[4];
        ldsm_x4(qb, qb_ld + o_);
        ldsm_x4(ob, ob_ld + o_);
        mma16816(st[2 * np], kf, qb[0], qb[1]);
        mma16816(st[2 * np + 1], kf, qb[2], qb[3]);
        mma16816(dpt[2 * np], vf, ob[0], ob[1]);
        mma16816(dpt[2 * np + 1], vf, ob[2], ob[3]);
      }
    }

    // P^T in st, dS^T in dpt; the mask element by element only where it
    // cuts into this tile for some key of the warp (the diagonal, the
    // window edge, Sq).  Keys past Sk read zeros and their rows are never
    // written.
    if (q0 + BQ > Sq || (causal && k0 + wk + 15 > q0 + off) ||
        (window && k0 + wk <= q0 + BQ - 1 + off - window))
      mask_cols<NS>(st, k0 + wk + g, q0 + 2 * t, Sq, off, causal, window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qc = j * 8 + 2 * t + c;
        const float l = lse_s[stage][qc] * kLog2e, dl = delta_s[stage][qc];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float p = exp2_ftz(st[j][2 * hr + c] * scale_log2 - l);
          st[j][2 * hr + c] = p;
          dpt[j][2 * hr + c] = p * (dpt[j][2 * hr + c] - dl);
        }
      }

    // dV += P^T dO, then dK += dS^T Q, P and dS split into bf16 hi and lo
    // halves: each tile's product in fresh registers, then one f32 add
    float pt[NO][4];
    bf16x2_times_tile<BQ / 16, NO, DP>(pt, st, ot_ld + so);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dv_acc[n][i] += pt[n][i];
    bf16x2_times_tile<BQ / 16, NO, DP>(pt, dpt, qt_ld + so);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dk_acc[n][i] += pt[n][i];
    __syncthreads();  // this stage is read; the next-but-one load reuses it
  }
  store_part<D>(part, dk_acc, dv_acc, B, Sk, H, h, b, k0 + wk + g, t);
}

// ---------------------------------------------------------------------
// float32: 3xTF32
// ---------------------------------------------------------------------

template <int D>
__device__ __forceinline__ void dq_tf32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ o,
    const float* __restrict__ lse, const float* __restrict__ dout,
    float* __restrict__ dq, float* __restrict__ delta, int Sq, int Sk, int H,
    int Hkv, int causal, int window, float scale) {
  using Tile = BwdTile<D, float>;
  constexpr int DP = Tile::DP, BQ = kBlock, BK = Tile::BS;
  constexpr int CH = D / 4;            // 16-byte chunks per row
  constexpr int RS = kThreads / CH;    // rows per pass of the copies
  constexpr int KD = D / 8;            // k-steps of S and dP
  constexpr int NS = BK / 8;           // 8-key tiles of S = k-steps of dS K
  constexpr int NO = D / 8;            // 8-wide column tiles of dQ
  static_assert(kThreads % CH == 0 && BK % RS == 0 && BK % 16 == 0 &&
                D % 8 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* Qs = reinterpret_cast<float*>(bwd_smem);  // BQ x DP, scaled
  float* dOs = Qs + BQ * DP;                       // BQ x DP
  float* Ks = dOs + BQ * DP;      // 2 stages x BK x DP (hi halves once split)
  float* Vs = Ks + 2 * BK * DP;   // 2 stages x BK x DP
  float* Kl = Vs + 2 * BK * DP;   // BK x DP, lo halves of this tile's K
  float* Vl = Kl + BK * DP;       // BK x DP, lo halves of this tile's V
  __shared__ float delta_s[BQ];

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - int(blockIdx.x)) * BQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31;
  const int wr = (tid >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int off = Sk - Sq;
  const long long qs = (long long)H * D, ks = (long long)Hkv * D;
  const long long qbase = (long long)b * Sq * qs + (long long)h * D;
  const long long kbase = (long long)b * Sk * ks + (long long)hk * D;
  const long long rbase = ((long long)b * H + h) * Sq;

  const int cr = tid / CH, cc = (tid % CH) * 4;
  const uint32_t kdst = smem_addr(Ks + cr * DP + cc);
  const uint32_t vdst = smem_addr(Vs + cr * DP + cc);
  auto load_kv = [&](int k0, int stage) {
#pragma unroll
    for (int i = 0; i < BK / RS; ++i) {
      const int r = k0 + cr + i * RS;
      const long long e = kbase + (long long)min(r, Sk - 1) * ks + cc;
      const uint32_t d = uint32_t((stage * BK + i * RS) * DP * sizeof(float));
      cp_async16(kdst + d, k + e, r < Sk);
      cp_async16(vdst + d, v + e, r < Sk);
    }
  };
  const int qa_lo = q0 + off;
  const int qa_hi = min(q0 + BQ, Sq) - 1 + off;
  const int k_begin = window ? max(0, qa_lo - window + 1) : 0;
  const int k_end = causal ? min(Sk, qa_hi + 1) : Sk;
  const int kt0 = k_begin / BK;
  const int n_kt = (k_end + BK - 1) / BK - kt0;
  if (n_kt > 0) load_kv(kt0 * BK, 0);
  cp_async_commit();

  {
    // Q times the scale (as the plain version computes it) and dO into
    // shared memory, and delta = rowsum(dO o O): two threads a row, D / 2
    // columns each, then one shuffle (a fixed order)
    const int r = tid >> 1, c0 = (tid & 1) * (D / 2);
    const bool in = q0 + r < Sq;
    const long long e = qbase + (long long)min(q0 + r, Sq - 1) * qs + c0;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < D / 2; c += 4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x, z = x;
      if (in) {
        x = *reinterpret_cast<const float4*>(q + e + c);
        y = *reinterpret_cast<const float4*>(dout + e + c);
        z = *reinterpret_cast<const float4*>(o + e + c);
      }
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
      *reinterpret_cast<float4*>(Qs + r * DP + c0 + c) = x;
      *reinterpret_cast<float4*>(dOs + r * DP + c0 + c) = y;
      s = fmaf(y.x, z.x, s);
      s = fmaf(y.y, z.y, s);
      s = fmaf(y.z, z.z, s);
      s = fmaf(y.w, z.w, s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = s;
      if (in) delta[rbase + q0 + r] = s;
    }
  }
  float lse_r[2];  // rows past Sq get +inf, so P = 0
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + wr + g + 8 * hr;
    lse_r[hr] = r < Sq ? lse[rbase + r] : INFINITY;
  }
  __syncthreads();
  const float delta_r[2] = {delta_s[wr + g], delta_s[wr + g + 8]};

  // ldmatrix on f32 rows read as pairs of b16: an 8x8 b16 matrix is 8 rows
  // of 4 floats, and lane i receives row i / 4, float i % 4 -- the m16n8k8
  // tf32 layouts.  Q's and dO's A fragments of k-step kd (split as read):
  // row i % 8 + 8 (i / 8 % 2), column 4 (i / 16).  K's and V's B
  // fragments of two 8-key tiles: key i % 8 + 8 (i / 16), d 4 (i / 8 % 2),
  // hi and lo halves from their two arrays.
  const int a_off = (wr + (lane & 7) + ((lane >> 3) & 1) * 8) * DP + (lane >> 4) * 4;
  const uint32_t qa_ld = smem_addr(Qs + a_off), da_ld = smem_addr(dOs + a_off);
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * DP + ((lane >> 3) & 1) * 4;
  const uint32_t kh_ld = smem_addr(Ks + b_off), kl_ld = smem_addr(Kl + b_off);
  const uint32_t vh_ld = smem_addr(Vs + b_off), vl_ld = smem_addr(Vl + b_off);
  constexpr uint32_t kStage = uint32_t(BK * DP * sizeof(float));
  // K's B fragment of dS K: keys 2t, 2t + 1 of the k-step, column g
  const int t_off = 2 * t * DP + g;

  float acc[NO][4];  // dQ / scale
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
    // without a barrier): hi in place, lo beside, once for the block.
#pragma unroll
    for (int i = 0; i < BK / RS; ++i) {
      const int r = (cr + i * RS) * DP + cc;
      split_rna_4(Ks + stage * BK * DP + r, Kl + r);
      split_rna_4(Vs + stage * BK * DP + r, Vl + r);
    }
    __syncthreads();
    const uint32_t so = stage * kStage;

    // S = (scale Q) K^T and dP = dO V^T: per k-step the three products of
    // every 8-key tile, cross terms first
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t x[4], qh[4], ql[4], dh[4], dl[4];
      ldsm_x4(x, qa_ld + uint32_t(kd * 8 * sizeof(float)));
      split_rna(x, qh, ql);
      ldsm_x4(x, da_ld + uint32_t(kd * 8 * sizeof(float)));
      split_rna(x, dh, dl);
      uint32_t kh[NS / 2][4], kl[NS / 2][4], vh[NS / 2][4], vl[NS / 2][4];
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        const uint32_t o_ = uint32_t((np * 16 * DP + kd * 8) * sizeof(float));
        ldsm_x4(kh[np], kh_ld + so + o_);
        ldsm_x4(kl[np], kl_ld + o_);
        ldsm_x4(vh[np], vh_ld + so + o_);
        ldsm_x4(vl[np], vl_ld + o_);
      }
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          const uint32_t (&a)[4] = pass == 0 ? ql : qh;
          const uint32_t (&bk)[4] = pass == 1 ? kl[np] : kh[np];
          mma1688(s[2 * np], a, bk[0], bk[1]);
          mma1688(s[2 * np + 1], a, bk[2], bk[3]);
          const uint32_t (&c)[4] = pass == 0 ? dl : dh;
          const uint32_t (&bv)[4] = pass == 1 ? vl[np] : vh[np];
          mma1688(dp[2 * np], c, bv[0], bv[1]);
          mma1688(dp[2 * np + 1], c, bv[2], bv[3]);
        }
    }

    if (k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + wr + off) ||
        (window && k0 <= q0 + wr + 15 + off - window))
      mask_rows<NS>(s, q0 + wr + g + off, k0 + 2 * t, Sk, causal, window);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = expf(s[j][2 * hr + c] - lse_r[hr]);
          dp[j][2 * hr + c] = p * (dp[j][2 * hr + c] - delta_r[hr]);
        }

    // dQ += dS K: this tile's product in fresh registers, then one f32 add
    float part[NO][4];
    tf32x3_times_tile<NS, NO, DP>(part, dp, Ks + stage * BK * DP + t_off,
                                  Kl + t_off);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i];
    __syncthreads();  // this tile is read: the next split and the
                      // next-but-one load reuse its space
  }

  float* dqb = dq + qbase;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + wr + g + 8 * hr;
    if (r >= Sq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(dqb + r * qs + n * 8 + 2 * t, scale * acc[n][2 * hr],
             scale * acc[n][2 * hr + 1]);
  }
}

template <int D>
__device__ __forceinline__ void dkdv_tf32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ dout,
    float* __restrict__ part, int B, int Sq, int Sk, int H, int Hkv,
    int causal, int window, float scale) {
  using Tile = BwdTile<D, float>;
  constexpr int DP = Tile::DP, BK = kBlock, BQ = Tile::BS;
  constexpr int CH = D / 4, RS = kThreads / CH;
  constexpr int KD = D / 8;            // k-steps of S^T and dP^T
  constexpr int NS = BQ / 8;           // 8-query tiles of S^T = k-steps of
                                       // P^T dO and dS^T Q
  constexpr int NO = D / 8;            // 8-wide column tiles of dK, dV
  static_assert(kThreads % CH == 0 && BK % RS == 0 && BQ % RS == 0 &&
                kThreads >= 2 * BQ && BQ % 16 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* Ks = reinterpret_cast<float*>(bwd_smem);  // BK x DP
  float* Vs = Ks + BK * DP;                        // BK x DP
  float* Qs = Vs + BK * DP;     // 2 stages x BQ x DP (scaled hi once split)
  float* dOs = Qs + 2 * BQ * DP;  // 2 stages x BQ x DP (hi once split)
  float* Ql = dOs + 2 * BQ * DP;  // BQ x DP, lo halves of this tile's Q
  float* dOl = Ql + BQ * DP;      // BQ x DP, lo halves of this tile's dO
  __shared__ float lse_s[2][BQ], delta_s[2][BQ];

  const int k0 = blockIdx.x * BK;  // causal: the heaviest tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31;
  const int wk = (tid >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int off = Sk - Sq;
  const long long qs = (long long)H * D, ks = (long long)Hkv * D;
  const long long kbase = (long long)b * Sk * ks + (long long)hk * D;
  const long long qbase = (long long)b * Sq * qs + (long long)h * D;
  const long long rbase = ((long long)b * H + h) * Sq;

  const int cr = tid / CH, cc = (tid % CH) * 4;
#pragma unroll
  for (int i = 0; i < BK / RS; ++i) {
    const int r = cr + i * RS;
    const long long e = kbase + (long long)min(k0 + r, Sk - 1) * ks + cc;
    cp_async16(smem_addr(Ks + r * DP + cc), k + e, k0 + r < Sk);
    cp_async16(smem_addr(Vs + r * DP + cc), v + e, k0 + r < Sk);
  }
  cp_async_commit();

  const int q_begin = causal ? max(0, k0 - off) : 0;
  const int q_end = window ? min(Sq, k0 + BK - 1 + window - off) : Sq;
  const int qt0 = q_begin / BQ;
  const int n_qt = q_end > q_begin ? (q_end + BQ - 1) / BQ - qt0 : 0;
  const uint32_t qdst = smem_addr(Qs + cr * DP + cc);
  const uint32_t ddst = smem_addr(dOs + cr * DP + cc);
  auto load_q = [&](int q0, int stage) {
#pragma unroll
    for (int i = 0; i < BQ / RS; ++i) {
      const int r = q0 + cr + i * RS;
      const long long e = qbase + (long long)min(r, Sq - 1) * qs + cc;
      const uint32_t d = uint32_t((stage * BQ + i * RS) * DP * sizeof(float));
      cp_async16(qdst + d, q + e, r < Sq);
      cp_async16(ddst + d, dout + e, r < Sq);
    }
    if (tid < 2 * BQ) {
      const int r = tid % BQ;
      const long long e = rbase + min(q0 + r, Sq - 1);
      if (tid < BQ)
        cp_async4(smem_addr(&lse_s[stage][r]), lse + e, q0 + r < Sq);
      else
        cp_async4(smem_addr(&delta_s[stage][r]), delta + e, q0 + r < Sq);
    }
  };
  if (n_qt > 0) load_q(qt0 * BQ, 0);
  cp_async_commit();
  cp_async_wait<1>();  // K and V have landed
  __syncthreads();

  // K's and V's A fragments (this warp's keys; split as read), Q's and
  // dO's B fragments of S^T and dP^T (two 8-query tiles per ldmatrix, hi
  // and lo from their two arrays), and their B fragments of dS^T Q and
  // P^T dO (queries 2t, 2t + 1 of the k-step, column g; plain loads)
  const int a_off = (wk + (lane & 7) + ((lane >> 3) & 1) * 8) * DP + (lane >> 4) * 4;
  const uint32_t ka_ld = smem_addr(Ks + a_off), va_ld = smem_addr(Vs + a_off);
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * DP + ((lane >> 3) & 1) * 4;
  const uint32_t qh_ld = smem_addr(Qs + b_off), ql_ld = smem_addr(Ql + b_off);
  const uint32_t oh_ld = smem_addr(dOs + b_off), ol_ld = smem_addr(dOl + b_off);
  constexpr uint32_t kStage = uint32_t(BQ * DP * sizeof(float));
  const int t_off = 2 * t * DP + g;

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;

  for (int it = 0; it < n_qt; ++it) {
    const int stage = it & 1;
    const int q0 = (qt0 + it) * BQ;
    if (it + 1 < n_qt) load_q(q0 + BQ, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of this tile have landed
    // Q times the scale, and dO, split: hi in place, lo beside
#pragma unroll
    for (int i = 0; i < BQ / RS; ++i) {
      const int r = (cr + i * RS) * DP + cc;
      split_rna_4(Qs + stage * BQ * DP + r, Ql + r, scale);
      split_rna_4(dOs + stage * BQ * DP + r, dOl + r);
    }
    __syncthreads();
    const uint32_t so = stage * kStage;

    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t x[4], kh[4], kl[4], vh[4], vl[4];
      ldsm_x4(x, ka_ld + uint32_t(kd * 8 * sizeof(float)));
      split_rna(x, kh, kl);
      ldsm_x4(x, va_ld + uint32_t(kd * 8 * sizeof(float)));
      split_rna(x, vh, vl);
      uint32_t qh[NS / 2][4], ql[NS / 2][4], oh[NS / 2][4], ol[NS / 2][4];
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        const uint32_t o_ = uint32_t((np * 16 * DP + kd * 8) * sizeof(float));
        ldsm_x4(qh[np], qh_ld + so + o_);
        ldsm_x4(ql[np], ql_ld + o_);
        ldsm_x4(oh[np], oh_ld + so + o_);
        ldsm_x4(ol[np], ol_ld + o_);
      }
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          const uint32_t (&a)[4] = pass == 0 ? kl : kh;
          const uint32_t (&bq)[4] = pass == 1 ? ql[np] : qh[np];
          mma1688(st[2 * np], a, bq[0], bq[1]);
          mma1688(st[2 * np + 1], a, bq[2], bq[3]);
          const uint32_t (&c)[4] = pass == 0 ? vl : vh;
          const uint32_t (&bo)[4] = pass == 1 ? ol[np] : oh[np];
          mma1688(dpt[2 * np], c, bo[0], bo[1]);
          mma1688(dpt[2 * np + 1], c, bo[2], bo[3]);
        }
    }

    if (q0 + BQ > Sq || (causal && k0 + wk + 15 > q0 + off) ||
        (window && k0 + wk <= q0 + BQ - 1 + off - window))
      mask_cols<NS>(st, k0 + wk + g, q0 + 2 * t, Sq, off, causal, window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qc = j * 8 + 2 * t + c;
        const float l = lse_s[stage][qc], dl = delta_s[stage][qc];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float p = expf(st[j][2 * hr + c] - l);
          st[j][2 * hr + c] = p;
          dpt[j][2 * hr + c] = p * (dpt[j][2 * hr + c] - dl);
        }
      }

    // dV += P^T dO, then dK += dS^T (scale Q): each tile's product in
    // fresh registers, then one f32 add
    float pt[NO][4];
    tf32x3_times_tile<NS, NO, DP>(pt, st, dOs + stage * BQ * DP + t_off,
                                  dOl + t_off);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dv_acc[n][i] += pt[n][i];
    tf32x3_times_tile<NS, NO, DP>(pt, dpt, Qs + stage * BQ * DP + t_off,
                                  Ql + t_off);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dk_acc[n][i] += pt[n][i];
    __syncthreads();  // this tile is read: the next split and the
                      // next-but-one load reuse its space
  }
  store_part<D>(part, dk_acc, dv_acc, B, Sk, H, h, b, k0 + wk + g, t);
}

// ---------------------------------------------------------------------
// The two kernels, by element type
// ---------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, BwdTile<D, T>::kDqBlocks)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const float* __restrict__ lse, const T* __restrict__ dout,
             T* __restrict__ dq, float* __restrict__ delta, int Sq, int Sk,
             int H, int Hkv, int causal, int window, float scale) {
  if constexpr (std::is_same<T, float>::value)
    dq_tf32<D>(q, k, v, o, lse, dout, dq, delta, Sq, Sk, H, Hkv, causal,
               window, scale);
  else
    dq_bf16<D>(q, k, v, o, lse, dout, dq, delta, Sq, Sk, H, Hkv, causal,
               window, scale);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ lse,
               const float* __restrict__ delta, const T* __restrict__ dout,
               float* __restrict__ part, int B, int Sq, int Sk, int H,
               int Hkv, int causal, int window, float scale) {
  if constexpr (std::is_same<T, float>::value)
    dkdv_tf32<D>(q, k, v, lse, delta, dout, part, B, Sq, Sk, H, Hkv, causal,
                 window, scale);
  else
    dkdv_bf16<D>(q, k, v, lse, delta, dout, part, B, Sq, Sk, H, Hkv, causal,
                 window, scale);
}

// dK and dV: each KV head's G per-head partials summed in head order (a
// fixed order), dK times dk_scale, rounded once to T.  One thread per 4
// consecutive columns of a (batch, key, KV head) row.
template <int D, typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_sum(const float* __restrict__ part, T* __restrict__ dk,
                   T* __restrict__ dv, int B, int Sk, int H, int Hkv,
                   float dk_scale) {
  constexpr int C4 = D / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * Sk * Hkv * C4) return;
  const int G = H / Hkv;
  const long long r = i / C4;  // (b Sk + key) Hkv + hk
  const int c = int(i % C4) * 4, hk = int(r % Hkv);
  const long long src = ((r / Hkv) * H + (long long)hk * G) * D + c;
  const long long half = (long long)B * Sk * H * D;
  float4 sk = *reinterpret_cast<const float4*>(part + src);
  float4 sv = *reinterpret_cast<const float4*>(part + half + src);
  for (int hh = 1; hh < G; ++hh) {
    const float4 a = *reinterpret_cast<const float4*>(part + src + hh * D);
    const float4 b = *reinterpret_cast<const float4*>(part + half + src + hh * D);
    sk.x += a.x;
    sk.y += a.y;
    sk.z += a.z;
    sk.w += a.w;
    sv.x += b.x;
    sv.y += b.y;
    sv.z += b.z;
    sv.w += b.w;
  }
  store2(dk + r * D + c, dk_scale * sk.x, dk_scale * sk.y);
  store2(dk + r * D + c + 2, dk_scale * sk.z, dk_scale * sk.w);
  store2(dv + r * D + c, sv.x, sv.y);
  store2(dv + r * D + c + 2, sv.z, sv.w);
}

template <int D, typename T>
cudaError_t launch_bwd(const void* q_, const void* k_, const void* v_,
                       const void* o_, const float* lse, const void* dout_,
                       void* dq_, void* dk_, void* dv_, float* delta,
                       float* part, int B, int Sq, int Sk, int H, int Hkv,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  const T *q = static_cast<const T*>(q_), *k = static_cast<const T*>(k_),
          *v = static_cast<const T*>(v_), *o = static_cast<const T*>(o_),
          *dout = static_cast<const T*>(dout_);
  T *dq = static_cast<T*>(dq_), *dk = static_cast<T*>(dk_),
    *dv = static_cast<T*>(dv_);
  constexpr int smem = int(BwdTile<D, T>::kSmem);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<D, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq<D, T><<<dim3((Sq + kBlock - 1) / kBlock, H, B), kThreads, smem,
                       stream>>>(q, k, v, o, lse, dout, dq, delta, Sq, Sk, H,
                                 Hkv, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<D, T><<<dim3((Sk + kBlock - 1) / kBlock, H, B), kThreads,
                         smem, stream>>>(q, k, v, lse, delta, dout, part, B,
                                         Sq, Sk, H, Hkv, causal, window,
                                         scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the bf16 kernel sums dK / scale; the f32 kernel's Q was scaled
  const long long n = (long long)B * Sk * Hkv * (D / 4);
  flash_bwd_dkdv_sum<D, T><<<unsigned((n + 255) / 256), 256, 0, stream>>>(
      part, dk, dv, B, Sk, H, Hkv, std::is_same<T, float>::value ? 1.f : scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the type of q, k, v, o, dout and of
// dq, dk, dv.  q, o, dout, dq: (B, Sq, H, D); k, v, dk, dv: (B, Sk, Hkv,
// D); lse: (B, H, Sq) f32; delta (B, H, Sq) and part (2, B, Sk, H, D), f32
// scratch written here; all contiguous.  Three launches (dq; the per-head
// dK and dV partials; their sum).  Returns the first failing launch's
// cudaError_t.
extern "C" int repro_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, void* part, int B, int Sq, int Sk, int H, int Hkv, int D,
    int causal, int window, float scale, void* stream) {
  if (D != 64) return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<64, float>(q, k, v, o, l, dout, dq, dk, dv, dl, pt, B,
                                 Sq, Sk, H, Hkv, causal, window, scale, s);
  if (dtype == 1)
    return launch_bwd<64, __nv_bfloat16>(q, k, v, o, l, dout, dq, dk, dv, dl,
                                         pt, B, Sq, Sk, H, Hkv, causal,
                                         window, scale, s);
  return cudaErrorInvalidValue;
}
