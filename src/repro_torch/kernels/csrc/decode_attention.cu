// B5: decode attention, one query token per head against a KV cache with
// a per-row valid length, for sm_90a.
//
// Replaces the Pallas TPU kernel `decode_attention` of the JAX package
// (src/repro/kernels/decode_attention.py:66).  Plain version:
// `decode_attention_ref` in kernels/ref.py.
//
// What bounds it on the H100: bytes.  Each valid cache position is read
// once (K and V: 2 * Hkv * D elements per position and row) for about one
// flop per byte, against a ridge of ~20 flop/byte; the roof is the valid
// K/V over 3.35 TB/s.  At the serving shapes (B=8, cache 512) that roof is
// under a microsecond, so what the call costs besides the bytes -- launches,
// syncs, exposed load latency -- is what the design cuts:
//
//  * One launch per call.  The cache is cut into n_split <= 8 ranges of
//    `split_len` positions (flash-decoding: one (row, KV head) pair is far
//    too little work for 132 SMs), one block each, and the n_split blocks
//    of one (row, KV head) pair form one thread-block cluster.  Each block
//    leaves its split's partial (m, l, acc) in its own shared memory; after
//    cluster.sync() each block merges a fixed share of the G x D outputs
//    from every peer's partials, read in rank order through distributed
//    shared memory, and writes them.  No second kernel, no global scratch,
//    no per-call allocation; the fixed merge order makes two calls on the
//    same inputs agree bit for bit.
//  * Splits sized on the cluster, and empty splits cost nothing but their
//    syncs: a split past length[b] reads no K or V and weighs 0 in the
//    merge (m = -inf, l = 0).  Nothing at or past length[b] is read.
//  * Loads in flight, state in registers.  Q for the group is held in
//    registers, pre-scaled, in f32.  A lane reads 16 bytes of one key (8
//    bf16 or 4 f32), so a warp reads 32 / kLanes keys per load, and each
//    key's dot product is summed by __shfl_xor_sync within its lane group.
//    K and V go straight into registers, kSteps loads of each outstanding
//    per lane: every byte is used by one lane only, so staging through
//    shared memory would add a store, a load and a barrier per byte with no
//    reuse to gain.  The online softmax (m, l) and the lane's slice of acc
//    live in registers per query head; lane groups merge by shuffles and
//    warps once through shared memory, at the end of the split.
//  * One block serves a KV head's whole query-head group, so each cache
//    position is read once, not G times.  Register arrays need a
//    compile-time width, so the group runs in passes of GP <= 8 heads (GP =
//    G when G <= 8); a short last pass recomputes its last head rather
//    than branch in the inner loop, and stores it once.
//  * f32 math throughout (explicit fmaf in the dot products and the
//    accumulator, exponentials by ex2.approx in log2 units); bf16 caches
//    are widened in registers and the output is rounded once.
//  * Registers bound the blocks per SM, and a serving call's 320 blocks
//    need three per SM to run in one wave: ptxas is asked for three where
//    a pass's registers allow it (Tile::min_blocks).  ptxas (sm_90a, -O3,
//    chip_smoke.py prints every instance at build): the serving instances
//    decode_cluster<64, float, 3> (SmolLM-360M) 121 registers and
//    <64, bf16, 5> (Hymba-1.5B) 168, no spills.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 4;       // key loads of K and of V in flight per lane
constexpr int kMaxSplits = 8;   // the portable cluster size
constexpr int kMaxGroup = 8;    // query heads per pass

// Per (D, T): a lane reads kVec elements (16 bytes) per load, kLanes lanes
// share one key, each lane holds kEl of its D columns (kNv loads per key),
// and a warp reads kKeys keys per load.
template <int D, typename T>
struct Tile {
  static constexpr int kVec = 16 / int(sizeof(T));
  static constexpr int kLanes = D / kVec < 32 ? D / kVec : 32;
  static constexpr int kNv = D / (kVec * kLanes);
  static constexpr int kEl = kNv * kVec;
  static constexpr int kKeys = 32 / kLanes;
  // Blocks per SM asked of ptxas: 3 (at most 168 registers a thread) where
  // the registers a pass of GP heads holds across a batch -- q, acc, m, l
  // and the scores per head, the raw K and V loads -- leave room for that,
  // so the 320 blocks of a serving call run in one wave; else 1 (no cap).
  static constexpr int min_blocks(int GP) {
    return GP * (2 * kEl + 2 + kSteps) + kSteps * kNv * 8 <= 150 ? 3 : 1;
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
__device__ __forceinline__ void widen(const uint4& raw, float* out);

template <>
__device__ __forceinline__ void widen<float>(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& raw,
                                                     float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 2^x by the SFU's ex2.approx (relative error ~2^-22, far inside attn_tol's
// 3e-5; exp2f adds range handling that costs registers and time here).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Weight of a partial with max m in a merge whose max is M (both in log2
// units); an empty partial (m = -inf) weighs 0, also when every partial
// is empty.
__device__ __forceinline__ float weight(float m, float M) {
  return m == -INFINITY ? 0.f : ex2(m - M);
}

// grid (n_split, Hkv, B), cluster (n_split, 1, 1), kThreads threads.
// q, out: (B, H, D); k, v: (B, L, Hkv, D); G = H / Hkv query heads per KV
// head, in passes of GP.
template <int D, typename T, int GP>
__global__ void __launch_bounds__(kThreads, Tile<D, T>::min_blocks(GP))
decode_cluster(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ length,
               T* __restrict__ out, int L, int H, int Hkv, int split_len,
               float scale) {
  using S = Tile<D, T>;
  constexpr int kEl = S::kEl, kNv = S::kNv, kVec = S::kVec;
  constexpr int kLanes = S::kLanes, kKeys = S::kKeys;
  constexpr int kSpan = kSteps * kWarps * kKeys;   // keys per block batch

  // warp partials; warp 0's acc slot then holds the block's (the split's)
  __shared__ float ws_m[kWarps][GP], ws_l[kWarps][GP];
  __shared__ __align__(16) float ws_acc[kWarps][GP * D];
  __shared__ float part_m[GP], part_l[GP];
  float* part_acc = ws_acc[0];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = int(cluster.block_rank());
  const int n_split = int(cluster.num_blocks());
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = lane / kLanes, li = lane % kLanes;
  const int G = H / Hkv;
  const float scale_log2 = scale * 1.4426950408889634f;   // scale * log2(e)

  const int len = min(__ldg(length + b), L);
  const int start = split * split_len;
  const int stop = min(start + split_len, len);

  const long long row = (long long)Hkv * D;
  const T* kb = k + (long long)b * L * row + (long long)hk * D;
  const T* vb = v + (long long)b * L * row + (long long)hk * D;
  // this lane's columns: load nv covers [col(nv), col(nv) + kVec)
  auto col = [&](int nv) { return (nv * kLanes + li) * kVec; };

  for (int g0 = 0; g0 < G; g0 += GP) {
    float qr[GP][kEl], acc[GP][kEl], m[GP], l[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const int h = hk * G + min(g0 + g, G - 1);
      const T* qh = q + ((long long)b * H + h) * D;
#pragma unroll
      for (int nv = 0; nv < kNv; ++nv) {
        widen<T>(load16(qh + col(nv)), &qr[g][nv * kVec]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) qr[g][nv * kVec + e] *= scale_log2;
      }
#pragma unroll
      for (int e = 0; e < kEl; ++e) acc[g][e] = 0.f;
      m[g] = -INFINITY;
      l[g] = 0.f;
    }

    for (int base = start; base < stop; base += kSpan) {
      uint4 kr[kSteps][kNv], vr[kSteps][kNv];
      bool ok[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int p = base + (u * kWarps + warp) * kKeys + kg;
        ok[u] = p < stop;
#pragma unroll
        for (int nv = 0; nv < kNv; ++nv) {
          kr[u][nv] = vr[u][nv] = make_uint4(0u, 0u, 0u, 0u);
          if (ok[u]) {
            kr[u][nv] = load16(kb + (long long)p * row + col(nv));
            vr[u][nv] = load16(vb + (long long)p * row + col(nv));
          }
        }
      }
      // scores, in log2 units (q carries log2(e)), then the online softmax
      float sc[GP][kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        float kf[kEl];
#pragma unroll
        for (int nv = 0; nv < kNv; ++nv) widen<T>(kr[u][nv], &kf[nv * kVec]);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < kEl; ++e) s = fmaf(qr[g][e], kf[e], s);
#pragma unroll
          for (int o = 1; o < kLanes; o <<= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
          sc[g][u] = ok[u] ? s : -INFINITY;
        }
      }
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kSteps; ++u) mx = fmaxf(mx, sc[g][u]);
        const float mc = mx == -INFINITY ? 0.f : mx;
        const float corr = ex2(m[g] - mc);
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          sc[g][u] = ex2(sc[g][u] - mc);      // the key's weight p
          sum += sc[g][u];
        }
        l[g] = fmaf(l[g], corr, sum);
        m[g] = mx;
#pragma unroll
        for (int e = 0; e < kEl; ++e) acc[g][e] *= corr;
      }
      // P V, one key step at a time: one widened V live at once
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        float vf[kEl];
#pragma unroll
        for (int nv = 0; nv < kNv; ++nv) widen<T>(vr[u][nv], &vf[nv * kVec]);
#pragma unroll
        for (int g = 0; g < GP; ++g)
#pragma unroll
          for (int e = 0; e < kEl; ++e)
            acc[g][e] = fmaf(sc[g][u], vf[e], acc[g][e]);
      }
    }

    // lane groups of the warp, by shuffles (both lanes of a pair compute
    // the same sums, so every group ends with the warp's partial)
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float M = fmaxf(m[g], mo);
        const float wa = weight(m[g], M), wb = weight(mo, M);
        l[g] = l[g] * wa + lo * wb;
        m[g] = M;
#pragma unroll
        for (int e = 0; e < kEl; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
          acc[g][e] = acc[g][e] * wa + ao * wb;
        }
      }
    }
    if (lane < kLanes) {
#pragma unroll
      for (int g = 0; g < GP; ++g) {
#pragma unroll
        for (int nv = 0; nv < kNv; ++nv)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            ws_acc[warp][g * D + col(nv) + e] = acc[g][nv * kVec + e];
        if (lane == 0) {
          ws_m[warp][g] = m[g];
          ws_l[warp][g] = l[g];
        }
      }
    }
    __syncthreads();

    // warps, in order, into the split's partial (acc in place of warp 0's)
    for (int e = tid; e < GP * D; e += kThreads) {
      const int g = e / D;
      float M = ws_m[0][g];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) M = fmaxf(M, ws_m[w][g]);
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        a = fmaf(ws_acc[w][e], weight(ws_m[w][g], M), a);
      part_acc[e] = a;
    }
    if (tid < GP) {
      float M = ws_m[0][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) M = fmaxf(M, ws_m[w][tid]);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        s = fmaf(ws_l[w][tid], weight(ws_m[w][tid], M), s);
      part_m[tid] = M;
      part_l[tid] = s;
    }
    cluster.sync();

    // the splits, in rank order, through distributed shared memory: this
    // block merges and writes outputs [rank * kThreads, ...) by strides
    for (int e = split * kThreads + tid; e < GP * D;
         e += n_split * kThreads) {
      const int g = e / D;
      float ms[kMaxSplits], ls[kMaxSplits], as[kMaxSplits];
      float M = -INFINITY;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (s < n_split) {
          ms[s] = *cluster.map_shared_rank(&part_m[g], s);
          ls[s] = *cluster.map_shared_rank(&part_l[g], s);
          as[s] = *cluster.map_shared_rank(&part_acc[e], s);
          M = fmaxf(M, ms[s]);
        }
      }
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (s < n_split) {
          const float w = weight(ms[s], M);
          lsum = fmaf(ls[s], w, lsum);
          a = fmaf(as[s], w, a);
        }
      }
      if (g0 + g < G)
        store1(out + ((long long)b * H + hk * G + g0 + g) * D + e % D,
               a / fmaxf(lsum, 1e-30f));
    }
    cluster.sync();   // peers' partials stay alive until every read is done
  }
}

template <int D, typename T, int GP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* length, void* out, int B, int L, int H, int Hkv,
                   int split_len, float scale, cudaStream_t stream) {
  const int n_split = (L + split_len - 1) / split_len;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_cluster<D, T, GP>,
                            static_cast<const T*>(q),
                            static_cast<const T*>(k),
                            static_cast<const T*>(v), length,
                            static_cast<T*>(out), L, H, Hkv, split_len,
                            scale);
}

template <int D, typename T>
cudaError_t by_group(int GP, const void* q, const void* k, const void* v,
                     const int* length, void* out, int B, int L, int H,
                     int Hkv, int split_len, float scale,
                     cudaStream_t stream) {
#define REPRO_GP(n)                                                       \
  case n:                                                                 \
    return launch<D, T, n>(q, k, v, length, out, B, L, H, Hkv, split_len, \
                           scale, stream);
  switch (GP) {
    REPRO_GP(1) REPRO_GP(2) REPRO_GP(3) REPRO_GP(4)
    REPRO_GP(5) REPRO_GP(6) REPRO_GP(7) REPRO_GP(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_GP
}

template <typename T>
cudaError_t dispatch(int D, int GP, const void* q, const void* k,
                     const void* v, const int* length, void* out, int B,
                     int L, int H, int Hkv, int split_len, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 64:
      return by_group<64, T>(GP, q, k, v, length, out, B, L, H, Hkv,
                             split_len, scale, stream);
    case 128:
      return by_group<128, T>(GP, q, k, v, length, out, B, L, H, Hkv,
                              split_len, scale, stream);
    case 256:
      return by_group<256, T>(GP, q, k, v, length, out, B, L, H, Hkv,
                              split_len, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, out: (B, H, D); k, v: (B, L, Hkv,
// D); length: (B,) int32 with 1 <= length[b] (values past L read as L).
// The cache is cut into n = ceil(L / split_len) <= 8 splits, one cluster
// of n blocks per (row, KV head).  Writes the number of kernels it
// launched (1) to *launched and returns the launch's cudaError_t.
extern "C" int repro_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, const int* length,
                                      void* out, int B, int L, int H, int Hkv,
                                      int D, int split_len, float scale,
                                      void* stream, int* launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (split_len < 1 || (L + split_len - 1) / split_len > kMaxSplits ||
      Hkv < 1 || H % Hkv)
    return cudaErrorInvalidValue;
  const int G = H / Hkv;
  const int GP = G < kMaxGroup ? G : kMaxGroup;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = dispatch<float>(D, GP, q, k, v, length, out, B, L, H, Hkv,
                          split_len, scale, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(D, GP, q, k, v, length, out, B, L, H, Hkv,
                                  split_len, scale, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 1;
  return err;
}
