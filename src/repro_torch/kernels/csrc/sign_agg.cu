// Eq. (20) server-consensus kernels for Hopper (sm_90a):
//
//     z' = z - alpha_z * (phi_mean + psi * sum_i s_i * sign(z - w_i) / n)
//
// They replace the three Pallas TPU kernels of the JAX package's
// kernels/sign_agg.py:
//   B1 sign_agg_group<T, false> <- sign_agg (_kernel)
//   B2 sign_agg_group<T, true> <- sign_agg_weighted (_weighted_kernel)
//   B3 sign_agg_int8_group<T, kWeighted> <- sign_agg_weighted_int8
//      (_int8_kernel)
//
// Bound on the H100: bytes.  Each kernel reads the (C, D) message matrix
// once plus z and phi_mean, and writes z'; a few flops per element of W
// are far below the card's compute rate.  Every operation uses an explicit
// round-to-nearest intrinsic (no FMA contraction; the build also passes
// -fmad=false), and every thread folds its columns over the C rows
// strictly in row order, so the result equals the row-order left fold of
// the plain versions (kernels/ref.py) bit for bit.
//
// One launch updates every leaf of a parameter tree -- a round of the
// MLP_H24 forecaster has 8 leaves of 24-16,384 columns, each a few
// microseconds of launch for well under a microsecond of bytes.  The host
// passes a table of the leaves (pointers, D, each leaf's first block, a
// vector flag) by value as a __grid_constant__ parameter, at most
// kMaxLeaves leaves per launch; each block finds its leaf in it by binary
// search.  A thread owns a vector of vec_width columns where the leaf's
// four pointers are 16-byte aligned and D is a multiple of that width,
// else one column.  Every input goes through the read-only path; each
// thread loads several rows of the message before it folds them, in
// order, which changes which loads are in flight, never the order of an
// addition.
//
// B1/B2 (repro_sign_agg_group): W in z's dtype, one 16-byte vector of it
// a thread (4 f32 or 8 bf16 columns), kRows rows in flight.
// repro_sign_agg and repro_sign_agg_weighted are one-leaf calls.
//
// B3 (repro_sign_agg_int8_group): the (C, D) int8 payload in W's slot and
// the (C,) f32 scale in the weights' slot; without a scale an exact int32
// sum, with it the f32 fold acc + s_i * q_i.  A thread owns kInt8Cols
// columns (one 8-byte load a row) with kInt8Rows rows in flight: with 16
// columns a thread (one 16-byte load) the bandwidth-bound shape ran no
// faster and a round ran slower, each thread's fold and epilogue then
// being twice as long over half as many threads.  z and phi_mean are not
// needed until the epilogue, so they are read after the fold; read
// before it, they spilled.  repro_sign_agg_int8 is its one-leaf call.
//
// ptxas (sm_90a, CUDA 12.8), 256 threads and at most 64 registers a
// thread: sign_agg_group 58-64 registers, sign_agg_int8_group 62-64; no
// spills.
//
// Plain C interface for ctypes: each entry returns the cudaError_t of the
// launch (0 = success) and takes the stream as a pointer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;   // leaves per launch
constexpr int kRows = 4;         // B1/B2: rows of W loaded, then folded
constexpr int kInt8Rows = 8;     // B3: rows of the payload loaded, then folded
constexpr int kMinBlocks = 4;    // blocks per SM asked of ptxas (<= 64 regs)
constexpr int kTableCols = 7;    // z, W, phi, out, D, first block, vector
constexpr int kVecBytes = 16;    // B1/B2: a thread's vector of W, in bytes
constexpr int kInt8Cols = 8;     // B3: a thread's int8 columns, 8 bytes

// columns a thread owns on the vector path, for message rows of elem bytes
__host__ __device__ constexpr int vec_width(int elem) {
  return elem == 1 ? kInt8Cols : kVecBytes / elem;
}

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

struct Leaf {
  const void* z;
  const void* W;     // B1/B2: (C, D) in z's dtype; B3: (C, D) int8 payload
  const void* phi;
  void* out;
  long long D;
  int vec;       // 1: 16-byte vectors of columns; 0: one column a thread
  int unused;
};

struct Group {
  Leaf leaf[kMaxLeaves];
  int first[kMaxLeaves + 1];   // each leaf's first block; first[n] = grid
  int n_leaves;
  int C;
  const float* weights;        // (C,) f32 weights (B2) or scale (B3), or null
  float n;                     // the divisor: C, or n_total
  float psi;
  float alpha_z;
};
static_assert(sizeof(Group) <= 4096, "the table must fit the 4 KB of "
                                     "kernel parameters");

// this block's leaf: the last l with first[l] <= blockIdx.x
__device__ __forceinline__ int find_leaf(const Group& g, int b) {
  int lo = 0, hi = g.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (g.first[mid] <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// V columns of T as one load: a 16-byte vector, or one T
template <typename T, int V>
using Raw = typename std::conditional<V == 1, T, uint4>::type;

// through the read-only path (an L1 no-allocate hint on W's rows timed
// slower on the H100)
template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_ro(const T* p) {
  if constexpr (V == 1) {
    return __ldg(p);
  } else {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
}

// bf16 -> f32 is exact: the 16 bits become the high half
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <typename T, int V>
__device__ __forceinline__ void unpack(Raw<T, V> r, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(r);
  } else if constexpr (std::is_same<T, float>::value) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  } else {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = bf16_lo(w[k]);
      v[2 * k + 1] = bf16_hi(w[k]);
    }
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = from_f32<T>(v[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                   __float_as_uint(v[2]), __float_as_uint(v[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = bf16_bits(v[2 * k]) | (bf16_bits(v[2 * k + 1]) << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ---------------------------------------------------------------- B1/B2 --

// Columns d .. d+V-1 of one leaf: the strict row-order fold over the C
// rows, kRows rows loaded before they are folded.
template <typename T, bool kWeighted, int V>
__device__ __forceinline__ void fold_columns(const Group& g, const Leaf& L,
                                             int64_t d) {
  if (d >= L.D) return;
  const T* W = static_cast<const T*>(L.W) + d;
  float zf[V], phif[V], acc[V];
  unpack<T, V>(load_ro<T, V>(static_cast<const T*>(L.z) + d), zf);
  unpack<T, V>(load_ro<T, V>(static_cast<const T*>(L.phi) + d), phif);
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  for (int i0 = 0; i0 < g.C; i0 += kRows) {
    Raw<T, V> w[kRows];
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (i0 + r < g.C) {
        w[r] = load_ro<T, V>(W + (int64_t)(i0 + r) * L.D);
        if (kWeighted) s[r] = __ldg(g.weights + i0 + r);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (i0 + r < g.C) {
        float wv[V];
        unpack<T, V>(w[r], wv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float sg = jsign(__fsub_rn(zf[j], wv[j]));
          acc[j] = __fadd_rn(acc[j], kWeighted ? __fmul_rn(s[r], sg) : sg);
        }
      }
    }
  }
  float o[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    o[j] = epilogue(zf[j], phif[j], acc[j], g.n, g.psi, g.alpha_z);
  }
  store<T, V>(static_cast<T*>(L.out) + d, o);
}

template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sign_agg_group(const __grid_constant__ Group g) {
  const int b = (int)blockIdx.x;
  const int l = find_leaf(g, b);
  const Leaf& L = g.leaf[l];
  const int64_t t = (int64_t)(b - g.first[l]) * kThreads + threadIdx.x;
  constexpr int kVec = vec_width(sizeof(T));
  if (L.vec) {
    fold_columns<T, kWeighted, kVec>(g, L, t * kVec);
  } else {
    fold_columns<T, kWeighted, 1>(g, L, t);
  }
}

// ------------------------------------------------------------------- B3 --

// V int8 columns as one load: 8 bytes, or one byte
template <int V>
using Raw8 = typename std::conditional<V == 1, signed char, uint2>::type;

template <int V>
__device__ __forceinline__ Raw8<V> load_q(const int8_t* p) {
  static_assert(V == 1 || V == 8, "one column or one 8-byte load");
  if constexpr (V == 1) {
    return __ldg(reinterpret_cast<const signed char*>(p));
  } else {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
}

// column k of a row's load, sign-extended: exact
template <int V>
__device__ __forceinline__ int q_at(const Raw8<V>& r, int k) {
  if constexpr (V == 1) {
    return (int)r;
  } else {
    const uint32_t w = k < 4 ? r.x : r.y;
    return (int)(int8_t)(w >> (8 * (k & 3)));
  }
}

// V columns of T from p: 16-byte loads of them, or one T
template <typename T, int V>
__device__ __forceinline__ void load_cols(const T* p, float (&v)[V]) {
  constexpr int kVec = V == 1 ? 1 : vec_width(sizeof(T));
#pragma unroll
  for (int c = 0; c < V / kVec; ++c) {
    float part[kVec];
    unpack<T, kVec>(load_ro<T, kVec>(p + c * kVec), part);
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[c * kVec + k] = part[k];
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_cols(T* p, const float (&v)[V]) {
  constexpr int kVec = V == 1 ? 1 : vec_width(sizeof(T));
#pragma unroll
  for (int c = 0; c < V / kVec; ++c) {
    float part[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) part[k] = v[c * kVec + k];
    store<T, kVec>(p + c * kVec, part);
  }
}

// Columns d .. d+V-1 of one leaf from its int8 payload: the exact int32
// sum over the C rows, or with the scale the f32 fold acc + s_i * q_i in
// row order; kInt8Rows rows loaded before they are folded.  z and
// phi_mean are read after the fold.
template <typename T, bool kWeighted, int V>
__device__ __forceinline__ void fold_int8_columns(const Group& g,
                                                  const Leaf& L, int64_t d) {
  if (d >= L.D) return;
  const int8_t* q = static_cast<const int8_t*>(L.W) + d;
  using Acc = typename std::conditional<kWeighted, float, int>::type;
  Acc acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0;
  for (int i0 = 0; i0 < g.C; i0 += kInt8Rows) {
    Raw8<V> rows[kInt8Rows];
    float s[kInt8Rows];
#pragma unroll
    for (int r = 0; r < kInt8Rows; ++r) {
      if (i0 + r < g.C) {
        rows[r] = load_q<V>(q + (int64_t)(i0 + r) * L.D);
        if (kWeighted) s[r] = __ldg(g.weights + i0 + r);
      }
    }
#pragma unroll
    for (int r = 0; r < kInt8Rows; ++r) {
      if (i0 + r < g.C) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int qj = q_at<V>(rows[r], j);
          if constexpr (kWeighted) {
            acc[j] = __fadd_rn(acc[j], __fmul_rn(s[r], __int2float_rn(qj)));
          } else {
            acc[j] += qj;
          }
        }
      }
    }
  }
  float zf[V], phif[V], o[V];
  load_cols<T, V>(static_cast<const T*>(L.z) + d, zf);
  load_cols<T, V>(static_cast<const T*>(L.phi) + d, phif);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float sum;
    if constexpr (kWeighted) {
      sum = acc[j];
    } else {
      sum = __int2float_rn(acc[j]);
    }
    o[j] = epilogue(zf[j], phif[j], sum, g.n, g.psi, g.alpha_z);
  }
  store_cols<T, V>(static_cast<T*>(L.out) + d, o);
}

template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sign_agg_int8_group(const __grid_constant__ Group g) {
  const int b = (int)blockIdx.x;
  const int l = find_leaf(g, b);
  const Leaf& L = g.leaf[l];
  const int64_t t = (int64_t)(b - g.first[l]) * kThreads + threadIdx.x;
  constexpr int kVec = vec_width(sizeof(int8_t));
  if (L.vec) {
    fold_int8_columns<T, kWeighted, kVec>(g, L, t * kVec);
  } else {
    fold_int8_columns<T, kWeighted, 1>(g, L, t);
  }
}

// ------------------------------------------------------------ the host --

// blocks of one leaf; the Python wrapper's table builder counts the same
inline long long leaf_blocks(long long D, bool vec, int elem) {
  const long long per_block = (long long)kThreads * (vec ? vec_width(elem)
                                                         : 1);
  return (D + per_block - 1) / per_block;
}

inline bool vector_ok(const long long* row, int elem) {
  const uintptr_t any = (uintptr_t)(row[0] | row[1] | row[2] | row[3]);
  return (any & 15) == 0 && row[4] % vec_width(elem) == 0;
}

// the table the Python wrapper builds (sign_agg.leaf_table) for message
// rows of elem bytes: D >= 1, the vector flag only where vector_ok, first
// blocks counted from 0 at every kMaxLeaves-th leaf, every launch's grid
// within an int
bool table_ok(const long long* table, int n_leaves, int elem) {
  long long first = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const long long* row = table + (long long)l * kTableCols;
    if (l % kMaxLeaves == 0) first = 0;
    if (row[4] < 1 || row[5] != first || (row[6] != 0 && row[6] != 1) ||
        (row[6] == 1 && !vector_ok(row, elem))) {
      return false;
    }
    first += leaf_blocks(row[4], row[6] == 1, elem);
    if (first > INT_MAX) return false;
  }
  return true;
}

template <typename T, bool kInt8>
cudaError_t launch_group(const Group& g, cudaStream_t s) {
  const unsigned grid = (unsigned)g.first[g.n_leaves];
  const bool weighted = g.weights != nullptr;
  if constexpr (kInt8) {
    if (weighted) {
      sign_agg_int8_group<T, true><<<grid, kThreads, 0, s>>>(g);
    } else {
      sign_agg_int8_group<T, false><<<grid, kThreads, 0, s>>>(g);
    }
  } else {
    if (weighted) {
      sign_agg_group<T, true><<<grid, kThreads, 0, s>>>(g);
    } else {
      sign_agg_group<T, false><<<grid, kThreads, 0, s>>>(g);
    }
  }
  return cudaGetLastError();
}

// Every launch of one table: B1/B2 (kInt8 false: message rows in z's
// dtype) or B3 (int8 rows), one launch per kMaxLeaves leaves.
template <bool kInt8>
int run_table(int dtype, int n_leaves, const long long* table, int C,
              const void* weights, int n, float psi, float alpha_z,
              void* stream, int* launches) {
  *launches = 0;
  if ((dtype != 0 && dtype != 1) || n_leaves < 1 || C < 1 || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int elem = kInt8 ? 1 : (dtype == 0 ? 4 : 2);
  if (!table_ok(table, n_leaves, elem)) return (int)cudaErrorInvalidValue;
  Group g;
  g.C = C;
  g.weights = (const float*)weights;
  g.n = (float)n;
  g.psi = psi;
  g.alpha_z = alpha_z;
  cudaStream_t s = (cudaStream_t)stream;
  for (int l0 = 0; l0 < n_leaves; l0 += kMaxLeaves) {
    g.n_leaves = n_leaves - l0 < kMaxLeaves ? n_leaves - l0 : kMaxLeaves;
    for (int k = 0; k < g.n_leaves; ++k) {
      const long long* row = table + (long long)(l0 + k) * kTableCols;
      g.leaf[k] = Leaf{(const void*)row[0], (const void*)row[1],
                       (const void*)row[2], (void*)row[3], row[4],
                       (int)row[6], 0};
      g.first[k] = (int)row[5];
    }
    const Leaf& last = g.leaf[g.n_leaves - 1];
    g.first[g.n_leaves] =
        g.first[g.n_leaves - 1] + (int)leaf_blocks(last.D, last.vec, elem);
    const cudaError_t err = dtype == 0
                                ? launch_group<float, kInt8>(g, s)
                                : launch_group<__nv_bfloat16, kInt8>(g, s);
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  return (int)cudaSuccess;
}

// one leaf through run_table, its vector flag decided here
template <bool kInt8>
int one_leaf(int dtype, const void* z, const void* W, const void* phi,
             const void* weights, void* out, int C, long long D, int n,
             float psi, float alpha_z, void* stream) {
  long long row[kTableCols] = {(long long)(uintptr_t)z,
                               (long long)(uintptr_t)W,
                               (long long)(uintptr_t)phi,
                               (long long)(uintptr_t)out, D, 0, 0};
  row[6] = (dtype == 0 || dtype == 1) &&
           vector_ok(row, kInt8 ? 1 : (dtype == 0 ? 4 : 2));
  int launches = 0;
  return run_table<kInt8>(dtype, 1, row, C, weights, n, psi, alpha_z, stream,
                          &launches);
}

}  // namespace

// Every entry: dtype 0 = float32, 1 = bfloat16 (z, phi_mean and out; B1/B2
// also W).  A table this code would not build is refused, launching
// nothing.

// B1 (weights == nullptr, divisor n = C) or B2 (weights (C,) f32, divisor
// n) over n_leaves leaves, one launch per kMaxLeaves of them.  table:
// kTableCols int64 per leaf -- z, W (C, D), phi_mean, out, D, the leaf's
// first block (counted from 0 again at every kMaxLeaves-th leaf) and its
// vector flag.  *launches: the launches made.
extern "C" int repro_sign_agg_group(int dtype, int n_leaves,
                                    const long long* table, int C,
                                    const void* weights, int n, float psi,
                                    float alpha_z, void* stream,
                                    int* launches) {
  return run_table<false>(dtype, n_leaves, table, C, weights, n, psi,
                          alpha_z, stream, launches);
}

// B3 over n_leaves leaves: the same table with each leaf's (C, D) int8
// payload in W's column; scale (C,) f32 or nullptr (an int32 sum); the
// divisor n.
extern "C" int repro_sign_agg_int8_group(int dtype, int n_leaves,
                                         const long long* table, int C,
                                         const void* scale, int n, float psi,
                                         float alpha_z, void* stream,
                                         int* launches) {
  return run_table<true>(dtype, n_leaves, table, C, scale, n, psi, alpha_z,
                         stream, launches);
}

extern "C" int repro_sign_agg(int dtype, const void* z, const void* W,
                              const void* phi, void* out, int C,
                              long long D, float psi, float alpha_z,
                              void* stream) {
  return one_leaf<false>(dtype, z, W, phi, nullptr, out, C, D, C, psi,
                         alpha_z, stream);
}

extern "C" int repro_sign_agg_weighted(int dtype, const void* z,
                                       const void* W, const void* phi,
                                       const void* weights, void* out, int C,
                                       long long D, int n, float psi,
                                       float alpha_z, void* stream) {
  return one_leaf<false>(dtype, z, W, phi, weights, out, C, D, n, psi,
                         alpha_z, stream);
}

extern "C" int repro_sign_agg_int8(int dtype, const void* z,
                                   const void* payload, const void* phi,
                                   const void* scale, void* out, int C,
                                   long long D, int n, float psi,
                                   float alpha_z, void* stream) {
  return one_leaf<true>(dtype, z, payload, phi, scale, out, C, D, n, psi,
                        alpha_z, stream);
}
