// A register-tiled f32 matrix product for Hopper (sm_90a), the building block
// of the entity-attention forward and backward (entity_attn.cu) and of the
// GRU backward (gru.cu):
//
//   C (M x N) = sum over k in [k_begin, k_end) of A(m, k) * B(k, n)
//
// in f32 FMA (no TF32, no tensor cores), operands float or __nv_bfloat16
// (converted to f32 as they are read from shared memory).
//
// Operands. Each operand is a matrix in device memory whose element (r, c)
// lies at ptr + row(r) * ld + c, with row(r) = (r / group) * stride +
// r % group: group = stride is a plain row-major matrix, and group = Nq,
// stride = Ne takes the first Nq of every Ne rows (the query rows of each
// sample) with no gathered copy. KA says A's contiguous index is k (A is
// "m x k" row-major, r = m); else it is m (A is stored as k x m, r = k). B
// is stored k x n (r = k): a product with a transposed weight takes the
// weight transposed once (entity_attn.cu). The output C (float, or
// __nv_bfloat16 for the attention forward's result) has its own row map and
// leading dimension; its epilogue may add a bias along n and store a row m
// as zeros where a per-row byte mask is set (in that order, as the TPU
// kernel forms (x W_o + b_o) * post_keep), round to bfloat16, then store,
// add to what is there (float C), or (split K, blockIdx.z = chunk) store
// chunk c's partial at ptr + c * chunk_stride.
//
// Design: 256 threads per block, a BM x BN output tile (BM = 16 RM, BN =
// 16 TN), RM x TN outputs per thread in registers: 128 x 128 or 128 x 64 as
// a rule, 64 x BN or 32 x 64 where the matrix is too small for those (see
// launch). The K loop stages 16-deep tiles of A and B in shared memory as
// they lie in device memory, 16-byte cp.async copies S tiles deep (S = 2:
// tile t+1 in flight while tile t is multiplied; a small product keeps three
// ahead); a chunk that is ragged or not 16-byte aligned is copied
// element by element, zero beyond the matrix. Each thread reads four
// consecutive values per shared-memory load (float4 for f32): along n, and
// along m where A is m-contiguous (its rows and columns then come in runs of
// four), along k where A is k-contiguous (its rows then interleave by 16 and
// a padded row stride keeps a quarter-warp on distinct banks). Each block owns
// its output tile and sums its k range in order: no atomics, and two runs
// give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // rows of a block's output tile
constexpr int kBK = 16;   // depth of a staged tile

// row r of a matrix whose rows come `group` of every `stride`
__device__ __forceinline__ long long mapped_row(int r, int group, int stride) {
  return group == stride ? r : (long long)(r / group) * stride + r % group;
}

struct Operand {
  const void* ptr;
  long long ld;
  int group, stride;  // row(r) = (r / group) * stride + r % group
  __device__ __forceinline__ long long row(int r) const { return mapped_row(r, group, stride); }
};

template <typename TC = float>
struct Output {
  TC* ptr;
  long long ld;
  int group, stride;
  long long chunk_stride;  // split K: chunk c writes at ptr + c * chunk_stride
  int add;                 // 1: C += acc, 0: C = acc (float C only)
  int round_bf16;          // round acc to bfloat16 before it is stored
  const TC* bias;          // null, or (N,): added to every row
  const uint8_t* drop;     // null, or one byte per row m: nonzero stores the row as 0
  __device__ __forceinline__ long long row(int r) const { return mapped_row(r, group, stride); }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// four values at p, n of them (n < 4: a ragged end) or all four (16-byte
// aligned: one store); a float C may add to what is there
__device__ __forceinline__ void store4(float* p, const float (&v)[4], int n, int add) {
  if (n >= 4 && ((uintptr_t)p & 15) == 0) {
    float4 x = make_float4(v[0], v[1], v[2], v[3]);
    if (add) {
      const float4 y = *reinterpret_cast<const float4*>(p);
      x.x += y.x; x.y += y.y; x.z += y.z; x.w += y.w;
    }
    *reinterpret_cast<float4*>(p) = x;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < n) p[u] = add ? p[u] + v[u] : v[u];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4], int n, int) {
  if (n >= 4 && ((uintptr_t)p & 7) == 0) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 x;
    x.x = *reinterpret_cast<const unsigned*>(&lo);
    x.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = x;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < n) p[u] = __float2bfloat16(v[u]);
  }
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// Shared-memory tile of one operand: MN (128 or BN) rows or columns by kBK.
// K-contiguous: MN rows of kBK elements plus one 16-byte chunk of padding;
// else kBK rows of MN elements.
template <typename T, bool KCONT, int MN>
struct Tile {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  static constexpr int kRows = KCONT ? MN : kBK;
  static constexpr int kCols = KCONT ? kBK : MN;
  static constexpr int kStride = KCONT ? kBK + kVec : MN;
  static constexpr int kElems = kRows * kStride;

  // stages the tile at (mn0, k0) of an operand with mn_end rows or columns
  // and k_end depth; ends with the copies issued, not landed
  __device__ static void load(T* s, const Operand& op, int mn0, int mn_end, int k0, int k_end) {
    const int r0 = KCONT ? mn0 : k0, c0 = KCONT ? k0 : mn0;
    const int r_end = KCONT ? mn_end : k_end, c_end = KCONT ? k_end : mn_end;
    constexpr int kChunks = kCols / kVec;
    const T* base = static_cast<const T*>(op.ptr);
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int rr = i / kChunks, cc = (i % kChunks) * kVec;
      const int r = r0 + rr, c = c0 + cc;
      T* dst = s + rr * kStride + cc;
      const T* src = r < r_end ? base + op.row(r) * op.ld + c : nullptr;
      if (src != nullptr && c + kVec <= c_end && ((uintptr_t)src & 15) == 0) {
        const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          dst[v] = (src != nullptr && c + v < c_end) ? src[v] : T(0.f);
      }
    }
  }
};

// the thread's i-th row (m) or column (n) within the tile: runs of four
// where that index is contiguous in shared memory, interleaved by 16 where k is
template <bool KCONT>
__device__ __forceinline__ int lane_index(int t, int i) {
  return KCONT ? t + 16 * i : (i / 4) * 64 + t * 4 + i % 4;
}

// RM x TN outputs a thread (a BM = 16 RM by BN = 16 TN tile a block), S
// staged tiles in flight (S - 1 copies ahead); EPI: the epilogue applies
// C.bias and C.drop (the attention forward's output product only: the
// checks cost the other instances registers and time). Two blocks per SM:
// at most 128 registers a thread, 64 of them the sums (RM 8, TN 8).
template <typename TA, typename TB, bool KA, int TN, typename TC, int RM, int S, bool EPI>
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(Operand A, Operand B, Output<TC> C, int M, int N, int K, int chunks) {
  static_assert(KA || RM % 4 == 0, "an m-contiguous A is read in runs of four rows");
  constexpr int BM = 16 * RM, BN = 16 * TN;
  typedef Tile<TA, KA, BM> TileA;
  typedef Tile<TB, false, BN> TileB;
  constexpr int kABytes = ((TileA::kElems * (int)sizeof(TA)) + 15) / 16 * 16;
  constexpr int kBBytes = ((TileB::kElems * (int)sizeof(TB)) + 15) / 16 * 16;
  __shared__ __align__(16) char smem[S * (kABytes + kBBytes)];
  // buffer b of A's tiles at smem + b * kABytes, of B's after all of A's
  const auto tile_a = [&](int b) { return reinterpret_cast<TA*>(smem + b * kABytes); };
  const auto tile_b = [&](int b) {
    return reinterpret_cast<TB*>(smem + S * kABytes + b * kBBytes);
  };

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, chunk = blockIdx.z;
  const int k_begin = (int)((long long)K * chunk / chunks);
  const int k_end = (int)((long long)K * (chunk + 1) / chunks);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;
  const auto stage = [&](int t) {  // tile t into buffer t % S
    const int k0 = k_begin + t * kBK;
    TileA::load(tile_a(t % S), A, m0, M, k0, k_end);
    TileB::load(tile_b(t % S), B, n0, N, k0, k_end);
  };

  float acc[RM][TN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < n_tiles) stage(t);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int t = 0; t < n_tiles; ++t) {
    if (t + S - 1 < n_tiles) stage(t + S - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1));  // tile t has landed
    __syncthreads();
    const TA* a_s = tile_a(t % S);
    const TB* b_s = tile_b(t % S);
#pragma unroll
    for (int kq = 0; kq < kBK; kq += 4) {
      // a k-contiguous A gives four k steps a load: a4[i][kk] = A(m_i, kq + kk)
      float a4[RM][4];
      if constexpr (KA) {
#pragma unroll
        for (int i = 0; i < RM; ++i)
          load4(a_s + lane_index<true>(ty, i) * TileA::kStride + kq, a4[i]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float a[RM], b[TN];
        if constexpr (KA) {
#pragma unroll
          for (int i = 0; i < RM; ++i) a[i] = a4[i][kk];
        } else {
#pragma unroll
          for (int i = 0; i < RM; i += 4) {
            float v[4];
            load4(a_s + (kq + kk) * TileA::kStride + lane_index<false>(ty, i), v);
#pragma unroll
            for (int u = 0; u < 4; ++u) a[i + u] = v[u];
          }
        }
#pragma unroll
        for (int j = 0; j < TN; j += 4) {
          float v[4];
          load4(b_s + (kq + kk) * TileB::kStride + lane_index<false>(tx, j), v);
#pragma unroll
          for (int u = 0; u < 4; ++u) b[j + u] = v[u];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();  // tile t is read before a later iteration restages its buffer
  }

  TC* out = C.ptr + (long long)chunk * C.chunk_stride;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + lane_index<KA>(ty, i);
    if (m >= M) continue;
    const bool drop = EPI && C.drop != nullptr && C.drop[m] != 0;
    TC* row = out + C.row(m) * C.ld;
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int n = n0 + lane_index<false>(tx, j);  // a run of four columns
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float x = acc[i][j + u];
        if constexpr (EPI) {
          if (C.bias != nullptr && n + u < N) x += to_f(C.bias[n + u]);
        }
        if (drop) x = 0.f;
        v[u] = C.round_bf16 ? __bfloat162float(__float2bfloat16(x)) : x;
      }
      store4(row + n, v, N - n, C.add);
    }
  }
}

// the current device's SM count, asked of the runtime once per device
inline cudaError_t sm_count(int* n_sm) {
  static int cached[64] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64)
    return cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, device);
  if (cached[device] == 0)
    err = cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount, device);
  *n_sm = cached[device];
  return err;
}

// the launch of one tile shape (see launch)
template <typename TA, typename TB, bool KA, int TN, typename TC, int RM, int S, bool EPI>
cudaError_t launch_tiles(const Operand& A, const Operand& B, const Output<TC>& C, int M, int N,
                         int K, int chunks, cudaStream_t st) {
  const dim3 grid((N + 16 * TN - 1) / (16 * TN), (M + 16 * RM - 1) / (16 * RM), chunks);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  gemm_kernel<TA, TB, KA, TN, TC, RM, S, EPI><<<grid, kThreads, 0, st>>>(A, B, C, M, N, K,
                                                                        chunks);
  return cudaGetLastError();
}

// Enqueues C = A B (see the top of this file) on `st`: 128 x 128 tiles (TN
// = 8) or 128 x 64 (TN = 4, where N is not a multiple of 128 but of 64, or
// N <= 64), two tiles staged; 64-row tiles for an m-contiguous A whose M
// would leave the last 128-row tile half empty or more. `chunks` splits K;
// each chunk writes its own partial (C.chunk_stride apart). A product with a
// k-contiguous A whose 128-row tiles would not give every SM a block takes
// 64-row tiles where those do (Group Matching's target-agent and mixer
// calls), else 32 x 64 tiles, four tiles staged (a rollout step's few rows):
// one block would otherwise compute a whole 128 x 128 tile, mostly rows
// beyond M, on one SM, each k-tile after the last. Every output sums its k
// range in the same order whatever the tile: the same bits. EPI = true takes
// C.bias and C.drop, which must be null otherwise.
template <typename TA, typename TB, bool KA, typename TC, bool EPI = false>
cudaError_t launch(const Operand& A, const Operand& B, const Output<TC>& C, int M, int N, int K,
                   int chunks, cudaStream_t st) {
  if (M <= 0 || N <= 0 || chunks < 1) return cudaSuccess;
  if (sizeof(TC) != sizeof(float) && C.add) return cudaErrorInvalidValue;
  if (!EPI && (C.bias != nullptr || C.drop != nullptr)) return cudaErrorInvalidValue;
  // 128-wide tiles where N fills them, else 64-wide (N = 192: three, none
  // padded, against two of which a quarter is padding)
  const int tn = (N > 64 && (N % 128 == 0 || N % 64 != 0)) ? 8 : 4, bn = 16 * tn;
  int rows = kBM;  // of a tile
  if constexpr (KA) {
    int n_sm = 0;
    const cudaError_t err = sm_count(&n_sm);
    if (err != cudaSuccess) return err;
    const long long n_tiles = (long long)((N + bn - 1) / bn) * chunks;
    if ((M + kBM - 1) / kBM * n_tiles < n_sm) {
      if ((M + 63) / 64 * n_tiles < n_sm)
        return launch_tiles<TA, TB, KA, 4, TC, 2, 4, EPI>(A, B, C, M, N, K, chunks, st);
      rows = 64;
    }
  } else if (M % kBM != 0 && M % kBM <= 64) {
    rows = 64;
  }
  if (rows == 64)
    return tn == 8 ? launch_tiles<TA, TB, KA, 8, TC, 4, 2, EPI>(A, B, C, M, N, K, chunks, st)
                   : launch_tiles<TA, TB, KA, 4, TC, 4, 2, EPI>(A, B, C, M, N, K, chunks, st);
  return tn == 8 ? launch_tiles<TA, TB, KA, 8, TC, 8, 2, EPI>(A, B, C, M, N, K, chunks, st)
                 : launch_tiles<TA, TB, KA, 4, TC, 8, 2, EPI>(A, B, C, M, N, K, chunks, st);
}

inline Operand operand(const void* ptr, long long ld, int group = 1, int stride = 1) {
  return Operand{ptr, ld, group, stride};
}

template <typename TC>
inline Output<TC> output(TC* ptr, long long ld, int group = 1, int stride = 1, int add = 0,
                         int round_bf16 = 0, long long chunk_stride = 0,
                         const TC* bias = nullptr, const uint8_t* drop = nullptr) {
  return Output<TC>{ptr, ld, group, stride, chunk_stride, add, round_bf16, bias, drop};
}

}  // namespace gemm
