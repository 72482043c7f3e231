// A register-tiled f32 matrix product for Hopper (sm_90a), the building block
// of the entity-attention backward (entity_attn.cu):
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
// weight transposed once (entity_attn.cu). The output C has its
// own row map and leading dimension; its epilogue stores, adds to what is
// there, or (split K, blockIdx.z = chunk) stores chunk c's partial at
// ptr + c * chunk_stride, and may round to bfloat16 first.
//
// Design: 256 threads per block, a 128 x BN output tile (BN = 16 TN, TN = 8
// or 4), TN x 8 outputs per thread in registers. The K loop stages 16-deep
// tiles of A and B in shared memory as they lie in device memory, 16-byte
// cp.async copies double-buffered (tile t+1 in flight while tile t is
// multiplied); a chunk that is ragged or not 16-byte aligned is copied
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

struct Output {
  float* ptr;
  long long ld;
  int group, stride;
  long long chunk_stride;  // split K: chunk c writes at ptr + c * chunk_stride
  int add;                 // 1: C += acc, 0: C = acc
  int round_bf16;          // round acc to bfloat16 before it is stored
  __device__ __forceinline__ long long row(int r) const { return mapped_row(r, group, stride); }
};

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

// Two blocks per SM: at most 128 registers a thread, 64 of them the sums.
template <typename TA, typename TB, bool KA, int TN>
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(Operand A, Operand B, Output C, int M, int N, int K, int chunks) {
  constexpr int BN = 16 * TN;
  typedef Tile<TA, KA, kBM> TileA;
  typedef Tile<TB, false, BN> TileB;
  constexpr int kABytes = ((TileA::kElems * (int)sizeof(TA)) + 15) / 16 * 16;
  constexpr int kBBytes = ((TileB::kElems * (int)sizeof(TB)) + 15) / 16 * 16;
  __shared__ __align__(16) char smem[2 * (kABytes + kBBytes)];
  // buffer b of A's tiles at smem + b * kABytes, of B's after both of A's
  const auto tile_a = [&](int b) { return reinterpret_cast<TA*>(smem + b * kABytes); };
  const auto tile_b = [&](int b) {
    return reinterpret_cast<TB*>(smem + 2 * kABytes + b * kBBytes);
  };

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM, chunk = blockIdx.z;
  const int k_begin = (int)((long long)K * chunk / chunks);
  const int k_end = (int)((long long)K * (chunk + 1) / chunks);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (n_tiles > 0) {
    TileA::load(tile_a(0), A, m0, M, k_begin, k_end);
    TileB::load(tile_b(0), B, n0, N, k_begin, k_end);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_tiles) {
      const int k1 = k_begin + (t + 1) * kBK;
      TileA::load(tile_a(cur ^ 1), A, m0, M, k1, k_end);
      TileB::load(tile_b(cur ^ 1), B, n0, N, k1, k_end);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);  // tile t has landed
    __syncthreads();
    const TA* a_s = tile_a(cur);
    const TB* b_s = tile_b(cur);
#pragma unroll
    for (int kq = 0; kq < kBK; kq += 4) {
      // a k-contiguous A gives four k steps a load: a4[i][kk] = A(m_i, kq + kk)
      float a4[8][4];
      if constexpr (KA) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          load4(a_s + lane_index<true>(ty, i) * TileA::kStride + kq, a4[i]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float a[8], b[TN];
#pragma unroll
        for (int i = 0; i < 8; i += 4) {
          float v[4];
          if constexpr (KA) {
#pragma unroll
            for (int u = 0; u < 4; ++u) v[u] = a4[i + u][kk];
          } else {
            load4(a_s + (kq + kk) * TileA::kStride + lane_index<false>(ty, i), v);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) a[i + u] = v[u];
        }
#pragma unroll
        for (int j = 0; j < TN; j += 4) {
          float v[4];
          load4(b_s + (kq + kk) * TileB::kStride + lane_index<false>(tx, j), v);
#pragma unroll
          for (int u = 0; u < 4; ++u) b[j + u] = v[u];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();  // tile t is read before iteration t + 1 restages its buffer
  }

  float* out = C.ptr + (long long)chunk * C.chunk_stride;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + lane_index<KA>(ty, i);
    if (m >= M) continue;
    float* row = out + C.row(m) * C.ld;
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int n = n0 + lane_index<false>(tx, j);  // a run of four columns
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = C.round_bf16 ? __bfloat162float(__float2bfloat16(acc[i][j + u]))
                            : acc[i][j + u];
      float* p = row + n;
      if (n + 3 < N && ((uintptr_t)p & 15) == 0) {
        float4 x = make_float4(v[0], v[1], v[2], v[3]);
        if (C.add) {
          const float4 y = *reinterpret_cast<const float4*>(p);
          x.x += y.x; x.y += y.y; x.z += y.z; x.w += y.w;
        }
        *reinterpret_cast<float4*>(p) = x;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (n + u < N) p[u] = C.add ? p[u] + v[u] : v[u];
      }
    }
  }
}

// Enqueues C = A B (see the top of this file) on `st`: TN = 8 (128 x 128
// tiles) where N > 64, else 4 (128 x 64). `chunks` splits K; each chunk
// writes its own partial (C.chunk_stride apart).
template <typename TA, typename TB, bool KA>
cudaError_t launch(const Operand& A, const Operand& B, const Output& C, int M, int N, int K,
                   int chunks, cudaStream_t st) {
  if (M <= 0 || N <= 0 || chunks < 1) return cudaSuccess;
  const int tn = N > 64 ? 8 : 4, bn = 16 * tn;
  const dim3 grid((N + bn - 1) / bn, (M + kBM - 1) / kBM, chunks);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  if (tn == 8)
    gemm_kernel<TA, TB, KA, 8><<<grid, kThreads, 0, st>>>(A, B, C, M, N, K, chunks);
  else
    gemm_kernel<TA, TB, KA, 4><<<grid, kThreads, 0, st>>>(A, B, C, M, N, K, chunks);
  return cudaGetLastError();
}

inline Operand operand(const void* ptr, long long ld, int group = 1, int stride = 1) {
  return Operand{ptr, ld, group, stride};
}

inline Output output(float* ptr, long long ld, int group = 1, int stride = 1, int add = 0,
                     int round_bf16 = 0, long long chunk_stride = 0) {
  return Output{ptr, ld, group, stride, chunk_stride, add, round_bf16};
}

}  // namespace gemm
