// The matrix product for Hopper (sm_90a), the building block of the
// entity-attention forward and backward (entity_attn.cu) and of the GRU
// backward (gru.cu):
//
//   C (M x N) = sum over k in [k_begin, k_end) of A(m, k) * B(k, n)
//
// in two instances that launch() picks by the operands' types:
//   * two __nv_bfloat16 operands: bf16 x bf16 into f32 on the tensor cores
//     (warpgroup MMA, tc::launch below). In bf16 the attention's products
//     (K = 128 deep over tall M, or the weight gradients' tall K in row
//     chunks) move ~2 bytes a multiply-add of A and C against ~128-256
//     multiply-adds a row: near 100-200 FLOP a byte, under the card's ~295
//     at 989 TFLOP/s, so the bytes bound them and the MMAs hide behind the
//     copies; the design keeps A read once a column tile and every copy 16
//     bytes where it can;
//   * any other (float, or float with bfloat16, as the GRU's): the
//     register-tiled f32 FMA product below (launch_fma; no TF32, no tensor
//     cores: f32 results keep the 1e-5 gate), bfloat16 operands converted
//     to f32 as they are read from shared memory. At 67 TFLOP/s of f32 FMA
//     (~20 FLOP a byte) the arithmetic bounds it.
//
// Operands (both instances). Each operand is a matrix in device memory whose
// element (r, c) lies at ptr + row(r) * ld + c, with row(r) = (r / group) *
// stride + r % group: group = stride is a plain row-major matrix, and group =
// Nq, stride = Ne takes the first Nq of every Ne rows (the query rows of each
// sample) with no gathered copy. KA says A's contiguous index is k (A is "m x
// k" row-major, r = m); else it is m (A is stored as k x m, r = k). B is
// stored k x n (r = k): a product with a transposed weight takes the weight
// transposed once (entity_attn.cu). The output C (float, or __nv_bfloat16:
// the attention's bf16 planes and result) has its own row map and leading
// dimension;
// its epilogue may add a bias along n and store a row m as zeros where a
// per-row byte mask is set (in that order, as the TPU kernel forms (x W_o +
// b_o) * post_keep), round to bfloat16, then store, add to what is there
// (float C), or (split K, blockIdx.z = chunk) store chunk c's partial at ptr +
// c * chunk_stride.
//
// Design of the FMA instance: 256 threads per block, a BM x BN output tile (BM
// = 16 RM, BN = 16 TN), RM x TN outputs per thread in registers: 128 x 128 or
// 128 x 64 as a rule, 64 x BN or 32 x 64 where the matrix is too small for
// those (see launch_fma). The K loop stages 16-deep tiles of A and B in shared
// memory as they lie in device memory, 16-byte cp.async copies S tiles deep (S
// = 2: tile t+1 in flight while tile t is multiplied; a small product keeps
// three ahead); a chunk that is ragged or not 16-byte aligned is copied
// element by element, zero beyond the matrix. Each thread reads four
// consecutive values per shared-memory load (float4 for f32): along n, and
// along m where A is m-contiguous (its rows and columns then come in runs of
// four), along k where A is k-contiguous (its rows then interleave by 16 and a
// padded row stride keeps a quarter-warp on distinct banks). Each block owns
// its output tile and sums its k range in order: no atomics, and two runs give
// the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// The tensor-core instance, for a product of two __nv_bfloat16 operands
// (the attention's every product in bfloat16): bf16 x bf16 into f32 on
// Hopper's warpgroup MMA (wgmma.mma_async m64nNk16, N = 64 or 128), as the
// TPU kernel multiplies bf16 by bf16 into f32 on its MXU
// (pallas_attn.py:98,249). The contract is launch_fma's: row maps, leading
// dimensions, ragged M, N and K, the epilogue, split-K chunks, and every
// output tile summing its k range in a fixed order (no atomics: two calls
// give the same bits). Only the order of the f32 sum differs from the FMA
// instance's.
//
// Design: a block is one or two consumer warpgroups (a BM = 64 or 128 row
// tile, each warpgroup 64 rows) by BN = 64 or 128 columns, the sums in
// registers as wgmma lays them out (BN / 2 floats a thread). The K loop
// stages 64-deep tiles of A and B in shared memory with 16-byte cp.async
// copies, S tiles deep (S = 2 for a k-contiguous A, whose K is the
// attention's width; S = 3 for the weight gradients' tall row chunks),
// every thread copying. The row maps (the Nq query rows of every Ne) are no
// TMA box, so cp.async it is. Tiles are stored in the 128-byte swizzle
// that the descriptors name (16-byte chunk c of 128-byte row r at chunk c ^
// (r % 8)): a k-contiguous A as rows of 64 k (8-row atoms of 1 KB, SBO 1
// KB); an m-contiguous A and B (always k x n) as 64-wide column blocks of
// 64 k rows (8 KB a block; SBO 1 KB between 8-row k groups, LBO 8 KB
// between blocks), read through wgmma's transpose bits, with no transposed
// copy. A chunk that is ragged or not 16-byte aligned is copied element by
// element, zeros beyond the matrix (wgmma's k16 needs K padded with zeros,
// and stale shared memory could hold NaNs). cp.async and plain stores
// write through the generic proxy and wgmma reads through the async one:
// each thread fences (fence.proxy.async) before the block barrier that
// precedes the MMAs. Each k-tile's four k16 MMAs are one wgmma group,
// waited for before the barrier that lets its buffer be restaged. The
// epilogue maps wgmma's accumulator fragment (row 16 w + lane / 4 (+ 8),
// columns 8 j + 2 (lane % 4) (+ 1) for warp w, n8 block j) to C: bias, drop,
// round, then pairs of columns stored, added (float C) or written as split-K
// chunks.
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int kBK = 64;  // depth of a staged tile: one 128-byte swizzled row of bf16

// byte offset of 16-byte chunk c of row r, 128-byte rows, 128-byte swizzle
__device__ __forceinline__ int swizzled(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), 128-byte swizzle (bits 62-63 = 1)
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// Stages the 64-deep tile at (mn0, k0) of an operand with mn_end rows or
// columns and k_end depth into s (1 KB aligned): KCONT, MN rows of 64 k;
// else 64 k rows of MN columns, 64-column blocks 8 KB apart. Ends with the
// copies issued, not landed.
template <bool KCONT, int MN>
__device__ __forceinline__ void load_tile(char* s, const Operand& op, int mn0, int mn_end, int k0,
                                          int k_end) {
  constexpr int kRows = KCONT ? MN : kBK;          // rows as they lie in device memory
  constexpr int kChunks = (KCONT ? kBK : MN) / 8;  // 16-byte chunks a row
  const int r0 = KCONT ? mn0 : k0, c0 = KCONT ? k0 : mn0;
  const int r_end = KCONT ? mn_end : k_end, c_end = KCONT ? k_end : mn_end;
  const bf16* base = static_cast<const bf16*>(op.ptr);
  for (int i = threadIdx.x; i < kRows * kChunks; i += blockDim.x) {
    const int rr = i / kChunks, cc = i % kChunks;
    const int r = r0 + rr, c = c0 + cc * 8;
    char* dst = s + (KCONT ? swizzled(rr, cc) : (cc / 8) * (kBK * 128) + swizzled(rr, cc % 8));
    const bf16* src = r < r_end ? base + op.row(r) * op.ld + c : nullptr;
    if (src != nullptr && c + 8 <= c_end && ((uintptr_t)src & 15) == 0) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
    } else {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = (src != nullptr && c + u < c_end) ? src[u] : bf16(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// D (64 x 64, f32, this thread's 32) += A (64 x 16) B (16 x 64), bf16 from
// shared memory as the descriptors name them; TA = 1: A is m-contiguous
template <int TA>
__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

// the same, 64 x 128 (this thread's 64)
template <int TA>
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

// keeps the compiler from moving accumulator reads or writes across a wgmma
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// two values at p, n of them (n < 2: a ragged end) or both (aligned: one
// store); a float C may add to what is there
__device__ __forceinline__ void store2(float* p, const float (&v)[2], int n, int add) {
  if (n >= 2 && ((uintptr_t)p & 7) == 0) {
    float2 x = make_float2(v[0], v[1]);
    if (add) {
      const float2 y = *reinterpret_cast<const float2*>(p);
      x.x += y.x; x.y += y.y;
    }
    *reinterpret_cast<float2*>(p) = x;
  } else {
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (u < n) p[u] = add ? p[u] + v[u] : v[u];
  }
}

__device__ __forceinline__ void store2(bf16* p, const float (&v)[2], int n, int) {
  if (n >= 2 && ((uintptr_t)p & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (u < n) p[u] = __float2bfloat16(v[u]);
  }
}

// WG consumer warpgroups (BM = 64 WG rows) by BN columns, S staged tiles;
// EPI as launch_fma's: the epilogue applies C.bias and C.drop
template <int WG, int BN, bool KA, typename TC, bool EPI, int S>
__global__ void __launch_bounds__(128 * WG, 2)
gemm_kernel_tc(Operand A, Operand B, Output<TC> C, int M, int N, int K, int chunks) {
  constexpr int BM = 64 * WG;
  constexpr int kABytes = BM * kBK * 2, kBBytes = kBK * BN * 2;
  constexpr int R = BN / 2;  // accumulators a thread
  extern __shared__ char smem_raw[];
  // the swizzle acts on address bits 4-9: tiles start 1 KB aligned
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  char* smem = smem_raw + (base - raw);
  // buffer b of A's tiles at b * kABytes, of B's after all of A's
  const auto a_off = [](int b) { return b * kABytes; };
  const auto b_off = [](int b) { return S * kABytes + b * kBBytes; };

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, chunk = blockIdx.z;
  const int k_begin = (int)((long long)K * chunk / chunks);
  const int k_end = (int)((long long)K * (chunk + 1) / chunks);
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  const auto stage = [&](int t) {  // tile t into buffer t % S
    const int k0 = k_begin + t * kBK;
    load_tile<KA, BM>(smem + a_off(t % S), A, m0, M, k0, k_end);
    load_tile<false, BN>(smem + b_off(t % S), B, n0, N, k0, k_end);
  };

  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;

#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < n_tiles) stage(t);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int t = 0; t < n_tiles; ++t) {
    if (t + S - 1 < n_tiles) stage(t + S - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1));  // tile t has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();
    // this warpgroup's 64 rows of A; k16 step kk at +32 bytes (k-contiguous)
    // or two 8-row k groups on (m-contiguous); B's at two k groups a step
    const uint32_t a = base + a_off(t % S) + wg * (KA ? 64 * 128 : kBK * 128);
    const uint32_t b = base + b_off(t % S);
    fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = KA ? descriptor(a + kk * 32, 16, 1024)
                             : descriptor(a + kk * 2048, kBK * 128, 1024);
      const uint64_t db = descriptor(b + kk * 2048, kBK * 128, 1024);
      if constexpr (BN == 64)
        mma_n64<KA ? 0 : 1>(acc, da, db);
      else
        mma_n128<KA ? 0 : 1>(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
    __syncthreads();  // tile t is read before a later iteration restages its buffer
  }

  TC* out = C.ptr + (long long)chunk * C.chunk_stride;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
    if (m >= M) continue;
    const bool drop = EPI && C.drop != nullptr && C.drop[m] != 0;
    TC* row = out + C.row(m) * C.ld;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);  // a pair of columns
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float x = acc[4 * j + 2 * h + u];
        if constexpr (EPI) {
          if (C.bias != nullptr && n + u < N) x += to_f(C.bias[n + u]);
        }
        if (drop) x = 0.f;
        v[u] = C.round_bf16 ? __bfloat162float(__float2bfloat16(x)) : x;
      }
      store2(row + n, v, N - n, C.add);
    }
  }
}

// The tile launch_tc takes for an M x N product in `chunks` split-K chunks
// on a card with n_sm SMs: 128 columns where N fills them (as launch_fma),
// else 64; 128 rows (two warpgroups) unless those would not give every SM
// a block or would leave the last tile half empty or more, then 64.
inline void tile_of(int M, int N, int chunks, int n_sm, int* rows, int* cols) {
  *cols = (N > 64 && (N % 128 == 0 || N % 64 != 0)) ? 128 : 64;
  const long long n_tiles = (long long)((N + *cols - 1) / *cols) * chunks;
  const bool few = (M + 127) / 128 * n_tiles < n_sm;
  *rows = (few || (M % 128 != 0 && M % 128 <= 64)) ? 64 : 128;
}

template <int WG, int BN, bool KA, typename TC, bool EPI>
cudaError_t launch_tiles(const Operand& A, const Operand& B, const Output<TC>& C, int M, int N,
                         int K, int chunks, cudaStream_t st) {
  constexpr int S = KA ? 2 : 3;
  constexpr int kSmem = S * (64 * WG + BN) * kBK * 2 + 1024;  // + the 1 KB alignment
  const dim3 grid((N + BN - 1) / BN, (M + 64 * WG - 1) / (64 * WG), chunks);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory a kernel must opt in, once a device
  // (before the first, eager launch: never inside a capture)
  static bool opted[64] = {false};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64 || !opted[device]) {
    err = cudaFuncSetAttribute(gemm_kernel_tc<WG, BN, KA, TC, EPI, S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    if (device < 64) opted[device] = true;
  }
  gemm_kernel_tc<WG, BN, KA, TC, EPI, S><<<grid, 128 * WG, kSmem, st>>>(A, B, C, M, N, K, chunks);
  return cudaGetLastError();
}

// Enqueues C = A B on the tensor cores (see above); as launch_fma, EPI =
// true takes C.bias and C.drop, which must be null otherwise, and a
// bfloat16 C cannot add.
template <bool KA, typename TC, bool EPI>
cudaError_t launch(const Operand& A, const Operand& B, const Output<TC>& C, int M, int N, int K,
                   int chunks, cudaStream_t st) {
  if (M <= 0 || N <= 0 || chunks < 1) return cudaSuccess;
  if (sizeof(TC) != sizeof(float) && C.add) return cudaErrorInvalidValue;
  if (!EPI && (C.bias != nullptr || C.drop != nullptr)) return cudaErrorInvalidValue;
  int n_sm = 0, rows = 0, cols = 0;
  const cudaError_t err = sm_count(&n_sm);
  if (err != cudaSuccess) return err;
  tile_of(M, N, chunks, n_sm, &rows, &cols);
  if (rows == 64)
    return cols == 128 ? launch_tiles<1, 128, KA, TC, EPI>(A, B, C, M, N, K, chunks, st)
                       : launch_tiles<1, 64, KA, TC, EPI>(A, B, C, M, N, K, chunks, st);
  return cols == 128 ? launch_tiles<2, 128, KA, TC, EPI>(A, B, C, M, N, K, chunks, st)
                     : launch_tiles<2, 64, KA, TC, EPI>(A, B, C, M, N, K, chunks, st);
}

}  // namespace tc

// the launch of one tile shape (see launch_fma)
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
cudaError_t launch_fma(const Operand& A, const Operand& B, const Output<TC>& C, int M, int N,
                       int K, int chunks, cudaStream_t st) {
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

// C = A B on `st` (see the top of this file): a product of two bfloat16
// operands on the tensor cores (tc::launch), any other on the FMA instance
// (launch_fma). A launch that fails returns its error; nothing falls back.
template <typename TA, typename TB, bool KA, typename TC, bool EPI = false>
cudaError_t launch(const Operand& A, const Operand& B, const Output<TC>& C, int M, int N, int K,
                   int chunks, cudaStream_t st) {
  if constexpr (std::is_same<TA, __nv_bfloat16>::value && std::is_same<TB, __nv_bfloat16>::value)
    return tc::launch<KA, TC, EPI>(A, B, C, M, N, K, chunks, st);
  else
    return launch_fma<TA, TB, KA, TC, EPI>(A, B, C, M, N, K, chunks, st);
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
