// Masked entity attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of refil_tpu/ops/pallas_attn.py:
//   * the forward <- _kernel (pallas_attn.py:87-131), in stages: the
//     register-tiled matrix product of gemm.cuh for the projections and
//     entity_attn_fwd_sample_kernel for the attention itself;
//   * the backward <- _bwd_kernel (pallas_attn.py:224-321), in stages: the
//     same product for every projection and gradient,
//     entity_attn_bwd_sample_kernel for the attention's own VJP, and
//     entity_attn_colsum_kernel and entity_attn_reduce_kernel, which sum
//     db_o and the weight gradients' chunks in a fixed order.
//
// What it computes (per sample b of Bp, Ne entities of width D, Nq <= Ne
// queries, H heads of width hd = E/H):
//   qkv = ents[b] @ W_qkv                              (Ne, 3E)
//   w_h = softmax(q_h k_h^T * scale, blocked -> -1e9)  (Nq, Ne) per head, f32
//   attn = concat_h(w_h @ v_h) * row_ok                (Nq, E)
//   out = (attn @ W_o + b_o) * post_keep               (Nq, O)
// row_ok is 0 for a query row whose pre-mask blocks every entity, so such a
// row is exactly 0 (never NaN); post_keep is 0 where post_mask is set. The
// backward recomputes the forward and returns dEnts (Bp, Ne, D) f32 and the
// f32 weight gradients dW_qkv (D, 3E), dW_o (E, O), db_o (O).
//
// Types: T = float or __nv_bfloat16 inputs. Every product accumulates in f32
// and the softmax is f32. The values the TPU kernel rounds to the input type
// (qkv, the softmax weights fed to w@v, attn, out, g, dqkv, dl) are rounded
// here at the same points, so bf16 results follow the same rounding path.
// The scratch planes between the stages are of type T: each holds only
// values the TPU kernel rounds to cdt before their next use (see
// launch_fwd, BwdScratch), so in bf16 every product is bf16 x bf16 into f32,
// as on the TPU's MXU (pallas_attn.py:98,249), and runs on gemm.cuh's
// tensor-core instance; in f32 every product is f32 FMA.
//
// What bounds it on an H100: a sample reads Ne*D inputs and writes Nq*O
// outputs but does ~2*Ne*D*2E + 2*Nq*D*E + 2*Nq*E*O multiply-adds for the
// projections (~95% of its arithmetic): at the combat widths (Ne 16, Nq 8,
// D = E = O = 128) ~1.6 MFLOP against ~12 KB, ~130 FLOP per byte. In f32,
// outside the tensor cores (67 TFLOP/s vs 3.35 TB/s, ~20 FLOP/byte), the
// arithmetic bounds it at every width the repository uses. In bf16 on the
// tensor cores (989 TFLOP/s, ~295 FLOP/byte) the function sits near the
// balance point, but the stages' own traffic does not: each product reads
// its A plane and writes its C plane (~2 bytes a value each) for 128-256
// multiply-adds a row, 64-128 FLOP a byte, so the products are bound by the
// bytes they move; the design stores the planes in bf16, halving them, and
// keeps every product's copies 16 bytes wide. Q, and in the backward dq's products, are
// formed over the Nq query rows only.
//
// Why stages: a kernel that walked groups of samples and streamed W_qkv and
// W_o through shared memory (262 KB of f32 weights at width 128, more than
// a block may hold) re-read the weights for every few samples and kept
// ~200 registers of partial sums, one block per SM: 9 TFLOP/s. Over all
// samples' rows at once every weight value fetched serves 128 rows, and the
// attention itself needs no weights.
// Forward design (launch_fwd):
//   (i)   K|V = ents W_kv (Bp*Ne rows) and Q = ents[:, :Nq] W_q (Bp*Nq
//         rows, addressed by gemm.cuh's row map), stored in the input
//         type, which rounds them where the TPU rounds qkv;
//   (ii)  entity_attn_fwd_sample_kernel, a warp per (sample, head), no
//         weights: the scores, the f32 softmax and attn = round(w) v * row_ok,
//         rounded, written over Q;
//   (iii) out = attn W_o, whose epilogue adds b_o, zeroes the post-masked
//         rows and stores in the input type.
// Backward design (launch_bwd):
//   (i)   the same projections, and dattn = g W_o^T (W_qkv^T and W_o^T are
//         written once per call by entity_attn_transpose_kernel, so every
//         product reads B row-major);
//   (ii)  entity_attn_bwd_sample_kernel, a warp per (sample, head) and no
//         weights: the scores, softmax, attn, dv, the softmax VJP, dq, dk;
//   (iii) the same product for dEnts = dK|dV W_kv^T + dq W_q^T (the second
//         added on the query rows) and for dW_kv = ents^T dK|dV, dW_q =
//         ents[:, :Nq]^T dq, dW_o = attn^T (g post_keep), whose tall K splits
//         into row chunks (blocks run concurrently, so the TPU kernel's +=
//         across its sequential grid, pallas_attn.py:274-278, would race);
//         db_o's chunks by entity_attn_colsum_kernel, and
//         entity_attn_reduce_kernel sums every chunk in order.
// No atomics: two runs give the same bits. The scratch in f32 (at Bp 14,496,
// Ne 16, Nq 8, E = O = 128): forward K|V 237 MB and Q (then attn) 59 MB;
// backward K|V 237 MB, Q 59 MB, dattn 59 MB and g post_keep 59 MB, stage
// (ii) writing dK|dV, dq and attn over the first three; the chunk partials
// 69 MB; the transposed weights 0.26 MB. In bf16 the planes take half
// (forward 148 MB, backward 207 MB), the partials stay f32.
//
// Interface: plain C (extern "C"), loaded with ctypes. The wrapper allocates
// every output and scratch buffer; each launcher enqueues on the stream it is
// given and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -1e9f;
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory a launch may take unasked

template <typename T>
struct Num;

// to_f: a stored value as f32; round: f32 rounded to T, kept in f32;
// store: f32 rounded to T, as T
template <>
struct Num<float> {
  __device__ static float to_f(float x) { return x; }
  __device__ static float round(float x) { return x; }
  __device__ static float store(float x) { return x; }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16(x)); }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
};

struct Dims {
  int bp, ne, nq, d, e, o, h;
  int mask_rows;  // rows of the pre-mask per sample (>= nq); 0 = no pre-mask
  int spb;        // samples per block of the per-sample kernels
  float scale;
};

// Shared memory of one warp of a per-sample kernel, which takes one (sample,
// head), in floats: q_h, k_h, v_h and (backward) dattn_h, their rows padded
// (to hd + 4 floats where hd is a multiple of 4, so rows stay 16-byte
// aligned for cp.async and eight lanes reading four floats each of eight
// rows hit distinct banks; else hd + 1), the softmax weights, (backward) dl,
// the pre-mask (Nq x Ne each), row_ok and (backward) post_keep.
struct WarpLayout {
  int hdp, q, k, v, da, w, dl, mask, rowok, post, floats;
};

__host__ __device__ inline WarpLayout make_warp_layout(const Dims& d, bool bwd) {
  WarpLayout L;
  const int hd = d.e / d.h, b = bwd ? 1 : 0;
  L.hdp = hd % 4 == 0 ? hd + 4 : hd + 1;
  int off = 0;
  L.q = off;     off += d.nq * L.hdp;
  L.k = off;     off += d.ne * L.hdp;
  L.v = off;     off += d.ne * L.hdp;
  L.da = off;    off += b * d.nq * L.hdp;
  L.w = off;     off += d.nq * d.ne;
  L.dl = off;    off += b * d.nq * d.ne;
  L.mask = off;  off += d.nq * d.ne;
  L.rowok = off; off += d.nq;
  L.post = off;  off += b * d.nq;
  L.floats = (off + 3) / 4 * 4;  // the next warp's slice 16-byte aligned
  return L;
}

// a per-sample kernel's block: H warps for each of its spb samples
inline size_t sample_smem(const Dims& d, bool bwd) {
  return (size_t)make_warp_layout(d, bwd).floats * sizeof(float) * d.h * d.spb;
}

// Calls body(r, c) once for every row r < rows and column c < cols over the
// 32 lanes of a warp: a lane keeps one column and steps over the rows, so no
// index is divided per element.
template <class F>
__device__ __forceinline__ void warp_rows_cols(int rows, int cols, F body) {
  const int lane = threadIdx.x & 31;
  const int cpp = min(cols, 32), rpp = 32 / cpp;
  const int tc = lane % cpp, tr = lane / cpp;
  if (tr >= rpp) return;
  for (int c = tc; c < cols; c += cpp)
    for (int r = tr; r < rows; r += rpp) body(r, c);
}

// As warp_rows_cols, four of a lane's rows at a time: body(rs, n, c) gets
// the rows rs[u] (u < 4; those from n on repeat the last valid one, so loads
// stay in range) and writes only u < n. A column value read once then feeds
// four independent sums.
template <class F>
__device__ __forceinline__ void warp_rows4_cols(int rows, int cols, F body) {
  const int lane = threadIdx.x & 31;
  const int cpp = min(cols, 32), rpp = 32 / cpp;
  const int tc = lane % cpp, tr = lane / cpp;
  if (tr >= rpp) return;
  for (int c = tc; c < cols; c += cpp)
    for (int r = tr; r < rows; r += 4 * rpp) {
      const int n = min(4, (rows - r + rpp - 1) / rpp);
      int rs[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) rs[u] = r + min(u, n - 1) * rpp;
      body(rs, n, c);
    }
}

// rows x cols floats from src (row stride ld_src) to shared dst (row stride
// ld_dst), over a warp's lanes: 16-byte cp.async where source and
// destination are 16-byte aligned, else plain copies
__device__ __forceinline__ void warp_copy_rows(float* dst, int ld_dst, const float* src,
                                               int ld_src, int rows, int cols) {
  if (cols % 4 == 0 && ld_dst % 4 == 0 && ld_src % 4 == 0 && ((uintptr_t)src & 15) == 0) {
    warp_rows_cols(rows, cols / 4, [&](int r, int c4) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + r * ld_dst + 4 * c4);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src + (size_t)r * ld_src + 4 * c4));
    });
  } else {
    warp_rows_cols(rows, cols,
                   [&](int r, int c) { dst[r * ld_dst + c] = src[(size_t)r * ld_src + c]; });
  }
}

// rows x cols values of a plane (row stride ld_src) to shared dst as f32
// (row stride ld_dst), over a warp's lanes: float rows by warp_copy_rows
// (cp.async, landed at the caller's wait); bfloat16 rows converted as they
// are read, where aligned 16 bytes (8 values) a load, each lane issuing
// four loads before it stores any, so their latencies overlap
__device__ __forceinline__ void warp_load_rows(float* dst, int ld_dst, const float* src,
                                               int ld_src, int rows, int cols) {
  warp_copy_rows(dst, ld_dst, src, ld_src, rows, cols);
}

__device__ __forceinline__ void warp_load_rows(float* dst, int ld_dst, const __nv_bfloat16* src,
                                               int ld_src, int rows, int cols) {
  if (cols % 8 == 0 && ld_dst % 4 == 0 && ld_src % 8 == 0 && ((uintptr_t)src & 15) == 0) {
    const int lane = threadIdx.x & 31, cpr = cols / 8, n = rows * cpr;  // 16-byte chunks
    for (int i0 = 0; i0 < n; i0 += 4 * 32) {
      uint4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 32 * u + lane;
        if (i < n)
          x[u] = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(i / cpr) * ld_src +
                                                      (i % cpr) * 8));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 32 * u + lane;
        if (i >= n) continue;
        // a bfloat16 is the upper half of the f32 it widens to: element 2k
        // is word k's low half, element 2k + 1 its high half
        const unsigned w[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
        float v[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[2 * k] = __uint_as_float(w[k] << 16);
          v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
        }
        float4* d = reinterpret_cast<float4*>(dst + (i / cpr) * ld_dst + (i % cpr) * 8);
        d[0] = make_float4(v[0], v[1], v[2], v[3]);
        d[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  } else {
    warp_rows_cols(rows, cols, [&](int r, int c) {
      dst[r * ld_dst + c] = __bfloat162float(src[(size_t)r * ld_src + c]);
    });
  }
}

// op over the G lanes of the caller's group (G a power of 2 dividing 32,
// groups of consecutive lanes), by xor shuffles: every lane of a group gets
// the same bits
template <class Op>
__device__ __forceinline__ float group_reduce(float v, int G, Op op) {
  for (int o = G / 2; o > 0; o /= 2) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// acc[u] = sum over k < n of a[u][k] * b[k] for four rows a[u], in order;
// b read once for the four (four floats a load where n is a multiple of 4)
__device__ __forceinline__ void rows_dot(const float* const (&a)[4], const float* b, int n,
                                         float (&acc)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) acc[u] = 0.f;
  if (n % 4 == 0) {
    for (int k = 0; k < n; k += 4) {
      const float4 y = *reinterpret_cast<const float4*>(b + k);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 x = *reinterpret_cast<const float4*>(a[u] + k);
        acc[u] = fmaf(x.x, y.x, acc[u]);
        acc[u] = fmaf(x.y, y.y, acc[u]);
        acc[u] = fmaf(x.z, y.z, acc[u]);
        acc[u] = fmaf(x.w, y.w, acc[u]);
      }
    }
  } else {
    for (int k = 0; k < n; ++k)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = fmaf(a[u][k], b[k], acc[u]);
  }
}

// Scores of one head, blocked pairs at kNeg, then the f32 softmax of each
// query row, into sw (Nq x Ne), over a warp's lanes; ends with __syncwarp.
// Returns G, the lanes per query row of the softmax: a power of 2, G >=
// min(Ne, 32), 32 / G rows at a time; a group past the last row repeats it
// and writes nothing.
__device__ __forceinline__ int head_softmax(const float* sq, const float* sk,
                                            const float* smask, float* sw, int hdp, int hd,
                                            int nq, int ne, float scale) {
  const int lane = threadIdx.x & 31;
  warp_rows4_cols(nq, ne, [&](const int (&rs)[4], int n, int j) {
    const float* const a[4] = {sq + rs[0] * hdp, sq + rs[1] * hdp, sq + rs[2] * hdp,
                               sq + rs[3] * hdp};
    float acc[4];
    rows_dot(a, sk + j * hdp, hd, acc);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < n) {
        const int i = rs[u] * ne + j;
        sw[i] = smask[i] != 0.f ? kNeg : acc[u] * scale;
      }
  });
  __syncwarp();
  int G = 1;
  while (G < ne && G < 32) G *= 2;
  const int jl = lane % G;
  for (int r0 = 0; r0 < nq; r0 += 32 / G) {
    const int r = r0 + lane / G;
    const bool live = r < nq;
    float* row = sw + min(r, nq - 1) * ne;
    float m = __int_as_float(0xff800000);  // -inf
    for (int j = jl; j < ne; j += G) m = fmaxf(m, row[j]);
    m = group_reduce(m, G, [](float a, float b) { return fmaxf(a, b); });
    float sum = 0.f;
    for (int j = jl; j < ne; j += G) {
      const float e = expf(row[j] - m);
      if (live) row[j] = e;
      sum += e;
    }
    sum = group_reduce(sum, G, [](float a, float b) { return a + b; });
    for (int j = jl; j < ne; j += G)
      if (live) row[j] = row[j] / sum;
  }
  __syncwarp();
  return G;
}

// attn_h = round(w) v_h times row_ok, stored as T (rounded), over a warp's
// lanes: row r of the head's Nq x hd block to dst + r * ld
template <typename T>
__device__ __forceinline__ void head_attn(const float* sw, const float* sv, const float* srowok,
                                          T* dst, int ld, int hdp, int hd, int nq, int ne) {
  warp_rows4_cols(nq, hd, [&](const int (&rs)[4], int n, int c) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < ne; ++j) {
      const float v = sv[j * hdp + c];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = fmaf(Num<T>::round(sw[rs[u] * ne + j]), v, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < n) dst[rs[u] * ld + c] = Num<T>::store(acc[u] * srowok[rs[u]]);
  });
}

// the pre-mask of sample s's query rows (1.f where blocked) and row_ok, over
// a warp's lanes; ends with __syncwarp
__device__ __forceinline__ void head_mask(const uint8_t* pre, int s, const Dims& d, float* smask,
                                          float* srowok) {
  const int lane = threadIdx.x & 31, nq = d.nq, ne = d.ne;
  warp_rows_cols(nq, ne, [&](int r, int j) {
    smask[r * ne + j] = pre ? (float)pre[((size_t)s * d.mask_rows + r) * ne + j] : 0.f;
  });
  __syncwarp();
  for (int r = lane; r < nq; r += 32) {
    float ok = 0.f;
    for (int j = 0; j < ne; ++j)
      if (smask[r * ne + j] == 0.f) { ok = 1.f; break; }
    srowok[r] = ok;
  }
  __syncwarp();
}

// Stage (ii) of the forward, no weights: one warp per (sample, head), H
// warps per sample and `spb` samples per block, each warp in its own slice of
// shared memory (no block barrier). From the rounded q (Nq rows) and k|v (Ne
// rows) of stage (i), stored as T, it forms the head's scores, the f32
// softmax and attn_h = round(w) v_h * row_ok, rounded as
// pallas_attn.py:117-126 rounds, and writes it as T over q_h's rows, which
// the warp has read first.
template <typename T>
__global__ void __launch_bounds__(kThreads)
entity_attn_fwd_sample_kernel(T* __restrict__ q, const T* __restrict__ kv,
                              const uint8_t* __restrict__ pre, Dims d) {
  extern __shared__ __align__(16) char smem[];
  const WarpLayout L = make_warp_layout(d, false);
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.x * d.spb + warp / d.h, h = warp % d.h;
  if (s >= d.bp) return;  // the last block's spare warps; no block barrier follows
  float* f = reinterpret_cast<float*>(smem) + warp * L.floats;
  float *sq = f + L.q, *sk = f + L.k, *sv = f + L.v, *sw = f + L.w;
  float *smask = f + L.mask, *srowok = f + L.rowok;
  const int E = d.e, E2 = 2 * d.e, hd = d.e / d.h, hdp = L.hdp;
  T* gq = q + (size_t)s * d.nq * E + h * hd;        // row r of q_h at gq + r * E
  const T* gkv = kv + (size_t)s * d.ne * E2 + h * hd;  // row j of k_h at gkv + j * E2

  warp_load_rows(sq, hdp, gq, E, d.nq, hd);
  warp_load_rows(sk, hdp, gkv, E2, d.ne, hd);
  warp_load_rows(sv, hdp, gkv + E, E2, d.ne, hd);
  asm volatile("cp.async.commit_group;\n" ::);
  head_mask(pre, s, d, smask, srowok);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncwarp();
  head_softmax(sq, sk, smask, sw, hdp, hd, d.nq, d.ne, d.scale);
  head_attn<T>(sw, sv, srowok, gq, E, hdp, hd, d.nq, d.ne);
}

// Stage (ii) of the backward, no weights: one warp per (sample, head), H
// warps per sample and `spb` samples per block, each warp in its own slice of
// shared memory, so the phases are ordered by __syncwarp and no block barrier.
// From the rounded q (Nq rows) and k|v (Ne rows) of stage (i) and dattn = g
// W_o^T (each stored as T), it recomputes the head's softmax weights and
// attn and forms its VJP. The warp reads all of its head's rows before it
// writes any, so the outputs go in place, as T:
//   * attn * row_ok, rounded, over dattn (for dW_o);
//   * dq * scale over q, [dk * scale | dv] over k|v, each rounded where
//     pallas_attn.py:312 rounds dqkv;
//   * g * post_keep into gm (for dW_o and db_o), a share per head.
// dattn is masked and rounded as pallas_attn.py:279-288 does: (g * post_keep)
// W_o^T equals (g W_o^T) * post_keep exactly, post_keep being 0 or 1, and
// so does the stored round(g W_o^T) masked, then rounded.
template <typename T>
__global__ void __launch_bounds__(kThreads)
entity_attn_bwd_sample_kernel(T* __restrict__ q, T* __restrict__ kv, T* __restrict__ da,
                              const T* __restrict__ g, const uint8_t* __restrict__ pre,
                              const uint8_t* __restrict__ post, T* __restrict__ gm, Dims d) {
  extern __shared__ __align__(16) char smem[];
  const WarpLayout L = make_warp_layout(d, true);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * d.spb + warp / d.h, h = warp % d.h;
  if (s >= d.bp) return;  // the last block's spare warps; no block barrier follows
  float* f = reinterpret_cast<float*>(smem) + warp * L.floats;
  float *sq = f + L.q, *sk = f + L.k, *sv = f + L.v, *sda = f + L.da;
  float *sw = f + L.w, *sdl = f + L.dl, *smask = f + L.mask, *srowok = f + L.rowok;
  float* spost = f + L.post;
  const int E = d.e, E2 = 2 * d.e, O = d.o, hd = d.e / d.h, hdp = L.hdp;
  const int nq = d.nq, ne = d.ne;
  T* gq = q + (size_t)s * nq * E + h * hd;    // row r of q_h at gq + r * E
  T* gkv = kv + (size_t)s * ne * E2 + h * hd;  // row j of k_h at gkv + j * E2, v_h + E
  T* gda = da + (size_t)s * nq * E + h * hd;

  // the head's rows of q, k, v and the unmasked dattn (f32 rows: every copy
  // in flight at once)
  warp_load_rows(sq, hdp, gq, E, nq, hd);
  warp_load_rows(sk, hdp, gkv, E2, ne, hd);
  warp_load_rows(sv, hdp, gkv + E, E2, ne, hd);
  warp_load_rows(sda, hdp, gda, E, nq, hd);
  asm volatile("cp.async.commit_group;\n" ::);
  warp_rows_cols(nq, ne, [&](int r, int j) {
    smask[r * ne + j] = pre ? (float)pre[((size_t)s * d.mask_rows + r) * ne + j] : 0.f;
  });
  for (int r = lane; r < nq; r += 32) spost[r] = post[(size_t)s * nq + r] ? 0.f : 1.f;
  __syncwarp();
  for (int r = lane; r < nq; r += 32) {
    float ok = 0.f;
    for (int j = 0; j < ne; ++j)
      if (smask[r * ne + j] == 0.f) { ok = 1.f; break; }
    srowok[r] = ok;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncwarp();
  warp_rows_cols(nq, hd, [&](int r, int c) {
    sda[r * hdp + c] = Num<T>::round(sda[r * hdp + c] * spost[r] * srowok[r]);
  });
  const size_t g0 = (size_t)s * nq * O;
  for (int i = h * 32 + lane; i < nq * O; i += d.h * 32)
    gm[g0 + i] = Num<T>::store(Num<T>::to_f(g[g0 + i]) * spost[i / O]);
  __syncwarp();

  const int G = head_softmax(sq, sk, smask, sw, hdp, hd, nq, ne, d.scale);
  const int jl = lane % G;
  // attn (over dattn in device memory) and dw = dattn_h v_h^T
  head_attn<T>(sw, sv, srowok, gda, E, hdp, hd, nq, ne);
  warp_rows4_cols(nq, ne, [&](const int (&rs)[4], int n, int j) {
    const float* const a[4] = {sda + rs[0] * hdp, sda + rs[1] * hdp, sda + rs[2] * hdp,
                               sda + rs[3] * hdp};
    float acc[4];
    rows_dot(a, sv + j * hdp, hd, acc);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < n) sdl[rs[u] * ne + j] = acc[u];
  });
  __syncwarp();
  // softmax VJP: dl = w * (dw - sum(dw * w)), the softmax's lane groups
  for (int r0 = 0; r0 < nq; r0 += 32 / G) {
    const int r = min(r0 + lane / G, nq - 1);
    const bool live = r0 + lane / G < nq;
    const float* wr = sw + r * ne;
    float* dr = sdl + r * ne;
    float dot = 0.f;
    for (int j = jl; j < ne; j += G) dot += dr[j] * wr[j];
    dot = group_reduce(dot, G, [](float a, float b) { return a + b; });
    for (int j = jl; j < ne; j += G)
      if (live) dr[j] = Num<T>::round(wr[j] * (dr[j] - dot));
  }
  __syncwarp();

  // dq = dl k_h * scale over the Nq query rows only; dk = dl^T q_h * scale
  // and dv = w^T dattn_h over all Ne rows
  warp_rows4_cols(nq, hd, [&](const int (&rs)[4], int n, int c) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < ne; ++j) {
      const float k = sk[j * hdp + c];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = fmaf(sdl[rs[u] * ne + j], k, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < n) gq[rs[u] * E + c] = Num<T>::store(acc[u] * d.scale);
  });
  warp_rows4_cols(ne, hd, [&](const int (&js)[4], int n, int c) {
    float dk[4] = {0.f, 0.f, 0.f, 0.f}, dv[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < nq; ++r) {
      const float x = sq[r * hdp + c], y = sda[r * hdp + c];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        dk[u] = fmaf(sdl[r * ne + js[u]], x, dk[u]);
        dv[u] = fmaf(Num<T>::round(sw[r * ne + js[u]]), y, dv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < n) {
        gkv[js[u] * E2 + c] = Num<T>::store(dk[u] * d.scale);
        gkv[js[u] * E2 + E + c] = Num<T>::store(dv[u]);
      }
  });
}

// dst (cols x rows) = src (rows x cols, row-major)^T through a 32 x 32 tile
// of shared memory, blocks of 32 x 8 threads
template <typename T>
__global__ void entity_attn_transpose_kernel(const T* __restrict__ src, int rows, int cols,
                                             T* __restrict__ dst) {
  __shared__ T tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[i][threadIdx.x] = src[(size_t)r * cols + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (r < rows && c < cols) dst[(size_t)c * rows + r] = tile[threadIdx.x][i];
  }
}

// partials[c][offset + o] = sum over the rows of chunk c, in order, of
// x[row][o] in f32: db_o's chunk partials from the post-masked g
template <typename T>
__global__ void entity_attn_colsum_kernel(const T* __restrict__ x, int rows, int cols,
                                          int chunks, size_t k_total, size_t offset,
                                          float* __restrict__ partials) {
  const int c = blockIdx.x;
  const int r0 = (int)((long long)rows * c / chunks);
  const int r1 = (int)((long long)rows * (c + 1) / chunks);
  for (int o = threadIdx.x; o < cols; o += blockDim.x) {
    float acc = 0.f;
    for (int r = r0; r < r1; ++r) acc += Num<T>::to_f(x[(size_t)r * cols + o]);
    partials[(size_t)c * k_total + offset + o] = acc;
  }
}

// out[k] = sum over chunks c (in order) of partials[c][k]
__global__ void entity_attn_reduce_kernel(const float* __restrict__ partials, int n_chunks,
                                          int k_total, float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= k_total) return;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc += partials[(size_t)c * k_total + k];
  out[k] = acc;
}

Dims make_dims(int bp, int ne, int nq, int d, int e, int o, int h, int mask_rows, int spb) {
  Dims dims;
  dims.bp = bp; dims.ne = ne; dims.nq = nq; dims.d = d; dims.e = e; dims.o = o; dims.h = h;
  dims.mask_rows = mask_rows;
  dims.spb = spb;
  dims.scale = (float)(1.0 / sqrt((double)(e / h)));  // the Python-float scale
  return dims;
}

// The forward as stages on one stream, with scratch planes of the inputs'
// type T, each row-major: q (Bp*Nq, E): Q, then attn; kv (Bp*Ne, 2E): K|V.
// Both hold only values the TPU kernel rounds to cdt before their next use
// (qkv, pallas_attn.py:103; attn, :130), so in T they lose nothing.
//   (i)   K|V = ents W_kv, Q = ents[:, :Nq] W_q, through gemm::launch;
//   (ii)  entity_attn_fwd_sample_kernel;
//   (iii) out = attn W_o + b_o, post-masked rows 0, stored as T.
template <typename T>
cudaError_t launch_fwd(const T* ents, const T* wqkv, const T* wo, const T* bo, const uint8_t* pm,
                       const uint8_t* qm, T* out, T* q, T* kv, const Dims& d, int grid,
                       int smem, cudaStream_t st) {
  using gemm::operand;
  using gemm::output;
  const int E = d.e, E2 = 2 * d.e, E3 = 3 * d.e;
  const int rows_e = d.bp * d.ne, rows_q = d.bp * d.nq;
  cudaError_t err;
#define REFIL_TRY(call) \
  if ((err = (call)) != cudaSuccess) return err
  REFIL_TRY((gemm::launch<T, T, true>(operand(ents, d.d), operand(wqkv + E, E3),
                                      output(kv, E2), rows_e, E2, d.d, 1, st)));
  REFIL_TRY((gemm::launch<T, T, true>(operand(ents, d.d, d.nq, d.ne), operand(wqkv, E3),
                                      output(q, E), rows_q, E, d.d, 1, st)));
  if (smem > kDefaultSmem)
    REFIL_TRY(cudaFuncSetAttribute(entity_attn_fwd_sample_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  entity_attn_fwd_sample_kernel<T><<<grid, 32 * d.h * d.spb, smem, st>>>(q, kv, pm, d);
  REFIL_TRY(cudaGetLastError());
  REFIL_TRY((gemm::launch<T, T, true, T, true>(operand(q, E), operand(wo, d.o),
                                               output(out, d.o, 1, 1, 0, 0, 0, bo, qm),
                                               rows_q, d.o, E, 1, st)));
#undef REFIL_TRY
  return cudaSuccess;
}

// Scratch of the backward, each (rows, columns) row-major. Planes of the
// inputs' type T, each holding only values the TPU kernel rounds to cdt
// before their next use, so in T they lose nothing:
//   q (Bp*Nq, E): Q (qkv, pallas_attn.py:256), then dq (dqkv, :312);
//   kv (Bp*Ne, 2E): K|V (:256), then dK|dV (:312);
//   da (Bp*Nq, E): dattn = g W_o^T (cast to cdt per head, :286-288, after
//     row_ok, by which it is 0 or itself: rounding it first changes no
//     value), then attn (:275);
//   gm (Bp*Nq, O): g * post_keep (g is T and post_keep 0 or 1: exact; :275);
//   wt (3E*D + O*E): the transposed weights.
// f32: partials (chunks, D*3E + E*O + O), the weight gradients' chunk
// partials, as dEnts, the outputs.
template <typename T>
struct BwdScratch {
  T *q, *kv, *da, *gm;
  float* partials;
  T* wt;  // W_qkv^T (3E, D), then W_o^T (O, E)
};

// The backward as stages on one stream:
//   (i)   W_qkv^T and W_o^T into wt; K|V = ents W_kv (Bp*Ne rows), Q =
//         ents[:, :Nq] W_q (Bp*Nq rows), dattn = g W_o^T, through gemm::launch;
//   (ii)  entity_attn_bwd_sample_kernel;
//   (iii) dEnts = dK|dV W_kv^T, then += dq W_q^T on the query rows; dW_kv =
//         ents^T dK|dV, dW_q = ents[:, :Nq]^T dq and dW_o = attn^T gm as
//         chunk partials of their tall K, db_o's partials from gm, and the
//         chunks summed in order.
template <typename T>
cudaError_t launch_bwd(const T* ents, const T* g, const T* wqkv, const T* wo, const uint8_t* pm,
                       const uint8_t* qm, float* dents, const BwdScratch<T>& s, float* dweights,
                       const Dims& d, int grid, int smem, int chunks, cudaStream_t st) {
  using gemm::operand;
  using gemm::output;
  const int E = d.e, E2 = 2 * d.e, E3 = 3 * d.e;
  const int rows_e = d.bp * d.ne, rows_q = d.bp * d.nq;
  const size_t n_w = (size_t)d.d * E3, n_wo = (size_t)E * d.o;
  const long long k_total = (long long)(n_w + n_wo + d.o);
  cudaError_t err;
#define REFIL_TRY(call) \
  if ((err = (call)) != cudaSuccess) return err
  // (i)
  const dim3 tr_threads(32, 8);
  entity_attn_transpose_kernel<T><<<dim3((E3 + 31) / 32, (d.d + 31) / 32), tr_threads, 0, st>>>(
      wqkv, d.d, E3, s.wt);
  entity_attn_transpose_kernel<T><<<dim3((d.o + 31) / 32, (E + 31) / 32), tr_threads, 0, st>>>(
      wo, E, d.o, s.wt + (size_t)E3 * d.d);
  REFIL_TRY(cudaGetLastError());
  const T* wqkv_t = s.wt;                      // (3E, D): W_q^T rows, then W_kv^T rows
  const T* wo_t = s.wt + (size_t)E3 * d.d;     // (O, E)
  REFIL_TRY((gemm::launch<T, T, true>(operand(ents, d.d), operand(wqkv + E, E3),
                                      output(s.kv, E2), rows_e, E2, d.d, 1, st)));
  REFIL_TRY((gemm::launch<T, T, true>(operand(ents, d.d, d.nq, d.ne), operand(wqkv, E3),
                                      output(s.q, E), rows_q, E, d.d, 1, st)));
  REFIL_TRY((gemm::launch<T, T, true>(operand(g, d.o), operand(wo_t, E), output(s.da, E),
                                      rows_q, E, d.o, 1, st)));
  // (ii)
  if (smem > kDefaultSmem)
    REFIL_TRY(cudaFuncSetAttribute(entity_attn_bwd_sample_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  entity_attn_bwd_sample_kernel<T><<<grid, 32 * d.h * d.spb, smem, st>>>(s.q, s.kv, s.da, g,
                                                                         pm, qm, s.gm, d);
  REFIL_TRY(cudaGetLastError());
  // (iii)
  REFIL_TRY((gemm::launch<T, T, true>(operand(s.kv, E2), operand(wqkv_t + E * d.d, d.d),
                                      output(dents, d.d), rows_e, d.d, E2, 1, st)));
  REFIL_TRY((gemm::launch<T, T, true>(operand(s.q, E), operand(wqkv_t, d.d),
                                      output(dents, d.d, d.nq, d.ne, 1), rows_q, d.d, E, 1, st)));
  REFIL_TRY((gemm::launch<T, T, false>(
      operand(ents, d.d), operand(s.kv, E2), output(s.partials + E, E3, 1, 1, 0, 0, k_total),
      d.d, E2, rows_e, chunks, st)));
  REFIL_TRY((gemm::launch<T, T, false>(
      operand(ents, d.d, d.nq, d.ne), operand(s.q, E),
      output(s.partials, E3, 1, 1, 0, 0, k_total), d.d, E, rows_q, chunks, st)));
  REFIL_TRY((gemm::launch<T, T, false>(
      operand(s.da, E), operand(s.gm, d.o), output(s.partials + n_w, d.o, 1, 1, 0, 0, k_total),
      E, d.o, rows_q, chunks, st)));
  entity_attn_colsum_kernel<T><<<chunks, 128, 0, st>>>(s.gm, rows_q, d.o, chunks,
                                                       (size_t)k_total, n_w + n_wo, s.partials);
  REFIL_TRY(cudaGetLastError());
  entity_attn_reduce_kernel<<<(int)((k_total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      s.partials, chunks, (int)k_total, dweights);
#undef REFIL_TRY
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Chooses the launch of a call's per-sample kernel: samples per block (a
// warp per head of each; the most of 8, 4, 2, 1 within 8 warps and 48 KB of
// shared memory, so several blocks share an SM), its grid (one block per
// group) and its shared memory; for the backward also the row chunks of the
// weight gradients (two blocks per SM for each single-tile product, each
// chunk at least 64 rows; 0 for the forward). Returns cudaErrorInvalidValue
// for more than 8 heads or if one sample's warps do not fit a block.
int entity_attn_plan(int bwd, int dtype, int bp, int ne, int nq, int d, int e, int o, int h,
                     int device, int* spb, int* grid, int* smem, int* chunks) {
  (void)dtype;  // the per-sample kernels hold f32 rows whatever the inputs' type
  int n_sm = 0, optin = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  for (int s = 8; s >= 1; s /= 2) {
    const size_t bytes = sample_smem(make_dims(bp, ne, nq, d, e, o, h, 0, s), bwd != 0);
    if (s > 1 && (h * s > 8 || bytes > 48 * 1024)) continue;
    if (h > 8 || bytes > (size_t)optin) break;
    *spb = s;
    *grid = (bp + s - 1) / s;
    *smem = (int)bytes;
    int c = 2 * n_sm;
    const int max_c = bp * nq / 64;
    if (c > max_c) c = max_c;
    *chunks = bwd ? (c < 1 ? 1 : c) : 0;
    return (int)cudaSuccess;
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16. pre may be null (no pre-mask). Scratch
// of the inputs' type q (Bp*Nq*E) and kv (Bp*Ne*2E); spb, grid and smem from
// entity_attn_plan(bwd = 0).
int entity_attn_fwd(int dtype, const void* ents, const void* wqkv, const void* wo,
                    const void* bo, const void* pre, const void* post, void* out, void* q,
                    void* kv, int bp, int ne, int nq, int d, int e, int o, int h, int mask_rows,
                    int spb, int grid, int smem, void* stream) {
  const Dims dims = make_dims(bp, ne, nq, d, e, o, h, pre ? mask_rows : 0, spb);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* pm = (const uint8_t*)pre;
  const uint8_t* qm = (const uint8_t*)post;
  typedef __nv_bfloat16 B;
  const cudaError_t err =
      dtype == 0 ? launch_fwd<float>((const float*)ents, (const float*)wqkv, (const float*)wo,
                                     (const float*)bo, pm, qm, (float*)out, (float*)q,
                                     (float*)kv, dims, grid, smem, st)
                 : launch_fwd<B>((const B*)ents, (const B*)wqkv, (const B*)wo, (const B*)bo, pm,
                                 qm, (B*)out, (B*)q, (B*)kv, dims, grid, smem, st);
  return (int)err;
}

// Scratch of the inputs' type q (Bp*Nq*E), kv (Bp*Ne*2E), da (Bp*Nq*E), gm
// (Bp*Nq*O) and wt (3E*D + O*E); f32 partials (chunks, D*3E + E*O + O);
// dweights: (D*3E + E*O + O,) f32, laid out as dW_qkv, dW_o, db_o. spb,
// grid, smem and chunks from entity_attn_plan(bwd = 1).
int entity_attn_bwd(int dtype, const void* ents, const void* g, const void* wqkv, const void* wo,
                    const void* pre, const void* post, void* dents, void* q, void* kv, void* da,
                    void* gm, void* wt, void* partials, void* dweights, int bp, int ne, int nq,
                    int d,
                    int e, int o, int h, int mask_rows, int spb, int grid, int smem, int chunks,
                    void* stream) {
  const Dims dims = make_dims(bp, ne, nq, d, e, o, h, pre ? mask_rows : 0, spb);
  typedef __nv_bfloat16 B;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* pm = (const uint8_t*)pre;
  const uint8_t* qm = (const uint8_t*)post;
  float* fp = (float*)partials;
  const cudaError_t err =
      dtype == 0
          ? launch_bwd<float>((const float*)ents, (const float*)g, (const float*)wqkv,
                              (const float*)wo, pm, qm, (float*)dents,
                              BwdScratch<float>{(float*)q, (float*)kv, (float*)da, (float*)gm,
                                                fp, (float*)wt},
                              (float*)dweights, dims, grid, smem, chunks, st)
          : launch_bwd<B>((const B*)ents, (const B*)g, (const B*)wqkv, (const B*)wo, pm, qm,
                          (float*)dents,
                          BwdScratch<B>{(B*)q, (B*)kv, (B*)da, (B*)gm, fp, (B*)wt},
                          (float*)dweights, dims, grid, smem, chunks, st);
  return (int)err;
}

// The matrix product of both directions alone (gemm.cuh), for its checks: C
// = A B with A of type ta, B of type tb, C of type tc (0 = float32, 1 =
// bfloat16), ka = 1 where A's contiguous index is k, row maps (group,
// stride), leading dimensions and the epilogue (bias of C's type, null or
// (N,); drop, null or a byte per row) as in gemm::Operand and gemm::Output.
// Takes the (ta, tb, ka, tc) the attention uses: float32 (0, 0, 1, 0), (0,
// 0, 0, 0), on the FMA instance; bfloat16 operands (1, 1, 1, 0), (1, 1, 0,
// 0), (1, 1, 1, 1), on the tensor cores; a bias or drop only with the
// output product's (0, 0, 1, 0) or (1, 1, 1, 1); any other returns
// cudaErrorInvalidValue.
int entity_attn_gemm(int ta, int tb, int ka, int tc, const void* a, long long lda, int a_group,
                     int a_stride, const void* b, long long ldb, void* c, long long ldc,
                     int c_group, int c_stride, int add, int round_bf16, long long chunk_stride,
                     const void* bias, const void* drop, int M, int N, int K, int chunks,
                     void* stream) {
  typedef __nv_bfloat16 B;
  const gemm::Operand A = gemm::operand(a, lda, a_group, a_stride);
  const gemm::Operand Bo = gemm::operand(b, ldb);
  const uint8_t* dr = (const uint8_t*)drop;
  cudaStream_t st = (cudaStream_t)stream;
  if (tc == 1) {
    if (ta != 1 || tb != 1 || ka != 1) return (int)cudaErrorInvalidValue;
    const gemm::Output<B> Cb = gemm::output((B*)c, ldc, c_group, c_stride, add, round_bf16,
                                            chunk_stride, (const B*)bias, dr);
    if (bias != nullptr || drop != nullptr)  // the bfloat16 forward's output product
      return (int)gemm::launch<B, B, true, B, true>(A, Bo, Cb, M, N, K, chunks, st);
    return (int)gemm::launch<B, B, true>(A, Bo, Cb, M, N, K, chunks, st);
  }
  const gemm::Output<float> C = gemm::output((float*)c, ldc, c_group, c_stride, add, round_bf16,
                                             chunk_stride, (const float*)bias, dr);
  if (bias != nullptr || drop != nullptr) {  // the float32 forward's output product
    if (ta != 0 || tb != 0 || ka != 1) return (int)cudaErrorInvalidValue;
    return (int)gemm::launch<float, float, true, float, true>(A, Bo, C, M, N, K, chunks, st);
  }
  switch (ta * 4 + tb * 2 + ka) {
    case 1: return (int)gemm::launch<float, float, true>(A, Bo, C, M, N, K, chunks, st);
    case 0: return (int)gemm::launch<float, float, false>(A, Bo, C, M, N, K, chunks, st);
    case 7: return (int)gemm::launch<B, B, true>(A, Bo, C, M, N, K, chunks, st);
    case 6: return (int)gemm::launch<B, B, false>(A, Bo, C, M, N, K, chunks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tile (rows x columns) the tensor-core instance takes for an M x N
// product in `chunks` split-K chunks on `device` (gemm::tc::tile_of)
int entity_attn_gemm_tile(int M, int N, int chunks, int device, int* rows, int* cols) {
  int n_sm = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  gemm::tc::tile_of(M, N, chunks, n_sm, rows, cols);
  return (int)cudaSuccess;
}

const char* entity_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
