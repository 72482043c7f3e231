// Masked entity attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of refil_tpu/ops/pallas_attn.py:
//   * entity_attn_fwd_kernel <- _kernel     (pallas_attn.py:87-131)
//   * entity_attn_bwd_kernel <- _bwd_kernel (pallas_attn.py:224-321), plus
//     entity_attn_dents_kernel, entity_attn_wgrad_kernel and
//     entity_attn_reduce_kernel, which form dEnts and the weight gradients
//     from what the backward wrote, summed in a fixed order.
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
// (qkv, the softmax weights fed to w@v, attn, g, dqkv, dl) are rounded here at
// the same points, so bf16 results follow the same rounding path.
//
// What bounds it on an H100: a sample reads Ne*D inputs and writes Nq*O
// outputs but does ~2*Ne*D*3E + 2*Nq*E*O multiply-adds for the projections
// (~95% of its arithmetic): at the combat widths (Ne 16, Nq 8, D = E = O =
// 128) ~1.9 MFLOP against ~12 KB, ~150 FLOP per byte; at f32 outside the
// tensor cores (67 TFLOP/s vs 3.35 TB/s, ~20 FLOP/byte) the arithmetic
// bounds it at every width the repository uses. The kernels project Q for
// all Ne rows though only the first Nq are read: at Ne 16, Nq 8 a sixth of
// the projection work is not needed (and not counted in the bound).
//
// Design (a simple one that is right first; tensor cores are later work):
//   * Persistent grid: each block walks groups of `spb` samples. Everything
//     of a group (entities, qkv, softmax weights, attn, and in the backward
//     g, dattn, dl) lives in shared memory. Ne is small, so the (Nq, Ne)
//     score tiles are plain loops.
//   * Weights: W_qkv (D x 3E) and W_o (E x O) are read in slices of `ks`
//     rows through two rings of two slots in shared memory; slice s+1 is in
//     flight (cp.async) while slice s is multiplied. Each slice serves every
//     sample of the group, and the weights stay hot in L2 across groups. At
//     the Group Matching widths (64) both matrices fit at once: the plan
//     then makes each ring one slot of all rows, loaded once per block
//     (resident). At the combat widths (128; 262 KB of f32 weights, more
//     than the 227 KB a block may have) they stream.
//   * A slice of W_qkv or W_o rows is a K-slice of qkv = x @ W_qkv and
//     out = attn @ W_o and an N-slice of the transposed product
//     dattn = g @ W_o^T (complete columns).
//   * The products go through tile_gemm: each thread keeps a 4 x 2..6 tile
//     of the result in registers, so one shared-memory load feeds 2-4 FMAs;
//     loops that would send a warp to one bank (a stride of 3E or O) start
//     each thread at a rotated offset. Over streamed K-slices, stream_gemm
//     keeps each thread's partial sums (up to 4 tiles) in registers from the
//     first slice to the last. Resident and streamed are separate kernel
//     instances, so the streamed one's ~200 registers do not cut the
//     resident one's occupancy.
//   * Backward: blocks run concurrently, so the TPU kernel's += into one
//     weight-gradient block (pallas_attn.py:274-278) would race, and at the
//     combat widths a block's partial would not fit in shared memory. The
//     per-sample kernel writes dqkv (Bp, Ne, 3E), attn (Bp, Nq, E) and the
//     post-masked g (Bp, Nq, O) in f32 to device memory. Tiled products over
//     all rows then take the projections' gradients, each block one 64 x 64
//     output tile: entity_attn_dents_kernel dEnts = dqkv W_qkv^T over all of
//     3E; entity_attn_wgrad_kernel dW_qkv = ents^T dqkv, dW_o = attn^T g,
//     db_o = sum g over one chunk of rows, and entity_attn_reduce_kernel sums
//     the chunks in order. No atomics: the result is deterministic.
//
// Interface: plain C (extern "C"), loaded with ctypes. The wrapper allocates
// every output and scratch buffer; each launcher enqueues on the stream it is
// given and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -1e9f;
constexpr int kTile = 64;     // output tile of the dEnts and weight-gradient products
constexpr int kRowStep = 16;  // depth of those products staged in shared memory at once

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
  __device__ static float round(float x) { return x; }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f(float x) { return __float2bfloat16(x); }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16(x)); }
};

struct Dims {
  int bp, ne, nq, d, e, o, h;
  int mask_rows;  // rows of the pre-mask per sample (>= nq); 0 = no pre-mask
  int spb;        // samples per block iteration
  int ks;         // weight rows per slice; >= max(d, e) = resident
  float scale;
};

__host__ __device__ inline bool resident(const Dims& d) { return d.ks >= d.d && d.ks >= d.e; }

// Shared-memory layout: the two weight rings (elements of T), then f32
// regions. Offsets of the rings in bytes, of the rest in floats from `f0`.
struct Layout {
  size_t ring_q, ring_o, slot_q, slot_o;  // bytes
  size_t f0;                              // bytes where the f32 regions start
  size_t bo, x, qkv, p, a, rowok, post, mask;  // forward
  size_t out, da, dl;                          // backward only (out holds g)
  size_t fwd_bytes, bwd_bytes;
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

__host__ __device__ inline Layout make_layout(const Dims& d, size_t elem) {
  Layout L;
  const size_t c3 = 3 * (size_t)d.e, s = d.spb;
  const bool res = resident(d);
  const int slots = res ? 1 : 2;
  L.slot_q = align16((size_t)(res ? d.d : d.ks) * c3 * elem);
  L.slot_o = align16((size_t)(res ? d.e : d.ks) * d.o * elem);
  L.ring_q = 0;
  L.ring_o = slots * L.slot_q;
  L.f0 = L.ring_o + slots * L.slot_o;
  size_t off = 0;
  L.bo = off;    off += d.o;
  L.x = off;     off += s * d.ne * d.d;
  L.qkv = off;   off += s * d.ne * c3;
  L.p = off;     off += s * d.h * d.nq * d.ne;
  L.a = off;     off += s * d.nq * d.e;
  L.rowok = off; off += s * d.nq;
  L.post = off;  off += s * d.nq;
  L.mask = off;  off += s * d.nq * d.ne;
  L.fwd_bytes = L.f0 + off * sizeof(float);
  L.out = off;   off += s * d.nq * d.o;  // g in the backward
  L.da = off;    off += s * d.nq * d.e;
  L.dl = off;    off += s * d.h * d.nq * d.ne;
  L.bwd_bytes = L.f0 + off * sizeof(float);
  return L;
}

// n elements from global src to shared dst: 16-byte cp.async where both
// ends are 16-byte aligned and the size is a multiple of 16 bytes, else a
// plain copy (visible after the next __syncthreads).
template <typename T>
__device__ void copy_to_shared(T* dst, const T* src, int n) {
  const size_t bytes = (size_t)n * sizeof(T);
  if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0 && bytes % 16 == 0) {
    const int n16 = (int)(bytes / 16);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) {
      const unsigned s = (unsigned)__cvta_generic_to_shared(reinterpret_cast<char*>(dst) + 16 * i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(reinterpret_cast<const char*>(src) + 16 * i));
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Walks the rows [0, K) of W (K x N, row-major) in slices of `ks` rows
// through `ring` (two slots of `slot` bytes; one slot of all rows when
// resident) and calls body(k0, kn, slice) for each slice in order, slice
// s+1 loading while body runs on slice s. `loaded`: a resident ring already
// holds W. Starts and ends synchronised.
template <typename T, class F>
__device__ void stream_rows(const T* W, int K, int N, int ks, char* ring, size_t slot,
                            bool loaded, F body) {
  const int n_slices = (K + ks - 1) / ks;
  __syncthreads();  // earlier readers of the ring are done
  if (!loaded) copy_to_shared(reinterpret_cast<T*>(ring), W, min(ks, K) * N);
  cp_async_commit();
  for (int s = 0; s < n_slices; ++s) {
    const int k0 = s * ks, kn = min(ks, K - k0);
    if (s + 1 < n_slices)
      copy_to_shared(reinterpret_cast<T*>(ring + ((s + 1) & 1) * slot), W + (size_t)(k0 + ks) * N,
                     min(ks, K - k0 - ks) * N);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    body(k0, kn, reinterpret_cast<const T*>(ring + (s & 1) * slot));
    __syncthreads();
  }
}

// C (M x N) = sum over k of A(m, k) * B(k, n), operands in shared memory.
// Each thread computes a TM x TN tile of C in registers, so one operand load
// feeds several FMAs. A tile's rows and columns are interleaved
// (m = tm + i * tiles_m, n = tn + j * tiles_n): neighbouring threads read
// neighbouring columns of a row-major B. With ROT each thread starts k at its
// own offset, which spreads a warp's reads of an operand read along k (a
// transposed B) over the banks. `store(m, n, c)` writes each element once.
template <int TM, int TN, bool ROT, class FA, class FB, class FC>
__device__ __forceinline__ void tile_gemm(int M, int N, int K, FA a, FB b, FC store) {
  const int tiles_m = (M + TM - 1) / TM, tiles_n = (N + TN - 1) / TN;
  for (int t = threadIdx.x; t < tiles_m * tiles_n; t += blockDim.x) {
    const int tm = t / tiles_n, tn = t - tm * tiles_n;
    int ms[TM], ns[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) ms[i] = min(tm + i * tiles_m, M - 1);  // loads stay in range
#pragma unroll
    for (int j = 0; j < TN; ++j) ns[j] = min(tn + j * tiles_n, N - 1);
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    int k = ROT ? tn % K : 0;
    for (int kk = 0; kk < K; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a(ms[i], k);
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = b(k, ns[j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      if (++k == K) k = 0;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = tm + i * tiles_m;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = tn + j * tiles_n;
        if (m < M && n < N) store(m, n, acc[i][j]);
      }
    }
  }
}

// C (M x N) = sum over k of A(m, k) * W[k][n], A in shared memory, W (K x N,
// row-major) in global memory streamed through `ring` by stream_rows. Each
// thread owns up to MAXT tiles of TM x TN outputs (interleaved as in
// tile_gemm) and keeps their sums in registers across all slices, so no
// partial sum goes back to shared memory; `store(m, n, c)` writes each
// element once at the end. Tiles beyond MAXT per thread take further passes
// over W.
template <typename T, int TM, int TN, int MAXT, class FA, class FC>
__device__ void stream_gemm(int M, int N, int K, FA a, const T* W, int ks, char* ring,
                            size_t slot, FC store) {
  const int tiles_m = (M + TM - 1) / TM, tiles_n = (N + TN - 1) / TN;
  const int n_tiles = tiles_m * tiles_n, per_pass = MAXT * (int)blockDim.x;
  for (int base = 0; base < n_tiles; base += per_pass) {
    float acc[MAXT][TM][TN];
#pragma unroll
    for (int u = 0; u < MAXT; ++u)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[u][i][j] = 0.f;
    stream_rows<T>(W, K, N, ks, ring, slot, false,
                   [&](int k0, int kn, const T* w) {
#pragma unroll
                     for (int u = 0; u < MAXT; ++u) {
                       const int t = base + threadIdx.x + u * blockDim.x;
                       if (t < n_tiles) {
                         const int tm = t / tiles_n, tn = t - tm * tiles_n;
                         int ms[TM], ns[TN];
#pragma unroll
                         for (int i = 0; i < TM; ++i) ms[i] = min(tm + i * tiles_m, M - 1);
#pragma unroll
                         for (int j = 0; j < TN; ++j) ns[j] = min(tn + j * tiles_n, N - 1);
                         for (int kk = 0; kk < kn; ++kk) {
                           float av[TM], bv[TN];
#pragma unroll
                           for (int i = 0; i < TM; ++i) av[i] = a(ms[i], k0 + kk);
#pragma unroll
                           for (int j = 0; j < TN; ++j) bv[j] = Num<T>::to_f(w[kk * N + ns[j]]);
#pragma unroll
                           for (int i = 0; i < TM; ++i)
#pragma unroll
                             for (int j = 0; j < TN; ++j)
                               acc[u][i][j] = fmaf(av[i], bv[j], acc[u][i][j]);
                         }
                       }
                     }
                   });
#pragma unroll
    for (int u = 0; u < MAXT; ++u) {
      const int t = base + threadIdx.x + u * blockDim.x;
      if (t >= n_tiles) continue;
      const int tm = t / tiles_n, tn = t - tm * tiles_n;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = tm + i * tiles_m;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = tn + j * tiles_n;
          if (m < M && n < N) store(m, n, acc[u][i][j]);
        }
      }
    }
    __syncthreads();  // stores done before the caller reads them
  }
}

// Loads entities and masks of samples [s0, s0 + ns) and derives row_ok.
// Ends synchronised.
template <typename T>
__device__ void load_group(const T* ents, const uint8_t* pre, const uint8_t* post, int s0,
                           int ns, const Dims& d, float* sx, float* smask, float* srowok,
                           float* spost) {
  const int nx = ns * d.ne * d.d, rows = ns * d.nq, nm = rows * d.ne;
  const T* src = ents + (size_t)s0 * d.ne * d.d;
  for (int i = threadIdx.x; i < nx; i += blockDim.x) sx[i] = Num<T>::to_f(src[i]);
  for (int i = threadIdx.x; i < nm; i += blockDim.x) {
    const int s = i / (d.nq * d.ne), r = i - s * (d.nq * d.ne);
    smask[i] = pre ? (float)pre[((size_t)s0 + s) * d.mask_rows * d.ne + r] : 0.f;
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x)
    spost[i] = post[(size_t)s0 * d.nq + i] ? 0.f : 1.f;
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    float ok = 0.f;
    for (int j = 0; j < d.ne; ++j)
      if (smask[i * d.ne + j] == 0.f) { ok = 1.f; break; }
    srowok[i] = ok;
  }
  __syncthreads();
}

struct Smem {
  char* ring_q;
  char* ring_o;
  float *bo, *x, *qkv, *p, *a, *rowok, *post, *mask, *out, *da, *dl;
};

__device__ inline Smem carve(char* base, const Layout& L) {
  Smem s;
  s.ring_q = base + L.ring_q;
  s.ring_o = base + L.ring_o;
  float* f = reinterpret_cast<float*>(base + L.f0);
  s.bo = f + L.bo; s.x = f + L.x; s.qkv = f + L.qkv; s.p = f + L.p; s.a = f + L.a;
  s.rowok = f + L.rowok; s.post = f + L.post; s.mask = f + L.mask; s.out = f + L.out;
  s.da = f + L.da; s.dl = f + L.dl;
  return s;
}

// Forward of one group up to attn (row_ok applied), rounded as the TPU
// kernel rounds. sp holds the f32 softmax weights (s, h, q, j). Ends
// synchronised.
template <typename T, bool RES>
__device__ void forward_group(int ns, const Dims& d, const Layout& L, const T* wqkv, bool loaded,
                              const Smem& S) {
  const int c3 = 3 * d.e, hd = d.e / d.h, D = d.d;
  float* sqkv = S.qkv;
  const float* sx = S.x;
  const auto a = [=](int m, int k) { return sx[m * D + k]; };
  const auto st = [=](int m, int n, float c) { sqkv[m * c3 + n] = Num<T>::round(c); };
  if (RES) {
    stream_rows<T>(wqkv, D, c3, d.ks, S.ring_q, L.slot_q, loaded, [&](int, int, const T* w) {
      tile_gemm<4, 6, false>(ns * d.ne, c3, D, a,
                             [=](int k, int n) { return Num<T>::to_f(w[k * c3 + n]); }, st);
    });
  } else {
    stream_gemm<T, 4, 6, 4>(ns * d.ne, c3, D, a, wqkv, d.ks, S.ring_q, L.slot_q, st);
  }

  float* sp = S.p;
  const int n_p = ns * d.h * d.nq * d.ne;
  for (int i = threadIdx.x; i < n_p; i += blockDim.x) {
    int t = i / d.ne;
    const int j = i - t * d.ne;
    const int q = t % d.nq;
    t /= d.nq;
    const int h = t % d.h, s = t / d.h;
    const float* qr = sqkv + (s * d.ne + q) * c3 + h * hd;
    const float* kr = sqkv + (s * d.ne + j) * c3 + d.e + h * hd;
    const int k0 = j % hd;
    float acc = 0.f;
    for (int kk = 0; kk < hd; ++kk) {
      int k = kk + k0;
      if (k >= hd) k -= hd;
      acc = fmaf(qr[k], kr[k], acc);
    }
    sp[i] = S.mask[(s * d.nq + q) * d.ne + j] != 0.f ? kNeg : acc * d.scale;
  }
  __syncthreads();

  const int n_rows = ns * d.h * d.nq;
  for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
    float* row = sp + r * d.ne;
    float m = row[0];
    for (int j = 1; j < d.ne; ++j) m = fmaxf(m, row[j]);
    float sum = 0.f;
    for (int j = 0; j < d.ne; ++j) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    for (int j = 0; j < d.ne; ++j) row[j] = row[j] / sum;
  }
  __syncthreads();

  const int n_a = ns * d.nq * d.e;
  for (int i = threadIdx.x; i < n_a; i += blockDim.x) {
    const int row = i / d.e, e = i - row * d.e;  // row = s * nq + q
    const int s = row / d.nq, q = row - s * d.nq, h = e / hd;
    const float* wr = sp + ((s * d.h + h) * d.nq + q) * d.ne;
    const float* vc = sqkv + (size_t)s * d.ne * c3 + 2 * d.e + e;
    float acc = 0.f;
    for (int j = 0; j < d.ne; ++j) acc = fmaf(Num<T>::round(wr[j]), vc[j * c3], acc);
    S.a[i] = Num<T>::round(acc * S.rowok[row]);
  }
  __syncthreads();
}

template <typename T, bool RES>
__global__ void __launch_bounds__(kThreads)
entity_attn_fwd_kernel(const T* __restrict__ ents, const T* __restrict__ wqkv,
                       const T* __restrict__ wo, const T* __restrict__ bo,
                       const uint8_t* __restrict__ pre, const uint8_t* __restrict__ post,
                       T* __restrict__ out, Dims d) {
  extern __shared__ __align__(16) char smem[];
  const Layout L = make_layout(d, sizeof(T));
  const Smem S = carve(smem, L);
  for (int i = threadIdx.x; i < d.o; i += blockDim.x) S.bo[i] = Num<T>::to_f(bo[i]);
  bool loaded = false;
  for (int s0 = blockIdx.x * d.spb; s0 < d.bp; s0 += gridDim.x * d.spb) {
    const int ns = min(d.spb, d.bp - s0);
    load_group<T>(ents, pre, post, s0, ns, d, S.x, S.mask, S.rowok, S.post);
    forward_group<T, RES>(ns, d, L, wqkv, loaded, S);
    const int E = d.e, O = d.o;
    const float *sa = S.a, *sbo = S.bo, *spost = S.post;
    T* dst = out + (size_t)s0 * d.nq * d.o;
    const auto a = [=](int m, int k) { return sa[m * E + k]; };
    const auto st = [=](int m, int n, float c) {
      dst[m * O + n] = Num<T>::from_f((c + sbo[n]) * spost[m]);
    };
    if (RES) {
      stream_rows<T>(wo, E, O, d.ks, S.ring_o, L.slot_o, loaded, [&](int, int, const T* w) {
        tile_gemm<4, 2, false>(ns * d.nq, O, E, a,
                               [=](int k, int n) { return Num<T>::to_f(w[k * O + n]); }, st);
      });
    } else {
      stream_gemm<T, 4, 2, 2>(ns * d.nq, O, E, a, wo, d.ks, S.ring_o, L.slot_o, st);
    }
    loaded = RES;
  }
}

// Per-sample backward: recomputes the forward and writes, as f32, dqkv (for
// entity_attn_dents_kernel and entity_attn_wgrad_kernel), attn and the
// post-masked g (for entity_attn_wgrad_kernel).
template <typename T, bool RES>
__global__ void __launch_bounds__(kThreads)
entity_attn_bwd_kernel(const T* __restrict__ ents, const T* __restrict__ g,
                       const T* __restrict__ wqkv, const T* __restrict__ wo,
                       const uint8_t* __restrict__ pre, const uint8_t* __restrict__ post,
                       float* __restrict__ dqkv_out, float* __restrict__ attn_out,
                       float* __restrict__ g_out, Dims d) {
  extern __shared__ __align__(16) char smem[];
  const Layout L = make_layout(d, sizeof(T));
  const Smem S = carve(smem, L);
  const int c3 = 3 * d.e, hd = d.e / d.h;
  bool loaded = false;

  for (int s0 = blockIdx.x * d.spb; s0 < d.bp; s0 += gridDim.x * d.spb) {
    const int ns = min(d.spb, d.bp - s0);
    const int rows = ns * d.nq;
    load_group<T>(ents, pre, post, s0, ns, d, S.x, S.mask, S.rowok, S.post);
    forward_group<T, RES>(ns, d, L, wqkv, loaded, S);

    // out = (attn @ W_o + b_o) * post_keep: g flows through post_keep first
    const T* gsrc = g + (size_t)s0 * d.nq * d.o;
    float* sg = S.out;
    for (int i = threadIdx.x; i < rows * d.o; i += blockDim.x) {
      const float v = Num<T>::to_f(gsrc[i]) * S.post[i / d.o];
      sg[i] = v;
      g_out[(size_t)s0 * d.nq * d.o + i] = v;
    }
    for (int i = threadIdx.x; i < rows * d.e; i += blockDim.x)
      attn_out[(size_t)s0 * d.nq * d.e + i] = S.a[i];
    const int E = d.e, O = d.o;
    // dattn = g @ W_o^T, one slice of W_o rows (columns e of dattn) at a
    // time; row_ok folds into the attention gradient
    float* sda = S.da;
    const float* srowok = S.rowok;
    stream_rows<T>(wo, E, O, d.ks, S.ring_o, L.slot_o, loaded,
                   [&](int e0, int kn, const T* w) {
                     auto a = [=](int m, int k) { return Num<T>::round(sg[m * O + k]); };
                     auto b = [=](int k, int n) { return Num<T>::to_f(w[n * O + k]); };
                     auto st = [=](int m, int n, float c) { sda[m * E + e0 + n] = c * srowok[m]; };
                     // a streamed slice is a narrow N: smaller tiles keep the threads busy
                     if (RES) tile_gemm<4, 2, true>(rows, kn, O, a, b, st);
                     else tile_gemm<1, 1, true>(rows, kn, O, a, b, st);
                   });

    // dw = dattn_h @ v_h^T per (s, h, q, j)
    float* sdl = S.dl;
    const float* sqkv = S.qkv;
    const float* sp = S.p;
    const int n_p = ns * d.h * d.nq * d.ne;
    for (int i = threadIdx.x; i < n_p; i += blockDim.x) {
      int t = i / d.ne;
      const int j = i - t * d.ne;
      const int q = t % d.nq;
      t /= d.nq;
      const int h = t % d.h, s = t / d.h;
      const float* dar = sda + (s * d.nq + q) * d.e + h * hd;
      const float* vr = sqkv + (s * d.ne + j) * c3 + 2 * d.e + h * hd;
      const int k0 = j % hd;
      float acc = 0.f;
      for (int kk = 0; kk < hd; ++kk) {
        int k = kk + k0;
        if (k >= hd) k -= hd;
        acc = fmaf(Num<T>::round(dar[k]), vr[k], acc);
      }
      sdl[i] = acc;
    }
    __syncthreads();
    // softmax VJP: dl = w * (dw - sum(dw * w))
    for (int r = threadIdx.x; r < ns * d.h * d.nq; r += blockDim.x) {
      const float* wr = sp + r * d.ne;
      float* dr = sdl + r * d.ne;
      float dot = 0.f;
      for (int j = 0; j < d.ne; ++j) dot += dr[j] * wr[j];
      for (int j = 0; j < d.ne; ++j) dr[j] = Num<T>::round(wr[j] * (dr[j] - dot));
    }
    __syncthreads();

    // dqkv (s, n, c): dq rows >= nq stay 0
    float* qdst = dqkv_out + (size_t)s0 * d.ne * c3;
    const int n_qkv = ns * d.ne * c3;
    for (int i = threadIdx.x; i < n_qkv; i += blockDim.x) {
      const int row = i / c3, c = i - row * c3;
      const int s = row / d.ne, n = row - s * d.ne;
      const float* base = sqkv + (size_t)s * d.ne * c3;
      float val = 0.f;
      if (c < d.e) {
        if (n < d.nq) {
          const float* dr = sdl + ((s * d.h + c / hd) * d.nq + n) * d.ne;
          float acc = 0.f;
          for (int j = 0; j < d.ne; ++j) acc = fmaf(dr[j], base[j * c3 + d.e + c], acc);
          val = acc * d.scale;
        }
      } else if (c < 2 * d.e) {
        const int e = c - d.e;
        const float* dc = sdl + (s * d.h + e / hd) * d.nq * d.ne + n;
        float acc = 0.f;
        for (int q = 0; q < d.nq; ++q) acc = fmaf(dc[q * d.ne], base[q * c3 + e], acc);
        val = acc * d.scale;
      } else {
        const int e = c - 2 * d.e;
        const float* wc = sp + (s * d.h + e / hd) * d.nq * d.ne + n;
        const float* dac = sda + (size_t)s * d.nq * d.e + e;
        float acc = 0.f;
        for (int q = 0; q < d.nq; ++q)
          acc = fmaf(Num<T>::round(wc[q * d.ne]), Num<T>::round(dac[q * d.e]), acc);
        val = acc;
      }
      qdst[i] = Num<T>::round(val);
    }
    __syncthreads();  // the next group's loads overwrite what this loop reads
    loaded = RES;
  }
}

// dEnts (R x D) = dqkv (R x C, f32) @ W_qkv^T (W_qkv: D x C), R = Bp*Ne,
// C = 3E: each block one kTile x kTile output tile over all of C, staged
// kRowStep columns at a time; 16 x 16 threads, 4 x 4 outputs each.
template <typename T>
__global__ void __launch_bounds__(kThreads)
entity_attn_dents_kernel(const float* __restrict__ dqkv, const T* __restrict__ w,
                         float* __restrict__ dents, int R, int D, int C) {
  __shared__ float sa[kRowStep][kTile + 1];  // [k][row]
  __shared__ float sb[kRowStep][kTile + 1];  // [k][column of dents]
  const int r0 = blockIdx.x * kTile, d0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int k0 = 0; k0 < C; k0 += kRowStep) {
    for (int u = threadIdx.x; u < kRowStep * kTile; u += blockDim.x) {
      const int i = u / kRowStep, kk = u - i * kRowStep, k = k0 + kk;
      sa[kk][i] = (r0 + i < R && k < C) ? dqkv[(size_t)(r0 + i) * C + k] : 0.f;
      sb[kk][i] = (d0 + i < D && k < C) ? Num<T>::to_f(w[(size_t)(d0 + i) * C + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kRowStep; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = sa[kk][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = sb[kk][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int dd = d0 + tx + 16 * b;
      if (r < R && dd < D) dents[(size_t)r * D + dd] = acc[a][b];
    }
  }
}

// The three weight-gradient products of the backward, each as tiles of
// kTile x kTile outputs: out_p = X_p^T Y_p over the rows of chunk c.
//   p = 0: dW_qkv (D x 3E) from X = ents (Bp*Ne x D, T), Y = dqkv (f32)
//   p = 1: dW_o (E x O) from X = attn (Bp*Nq x E, f32), Y = g (f32)
//   p = 2: db_o (1 x O) from X = ones, Y = g
// Block (tile, chunk) writes its tile of partials[chunk]; the chunks are
// summed in order by entity_attn_reduce_kernel.
struct WgradProduct {
  const void* x;  // null = ones
  bool x_is_t;    // X has the input type T (else f32)
  const float* y;
  int rows, p, q;
  size_t offset;  // of this product in a partials row
};

struct WgradArgs {
  WgradProduct prod[3];
  int tiles[3];  // tiles of each product
  int n_chunks;
  size_t k_total;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
entity_attn_wgrad_kernel(WgradArgs args, float* __restrict__ partials) {
  __shared__ float sx[kRowStep * kTile];
  __shared__ float sy[kRowStep * kTile];
  int t = blockIdx.x, pi = 0;
  while (pi < 2 && t >= args.tiles[pi]) t -= args.tiles[pi++];
  const WgradProduct& P = args.prod[pi];
  const int tiles_q = (P.q + kTile - 1) / kTile;
  const int i0 = (t / tiles_q) * kTile, j0 = (t % tiles_q) * kTile;
  const int chunk = blockIdx.y;
  const int r_begin = (int)((long long)P.rows * chunk / args.n_chunks);
  const int r_end = (int)((long long)P.rows * (chunk + 1) / args.n_chunks);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // 16 x 16 threads, 4 x 4 outputs each
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int r0 = r_begin; r0 < r_end; r0 += kRowStep) {
    const int nr = min(kRowStep, r_end - r0);
    for (int u = threadIdx.x; u < kRowStep * kTile; u += blockDim.x) {
      const int rr = u / kTile, cc = u - rr * kTile;
      const int i = i0 + cc, j = j0 + cc;
      const size_t r = (size_t)r0 + rr;
      float xv = 0.f;
      if (rr < nr && i < P.p) {
        if (P.x == nullptr) xv = 1.f;
        else if (P.x_is_t) xv = Num<T>::to_f(static_cast<const T*>(P.x)[r * P.p + i]);
        else xv = static_cast<const float*>(P.x)[r * P.p + i];
      }
      sx[u] = xv;
      sy[u] = (rr < nr && j < P.q) ? P.y[r * P.q + j] : 0.f;
    }
    __syncthreads();
    for (int rr = 0; rr < nr; ++rr) {
      float xv[4], yv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) xv[a] = sx[rr * kTile + ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) yv[b] = sy[rr * kTile + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xv[a], yv[b], acc[a][b]);
    }
    __syncthreads();
  }
  float* dst = partials + (size_t)chunk * args.k_total + P.offset;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx + 16 * b;
      if (i < P.p && j < P.q) dst[(size_t)i * P.q + j] = acc[a][b];
    }
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

Dims make_dims(int bp, int ne, int nq, int d, int e, int o, int h, int mask_rows, int spb,
               int ks) {
  Dims dims;
  dims.bp = bp; dims.ne = ne; dims.nq = nq; dims.d = d; dims.e = e; dims.o = o; dims.h = h;
  dims.mask_rows = mask_rows;
  dims.spb = spb;
  dims.ks = ks;
  dims.scale = (float)(1.0 / sqrt((double)(e / h)));  // the Python-float scale
  return dims;
}

int tiles_of(int p, int q) { return ((p + kTile - 1) / kTile) * ((q + kTile - 1) / kTile); }

// One instance per (type, resident): the streamed instance keeps ~200
// registers of partial sums per thread, which would halve the resident
// instance's occupancy if they shared one register allocation.
template <typename T, bool RES>
cudaError_t launch_fwd(const void* ents, const void* wqkv, const void* wo, const void* bo,
                       const uint8_t* pm, const uint8_t* qm, void* out, const Dims& dims,
                       int grid, int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(entity_attn_fwd_kernel<T, RES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  entity_attn_fwd_kernel<T, RES><<<grid, kThreads, smem, st>>>(
      (const T*)ents, (const T*)wqkv, (const T*)wo, (const T*)bo, pm, qm, (T*)out, dims);
  return cudaGetLastError();
}

template <typename T, bool RES>
cudaError_t launch_bwd(const void* ents, const void* g, const void* wqkv, const void* wo,
                       const uint8_t* pm, const uint8_t* qm, void* dqkv, void* attn, void* gm,
                       const Dims& dims, int grid, int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(entity_attn_bwd_kernel<T, RES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  entity_attn_bwd_kernel<T, RES><<<grid, kThreads, smem, st>>>(
      (const T*)ents, (const T*)g, (const T*)wqkv, (const T*)wo, pm, qm, (float*)dqkv,
      (float*)attn, (float*)gm, dims);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Chooses the launch of a call: samples per block iteration (spb), weight
// rows per slice (ks; >= max(d, e) means the weights stay resident), the
// persistent grid, the dynamic shared memory in bytes, and, for the
// backward, the row chunks of the weight-gradient products. The most
// samples per block first; at each, resident where both weight matrices fit
// beside the group, else the weights stream in slices of 16 or 8 rows. Returns cudaErrorInvalidValue if
// even one sample per block does not fit.
int entity_attn_plan(int bwd, int dtype, int bp, int ne, int nq, int d, int e, int o, int h,
                     int device, int* spb, int* ks, int* grid, int* smem, int* chunks) {
  int n_sm = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return (int)err;
  const size_t elem = dtype == 0 ? 4 : 2;
  const int res_ks = d > e ? d : e;
  const int ks_try[3] = {res_ks, 16, 8};
  for (int s = 4; s >= 1; s /= 2) {
    for (int ki = 0; ki < 3; ++ki) {
      if (ki > 0 && ks_try[ki] >= res_ks) continue;  // streaming only where it changes something
      const Layout L = make_layout(make_dims(bp, ne, nq, d, e, o, h, 0, s, ks_try[ki]), elem);
      const size_t bytes = bwd ? L.bwd_bytes : L.fwd_bytes;
      if (bytes > (size_t)optin) continue;
      int blocks_per_sm = (int)(per_sm / (bytes + 1024));
      if (blocks_per_sm < 1) blocks_per_sm = 1;
      if (blocks_per_sm > 4) blocks_per_sm = 4;
      const int need = (bp + s - 1) / s;
      const int cap = n_sm * blocks_per_sm;
      *spb = s;
      *ks = ks_try[ki];
      *grid = need < cap ? need : cap;
      *smem = (int)bytes;
      // weight-gradient chunks: about 4 blocks per SM, at least kRowStep rows each
      const int tiles = tiles_of(d, 3 * e) + tiles_of(e, o) + tiles_of(1, o);
      int c = (4 * n_sm + tiles - 1) / tiles;
      const int max_c = (bp * nq + kRowStep - 1) / kRowStep;
      if (c > max_c) c = max_c;
      *chunks = c < 1 ? 1 : c;
      return (int)cudaSuccess;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16. pre may be null (no pre-mask). Weights
// that are not 16-byte aligned are copied without cp.async (slower, same
// result).
int entity_attn_fwd(int dtype, const void* ents, const void* wqkv, const void* wo,
                    const void* bo, const void* pre, const void* post, void* out, int bp, int ne,
                    int nq, int d, int e, int o, int h, int mask_rows, int spb, int ks, int grid,
                    int smem, void* stream) {
  const Dims dims = make_dims(bp, ne, nq, d, e, o, h, pre ? mask_rows : 0, spb, ks);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* pm = (const uint8_t*)pre;
  const uint8_t* qm = (const uint8_t*)post;
  typedef __nv_bfloat16 B;
  const bool res = resident(dims);
  const cudaError_t err =
      dtype == 0 ? (res ? launch_fwd<float, true> : launch_fwd<float, false>)(
                       ents, wqkv, wo, bo, pm, qm, out, dims, grid, smem, st)
                 : (res ? launch_fwd<B, true> : launch_fwd<B, false>)(
                       ents, wqkv, wo, bo, pm, qm, out, dims, grid, smem, st);
  return (int)err;
}

// scratch: f32 dqkv (Bp*Ne*3E), attn (Bp*Nq*E), g (Bp*Nq*O); partials:
// (chunks, D*3E + E*O + O) f32; dweights: (D*3E + E*O + O,) f32, laid out as
// dW_qkv, dW_o, db_o.
int entity_attn_bwd(int dtype, const void* ents, const void* g, const void* wqkv, const void* wo,
                    const void* pre, const void* post, void* dents, void* dqkv, void* attn,
                    void* gm, void* partials, void* dweights, int bp, int ne, int nq, int d,
                    int e, int o, int h, int mask_rows, int spb, int ks, int grid, int smem,
                    int chunks, void* stream) {
  const Dims dims = make_dims(bp, ne, nq, d, e, o, h, pre ? mask_rows : 0, spb, ks);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* pm = (const uint8_t*)pre;
  const uint8_t* qm = (const uint8_t*)post;
  cudaError_t err;
  WgradArgs wa;
  const size_t n_w = (size_t)d * 3 * e, n_wo = (size_t)e * o;
  wa.prod[0] = {ents, true, (const float*)dqkv, bp * ne, d, 3 * e, 0};
  wa.prod[1] = {attn, false, (const float*)gm, bp * nq, e, o, n_w};
  wa.prod[2] = {nullptr, false, (const float*)gm, bp * nq, 1, o, n_w + n_wo};
  wa.tiles[0] = tiles_of(d, 3 * e);
  wa.tiles[1] = tiles_of(e, o);
  wa.tiles[2] = tiles_of(1, o);
  wa.n_chunks = chunks;
  wa.k_total = n_w + n_wo + o;
  const dim3 wgrid(wa.tiles[0] + wa.tiles[1] + wa.tiles[2], chunks);
  typedef __nv_bfloat16 B;
  const bool res = resident(dims);
  err = dtype == 0 ? (res ? launch_bwd<float, true> : launch_bwd<float, false>)(
                         ents, g, wqkv, wo, pm, qm, dqkv, attn, gm, dims, grid, smem, st)
                   : (res ? launch_bwd<B, true> : launch_bwd<B, false>)(
                         ents, g, wqkv, wo, pm, qm, dqkv, attn, gm, dims, grid, smem, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 dgrid((bp * ne + kTile - 1) / kTile, (d + kTile - 1) / kTile);
  if (dtype == 0) {
    entity_attn_dents_kernel<float><<<dgrid, kThreads, 0, st>>>(
        (const float*)dqkv, (const float*)wqkv, (float*)dents, bp * ne, d, 3 * e);
    entity_attn_wgrad_kernel<float><<<wgrid, kThreads, 0, st>>>(wa, (float*)partials);
  } else {
    entity_attn_dents_kernel<B><<<dgrid, kThreads, 0, st>>>(
        (const float*)dqkv, (const B*)wqkv, (float*)dents, bp * ne, d, 3 * e);
    entity_attn_wgrad_kernel<B><<<wgrid, kThreads, 0, st>>>(wa, (float*)partials);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int k_total = (int)wa.k_total;
  entity_attn_reduce_kernel<<<(k_total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const float*)partials, chunks, k_total, (float*)dweights);
  return (int)cudaGetLastError();
}

const char* entity_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
