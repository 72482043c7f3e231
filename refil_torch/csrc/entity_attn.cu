// Masked entity attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of refil_tpu/ops/pallas_attn.py:
//   * entity_attn_fwd_kernel <- _kernel     (pallas_attn.py:87-131)
//   * entity_attn_bwd_kernel <- _bwd_kernel (pallas_attn.py:224-321), plus
//     entity_attn_reduce_kernel, which sums the backward's per-block weight
//     gradients in a fixed order.
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
// What bounds it on an H100: at the Group Matching widths (Ne = Nq = 8,
// D = E = O = 64, H = 4) a sample reads 2 KB of entities and writes 2 KB of
// output but takes ~340 kFLOP forward, ~170 FLOP per byte; at f32 outside the
// tensor cores (67 TFLOP/s vs 3.35 TB/s, ~20 FLOP/byte) the arithmetic bounds
// it. The projections (ents @ W_qkv, attn @ W_o and their transposes) are
// ~95% of that arithmetic.
//
// Design (a simple one that is right first; tensor cores are later work):
//   * Weights are staged once per block in shared memory as f32 and reused
//     for every sample the block handles: the grid is persistent (at most a
//     few blocks per SM), each block walks groups of `spb` samples.
//   * Everything of a group (entities, qkv, softmax weights, attn, and in the
//     backward g, dattn, dl, dqkv) lives in shared memory; nothing but the
//     inputs, the output and the per-block gradient partials touches device
//     memory. Ne is tiny (8), so the (Nq, Ne) score tiles are plain loops.
//   * The six projections (qkv, out, and in the backward dW_o, dattn, dEnts,
//     dW_qkv) go through tile_gemm: each thread keeps a 4 x 2..6 tile of the
//     result in registers, so one shared-memory load feeds 2-4 FMAs (the
//     first version, one output per thread, was bound by shared-memory
//     reads at two per FMA). Loops whose threads would all hit one
//     shared-memory bank (a stride of 3E or O floats) start each thread at a
//     rotated offset.
//   * Backward: blocks run concurrently, so the TPU kernel's += into one
//     output block (pallas_attn.py:362-366) would race. Each block
//     accumulates its own dW_qkv, dW_o, db_o in shared memory and writes them
//     to its row of a partials buffer; entity_attn_reduce_kernel sums the rows
//     in block order. No atomics: the result is deterministic.
//
// Limits: all of one block's weights (and, in the backward, their gradient
// partials) must fit in the card's opt-in shared memory per block (227 KB on
// an H100). At f32 that holds D = E = O = 64 (backward ~180 KB) but not the
// combat widths D = E = 128; entity_attn_plan returns cudaErrorInvalidValue
// for widths it cannot take and the Python wrapper raises.
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
  float scale;
};

// Shared-memory layout, in floats. The forward uses the first part, the
// backward all of it.
struct Layout {
  size_t w, wo, bo, x, qkv, p, a, rowok, post, mask;  // forward
  size_t dw, dwo, dbo, g, da, dl, dqkv;                // backward only
  size_t fwd_floats, bwd_floats;
};

__host__ __device__ inline Layout make_layout(const Dims& d) {
  Layout L;
  const size_t c3 = 3 * (size_t)d.e, s = d.spb;
  size_t off = 0;
  L.w = off;     off += (size_t)d.d * c3;
  L.wo = off;    off += (size_t)d.e * d.o;
  L.bo = off;    off += d.o;
  L.x = off;     off += s * d.ne * d.d;
  L.qkv = off;   off += s * d.ne * c3;
  L.p = off;     off += s * d.h * d.nq * d.ne;
  L.a = off;     off += s * d.nq * d.e;
  L.rowok = off; off += s * d.nq;
  L.post = off;  off += s * d.nq;
  L.mask = off;  off += s * d.nq * d.ne;
  L.fwd_floats = off;
  L.dw = off;    off += (size_t)d.d * c3;
  L.dwo = off;   off += (size_t)d.e * d.o;
  L.dbo = off;   off += d.o;
  L.g = off;     off += s * d.nq * d.o;
  L.da = off;    off += s * d.nq * d.e;
  L.dl = off;    off += s * d.h * d.nq * d.ne;
  L.dqkv = off;  off += s * d.ne * c3;
  L.bwd_floats = off;
  return L;
}

template <typename T>
__device__ void stage_weights(const T* wqkv, const T* wo, const T* bo, const Dims& d,
                              float* sw, float* swo, float* sbo) {
  const int n_w = d.d * 3 * d.e, n_wo = d.e * d.o;
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) sw[i] = Num<T>::to_f(wqkv[i]);
  for (int i = threadIdx.x; i < n_wo; i += blockDim.x) swo[i] = Num<T>::to_f(wo[i]);
  if (bo != nullptr)
    for (int i = threadIdx.x; i < d.o; i += blockDim.x) sbo[i] = Num<T>::to_f(bo[i]);
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

// Forward of one group up to attn (row_ok applied). Ends synchronised.
// sp holds the f32 softmax weights (s, h, q, j).
template <typename T>
__device__ void forward_group(int ns, const Dims& d, const float* sw, const float* sx,
                              const float* smask, const float* srowok, float* sqkv,
                              float* sp, float* sa) {
  const int c3 = 3 * d.e, hd = d.e / d.h;
  const int D = d.d;
  tile_gemm<4, 6, false>(
      ns * d.ne, c3, D, [=](int m, int k) { return sx[m * D + k]; },
      [=](int k, int n) { return sw[k * c3 + n]; },
      [=](int m, int n, float c) { sqkv[m * c3 + n] = Num<T>::round(c); });
  __syncthreads();

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
    sp[i] = smask[(s * d.nq + q) * d.ne + j] != 0.f ? kNeg : acc * d.scale;
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
    sa[i] = Num<T>::round(acc * srowok[row]);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
entity_attn_fwd_kernel(const T* __restrict__ ents, const T* __restrict__ wqkv,
                       const T* __restrict__ wo, const T* __restrict__ bo,
                       const uint8_t* __restrict__ pre, const uint8_t* __restrict__ post,
                       T* __restrict__ out, Dims d) {
  extern __shared__ float smem[];
  const Layout L = make_layout(d);
  float *sw = smem + L.w, *swo = smem + L.wo, *sbo = smem + L.bo, *sx = smem + L.x;
  float *sqkv = smem + L.qkv, *sp = smem + L.p, *sa = smem + L.a;
  float *srowok = smem + L.rowok, *spost = smem + L.post, *smask = smem + L.mask;

  stage_weights<T>(wqkv, wo, bo, d, sw, swo, sbo);
  for (int s0 = blockIdx.x * d.spb; s0 < d.bp; s0 += gridDim.x * d.spb) {
    const int ns = min(d.spb, d.bp - s0);
    load_group<T>(ents, pre, post, s0, ns, d, sx, smask, srowok, spost);
    forward_group<T>(ns, d, sw, sx, smask, srowok, sqkv, sp, sa);
    T* dst = out + (size_t)s0 * d.nq * d.o;
    const int E = d.e, O = d.o;
    tile_gemm<4, 2, false>(
        ns * d.nq, O, E, [=](int m, int k) { return sa[m * E + k]; },
        [=](int k, int n) { return swo[k * O + n]; },
        [=](int m, int n, float c) { dst[m * O + n] = Num<T>::from_f((c + sbo[n]) * spost[m]); });
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
entity_attn_bwd_kernel(const T* __restrict__ ents, const T* __restrict__ g,
                       const T* __restrict__ wqkv, const T* __restrict__ wo,
                       const uint8_t* __restrict__ pre, const uint8_t* __restrict__ post,
                       float* __restrict__ dents, float* __restrict__ partials, Dims d) {
  extern __shared__ float smem[];
  const Layout L = make_layout(d);
  float *sw = smem + L.w, *swo = smem + L.wo, *sx = smem + L.x;
  float *sqkv = smem + L.qkv, *sp = smem + L.p, *sa = smem + L.a;
  float *srowok = smem + L.rowok, *spost = smem + L.post, *smask = smem + L.mask;
  float *sdw = smem + L.dw, *sdwo = smem + L.dwo, *sdbo = smem + L.dbo;
  float *sg = smem + L.g, *sda = smem + L.da, *sdl = smem + L.dl, *sdqkv = smem + L.dqkv;
  const int c3 = 3 * d.e, hd = d.e / d.h;
  const int n_w = d.d * c3, n_wo = d.e * d.o;

  stage_weights<T>(wqkv, wo, nullptr, d, sw, swo, nullptr);
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) sdw[i] = 0.f;
  for (int i = threadIdx.x; i < n_wo; i += blockDim.x) sdwo[i] = 0.f;
  for (int i = threadIdx.x; i < d.o; i += blockDim.x) sdbo[i] = 0.f;

  for (int s0 = blockIdx.x * d.spb; s0 < d.bp; s0 += gridDim.x * d.spb) {
    const int ns = min(d.spb, d.bp - s0);
    const int rows = ns * d.nq;
    load_group<T>(ents, pre, post, s0, ns, d, sx, smask, srowok, spost);
    forward_group<T>(ns, d, sw, sx, smask, srowok, sqkv, sp, sa);

    // out = (attn @ W_o + b_o) * post_keep: g flows through post_keep first
    const T* gsrc = g + (size_t)s0 * d.nq * d.o;
    for (int i = threadIdx.x; i < rows * d.o; i += blockDim.x)
      sg[i] = Num<T>::to_f(gsrc[i]) * spost[i / d.o];
    __syncthreads();

    for (int o = threadIdx.x; o < d.o; o += blockDim.x) {
      float acc = 0.f;
      for (int r = 0; r < rows; ++r) acc += sg[r * d.o + o];
      sdbo[o] += acc;
    }
    const int E = d.e, O = d.o;
    // dW_o += attn^T @ g
    tile_gemm<4, 4, false>(
        E, O, rows, [=](int m, int k) { return sa[k * E + m]; },
        [=](int k, int n) { return Num<T>::round(sg[k * O + n]); },
        [=](int m, int n, float c) { sdwo[m * O + n] += c; });
    // dattn = g @ W_o^T; row_ok folds into the attention gradient
    tile_gemm<4, 2, true>(
        rows, E, O, [=](int m, int k) { return Num<T>::round(sg[m * O + k]); },
        [=](int k, int n) { return swo[n * O + k]; },
        [=](int m, int n, float c) { sda[m * E + n] = c * srowok[m]; });
    __syncthreads();

    // dw = dattn_h @ v_h^T per (s, h, q, j)
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
      sdqkv[i] = Num<T>::round(val);
    }
    __syncthreads();

    // dents = dqkv @ W_qkv^T ; dW_qkv += ents^T @ dqkv
    float* ddst = dents + (size_t)s0 * d.ne * d.d;
    const int D = d.d;
    tile_gemm<4, 2, true>(
        ns * d.ne, D, c3, [=](int m, int k) { return sdqkv[m * c3 + k]; },
        [=](int k, int n) { return sw[n * c3 + k]; },
        [=](int m, int n, float c) { ddst[m * D + n] = c; });
    tile_gemm<4, 4, false>(
        D, c3, ns * d.ne, [=](int m, int k) { return sx[k * D + m]; },
        [=](int k, int n) { return sdqkv[k * c3 + n]; },
        [=](int m, int n, float c) { sdw[m * c3 + n] += c; });
    __syncthreads();
  }

  __syncthreads();
  float* dst = partials + (size_t)blockIdx.x * (n_w + n_wo + d.o);
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) dst[i] = sdw[i];
  for (int i = threadIdx.x; i < n_wo; i += blockDim.x) dst[n_w + i] = sdwo[i];
  for (int i = threadIdx.x; i < d.o; i += blockDim.x) dst[n_w + n_wo + i] = sdbo[i];
}

// out[k] = sum over blocks b (in order) of partials[b][k]
__global__ void entity_attn_reduce_kernel(const float* __restrict__ partials, int n_blocks,
                                          int k_total, float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= k_total) return;
  float acc = 0.f;
  for (int b = 0; b < n_blocks; ++b) acc += partials[(size_t)b * k_total + k];
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

size_t smem_bytes(const Dims& d, bool bwd) {
  const Layout L = make_layout(d);
  return (bwd ? L.bwd_floats : L.fwd_floats) * sizeof(float);
}

template <typename T>
cudaError_t set_smem(bool bwd, size_t bytes) {
  if (bwd)
    return cudaFuncSetAttribute(entity_attn_bwd_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  return cudaFuncSetAttribute(entity_attn_fwd_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Chooses samples per block iteration (spb) and the persistent grid for a
// call; writes them and the dynamic shared memory in bytes. Returns
// cudaErrorInvalidValue if even one sample per block does not fit.
int entity_attn_plan(int bwd, int bp, int ne, int nq, int d, int e, int o, int h, int device,
                     int* spb, int* grid, int* smem) {
  int n_sm = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return (int)err;
  for (int s = 4; s >= 1; s /= 2) {
    const size_t bytes = smem_bytes(make_dims(bp, ne, nq, d, e, o, h, 0, s), bwd != 0);
    if (bytes > (size_t)optin) continue;
    int blocks_per_sm = (int)(per_sm / (bytes + 1024));
    if (blocks_per_sm < 1) blocks_per_sm = 1;
    if (blocks_per_sm > 4) blocks_per_sm = 4;
    const int need = (bp + s - 1) / s;
    const int cap = n_sm * blocks_per_sm;
    *spb = s;
    *grid = need < cap ? need : cap;
    *smem = (int)bytes;
    return (int)cudaSuccess;
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16. pre may be null (no pre-mask).
int entity_attn_fwd(int dtype, const void* ents, const void* wqkv, const void* wo,
                     const void* bo, const void* pre, const void* post, void* out, int bp,
                     int ne, int nq, int d, int e, int o, int h, int mask_rows, int spb,
                     int grid, int smem, void* stream) {
  const Dims dims = make_dims(bp, ne, nq, d, e, o, h, pre ? mask_rows : 0, spb);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* pm = (const uint8_t*)pre;
  const uint8_t* qm = (const uint8_t*)post;
  cudaError_t err;
  if (dtype == 0) {
    err = set_smem<float>(false, smem);
    if (err != cudaSuccess) return (int)err;
    entity_attn_fwd_kernel<float><<<grid, kThreads, smem, st>>>(
        (const float*)ents, (const float*)wqkv, (const float*)wo, (const float*)bo, pm, qm,
        (float*)out, dims);
  } else {
    typedef __nv_bfloat16 B;
    err = set_smem<B>(false, smem);
    if (err != cudaSuccess) return (int)err;
    entity_attn_fwd_kernel<B><<<grid, kThreads, smem, st>>>(
        (const B*)ents, (const B*)wqkv, (const B*)wo, (const B*)bo, pm, qm, (B*)out, dims);
  }
  return (int)cudaGetLastError();
}

// partials: (grid, D*3E + E*O + O) f32 scratch; dweights: (D*3E + E*O + O,)
// f32, laid out as dW_qkv, dW_o, db_o.
int entity_attn_bwd(int dtype, const void* ents, const void* g, const void* wqkv,
                     const void* wo, const void* pre, const void* post, void* dents,
                     void* partials, void* dweights, int bp, int ne, int nq, int d, int e,
                     int o, int h, int mask_rows, int spb, int grid, int smem, void* stream) {
  const Dims dims = make_dims(bp, ne, nq, d, e, o, h, pre ? mask_rows : 0, spb);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* pm = (const uint8_t*)pre;
  const uint8_t* qm = (const uint8_t*)post;
  cudaError_t err;
  if (dtype == 0) {
    err = set_smem<float>(true, smem);
    if (err != cudaSuccess) return (int)err;
    entity_attn_bwd_kernel<float><<<grid, kThreads, smem, st>>>(
        (const float*)ents, (const float*)g, (const float*)wqkv, (const float*)wo, pm, qm,
        (float*)dents, (float*)partials, dims);
  } else {
    typedef __nv_bfloat16 B;
    err = set_smem<B>(true, smem);
    if (err != cudaSuccess) return (int)err;
    entity_attn_bwd_kernel<B><<<grid, kThreads, smem, st>>>(
        (const B*)ents, (const B*)g, (const B*)wqkv, (const B*)wo, pm, qm, (float*)dents,
        (float*)partials, dims);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int k_total = d * 3 * e + e * o + o;
  entity_attn_reduce_kernel<<<(k_total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const float*)partials, grid, k_total, (float*)dweights);
  return (int)cudaGetLastError();
}

const char* entity_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
