// GRU recurrence over a whole sequence, forward and backward, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of refil_tpu/ops/pallas_gru.py:
//   * gru_fwd_kernel <- _fwd_kernel (pallas_gru.py:113-133)
//   * gru_bwd_kernel <- _bwd_kernel (pallas_gru.py:136-195), plus
//     gru_reduce_kernel, which sums the backward's per-block dW_h and db_hn
//     in a fixed order.
//
// What it computes, flax GRUCell gates [r | z | n] over a hoisted input
// projection xw (T, R, 3H) (its biases included), with W_h (H, 3H) f32,
// b_hn (H,) f32 and h0 (R, H) f32:
//   gh = h @ W_h                      (f32, never rounded to xw's dtype)
//   r = sigmoid(xw_r + gh_r); z = sigmoid(xw_z + gh_z)
//   n = tanh(xw_n + r * (gh_n + b_hn))
//   h' = (1 - z) * n + z * h          (the f32 carry)
// hs[t] = h' in xw's dtype. The backward recomputes the gates from xw and
// h_{t-1} (hs[t-1], or h0 at t = 0, as the TPU kernel does), carries dh in
// f32 and returns dxw (T, R, 3H) f32, dW_h, db_hn and dh0 f32.
//
// What bounds it on an H100: at T 151, R 768, H 64 the forward moves ~119 MB
// (0.035 ms at 3.35 TB/s) and does 2.85 GFLOP (0.043 ms at 67 TFLOP/s f32),
// but each of the 151 steps depends on the one before, so the chain of steps
// sets the pace: a step's latency (the dots, the gates, the barriers) times
// T, not bytes or operations.
//
// Design:
//   * Blocks run in no order, so the T loop that the TPU's sequential grid
//     carried (pallas_gru.py:239) lives inside the kernel, with the h carry
//     in f32 shared memory; the ragged last row tile is masked.
//   * Forward: gru_fwd_plan picks 1, 2, 4 or 8 rows per block (a template
//     instance each), the fewest whose grid is resident at once, so the rows
//     spread over the SMs (R = 768: 2 rows, 384 blocks) and each SM holds
//     several blocks whose warps hide each other's latency. Four lanes share
//     each gate column's H-deep dot, W_h's rows of it in registers; the
//     three columns of one gate index meet on those lanes through shuffles,
//     so a step has one barrier and no round trip of h @ W_h through shared
//     memory (see gru_fwd_kernel). f32 FMA, no TF32, full-precision
//     expf/tanhf.
//   * Backward: one block per kRows (8) rows; thread c of 3H keeps column c
//     of W_h in registers, so gh = h @ W_h is H FMAs per row with h read as
//     a shared-memory broadcast, four floats per load.
//   * Step t+1's xw tile (and in the backward g and hs[t-2]) is copied with
//     cp.async while step t computes.
//   * Backward: thread c also keeps column c of its block's dW_h partial in
//     registers; dh_{t-1} = dh * z + dgh @ W_h^T reads a transposed copy of
//     W_h from shared memory. The TPU kernel's += into one dW_h block across
//     the grid (pallas_gru.py:187-191) would race here: each block writes its
//     partial and gru_reduce_kernel sums them in block order. No atomics: two
//     runs give the same bits.
//
// Limits: H <= kHMax (64). Interface: plain C (extern "C"), loaded with
// ctypes; the wrapper allocates every output and scratch buffer, each
// launcher enqueues on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHMax = 64;
constexpr int kRows = 8;  // rows per block of the backward
constexpr int kThreads = 3 * kHMax;

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f(float x) { return __float2bfloat16(x); }
};

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
// waits until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// acc[r] = sum over k < H of h[r][k] * wcol[k], for the block's kRows rows;
// h is read as a shared-memory broadcast, four floats at a time where H is a
// multiple of 4 (sh 16-byte aligned)
__device__ __forceinline__ void row_dots(const float* sh, const float (&wcol)[kHMax], int H,
                                         float (&acc)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  if (H % 4 == 0) {
#pragma unroll
    for (int k = 0; k < kHMax; k += 4) {
      if (k < H) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 h = *reinterpret_cast<const float4*>(sh + r * H + k);
          acc[r] = fmaf(h.x, wcol[k], acc[r]);
          acc[r] = fmaf(h.y, wcol[k + 1], acc[r]);
          acc[r] = fmaf(h.z, wcol[k + 2], acc[r]);
          acc[r] = fmaf(h.w, wcol[k + 3], acc[r]);
        }
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kHMax; ++k) {
    if (k < H) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(sh[r * H + k], wcol[k], acc[r]);
    }
  }
}

// Forward: thread (j, p) = (threadIdx.x / 4, threadIdx.x % 4) keeps rows
// [16p, 16p + 16) of W_h's three gate columns j, H + j, 2H + j in registers
// and forms those rows' share of the three dots for each of the block's RPB
// rows. The four parts of column j sit on four neighbouring lanes of one
// warp; two xor shuffles sum them, (a0 + a1) + (a2 + a3) on every lane (the
// same bits everywhere), so each lane of the quad holds the full r/z/n
// pre-activations and lane p applies the gates of rows p, p + 4. The carry is
// double-buffered in shared memory, each row padded to kHMax floats kept at
// zero beyond H: step t reads buffer t & 1 and writes the other, so one
// barrier per step suffices.
constexpr int kParts = 4;                  // lanes sharing one column's dot
constexpr int kPartK = kHMax / kParts;     // depth of each lane's share
constexpr int kFwdThreads = kParts * kHMax;

template <typename T, int RPB>
__global__ void __launch_bounds__(kFwdThreads)
gru_fwd_kernel(const T* __restrict__ xw, const float* __restrict__ wh,
               const float* __restrict__ bhn, const float* __restrict__ h0,
               T* __restrict__ hs, int steps, int rows, int H) {
  __shared__ __align__(16) float sh[2][RPB * kHMax];  // the f32 carry, two buffers
  __shared__ __align__(16) T sxw[2][RPB * 3 * kHMax];
  const int H3 = 3 * H, j = threadIdx.x / kParts, p = threadIdx.x % kParts;
  const int r0 = blockIdx.x * RPB, nr = min(RPB, rows - r0);
  const bool col = j < H;

  float w[3][kPartK];
#pragma unroll
  for (int kk = 0; kk < kPartK; ++kk) {
    const int k = p * kPartK + kk;
#pragma unroll
    for (int g = 0; g < 3; ++g) w[g][kk] = (col && k < H) ? wh[k * H3 + g * H + j] : 0.f;
  }
  const float b = col ? bhn[j] : 0.f;
  for (int i = threadIdx.x; i < 2 * RPB * kHMax; i += blockDim.x) {
    const int r = (i / kHMax) % RPB, k = i % kHMax;
    (&sh[0][0])[i] = (i < RPB * kHMax && r < nr && k < H) ? h0[(size_t)(r0 + r) * H + k] : 0.f;
  }
  copy_to_shared(sxw[0], xw + (size_t)r0 * H3, nr * H3);
  cp_async_commit();
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    if (t + 1 < steps)
      copy_to_shared(sxw[cur ^ 1], xw + ((size_t)(t + 1) * rows + r0) * H3, nr * H3);
    cp_async_commit();

    float acc[3][RPB];
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int r = 0; r < RPB; ++r) acc[g][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kPartK; kk += 4) {
#pragma unroll
      for (int r = 0; r < RPB; ++r) {
        const float4 h = *reinterpret_cast<const float4*>(&sh[cur][r * kHMax + p * kPartK + kk]);
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          acc[g][r] = fmaf(h.x, w[g][kk], acc[g][r]);
          acc[g][r] = fmaf(h.y, w[g][kk + 1], acc[g][r]);
          acc[g][r] = fmaf(h.z, w[g][kk + 2], acc[g][r]);
          acc[g][r] = fmaf(h.w, w[g][kk + 3], acc[g][r]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int r = 0; r < RPB; ++r) {
        acc[g][r] += __shfl_xor_sync(0xffffffffu, acc[g][r], 1);
        acc[g][r] += __shfl_xor_sync(0xffffffffu, acc[g][r], 2);
      }

    const T* x = sxw[cur];
    T* out = hs + ((size_t)t * rows + r0) * H;
#pragma unroll
    for (int r = 0; r < RPB; ++r) {
      if (r % kParts == p && r < nr && col) {
        const T* xr = x + r * H3;
        const float rg = sigmoidf(Num<T>::to_f(xr[j]) + acc[0][r]);
        const float zg = sigmoidf(Num<T>::to_f(xr[H + j]) + acc[1][r]);
        const float ng = tanhf(Num<T>::to_f(xr[2 * H + j]) + rg * (acc[2][r] + b));
        const float hn = (1.f - zg) * ng + zg * sh[cur][r * kHMax + j];
        sh[cur ^ 1][r * kHMax + j] = hn;
        out[r * H + j] = Num<T>::from_f(hn);
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);  // step t+1's tile has landed
    __syncthreads();  // h_t complete; step t is done with sxw[cur] and sh[cur]
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gru_bwd_kernel(const T* __restrict__ xw, const T* __restrict__ hs, const T* __restrict__ g,
               const float* __restrict__ h0, const float* __restrict__ wh,
               const float* __restrict__ bhn, float* __restrict__ dxw, float* __restrict__ dh0,
               float* __restrict__ partials, int steps, int rows, int H) {
  extern __shared__ __align__(16) float smem[];
  const int H3 = 3 * H, c = threadIdx.x;
  float* swt = smem;                            // W_h^T (3H, H)
  float* shp = swt + 3 * kHMax * kHMax;         // h_{t-1} f32 (kRows, H)
  float* sdh = shp + kRows * kHMax;             // the dh carry
  float* sdz = sdh + kRows * kHMax;             // dh * z of this step
  float* sgh = sdz + kRows * kHMax;             // h_{t-1} @ W_h (kRows, 3H)
  float* sdg = sgh + kRows * 3 * kHMax;         // d(h @ W_h + [0, 0, b_hn]) (kRows, 3H)
  float* sb = sdg + kRows * 3 * kHMax;          // b_hn
  T* sx = reinterpret_cast<T*>(sb + kHMax);     // 2 x xw tile (kRows, 3H)
  T* sg = sx + 2 * kRows * 3 * kHMax;           // 2 x g tile (kRows, H)
  T* sp = sg + 2 * kRows * kHMax;               // 2 x hs[t-1] tile (kRows, H)
  const int r0 = blockIdx.x * kRows, nr = min(kRows, rows - r0);

  float wcol[kHMax], dw[kHMax];
#pragma unroll
  for (int k = 0; k < kHMax; ++k) {
    wcol[k] = (c < H3 && k < H) ? wh[k * H3 + c] : 0.f;
    dw[k] = 0.f;
  }
  float db = 0.f;
  for (int i = threadIdx.x; i < H * H3; i += blockDim.x) {
    const int k = i / H3, cc = i - k * H3;
    swt[cc * H + k] = wh[i];
  }
  for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) sdh[i] = 0.f;
  for (int i = threadIdx.x; i < kRows * H3; i += blockDim.x) sdg[i] = 0.f;  // rows >= nr stay 0
  for (int i = threadIdx.x; i < H; i += blockDim.x) sb[i] = bhn[i];

  auto load_step = [&](int t, int buf) {
    copy_to_shared(sx + buf * kRows * 3 * kHMax, xw + ((size_t)t * rows + r0) * H3, nr * H3);
    copy_to_shared(sg + buf * kRows * kHMax, g + ((size_t)t * rows + r0) * H, nr * H);
    if (t > 0)
      copy_to_shared(sp + buf * kRows * kHMax, hs + ((size_t)(t - 1) * rows + r0) * H, nr * H);
  };
  load_step(steps - 1, (steps - 1) & 1);
  cp_async_commit();

  for (int t = steps - 1; t >= 0; --t) {
    const int buf = t & 1;
    __syncthreads();  // step t+1 is done with the other buffers and the carry
    if (t > 0) load_step(t - 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const T* x = sx + buf * kRows * 3 * kHMax;
    const T* gt = sg + buf * kRows * kHMax;
    const T* hp = sp + buf * kRows * kHMax;
    for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) {
      const int r = i / H;
      shp[i] = r >= nr ? 0.f : (t > 0 ? Num<T>::to_f(hp[i]) : h0[(size_t)r0 * H + i]);
    }
    __syncthreads();
    if (c < H3) {
      float acc[kRows];
      row_dots(shp, wcol, H, acc);
#pragma unroll
      for (int r = 0; r < kRows; ++r) sgh[r * H3 + c] = acc[r];
    }
    __syncthreads();
    float* dx = dxw + ((size_t)t * rows + r0) * H3;
    for (int i = threadIdx.x; i < nr * H; i += blockDim.x) {
      const int r = i / H, j = i - r * H;
      const float* gh = sgh + r * H3;
      const T* xr = x + r * H3;
      const float rg = sigmoidf(Num<T>::to_f(xr[j]) + gh[j]);
      const float zg = sigmoidf(Num<T>::to_f(xr[H + j]) + gh[H + j]);
      const float ghn_b = gh[2 * H + j] + sb[j];
      const float ng = tanhf(Num<T>::to_f(xr[2 * H + j]) + rg * ghn_b);
      const float dh = Num<T>::to_f(gt[i]) + sdh[i];
      const float dz = dh * (shp[i] - ng);
      const float dn = dh * (1.f - zg);
      const float dpre_n = dn * (1.f - ng * ng);
      const float da_hn = dpre_n * rg;
      const float dpre_r = dpre_n * ghn_b * rg * (1.f - rg);
      const float dpre_z = dz * zg * (1.f - zg);
      dx[r * H3 + j] = dpre_r;
      dx[r * H3 + H + j] = dpre_z;
      dx[r * H3 + 2 * H + j] = dpre_n;
      float* dg = sdg + r * H3;
      dg[j] = dpre_r;
      dg[H + j] = dpre_z;
      dg[2 * H + j] = da_hn;
      sdz[i] = dh * zg;
    }
    __syncthreads();
    if (c < H3) {
      // this block's dW_h[:, c] += h_{t-1}^T @ dgh[:, c]; db_hn from da_hn
      float dcol[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) dcol[r] = sdg[r * H3 + c];
      if (H % 4 == 0) {
#pragma unroll
        for (int k = 0; k < kHMax; k += 4) {
          if (k < H) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float4 h = *reinterpret_cast<const float4*>(shp + r * H + k);
              dw[k] = fmaf(h.x, dcol[r], dw[k]);
              dw[k + 1] = fmaf(h.y, dcol[r], dw[k + 1]);
              dw[k + 2] = fmaf(h.z, dcol[r], dw[k + 2]);
              dw[k + 3] = fmaf(h.w, dcol[r], dw[k + 3]);
            }
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < kHMax; ++k) {
          if (k < H) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) dw[k] = fmaf(shp[r * H + k], dcol[r], dw[k]);
          }
        }
      }
      if (c >= 2 * H)
#pragma unroll
        for (int r = 0; r < kRows; ++r) db += dcol[r];
    }
    // dh_{t-1} = dh * z + dgh @ W_h^T: thread (q, k) takes rows q, q + 3, ...
    if (c < H3) {
      const int q = c / H, k = c - q * H;
      for (int r = q; r < nr; r += 3) {
        const float* dg = sdg + r * H3;
        float acc = 0.f;
        for (int cc = 0; cc < H3; ++cc) acc = fmaf(dg[cc], swt[cc * H + k], acc);
        sdh[r * H + k] = sdz[r * H + k] + acc;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * H; i += blockDim.x) dh0[(size_t)r0 * H + i] = sdh[i];
  if (c < H3) {
    float* dst = partials + (size_t)blockIdx.x * (H * H3 + H);
#pragma unroll
    for (int k = 0; k < kHMax; ++k)
      if (k < H) dst[k * H3 + c] = dw[k];
    if (c >= 2 * H) dst[H * H3 + c - 2 * H] = db;
  }
}

// out[k] = sum over blocks b (in order) of partials[b][k]
__global__ void gru_reduce_kernel(const float* __restrict__ partials, int n_blocks, int k_total,
                                  float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= k_total) return;
  float acc = 0.f;
  for (int b = 0; b < n_blocks; ++b) acc += partials[(size_t)b * k_total + k];
  out[k] = acc;
}

template <int RPB>
const void* fwd_instance(int dtype) {
  return dtype == 0 ? (const void*)gru_fwd_kernel<float, RPB>
                    : (const void*)gru_fwd_kernel<__nv_bfloat16, RPB>;
}

// the forward instance for (dtype, rows per block); null for another count
const void* fwd_kernel(int dtype, int rpb) {
  switch (rpb) {
    case 1: return fwd_instance<1>(dtype);
    case 2: return fwd_instance<2>(dtype);
    case 4: return fwd_instance<4>(dtype);
    case 8: return fwd_instance<8>(dtype);
    default: return nullptr;
  }
}

size_t bwd_smem_bytes(size_t elem) {
  const size_t floats = 3 * kHMax * kHMax + 3 * kRows * kHMax + 2 * kRows * 3 * kHMax + kHMax;
  const size_t tiles = 2 * kRows * 3 * kHMax + 2 * 2 * kRows * kHMax;
  return floats * sizeof(float) + tiles * elem;
}

template <typename T>
cudaError_t launch_bwd(const void* xw, const void* hs, const void* g, const void* h0,
                       const void* wh, const void* bhn, void* dxw, void* dh0, void* partials,
                       int steps, int rows, int H, int grid, cudaStream_t st) {
  const size_t bytes = bwd_smem_bytes(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(gru_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  gru_bwd_kernel<T><<<grid, kThreads, bytes, st>>>(
      (const T*)xw, (const T*)hs, (const T*)g, (const float*)h0, (const float*)wh,
      (const float*)bhn, (float*)dxw, (float*)dh0, (float*)partials, steps, rows, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gru_rows_per_block() { return kRows; }
int gru_max_hidden() { return kHMax; }

// The forward's launch for `rows` rows: the fewest rows per block (1, 2, 4
// or 8) whose grid is resident all at once (blocks <= SMs x the blocks of
// that instance an SM holds), since the T loop lives inside the kernel and a
// second wave of blocks would run all T steps again after the first; 8 where
// none is. Fewer rows per block spread the rows over more SMs and give each
// SM more warps to hide a step's latency.
int gru_fwd_plan(int dtype, int rows, int device, int* rows_per_block, int* grid,
                 int* blocks_per_sm) {
  int n_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  for (int rpb = 1; rpb <= 8; rpb *= 2) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fwd_kernel(dtype, rpb),
                                                        kFwdThreads, 0);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (rows + rpb - 1) / rpb;
    if (blocks <= n_sm * per_sm || rpb == 8) {
      *rows_per_block = rpb;
      *grid = blocks;
      *blocks_per_sm = per_sm;
      return (int)cudaSuccess;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// dtype of xw and hs: 0 = float32, 1 = bfloat16. wh, bhn, h0 are float32.
// rows_per_block and grid come from gru_fwd_plan.
int gru_fwd(int dtype, const void* xw, const void* wh, const void* bhn, const void* h0, void* hs,
            int steps, int rows, int H, int rows_per_block, int grid, void* stream) {
  if (H < 1 || H > kHMax) return (int)cudaErrorInvalidValue;
  if (grid * rows_per_block < rows) return (int)cudaErrorInvalidValue;
  const void* kernel = fwd_kernel(dtype, rows_per_block);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&xw, (void*)&wh, (void*)&bhn, (void*)&h0, (void*)&hs,
                  (void*)&steps, (void*)&rows, (void*)&H};
  cudaError_t err = cudaLaunchKernel(kernel, dim3(grid), dim3(kFwdThreads), args, 0,
                                     (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// g has xw's dtype. partials: (ceil(rows / kRows), H*3H + H) f32 scratch;
// dweights: (H*3H + H,) f32, laid out as dW_h (H, 3H) then db_hn (H,).
int gru_bwd(int dtype, const void* xw, const void* hs, const void* g, const void* h0,
            const void* wh, const void* bhn, void* dxw, void* dh0, void* partials,
            void* dweights, int steps, int rows, int H, void* stream) {
  if (H < 1 || H > kHMax) return (int)cudaErrorInvalidValue;
  const int grid = (rows + kRows - 1) / kRows;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = dtype == 0
      ? launch_bwd<float>(xw, hs, g, h0, wh, bhn, dxw, dh0, partials, steps, rows, H, grid, st)
      : launch_bwd<__nv_bfloat16>(xw, hs, g, h0, wh, bhn, dxw, dh0, partials, steps, rows, H,
                                  grid, st);
  if (err != cudaSuccess) return (int)err;
  const int k_total = H * 3 * H + H;
  gru_reduce_kernel<<<(k_total + 255) / 256, 256, 0, st>>>((const float*)partials, grid, k_total,
                                                           (float*)dweights);
  return (int)cudaGetLastError();
}

const char* gru_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
