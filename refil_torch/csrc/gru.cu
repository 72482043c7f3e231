// GRU recurrence over a whole sequence, forward and backward, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of refil_tpu/ops/pallas_gru.py:
//   * gru_fwd_kernel <- _fwd_kernel (pallas_gru.py:113-133)
//   * the backward <- _bwd_kernel (pallas_gru.py:136-195), in stages: the
//     register-tiled matrix product of gemm.cuh for the recurrent product
//     and the weight gradient, gru_bwd_kernel for the dh chain, and
//     gru_colsum_kernel and gru_reduce_kernel, which sum db_hn and the
//     weight gradient's chunks in a fixed order.
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
//     carried (pallas_gru.py:239) lives inside the kernel; the ragged last
//     row tile is masked.
//   * Launch plan (gru_plan): 1, 2, 4 or 8 rows per block (a template
//     instance each), the fewest whose grid is resident at once, so the rows
//     spread over the SMs (R = 768: 2 rows, 384 blocks) and each SM holds
//     several blocks whose warps hide each other's latency.
//   * Forward: four lanes share each gate column's H-deep dot, W_h's rows of
//     it in registers; the three columns of one gate index meet on those
//     lanes through shuffles, so a step has one barrier and no round trip of
//     h @ W_h through shared memory (see gru_fwd_kernel). The h carry is f32
//     in shared memory, double-buffered. f32 FMA, no TF32, full-precision
//     expf/tanhf.
//   * Backward, in stages. Only dh depends on the step before; gh = h_{t-1}
//     W_h and the dW_h products do not, and a kernel that formed them inside
//     the chain (five barriers a step, 8 rows a block) took 10.6 us a step.
//     (i) GH = h_prev W_h for all T*R rows at once through gemm.cuh: hs[:T-1]
//     for steps 1..T-1 and h0 (f32) for step 0; GH is f32, never rounded.
//     (ii) gru_bwd_kernel carries only dh: per step it reads the xw, GH, g
//     and h_{t-1} tiles (the next step's copied by cp.async meanwhile), forms
//     the gate gradients, writes dxw = [dpre_r | dpre_z | dpre_n] and dgh =
//     [dpre_r | dpre_z | da_hn] (f32 scratch), and dh_{t-1} = dh z + dgh
//     W_h^T: four lanes share each output column's 3H-deep dot with W_h's
//     row of it in registers and meet by shuffles; the lane that formed
//     column j's gates keeps dh[j] in a register; dgh goes through shared
//     memory, double-buffered: one barrier a step. (iii) dW_h^T = dgh^T
//     h_prev through gemm.cuh over row chunks (dgh[1:] against hs[:T-1],
//     then dgh[0] against h0), db_hn as the column sums of dgh's n third
//     over as many chunks, and gru_reduce_kernel sums the chunks in order,
//     transposing dW_h^T. The TPU kernel's += into one dW_h block across its
//     sequential grid (pallas_gru.py:187-191) would race here. No atomics:
//     two runs give the same bits. Scratch at (151, 768): GH and dgh 89 MB
//     each. A step of (ii) is bound by instruction issue, not by memory:
//     ~24 warps a SM share the issue slots, and masked lanes cost a slot as
//     active ones do; so a warp's lanes form their rows' gates at once and
//     each thread plans its tile copies once (see gru_bwd_kernel).
//
// Limits: H <= kHMax (64). Interface: plain C (extern "C"), loaded with
// ctypes; the wrapper allocates every output and scratch buffer, each
// launcher enqueues on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm.cuh"

namespace {

constexpr int kHMax = 64;

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
// waits until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

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
constexpr int kThreads = kParts * kHMax;

template <typename T, int RPB>
__global__ void __launch_bounds__(kThreads)
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

// Backward stage (ii): thread (j, p) = (threadIdx.x / 4, threadIdx.x % 4)
// forms the gate gradients of column j < H for the block's rows r = p + 4 q
// and keeps their dh carry in registers. dh_{t-1}[j] = dh[j] z[j] +
// sum over c < 3H of dgh[c] W_h[j][c]: the four lanes of column j each keep
// W_h[j][c] for the float4 runs c = 4 (p + 4 i) .. + 3 in registers (so a
// quarter-warp reads 64 consecutive bytes of dgh), form their share of the
// dot for every row of the block, and two xor shuffles give every lane of
// the quad the sum, (a0 + a1) + (a2 + a3), the same bits on each. dgh goes
// through shared memory, rows padded to 3 kHMax floats kept at zero beyond
// 3H, double-buffered: step t writes buffer t & 1, which step t - 2 writes
// again only after the barrier of step t - 1, so one barrier per step
// suffices. Each step's xw, GH, g and h_{t-1} tiles come through a ring of
// kBwdStages buffers, copied by cp.async kBwdStages - 1 steps ahead; the
// step's barrier also publishes the next step's tiles.
constexpr int kBwdRuns = 3 * kHMax / 4 / kParts;  // float4 runs of dgh per lane
constexpr int kBwdStages = 2;                     // tile buffers of the ring
constexpr int kDg = 3 * kHMax;                    // padded row of dgh in shared memory

// dynamic shared memory of a backward block: the ring (xw, g, h_{t-1} of
// T, GH f32), the h0 tile and the two dgh buffers
template <typename T, int RPB>
struct BwdSmem {
  static constexpr size_t kX = (size_t)RPB * 3 * kHMax * sizeof(T);
  static constexpr size_t kH = (size_t)RPB * kHMax * sizeof(T);
  static constexpr size_t kGh = (size_t)RPB * 3 * kHMax * sizeof(float);
  static constexpr size_t kStage = kX + 2 * kH + kGh;  // one step's tiles
  static constexpr size_t kH0 = (size_t)RPB * kHMax * sizeof(float);
  static constexpr size_t kBytes = kBwdStages * kStage + kH0 + 2 * (size_t)RPB * kDg * 4;
};

template <typename T, int RPB>
__global__ void __launch_bounds__(kThreads)
gru_bwd_kernel(const T* __restrict__ xw, const T* __restrict__ hs, const T* __restrict__ g,
               const float* __restrict__ h0, const float* __restrict__ gh,
               const float* __restrict__ wh, const float* __restrict__ bhn,
               float* __restrict__ dxw, float* __restrict__ dgh, float* __restrict__ dh0,
               int steps, int rows, int H) {
  typedef BwdSmem<T, RPB> L;
  constexpr int kOwn = (RPB + kParts - 1) / kParts;  // rows a lane owns
  extern __shared__ __align__(16) char smem[];
  // tiles of the ring's buffer s
  const auto sx = [&](int s) { return reinterpret_cast<T*>(smem + s * L::kStage); };
  const auto sg = [&](int s) { return reinterpret_cast<T*>(smem + s * L::kStage + L::kX); };
  const auto shp = [&](int s) {
    return reinterpret_cast<T*>(smem + s * L::kStage + L::kX + L::kH);
  };
  const auto sgh = [&](int s) {
    return reinterpret_cast<float*>(smem + s * L::kStage + L::kX + 2 * L::kH);
  };
  float* sh0 = reinterpret_cast<float*>(smem + kBwdStages * L::kStage);
  float* sdg = sh0 + RPB * kHMax;  // two buffers of RPB rows of kDg
  const int H3 = 3 * H, j = threadIdx.x / kParts, p = threadIdx.x % kParts;
  const int r0 = blockIdx.x * RPB, nr = min(RPB, rows - r0);
  const bool col = j < H;

  float w[kBwdRuns][4];
#pragma unroll
  for (int i = 0; i < kBwdRuns; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 4 * (p + kParts * i) + u;
      w[i][u] = (col && c < H3) ? wh[j * H3 + c] : 0.f;
    }
  const float b = col ? bhn[j] : 0.f;
  float dh[kOwn], dhz[kOwn];
#pragma unroll
  for (int q = 0; q < kOwn; ++q) dh[q] = dhz[q] = 0.f;
  for (int i = threadIdx.x; i < 2 * RPB * kDg; i += blockDim.x) sdg[i] = 0.f;

  // A step's tiles are the same spans of xw, g, hs and GH at every step, a
  // fixed distance further on, so each thread plans its 16-byte chunks of
  // them once (the step the kernel is issue-bound: copy_to_shared's per-step
  // address arithmetic for four tiles took a fifth of it); spans not in whole
  // aligned chunks (H not a multiple of 8) take copy_to_shared each step.
  constexpr int kMaxChunks = (int)((L::kStage + 16 * kThreads - 1) / (16 * kThreads));
  unsigned long long c_src[kMaxChunks];  // the chunk's source at step 0
  unsigned long long c_step[kMaxChunks];  // bytes a step
  unsigned c_dst[kMaxChunks];  // its offset in a ring buffer
  bool c_hp[kMaxChunks];  // a chunk of h_{t-1}: none at step 0
  bool planned = true;
  {
    const int esz = (int)sizeof(T);
    // span i: source of step 0 (h_{t-1}: of step 1, less a step), bytes a
    // step, bytes, offset in a ring buffer
    const unsigned long long base[4] = {
        (unsigned long long)(xw + (size_t)r0 * H3), (unsigned long long)(g + (size_t)r0 * H),
        (unsigned long long)(hs + (size_t)r0 * H) - (unsigned long long)rows * H * esz,
        (unsigned long long)(gh + (size_t)r0 * H3)};
    const unsigned long long step[4] = {(unsigned long long)rows * H3 * esz,
                                        (unsigned long long)rows * H * esz,
                                        (unsigned long long)rows * H * esz,
                                        (unsigned long long)rows * H3 * 4};
    const int bytes[4] = {nr * H3 * esz, nr * H * esz, nr * H * esz, nr * H3 * 4};
    const unsigned off[4] = {0, (unsigned)L::kX, (unsigned)(L::kX + L::kH),
                             (unsigned)(L::kX + 2 * L::kH)};
    for (int i = 0; i < 4; ++i)
      planned = planned && bytes[i] % 16 == 0 && base[i] % 16 == 0 && step[i] % 16 == 0;
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      int c = threadIdx.x + k * kThreads, i = 0;  // the chunk's span and index in it
      while (i < 4 && c >= bytes[i] / 16) c -= bytes[i++] / 16;
      c_hp[k] = i == 2;
      c_src[k] = i < 4 ? base[i] + 16ull * c : 0;
      c_step[k] = i < 4 ? step[i] : 0;
      c_dst[k] = i < 4 ? off[i] + 16u * c : ~0u;
    }
  }
  const unsigned ring = (unsigned)__cvta_generic_to_shared(smem);
  // step t's tiles into the ring's buffer t % kBwdStages, one commit group
  const auto load_step = [&](int t) {
    const int s = t % kBwdStages;
    if (planned) {
#pragma unroll
      for (int k = 0; k < kMaxChunks; ++k)
        if (c_dst[k] != ~0u && (t > 0 || !c_hp[k]))
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                           ring + (unsigned)(s * L::kStage) + c_dst[k]),
                       "l"(c_src[k] + (unsigned long long)t * c_step[k]));
    } else {
      const size_t at = (size_t)t * rows + r0;
      copy_to_shared(sx(s), xw + at * H3, nr * H3);
      copy_to_shared(sgh(s), gh + at * H3, nr * H3);
      copy_to_shared(sg(s), g + at * H, nr * H);
      if (t > 0) copy_to_shared(shp(s), hs + (at - rows) * H, nr * H);
    }
    cp_async_commit();
  };
  copy_to_shared(sh0, h0 + (size_t)r0 * H, nr * H);
  for (int k = 1; k < kBwdStages; ++k) {
    if (steps - k >= 0) load_step(steps - k);
    else cp_async_commit();
  }
  cp_async_wait<kBwdStages - 2>();  // step T-1's tiles have landed
  __syncthreads();

  for (int t = steps - 1; t >= 0; --t) {
    const int s = t % kBwdStages;
    if (t - (kBwdStages - 1) >= 0) load_step(t - (kBwdStages - 1));
    else cp_async_commit();

    // the gate gradients of column j, rows r = p + 4 q: the lanes of a warp
    // take their rows at once
    const size_t at = (size_t)t * rows + r0;
    float* dg_s = sdg + (t & 1) * RPB * kDg;
#pragma unroll
    for (int q = 0; q < kOwn; ++q) {
      const int r = p + kParts * q;
      if (r < nr && col) {
        const T* xr = sx(s) + r * H3;
        const float* ghr = sgh(s) + r * H3;
        const float hp = t > 0 ? Num<T>::to_f(shp(s)[r * H + j]) : sh0[r * H + j];
        const float rg = sigmoidf(Num<T>::to_f(xr[j]) + ghr[j]);
        const float zg = sigmoidf(Num<T>::to_f(xr[H + j]) + ghr[H + j]);
        const float ghn_b = ghr[2 * H + j] + b;
        const float ng = tanhf(Num<T>::to_f(xr[2 * H + j]) + rg * ghn_b);
        const float d = Num<T>::to_f(sg(s)[r * H + j]) + dh[q];
        const float dz = d * (hp - ng);
        const float dn = d * (1.f - zg);
        const float dpre_n = dn * (1.f - ng * ng);
        const float da_hn = dpre_n * rg;
        const float dpre_r = dpre_n * ghn_b * rg * (1.f - rg);
        const float dpre_z = dz * zg * (1.f - zg);
        float* dx = dxw + (at + r) * H3;
        float* dgg = dgh + (at + r) * H3;
        dx[j] = dpre_r;
        dx[H + j] = dpre_z;
        dx[2 * H + j] = dpre_n;
        dgg[j] = dpre_r;
        dgg[H + j] = dpre_z;
        dgg[2 * H + j] = da_hn;
        dg_s[r * kDg + j] = dpre_r;
        dg_s[r * kDg + H + j] = dpre_z;
        dg_s[r * kDg + 2 * H + j] = da_hn;
        dhz[q] = d * zg;
      }
    }
    cp_async_wait<kBwdStages - 2>();  // step t-1's tiles have landed
    __syncthreads();  // dgh of step t complete; step t is done with its tiles

    // dh_{t-1} = dh z + dgh W_h^T
    float acc[RPB];
#pragma unroll
    for (int r = 0; r < RPB; ++r) acc[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kBwdRuns; ++i) {
#pragma unroll
      for (int r = 0; r < RPB; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(&dg_s[r * kDg + 4 * (p + kParts * i)]);
        acc[r] = fmaf(v.x, w[i][0], acc[r]);
        acc[r] = fmaf(v.y, w[i][1], acc[r]);
        acc[r] = fmaf(v.z, w[i][2], acc[r]);
        acc[r] = fmaf(v.w, w[i][3], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPB; ++r) {
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
    }
#pragma unroll
    for (int q = 0; q < kOwn; ++q) {
      float dot = acc[0];  // acc[p + 4 q], selected without indexing by p
#pragma unroll
      for (int r = 1; r < RPB; ++r)
        if (r == p + kParts * q) dot = acc[r];
      dh[q] = dhz[q] + dot;
    }
  }
#pragma unroll
  for (int q = 0; q < kOwn; ++q) {
    const int r = p + kParts * q;
    if (r < nr && col) dh0[(size_t)(r0 + r) * H + j] = dh[q];
  }
}

// partials[c][offset + o] = the sum over the rows of chunk c of `chunks` of
// x[row * ld + o], o < cols <= kHMax: db_hn's chunk partials from dgh. Each
// of a block's kColGroups groups of kHMax threads sums an eighth of the
// chunk's rows in order, and thread o of group 0 adds the parts in order.
constexpr int kColGroups = 8;

__global__ void __launch_bounds__(kColGroups * kHMax)
gru_colsum_kernel(const float* __restrict__ x, long long ld, int rows, int cols, int chunks,
                  int k_total, int offset, float* __restrict__ partials) {
  __shared__ float part[kColGroups][kHMax];
  const int c = blockIdx.x, grp = threadIdx.x / kHMax, o = threadIdx.x % kHMax;
  const long long r0 = (long long)rows * c / chunks, r1 = (long long)rows * (c + 1) / chunks;
  const long long a = r0 + (r1 - r0) * grp / kColGroups;
  const long long b = r0 + (r1 - r0) * (grp + 1) / kColGroups;
  float acc = 0.f;
  if (o < cols) {
#pragma unroll 8
    for (long long r = a; r < b; ++r) acc += x[r * ld + o];
  }
  part[grp][o] = acc;
  __syncthreads();
  if (grp == 0 && o < cols) {
    float sum = part[0][o];
#pragma unroll
    for (int q = 1; q < kColGroups; ++q) sum += part[q][o];
    partials[(size_t)c * k_total + offset + o] = sum;
  }
}

// out = the sum over chunks c (in order) of partials[c], whose first 3H*H
// values are dW_h^T (3H, H) and whose last H are db_hn; out is dW_h (H, 3H)
// then db_hn. Thread k reads element k of each chunk (neighbouring threads,
// neighbouring addresses) and writes it transposed.
__global__ void gru_reduce_kernel(const float* __restrict__ partials, int n_chunks, int H,
                                  float* __restrict__ out) {
  const int H3 = 3 * H, k_total = H3 * H + H;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= k_total) return;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc += partials[(size_t)c * k_total + k];
  out[k < H3 * H ? (k % H) * H3 + k / H : k] = acc;
}

template <int RPB>
const void* fwd_instance(int dtype) {
  return dtype == 0 ? (const void*)gru_fwd_kernel<float, RPB>
                    : (const void*)gru_fwd_kernel<__nv_bfloat16, RPB>;
}

template <int RPB>
const void* bwd_instance(int dtype) {
  return dtype == 0 ? (const void*)gru_bwd_kernel<float, RPB>
                    : (const void*)gru_bwd_kernel<__nv_bfloat16, RPB>;
}

// the instance for (direction, dtype, rows per block); null for another count
const void* kernel_for(int bwd, int dtype, int rpb) {
  switch (rpb) {
    case 1: return bwd ? bwd_instance<1>(dtype) : fwd_instance<1>(dtype);
    case 2: return bwd ? bwd_instance<2>(dtype) : fwd_instance<2>(dtype);
    case 4: return bwd ? bwd_instance<4>(dtype) : fwd_instance<4>(dtype);
    case 8: return bwd ? bwd_instance<8>(dtype) : fwd_instance<8>(dtype);
    default: return nullptr;
  }
}

template <int RPB>
size_t bwd_smem(int dtype) {
  return dtype == 0 ? BwdSmem<float, RPB>::kBytes : BwdSmem<__nv_bfloat16, RPB>::kBytes;
}

// the dynamic shared memory of an instance (the forward's is static), with
// the launch's attribute set where it exceeds 48 KB
cudaError_t smem_for(int bwd, int dtype, int rpb, size_t* bytes) {
  *bytes = 0;
  if (!bwd) return cudaSuccess;
  switch (rpb) {
    case 1: *bytes = bwd_smem<1>(dtype); break;
    case 2: *bytes = bwd_smem<2>(dtype); break;
    case 4: *bytes = bwd_smem<4>(dtype); break;
    case 8: *bytes = bwd_smem<8>(dtype); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaFuncSetAttribute(kernel_for(bwd, dtype, rpb),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

// The backward as stages on one stream (see the top of this file), with f32
// scratch gh and dgh (T, R, 3H) and partials (chunks + h0_chunks, 3H*H + H):
// chunk c < chunks holds the share of rows chunk c of dgh[1:] against
// hs[:T-1], the h0_chunks after it dgh[0] against h0; db_hn's column sums
// split all T*R rows of dgh into as many chunks.
template <typename T>
cudaError_t launch_bwd(const T* xw, const T* hs, const T* g, const float* h0, const float* wh,
                       const float* bhn, float* dxw, float* dh0, float* gh, float* dgh,
                       float* partials, float* dweights, int steps, int rows, int H, int rpb,
                       int grid, int chunks, int h0_chunks, cudaStream_t st) {
  using gemm::operand;
  using gemm::output;
  const int H3 = 3 * H, k_total = H3 * H + H, slots = chunks + h0_chunks;
  const int prev = (steps - 1) * rows;  // rows of hs[:T-1]
  const size_t step = (size_t)rows * H3;
  const int dtype = sizeof(T) == 2 ? 1 : 0;
  size_t smem = 0;
  cudaError_t err;
#define REFIL_TRY(call) \
  if ((err = (call)) != cudaSuccess) return err
  // (i) GH[1:] = hs[:T-1] W_h, GH[0] = h0 W_h
  REFIL_TRY((gemm::launch<T, float, true>(operand(hs, H), operand(wh, H3),
                                          output(gh + step, H3), prev, H3, H, 1, st)));
  REFIL_TRY((gemm::launch<float, float, true>(operand(h0, H), operand(wh, H3), output(gh, H3),
                                              rows, H3, H, 1, st)));
  // (ii)
  REFIL_TRY(smem_for(1, dtype, rpb, &smem));
  void* args[] = {(void*)&xw, (void*)&hs, (void*)&g, (void*)&h0, (void*)&gh, (void*)&wh,
                  (void*)&bhn, (void*)&dxw, (void*)&dgh, (void*)&dh0, (void*)&steps,
                  (void*)&rows, (void*)&H};
  REFIL_TRY(cudaLaunchKernel(kernel_for(1, dtype, rpb), dim3(grid), dim3(kThreads), args, smem,
                             st));
  // (iii) dW_h^T = dgh^T h_prev in row chunks, db_hn, the chunks summed
  REFIL_TRY((gemm::launch<float, T, false>(operand(dgh + step, H3), operand(hs, H),
                                           output(partials, H, 1, 1, 0, 0, k_total), H3, H, prev,
                                           chunks, st)));
  REFIL_TRY((gemm::launch<float, float, false>(
      operand(dgh, H3), operand(h0, H),
      output(partials + (size_t)chunks * k_total, H, 1, 1, 0, 0, k_total), H3, H, rows,
      h0_chunks, st)));
  gru_colsum_kernel<<<slots, kColGroups * kHMax, 0, st>>>(dgh + 2 * H, H3, steps * rows, H,
                                                          slots, k_total, H3 * H, partials);
  REFIL_TRY(cudaGetLastError());
  gru_reduce_kernel<<<(k_total + 255) / 256, 256, 0, st>>>(partials, slots, H, dweights);
#undef REFIL_TRY
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gru_max_hidden() { return kHMax; }

// The launch of a direction (bwd 0: the forward, 1: the backward's stage
// (ii)) for `rows` rows: the fewest rows per block (1, 2, 4 or 8) whose grid
// is resident all at once (blocks <= SMs x the blocks of that instance an SM
// holds), since the T loop lives inside the kernel and a second wave of
// blocks would run all T steps again after the first; 8 where none is. Fewer
// rows per block spread the rows over more SMs and give each SM more warps
// to hide a step's latency. For the backward also the row chunks of its
// weight-gradient products, about two blocks per SM: `chunks` over the
// (T-1) R rows of hs[:T-1], `h0_chunks` over the R rows of h0, each chunk at
// least 64 rows (0 for the forward).
int gru_plan(int bwd, int dtype, int steps, int rows, int H, int device, int* rows_per_block,
             int* grid, int* blocks_per_sm, int* chunks, int* h0_chunks) {
  int n_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  for (int rpb = 1; rpb <= 8; rpb *= 2) {
    int per_sm = 0;
    size_t smem = 0;
    err = smem_for(bwd, dtype, rpb, &smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_for(bwd, dtype, rpb),
                                                          kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (rows + rpb - 1) / rpb;
    if (blocks <= n_sm * per_sm || rpb == 8) {
      *rows_per_block = rpb;
      *grid = blocks;
      *blocks_per_sm = per_sm;
      // blocks of one chunk of the weight-gradient products: (3H / 128) x 1
      const int tiles = (3 * H + gemm::kBM - 1) / gemm::kBM;
      const int c = 2 * n_sm / tiles;
      const int c_prev = (steps - 1) * rows / 64, c_h0 = rows / 64;
      *chunks = bwd ? (c_prev < 1 ? 1 : (c < c_prev ? c : c_prev)) : 0;
      *h0_chunks = bwd ? (c_h0 < 1 ? 1 : (c < c_h0 ? c : c_h0)) : 0;
      return (int)cudaSuccess;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// dtype of xw and hs: 0 = float32, 1 = bfloat16. wh, bhn, h0 are float32.
// rows_per_block and grid come from gru_plan(bwd = 0).
int gru_fwd(int dtype, const void* xw, const void* wh, const void* bhn, const void* h0, void* hs,
            int steps, int rows, int H, int rows_per_block, int grid, void* stream) {
  if (H < 1 || H > kHMax) return (int)cudaErrorInvalidValue;
  if (grid * rows_per_block < rows) return (int)cudaErrorInvalidValue;
  const void* kernel = kernel_for(0, dtype, rows_per_block);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&xw, (void*)&wh, (void*)&bhn, (void*)&h0, (void*)&hs,
                  (void*)&steps, (void*)&rows, (void*)&H};
  cudaError_t err = cudaLaunchKernel(kernel, dim3(grid), dim3(kThreads), args, 0,
                                     (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// g has xw's dtype. f32 scratch gh and dgh (T*R*3H), partials (chunks +
// h0_chunks, H*3H + H); dweights: (H*3H + H,) f32, laid out as dW_h (H, 3H)
// then db_hn (H,). rows_per_block, grid, chunks and h0_chunks come from
// gru_plan(bwd = 1).
int gru_bwd(int dtype, const void* xw, const void* hs, const void* g, const void* h0,
            const void* wh, const void* bhn, void* dxw, void* dh0, void* gh, void* dgh,
            void* partials, void* dweights, int steps, int rows, int H, int rows_per_block,
            int grid, int chunks, int h0_chunks, void* stream) {
  if (H < 1 || H > kHMax || chunks < 1 || h0_chunks < 1) return (int)cudaErrorInvalidValue;
  if (grid * rows_per_block < rows || kernel_for(1, dtype, rows_per_block) == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  typedef __nv_bfloat16 B;
  const float *fh0 = (const float*)h0, *fwh = (const float*)wh, *fb = (const float*)bhn;
  float *fdx = (float*)dxw, *fdh0 = (float*)dh0, *fgh = (float*)gh, *fdg = (float*)dgh;
  float *fp = (float*)partials, *fdw = (float*)dweights;
  const cudaError_t err =
      dtype == 0 ? launch_bwd<float>((const float*)xw, (const float*)hs, (const float*)g, fh0,
                                     fwh, fb, fdx, fdh0, fgh, fdg, fp, fdw, steps, rows, H,
                                     rows_per_block, grid, chunks, h0_chunks, st)
                 : launch_bwd<B>((const B*)xw, (const B*)hs, (const B*)g, fh0, fwh, fb, fdx,
                                 fdh0, fgh, fdg, fp, fdw, steps, rows, H, rows_per_block, grid,
                                 chunks, h0_chunks, st);
  return (int)err;
}

const char* gru_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
