// Blocked online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py: out = softmax(q k^T / sqrt(D)) v
// per head, with GQA (q head h reads kv head h / (Hq / Hkv)), causal
// masking, a sliding `window`, a `q_offset` (q row i sits at kv position
// q_offset + i) and Dv != D.  The logits (Sq x Skv) never reach device
// memory: the running max, running sum and output accumulator stay on
// chip across the whole KV loop, in f32, whatever the input type.  On
// request each q row also writes max + log(sum) of its scaled logits, in
// f32 (`lse`): a decode over keys split across ranks combines the ranks'
// partial outputs by these weights.
//
// Two kernel bodies, chosen by an explicit route check before the launch
// (`tc_route`; the entry reports the route it took, and the Python
// wrapper, which checks the same rule first, counts it):
//
// * bf16 with D and Dv at most 128, each a multiple of 8: the tensor-core
//   kernel `flash_attention_tc_kernel`, FlashAttention-2 style on
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate).  What bounds it at the
//   serving shapes (B = 1, 16 heads of 64, S = 64-1000): neither bytes
//   (0.6 MB at S = 384: 0.2 us) nor the bf16 tensor rate (0.3 GFLOP: 0.3
//   us) but the issue rate and latency of one warp's chain per 64-key step
//   (ldmatrix -> mma -> softmax -> mma), with 1-3 warps per SM
//   sub-partition: the heaviest causal block walks up to Sq / 64 steps.
//   So the design keeps every step short and lets the compiler overlap it:
//     - each warp owns 16 q rows; Q fragments are loaded once with
//       ldmatrix and stay in registers;
//     - K and V tiles of 64 keys arrive by 16-byte cp.async in a ring of
//       three stages (the next two tiles in flight while this one is
//       multiplied); a thread's copies need one pointer per call and no
//       division; rows are padded by 16 bytes (an odd multiple of 16 bytes
//       apart), so every ldmatrix phase hits 8 distinct bank quads;
//     - D and Dv are padded with zeros in shared memory to 64 or 128, a
//       compile-time width: the head-dim loops have fixed trip counts and
//       the strides are constants (D = 80 runs as 128, D = 32 / Dv = 48 as
//       64 / 64: more mma work, the same result);
//     - S = Q K^T accumulates in f32 registers; the 1 / sqrt(D) scale
//       (times log2 e, for exp2) is applied to S in f32, never folded
//       into bf16 q: one fma per logit, 2^(s scale - m);
//     - the mask is applied only on tiles that cross the causal diagonal,
//       the window edge or Skv, by a second compiled copy of the step; the
//       row max and sum live in the mma accumulator layout, reduced over
//       the 4 lanes of a quad by shuffles;
//     - P is rounded to bf16 straight from the S accumulators into A
//       fragments (no trip through shared memory), V is read with
//       ldmatrix.trans, O accumulates in f32 and is divided by l and
//       rounded to bf16 once, at the store;
//     - the grid covers B * Hq * ceil(Sq / 64) q blocks of 4 warps, the
//       heaviest causal blocks (the last q rows) issued first.  Under one
//       wave of the 132 SMs (every serving prefill up to 512 tokens at 16
//       heads), 32-row blocks of 2 warps would double the grid; measured
//       on the card they were slower: each warp then issues twice the
//       copies, and a warp's step, not the count of busy SMs, is what
//       bounds the time.
//   mma.sync and cp.async rather than wgmma and TMA: at these shapes the
//   kernel is nowhere near a rate limit, and what cost the time in the
//   first version (scalar f32 math, loads with nothing in flight, a thin
//   grid) these remove.
//
// * every other case (f32; bf16 with a head dim over 128, such as an
//   MLA-like D = 192): the CUDA-core kernel `flash_attention_kernel`, in
//   f32 throughout.  f32 inputs must stay within 2e-5 of the plain
//   version, which rules out bf16 or TF32 tensor-core math.  One block of
//   128 threads per (b * Hq + h, 32-row q block); the q block
//   (pre-scaled), one 64-key K block and its V block are staged in shared
//   memory as f32; four neighbouring lanes own one q row, each holding 16
//   of the block's 64 logits and Dv / 4 accumulator columns in registers.
//
// Masking follows the Pallas kernel exactly in both: a masked key gets the
// logit -1e30, not -inf, so a row with no visible key at all averages V
// over every key (exp(0) = 1 each) instead of giving 0.  Keys at or past
// Skv (a ragged Skv, which the Pallas kernel never sees) are excluded
// outright.  Blocks that no row of the q block can see are skipped only
// when every row sees some key: then their terms are exactly 0 in f32, and
// skipping them changes nothing.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 32;            // q rows per block (4 lanes per row)
constexpr int kBK = 64;            // keys per KV block
constexpr int kPerLane = kBK / 4;  // logits per lane
constexpr float kMasked = -1e30f;  // the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T, int DV_MAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int Hq,
                       int Hkv, int Sq, int Skv, int D, int Dv, float scale,
                       int causal, int has_window, int window, int q_offset) {
  extern __shared__ float smem[];
  const int dq = D + 1;                       // padded row strides
  float* qs = smem;                           // [kBQ][D + 1]
  float* ks = qs + kBQ * dq;                  // [kBK][D + 1]
  float* vs = ks + kBK * dq;                  // [kBK][Dv]
  float* ps = vs + kBK * Dv;                  // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int r = tid / 4, lane = tid % 4;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const T* qg = q + static_cast<size_t>(bh) * Sq * D;
  const T* kg = k + static_cast<size_t>(kvh) * Skv * D;
  const T* vg = v + static_cast<size_t>(kvh) * Skv * Dv;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    qs[rr * dq + d] = q0 + rr < Sq
        ? to_f32(qg[static_cast<size_t>(q0 + rr) * D + d]) * scale : 0.0f;
  }

  // The keys a row at position p can see: [lo(p), hi(p)], both
  // non-decreasing in p, so the q block's union is [lo(first), hi(last)].
  const int row_last = min(q0 + kBQ, Sq) - 1;
  const int qpos = q0 + r + q_offset;
  auto lo_of = [&](int p) { return has_window ? max(0, p - window + 1) : 0; };
  auto hi_of = [&](int p) { return causal ? min(p, Skv - 1) : Skv - 1; };
  const int blind = q0 + r <= row_last && lo_of(qpos) > hi_of(qpos);
  const int n_blocks = (Skv + kBK - 1) / kBK;
  int kb_lo = 0, kb_hi = n_blocks - 1;
  if (!__syncthreads_or(blind)) {
    kb_lo = lo_of(q0 + q_offset) / kBK;
    kb_hi = hi_of(row_last + q_offset) / kBK;
  }

  float m = kMasked, l = 0.0f;
  float acc[DV_MAX / 4];
#pragma unroll
  for (int i = 0; i < DV_MAX / 4; ++i) acc[i] = 0.0f;

  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int k0 = kb * kBK;
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      ks[c * dq + d] = k0 + c < Skv
          ? to_f32(kg[static_cast<size_t>(k0 + c) * D + d]) : 0.0f;
    }
    for (int i = tid; i < kBK * Dv; i += kThreads) {
      const int c = i / Dv, d = i % Dv;
      vs[c * Dv + d] = k0 + c < Skv
          ? to_f32(vg[static_cast<size_t>(k0 + c) * Dv + d]) : 0.0f;
    }
    __syncthreads();

    float s[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) s[j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * dq + d];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        s[j] += qd * ks[(lane + 4 * j) * dq + d];
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int kpos = k0 + lane + 4 * j;
      if (kpos >= Skv)
        s[j] = -INFINITY;                     // past the keys: excluded
      else if ((causal && kpos > qpos) ||
               (has_window && kpos <= qpos - window))
        s[j] = kMasked;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, quad_max(mx));
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const float p = expf(s[j] - m_new);
      ps[r * (kBK + 1) + lane + 4 * j] = p;
      sum += p;
    }
    const float alpha = expf(m - m_new);
    l = alpha * l + quad_sum(sum);
    m = m_new;
    __syncwarp();                             // a row's p stay in its warp
#pragma unroll
    for (int i = 0; i < DV_MAX / 4; ++i) acc[i] *= alpha;
    for (int c = 0; c < kBK; ++c) {
      const float p = ps[r * (kBK + 1) + c];
      const float* vrow = vs + c * Dv;
#pragma unroll
      for (int i = 0; i < DV_MAX / 4; ++i)
        if (lane + 4 * i < Dv) acc[i] += p * vrow[lane + 4 * i];
    }
    __syncthreads();
  }

  if (q0 + r > row_last) return;
  const float denom = l == 0.0f ? 1.0f : l;
  if (lse != nullptr && lane == 0)
    lse[static_cast<size_t>(bh) * Sq + q0 + r] = m + logf(denom);
  T* og = o + (static_cast<size_t>(bh) * Sq + q0 + r) * Dv;
#pragma unroll
  for (int i = 0; i < DV_MAX / 4; ++i)
    if (lane + 4 * i < Dv) store(og + lane + 4 * i, acc[i] / denom);
}

template <typename T, int DV_MAX>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Hq, int Hkv, int Sq, int Skv, int D, int Dv, float scale,
           int causal, int has_window, int window, int q_offset,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kBQ + kBK) * (D + 1) + kBK * Dv +
       kBQ * (kBK + 1));
  auto kernel = flash_attention_kernel<T, DV_MAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq, Hkv, Sq, Skv, D,
      Dv, scale, causal, has_window, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dv(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                int Dv, float scale, int causal, int has_window, int window,
                int q_offset, cudaStream_t stream) {
  if (Dv <= 64)
    return launch<T, 64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, Dv, scale,
                         causal, has_window, window, q_offset, stream);
  if (Dv <= 128)
    return launch<T, 128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, Dv, scale,
                          causal, has_window, window, q_offset, stream);
  return launch<T, 256>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, Dv, scale,
                        causal, has_window, window, q_offset, stream);
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// The route rule.  The entry reports the route it took (enum Route).
enum Route : int { ROUTE_CUDA_CORE = 0, ROUTE_TENSOR_CORE = 1 };
constexpr int kTcMaxHeadDim = 128;      // D and Dv at most this
constexpr int kTcHeadDimMultiple = 8;   // 8 bf16 = one 16-byte cp.async

constexpr int kTcWarps = 4;             // warps per block, 16 q rows each
constexpr int kTcBK = 64;               // keys per K / V tile
constexpr int kStages = 3;              // K / V tiles in the smem ring
constexpr int kTcPad = 8;               // bf16 of padding per smem row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked2 = kMasked * kLog2e;   // -1e30 in the log2 domain

int tc_route(int dtype, int D, int Dv) {
  return dtype == 1 && D <= kTcMaxHeadDim && Dv <= kTcMaxHeadDim &&
                 D % kTcHeadDimMultiple == 0 && Dv % kTcHeadDimMultiple == 0
             ? ROUTE_TENSOR_CORE
             : ROUTE_CUDA_CORE;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until the group is waited for; a
// row that is not `valid` is zero-filled (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's newest copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 address the rows of matrix i, and
// register i holds matrix i (row lane / 4, columns 2 (lane % 4) + 0, 1;
// with .trans the transpose: rows 2 (lane % 4) + 0, 1, column lane / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// c[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate.  With g = lane / 4
// and t = lane % 4: a = {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..)}; b = {(k 2t.., n g), (k 2t + 8.., n g)}; c = {(g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU.EX2 (exp2f adds a denormal fix-up around it): 2^-inf
// and 2^(-1e30) are +0, 2^0 is 1.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [r0, r0 + N_ROWS) of a row-major [rows][width] bf16 matrix (width a
// multiple of 8, at most W_MAX <= 128) into shared memory at row stride
// LD, by 16-byte cp.async; rows at or past `rows` are zero-filled.  Thread
// `tid` copies columns 8 (tid % 8) (and 8 (tid % 8) + 64 when W_MAX > 64)
// of rows tid / 8, tid / 8 + THREADS / 8, ...: no division, one pointer
// computed per call, a fixed unrolled loop.
template <int N_ROWS, int THREADS, int W_MAX, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int rows, int width, int tid) {
  constexpr int kStep = THREADS / 8;          // rows between a thread's
  static_assert(N_ROWS % kStep == 0, "whole row groups");
  const int c = (tid % 8) * 8, r = tid / 8;
  const bool lo = c < width, hi = W_MAX > 64 && c + 64 < width;
  const bf16* g = src + static_cast<size_t>(r0 + r) * width + c;
  const uint32_t d = smem_u32(dst + r * LD + c);
#pragma unroll
  for (int i = 0; i < N_ROWS / kStep; ++i) {
    const bool valid = r0 + r + i * kStep < rows;
    const bf16* gi = valid ? g + static_cast<size_t>(i) * kStep * width : src;
    const uint32_t di = d + i * kStep * LD * sizeof(bf16);
    if (lo) cp_async16(di, gi, valid);
    if (hi) cp_async16(di + 128, gi + 64, valid);
  }
}

// Columns [c0, c1) of `rows` shared-memory rows set to 0 (the padding of
// D and Dv up to the kernel's compile-time width).
__device__ __forceinline__ void zero_cols(bf16* base, int rows, int ld,
                                          int c0, int c1, int tid,
                                          int threads) {
  const int w = c1 - c0;
  if (w <= 0) return;
  for (int i = tid; i < rows * w; i += threads)
    base[(i / w) * ld + c0 + i % w] = __float2bfloat16(0.0f);
}

// One block of 4 warps per (b * Hq + h, 64-row q block).  D and Dv are
// padded with zeros in shared memory to the compile-time DP and DVP (64 or
// 128): every loop over the head dims has a fixed trip count and every
// shared-memory stride is a constant, so the compiler can hoist the
// ldmatrix loads and interleave the mma chains (a run-time trip count put
// each ldmatrix -> mma pair in a basic block of its own).
template <int DP, int DVP>
__global__ void __launch_bounds__(kTcWarps * 32, 1)
flash_attention_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int BH, int Hq,
                          int Hkv, int Sq, int Skv, int D, int Dv,
                          float scale_log2, int causal,
                          int has_window, int window, int q_offset) {
  constexpr int kThreadsTc = kTcWarps * 32;
  constexpr int kBQTc = kTcWarps * 16;
  constexpr int KD = DP / 16;            // k-steps of Q K^T
  constexpr int NV = DVP / 8;            // n-tiles of P V
  constexpr int NS = kTcBK / 8;          // n-tiles of S
  constexpr int ldk = DP + kTcPad, ldv = DVP + kTcPad;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQTc][ldk]
  bf16* ks = qs + kBQTc * ldk;                   // [kStages][kTcBK][ldk]
  bf16* vs = ks + kStages * kTcBK * ldk;         // [kStages][kTcBK][ldv]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n_qb = (Sq + kBQTc - 1) / kBQTc;
  const int bh = blockIdx.x % BH;
  const int qb = n_qb - 1 - static_cast<int>(blockIdx.x / BH);
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = qb * kBQTc;
  const bf16* qg = q + static_cast<size_t>(bh) * Sq * D;
  const bf16* kg = k + static_cast<size_t>(kvh) * Skv * D;
  const bf16* vg = v + static_cast<size_t>(kvh) * Skv * Dv;

  zero_cols(qs, kBQTc, ldk, D, DP, tid, kThreadsTc);
  zero_cols(ks, kStages * kTcBK, ldk, D, DP, tid, kThreadsTc);
  zero_cols(vs, kStages * kTcBK, ldv, Dv, DVP, tid, kThreadsTc);

  // The keys a row at position p can see: [lo(p), hi(p)], both
  // non-decreasing in p, so the q block's union is [lo(first), hi(last)].
  const int row_last = min(q0 + kBQTc, Sq) - 1;
  auto lo_of = [&](int p) { return has_window ? max(0, p - window + 1) : 0; };
  auto hi_of = [&](int p) { return causal ? min(p, Skv - 1) : Skv - 1; };
  const int own = q0 + tid / 2;               // two threads per row
  const int blind = own <= row_last &&
                    lo_of(own + q_offset) > hi_of(own + q_offset);
  const int n_tiles = (Skv + kTcBK - 1) / kTcBK;
  int kb_lo = 0, kb_hi = n_tiles - 1;
  if (!__syncthreads_or(blind)) {
    kb_lo = lo_of(q0 + q_offset) / kTcBK;
    kb_hi = hi_of(row_last + q_offset) / kTcBK;
  }

  // A ring of kStages K / V tiles: tile kb lives in stage
  // (kb - kb_lo) % kStages, and kStages - 1 tiles are in flight ahead of
  // the one being multiplied.  Every step commits one group (empty past
  // kb_hi), so "all but the kStages - 2 newest groups done" always means
  // "this step's tile done".
  load_rows<kBQTc, kThreadsTc, DP, ldk>(qs, qg, q0, Sq, D, tid);
  auto load_kv = [&](int kb) {
    if (kb <= kb_hi) {
      const int st = (kb - kb_lo) % kStages;
      load_rows<kTcBK, kThreadsTc, DP, ldk>(ks + st * kTcBK * ldk, kg,
                                            kb * kTcBK, Skv, D, tid);
      load_rows<kTcBK, kThreadsTc, DVP, ldv>(vs + st * kTcBK * ldv, vg,
                                             kb * kTcBK, Skv, Dv, tid);
    }
    cp_async_commit();
  };
  for (int i = 0; i < kStages - 1; ++i) load_kv(kb_lo + i);  // q: 1st group

  // This warp's 16 rows: row g and g + 8 of each accumulator tile.
  const int w0 = q0 + warp * 16;
  const bool live = w0 < Sq;
  const int pos_first = w0 + q_offset, pos_last = pos_first + 15;
  uint32_t qa[KD][4];
  float acc[NV][4];
#pragma unroll
  for (int t = 0; t < NV; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
  float m_run[2] = {kMasked2, kMasked2}, l_run[2] = {0.0f, 0.0f};

  // One 64-key step.  The mask is applied only on tiles that cross the
  // causal diagonal, the window edge or Skv, by a second copy of the step
  // (kMask, a compile-time tag): a run-time branch between the two
  // products would keep the compiler from overlapping the S mma's with
  // the softmax.
  auto step = [&](int kb, int buf, auto mask_tag) {
    constexpr bool kMask = decltype(mask_tag)::value;
    const bf16* kt = ks + buf * kTcBK * ldk;
    const bf16* vt = vs + buf * kTcBK * ldv;

    // S = Q K^T: n-tiles 2 j2 and 2 j2 + 1 (keys 16 j2 ..) per ldmatrix.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int j2 = 0; j2 < NS / 2; ++j2)
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t kf[4];
        ldsm_x4(kf, smem_u32(kt + (j2 * 16 + (lane & 7) + (lane >> 4) * 8) *
                                      ldk + kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * j2], qa[kk], kf[0], kf[1]);
        mma_bf16(s[2 * j2 + 1], qa[kk], kf[2], kf[3]);
      }

    // The logits in f32, scaled by 1 / sqrt(D) * log2 e: on a masked tile
    // scaled first, then masked; on the others the scale is folded into
    // one fma per element, p = 2^(s scale - m) (the row max of the raw
    // logits times the positive scale is the max of the scaled ones).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kMask) {                // branch-free per element
          const int kpos = kb * kTcBK + j * 8 + 2 * t4 + (e & 1);
          const int qpos = pos_first + g + (e >> 1) * 8;
          const bool masked = (causal & (kpos > qpos)) |
                              (has_window & (kpos <= qpos - window));
          const float x = s[j][e] * scale_log2;
          s[j][e] = kpos >= Skv ? -INFINITY    // past the keys: excluded
                                : (masked ? kMasked2 : x);
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float tile_max = kMask ? quad_max(mx[i])
                                   : quad_max(mx[i]) * scale_log2;
      const float m_new = fmaxf(m_run[i], tile_max);
      alpha[i] = fast_exp2(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float m = m_run[e >> 1];
        const float p = kMask ? fast_exp2(s[j][e] - m)
                              : fast_exp2(fmaf(s[j][e], scale_log2, -m));
        s[j][e] = p;
        rsum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = alpha[i] * l_run[i] + rsum[i];
#pragma unroll
    for (int t = 0; t < NV; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] *= alpha[e >> 1];

    // O += P V: P in bf16 straight from the S accumulators (keys 16 kk2 ..
    // are S tiles 2 kk2 and 2 kk2 + 1), V by ldmatrix.trans.
#pragma unroll
    for (int kk2 = 0; kk2 < kTcBK / 16; ++kk2) {
      uint32_t pa[4] = {pack_bf16(s[2 * kk2][0], s[2 * kk2][1]),
                        pack_bf16(s[2 * kk2][2], s[2 * kk2][3]),
                        pack_bf16(s[2 * kk2 + 1][0], s[2 * kk2 + 1][1]),
                        pack_bf16(s[2 * kk2 + 1][2], s[2 * kk2 + 1][3])};
#pragma unroll
      for (int np = 0; np < NV / 2; ++np) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, smem_u32(vt + (kk2 * 16 + (lane & 7) +
                                         ((lane >> 3) & 1) * 8) * ldv +
                                   np * 16 + (lane >> 4) * 8));
        mma_bf16(acc[2 * np], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
  };

  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int buf = (kb - kb_lo) % kStages;
    cp_async_wait<kStages - 2>();             // this tile (and q) arrived
    __syncthreads();                          // ... for every thread, and
                                              // tile kb - 1's stage is free
    load_kv(kb + kStages - 1);                // in flight while we compute
    if (!live) continue;
    if (kb == kb_lo) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qa[kk], smem_u32(qs + (warp * 16 + (lane & 7) +
                                       ((lane >> 3) & 1) * 8) * ldk +
                                 kk * 16 + (lane >> 4) * 8));
    }
    const int k0 = kb * kTcBK;
    if (k0 + kTcBK > Skv || (causal && k0 + kTcBK - 1 > pos_first) ||
        (has_window && k0 <= pos_last - window))
      step(kb, buf, std::true_type{});
    else
      step(kb, buf, std::false_type{});
  }
  if (!live) return;

  bf16* og = o + static_cast<size_t>(bh) * Sq * Dv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w0 + g + 8 * i;
    const float l = quad_sum(l_run[i]);
    const float inv = __frcp_rn(l == 0.0f ? 1.0f : l);
    if (row >= Sq) continue;
    if (lse != nullptr && t4 == 0)           // back from the log2 domain
      lse[static_cast<size_t>(bh) * Sq + row] =
          (m_run[i] + log2f(l == 0.0f ? 1.0f : l)) * kLn2;
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int col = t * 8 + 2 * t4;       // Dv is a multiple of 8
      if (col < Dv)
        *reinterpret_cast<uint32_t*>(og + static_cast<size_t>(row) * Dv +
                                     col) =
            pack_bf16(acc[t][2 * i] * inv, acc[t][2 * i + 1] * inv);
    }
  }
}

template <int DP, int DVP>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
              int Dv, float scale, int causal, int has_window, int window,
              int q_offset, cudaStream_t stream) {
  constexpr int bq = kTcWarps * 16;
  constexpr size_t smem =
      sizeof(bf16) * (bq * (DP + kTcPad) +
                      kStages * kTcBK * (DP + kTcPad + DVP + kTcPad));
  auto kernel = flash_attention_tc_kernel<DP, DVP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(B) * Hq * ((Sq + bq - 1) / bq);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kTcWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, B * Hq, Hq,
      Hkv, Sq, Skv, D, Dv, scale * kLog2e, causal, has_window, window,
      q_offset);
  return static_cast<int>(cudaGetLastError());
}

// D and Dv each padded to 64 or 128.
int dispatch_tc(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                int Dv, float scale, int causal, int has_window, int window,
                int q_offset, cudaStream_t stream) {
#define FA_TC_LAUNCH(DP, DVP)                                               \
  return launch_tc<DP, DVP>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, Dv,    \
                            scale, causal, has_window, window, q_offset,     \
                            stream)
  if (D <= 64) {
    if (Dv <= 64) FA_TC_LAUNCH(64, 64);
    FA_TC_LAUNCH(64, 128);
  }
  if (Dv <= 64) FA_TC_LAUNCH(128, 64);
  FA_TC_LAUNCH(128, 128);
#undef FA_TC_LAUNCH
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// out[B, Hq, Sq, Dv] = attention(q[B, Hq, Sq, D], k[B, Hkv, Skv, D],
// v[B, Hkv, Skv, Dv]) on `stream`; all contiguous, of one type: f32
// (dtype 0) or bf16 (dtype 1).  D and Dv at most 256, Hq a multiple of
// Hkv, Sq and Skv at least 1.  `scale` multiplies the logits (1 / sqrt(D)).
// `lse`, when not null, receives f32 [B, Hq, Sq]: each row's log-sum-exp
// of its scaled logits, max + log(sum), masked keys at -1e30 as in the
// softmax (the weight of this slice of keys when partials over several
// slices are combined).
// The kernel body is `tc_route(dtype, D, Dv)`, written to `*route` (enum
// Route) before anything else; the tensor-core route needs 16-byte aligned
// pointers and refuses others.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int Hq, int Hkv,
                               int Sq,
                               int Skv, int D, int Dv, float scale,
                               int causal, int has_window, int window,
                               int q_offset, int dtype, int* route,
                               cudaStream_t stream) {
  *route = tc_route(dtype, D, Dv);
  if (*route == ROUTE_TENSOR_CORE) {
    if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
      return static_cast<int>(cudaErrorMisalignedAddress);
    return dispatch_tc(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, Dv, scale,
                       causal, has_window, window, q_offset, stream);
  }
  if (dtype == 0)
    return dispatch_dv<float>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, Dv,
                              scale, causal, has_window, window, q_offset,
                              stream);
  return dispatch_dv<__nv_bfloat16>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D,
                                    Dv, scale, causal, has_window, window,
                                    q_offset, stream);
}
