// Blocked online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py: out = softmax(q k^T / sqrt(D)) v
// per head, with GQA (q head h reads kv head h / (Hq / Hkv)), causal
// masking, a sliding `window`, a `q_offset` (q row i sits at kv position
// q_offset + i) and Dv != D.  The logits (Sq x Skv) never reach device
// memory: the running max, running sum and output accumulator stay on
// chip across the whole KV loop, in f32, whatever the input type.
//
// What bounds it on this card: at the serving shapes (D = 64, a few
// hundred tokens) operations, here done in f32 on the CUDA cores.  This
// first version is simple and right; wgmma and TMA come later.
//
// Design: one block of 128 threads per (b * Hq + h, 32-row q block).  The
// q block (pre-scaled), one 64-key K block and its V block are staged in
// shared memory as f32; four neighbouring lanes own one q row, each
// holding 16 of the block's 64 logits and Dv / 4 accumulator columns in
// registers; the row max and sum reduce over the four lanes with shuffles.
//
// Masking follows the Pallas kernel exactly: a masked key gets the logit
// -1e30, not -inf, so a row with no visible key at all averages V over
// every key (exp(0) = 1 each) instead of giving 0.  Keys at or past Skv
// (a ragged Skv, which the Pallas kernel never sees) are excluded outright.
// Blocks that no row of the q block can see are skipped only when every
// row sees some key: then their terms are exactly 0 in f32, and skipping
// them changes nothing.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
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
  T* og = o + (static_cast<size_t>(bh) * Sq + q0 + r) * Dv;
#pragma unroll
  for (int i = 0; i < DV_MAX / 4; ++i)
    if (lane + 4 * i < Dv) store(og + lane + 4 * i, acc[i] / denom);
}

template <typename T, int DV_MAX>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, int D, int Dv, float scale,
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
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, D, Dv,
      scale, causal, has_window, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dv(const void* q, const void* k, const void* v, void* o, int B,
                int Hq, int Hkv, int Sq, int Skv, int D, int Dv, float scale,
                int causal, int has_window, int window, int q_offset,
                cudaStream_t stream) {
  if (Dv <= 64)
    return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, Dv, scale,
                         causal, has_window, window, q_offset, stream);
  if (Dv <= 128)
    return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, Dv, scale,
                          causal, has_window, window, q_offset, stream);
  return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, Dv, scale,
                        causal, has_window, window, q_offset, stream);
}

}  // namespace

// out[B, Hq, Sq, Dv] = attention(q[B, Hq, Sq, D], k[B, Hkv, Skv, D],
// v[B, Hkv, Skv, Dv]) on `stream`; all contiguous, of one type: f32
// (dtype 0) or bf16 (dtype 1).  D and Dv at most 256, Hq a multiple of
// Hkv, Sq and Skv at least 1.  `scale` multiplies q (1 / sqrt(D)).
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Hq, int Hkv, int Sq,
                               int Skv, int D, int Dv, float scale,
                               int causal, int has_window, int window,
                               int q_offset, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return dispatch_dv<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, Dv, scale,
                              causal, has_window, window, q_offset, stream);
  return dispatch_dv<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, Dv,
                                    scale, causal, has_window, window,
                                    q_offset, stream);
}
