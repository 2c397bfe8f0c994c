// W8A8 matmul with a fused epilogue for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `nmc_matmul` in
// src/repro/kernels/nmc_matmul.py: y[M,N] = act((x_q[M,K] @ w_q[K,N]) *
// scale[N] + bias[N]), int8 x int8 products accumulated in int32 (the
// NM-Carus vmacc rule: never accumulate at operand width), the dequant +
// bias + activation epilogue applied in registers before the one store.
//
// What bounds it on this card: at decode (M of 1 to 8) bytes, the int8
// weight matrix read once (the LM head alone is 155 MB); at prefill
// (M of a few hundred) operations.  This first version is simple and
// right; wgmma, TMA and mma.sync come later.
//
// Design: one block of 256 threads (16 x 16) per BM x 64 output tile,
// BM = 64 when M > 16 and 16 otherwise, so a decode call does not spend
// dp4a issue slots on 60 empty rows.  K is walked in 64-wide slabs staged
// through shared memory, packed four k values to a 32-bit word: x rows
// load as they lie, w columns are transposed 4 x 4 bytes at a time with
// __byte_perm.  Each thread keeps a TM x 4 int32 accumulator in registers
// (rows ty + 16 i, columns tx + 16 j) and issues one __dp4a per
// accumulator per packed word.
//
// Any M, N and K: the slabs are zero-filled past the edges and the stores
// are bounds-checked.  The epilogue rounds like the reference, a product
// and then a sum (__fmul_rn, __fadd_rn): nvcc -O3 would otherwise contract
// them into one FMA.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // 16 x 16
constexpr int kBN = 64;           // output columns per block
constexpr int kBK = 64;           // k values per slab
constexpr int kK4 = kBK / 4;      // packed words per slab row

enum Act : int { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };
enum Out : int { OUT_F32 = 0, OUT_BF16 = 1, OUT_I32 = 2 };

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(y, 0.0f);
    case ACT_SILU:                           // y * sigmoid(y)
      return y * (1.0f / (1.0f + expf(-y)));
    case ACT_GELU: {                         // tanh approximation
      const float inner = 0.7978845608028654f * (y + 0.044715f * y * y * y);
      return 0.5f * y * (1.0f + tanhf(inner));
    }
    default:
      return y;
  }
}

// Four consecutive int8 of one row, zero past `len`.
__device__ __forceinline__ uint32_t load4(const int8_t* row, int col, int len,
                                          bool vec) {
  if (vec && col + 3 < len)
    return *reinterpret_cast<const uint32_t*>(row + col);
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < len)
      r |= static_cast<uint32_t>(static_cast<uint8_t>(row[col + i]))
           << (8 * i);
  return r;
}

template <int TM, int OUT>
__global__ void __launch_bounds__(kThreads)
nmc_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, void* __restrict__ out,
                  int M, int N, int K, int act, bool vec_x, bool vec_w) {
  constexpr int kBM = 16 * TM;
  __shared__ uint32_t xs[kBM][kK4 + 1];      // [m][k/4], padded
  __shared__ uint32_t ws[kK4][kBN + 1];      // [k/4][n], padded
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  int acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x slab: kBM rows x 16 packed words, coalesced along k
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int idx = tid + r * kThreads;
      const int m = idx / kK4, k4 = idx % kK4;
      const int gm = m0 + m;
      xs[m][k4] = gm < M ? load4(x + static_cast<size_t>(gm) * K,
                                 k0 + 4 * k4, K, vec_x)
                         : 0u;
    }
    // w slab: thread (k4, g) reads 4 rows x 4 columns and transposes them
    {
      const int k4 = tid / 16, g = tid % 16;
      const int nb = n0 + 4 * g;
      uint32_t rows[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + 4 * k4 + i;
        rows[i] = k < K ? load4(w + static_cast<size_t>(k) * N, nb, N, vec_w)
                        : 0u;
      }
      const uint32_t t0 = __byte_perm(rows[0], rows[1], 0x5140);
      const uint32_t t1 = __byte_perm(rows[2], rows[3], 0x5140);
      const uint32_t t2 = __byte_perm(rows[0], rows[1], 0x7362);
      const uint32_t t3 = __byte_perm(rows[2], rows[3], 0x7362);
      ws[k4][4 * g + 0] = __byte_perm(t0, t1, 0x5410);
      ws[k4][4 * g + 1] = __byte_perm(t0, t1, 0x7632);
      ws[k4][4 * g + 2] = __byte_perm(t2, t3, 0x5410);
      ws[k4][4 * g + 3] = __byte_perm(t2, t3, 0x7632);
    }
    __syncthreads();
#pragma unroll 4
    for (int k4 = 0; k4 < kK4; ++k4) {
      int a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = static_cast<int>(xs[ty + 16 * i][k4]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = static_cast<int>(ws[k4][tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const size_t o = static_cast<size_t>(m) * N + n;
      if (OUT == OUT_I32) {
        static_cast<int32_t*>(out)[o] = acc[i][j];
        continue;
      }
      float y = __fmul_rn(__int2float_rn(acc[i][j]), scale[n]);
      if (bias != nullptr) y = __fadd_rn(y, bias[n]);
      y = activate(y, act);
      if (OUT == OUT_F32)
        static_cast<float*>(out)[o] = y;
      else
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
    }
  }
}

template <int TM, int OUT>
void launch(const int8_t* x, const int8_t* w, const float* scale,
            const float* bias, void* out, int M, int N, int K, int act,
            bool vec_x, bool vec_w, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + 16 * TM - 1) / (16 * TM));
  nmc_matmul_kernel<TM, OUT><<<grid, kThreads, 0, stream>>>(
      x, w, scale, bias, out, M, N, K, act, vec_x, vec_w);
}

template <int TM>
void dispatch_out(int out_kind, const int8_t* x, const int8_t* w,
                  const float* scale, const float* bias, void* out, int M,
                  int N, int K, int act, bool vec_x, bool vec_w,
                  cudaStream_t stream) {
  if (out_kind == OUT_F32)
    launch<TM, OUT_F32>(x, w, scale, bias, out, M, N, K, act, vec_x, vec_w,
                        stream);
  else if (out_kind == OUT_BF16)
    launch<TM, OUT_BF16>(x, w, scale, bias, out, M, N, K, act, vec_x, vec_w,
                         stream);
  else
    launch<TM, OUT_I32>(x, w, scale, bias, out, M, N, K, act, vec_x, vec_w,
                        stream);
}

}  // namespace

// y = act((x @ w) * scale + bias) on `stream`.  x: int8 [M, K], w: int8
// [K, N], row-major and contiguous; scale: f32 [N]; bias: f32 [N] or null;
// out: [M, N] f32 (out_kind 0), bf16 (1) or the int32 accumulator itself
// (2, scale and bias unused).  act: 0 none, 1 relu, 2 silu, 3 gelu (tanh).
// Returns the CUDA error of the launch (0 on success).
extern "C" int nmc_matmul(const int8_t* x, const int8_t* w,
                          const float* scale, const float* bias, void* out,
                          int M, int N, int K, int act, int out_kind,
                          cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  const bool vec_x = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  const bool vec_w = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  if (M > 16)
    dispatch_out<4>(out_kind, x, w, scale, bias, out, M, N, K, act, vec_x,
                    vec_w, stream);
  else
    dispatch_out<1>(out_kind, x, w, scale, bias, out, M, N, K, act, vec_x,
                    vec_w, stream);
  return static_cast<int>(cudaGetLastError());
}
