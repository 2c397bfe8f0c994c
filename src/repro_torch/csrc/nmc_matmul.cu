// W8A8 matmul with a fused epilogue for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `nmc_matmul` in
// src/repro/kernels/nmc_matmul.py: y[M,N] = act((x_q[M,K] @ w_q[K,N]) *
// scale[N] + bias[N]), int8 x int8 products accumulated in int32 (the
// NM-Carus vmacc rule: never accumulate at operand width), the dequant +
// bias + activation epilogue applied in registers before the one store.
//
// What bounds it on this card: at prefill (M of a few hundred) operations,
// 2 M N K at the int8 tensor rate (the 384-token LM head is 119.5 GOP,
// 60 us at 1,979 TOP/s, beside 272 MB of weights and output; mma.sync
// runs below that data-sheet rate, which wgmma reaches); at decode (M of 1
// to 16) bytes, the int8 weight matrix read once (the LM head alone is 155
// MB, 46 us at 3.35 TB/s), with next to no arithmetic per byte.
//
// Two kernel bodies, chosen by an explicit route check before the launch
// (`tc_route`; the entry reports the route it took, and the Python
// wrapper, which states the same rule, counts it):
//
// * K a positive multiple of 16, N a multiple of 16, x, w and out 16-byte
//   aligned (every serving shape): the tensor-core kernel
//   `nmc_matmul_tc_kernel`, on mma.sync.m16n8k32 (s8 x s8 -> s32).
//     - Tiles are planned in Python (`kernels/nmc_matmul.plan`) and passed
//       in: BM x BN = 16 x 128 over 4 warps for M <= 16, where a decode
//       call streams the weights and a 16-row tile wastes no loads;
//       128 x 128 over 8 warps otherwise, 64 x 32 per warp (4 x 4 mma
//       tiles, 64 int32 accumulators a thread).  K goes in 64-wide slabs.
//     - x (A, K-contiguous) and w both arrive by 16-byte cp.async in a
//       ring of four slabs, three in flight ahead of the one multiplied;
//       rows past M, k rows past the split's end and columns past N are
//       zero-filled (src-size 0).
//     - w (B) is [K][N], N-contiguous, but the int8 mma takes B only as
//       .col (K-contiguous), and ldmatrix.trans moves 16-bit elements, not
//       bytes.  So the ring holds w's rows as they lie, and once a slab
//       has arrived, four warps transpose it into a [n][k] buffer: each
//       thread reads 16 k rows x 4 n columns (16 four-byte shared loads),
//       transposes the 4 x 4 byte blocks with __byte_perm and stores
//       [n][k] rows 16 bytes at a time.  The ring's 16-byte chunks are
//       XOR-swizzled by k row (`w_swizzle`) so that those loads hit 32
//       distinct banks.  (Staging w through registers instead, one slab
//       ahead, measured slower on the card at every shape: PERF.md.)
//     - [m][k] and [n][k] rows are BK + 16 bytes apart (an odd number of
//       16-byte chunks): the 8 rows of every ldmatrix phase and the 8
//       lanes of every 16-byte store phase hit 8 distinct bank quads.
//     - Split-K (shapes whose output tiles cannot fill the card):
//       blockIdx.z takes K range [z kps, (z + 1) kps) and stores its int32
//       partial sums in a workspace [splits][M][N]; a second launch,
//       `nmc_matmul_reduce_kernel`, adds them in split order, four
//       outputs a thread across the whole card, and runs the epilogue.
//       Integer addition is exact (int32 wraps the same way in any order),
//       so the sum is the one-pass sum bit for bit; the epilogue never
//       sees a partial sum.  (A reduction by the last block of each tile
//       left too few loads in flight, and atomic adds into one int32 sum
//       queued on the same addresses: both measured slower.)
// * every other shape (K or N not a multiple of 16, unaligned pointers):
//   the CUDA-core kernel `nmc_matmul_dp4a_kernel`, any M, N and K.  One
//   block of 256 threads (16 x 16) per BM x 64 output tile, BM = 64 when
//   M > 16 and 16 otherwise; K walked in 64-wide slabs staged through
//   shared memory, packed four k values to a 32-bit word (w columns
//   transposed 4 x 4 bytes at a time with __byte_perm); one __dp4a per
//   accumulator per packed word.  Slabs are zero-filled past the edges
//   and the stores bounds-checked.
//
// Fragment maps of mma.m16n8k32 .s8 (PTX ISA), with g = lane / 4 and
// t = lane % 4; a 32-bit register holds 4 int8, the lowest k in the lowest
// byte:
//   A (16 x 32, row): a0 = row g, k 4t..4t+3; a1 = row g + 8, k 4t..;
//     a2 = row g, k 16 + 4t..; a3 = row g + 8, k 16 + 4t...
//   B (32 x 8, col): b0 = n g, k 4t..4t+3; b1 = n g, k 16 + 4t...
//   C (16 x 8, s32): c0, c1 = row g, n 2t, 2t + 1; c2, c3 = row g + 8,
//     n 2t, 2t + 1.
// An 8 x 8 b16 matrix of ldmatrix is 8 rows x 16 int8; lane l receives row
// l / 4, bytes 4 (l % 4)..+3 of it: exactly a0's layout for a matrix of
// rows 0-7 and k 0-15.  So ldmatrix.x4 over (rows 0-7, k 0-15), (rows
// 8-15, k 0-15), (rows 0-7, k 16-31), (rows 8-15, k 16-31) of A's [m][k]
// slab gives a0..a3, and over (n 0-7, k 0-15), (n 0-7, k 16-31), (n 8-15,
// k 0-15), (n 8-15, k 16-31) of B's [n][k] slab gives b0, b1 of two
// n-tiles.  Lanes 8i..8i+7 address the rows of matrix i.
//
// The epilogue rounds like the reference, a product and then a sum
// (__fmul_rn, __fadd_rn): nvcc -O3 would otherwise contract them into one
// FMA.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Act : int { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };
enum Out : int { OUT_F32 = 0, OUT_BF16 = 1, OUT_I32 = 2 };
// The route rule.  The entry reports the route it took.
enum Route : int { ROUTE_DP4A = 0, ROUTE_TENSOR_CORE = 1 };

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

__device__ __forceinline__ float dequant(int acc, int n,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias,
                                         int act) {
  float y = __fmul_rn(__int2float_rn(acc), scale[n]);
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  return activate(y, act);
}

// out[o], out[o + 1] = the epilogue of accumulators a0, a1 of columns n,
// n + 1 (o even: one 8-, 8- or 4-byte store).
template <int OUT>
__device__ __forceinline__ void store2(void* out, size_t o, int a0, int a1,
                                       int n, const float* scale,
                                       const float* bias, int act) {
  if constexpr (OUT == OUT_I32) {
    *reinterpret_cast<int2*>(static_cast<int32_t*>(out) + o) =
        make_int2(a0, a1);
  } else {
    const float y0 = dequant(a0, n, scale, bias, act);
    const float y1 = dequant(a1, n + 1, scale, bias, act);
    if constexpr (OUT == OUT_F32)
      *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
          make_float2(y0, y1);
    else
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                         o) = __floats2bfloat162_rn(y0, y1);
  }
}

// The 4 x 4 byte transpose: r0..r3 are four k rows of 4 n columns each;
// c[j] is column j's four k values (r0's byte in the lowest byte).
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// ---------------------------------------------------------------------------
// The CUDA-core (dp4a) kernel: any M, N and K
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;     // 16 x 16
constexpr int kBN = 64;           // output columns per block
constexpr int kBK = 64;           // k values per slab
constexpr int kK4 = kBK / 4;      // packed words per slab row

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
nmc_matmul_dp4a_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, void* __restrict__ out,
                       int M, int N, int K, int act, bool vec_x,
                       bool vec_w) {
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
      uint32_t c[4];
      transpose4(rows[0], rows[1], rows[2], rows[3], c);
#pragma unroll
      for (int j = 0; j < 4; ++j) ws[k4][4 * g + j] = c[j];
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
      const float y = dequant(acc[i][j], n, scale, bias, act);
      if (OUT == OUT_F32)
        static_cast<float*>(out)[o] = y;
      else
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
    }
  }
}

template <int TM, int OUT>
int launch_dp4a(const int8_t* x, const int8_t* w, const float* scale,
                const float* bias, void* out, int M, int N, int K, int act,
                cudaStream_t stream) {
  const bool vec_x = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  const bool vec_w = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + 16 * TM - 1) / (16 * TM));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  nmc_matmul_dp4a_kernel<TM, OUT><<<grid, kThreads, 0, stream>>>(
      x, w, scale, bias, out, M, N, K, act, vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

template <int TM>
int dispatch_dp4a(int out_kind, const int8_t* x, const int8_t* w,
                  const float* scale, const float* bias, void* out, int M,
                  int N, int K, int act, cudaStream_t stream) {
  if (out_kind == OUT_F32)
    return launch_dp4a<TM, OUT_F32>(x, w, scale, bias, out, M, N, K, act,
                                    stream);
  if (out_kind == OUT_BF16)
    return launch_dp4a<TM, OUT_BF16>(x, w, scale, bias, out, M, N, K, act,
                                     stream);
  return launch_dp4a<TM, OUT_I32>(x, w, scale, bias, out, M, N, K, act,
                                  stream);
}

// ---------------------------------------------------------------------------
// The int8 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kPad = 16;       // bytes of padding per [m][k] / [n][k] row
constexpr int kStages = 4;     // slabs in the cp.async ring

template <int BM_, int BN_, int BK_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kLd = BK + kPad;       // [m][k], [n][k] row stride
  static constexpr int kWarpM = BM / WM, kWarpN = BN / WN;
  static constexpr int kMT = kWarpM / 16;     // mma m-tiles per warp
  static constexpr int kNT = kWarpN / 8;      // mma n-tiles per warp
  static constexpr int kKW = BK / 16;         // 16-k groups per slab
  static constexpr int kPieces = kKW * (BN / 4);   // 16 k x 4 n pieces
  // 16-byte chunks per slab, and per thread: x [BM][BK], w [BK][BN]
  static constexpr int kChunksA = BM * kKW;
  static constexpr int kItersA = (kChunksA + kThreads - 1) / kThreads;
  static constexpr int kChunksW = BK * BN / 16;
  static constexpr int kItersW = kChunksW / kThreads;
  static constexpr int kSmemA = kStages * BM * kLd;
  static constexpr int kSmemW = kStages * BK * BN;
  static constexpr int kSmem = kSmemA + kSmemW + BN * kLd;
  static_assert(BN == 128, "the w swizzle spans 8 chunks per row");
  static_assert(kPieces <= kThreads && kPieces % 32 == 0, "whole warps");
  static_assert(kChunksW % kThreads == 0, "whole w copies per thread");
  static_assert(kWarpM % 16 == 0 && kNT % 2 == 0, "whole mma tiles");
  static_assert((kLd / 16) % 2 == 1, "an odd number of 16-byte chunks");
};

// The compiled tiles (kernels/nmc_matmul.py's TILE_THIN / TILE_WIDE).
using TileThin = Tile<16, 128, 64, 1, 4>;     // M <= 16: decode
using TileWide = Tile<128, 128, 64, 2, 4>;    // M > 16: prefill

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until the group is waited for; a
// chunk that is not `valid` is zero-filled (src-size 0 reads nothing).
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// c[16 x 8] += a[16 x 32] b[32 x 8], s8 in, s32 accumulate (maps above).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16-byte chunk of w slab row r (k) holding columns 16 c .. 16 c + 15
// sits at chunk c ^ w_swizzle<KW>(r) of its [BK][128] shared row: the
// rows 16 kw + i that one transposing load instruction reads (kw = 0 ..
// KW - 1 across the warp) then fall in 8 distinct 16-byte bank groups.
template <int KW>
__device__ __forceinline__ int w_swizzle(int r) {
  return ((r >> 4) * (8 / KW)) & 7;
}

// One block per (BM-row tile blockIdx.x, BN-column tile blockIdx.y, K split
// blockIdx.z).  With one split it runs the epilogue itself; otherwise it
// stores its partial sums in the int32 workspace `ws` [splits][M][N], and
// nmc_matmul_reduce_kernel, launched next, adds them and runs it.
template <class T, int OUT>
__global__ void __launch_bounds__(T::kThreads, T::BM == 16 ? 4 : 2)
nmc_matmul_tc_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, void* __restrict__ out,
                     int32_t* __restrict__ ws, int M, int N, int K, int act,
                     int splits, int k_per_split) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, kLd = T::kLd;
  constexpr int S = kStages, KW = T::kKW;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* as = smem;                  // [S][BM][kLd]    x, [m][k]
  unsigned char* wraw = smem + T::kSmemA;    // [S][BK][BN]     w as it lies
  unsigned char* bs = wraw + T::kSmemW;      // [BN][kLd]       w, [n][k]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_slabs = (k_end - k_begin + BK - 1) / BK;

  // Slab s of x and of w into ring stage s % S, one commit group per call
  // (empty past the last slab, so group counting stays uniform).  Rows
  // past M, k rows at or past k_end and columns past N are zero-filled.
  auto load_slab = [&](int s) {
    if (s < n_slabs) {
      const int st = s % S, kb = k_begin + s * BK;
      unsigned char* da = as + st * BM * kLd;
#pragma unroll
      for (int i = 0; i < T::kItersA; ++i) {
        const int c = tid + i * T::kThreads;
        if (c < T::kChunksA) {
          const int r = c / KW, kc = c % KW;
          const int gm = m0 + r, gk = kb + 16 * kc;
          const bool valid = gm < M && gk < k_end;
          cp_async16(smem_u32(da + r * kLd + 16 * kc),
                     valid ? x + static_cast<size_t>(gm) * K + gk : x,
                     valid);
        }
      }
      unsigned char* dw = wraw + st * BK * BN;
#pragma unroll
      for (int i = 0; i < T::kItersW; ++i) {
        const int c = tid + i * T::kThreads;
        const int r = c / 8, cc = c % 8;
        const int gk = kb + r, gn = n0 + 16 * cc;
        const bool valid = gk < k_end && gn < N;
        cp_async16(smem_u32(dw + r * BN + 16 * (cc ^ w_swizzle<KW>(r))),
                   valid ? w + static_cast<size_t>(gk) * N + gn : w, valid);
      }
    }
    cp_async_commit();
  };

  // Stage st's w slab into [n][k]: the thread owning piece (kw, nq) reads
  // k rows 16 kw .. 16 kw + 15 of columns 4 nq .. 4 nq + 3 (one 4-byte
  // read per row), transposes the 4 x 4 byte blocks and stores row
  // 4 nq + j, bytes 16 kw .. 16 kw + 15, 16 bytes at a time.
  auto transpose_w = [&](int st) {
    if (tid >= T::kPieces) return;
    const int kw = tid % KW, nq = tid / KW;
    const unsigned char* src = wraw + st * BK * BN + 16 * kw * BN +
                               16 * ((nq >> 2) ^ w_swizzle<KW>(16 * kw)) +
                               4 * (nq & 3);
    uint32_t r[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      r[i] = *reinterpret_cast<const uint32_t*>(src + i * BN);
    uint32_t col[4][4];                                // [k-quad][column]
#pragma unroll
    for (int q = 0; q < 4; ++q)
      transpose4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3], col[q]);
    unsigned char* dst = bs + 4 * nq * kLd + 16 * kw;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint4*>(dst + j * kLd) =
          make_uint4(col[0][j], col[1][j], col[2][j], col[3][j]);
  };

  int acc[T::kMT][T::kNT][4];
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  // The warp's mma's over the slab in stage st (x) and in bs (w), 32 k at
  // a time.
  auto compute = [&](int st) {
    const unsigned char* at = as + st * BM * kLd;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t af[T::kMT][4], bf[T::kNT][2];
#pragma unroll
      for (int mt = 0; mt < T::kMT; ++mt) {
        const int r = wm * T::kWarpM + mt * 16 + (lane & 7) +
                      ((lane >> 3) & 1) * 8;
        ldsm_x4(af[mt], smem_u32(at + r * kLd + kk * 32 + (lane >> 4) * 16));
      }
#pragma unroll
      for (int np = 0; np < T::kNT / 2; ++np) {
        const int r = wn * T::kWarpN + np * 16 + (lane >> 4) * 8 + (lane & 7);
        uint32_t f[4];
        ldsm_x4(f, smem_u32(bs + r * kLd + kk * 32 + ((lane >> 3) & 1) * 16));
        bf[2 * np][0] = f[0];
        bf[2 * np][1] = f[1];
        bf[2 * np + 1][0] = f[2];
        bf[2 * np + 1][1] = f[3];
      }
#pragma unroll
      for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::kNT; ++nt)
          mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  };

  // S - 1 slabs in flight ahead of the one multiplied.
#pragma unroll
  for (int i = 0; i < S - 1; ++i) load_slab(i);
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<S - 2>();       // slab s arrived (this thread's copies)
    __syncthreads();              // ... every thread's; slab s - 1's stage
                                  // and bs are free
    load_slab(s + S - 1);
    transpose_w(s % S);
    __syncthreads();              // bs holds slab s's w
    compute(s % S);
  }
  cp_async_wait<0>();

  const int row0 = m0 + wm * T::kWarpM + g;
  const int col0 = n0 + wn * T::kWarpN + 2 * t4;
  if (splits == 1) {
#pragma unroll
    for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + mt * 16 + 8 * h;
        if (row >= M) continue;
#pragma unroll
        for (int nt = 0; nt < T::kNT; ++nt) {
          const int col = col0 + nt * 8;
          if (col < N)
            store2<OUT>(out, static_cast<size_t>(row) * N + col,
                        acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1], col,
                        scale, bias, act);
        }
      }
    return;
  }

  // Split-K: store this split's partial sums; the reduce kernel adds them.
  int32_t* part = ws + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + mt * 16 + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt) {
        const int col = col0 + nt * 8;
        if (col < N)
          *reinterpret_cast<int2*>(part + static_cast<size_t>(row) * N +
                                   col) =
              make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

// Split-K, the second launch: out = the epilogue of the sum of the splits'
// partial sums [splits][M][N], added in split order, four columns a
// thread (N is a multiple of 16).
template <int OUT>
__global__ void __launch_bounds__(256)
nmc_matmul_reduce_kernel(const int32_t* __restrict__ part,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias,
                         void* __restrict__ out, int M, int N, int act,
                         int splits) {
  const size_t plane = static_cast<size_t>(M) * N;
  const size_t o = 4 * (static_cast<size_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x);
  if (o >= plane) return;
  uint32_t sum[4] = {0u, 0u, 0u, 0u};       // wraps like int32, exactly
#pragma unroll 8
  for (int z = 0; z < splits; ++z) {
    const int4 v = *reinterpret_cast<const int4*>(part + z * plane + o);
    sum[0] += v.x;
    sum[1] += v.y;
    sum[2] += v.z;
    sum[3] += v.w;
  }
  const int col = static_cast<int>(o % N);
  store2<OUT>(out, o, static_cast<int>(sum[0]), static_cast<int>(sum[1]),
              col, scale, bias, act);
  store2<OUT>(out, o + 2, static_cast<int>(sum[2]), static_cast<int>(sum[3]),
              col + 2, scale, bias, act);
}

template <class T, int OUT>
int launch_tc(const int8_t* x, const int8_t* w, const float* scale,
              const float* bias, void* out, int32_t* ws, int M, int N, int K,
              int act, int splits, int k_per_split, cudaStream_t stream) {
  auto kernel = nmc_matmul_tc_kernel<T, OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + T::BM - 1) / T::BM, (N + T::BN - 1) / T::BN, splits);
  if (grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      x, w, scale, bias, out, ws, M, N, K, act, splits, k_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long groups = static_cast<long long>(M) * N / 4;
  nmc_matmul_reduce_kernel<OUT>
      <<<static_cast<unsigned>((groups + 255) / 256), 256, 0, stream>>>(
          ws, scale, bias, out, M, N, act, splits);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int dispatch_tc(int out_kind, const int8_t* x, const int8_t* w,
                const float* scale, const float* bias, void* out,
                int32_t* ws, int M, int N, int K, int act, int splits,
                int k_per_split, cudaStream_t stream) {
  // the plan must cover K exactly once, in whole slabs per split
  if (splits < 1 || k_per_split < T::BK || k_per_split % T::BK != 0 ||
      static_cast<long long>(splits - 1) * k_per_split >= K ||
      static_cast<long long>(splits) * k_per_split < K ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_kind == OUT_F32)
    return launch_tc<T, OUT_F32>(x, w, scale, bias, out, ws, M, N, K, act,
                                 splits, k_per_split, stream);
  if (out_kind == OUT_BF16)
    return launch_tc<T, OUT_BF16>(x, w, scale, bias, out, ws, M, N, K, act,
                                  splits, k_per_split, stream);
  return launch_tc<T, OUT_I32>(x, w, scale, bias, out, ws, M, N, K, act,
                               splits, k_per_split, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int tc_route(const void* x, const void* w, const void* out, int N, int K) {
  return K > 0 && K % 16 == 0 && N % 16 == 0 && aligned16(x) &&
                 aligned16(w) && aligned16(out)
             ? ROUTE_TENSOR_CORE
             : ROUTE_DP4A;
}

}  // namespace

// y = act((x @ w) * scale + bias) on `stream`.  x: int8 [M, K], w: int8
// [K, N], row-major and contiguous; scale: f32 [N]; bias: f32 [N] or null;
// out: [M, N] f32 (out_kind 0), bf16 (1) or the int32 accumulator itself
// (2, scale and bias unused).  act: 0 none, 1 relu, 2 silu, 3 gelu (tanh).
// The kernel body is `tc_route(...)`, written to `*route` (enum Route)
// before anything else.  On the tensor-core route, the plan (bm x bn
// tiles, K in `splits` ranges of `k_per_split`) comes from
// kernels/nmc_matmul.plan, and `ws` is null for one split, else an int32
// workspace of splits * M * N elements (the partial sums, written before
// they are read: no zeroing); the dp4a route ignores the plan and `ws`.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int nmc_matmul(const int8_t* x, const int8_t* w,
                          const float* scale, const float* bias, void* out,
                          int32_t* ws, int M, int N, int K, int act,
                          int out_kind, int bm, int bn, int splits,
                          int k_per_split, int* route, cudaStream_t stream) {
  *route = tc_route(x, w, out, N, K);
  if (M <= 0 || N <= 0) return 0;
  if (*route == ROUTE_TENSOR_CORE) {
    if (bm == TileThin::BM && bn == TileThin::BN)
      return dispatch_tc<TileThin>(out_kind, x, w, scale, bias, out, ws, M,
                                   N, K, act, splits, k_per_split, stream);
    if (bm == TileWide::BM && bn == TileWide::BN)
      return dispatch_tc<TileWide>(out_kind, x, w, scale, bias, out, ws, M,
                                   N, K, act, splits, k_per_split, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M > 16)
    return dispatch_dp4a<4>(out_kind, x, w, scale, bias, out, M, N, K, act,
                            stream);
  return dispatch_dp4a<1>(out_kind, x, w, scale, bias, out, M, N, K, act,
                          stream);
}
