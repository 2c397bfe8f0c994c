// NM-Caesar wave executor for Hopper (sm_90a).
//
// Replaces the TPU kernel `_caesar_kernel` / `_caesar_call` in
// src/repro/nmc/pallas_engine.py: one launch runs a wave of T same-bucket
// NM-Caesar programs, each against its own 8192-word (32 KiB) memory image.
//
// What bounds it on this card: not bytes.  Per tile the work is 64 KiB of
// image traffic plus 16 B per instruction, a few microseconds of HBM time
// for a whole wave.  Each instruction reads two words of the image and
// writes one, and the next instruction may read what this one wrote, so a
// tile's stream is one serial dependency chain: its time is n_instr times
// the latency of a shared-memory load -> ALU -> store round trip, and the
// only parallelism is across tiles.
//
// Design: one block per tile.  The block copies the image into shared
// memory (16-byte vector loads), stages the instruction stream through
// shared memory in chunks with all its threads, and one thread executes the
// serial chain at word level with the packed MAC and the 32-bit DOT
// accumulators in registers; lanes are unpacked and packed inside the
// instruction, so the image stays int32 words in and out.  The block writes
// the image back in place.  Cutting the serial chain is later work.
//
// Arithmetic is unsigned 32-bit (signed overflow is undefined in C++; the
// reference wraps), and lanes are sign-extended by shifts.
//
// Addresses are assumed in range [0, 8192) and opcodes valid: the pools
// check every wave's opcodes with repro_torch.nmc.check.assert_wave and its
// addresses on the host before upload (nmc/pool.py, _device_arrays), so
// nothing is clamped here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMemWords = 8192;
constexpr int kChunk = 512;     // instructions staged per round (8 KiB)
constexpr int kThreads = 256;   // copy / staging threads per block

// CaesarOp (src/repro_torch/core/isa.py); checked by the CPU tests.
enum CaesarOpId : int {
  AND = 0, OR = 1, XOR = 2, ADD = 3, SUB = 4, MUL = 5,
  MAC_INIT = 6, MAC = 7, MAC_STORE = 8,
  DOT_INIT = 9, DOT = 10, DOT_STORE = 11,
  SLL = 12, SLR = 13, MIN = 14, MAX = 15, CSRW = 16, SRA = 17, NOP = 18,
};

template <int SEW>
__device__ __forceinline__ int32_t lane(uint32_t w, int k) {
  // sign-extended lane k (little-endian): move it to the top, shift back
  return static_cast<int32_t>(w << (32 - SEW * (k + 1))) >> (32 - SEW);
}

template <int SEW>
__device__ __forceinline__ uint32_t put(uint32_t r, int k) {
  constexpr uint32_t kMask = SEW == 32 ? 0xFFFFFFFFu : ((1u << SEW) - 1u);
  return (r & kMask) << (SEW * k);
}

template <int SEW>
__device__ __forceinline__ uint32_t lane_op(int op, uint32_t a, uint32_t b) {
  constexpr int kLanes = 32 / SEW;
  constexpr uint32_t kMask = SEW == 32 ? 0xFFFFFFFFu : ((1u << SEW) - 1u);
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const int32_t x = lane<SEW>(a, k), y = lane<SEW>(b, k);
    const uint32_t ux = static_cast<uint32_t>(x), uy = static_cast<uint32_t>(y);
    const uint32_t sh = uy & (SEW - 1);        // RVV: amount mod SEW
    uint32_t r;
    switch (op) {
      case ADD: r = ux + uy; break;
      case SUB: r = ux - uy; break;
      case MUL: r = ux * uy; break;
      case SLL: r = ux << sh; break;
      case SLR: r = (ux & kMask) >> sh; break;
      case SRA: r = static_cast<uint32_t>(x >> sh); break;
      case MIN: r = static_cast<uint32_t>(x < y ? x : y); break;
      default:  r = static_cast<uint32_t>(x > y ? x : y); break;   // MAX
    }
    out |= put<SEW>(r, k);
  }
  return out;
}

template <int SEW>
__device__ __forceinline__ uint32_t mac_word(uint32_t acc, uint32_t a,
                                             uint32_t b) {
  constexpr int kLanes = 32 / SEW;
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const uint32_t r = static_cast<uint32_t>(lane<SEW>(acc, k)) +
                       static_cast<uint32_t>(lane<SEW>(a, k)) *
                       static_cast<uint32_t>(lane<SEW>(b, k));
    out |= put<SEW>(r, k);
  }
  return out;
}

template <int SEW>
__device__ __forceinline__ uint32_t dot_word(uint32_t a, uint32_t b) {
  constexpr int kLanes = 32 / SEW;
  uint32_t sum = 0;                            // wraps modulo 2^32
#pragma unroll
  for (int k = 0; k < kLanes; ++k)
    sum += static_cast<uint32_t>(lane<SEW>(a, k)) *
           static_cast<uint32_t>(lane<SEW>(b, k));
  return sum;
}

template <int SEW>
__global__ void __launch_bounds__(kThreads)
caesar_wave_kernel(const int32_t* __restrict__ op,
                   const int32_t* __restrict__ dest,
                   const int32_t* __restrict__ src1,
                   const int32_t* __restrict__ src2,
                   int32_t* __restrict__ mem, int n_instr) {
  __shared__ __align__(16) uint32_t image[kMemWords];
  __shared__ int4 instr[kChunk];               // (op, dest, src1, src2)

  uint4* g = reinterpret_cast<uint4*>(mem) +
             static_cast<size_t>(blockIdx.x) * (kMemWords / 4);
  uint4* s = reinterpret_cast<uint4*>(image);
  for (int i = threadIdx.x; i < kMemWords / 4; i += blockDim.x) s[i] = g[i];

  const size_t base = static_cast<size_t>(blockIdx.x) * n_instr;
  uint32_t mac = 0, dot = 0;                   // live in thread 0 only
  for (int c0 = 0; c0 < n_instr; c0 += kChunk) {
    const int cn = min(kChunk, n_instr - c0);
    __syncthreads();                           // image in / chunk consumed
    for (int i = threadIdx.x; i < cn; i += blockDim.x) {
      const size_t j = base + c0 + i;
      instr[i] = make_int4(op[j], dest[j], src1[j], src2[j]);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < cn; ++i) {
        const int4 in = instr[i];
        const uint32_t a = image[in.z], b = image[in.w];
        switch (in.x) {
          case AND: image[in.y] = a & b; break;
          case OR:  image[in.y] = a | b; break;
          case XOR: image[in.y] = a ^ b; break;
          case ADD: case SUB: case MUL: case SLL: case SLR: case SRA:
          case MIN: case MAX:
            image[in.y] = lane_op<SEW>(in.x, a, b);
            break;
          case MAC_INIT: mac = mac_word<SEW>(0u, a, b); break;
          case MAC: mac = mac_word<SEW>(mac, a, b); break;
          case MAC_STORE:
            mac = mac_word<SEW>(mac, a, b);
            image[in.y] = mac;
            break;
          case DOT_INIT: dot = dot_word<SEW>(a, b); break;
          case DOT: dot += dot_word<SEW>(a, b); break;
          case DOT_STORE:                        // the scalar as one word
            dot += dot_word<SEW>(a, b);
            image[in.y] = dot;
            break;
          default: break;                        // CSRW, NOP: no state change
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kMemWords / 4; i += blockDim.x) g[i] = s[i];
}

}  // namespace

// op/dest/src1/src2: int32 [n_tiles, n_instr]; mem: int32 [n_tiles, 8192],
// updated in place.  Returns cudaGetLastError() after the launch.
extern "C" int caesar_wave(const void* op, const void* dest, const void* src1,
                           const void* src2, void* mem, int n_tiles,
                           int n_instr, int mem_words, int sew,
                           void* stream) {
  if (mem_words != kMemWords) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const auto* o = static_cast<const int32_t*>(op);
  const auto* d = static_cast<const int32_t*>(dest);
  const auto* a = static_cast<const int32_t*>(src1);
  const auto* b = static_cast<const int32_t*>(src2);
  auto* m = static_cast<int32_t*>(mem);
  auto st = static_cast<cudaStream_t>(stream);
  switch (sew) {
    case 8:
      caesar_wave_kernel<8><<<n_tiles, kThreads, 0, st>>>(o, d, a, b, m,
                                                         n_instr);
      break;
    case 16:
      caesar_wave_kernel<16><<<n_tiles, kThreads, 0, st>>>(o, d, a, b, m,
                                                          n_instr);
      break;
    case 32:
      caesar_wave_kernel<32><<<n_tiles, kThreads, 0, st>>>(o, d, a, b, m,
                                                          n_instr);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
