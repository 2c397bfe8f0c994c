// NM-Carus VPU as a program-as-data kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `vrf_alu` in
// src/repro/kernels/vrf_alu.py: one launch runs a program of element-wise
// vector instructions (op, vd, vs1, vs2, scalar, mode) over an (n_regs, VL)
// int8/int16/int32 register file, updated in place.  The program is
// runtime data: the same compiled kernel runs any program over any register
// operands.
//
// What bounds it on this card: bytes.  Each instruction is one integer op
// per element, so even a long program does a few operations per byte of
// register traffic; the least time is the registers the program reads
// before writing them, loaded once, plus the registers it writes, stored
// once, over the memory rate.  N instructions cost one memory round trip,
// not N.  At small files the launch itself is the floor.
//
// Design:
// * The program travels in the launch's parameters (`Prog`, by value,
//   __grid_constant__): no program buffer in device memory, no copy before
//   the launch, and a thread's first memory instructions are its register
//   loads.  The host compiles the checked rows: the registers read before
//   written are loaded (load i fills slot i); every value gets a slot from
//   its definition to its last read, and a slot is reused once its value
//   is dead, so a block keeps only the values live at once; a register's
//   final value is stored from the thread's registers right after the
//   instruction that writes it, so the stores overlap the rest of the
//   program.  Each instruction is one packed word (its dispatch key, the
//   vx and store flags, three slots; the key of a vx shift differs from its
//   op's, so the dispatch is one dense switch) plus its vx scalar, already
//   truncated to the element width and copied into every lane of a 32-bit
//   word.  A program longer than one `Prog` holds runs as consecutive
//   launches over the in-place file.
// * Every element lane is independent (the paper's Fig. 6 bank alignment),
//   so a thread owns 16 contiguous bytes of every register (16 / 8 / 4
//   elements at int8 / int16 / int32), moves each with one 128-bit load
//   and store, and needs no barrier anywhere.  Slot indices are dynamic and
//   registers cannot be indexed at run time, so a thread keeps its vector
//   of each slot in shared memory (slab[slot][thread], one uint4):  an
//   instruction is two 16-byte shared reads, one uniform dispatch and one
//   16-byte write, its code word read one instruction ahead.  Up to kBatch
//   loads are in flight before the first of them is written to the slab.
// * Lanes are packed SIMD: add / sub / signed min / max are __vadd4 ...
//   __vmaxs4 at int8 and the ...2 forms at int16; and / or / xor / mv act
//   on whole words; mul and vv shifts take each lane to 32 bits by
//   shifting and pack the low bytes back with __byte_perm; vx shifts, one
//   amount in every lane, shift the word and mask what crossed a lane.
//   Shift amounts are taken mod the element width, as the reference does.
//   tests/test_torch_vrf_swar.py emulates these formulas in numpy.
// * Rows whose start is not 16-byte aligned (VL x element size not a
//   multiple of 16, or a file that is a view at an offset) run the ragged
//   instance, which keeps the same element-to-thread mapping and moves a
//   vector in the widest pieces the row's alignment allows, and masks the
//   ragged end of each row element by element.
// * The block is the one (of 256 threads down to 32) that keeps the most
//   threads resident on an SM at the program's slab size, and the grid is
//   the blocks that fit the card at once, each striding over the vectors;
//   both are cached per device, kernel and slot count, so a launch makes no
//   CUDA query after the first.
//
// Register indices are checked on the host (the wrapper raises ValueError
// outside [0, n_regs)); the kernel addresses only the rows it was given.

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int kVecBytes = 16;     // bytes of every register a thread owns
constexpr int kMaxInstr = 256;    // instructions one launch holds
constexpr int kMaxSlots = 128;    // registers one launch touches
constexpr int kMaxSlabBytes = 200 * 1024;
constexpr int kMaxBlock = 256;
constexpr int kBatch = 8;         // loads in flight before their first use
constexpr int kModeVV = 0;
// a code word: the dispatch key (bits 0-3: the op, or a vx shift's key),
// the vx flag (bit 4), the store flag (bit 5: vd's final value, stored
// after this instruction), the slots of vd, vs1 and vs2 (7 bits each)
constexpr int kOpBits = 4;
constexpr int kModeShift = 4;
constexpr int kStoreShift = 5;
constexpr int kVdShift = 6;
constexpr int kVs1Shift = 13;
constexpr int kVs2Shift = 20;
constexpr int kSlotBits = 7;
constexpr uint32_t kSlotMask = (1u << kSlotBits) - 1u;
constexpr uint32_t kKeyMask = (1u << kOpBits) - 1u;
constexpr uint32_t kVx = 1u << kModeShift;  // set for every mode but kModeVV
constexpr uint32_t kStore = 1u << kStoreShift;
static_assert(kVs2Shift + kSlotBits <= 32, "a code word is 32 bits");
static_assert(kMaxSlots <= (1 << kSlotBits), "a slot fits its field");
static_assert(kModeVV == 0 && kOpBits == kModeShift, "key, then vx flag");

// VRF_OPS in src/repro_torch/kernels/ref.py; checked by the CPU tests.
enum Op : int {
  ADD = 0, SUB = 1, MUL = 2, MIN = 3, MAX = 4, AND = 5, OR = 6, XOR = 7,
  SLL = 8, SRL = 9, SRA = 10, MV = 11,
};
// the dispatch keys of vx shifts (one amount in every lane); every other
// instruction's key is its op (VX_SHIFT_KEY in kernels/vrf_alu.py)
enum VxShift : int { SLL_VX = 12, SRL_VX = 13, SRA_VX = 14 };

// One launch's program (PROG_DTYPE in kernels/vrf_alu.py).
struct Prog {
  int32_t n_instr, n_load, n_store, n_slots;
  int32_t load_reg[kMaxSlots];    // load i fills slot i
  int32_t store_reg[kMaxSlots];   // the register of the i-th store flag
  // per instruction: its code word, and its vx scalar truncated and copied
  // into every lane of the word; one entry more, read ahead after the last
  uint2 ins[kMaxInstr + 1];
};
static_assert(sizeof(Prog) == 16 + 8 * kMaxSlots + 8 * (kMaxInstr + 1),
              "Prog is packed as PROG_DTYPE");
static_assert(sizeof(Prog) <= 4096, "Prog fits the classic 4 KB of "
              "kernel parameters");

// ---- one 32-bit word of BITS-wide lanes --------------------------------

template <int BITS>
__device__ __forceinline__ constexpr uint32_t lane_ones() {
  return BITS == 8 ? 0x01010101u : BITS == 16 ? 0x00010001u : 1u;
}

template <int BITS>
__device__ __forceinline__ constexpr uint32_t lane_mask() {
  return BITS == 32 ? 0xffffffffu : (1u << BITS) - 1u;
}

// the low lane of each p_k, packed: lane k of the result is p_k's
__device__ __forceinline__ uint32_t pack4(uint32_t p0, uint32_t p1,
                                          uint32_t p2, uint32_t p3) {
  return __byte_perm(__byte_perm(p0, p1, 0x0040), __byte_perm(p2, p3, 0x0040),
                     0x5410);
}

__device__ __forceinline__ uint32_t pack2(uint32_t p0, uint32_t p1) {
  return __byte_perm(p0, p1, 0x5410);
}

template <int BITS>
__device__ __forceinline__ uint32_t w_add(uint32_t a, uint32_t b) {
  if constexpr (BITS == 8) return __vadd4(a, b);
  else if constexpr (BITS == 16) return __vadd2(a, b);
  else return a + b;
}

template <int BITS>
__device__ __forceinline__ uint32_t w_sub(uint32_t a, uint32_t b) {
  if constexpr (BITS == 8) return __vsub4(a, b);
  else if constexpr (BITS == 16) return __vsub2(a, b);
  else return a - b;
}

template <int BITS>
__device__ __forceinline__ uint32_t w_min(uint32_t a, uint32_t b) {
  if constexpr (BITS == 8) return __vmins4(a, b);
  else if constexpr (BITS == 16) return __vmins2(a, b);
  else return static_cast<int>(a) < static_cast<int>(b) ? a : b;
}

template <int BITS>
__device__ __forceinline__ uint32_t w_max(uint32_t a, uint32_t b) {
  if constexpr (BITS == 8) return __vmaxs4(a, b);
  else if constexpr (BITS == 16) return __vmaxs2(a, b);
  else return static_cast<int>(a) > static_cast<int>(b) ? a : b;
}

// the low byte (half) of a product depends only on the operands' low byte
// (half): each lane is shifted down and multiplied in 32 bits
template <int BITS>
__device__ __forceinline__ uint32_t w_mul(uint32_t a, uint32_t b) {
  if constexpr (BITS == 8) {
    return pack4(a * b, (a >> 8) * (b >> 8), (a >> 16) * (b >> 16),
                 (a >> 24) * (b >> 24));
  } else if constexpr (BITS == 16) {
    return pack2(a * b, (a >> 16) * (b >> 16));
  } else {
    return a * b;
  }
}

// vx shifts: one amount sh in [0, BITS) for every lane; what the word shift
// carries across a lane edge is masked off
template <int BITS>
__device__ __forceinline__ uint32_t w_sll_vx(uint32_t a, uint32_t sh) {
  if constexpr (BITS == 32) return a << sh;
  else return (a << sh) & (lane_ones<BITS>() *
                           ((lane_mask<BITS>() << sh) & lane_mask<BITS>()));
}

template <int BITS>
__device__ __forceinline__ uint32_t w_srl_vx(uint32_t a, uint32_t sh) {
  if constexpr (BITS == 32) return a >> sh;
  else return (a >> sh) & (lane_ones<BITS>() * (lane_mask<BITS>() >> sh));
}

// arithmetic: a negative lane is complemented, shifted logically and
// complemented back (n is all ones in the negative lanes)
template <int BITS>
__device__ __forceinline__ uint32_t w_sra_vx(uint32_t a, uint32_t sh) {
  if constexpr (BITS == 32) {
    return static_cast<uint32_t>(static_cast<int>(a) >> sh);
  } else {
    const uint32_t n = ((a >> (BITS - 1)) & lane_ones<BITS>()) *
                       lane_mask<BITS>();
    return w_srl_vx<BITS>(a ^ n, sh) ^ n;
  }
}

// vv shifts: lane k of a shifted by lane k of b (mod BITS), in 32 bits
template <int BITS>
__device__ __forceinline__ uint32_t w_sll_vv(uint32_t a, uint32_t b) {
  if constexpr (BITS == 8) {
    return pack4(a << (b & 7), (a >> 8) << ((b >> 8) & 7),
                 (a >> 16) << ((b >> 16) & 7), (a >> 24) << ((b >> 24) & 7));
  } else if constexpr (BITS == 16) {
    return pack2(a << (b & 15), (a >> 16) << ((b >> 16) & 15));
  } else {
    return a << (b & 31);
  }
}

template <int BITS>
__device__ __forceinline__ uint32_t w_srl_vv(uint32_t a, uint32_t b) {
  if constexpr (BITS == 8) {
    return pack4((a & 0xffu) >> (b & 7), ((a >> 8) & 0xffu) >> ((b >> 8) & 7),
                 ((a >> 16) & 0xffu) >> ((b >> 16) & 7),
                 (a >> 24) >> ((b >> 24) & 7));
  } else if constexpr (BITS == 16) {
    return pack2((a & 0xffffu) >> (b & 15), (a >> 16) >> ((b >> 16) & 15));
  } else {
    return a >> (b & 31);
  }
}

// lane k sign-extended to 32 bits (shifted to the top, then back down)
template <int BITS, int K>
__device__ __forceinline__ int lane_s(uint32_t a) {
  return static_cast<int>(a << (32 - BITS * (K + 1))) >> (32 - BITS);
}

template <int BITS>
__device__ __forceinline__ uint32_t w_sra_vv(uint32_t a, uint32_t b) {
  if constexpr (BITS == 8) {
    return pack4(lane_s<8, 0>(a) >> (b & 7), lane_s<8, 1>(a) >> ((b >> 8) & 7),
                 lane_s<8, 2>(a) >> ((b >> 16) & 7),
                 lane_s<8, 3>(a) >> ((b >> 24) & 7));
  } else if constexpr (BITS == 16) {
    return pack2(lane_s<16, 0>(a) >> (b & 15),
                 lane_s<16, 1>(a) >> ((b >> 16) & 15));
  } else {
    return static_cast<uint32_t>(static_cast<int>(a) >> (b & 31));
  }
}

// ---- one instruction on a thread's 16 bytes ----------------------------

// KEY: the dispatch key (a vx shift's amount is b's low lane)
template <int KEY, int BITS>
__device__ __forceinline__ uint32_t word_op(uint32_t a, uint32_t b) {
  constexpr uint32_t sh_mask = BITS - 1;
  if constexpr (KEY == ADD) return w_add<BITS>(a, b);
  else if constexpr (KEY == SUB) return w_sub<BITS>(a, b);
  else if constexpr (KEY == MUL) return w_mul<BITS>(a, b);
  else if constexpr (KEY == MIN) return w_min<BITS>(a, b);
  else if constexpr (KEY == MAX) return w_max<BITS>(a, b);
  else if constexpr (KEY == AND) return a & b;
  else if constexpr (KEY == OR) return a | b;
  else if constexpr (KEY == XOR) return a ^ b;
  else if constexpr (KEY == SLL) return w_sll_vv<BITS>(a, b);
  else if constexpr (KEY == SRL) return w_srl_vv<BITS>(a, b);
  else if constexpr (KEY == SRA) return w_sra_vv<BITS>(a, b);
  else if constexpr (KEY == SLL_VX) return w_sll_vx<BITS>(a, b & sh_mask);
  else if constexpr (KEY == SRL_VX) return w_srl_vx<BITS>(a, b & sh_mask);
  else if constexpr (KEY == SRA_VX) return w_sra_vx<BITS>(a, b & sh_mask);
  else return b;                  // MV
}

template <int KEY, int BITS>
__device__ __forceinline__ uint4 vec_op(uint4 a, uint4 b) {
  return make_uint4(word_op<KEY, BITS>(a.x, b.x), word_op<KEY, BITS>(a.y, b.y),
                    word_op<KEY, BITS>(a.z, b.z), word_op<KEY, BITS>(a.w, b.w));
}

// key: dense in [0, 15) and uniform over the grid
template <int BITS>
__device__ __forceinline__ uint4 dispatch(uint32_t key, uint4 a, uint4 b) {
  switch (key) {
    case ADD: return vec_op<ADD, BITS>(a, b);
    case SUB: return vec_op<SUB, BITS>(a, b);
    case MUL: return vec_op<MUL, BITS>(a, b);
    case MIN: return vec_op<MIN, BITS>(a, b);
    case MAX: return vec_op<MAX, BITS>(a, b);
    case AND: return vec_op<AND, BITS>(a, b);
    case OR: return vec_op<OR, BITS>(a, b);
    case XOR: return vec_op<XOR, BITS>(a, b);
    case SLL: return vec_op<SLL, BITS>(a, b);
    case SRL: return vec_op<SRL, BITS>(a, b);
    case SRA: return vec_op<SRA, BITS>(a, b);
    case SLL_VX: return vec_op<SLL_VX, BITS>(a, b);
    case SRL_VX: return vec_op<SRL_VX, BITS>(a, b);
    case SRA_VX: return vec_op<SRA_VX, BITS>(a, b);
    default: return b;            // MV
  }
}

// ---- moving a thread's 16 bytes of one row -----------------------------

// p: the vector's first byte; n: its bytes inside the row (the row's last
// vector may be short).  Aligned rows take one 128-bit access; the ragged
// instance takes the widest pieces p's alignment allows, and whole
// elements at a row's ragged end.
template <int ELEM, bool kAligned>
__device__ __forceinline__ uint4 load_vec(const char* p, int n) {
  if constexpr (kAligned) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
    if (n == kVecBytes && (addr & 15) == 0)
      return __ldg(reinterpret_cast<const uint4*>(p));
    if (n == kVecBytes && (addr & 3) == 0) {
      const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
      return make_uint4(q[0], q[1], q[2], q[3]);
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    for (int k = 0; k < n; k += ELEM) {
      uint32_t x;
      if constexpr (ELEM == 1) x = *reinterpret_cast<const uint8_t*>(p + k);
      else if constexpr (ELEM == 2)
        x = *reinterpret_cast<const uint16_t*>(p + k);
      else x = *reinterpret_cast<const uint32_t*>(p + k);
      w[k >> 2] |= x << (8 * (k & 3));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int ELEM, bool kAligned>
__device__ __forceinline__ void store_vec(char* p, uint4 v, int n) {
  if constexpr (kAligned) {
    *reinterpret_cast<uint4*>(p) = v;
  } else {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
    if (n == kVecBytes && (addr & 15) == 0) {
      *reinterpret_cast<uint4*>(p) = v;
      return;
    }
    if (n == kVecBytes && (addr & 3) == 0) {
      uint32_t* q = reinterpret_cast<uint32_t*>(p);
      q[0] = v.x; q[1] = v.y; q[2] = v.z; q[3] = v.w;
      return;
    }
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    for (int k = 0; k < n; k += ELEM) {
      const uint32_t x = w[k >> 2] >> (8 * (k & 3));
      if constexpr (ELEM == 1) *reinterpret_cast<uint8_t*>(p + k) =
          static_cast<uint8_t>(x);
      else if constexpr (ELEM == 2) *reinterpret_cast<uint16_t*>(p + k) =
          static_cast<uint16_t>(x);
      else *reinterpret_cast<uint32_t*>(p + k) = x;
    }
  }
}

// ---- the kernel --------------------------------------------------------

// vrf: the file's first byte; row_bytes: VL x element size; n_vec: 16-byte
// vectors per row (the last one short in a ragged row).  Thread v of the
// grid owns bytes [16 v, 16 v + 16) of every row; at(slot) (in the slab,
// [n_slots][block] uint4) holds its vector of one slot.  Each
// instruction's code word and scalar are read one instruction ahead, and
// operand b is loaded from slot vs1 in either mode and then selected, so
// the dependent chain of an instruction is its slab reads, its op and its
// slab write.
template <int BITS, bool kAligned>
__device__ __forceinline__ void run(char* __restrict__ vrf, int64_t row_bytes,
                                    int64_t n_vec, const Prog& p) {
  extern __shared__ uint4 slab[];                        // [n_slots][block]
  constexpr int kElem = BITS / 8;
  const int block = blockDim.x;
  const uint32_t stride = block * kVecBytes;             // bytes per slot
  char* const mine = reinterpret_cast<char*>(slab + threadIdx.x);
  auto at = [&](uint32_t slot) -> uint4& {
    return *reinterpret_cast<uint4*>(mine + slot * stride);
  };
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * block + threadIdx.x;
       v < n_vec; v += static_cast<int64_t>(gridDim.x) * block) {
    const int64_t off = v * kVecBytes;
    const int n = kAligned ? kVecBytes
                           : static_cast<int>(row_bytes - off < kVecBytes
                                                  ? row_bytes - off
                                                  : kVecBytes);
    for (int i0 = 0; i0 < p.n_load; i0 += kBatch) {
      uint4 x[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (i0 + j < p.n_load)
          x[j] = load_vec<kElem, kAligned>(
              vrf + p.load_reg[i0 + j] * row_bytes + off, n);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (i0 + j < p.n_load) at(i0 + j) = x[j];
      }
    }
    uint2 ins = p.ins[0];
    int i_store = 0;
#pragma unroll 1
    for (int t = 0; t < p.n_instr; ++t) {
      const uint2 next = p.ins[t + 1];
      const uint32_t w = ins.x, s = ins.y;
      const uint4 a = at((w >> kVs2Shift) & kSlotMask);
      const uint4 c = at((w >> kVs1Shift) & kSlotMask);
      const bool vx = w & kVx;
      const uint4 b = make_uint4(vx ? s : c.x, vx ? s : c.y, vx ? s : c.z,
                                 vx ? s : c.w);
      const uint4 r = dispatch<BITS>(w & kKeyMask, a, b);
      at((w >> kVdShift) & kSlotMask) = r;
      if (w & kStore) {
        store_vec<kElem, kAligned>(
            vrf + p.store_reg[i_store++] * row_bytes + off, r, n);
      }
      ins = next;
    }
  }
}

// rows 16-byte aligned: every access one LDG.128 / STG.128
template <int BITS>
__global__ void __launch_bounds__(kMaxBlock)
vrf_alu_kernel(char* __restrict__ vrf, int64_t row_bytes, int64_t n_vec,
               const __grid_constant__ Prog p) {
  run<BITS, true>(vrf, row_bytes, n_vec, p);
}

// rows not 16-byte aligned, or a ragged end
template <int BITS>
__global__ void __launch_bounds__(kMaxBlock)
vrf_alu_ragged_kernel(char* __restrict__ vrf, int64_t row_bytes,
                      int64_t n_vec, const __grid_constant__ Prog p) {
  run<BITS, false>(vrf, row_bytes, n_vec, p);
}

// the launch floor: the same parameters, no work (measurement only)
__global__ void vrf_alu_floor_kernel(const __grid_constant__ Prog p) {}

using KernelFn = void (*)(char*, int64_t, int64_t, const Prog);

KernelFn pick(int elem_bytes, bool aligned) {
  switch (elem_bytes) {
    case 1: return aligned ? vrf_alu_kernel<8> : vrf_alu_ragged_kernel<8>;
    case 2: return aligned ? vrf_alu_kernel<16> : vrf_alu_ragged_kernel<16>;
    case 4: return aligned ? vrf_alu_kernel<32> : vrf_alu_ragged_kernel<32>;
    default: return nullptr;
  }
}

// The block and grid of a launch: of the blocks from block_cap down to 32
// threads whose slab fits, the one with the most threads resident on an SM
// (the larger on a tie), and the blocks of it resident on the card.  Cached
// per (device, kernel, slots, cap); the slab attribute is raised once per
// (device, kernel), to the most any launch asks.
cudaError_t plan(int device, KernelFn fn, int n_slots, int block_cap,
                 int* block, int* resident) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, int>,
                  std::pair<int, int>> cache;
  static std::map<std::tuple<int, const void*>, bool> raised;
  const auto key = std::make_tuple(device, reinterpret_cast<const void*>(fn),
                                   n_slots, block_cap);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *block = hit->second.first;
    *resident = hit->second.second;
    return cudaSuccess;
  }
  cudaError_t err;
  const auto fkey = std::make_tuple(device, reinterpret_cast<const void*>(fn));
  if (!raised[fkey]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSlabBytes);
    if (err != cudaSuccess) return err;
    raised[fkey] = true;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int best = 0, best_threads = -1, best_blocks = 1;
  for (int b = block_cap; b >= 32; b /= 2) {
    const int smem = n_slots * kVecBytes * b;
    if (smem > kMaxSlabBytes) continue;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, b, static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    if (per_sm * b > best_threads) {
      best = b;
      best_threads = per_sm * b;
      best_blocks = per_sm > 0 ? per_sm : 1;
    }
  }
  if (best == 0) return cudaErrorInvalidValue;
  *block = best;
  *resident = sms * best_blocks;
  cache[key] = std::make_pair(*block, *resident);
  return cudaSuccess;
}

}  // namespace

// vrf: [n_regs, vl] elements of elem_bytes (1, 2 or 4), contiguous, updated
// in place; row_bytes = vl x elem_bytes.  prog: one launch's program in
// host memory (prog_bytes == sizeof(Prog)), every register of its load /
// store lists a row of the file, every slot below its n_slots.  aligned:
// 1 if the file's start and row_bytes are multiples of 16 (checked).
// block_cap: the most threads per block (a power of two from 32 to 256;
// plan() picks the block); device: the current device's index.  Returns
// cudaGetLastError() after the launch.
extern "C" int vrf_alu(void* vrf, const void* prog, int prog_bytes,
                       long long row_bytes, int elem_bytes, int aligned,
                       int block_cap, int device, void* stream) {
  Prog p;
  if (prog_bytes != static_cast<int>(sizeof(Prog)) || row_bytes < 0 ||
      block_cap < 32 || block_cap > kMaxBlock ||
      (block_cap & (block_cap - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(&p, prog, sizeof(Prog));
  if (p.n_instr < 0 || p.n_instr > kMaxInstr || p.n_load < 0 ||
      p.n_load > p.n_slots || p.n_store < 0 || p.n_store > kMaxSlots ||
      p.n_slots <= 0 || p.n_slots > kMaxSlots ||
      row_bytes % (elem_bytes > 0 ? elem_bytes : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool is_aligned = reinterpret_cast<uintptr_t>(vrf) % kVecBytes == 0 &&
                          row_bytes % kVecBytes == 0;
  if (aligned && !is_aligned) return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn fn = pick(elem_bytes, aligned != 0);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (row_bytes == 0 || p.n_instr == 0) return static_cast<int>(cudaSuccess);
  int block = 0, resident = 0;
  cudaError_t err = plan(device, fn, p.n_slots, block_cap, &block, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = p.n_slots * kVecBytes * block;
  const int64_t n_vec = (row_bytes + kVecBytes - 1) / kVecBytes;
  const int64_t tiles = (n_vec + block - 1) / block;
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  fn<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(vrf), static_cast<int64_t>(row_bytes), n_vec, p);
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel with vrf_alu's parameters, one block of 32 threads: the
// floor under any launch (chip_smoke.py times it beside the kernel).
extern "C" int vrf_alu_floor(const void* prog, int prog_bytes, void* stream) {
  Prog p;
  if (prog_bytes != static_cast<int>(sizeof(Prog)))
    return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(&p, prog, sizeof(Prog));
  vrf_alu_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
