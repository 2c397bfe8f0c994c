// NM-Carus VPU as a program-as-data kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `vrf_alu` in
// src/repro/kernels/vrf_alu.py: one launch runs a whole program of
// element-wise vector instructions (op, vd, vs1, vs2, scalar, mode) over an
// (n_regs, VL) int8/int16/int32 register file, updated in place.  The
// program is runtime data: the same compiled kernel runs any program over
// any register operands.
//
// What bounds it on this card: bytes.  Each instruction is one integer op
// per element, so even a long program does a few operations per byte of
// register traffic; the least time is the registers the program reads
// before writing them, loaded once, plus the registers it writes, stored
// once, over the memory rate.  N instructions cost one memory round trip,
// not N.
//
// Design: every element lane is independent (the paper's Fig. 6 bank
// alignment: element i of every register lives in the same bank), so a
// thread owns its columns' elements of every register and no barrier is
// needed anywhere.  The host wrapper compiles the program once per call:
// the registers it touches get dense slots, and it lists the registers to
// load (those read before any instruction writes them: vs2 unless the op is
// mv, vs1 in vv mode) and to store (those written); a slot written first
// is never loaded.  A thread owns 4 columns, a block apart (so loads and
// stores coalesce), and keeps their elements of each slot as one int4 in
// shared memory (slot indices are dynamic, and registers cannot be indexed
// at run time): an instruction is two 16-byte shared-memory reads, one op
// dispatch and one 16-byte write for 4 elements, and a block's slab is
// n_slots x block int4, not n_regs x block.  The compiled program is read
// by all threads of a warp at the same address (a broadcast through the
// read-only cache).  A thread issues the loads of up to 8 registers x 4
// columns before it writes any into its slab, so they are in flight
// together.  The grid is sized to the blocks that fit the card at once, and
// each block strides over the columns.  Arithmetic is unsigned 32-bit
// (signed overflow is undefined in C++; the reference wraps) and a result
// is truncated to the element width when it is written.
//
// Register indices are checked on the host (the wrapper raises ValueError
// outside [0, n_regs)); the kernel addresses only the slots it was given.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFields = 6;        // op, vd, vs1, vs2, scalar, mode
constexpr int kModeVV = 0;
constexpr int kBatch = 8;         // registers whose loads issue together
constexpr int kCols = 4;          // columns a thread owns: one int4 per slot

// VRF_OPS in src/repro_torch/kernels/ref.py; checked by the CPU tests.
enum Op : int {
  ADD = 0, SUB = 1, MUL = 2, MIN = 3, MAX = 4, AND = 5, OR = 6, XOR = 7,
  SLL = 8, SRL = 9, SRA = 10, MV = 11,
};

// The low BITS bits of x as a signed value, sign-extended to 32 bits.
template <int BITS>
__device__ __forceinline__ int trunc(unsigned x) {
  if constexpr (BITS == 32) {
    return static_cast<int>(x);
  } else {
    return static_cast<int>(x << (32 - BITS)) >> (32 - BITS);
  }
}

template <int OP, int BITS>
__device__ __forceinline__ int binop(int a, int b) {
  const unsigned ua = static_cast<unsigned>(a);
  const unsigned ub = static_cast<unsigned>(b);
  // (b mod 2^32) mod BITS: BITS divides 2^32
  const unsigned sh = ub & (BITS - 1);
  constexpr unsigned kMask = BITS == 32 ? 0xffffffffu : (1u << BITS) - 1u;
  unsigned r;
  if constexpr (OP == ADD) r = ua + ub;
  else if constexpr (OP == SUB) r = ua - ub;
  else if constexpr (OP == MUL) r = ua * ub;
  else if constexpr (OP == MIN) r = static_cast<unsigned>(a < b ? a : b);
  else if constexpr (OP == MAX) r = static_cast<unsigned>(a > b ? a : b);
  else if constexpr (OP == AND) r = ua & ub;
  else if constexpr (OP == OR) r = ua | ub;
  else if constexpr (OP == XOR) r = ua ^ ub;
  else if constexpr (OP == SLL) r = ua << sh;
  else if constexpr (OP == SRL) r = (ua & kMask) >> sh;
  else if constexpr (OP == SRA) r = static_cast<unsigned>(a >> sh);
  else r = ub;                    // MV
  return trunc<BITS>(r);
}

// One op on a thread's kCols (= 4) columns at once.
template <int OP, int BITS>
__device__ __forceinline__ int4 binop4(int4 a, int4 b) {
  return make_int4(binop<OP, BITS>(a.x, b.x), binop<OP, BITS>(a.y, b.y),
                   binop<OP, BITS>(a.z, b.z), binop<OP, BITS>(a.w, b.w));
}

template <int BITS>
__device__ __forceinline__ int4 dispatch(int op, int4 a, int4 b) {
  switch (op) {
    case ADD: return binop4<ADD, BITS>(a, b);
    case SUB: return binop4<SUB, BITS>(a, b);
    case MUL: return binop4<MUL, BITS>(a, b);
    case MIN: return binop4<MIN, BITS>(a, b);
    case MAX: return binop4<MAX, BITS>(a, b);
    case AND: return binop4<AND, BITS>(a, b);
    case OR: return binop4<OR, BITS>(a, b);
    case XOR: return binop4<XOR, BITS>(a, b);
    case SLL: return binop4<SLL, BITS>(a, b);
    case SRL: return binop4<SRL, BITS>(a, b);
    case SRA: return binop4<SRA, BITS>(a, b);
    default: return binop4<MV, BITS>(a, b);
  }
}

// code: n_load (register, slot) pairs, then n_store pairs, then n_instr
// rows of (op, vd, vs1, vs2, scalar, mode) with registers as slots.  A
// thread owns kCols (= 4) columns, a block apart; its elements of one slot
// are one int4, slab[slot * block + tid], read and written in one
// shared-memory access.
template <typename E, int BITS>
__global__ void vrf_alu_kernel(E* __restrict__ vrf,
                               const int32_t* __restrict__ code, int n_instr,
                               int n_load, int n_store, int vl) {
  extern __shared__ int4 slab[];                         // [n_slots][block]
  const int block = blockDim.x;
  const int tid = threadIdx.x;
  const int32_t* loads = code;
  const int32_t* stores = code + 2 * n_load;
  const int32_t* prog = stores + 2 * n_store;
  const int64_t span = static_cast<int64_t>(block) * kCols;
  for (int64_t base = blockIdx.x * span + tid; base < vl;
       base += gridDim.x * span) {
    // up to kBatch x kCols independent loads in flight before a first use
    for (int i0 = 0; i0 < n_load; i0 += kBatch) {
      int v[kBatch][kCols];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (i0 + j < n_load) {
          const int64_t row =
              static_cast<int64_t>(__ldg(loads + 2 * (i0 + j))) * vl;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int64_t col = base + c * block;
            v[j][c] = col < vl ? static_cast<int>(vrf[row + col]) : 0;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (i0 + j < n_load)
          slab[__ldg(loads + 2 * (i0 + j) + 1) * block + tid] =
              make_int4(v[j][0], v[j][1], v[j][2], v[j][3]);
      }
    }
    for (int t = 0; t < n_instr; ++t) {
      const int32_t* ins = prog + t * kFields;
      const int4 a = slab[__ldg(ins + 3) * block + tid];
      int4 b;
      if (__ldg(ins + 5) == kModeVV) {
        b = slab[__ldg(ins + 2) * block + tid];
      } else {
        const int x = trunc<BITS>(static_cast<unsigned>(__ldg(ins + 4)));
        b = make_int4(x, x, x, x);
      }
      slab[__ldg(ins + 1) * block + tid] = dispatch<BITS>(__ldg(ins), a, b);
    }
    for (int i = 0; i < n_store; ++i) {
      const int64_t row = static_cast<int64_t>(__ldg(stores + 2 * i)) * vl;
      const int4 r = slab[__ldg(stores + 2 * i + 1) * block + tid];
      const int out[kCols] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int64_t col = base + c * block;
        if (col < vl) vrf[row + col] = static_cast<E>(out[c]);
      }
    }
  }
}

template <typename E, int BITS>
int launch(void* vrf, const void* code, int n_instr, int n_slots, int n_load,
           int n_store, int vl, int block, cudaStream_t st) {
  auto kernel = vrf_alu_kernel<E, BITS>;
  const size_t smem = sizeof(int4) * static_cast<size_t>(n_slots) * block;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, block, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int64_t span = static_cast<int64_t>(block) * kCols;
  const int64_t tiles = (static_cast<int64_t>(vl) + span - 1) / span;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm
                                                                   : 1);
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  kernel<<<grid, block, smem, st>>>(static_cast<E*>(vrf),
                                    static_cast<const int32_t*>(code),
                                    n_instr, n_load, n_store, vl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vrf: [n_regs, vl] elements of elem_bytes (1, 2 or 4), contiguous, updated
// in place; code: the compiled program (see vrf_alu_kernel), every register
// of its load / store lists in [0, n_regs) and every slot in [0, n_slots).
// block: threads per block (a multiple of 32).  Returns cudaGetLastError()
// after the launch.
extern "C" int vrf_alu(void* vrf, const void* code, int n_instr, int n_slots,
                       int n_load, int n_store, int vl, int elem_bytes,
                       int block, void* stream) {
  if (n_slots <= 0 || vl < 0 || n_instr < 0 || n_load < 0 || n_store < 0 ||
      block <= 0 || block % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vl == 0 || n_instr == 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1:
      return launch<int8_t, 8>(vrf, code, n_instr, n_slots, n_load, n_store,
                               vl, block, st);
    case 2:
      return launch<int16_t, 16>(vrf, code, n_instr, n_slots, n_load,
                                 n_store, vl, block, st);
    case 4:
      return launch<int32_t, 32>(vrf, code, n_instr, n_slots, n_load,
                                 n_store, vl, block, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
