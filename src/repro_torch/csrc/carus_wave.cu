// NM-Carus wave executor for Hopper (sm_90a).
//
// Replaces the TPU kernel `_carus_kernel` / `_carus_call` in
// src/repro/nmc/pallas_engine.py: one launch runs a wave of T same-bucket
// NM-Carus xvnmc traces, each against its own 32-register x 256-word
// (32 KiB) vector register file.
//
// What bounds it on this card: not bytes.  Per tile the work is 64 KiB of
// VRF traffic plus 32 B per instruction.  Every instruction depends on the
// VRF state the previous one left (and slides gather across elements), so
// a tile runs its trace one instruction after another, each costing a few
// shared-memory accesses and two block barriers; the time is n_instr times
// that step latency, and the parallelism is across elements and tiles.
//
// Design: one block per tile and one thread per element
// (256 * 32 / SEW threads: 1024, 512 or 256).  The VRF sits in shared
// memory as native-dtype elements: the little-endian lanes of the int32
// words are exactly the elements in order, so the int32 word image is copied
// in and out as it is, with no unpack or pack pass around the launch.  The
// trace is staged through shared memory in chunks.  Each instruction has
// two phases: every thread reads its operands (and, for slides, its
// gathered element) into registers, then a barrier, because slides read
// across elements and vd may equal vs2; then it writes and a second barrier
// follows.  VL is a uniform register.
//
// Arithmetic that may overflow is unsigned 32-bit (signed overflow is
// undefined in C++; the reference wraps); C++ % truncates toward zero, so
// the reference's floor mods go through floor_mod().
//
// Register indices are reduced modulo n_regs and element indices modulo
// the register length, exactly like the reference; slide gathers clamp
// their index like the reference's clip.  Opcodes are assumed valid: the
// pools check every wave with repro_torch.nmc.check.assert_wave before
// dispatch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kVrfWords = 8192;   // 32 registers x 256 words
constexpr int kChunk = 128;       // instructions staged per round (4 KiB)
constexpr int kFields = 8;

// Compact VOp ids (VOP_COMPACT in src/repro_torch/core/isa.py); checked by
// the CPU tests.
enum VOpId : int {
  VADD = 0, VSUB = 1, VMUL = 2, VMACC = 3, VAND = 4, VOR = 5, VXOR = 6,
  VMIN = 7, VMINU = 8, VMAX = 9, VMAXU = 10, VSLL = 11, VSRL = 12,
  VSRA = 13, VMV = 14, VSLIDEUP = 15, VSLIDEDOWN = 16, EMVV = 17, EMVX = 18,
  VSETVL = 19, VNOP = 20,
};
enum Mode : int { MODE_VV = 0, MODE_VX = 1, MODE_VI = 2, MODE_INDIRECT = 4,
                  MODE_SLIDE1 = 8 };

__device__ __forceinline__ int floor_mod(int x, int n) {
  const int r = x % n;
  return r < 0 ? r + n : r;
}

template <typename E, int SEW>
__global__ void __launch_bounds__(1024)
carus_wave_kernel(const int32_t* __restrict__ f_op,
                  const int32_t* __restrict__ f_vd,
                  const int32_t* __restrict__ f_vs1,
                  const int32_t* __restrict__ f_vs2,
                  const int32_t* __restrict__ f_sval1,
                  const int32_t* __restrict__ f_sval2,
                  const int32_t* __restrict__ f_imm,
                  const int32_t* __restrict__ f_mode,
                  int32_t* __restrict__ vrf, int n_instr, int n_regs) {
  constexpr int kElems = 256 * 32 / SEW;       // elements per register
  constexpr uint32_t kMask = SEW == 32 ? 0xFFFFFFFFu : ((1u << SEW) - 1u);
  __shared__ __align__(16) uint32_t words[kVrfWords];
  __shared__ int32_t instr[kFields][kChunk];
  E* v = reinterpret_cast<E*>(words);          // [n_regs][kElems]
  const int e = threadIdx.x;

  uint4* g = reinterpret_cast<uint4*>(vrf) +
             static_cast<size_t>(blockIdx.x) * (kVrfWords / 4);
  uint4* s = reinterpret_cast<uint4*>(words);
  for (int i = e; i < kVrfWords / 4; i += blockDim.x) s[i] = g[i];

  const int32_t* fields[kFields] = {f_op, f_vd, f_vs1, f_vs2,
                                    f_sval1, f_sval2, f_imm, f_mode};
  const size_t base = static_cast<size_t>(blockIdx.x) * n_instr;
  int vl = kElems;                             // VLMAX
  for (int c0 = 0; c0 < n_instr; c0 += kChunk) {
    const int cn = min(kChunk, n_instr - c0);
    __syncthreads();                           // VRF in / chunk consumed
    for (int i = e; i < kFields * cn; i += blockDim.x)
      instr[i / cn][i % cn] = fields[i / cn][base + c0 + i % cn];
    __syncthreads();
    for (int i = 0; i < cn; ++i) {
      const int op = instr[0][i];
      const int sval1 = instr[4][i], sval2 = instr[5][i];
      const int mode = instr[7][i];
      const bool indirect = (mode & MODE_INDIRECT) != 0;
      const bool slide1 = (mode & MODE_SLIDE1) != 0;
      const int opmode = mode & 0x3;
      // indirect register addressing: indices from sval2's LSBytes
      const int vd = floor_mod(indirect ? (sval2 >> 16) & 0xFF : instr[1][i],
                               n_regs);
      const int vs1 = floor_mod(indirect ? sval2 & 0xFF : instr[2][i], n_regs);
      const int vs2 = floor_mod(indirect ? (sval2 >> 8) & 0xFF : instr[3][i],
                                n_regs);

      // phase 1: read operands into registers
      const int32_t dst = v[vd * kElems + e];
      const int32_t a = v[vs2 * kElems + e];
      const int32_t scalar_b = opmode == MODE_VI ? instr[6][i] : sval1;
      const bool vv = opmode == MODE_VV;
      const int32_t s1r = v[vs1 * kElems + e];
      // b: vs1 element or the scalar truncated to SEW (as the native-dtype
      // splat); b32: the untruncated scalar for signed min/max
      const int32_t b = vv ? s1r : static_cast<int32_t>(static_cast<E>(scalar_b));
      const int32_t b32 = vv ? s1r : scalar_b;
      const uint32_t ua = static_cast<uint32_t>(a) & kMask;
      const uint32_t ub = static_cast<uint32_t>(b) & kMask;
      const uint32_t sh = ub & (SEW - 1);      // RVV: amount mod SEW
      const int32_t off = slide1 ? 1 : scalar_b;
      int vl_eff = vl;
      bool writes = op <= EMVV;
      uint32_t r = static_cast<uint32_t>(dst);
      switch (op) {
        case VADD: r = static_cast<uint32_t>(a) + static_cast<uint32_t>(b); break;
        case VSUB: r = static_cast<uint32_t>(a) - static_cast<uint32_t>(b); break;
        case VMUL: r = static_cast<uint32_t>(a) * static_cast<uint32_t>(b); break;
        case VMACC:
          r = static_cast<uint32_t>(dst) +
              static_cast<uint32_t>(a) * static_cast<uint32_t>(b);
          break;
        case VAND: r = static_cast<uint32_t>(a & b); break;
        case VOR:  r = static_cast<uint32_t>(a | b); break;
        case VXOR: r = static_cast<uint32_t>(a ^ b); break;
        case VMIN: r = static_cast<uint32_t>(a < b32 ? a : b32); break;
        case VMAX: r = static_cast<uint32_t>(a > b32 ? a : b32); break;
        case VMINU: r = static_cast<uint32_t>(ua <= ub ? a : b); break;
        case VMAXU: r = static_cast<uint32_t>(ua >= ub ? a : b); break;
        case VSLL: r = ua << sh; break;
        case VSRL: r = ua >> sh; break;
        case VSRA: r = static_cast<uint32_t>(a >> sh); break;
        case VMV: r = static_cast<uint32_t>(b); break;
        case VSLIDEUP: {
          const int idx = static_cast<int>(static_cast<uint32_t>(e) -
                                           static_cast<uint32_t>(off));
          r = idx >= 0 ? static_cast<uint32_t>(
                             static_cast<int32_t>(
                                 v[vs2 * kElems + min(idx, kElems - 1)]))
                       : static_cast<uint32_t>(dst);
          if (slide1 && e == 0) r = static_cast<uint32_t>(sval1);
          break;
        }
        case VSLIDEDOWN: {
          const int idx = static_cast<int>(static_cast<uint32_t>(e) +
                                           static_cast<uint32_t>(off));
          const int32_t got = v[vs2 * kElems + max(0, min(idx, kElems - 1))];
          r = idx < vl ? static_cast<uint32_t>(got) : 0u;
          if (slide1 && e == vl - 1) r = static_cast<uint32_t>(sval1);
          break;
        }
        case EMVV:                             // one element, ignores VL
          vl_eff = kElems;
          if (e == floor_mod(sval2, kElems)) r = static_cast<uint32_t>(sval1);
          break;
        default: break;                        // EMVX, VSETVL, VNOP
      }
      __syncthreads();
      // phase 2: tail-undisturbed writeback
      if (writes && e < vl_eff) v[vd * kElems + e] = static_cast<E>(r);
      __syncthreads();
      if (op == VSETVL) vl = min(sval1, kElems);   // signed min with VLMAX
    }
  }
  __syncthreads();
  for (int i = e; i < kVrfWords / 4; i += blockDim.x) g[i] = s[i];
}

template <typename E, int SEW>
void launch(const int32_t* const* f, int32_t* vrf, int n_tiles, int n_instr,
            int n_regs, cudaStream_t st) {
  carus_wave_kernel<E, SEW><<<n_tiles, 256 * 32 / SEW, 0, st>>>(
      f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], vrf, n_instr, n_regs);
}

}  // namespace

// fields: 8 int32 [n_tiles, n_instr] arrays in CARUS_TRACE_DTYPE order (op,
// vd, vs1, vs2, sval1, sval2, imm, mode); vrf: int32 [n_tiles, n_regs,
// reg_words], updated in place.  Returns cudaGetLastError() after the launch.
extern "C" int carus_wave(const void* op, const void* vd, const void* vs1,
                          const void* vs2, const void* sval1,
                          const void* sval2, const void* imm,
                          const void* mode, void* vrf, int n_tiles,
                          int n_instr, int n_regs, int reg_words, int sew,
                          void* stream) {
  if (n_regs * reg_words != kVrfWords || reg_words != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const int32_t* f[kFields] = {
      static_cast<const int32_t*>(op), static_cast<const int32_t*>(vd),
      static_cast<const int32_t*>(vs1), static_cast<const int32_t*>(vs2),
      static_cast<const int32_t*>(sval1), static_cast<const int32_t*>(sval2),
      static_cast<const int32_t*>(imm), static_cast<const int32_t*>(mode)};
  auto* x = static_cast<int32_t*>(vrf);
  auto st = static_cast<cudaStream_t>(stream);
  switch (sew) {
    case 8: launch<int8_t, 8>(f, x, n_tiles, n_instr, n_regs, st); break;
    case 16: launch<int16_t, 16>(f, x, n_tiles, n_instr, n_regs, st); break;
    case 32: launch<int32_t, 32>(f, x, n_tiles, n_instr, n_regs, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
