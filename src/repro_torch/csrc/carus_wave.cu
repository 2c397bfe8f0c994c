// NM-Carus wave executor for Hopper (sm_90a).
//
// Replaces the TPU kernel `_carus_kernel` / `_carus_call` in
// src/repro/nmc/pallas_engine.py: one launch runs a wave of T same-bucket
// NM-Carus xvnmc traces, each against its own 32-register x 256-word
// (32 KiB) vector register file.
//
// What bounds it on this card: not bytes.  Per tile the work is 64 KiB of
// VRF traffic plus 32 B per instruction, a few microseconds of HBM time for
// a whole wave.  A tile runs its trace one instruction after another, so
// its time is a latency: the instructions it executes times the time one
// warp takes per instruction.  The first version of this kernel ran one
// thread per element (1024 threads at SEW 8), every thread decoded every
// instruction again (field loads, three divisions by the register count,
// mode selects), and every instruction ended in two block barriers: it was
// issue-bound on work that all 32 warps repeated, over a floor of barrier
// latency, and bucket padding (VNOPs) cost as much as real work.
//
// Design: one block of kThreads = 256 threads per tile; thread t owns word
// t of every register, i.e. elements t*L .. t*L+L-1 (L = 32 / SEW,
// little-endian lanes).  The VRF stays in shared memory as the int32 word
// image, so word t of a register sits in bank t % 32 and a warp's accesses
// never conflict.  The trace runs in chunks of kChunk = 256 instructions:
//   1. Fields.  Thread t copies instruction t of a chunk (eight int32
//      fields) into a two-slot staging area by cp.async, two chunks ahead;
//      the image comes in by 16-byte cp.async beside the first chunks.  A
//      thread decodes only what it copied itself, so staging needs no
//      barrier.
//   2. Decode, once per tile.  Thread t turns its instruction into a
//      16-byte record: op, flags and the three register indices (after the
//      indirect selection, reduced & 31, which is the floor mod by 32 for
//      negative indices too, stored as byte offsets reg * 1024), the scalar
//      operand (untruncated), a slide's sval1, and the VL in force; EMVV's
//      element sval2 & (E-1) becomes its word and lane shift.  VL depends
//      only on the trace's VSETVLs, never on VRF values: a lane takes the
//      VL of the latest VSETVL below it in its warp (ballot + shuffle),
//      and a record with none before it in its warp is marked to take the
//      VL carried in from the previous warps' segments and chunks.  A VL at or below zero writes nothing, so the
//      decode clamps VL to [0, VLMAX]: the same result, and vl - t*L and
//      vl - 1 cannot overflow.  VNOP, EMVX and VSETVL write nothing and are
//      compacted out (ballot + popc prefix): each warp writes its records
//      densely into its own 32-slot segment, with the segment's count and
//      its last VSETVL beside it.  Records are double-buffered, so chunk
//      c+1 is decoded right after chunk c's barrier, while other warps
//      already execute chunk c.
//   3. Execute.  Every thread walks the chunk's segments in order (the
//      trace's order), two records in flight in two register sets, and
//      carries VL across segments in a block-uniform register.  Every op
//      but the two slides reads and writes only the executing thread's own
//      words (EMVV's one element is written by the thread that owns it),
//      so warps run a chunk at their own pace.  A slide gathers from other
//      threads' words and is fenced on both sides by __syncthreads: before
//      its gathers, so every earlier write to vs2 is visible; after them,
//      before its write, because vd may equal vs2 and a later op may
//      overwrite vs2 words another thread still reads.
//   4. Barriers.  One per chunk (its records and, before the first, the
//      image are visible), two per slide, one before the image goes out.
//      A trace without slides takes none inside a chunk, and bucket
//      padding costs only its decode.
// What bounds the new kernel: one warp's dependent chain per executed
// record (the broadcast LDS.128 of the record, the dispatch, the operand
// loads, the lane arithmetic, the tail merge, one store), plus two
// barriers per slide.  Branches cost most on that chain, so the
// element-local ops take at most two: slides and EMVV behind one, MUL,
// MACC and the shifts (lane loops) behind another, and the rest computed
// by selects without a branch.
// The result is the serial one bit for bit: non-slide ops are element-local
// and run in trace order within each thread, slides are fenced on both
// sides, and VL is value-free, so the decode knows it before any VRF value.
//
// Lane arithmetic that may overflow is unsigned 32-bit (signed overflow is
// undefined in C++; the reference wraps).  VADD and VSUB are the SIMD
// intrinsics (__vadd4 ... at SEW 8, the ...2 forms at SEW 16); the four
// min / max ops share one unsigned lane compare (__vcmpltu4 / 2), signed
// ones on lanes with their sign bit flipped.  Signed VMIN / VMAX against a
// scalar compare with the untruncated 32-bit scalar: a block-uniform case
// split on its range (above the lane range: min keeps the lane, max gives
// the truncated scalar; below it, the reverse; inside it, the compare with
// the splat).  MUL, MACC and the shifts (amounts mod SEW) go lane by lane.
// Slide gathers clamp their index like the reference's clip.  Opcodes are
// assumed valid: the pools check every wave with
// repro_torch.nmc.check.assert_wave before dispatch.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kRegs = 32;
constexpr int kRegWords = 256;
constexpr int kVrfWords = kRegs * kRegWords;   // 8192 words, 32 KiB
constexpr int kThreads = 256;    // threads per tile, one per VRF word
constexpr int kChunk = 256;      // instructions decoded per chunk, one a thread
constexpr int kWarps = kThreads / 32;
constexpr int kFields = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kThreads == kRegWords && kChunk == kThreads,
              "thread t owns VRF word t and decodes instruction t of a chunk");
// image (32 KiB), two record buffers (8 KiB), two segment tables, two
// staging slots of raw fields (16 KiB): dynamic shared memory
constexpr int kSmemBytes = kVrfWords * 4 + 2 * kChunk * 16 + 2 * kWarps * 16 +
                           2 * kFields * kChunk * 4;

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

// Record word 0: op (bits 0-4), flags, and vd / vs1 / vs2 (5 bits each at
// bits 10, 15, 20, so that a field masked in place is the register's byte
// offset, reg * 1024).  Word 1: the scalar; word 2: a slide's sval1 or
// EMVV's word; word 3: the VL in force or EMVV's lane shift.
constexpr uint32_t kRecVV = 1u << 5;       // operand b is register vs1
constexpr uint32_t kRecSlide1 = 1u << 6;   // vslide1up / vslide1down
constexpr uint32_t kRecCarryVL = 1u << 7;  // VL from the carry, not word 3
constexpr int kRecVd = 10, kRecVs1 = 15, kRecVs2 = 20;
constexpr uint32_t kRegBytes = 31u << kRecVd;

// ---------------------------------------------------------------------------
// lane arithmetic on one 32-bit word of L = 32 / SEW lanes
// ---------------------------------------------------------------------------

template <int SEW>
struct Lanes {
  static constexpr int L = 32 / SEW;
  static constexpr int kElems = kRegWords * L;        // elements a register
  static constexpr uint32_t kMask =
      SEW == 32 ? 0xFFFFFFFFu : ((1u << SEW) - 1u);
  static constexpr int32_t kHi = SEW == 32 ? 0x7FFFFFFF
                                           : (1 << (SEW - 1)) - 1;
  static constexpr int32_t kLo = -kHi - 1;
};

template <int SEW>
__device__ __forceinline__ uint32_t ulane(uint32_t w, int k) {
  return (w >> (SEW * k)) & Lanes<SEW>::kMask;
}

template <int SEW>
__device__ __forceinline__ int32_t slane(uint32_t w, int k) {
  // sign-extended lane k: move it to the top, shift back
  return static_cast<int32_t>(w << (32 - SEW * (k + 1))) >> (32 - SEW);
}

template <int SEW>
__device__ __forceinline__ uint32_t put(uint32_t r, int k) {
  return (r & Lanes<SEW>::kMask) << (SEW * k);
}

template <int SEW>
__host__ __device__ constexpr uint32_t splat(uint32_t s) {
  if constexpr (SEW == 8) return (s & 0xFFu) * 0x01010101u;
  else if constexpr (SEW == 16) return (s & 0xFFFFu) * 0x00010001u;
  else return s;
}

template <int SEW>
__device__ __forceinline__ uint32_t vadd(uint32_t a, uint32_t b) {
  if constexpr (SEW == 8) return __vadd4(a, b);
  else if constexpr (SEW == 16) return __vadd2(a, b);
  else return a + b;
}

template <int SEW>
__device__ __forceinline__ uint32_t vsub(uint32_t a, uint32_t b) {
  if constexpr (SEW == 8) return __vsub4(a, b);
  else if constexpr (SEW == 16) return __vsub2(a, b);
  else return a - b;
}

// all-ones in the lanes where a < b, unsigned
template <int SEW>
__device__ __forceinline__ uint32_t vcmpltu(uint32_t a, uint32_t b) {
  if constexpr (SEW == 8) return __vcmpltu4(a, b);
  else if constexpr (SEW == 16) return __vcmpltu2(a, b);
  else return a < b ? 0xFFFFFFFFu : 0u;
}

template <int SEW>
__device__ __forceinline__ uint32_t vmul(uint32_t a, uint32_t b) {
  if constexpr (SEW == 32) return a * b;
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < Lanes<SEW>::L; ++k)
    r |= put<SEW>(ulane<SEW>(a, k) * ulane<SEW>(b, k), k);
  return r;
}

// VSLL / VSRL / VSRA, each lane shifted by its own amount mod SEW
template <int SEW>
__device__ __forceinline__ uint32_t vshift(int op, uint32_t a, uint32_t b) {
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < Lanes<SEW>::L; ++k) {
    const uint32_t sh = ulane<SEW>(b, k) & (SEW - 1);
    const uint32_t x =
        op == VSLL ? ulane<SEW>(a, k) << sh
        : op == VSRL ? ulane<SEW>(a, k) >> sh
                     : static_cast<uint32_t>(slane<SEW>(a, k) >> sh);
    r |= put<SEW>(x, k);
  }
  return r;
}

// Tail-undisturbed write of word t: the lanes of elements below vl from r,
// the others from dst (word t's value before the op), without a branch.
template <int SEW>
__device__ __forceinline__ void write_vl(uint32_t* d, uint32_t r,
                                         uint32_t dst, int vl, int t) {
  constexpr int L = Lanes<SEW>::L;
  const int n = vl - t * L;                 // lanes of this word inside VL
  uint32_t m = n > 0 ? 0xFFFFFFFFu : 0u;
  if constexpr (L > 1)
    if (n > 0 && n < L) m = (1u << (SEW * n)) - 1u;
  *d = (r & m) | (dst & ~m);
}

// ---------------------------------------------------------------------------
// staging and decode
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Thread t copies the fields of instruction t of `chunk` into its column of
// the staging slot (zeros past n_instr), then commits one group (empty past
// the trace).
__device__ __forceinline__ void stage(int32_t* slot,
                                      const int32_t* const* field, int chunk,
                                      int n_instr, int t) {
  if (chunk * kChunk < n_instr) {
    const int i = chunk * kChunk + t;
    const int ic = min(i, n_instr - 1);
#pragma unroll
    for (int f = 0; f < kFields; ++f)
      cp_async4(slot + f * kChunk + t, field[f] + ic, i < n_instr ? 4 : 0);
  }
  cp_async_commit();
}

// Thread t decodes instruction t of `chunk` from its own staged column into
// its warp's record segment; lane 0 writes the segment's (count, has a
// VSETVL, the last VSETVL's VL).
template <int SEW>
__device__ __forceinline__ void decode(const int32_t* slot, uint4* recs,
                                       int4* segs, int chunk, int n_instr,
                                       int t) {
  constexpr int kElems = Lanes<SEW>::kElems;
  const int warp = t / 32, ln = t % 32;
  const bool valid = chunk * kChunk + t < n_instr;
  const int op = slot[0 * kChunk + t];
  const int sval1 = slot[4 * kChunk + t], sval2 = slot[5 * kChunk + t];
  const int imm = slot[6 * kChunk + t], mode = slot[7 * kChunk + t];
  const bool indirect = (mode & MODE_INDIRECT) != 0;
  // indirect register addressing: indices from sval2's LSBytes
  const uint32_t vd = (indirect ? sval2 >> 16 : slot[1 * kChunk + t]) & 31;
  const uint32_t vs1 = (indirect ? sval2 : slot[2 * kChunk + t]) & 31;
  const uint32_t vs2 = (indirect ? sval2 >> 8 : slot[3 * kChunk + t]) & 31;
  const int opmode = mode & 0x3;
  const bool executes = valid && op <= EMVV;    // VNOP, EMVX, VSETVL: no write
  const unsigned below = (1u << ln) - 1u;
  const unsigned sets = __ballot_sync(kFull, valid && op == VSETVL);
  const int new_vl = max(min(sval1, kElems), 0); // VL <= 0 writes nothing
  const unsigned before = sets & below;
  const int vl = __shfl_sync(kFull, new_vl, before ? 31 - __clz(before) : 0);
  const int last = __shfl_sync(kFull, new_vl, sets ? 31 - __clz(sets) : 0);
  const unsigned execs = __ballot_sync(kFull, executes);
  if (executes) {
    const bool emvv = op == EMVV;
    const int elem = sval2 & (kElems - 1);      // EMVV's element
    uint4 r;
    r.x = static_cast<uint32_t>(op) | (opmode == MODE_VV ? kRecVV : 0u) |
          ((mode & MODE_SLIDE1) ? kRecSlide1 : 0u) |
          (before ? 0u : kRecCarryVL) |
          (vd << kRecVd) | (vs1 << kRecVs1) | (vs2 << kRecVs2);
    r.y = static_cast<uint32_t>(!emvv && opmode == MODE_VI ? imm : sval1);
    r.z = static_cast<uint32_t>(emvv ? elem / Lanes<SEW>::L : sval1);
    r.w = static_cast<uint32_t>(emvv ? elem % Lanes<SEW>::L * SEW : vl);
    recs[warp * 32 + __popc(execs & below)] = r;
  }
  if (ln == 0) segs[warp] = make_int4(__popc(execs), sets != 0, last, 0);
}

// ---------------------------------------------------------------------------
// execute
// ---------------------------------------------------------------------------

// The word of register `src` that a slide gives thread t (before the VL
// mask); `dst` is thread t's word of vd.
template <int SEW>
__device__ __forceinline__ uint32_t slide_word(const uint32_t* src, int op,
                                               uint4 r, uint32_t dst, int vl,
                                               int t) {
  using E = typename std::conditional<
      SEW == 8, int8_t,
      typename std::conditional<SEW == 16, int16_t, int32_t>::type>::type;
  constexpr int L = Lanes<SEW>::L, kElems = Lanes<SEW>::kElems;
  const E* v = reinterpret_cast<const E*>(src);
  const bool s1 = (r.x & kRecSlide1) != 0;
  const uint32_t off = s1 ? 1u : r.y;
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int e = t * L + k;
    uint32_t x;
    if (op == VSLIDEUP) {
      const int idx = static_cast<int>(static_cast<uint32_t>(e) - off);
      x = idx >= 0 ? static_cast<uint32_t>(v[min(idx, kElems - 1)])
                   : ulane<SEW>(dst, k);
      if (s1 && e == 0) x = r.z;
    } else {
      const int idx = static_cast<int>(static_cast<uint32_t>(e) + off);
      x = idx < vl ? static_cast<uint32_t>(v[max(0, min(idx, kElems - 1))])
                   : 0u;
      if (s1 && e == vl - 1) x = r.z;
    }
    w |= put<SEW>(x, k);
  }
  return w;
}

// VADD, VSUB, VAND, VOR, VXOR, VMIN, VMINU, VMAX, VMAXU and VMV, by selects
template <int SEW>
__device__ __forceinline__ uint32_t select_op(int op, uint32_t a, uint32_t b,
                                              bool vv, int32_t s) {
  constexpr uint32_t kSign = splat<SEW>(1u << (SEW - 1));
  const bool sgn = op == VMIN || op == VMAX;
  const bool mx = op == VMAX || op == VMAXU;
  const uint32_t bias = sgn ? kSign : 0u;       // signed: flip the sign bits
  uint32_t pick_a = vcmpltu<SEW>(a ^ bias, b ^ bias);   // lanes a < b
  if (mx) pick_a = ~pick_a;
  // against a scalar outside the lane range: all of a, or all of b
  const bool hi = sgn && !vv && s > Lanes<SEW>::kHi;
  const bool lo = sgn && !vv && s < Lanes<SEW>::kLo;
  pick_a = (mx ? lo : hi) ? 0xFFFFFFFFu : ((mx ? hi : lo) ? 0u : pick_a);
  uint32_t w = op >= VMIN && op <= VMAXU ? (a & pick_a) | (b & ~pick_a) : b;
  w = op == VADD ? vadd<SEW>(a, b) : w;
  w = op == VSUB ? vsub<SEW>(a, b) : w;
  w = op == VAND ? (a & b) : w;
  w = op == VOR ? (a | b) : w;
  w = op == VXOR ? (a ^ b) : w;
  return w;
}

constexpr uint32_t kLaneOps = (1u << VMUL) | (1u << VMACC) | (1u << VSLL) |
                              (1u << VSRL) | (1u << VSRA);

__device__ __forceinline__ uint32_t* at(uint32_t* p, uint32_t bytes) {
  return reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(p) + bytes);
}

// One record on thread t; wt = words + t.
template <int SEW>
__device__ __forceinline__ void execute(uint32_t* words, uint32_t* wt,
                                        uint4 r, int vl, int t) {
  const int op = r.x & 31;
  uint32_t* d = at(wt, r.x & kRegBytes);
  const uint32_t vs2 = (r.x >> (kRecVs2 - kRecVd)) & kRegBytes;
  if (op >= VSLIDEUP) {                       // the slides and EMVV
    if (op == EMVV) {                         // one element, ignores VL
      if (static_cast<int>(r.z) == t) {
        constexpr uint32_t m = Lanes<SEW>::kMask;
        *d = (*d & ~(m << r.w)) | ((r.y & m) << r.w);
      }
      return;
    }
    const uint32_t dst = *d;
    __syncthreads();                          // earlier writes to vs2 landed
    const uint32_t w = slide_word<SEW>(at(words, vs2), op, r, dst, vl, t);
    __syncthreads();                          // every gather done
    write_vl<SEW>(d, w, dst, vl, t);
    return;
  }
  const uint32_t a = *at(wt, vs2);
  const bool vv = (r.x & kRecVV) != 0;
  const uint32_t v1 = *at(wt, (r.x >> (kRecVs1 - kRecVd)) & kRegBytes);
  const uint32_t b = vv ? v1 : splat<SEW>(r.y);
  const uint32_t dst = *d;
  uint32_t w;
  if ((1u << op) & kLaneOps) {                // lane loops
    if (op == VMUL || op == VMACC) {
      w = vmul<SEW>(a, b);
      if (op == VMACC) w = vadd<SEW>(dst, w);
    } else {
      w = vshift<SEW>(op, a, b);
    }
  } else {
    w = select_op<SEW>(op, a, b, vv, static_cast<int32_t>(r.y));
  }
  write_vl<SEW>(d, w, dst, vl, t);
}

// Chunk c's records, segment by segment, carrying VL across segments; two
// records are loaded ahead, each into its own registers (one record with
// the next loaded ahead took 3-9% more device time on every timed wave).
template <int SEW>
__device__ __forceinline__ void run_chunk(uint32_t* words, const uint4* recs,
                                          const int4* segs, int& vl, int t) {
  uint32_t* wt = words + t;
#pragma unroll 1
  for (int w = 0; w < kWarps; ++w) {
    const int4 seg = segs[w];
    const uint4* rec = recs + w * 32;
    uint4 ra = rec[0], rb = rec[1];
#pragma unroll 1
    for (int k = 0; k < seg.x; k += 2) {
      execute<SEW>(words, wt, ra,
                   (ra.x & kRecCarryVL) ? vl : static_cast<int>(ra.w), t);
      ra = rec[min(k + 2, 31)];
      if (k + 1 == seg.x) break;
      execute<SEW>(words, wt, rb,
                   (rb.x & kRecCarryVL) ? vl : static_cast<int>(rb.w), t);
      rb = rec[min(k + 3, 31)];
    }
    if (seg.y) vl = seg.z;
  }
}

template <int SEW>
__global__ void __launch_bounds__(kThreads)
carus_wave_kernel(const int32_t* __restrict__ f_op,
                  const int32_t* __restrict__ f_vd,
                  const int32_t* __restrict__ f_vs1,
                  const int32_t* __restrict__ f_vs2,
                  const int32_t* __restrict__ f_sval1,
                  const int32_t* __restrict__ f_sval2,
                  const int32_t* __restrict__ f_imm,
                  const int32_t* __restrict__ f_mode,
                  int32_t* __restrict__ vrf, int n_instr) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* words = smem;                                    // [32][256]
  uint4* recs = reinterpret_cast<uint4*>(smem + kVrfWords);  // [2][kChunk]
  int4* segs = reinterpret_cast<int4*>(recs + 2 * kChunk);   // [2][kWarps]
  int32_t* raw = reinterpret_cast<int32_t*>(segs + 2 * kWarps);
  constexpr int kSlot = kFields * kChunk;                    // [2][8][kChunk]
  const int t = threadIdx.x;

  const size_t base = static_cast<size_t>(blockIdx.x) * n_instr;
  const int32_t* field[kFields] = {f_op + base,    f_vd + base,
                                   f_vs1 + base,   f_vs2 + base,
                                   f_sval1 + base, f_sval2 + base,
                                   f_imm + base,   f_mode + base};
  uint4* g = reinterpret_cast<uint4*>(vrf) +
             static_cast<size_t>(blockIdx.x) * (kVrfWords / 4);
  uint4* s = reinterpret_cast<uint4*>(words);

  // groups in order: chunk 0, the image, chunk 1, then one chunk each time
  // a slot is decoded
  stage(raw, field, 0, n_instr, t);
  for (int i = t; i < kVrfWords / 4; i += kThreads) cp_async16(s + i, g + i);
  cp_async_commit();
  stage(raw + kSlot, field, 1, n_instr, t);
  cp_async_wait<2>();                          // chunk 0's fields
  decode<SEW>(raw, recs, segs, 0, n_instr, t);
  stage(raw, field, 2, n_instr, t);

  const int n_chunks = (n_instr + kChunk - 1) / kChunk;
  int vl = Lanes<SEW>::kElems;                 // VLMAX
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<1>();                        // chunk c+1's fields, the image
    __syncthreads();                           // chunk c's records visible
    const int nb = (c + 1) & 1;
    if (c + 1 < n_chunks) {
      decode<SEW>(raw + nb * kSlot, recs + nb * kChunk, segs + nb * kWarps,
                  c + 1, n_instr, t);
      stage(raw + nb * kSlot, field, c + 3, n_instr, t);
    }
    run_chunk<SEW>(words, recs + (c & 1) * kChunk, segs + (c & 1) * kWarps,
                   vl, t);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = t; i < kVrfWords / 4; i += kThreads) g[i] = s[i];
}

template <int SEW>
int launch(const int32_t* const* f, int32_t* vrf, int n_tiles, int n_instr,
           cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      carus_wave_kernel<SEW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  carus_wave_kernel<SEW><<<n_tiles, kThreads, kSmemBytes, st>>>(
      f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], vrf, n_instr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fields: 8 int32 [n_tiles, n_instr] arrays in CARUS_TRACE_DTYPE order (op,
// vd, vs1, vs2, sval1, sval2, imm, mode); vrf: int32 [n_tiles, n_regs,
// reg_words], updated in place.  Returns the CUDA error code of the launch.
extern "C" int carus_wave(const void* op, const void* vd, const void* vs1,
                          const void* vs2, const void* sval1,
                          const void* sval2, const void* imm,
                          const void* mode, void* vrf, int n_tiles,
                          int n_instr, int n_regs, int reg_words, int sew,
                          void* stream) {
  if (n_regs != kRegs || reg_words != kRegWords)
    return static_cast<int>(cudaErrorInvalidValue);
  if (sew != 8 && sew != 16 && sew != 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0 || n_instr == 0) return static_cast<int>(cudaSuccess);
  const int32_t* f[kFields] = {
      static_cast<const int32_t*>(op), static_cast<const int32_t*>(vd),
      static_cast<const int32_t*>(vs1), static_cast<const int32_t*>(vs2),
      static_cast<const int32_t*>(sval1), static_cast<const int32_t*>(sval2),
      static_cast<const int32_t*>(imm), static_cast<const int32_t*>(mode)};
  auto* x = static_cast<int32_t*>(vrf);
  auto st = static_cast<cudaStream_t>(stream);
  switch (sew) {
    case 8: return launch<8>(f, x, n_tiles, n_instr, st);
    case 16: return launch<16>(f, x, n_tiles, n_instr, st);
    default: return launch<32>(f, x, n_tiles, n_instr, st);
  }
}
