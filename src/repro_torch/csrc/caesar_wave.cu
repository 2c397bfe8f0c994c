// NM-Caesar wave executor for Hopper (sm_90a).
//
// Replaces the TPU kernel `_caesar_kernel` / `_caesar_call` in
// src/repro/nmc/pallas_engine.py: one launch runs a wave of T same-bucket
// NM-Caesar programs, each against its own 8192-word (32 KiB) memory image.
//
// What bounds it on this card: not bytes.  Per tile the work is 64 KiB of
// image traffic plus 16 B per instruction, a few microseconds of HBM time
// for a whole wave.  A tile's instructions depend on each other only
// through the words they read and write, so a tile's time is its number of
// windows times the latency of one window on one warp: a fixed part (the
// record, the image reads, round 1, the write-back) plus one round per
// further level of the read-after-write chain inside the window.  Tiles
// run in parallel, one block each.
//
// Design: one block per tile.  Its warps copy the image into shared memory
// (16-byte vectors) and out again.  In between, two warps run the stream
// in windows of kWindow = 32 instructions, one per lane:
//   1. Fields (warp 1).  Lane j of window w takes instruction w*32 + j from
//      a cp.async ring kStages windows deep that each lane fills ahead of
//      itself (a lane reads only what it copied, so no barrier stops the
//      stream).  NOP, CSRW and the tail past n_instr neither read nor write.
//   2. Address analysis, value-free (warp 1, kSlots windows ahead of the
//      executor).  Writers are the ALU ops, MAC_STORE and DOT_STORE.  A
//      table in shared memory holds, for each word, the lane mask of its
//      writers in the window under the window's tag (a tag store, then one
//      atomic OR per writer).  The producer of a source is its highest
//      writer below the reader; the last writer of a word is its highest
//      writer.  With the accumulator segments (below) this goes into a
//      record ring; named barriers hand each slot from warp to warp.
//   3. Rounds (warp 0).  Every lane reads both source words from the image
//      before any write of the window, so write-after-read is safe.  Round
//      1 computes the lanes without producers by selects over the ops
//      present in the window; each later round computes the lanes whose
//      producers are now done (known from __ballot_sync of the done mask),
//      with operands forwarded by __shfl_sync from the producer lanes and
//      one switch on the lane's op.
//   4. Accumulators.  MAC adds packed lane products per lane mod 2^SEW and
//      DOT adds 32-bit sums mod 2^32; both are associative, so they run as
//      inclusive segmented scans by __shfl_up_sync over the window in every
//      round in which an accumulator lane computed (MAC_INIT / DOT_INIT
//      start a segment; the lanes before a window's first INIT add the
//      carry that the previous window left, held in a warp-uniform
//      register).  An accumulator lane is done once every accumulator lane
//      of its segment up to it has computed; MAC_STORE / DOT_STORE lanes
//      then forward like any writer.
//   5. Write-back.  Only the last writer of each word stores it (two stores
//      of one warp instruction to one address leave an unspecified winner),
//      then __syncwarp() before the next window reads.
// The result is the serial one bit for bit: every read sees the image as
// the window found it or the latest earlier writer of the window, the last
// writer wins, and the scans are associative sums mod 2^SEW or 2^32.  The
// worst case, a program whose every instruction reads the one before it,
// takes 32 rounds per window.
//
// Lane arithmetic is unsigned 32-bit (signed overflow is undefined in C++;
// the reference wraps) and lanes are sign-extended by shifts.  ADD, SUB,
// MIN and MAX are the SIMD intrinsics (__vadd4 ... at SEW 8, the ...2 forms
// at SEW 16), DOT at SEW 8 is __dp4a; MUL and the shifts go lane by lane.
// No switch sits inside a lane loop: round 1 selects over the ops present
// in the window (one warp-wide reduction), later rounds switch once on the
// lane's op outside the lane loops.
//
// Addresses are assumed in range [0, 8192) and opcodes valid: the pools
// check every wave's opcodes with repro_torch.nmc.check.assert_wave and its
// addresses on the host before upload (nmc/pool.py, _device_arrays), so
// nothing is clamped here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMemWords = 8192;
constexpr int kWindow = 32;      // instructions per window, one per lane
constexpr int kStages = 8;       // windows of fields in flight (cp.async)
constexpr int kFields = 4;       // op, dest, src1, src2
constexpr int kThreads = 256;    // copy threads; warp 0 executes, warp 1 analyses
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kSlots = 4;        // analysed windows in flight (records)
constexpr int kRecordWords = 8;  // per lane and window
// image (32 KiB), writer table (64 KiB), records (4 KiB), field ring
// (4 KiB): dynamic shared memory
constexpr int kSmemBytes = (3 * kMemWords + kSlots * kWindow * kRecordWords +
                            kStages * kFields * kWindow) * sizeof(uint32_t);

// CaesarOp (src/repro_torch/core/isa.py); checked by the CPU tests.
enum CaesarOpId : int {
  AND = 0, OR = 1, XOR = 2, ADD = 3, SUB = 4, MUL = 5,
  MAC_INIT = 6, MAC = 7, MAC_STORE = 8,
  DOT_INIT = 9, DOT = 10, DOT_STORE = 11,
  SLL = 12, SLR = 13, MIN = 14, MAX = 15, CSRW = 16, SRA = 17, NOP = 18,
};

__host__ __device__ constexpr unsigned bit(int op) { return 1u << op; }
constexpr unsigned kMacOps = bit(MAC_INIT) | bit(MAC) | bit(MAC_STORE);
constexpr unsigned kDotOps = bit(DOT_INIT) | bit(DOT) | bit(DOT_STORE);
constexpr unsigned kWriters =
    bit(AND) | bit(OR) | bit(XOR) | bit(ADD) | bit(SUB) | bit(MUL) |
    bit(MAC_STORE) | bit(DOT_STORE) | bit(SLL) | bit(SLR) | bit(SRA) |
    bit(MIN) | bit(MAX);
constexpr unsigned kShifts = bit(SLL) | bit(SLR) | bit(SRA);

__device__ __forceinline__ int top_lane(unsigned m) { return 31 - __clz(m); }

// ---------------------------------------------------------------------------
// lane arithmetic
// ---------------------------------------------------------------------------

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

template <int SEW>
__device__ __forceinline__ uint32_t vmin(uint32_t a, uint32_t b) {
  if constexpr (SEW == 8) return __vmins4(a, b);
  else if constexpr (SEW == 16) return __vmins2(a, b);
  else return static_cast<uint32_t>(min(static_cast<int32_t>(a),
                                        static_cast<int32_t>(b)));
}

template <int SEW>
__device__ __forceinline__ uint32_t vmax(uint32_t a, uint32_t b) {
  if constexpr (SEW == 8) return __vmaxs4(a, b);
  else if constexpr (SEW == 16) return __vmaxs2(a, b);
  else return static_cast<uint32_t>(max(static_cast<int32_t>(a),
                                        static_cast<int32_t>(b)));
}

// lane products truncated to SEW: also the packed MAC term
template <int SEW>
__device__ __forceinline__ uint32_t vmul(uint32_t a, uint32_t b) {
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 32 / SEW; ++k)
    out |= put<SEW>(static_cast<uint32_t>(lane<SEW>(a, k)) *
                    static_cast<uint32_t>(lane<SEW>(b, k)), k);
  return out;
}

// lane-by-lane shifts of each lane's own kind (amounts mod SEW)
template <int SEW>
__device__ __forceinline__ uint32_t vshift(int op, uint32_t a, uint32_t b) {
  constexpr uint32_t kMask = SEW == 32 ? 0xFFFFFFFFu : ((1u << SEW) - 1u);
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 32 / SEW; ++k) {
    const int32_t x = lane<SEW>(a, k);
    const uint32_t ux = static_cast<uint32_t>(x);
    const uint32_t sh = static_cast<uint32_t>(lane<SEW>(b, k)) & (SEW - 1);
    out |= put<SEW>(op == SLL ? ux << sh
                    : op == SLR ? (ux & kMask) >> sh
                    : static_cast<uint32_t>(x >> sh), k);      // SRA
  }
  return out;
}

// the DOT term: sign-extended lane products summed modulo 2^32
template <int SEW>
__device__ __forceinline__ uint32_t dot_word(uint32_t a, uint32_t b) {
  if constexpr (SEW == 8) {
    return static_cast<uint32_t>(__dp4a(static_cast<int>(a),
                                        static_cast<int>(b), 0));
  } else {
    uint32_t sum = 0;
#pragma unroll
    for (int k = 0; k < 32 / SEW; ++k)
      sum += static_cast<uint32_t>(lane<SEW>(a, k)) *
             static_cast<uint32_t>(lane<SEW>(b, k));
    return sum;
  }
}

// the result of `op` for every lane by selects over the ops present in the
// window (the ALU ops, the MAC ops' lane products and the DOT ops' term)
template <int SEW>
__device__ __forceinline__ uint32_t alu(unsigned present, int op, uint32_t a,
                                        uint32_t b) {
  const unsigned ob = bit(op);
  uint32_t r = (present & (bit(MUL) | kMacOps)) ? vmul<SEW>(a, b) : 0u;
  if (present & bit(AND)) r = op == AND ? a & b : r;
  if (present & bit(OR)) r = op == OR ? a | b : r;
  if (present & bit(XOR)) r = op == XOR ? a ^ b : r;
  if (present & bit(ADD)) r = op == ADD ? vadd<SEW>(a, b) : r;
  if (present & bit(SUB)) r = op == SUB ? vsub<SEW>(a, b) : r;
  if (present & bit(MIN)) r = op == MIN ? vmin<SEW>(a, b) : r;
  if (present & bit(MAX)) r = op == MAX ? vmax<SEW>(a, b) : r;
  if (present & kShifts) r = (ob & kShifts) ? vshift<SEW>(op, a, b) : r;
  if (present & kDotOps) r = (ob & kDotOps) ? dot_word<SEW>(a, b) : r;
  return r;
}

// the same for one lane: one switch outside the lane loops
template <int SEW>
__device__ __forceinline__ uint32_t compute(int op, uint32_t a, uint32_t b) {
  switch (op) {
    case AND: return a & b;
    case OR: return a | b;
    case XOR: return a ^ b;
    case ADD: return vadd<SEW>(a, b);
    case SUB: return vsub<SEW>(a, b);
    case MIN: return vmin<SEW>(a, b);
    case MAX: return vmax<SEW>(a, b);
    case SLL: case SLR: case SRA: return vshift<SEW>(op, a, b);
    case DOT_INIT: case DOT: case DOT_STORE: return dot_word<SEW>(a, b);
    default: return vmul<SEW>(a, b);              // MUL, MAC_INIT .. MAC_STORE
  }
}

// ---------------------------------------------------------------------------
// the field ring
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// lane ln copies its instruction of window w into the window's ring slot
// (zeros past n_instr), then commits one group, empty past the stream
__device__ __forceinline__ void stage(int32_t* ring,
                                      const int32_t* const* field, int w,
                                      int n_instr, int ln) {
  if (w * kWindow < n_instr) {
    const int i = w * kWindow + ln;
    const int ic = min(i, n_instr - 1);
    int32_t* slot = ring + (w % kStages) * kFields * kWindow + ln;
#pragma unroll
    for (int k = 0; k < kFields; ++k)
      cp_async4(slot + k * kWindow, field[k] + ic, i < n_instr ? 4 : 0);
  }
  cp_async_commit();
}

// Named barriers between the two warps, one pair per record slot: "full"
// (the analyser wrote the slot) and "empty" (the executor read it).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(2 * kWindow) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(2 * kWindow)
               : "memory");
}

static_assert(1 + 2 * kSlots <= 16, "a block has 16 named barriers");
__device__ __forceinline__ int full_bar(int slot) { return 1 + slot; }
__device__ __forceinline__ int empty_bar(int slot) { return 1 + kSlots + slot; }

// ---------------------------------------------------------------------------
// warp 1: the value-free analysis of every window, kSlots windows ahead
// ---------------------------------------------------------------------------

__device__ __forceinline__ void analyse(uint64_t* writers, int32_t* ring,
                                        uint4* records,
                                        const int32_t* const* field,
                                        int n_instr, int ln) {
  const unsigned below = (1u << ln) - 1u, upto = below | (1u << ln);
  const int n_windows = (n_instr + kWindow - 1) / kWindow;
  for (int w = 0; w < n_windows; ++w) {
    // 1. fields of window w; then keep kStages - 1 windows in flight
    cp_async_wait<kStages - 2>();
    const int32_t* slot = ring + (w % kStages) * kFields * kWindow + ln;
    int op = slot[0], d = slot[kWindow], s1 = slot[2 * kWindow],
        s2 = slot[3 * kWindow];
    stage(ring, field, w + kStages - 1, n_instr, ln);
    if (w * kWindow + ln >= n_instr) op = NOP;
    const unsigned ob = bit(op);
    const bool writes = ob & kWriters, is_mac = ob & kMacOps,
               is_dot = ob & kDotOps;
    if (!(writes || is_mac || is_dot)) d = s1 = s2 = 0;   // CSRW, NOP, tail

    // 2. each word's writers in the window, as a lane mask under the
    // window's tag; the producer of a source is its highest writer below
    // the reader, the last writer of a word its highest writer
    const uint64_t tag = static_cast<uint64_t>(w) << 32;
    if (writes) writers[d] = tag;
    __syncwarp();
    if (writes) atomicOr(reinterpret_cast<unsigned*>(writers + d), 1u << ln);
    __syncwarp();
    const uint64_t e1 = writers[s1], e2 = writers[s2];
    const bool last = writes &&
        top_lane(static_cast<unsigned>(writers[d])) == ln;
    const unsigned m1 = (e1 >> 32) == static_cast<unsigned>(w)
        ? static_cast<unsigned>(e1) & below : 0u;
    const unsigned m2 = (e2 >> 32) == static_cast<unsigned>(w)
        ? static_cast<unsigned>(e2) & below : 0u;
    const int p1 = m1 ? top_lane(m1) : -1;
    const int p2 = m2 ? top_lane(m2) : -1;

    // accumulator segments: from the latest INIT at or below this lane,
    // else from the window's start with the carry
    const unsigned present = __reduce_or_sync(kFull, ob);
    const unsigned mac_init = __ballot_sync(kFull, op == MAC_INIT) & upto;
    const unsigned dot_init = __ballot_sync(kFull, op == DOT_INIT) & upto;
    const int mac_from = mac_init ? top_lane(mac_init) : 0;
    const int dot_from = dot_init ? top_lane(dot_init) : 0;
    const unsigned mac_seg =
        __ballot_sync(kFull, is_mac) & upto & ~((1u << mac_from) - 1u);
    const unsigned dot_seg =
        __ballot_sync(kFull, is_dot) & upto & ~((1u << dot_from) - 1u);

    // the window's record, once the executor has read the slot's last one
    const int k = w % kSlots;
    if (w >= kSlots) bar_sync(empty_bar(k));
    uint4* rec = records + (k * kWindow + ln) * 2;
    rec[0] = make_uint4(op | last << 8 | (mac_init != 0) << 9 |
                            (dot_init != 0) << 10, d, s1, s2);
    rec[1] = make_uint4((p1 & 0xFF) | (p2 & 0xFF) << 8 | mac_from << 16 |
                            dot_from << 24, mac_seg, dot_seg, present);
    bar_arrive(full_bar(k));
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// warp 0: executes the analysed windows in order
// ---------------------------------------------------------------------------

template <int SEW>
__device__ __forceinline__ void execute(uint32_t* image, const uint4* records,
                                        int n_instr, int ln) {
  const int n_windows = (n_instr + kWindow - 1) / kWindow;
  uint32_t mac = 0, dot = 0;                 // accumulators, warp-uniform
  for (int w = 0; w < n_windows; ++w) {
    const int k = w % kSlots;
    bar_sync(full_bar(k));
    const uint4* rec = records + (k * kWindow + ln) * 2;
    const uint4 r0 = rec[0], r1 = rec[1];
    if (w + kSlots < n_windows) bar_arrive(empty_bar(k));
    const int op = r0.x & 0xFF;
    const int d = r0.y;
    const bool last = (r0.x >> 8) & 1u, mac_carry = !((r0.x >> 9) & 1u),
               dot_carry = !((r0.x >> 10) & 1u);
    const int p1 = static_cast<int8_t>(r1.x & 0xFF);
    const int p2 = static_cast<int8_t>((r1.x >> 8) & 0xFF);
    const int mac_from = (r1.x >> 16) & 0xFF, dot_from = r1.x >> 24;
    const unsigned mac_seg = r1.y, dot_seg = r1.z, present = r1.w;
    const unsigned ob = bit(op);
    const bool is_mac = ob & kMacOps, is_dot = ob & kDotOps,
               acc = is_mac || is_dot, active = (ob & kWriters) || acc;
    const uint32_t x1 = image[r0.z], x2 = image[r0.w];  // as the window found it

    // 3. rounds.  `got`: lanes that have computed (inactive lanes count);
    // `done`: lanes whose result is final.  A lane computes once its
    // producers are done; an accumulator lane is done once every lane of
    // its segment up to it has computed.
    const unsigned accs = __ballot_sync(kFull, acc);
    const unsigned need = (p1 < 0 ? 0u : 1u << p1) | (p2 < 0 ? 0u : 1u << p2);
    bool taken = !active || !need;                   // round 1: no producer
    uint32_t term = alu<SEW>(present, op, x1, x2);   // result, or acc term
    uint32_t res = term;                             // what later lanes read
    unsigned got = __ballot_sync(kFull, taken);
    unsigned done = got & ~accs;
    unsigned took = got & __ballot_sync(kFull, active);
    uint32_t mac_next = mac, dot_next = dot;
    // 4. inclusive segmented scans of the accumulator terms over the window,
    // run again in every round in which an accumulator lane computed
    auto scan = [&]() {
      uint32_t ms = is_mac ? term : 0u, ds = is_dot ? term : 0u;
#pragma unroll
      for (int j = 1; j < kWindow; j <<= 1) {
        const uint32_t mu = __shfl_up_sync(kFull, ms, j);
        const uint32_t du = __shfl_up_sync(kFull, ds, j);
        if (ln - j >= mac_from) ms = vadd<SEW>(ms, mu);
        if (ln - j >= dot_from) ds += du;               // mod 2^32
      }
      if (mac_carry) ms = vadd<SEW>(ms, mac);
      if (dot_carry) ds += dot;
      mac_next = __shfl_sync(kFull, ms, kWindow - 1);
      dot_next = __shfl_sync(kFull, ds, kWindow - 1);
      const bool fin = is_mac ? !(~got & mac_seg) : is_dot && !(~got & dot_seg);
      if (fin && op == MAC_STORE) res = ms;
      if (fin && op == DOT_STORE) res = ds;             // the scalar, one word
      done |= __ballot_sync(kFull, fin);
    };
    if (took & accs) scan();
    while (done != kFull) {                // the lanes whose producers are done
      const bool take = !taken && !(need & ~done);
      took = __ballot_sync(kFull, take);
      const uint32_t f1 = __shfl_sync(kFull, res, p1 & 31);
      const uint32_t f2 = __shfl_sync(kFull, res, p2 & 31);
      if (take) {
        term = compute<SEW>(op, p1 < 0 ? x1 : f1, p2 < 0 ? x2 : f2);
        if (!acc) res = term;
        taken = true;
      }
      got |= took;
      done |= took & ~accs;
      if (took & accs) scan();
    }
    mac = mac_next;
    dot = dot_next;

    // 5. write-back by the last writer of each word
    if (last) image[d] = res;
    __syncwarp();
  }
}

template <int SEW>
__global__ void __launch_bounds__(kThreads)
caesar_wave_kernel(const int32_t* __restrict__ op,
                   const int32_t* __restrict__ dest,
                   const int32_t* __restrict__ src1,
                   const int32_t* __restrict__ src2,
                   int32_t* __restrict__ mem, int n_instr) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* image = smem;
  uint64_t* writers = reinterpret_cast<uint64_t*>(smem + kMemWords);
  uint4* records = reinterpret_cast<uint4*>(smem + 3 * kMemWords);
  int32_t* ring = reinterpret_cast<int32_t*>(
      smem + 3 * kMemWords + kSlots * kWindow * kRecordWords);

  const size_t base = static_cast<size_t>(blockIdx.x) * n_instr;
  const int32_t* field[kFields] = {op + base, dest + base, src1 + base,
                                   src2 + base};
  const int warp = threadIdx.x / kWindow, ln = threadIdx.x % kWindow;
  if (warp == 1) {                     // the ring fills while the image lands
#pragma unroll
    for (int w = 0; w < kStages - 1; ++w) stage(ring, field, w, n_instr, ln);
  }
  uint4* g = reinterpret_cast<uint4*>(mem) +
             static_cast<size_t>(blockIdx.x) * (kMemWords / 4);
  uint4* s = reinterpret_cast<uint4*>(image);
  for (int i = threadIdx.x; i < kMemWords / 4; i += blockDim.x) s[i] = g[i];
  int4* tags = reinterpret_cast<int4*>(writers);     // no window's tag: -1
  for (int i = threadIdx.x; i < kMemWords / 2; i += blockDim.x)
    tags[i] = make_int4(0, -1, 0, -1);
  __syncthreads();
  if (warp == 0) execute<SEW>(image, records, n_instr, ln);
  if (warp == 1) analyse(writers, ring, records, field, n_instr, ln);
  __syncthreads();
  for (int i = threadIdx.x; i < kMemWords / 4; i += blockDim.x) g[i] = s[i];
}

template <int SEW>
int launch(const int32_t* o, const int32_t* d, const int32_t* a,
           const int32_t* b, int32_t* m, int n_tiles, int n_instr,
           cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      caesar_wave_kernel<SEW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  caesar_wave_kernel<SEW><<<n_tiles, kThreads, kSmemBytes, st>>>(
      o, d, a, b, m, n_instr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// op/dest/src1/src2: int32 [n_tiles, n_instr]; mem: int32 [n_tiles, 8192],
// updated in place.  Returns the CUDA error code of the launch.
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
    case 8: return launch<8>(o, d, a, b, m, n_tiles, n_instr, st);
    case 16: return launch<16>(o, d, a, b, m, n_tiles, n_instr, st);
    case 32: return launch<32>(o, d, a, b, m, n_tiles, n_instr, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
