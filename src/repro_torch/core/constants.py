"""Hardware constants for the NMC reproduction and the TPU roofline target.

Every number in the `paper` section is lifted directly from the paper
(Caon, Choné et al., "Scalable and RISC-V Programmable Near-Memory Computing
Architectures for Edge Nodes", IEEE TETC) with its provenance recorded, so the
timing/energy models in :mod:`repro_torch.core.timing` / :mod:`repro_torch.core.energy`
are auditable against the publication.
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Paper: physical implementation (Table IV, Section IV)
# ---------------------------------------------------------------------------

TECH_NODE_NM = 65                 # low-power 65 nm CMOS
F_CLK_MAX_HZ = 330e6              # post-layout max clock (Table IV)
F_CLK_BENCH_HZ = 250e6            # frequency used for all benchmarks (Table V)

SRAM_REF_AREA_UM2 = 200e3         # 32 KiB reference SRAM (Table IV)
CAESAR_AREA_UM2 = 256e3           # +28 % (Table IV)
CARUS_AREA_UM2 = 419e3            # +110 % (Table IV)

# Memory geometry (Sections III-A2, III-B2, IV)
CAESAR_MEM_BYTES = 32 * 1024      # 2 x 16 KiB single-port banks
CAESAR_N_BANKS = 2
CARUS_MEM_BYTES = 32 * 1024       # 4 x 8 KiB single-port banks (= VRF)
CARUS_N_LANES = 4                 # one ALU lane per VRF bank
CARUS_N_VREGS = 32                # architectural vector registers (RVV-like)
CARUS_EMEM_BYTES = 512            # eCPU code/data memory (Section IV-B)
WORD_BYTES = 4

# Host-side DMA between main memory and the tiles' SRAM macros: the macros
# hang off a 32-bit system bus and accept one word per bus cycle in memory
# mode (Section III — the tile "behaves as a standard SRAM" when not
# computing), so streaming transfers sustain 4 B/cycle.  This drives the
# DMA legs of the dispatch-pipeline cost model (timing.dispatch_cycles).
DMA_BYTES_PER_CYCLE = 4

# Multi-tile system: the whole tile array hangs off ONE such bus (Fig. 1's
# edge-node topology — N SRAM macros, one interconnect).  Concurrent tiles'
# memory-mode DMA transfers therefore *serialize* on the bus while each
# tile's compute-mode execution proceeds independently — the saturation
# mechanism of the system-level scaling model (timing.wave_cycles): wave
# speedup grows with the tile count until the serialized DMA stream, not
# per-tile compute, binds the makespan.
SYS_BUS_BYTES_PER_CYCLE = DMA_BYTES_PER_CYCLE

# Derived VRF geometry: 32 KiB / 32 regs = 1 KiB per register (VLEN = 8192 b)
CARUS_REG_BYTES = CARUS_MEM_BYTES // CARUS_N_VREGS
CARUS_REG_WORDS = CARUS_REG_BYTES // WORD_BYTES          # 256 words
CARUS_VLMAX = {8: 1024, 16: 512, 32: 256}                # elements per register

# ---------------------------------------------------------------------------
# Paper: microarchitectural timing rules (Sections III-A2, III-B2, V-B)
# ---------------------------------------------------------------------------

# NM-Caesar: multi-cycle SIMD ALU. The partitioned adder and the 4x17-bit
# multiplier array both produce one 32-bit word of results every 2 cycles
# (Section III-A2), independent of element width.
CAESAR_CYCLES_PER_OP = 2          # sustained, operands in different banks
CAESAR_SAME_BANK_CYCLES = 3       # +1 cycle serialized fetch (Section III-A2)
CAESAR_OFFLOAD_CYCLES = 5         # "negligible overhead of five cycles" (V-B1)

# NM-Carus: per-lane *word* timing.  Each lane owns one single-port VRF bank,
# so an instruction's per-word cost is the max of its ALU latency and its
# bank-port occupancy ("the throughput of the arithmetic unit is never lower
# than the slower unit between the ALU and the VRF", Section III-B2):
#
#   cycles/word = max(ALU_WORD_CYCLES[class][sew], port_accesses(op))
#
# ALU word latencies follow Section III-B2: the partitioned adder retires one
# 32-bit word every 2 cycles at any SEW; the 16-bit multiplier produces four
# 8-bit / two 16-bit / one 32-bit results in 4 / 2 / 3 cycles; vmacc adds the
# shared-adder accumulate (fit: Table V/VIII cycle counts — note the paper's
# text quotes 0.33 MAC/cycle at 32-bit while Table VIII implies 0.25; we use
# the table-consistent value, flagged in EXPERIMENTS.md); the serial 8-bit
# barrel shifter and the move/slide unit stream one byte per cycle (4/word).
# Port occupancy counts register-file words touched per result word:
# vv = 3 (2 reads + 1 write), vx/vi = 2, vmacc.vx = 3, vmacc.vv = 4, splat = 1,
# slide = 2.  This model reproduces every Table V Carus cell within ~5 %
# (exactly, for add/mul/relu/leaky/xor — see EXPERIMENTS.md §Paper-validation).
CARUS_ALU_WORD_CYCLES = {
    "add":   {8: 2, 16: 2, 32: 2},
    "logic": {8: 2, 16: 2, 32: 2},
    "mul":   {8: 4, 16: 2, 32: 3},
    "macc":  {8: 4, 16: 3, 32: 4},
    "shift": {8: 4, 16: 4, 32: 4},
    "move":  {8: 4, 16: 4, 32: 4},
}
CARUS_ISSUE_CYCLES = 1            # issue slot when overlapped with eCPU
CARUS_KERNEL_OVERHEAD_CYCLES = 100  # eCPU bootstrap + driver loop (fitted on
                                    # Table V element-wise kernels)
CARUS_ECPU_CPI = 1.3              # CV32E40X-class in-order CPI for scalar code

# RV32IMC CPU baseline: cycles per output element, per kernel and bitwidth
# (Table V, "Cycles/output" rows — these are the paper's own measurements and
# serve as the baseline of every relative claim we reproduce).
CPU_CYCLES_PER_OUTPUT = {
    "xor":        {8: 2.5,   16: 5.0,   32: 10.0},
    "add":        {8: 4.0,   16: 11.0,  32: 10.0},
    "mul":        {8: 11.0,  16: 11.0,  32: 10.0},
    "matmul":     {8: 112.0, 16: 112.0, 32: 89.1},
    "gemm":       {8: 73.1,  16: 81.2,  32: 66.3},
    "conv2d":     {8: 135.0, 16: 133.0, 32: 115.1},
    "relu":       {8: 13.0,  16: 12.0,  32: 10.0},
    "leaky_relu": {8: 12.0,  16: 11.5,  32: 9.5},
    "maxpool":    {8: 64.6,  16: 65.6,  32: 50.3},
}

# CPU baseline energy per output element in pJ (Table V).
CPU_ENERGY_PER_OUTPUT_PJ = {
    "xor":        {8: 61.0,   16: 124.0,  32: 281.0},
    "add":        {8: 99.0,   16: 269.0,  32: 278.0},
    "mul":        {8: 267.0,  16: 285.0,  32: 279.0},
    "matmul":     {8: 2880.0, 16: 3000.0, 32: 2540.0},
    "gemm":       {8: 1910.0, 16: 2260.0, 32: 1950.0},
    "conv2d":     {8: 3300.0, 16: 3400.0, 32: 3100.0},
    "relu":       {8: 344.0,  16: 338.0,  32: 300.0},
    "leaky_relu": {8: 300.0,  16: 295.0,  32: 258.0},
    "maxpool":    {8: 1440.0, 16: 1500.0, 32: 1200.0},
}

# Macro-level energy per 8/16/32-bit MAC in pJ (Table VIII, 65 nm columns).
MACRO_PJ_PER_MAC = {
    "caesar": {8: 16.3, 16: 32.0, 32: 61.8},
    "carus":  {8: 6.8,  16: 12.0, 32: 31.2},
}

# System-level average power model (mW @ 250 MHz, 65 nm typical), calibrated
# on Table V (energy/output = power x cycles/output across all kernels):
#   * CPU-only system: Table V implies 22-27 pJ/cycle, nearly flat across
#     kernels -> constant 6.25 mW ("memory accesses consume approximately as
#     much power as the CPU itself", Fig. 13).
#   * NM-Caesar system: 7.1-7.7 mW, flat — the DMA streams one micro-op per
#     2 cycles from system memory regardless of kernel ("half of [memory
#     power] is used to fetch the kernel micro-instructions", Fig. 13).
#   * NM-Carus system: P = P_FIX + e_VRF x (VRF word-accesses per cycle).
#     Fitting Table V gives P_FIX ~= 6.4 mW and e_VRF ~= 5.4 pJ per 32-bit
#     word access — squarely in the expected range for an 8 KiB 65 nm LP SRAM
#     read, a strong consistency check of the model.
P_CPU_SYS_MW = 6.25
P_CAESAR_SYS_MW = 7.4
P_CARUS_FIX_MW = 6.4
E_CARUS_VRF_ACCESS_PJ = 5.4
# Component split of the fixed terms (Fig. 13 power-breakdown shape):
P_CARUS_FIX_SPLIT_MW = {"host_idle+bus": 1.5, "ecpu": 0.45,
                        "vpu+ctrl": 2.6, "vrf_static": 1.85}
P_CARUS_ECPU_PHASE_MW = 4.9   # eCPU-serial phases (e.g. horizontal pooling)

# Peak figures (Table VII) used as model cross-checks.
CAESAR_PEAK_GOPS = 1.32           # 2 ops x 2 MAC/2cyc x 330 MHz (8-bit DOT)
CARUS_PEAK_GOPS = 2.64            # 2 ops x 4 lanes x 1 MAC/cyc x 330 MHz
CARUS_PEAK_GOPS_W = 306.7         # 8-bit matmul, post-layout
CAESAR_PEAK_GOPS_W = 200.3        # (421.9 without controller power)
VECIM_PEAK_GOPS_W = 289.1         # ISSCC'24 comparison point

# Anomaly-detection end-to-end application (Table VI).
TABLE_VI = {
    # config: (cycle_factor, energy_factor, area_factor) vs 1-core CV32E40P
    "cv32e40p_1c": (1.0, 1.0, 1.0),
    "cv32e40p_2c": (2.0, 1.37, 1.43),
    "cv32e40p_4c": (4.0, 1.67, 2.29),
    "caesar_e20":  (1.29, 1.20, 0.90),
    "carus_e20":   (3.55, 2.36, 1.36),
}
TABLE_VI_BASE_CYCLES = 561e3
TABLE_VI_BASE_ENERGY_UJ = 13.5
TABLE_VI_BASE_AREA_UM2 = 350e3

# ---------------------------------------------------------------------------
# TPU v5e roofline constants (per chip) — the adaptation target.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TpuSpec:
    name: str = "tpu-v5e"
    peak_bf16_flops: float = 197e12     # FLOP/s
    peak_int8_ops: float = 394e12       # OP/s (2x bf16 via int8 MXU)
    hbm_bw: float = 819e9               # B/s
    ici_link_bw: float = 50e9           # B/s per link (roofline: per-chip)
    hbm_bytes: float = 16e9             # 16 GiB HBM per chip
    vmem_bytes: float = 128 * 2**20     # ~128 MiB VMEM
    mxu_dim: int = 128


TPU_V5E = TpuSpec()
