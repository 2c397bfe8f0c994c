"""Energy models for the HEEPerator-style system (CPU / NM-Caesar / NM-Carus).

Calibration strategy (documented in DESIGN.md §3.3): we cannot run the
paper's post-layout PrimePower flow, so the component powers in
:mod:`repro_torch.core.constants` are *fitted once* on Table V (system level) and
then validated against the paper's independent claims: Table VIII pJ/MAC,
Fig. 12 energy saturation (66 pJ/output @8-bit matmul), Fig. 13 power
breakdown shape, and the Table VII peak GOPS/W figures.

Model:
  * CPU system:     E = P_CPU_SYS x t                  (flat ~6.25 mW)
  * NM-Caesar sys:  E = P_CAESAR_SYS x t               (flat ~7.4 mW; the
                    1-op/2-cycle DMA instruction stream keeps the system
                    memory active at a constant rate)
  * NM-Carus sys:   E = P_CARUS_FIX x t + e_VRF x (VRF word accesses)
  * host/eCPU-serial phases (horizontal pooling): P_CPU_SYS / P_ECPU_PHASE.

Both engines are costed through :func:`program_energy` on the unified
program IR (DESIGN.md §5); the per-engine ``caesar_energy`` / ``carus_energy``
helpers are wrappers that pull the IR out of a KernelBuild.

Padding NOPs (the bucketed scheduler's instruction-stream filler,
``repro_torch.nmc.pool``) are zero-energy by construction: they contribute no
cycles in :mod:`repro_torch.core.timing` and no VRF accesses, so a NOP-padded
program costs exactly what the unpadded program costs (property-tested in
``tests/test_nmc_ir.py``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import constants as C
from repro_torch.core import timing as T
from repro_torch.nmc.program import Program


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    energy_pj: float
    avg_power_mw: float
    detail: dict

    def per_output_pj(self, n_outputs: int) -> float:
        return self.energy_pj / n_outputs


def _mw_cycles_to_pj(p_mw: float, cycles: float,
                     f_hz: float = C.F_CLK_BENCH_HZ) -> float:
    return p_mw * 1e-3 * (cycles / f_hz) * 1e12


def cpu_energy(kernel: str, sew: int, n_outputs: int) -> EnergyReport:
    """CPU baseline straight from Table V measurements."""
    e = C.CPU_ENERGY_PER_OUTPUT_PJ[kernel][sew] * n_outputs
    cyc = C.CPU_CYCLES_PER_OUTPUT[kernel][sew] * n_outputs
    p = e / (cyc / C.F_CLK_BENCH_HZ) * 1e-9 if cyc else 0.0
    return EnergyReport(e, p, {"model": "table_v"})


# ---------------------------------------------------------------------------
# Unified IR costing
# ---------------------------------------------------------------------------

def program_energy(prog: Program, host_cycles: float = 0.0) -> EnergyReport:
    """System-level energy of one NMC program (either engine)."""
    tr = T.program_cycles(prog, host_cycles)
    if prog.engine == "caesar":
        e_nmc = _mw_cycles_to_pj(C.P_CAESAR_SYS_MW, tr.cycles)
        e_host = _mw_cycles_to_pj(C.P_CPU_SYS_MW, tr.host_cycles)
        e = e_nmc + e_host
        detail = {"nmc_pj": e_nmc, "host_pj": e_host}
    else:
        acc = T.program_vrf_accesses(prog)
        e_fix = _mw_cycles_to_pj(C.P_CARUS_FIX_MW, tr.cycles)
        e_vrf = acc * C.E_CARUS_VRF_ACCESS_PJ
        e_host = _mw_cycles_to_pj(C.P_CARUS_ECPU_PHASE_MW, tr.host_cycles)
        e = e_fix + e_vrf + e_host
        detail = {"fix_pj": e_fix, "vrf_pj": e_vrf, "host_pj": e_host,
                  "vrf_accesses": acc}
    p = e / (tr.total_cycles / C.F_CLK_BENCH_HZ) * 1e-9
    return EnergyReport(e, p, detail)


def _prog(kb, engine: str) -> tuple[Program, float]:
    eb = getattr(kb, engine)
    return eb.program.with_sew(kb.sew), eb.host_cycles


def caesar_energy(kb) -> EnergyReport:
    return program_energy(*_prog(kb, "caesar"))


def carus_energy(kb) -> EnergyReport:
    return program_energy(*_prog(kb, "carus"))


def carus_macro_energy_pj(kb) -> float:
    """Macro-only energy (Table VIII / peak-GOPS/W comparisons): excludes the
    host-idle + bus share of the fixed power."""
    prog, host_cycles = _prog(kb, "carus")
    tr = T.program_cycles(prog, host_cycles)
    acc = T.program_vrf_accesses(prog)
    p_macro = C.P_CARUS_FIX_MW - C.P_CARUS_FIX_SPLIT_MW["host_idle+bus"]
    return _mw_cycles_to_pj(p_macro, tr.cycles) + acc * C.E_CARUS_VRF_ACCESS_PJ


def caesar_macro_energy_pj(kb) -> float:
    """NM-Caesar energy for macro-level comparisons (Table VIII): system
    minus the idle host CPU — the instruction stream fetch IS part of
    operating the macro (it has no controller of its own)."""
    prog, host_cycles = _prog(kb, "caesar")
    tr = T.program_cycles(prog, host_cycles)
    return _mw_cycles_to_pj(C.P_CAESAR_SYS_MW - 0.35, tr.cycles)


def kernel_energy(kb) -> dict[str, EnergyReport]:
    return {
        "cpu": cpu_energy(kb.name, kb.sew, kb.n_outputs),
        "caesar": caesar_energy(kb),
        "carus": carus_energy(kb),
    }


def power_breakdown_mw(engine: str, access_rate_per_cycle: float = 0.0) -> dict:
    """Average power split (Fig. 13 reproduction)."""
    if engine == "cpu":
        return {"host_cpu": 2.9, "system_mem": 2.9, "bus_other": 0.45}
    if engine == "caesar":
        # half the memory power fetches the micro-instruction stream (Fig. 13)
        return {"host_cpu": 0.35, "instr_fetch": 1.65, "system_mem": 1.65,
                "bus_other": 0.45, "nmc_logic": 1.25, "nmc_mem": 2.05}
    if engine == "carus":
        vrf_dyn = access_rate_per_cycle * C.E_CARUS_VRF_ACCESS_PJ * \
            C.F_CLK_BENCH_HZ * 1e-9
        s = C.P_CARUS_FIX_SPLIT_MW
        return {"host_cpu+bus": s["host_idle+bus"], "ecpu": s["ecpu"],
                "vpu+ctrl": s["vpu+ctrl"],
                "vrf": s["vrf_static"] + vrf_dyn}
    raise KeyError(engine)
