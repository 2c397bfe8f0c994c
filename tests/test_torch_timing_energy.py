"""The port's cost models (copies of the reference's) give the reference's
numbers exactly: per-program cycles and energy on both engines for every
registry kernel, the per-kernel Table V timing, and the dispatch / wave
pipeline models over the same stages."""

import dataclasses

import jax  # noqa: F401  (the reference package runs on JAX)
import pytest
import torch  # noqa: F401  (both frameworks share the process)

from repro.core import energy as ref_energy
from repro.core import programs as ref_programs
from repro.core import timing as ref_timing
from repro_torch.core import energy, programs, timing

SEWS = (8, 16, 32)
SMALL = {"caesar_bytes": 1024, "carus_bytes": 2048}
REDUCED = {"matmul": {"p": 16}, "gemm": {"p": 16}, "conv2d": {"n": 24, "f": 3},
           "maxpool": {**SMALL, "width": 64},
           "qrelu": {"rows": 4, "row_bytes": 64}}


def _builds(name, sew):
    kw = REDUCED.get(name, SMALL)
    return ref_programs.build(name, sew, **kw), programs.build(name, sew, **kw)


def _same(a, b):
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("sew", SEWS)
@pytest.mark.parametrize(
    "name", programs.ALL_KERNELS + programs.HETERO_KERNELS)
def test_program_cycles_and_energy_equal_reference(name, sew):
    ref_kb, kb = _builds(name, sew)
    for engine in ("caesar", "carus"):
        ref_eb, eb = getattr(ref_kb, engine), getattr(kb, engine)
        if ref_eb is None:
            continue
        _same(timing.program_cycles(eb.program, eb.host_cycles),
              ref_timing.program_cycles(ref_eb.program, ref_eb.host_cycles))
        _same(energy.program_energy(eb.program, eb.host_cycles),
              ref_energy.program_energy(ref_eb.program, ref_eb.host_cycles))
        _same(timing.stage_cost(eb, name), ref_timing.stage_cost(ref_eb, name))
    if name in programs.TABLE_V_KERNELS:
        mine, ref = timing.kernel_timing(kb), ref_timing.kernel_timing(ref_kb)
        assert mine.keys() == ref.keys()
        for k in ref:
            _same(mine[k], ref[k])
        _same(energy.caesar_energy(kb), ref_energy.caesar_energy(ref_kb))
        _same(energy.carus_energy(kb), ref_energy.carus_energy(ref_kb))
        _same(energy.cpu_energy(name, sew, kb.n_outputs),
              ref_energy.cpu_energy(name, sew, ref_kb.n_outputs))


@pytest.mark.parametrize("mode", ["serial", "overlapped"])
def test_dispatch_and_wave_models_equal_reference(mode):
    pairs = [_builds(n, 8) for n in ("xor", "matmul", "conv2d", "relu")]
    mine = [getattr(kb, e) for _, kb in pairs for e in ("caesar", "carus")]
    ref = [getattr(kb, e) for kb, _ in pairs for e in ("caesar", "carus")]
    assert timing.sweep_dispatch_cycles(mine, mode) == \
        ref_timing.sweep_dispatch_cycles(ref, mode)
    stages = [timing.stage_cost(eb) for eb in mine]
    ref_stages = [ref_timing.stage_cost(eb) for eb in ref]
    for n_tiles in (1, 2, 4, 8):
        assert timing.wave_cycles(stages, n_tiles) == \
            ref_timing.wave_cycles(ref_stages, n_tiles)
    assert timing.chained_wave_cycles([stages[:4], stages[4:]], 4) == \
        ref_timing.chained_wave_cycles([ref_stages[:4], ref_stages[4:]], 4)
