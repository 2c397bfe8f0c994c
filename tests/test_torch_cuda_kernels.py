"""The hand-written CUDA wave kernels against their plain PyTorch versions,
on the card.  Imports no JAX (the card's machine has none); every test
needs a CUDA device, decided inside the ``card`` fixture, and skips
without one.  Run on the card with

    python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from repro_torch import nmc
from repro_torch.core import programs
from repro_torch.core.caesar import CaesarEngine
from repro_torch.core.carus import CarusVPU
from repro_torch.nmc import conformance, cuda_engine
from repro_torch.nmc.program import Program, stack_programs

pytestmark = pytest.mark.gpu
SEWS = (8, 16, 32)
WAVE = {"caesar": (16, 2048), "carus": (16, 256)}     # tiles, instructions


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _tensors(progs, states, device):
    fields = {k: torch.as_tensor(v, device=device)
              for k, v in stack_programs(progs).items()}
    return fields, torch.as_tensor(np.ascontiguousarray(states),
                                   device=device)


def _plain(engine, fields, state, sew):
    if engine == "caesar":
        return CaesarEngine().run_stream(state, fields, sew)[0]
    return CarusVPU().run_trace(state, fields, sew)[0]


def _kernel(engine):
    return cuda_engine.caesar_wave if engine == "caesar" \
        else cuda_engine.carus_wave


@pytest.mark.parametrize("engine", ["caesar", "carus"])
@pytest.mark.parametrize("sew", SEWS)
def test_kernel_equals_plain_on_random_wave(card, engine, sew):
    n_tiles, n_instr = WAVE[engine]
    progs, states = conformance.random_wave(engine, sew, n_tiles, n_instr,
                                            seed=sew)
    fields, state = _tensors(progs, states, card)
    want = _plain(engine, fields, state, sew)
    before = _kernel(engine).launches
    got = _kernel(engine)(fields, state.clone(), sew)
    torch.cuda.synchronize()
    assert _kernel(engine).launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("engine", ["caesar", "carus"])
def test_kernel_equals_plain_on_golden_programs(card, engine):
    for eng, label, entries in conformance.golden_cases():
        if eng != engine:
            continue
        for sew in SEWS:
            prog = Program.from_entries(eng, sew, entries) \
                .pad_to(conformance.CONF_BUCKET)
            fields, state = _tensors(
                [prog], conformance.golden_state(eng, sew)[None], card)
            want = _plain(eng, fields, state, sew)
            got = _kernel(eng)(fields, state.clone(), sew)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (label, sew)


def test_cuda_pools_equal_torch_pools(card):
    kbs = [programs.build(n, sew, caesar_bytes=1024, carus_bytes=1024)
           for n in ("xor", "mul", "relu") for sew in SEWS]
    builds = [getattr(kb, e) for kb in kbs for e in ("caesar", "carus")]
    cuda_pool, torch_pool = (nmc.BucketedPool(backend=b)
                             for b in ("cuda", "torch"))
    got = cuda_pool.run_builds(builds)
    want = torch_pool.run_builds(builds)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert cuda_pool.compiles == torch_pool.compiles
    q = nmc.DispatchQueue(pool=nmc.ResidentPool(backend="cuda"))
    for g, w in zip(q.run_builds(builds, n_tiles=4), want):
        assert np.array_equal(g, w)
    assert q.pool.state(("lane", 0)).is_cuda


def test_wrappers_check_their_inputs(card):
    progs, states = conformance.random_wave("caesar", 8, 2, 16, seed=0)
    fields, state = _tensors(progs, states, card)
    with pytest.raises(TypeError):
        cuda_engine.caesar_wave(fields, state.to(torch.int64), 8)
    with pytest.raises(ValueError):
        cuda_engine.caesar_wave(fields, state[:, :4096], 8)
    with pytest.raises(ValueError):
        cuda_engine.caesar_wave({**fields, "op": fields["op"].cpu()},
                                state, 8)
    with pytest.raises(ValueError):
        cuda_engine.caesar_wave(
            {**fields, "dest": fields["dest"].t().contiguous().t()}, state, 8)
