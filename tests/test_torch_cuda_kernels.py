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


# ---------------------------------------------------------------------------
# The LM-layer kernels: nmc_matmul and flash_attention against their plain
# versions at the serving path's shapes (tolerances in kernels/checks.py)
# ---------------------------------------------------------------------------

from repro_torch.kernels import checks  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import nmc_matmul as mm  # noqa: E402


@pytest.mark.parametrize("m", checks.MATMUL_M)
@pytest.mark.parametrize("k,n", checks.MATMUL_KN)
def test_nmc_matmul_equals_plain_at_serving_shapes(card, m, k, n):
    before = mm.nmc_matmul.launches
    errs = checks.check_matmul(m, k, n, card)
    torch.cuda.synchronize()
    assert errs["acc"] == 0 and errs["none/f32"] == 0
    assert mm.nmc_matmul.launches == before + 9


@pytest.mark.parametrize("m,k,n", checks.MATMUL_RAGGED)
def test_nmc_matmul_equals_plain_at_ragged_shapes(card, m, k, n):
    checks.check_matmul(m, k, n, card)


def test_nmc_matmul_exact_worst_case_accumulator(card):
    k = 2816
    x = torch.full((4, k), -128, dtype=torch.int8, device=card)
    w = torch.full((k, 64), -128, dtype=torch.int8, device=card)
    acc = mm.nmc_matmul(x, w, None, out_dtype=torch.int32)
    assert int(acc[0, 0]) == 128 * 128 * k and bool((acc == acc[0, 0]).all())


@pytest.mark.parametrize("name", sorted(checks.ATTENTION_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_equals_plain(card, name, dtype):
    before = fa.flash_attention.launches
    checks.check_attention(name, dtype, card)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1


def test_lm_kernel_wrappers_check_their_inputs(card):
    x, w, scale, bias = checks.matmul_inputs(4, 64, 32, card)
    with pytest.raises(TypeError):
        mm.nmc_matmul(x.float(), w, scale)
    with pytest.raises(ValueError):
        mm.nmc_matmul(x, w[:32], scale)
    with pytest.raises(ValueError):
        mm.nmc_matmul(x, w.t().contiguous().t(), scale)
    with pytest.raises(ValueError):
        mm.nmc_matmul(x, w, scale, act="tanh")
    with pytest.raises(ValueError):
        mm.nmc_matmul(x, w, scale, out_dtype=torch.int32)
    q, k, v = checks.attention_inputs(checks.ATTENTION_CASES["qwen-128"],
                                      torch.float32, card)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :5], v[:, :5])
