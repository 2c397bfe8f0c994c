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
from repro_torch.nmc.program import PROG_DTYPE, Program, stack_programs

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


def _equals_plain(engine, progs, states, sew, card):
    fields, state = _tensors(progs, states, card)
    want = _plain(engine, fields, state, sew)
    got = _kernel(engine)(fields, state.clone(), sew)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_words", [8, 32])
@pytest.mark.parametrize("sew", SEWS)
def test_caesar_equals_plain_on_conflict_dense_waves(card, sew, n_words):
    """Addresses from a few words: deep read-after-write chains, many
    writers of one word and write-after-read pairs in every window."""
    progs, states = conformance.random_wave("caesar", sew, 16, 1024,
                                            seed=sew, n_words=n_words)
    _equals_plain("caesar", progs, states, sew, card)


@pytest.mark.parametrize("sew", SEWS)
def test_caesar_equals_plain_on_the_serial_chain(card, sew):
    progs, states = conformance.chain_wave(sew, 16, 1024, seed=sew)
    _equals_plain("caesar", progs, states, sew, card)


@pytest.mark.parametrize("sew", SEWS)
def test_caesar_equals_plain_when_all_lanes_write_one_word(card, sew):
    """Every lane of every window writes word 5 (reading it and its
    neighbours); the last writer must win."""
    rng = np.random.default_rng(sew)
    alu = [int(o) for o in conformance.CAESAR_ALU_OPS]
    progs = []
    for _ in range(4):
        entries = np.zeros(256, dtype=PROG_DTYPE)
        entries["op"] = rng.choice(alu, 256)
        entries["dest"] = 5
        entries["src1"] = rng.integers(4, 7, 256)
        entries["src2"] = rng.integers(4, 7, 256)
        progs.append(Program.from_entries("caesar", sew, entries))
    states = rng.integers(-2**31, 2**31, (4, conformance.CAESAR_MEM_WORDS),
                          dtype=np.int64).astype(np.int32)
    _equals_plain("caesar", progs, states, sew, card)


@pytest.mark.parametrize("n_instr", [1, 31, 33, 1001])
@pytest.mark.parametrize("sew", SEWS)
def test_caesar_equals_plain_off_the_window(card, sew, n_instr):
    progs, states = conformance.random_wave("caesar", sew, 8, n_instr,
                                            seed=n_instr, n_words=16)
    _equals_plain("caesar", progs, states, sew, card)


@pytest.mark.parametrize("sew", SEWS)
def test_carus_equals_plain_on_slide_dense_waves(card, sew):
    """Every other op a slide, half of them in place (vd == vs2), with
    VSETVLs to negative (down to -2**31), partial and oversized lengths
    between them."""
    progs, states = conformance.slide_wave(sew, 16, 256, seed=sew)
    _equals_plain("carus", progs, states, sew, card)


@pytest.mark.parametrize("n_instr", [257, 700, 1024])
@pytest.mark.parametrize("sew", SEWS)
def test_carus_equals_plain_beyond_one_chunk(card, sew, n_instr):
    """Traces of several decode chunks: VL carried across them, random and
    slide-dense."""
    progs, states = conformance.random_wave("carus", sew, 8, n_instr,
                                            seed=n_instr + sew)
    _equals_plain("carus", progs, states, sew, card)
    progs, states = conformance.slide_wave(sew, 8, n_instr, seed=sew)
    _equals_plain("carus", progs, states, sew, card)


@pytest.mark.parametrize("engine", ["caesar", "carus"])
def test_empty_waves_launch_nothing(card, engine):
    """No tiles (and, for Carus, no instructions): the image stays as it
    was and the launch counter does not move."""
    progs, states = conformance.random_wave(engine, 8, 2, 16, seed=0)
    fields, state = _tensors(progs, states, card)
    cases = [({k: v[:0] for k, v in fields.items()}, state[:0])]
    if engine == "carus":
        cases.append(({k: v[:, :0].contiguous() for k, v in fields.items()},
                      state))
    for f, st in cases:
        before, want = _kernel(engine).launches, st.clone()
        got = _kernel(engine)(f, st, 8)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert _kernel(engine).launches == before


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
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import vrf_alu as vrf  # noqa: E402


def _check_matmul_route(m, k, n, card, want):
    """check_matmul at one shape; its 9 launches all on route ``want``."""
    assert mm.route(k, n) == want
    before = dict(mm.nmc_matmul.launches_by_route)
    errs = checks.check_matmul(m, k, n, card)
    torch.cuda.synchronize()
    assert mm.nmc_matmul.launches_by_route == {
        r: c + 9 * (r == want) for r, c in before.items()}
    return errs


@pytest.mark.parametrize("m", checks.MATMUL_M)
@pytest.mark.parametrize("k,n", checks.SERVING_MATMUL_KN)
def test_nmc_matmul_equals_plain_at_serving_shapes(card, m, k, n):
    """On the tensor cores, but whisper-tiny's LM head on dp4a."""
    before = mm.nmc_matmul.launches
    errs = _check_matmul_route(m, k, n, card, checks.serving_route(k, n))
    assert errs["acc"] == 0 and errs["none/f32"] == 0
    assert mm.nmc_matmul.launches == before + 9


@pytest.mark.parametrize("m,k,n", [
    (checks.WHISPER_PREFILL_M, k, n) for k, n in checks.WHISPER_MATMUL_KN]
    + [(checks.WHISPER_ENCODER_M, k, n) for k, n in
       checks.WHISPER_ENCODER_KN])
def test_nmc_matmul_equals_plain_at_whisper_prefill_rows(card, m, k, n):
    """whisper-tiny's projections at its decoder's prefill rows (4 x 64)
    and its encoder's (4 x 1500), the gelu epilogue among the checked
    activations."""
    errs = _check_matmul_route(m, k, n, card, checks.serving_route(k, n))
    assert errs["acc"] == 0 and errs["none/f32"] == 0


@pytest.mark.parametrize("k,n", checks.VLM_MATMUL_KN)
def test_nmc_matmul_equals_plain_at_vlm_prefill_rows(card, k, n):
    """pixtral-12b's projections at its prefill rows (4 x 1152)."""
    errs = _check_matmul_route(checks.VLM_PREFILL_M, k, n, card,
                               "tensor_core")
    assert errs["acc"] == 0 and errs["none/f32"] == 0


@pytest.mark.parametrize("m,k,n", checks.MATMUL_RAGGED)
def test_nmc_matmul_equals_plain_at_ragged_shapes(card, m, k, n):
    _check_matmul_route(m, k, n, card, "dp4a")


@pytest.mark.parametrize("m,k,n", checks.MATMUL_EDGES)
def test_nmc_matmul_equals_plain_at_edge_shapes(card, m, k, n):
    """The tensor-core kernel's edges (M = 16 / 17, split K with a partial
    last slab, partial tiles, K = 32) and N = 8 / 136 on the dp4a route."""
    errs = _check_matmul_route(m, k, n, card, mm.route(k, n))
    assert errs["acc"] == 0 and errs["none/f32"] == 0


@pytest.mark.parametrize("m,k,n", [(4, 2816, 64), (4, 2816, 1024),
                                   (384, 2816, 1024)])
def test_nmc_matmul_exact_worst_case_accumulator(card, m, k, n):
    """All -128: the int32 sums at their extreme, through split K on both
    tiles."""
    assert mm.plan(m, n, k)[2] > 1
    x = torch.full((m, k), -128, dtype=torch.int8, device=card)
    w = torch.full((k, n), -128, dtype=torch.int8, device=card)
    acc = mm.nmc_matmul(x, w, None, out_dtype=torch.int32)
    assert int(acc[0, 0]) == 128 * 128 * k and bool((acc == acc[0, 0]).all())


def test_nmc_matmul_unaligned_input_takes_the_dp4a_route(card):
    x, w, scale, bias = checks.matmul_inputs(4, 1024, 1024, card)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)
    shifted[1:] = x.flatten()
    before = dict(mm.nmc_matmul.launches_by_route)
    got = mm.nmc_matmul(shifted[1:].view(x.shape), w, scale, bias)
    assert mm.nmc_matmul.launches_by_route["dp4a"] == before["dp4a"] + 1
    assert torch.equal(got, ref.nmc_matmul(x, w, scale, bias))


@pytest.mark.parametrize("name", sorted(checks.ATTENTION_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_equals_plain(card, name, dtype):
    """Every case within its tolerance, through the route it should take:
    each bf16 case with head dims up to 128 on the tensor cores."""
    kind = checks.attention_route(name, dtype)
    if dtype == torch.bfloat16 and name not in checks.HEAD_DIM_OVER_128:
        assert kind == "tensor_core"
    before = fa.flash_attention.launches
    by_route = dict(fa.flash_attention.launches_by_route)
    checks.check_attention(name, dtype, card)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert fa.flash_attention.launches_by_route == {
        r: n + (r == kind) for r, n in by_route.items()}


@pytest.mark.parametrize("name", checks.ATTENTION_GRAD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_gradient_through_the_kernel_equals_plain(card, name,
                                                            dtype):
    """``ops.attention``'s dq, dk, dv on the card, through the kernel inside
    its autograd Function, against autograd of the plain version: bf16 at
    D 64 on the tensor cores (the training shape among them), f32 on the
    CUDA cores."""
    by_route = dict(fa.flash_attention.launches_by_route)
    errs = checks.check_attention_grad(name, dtype, card)
    torch.cuda.synchronize()
    kind = checks.attention_route(name, dtype)
    assert fa.flash_attention.launches_by_route == {
        r: n + (r == kind) for r, n in by_route.items()}
    if name == "qwen-train-512":
        assert (kind == "tensor_core") == (dtype == torch.bfloat16)
    assert set(errs) == {"dq", "dk", "dv"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_partials_over_split_frames_combine_on_the_card(card,
                                                                   dtype):
    """whisper-tiny's cross-attention at decode over a frame-split cache:
    each half of the 1500 frames through the kernel with its log-sum-exp
    (``ops.attention_partial``, one launch each), the halves combined by
    ``ops.combine_partials``, against the kernel over every frame within
    the attention tolerance."""
    from repro_torch.kernels import ops
    case = dict(checks.ATTENTION_CASES["whisper-cross-decode"])
    q, k, v = checks.attention_inputs(case, dtype, card)
    half = case["skv"] // 2
    before = fa.flash_attention.launches
    parts = [ops.attention_partial(q, k[:, :, lo:lo + half],
                                   v[:, :, lo:lo + half], causal=False)
             for lo in (0, half)]
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    assert all(lse.dtype == torch.float32 for _, lse in parts)
    o, lse = (torch.stack(t) for t in zip(*parts))
    got = ops.combine_partials(
        o, lse, lambda t: t.amax(0, keepdim=True).expand_as(t),
        lambda t: t.sum(0, keepdim=True).expand_as(t))[0]
    want = fa.flash_attention(q, k, v, causal=False)
    checks.close(f"attention partials {dtype}", got, want,
                 *checks.attention_tolerance(dtype))


def test_flash_attention_tensor_core_route_needs_aligned_inputs(card):
    q, k, v = checks.attention_inputs(checks.ATTENTION_CASES["qwen-64"],
                                      torch.bfloat16, card)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)
    shifted[1:] = q.flatten()
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(shifted[1:].view(q.shape), k, v)


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


def test_vrf_alu_equals_plain(card):
    """Every ``vrf_alu`` case of kernels/checks.py (both demo programs,
    every op in both modes, the wrap extremes, at int8 / int16 / int32 on
    a block-multiple and a ragged VL, and random programs) bit for bit."""
    before = vrf.vrf_alu.launches
    cases = checks.vrf_cases(n_random=20)
    for label, f, entries in cases:
        assert checks.check_vrf_alu(f, entries, card) == 0, label
    torch.cuda.synchronize()
    assert vrf.vrf_alu.launches - before == len(cases)


def test_vrf_alu_wrapper_checks_its_inputs(card):
    prog = vrf.make_prog(checks.VRF_DEMO_PROGRAMS["leaky_relu"])
    file = torch.zeros((8, 300), dtype=torch.int16, device=card)
    with pytest.raises(TypeError):
        vrf.vrf_alu(file.float(), prog)
    with pytest.raises(ValueError):
        vrf.vrf_alu(file.t(), prog)
    with pytest.raises(ValueError, match="register"):
        vrf.vrf_alu(file, vrf.make_prog([("add", 8, 0, 1, 0, 0)]))
    got = vrf.vrf_alu(file, prog.to(card))
    assert got is file


#: the labels of kernels/checks.py's vrf_alu edge cases (made from a seed)
VRF_EDGE = [c[0] for c in checks.vrf_edge_cases()]


@pytest.mark.parametrize("label", VRF_EDGE)
def test_vrf_alu_edge_cases_equal_plain(card, label):
    """Rows not 16-byte aligned, a view at an odd element offset, programs
    longer or wider than one launch holds (launch counts asserted), vv
    shifts with per-lane amounts at every width, an empty program and VL 0
    (no launch), bit for bit and nothing written outside the file; the
    misaligned files take the ragged instance, the others the aligned."""
    case = next(c for c in checks.vrf_edge_cases() if c[0] == label)
    routes = dict(vrf.vrf_alu.launches_by_route)
    assert checks.check_vrf_case(case, card) == 0
    torch.cuda.synchronize()
    got = {r: vrf.vrf_alu.launches_by_route[r] - routes[r] for r in routes}
    misaligned = label.startswith(("ragged-rows", "offset"))
    assert got == {"ragged": case[4] if misaligned else 0,
                   "aligned": 0 if misaligned else case[4]}
