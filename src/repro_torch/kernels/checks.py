"""The Layer B kernels against their plain versions, at the serving path's
shapes (``nmc_matmul``, ``flash_attention``) and on the kernels demo's
programs and more (``vrf_alu``), with the tolerances stated.

Shared by ``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``: each
check makes its inputs from a seed on the given device, runs the kernel
wrapper and the plain version on the same tensors, raises
``AssertionError`` on a result outside the tolerance, and returns the
largest absolute differences.  On the card the wrappers launch the CUDA
kernels; the launches made here are comparisons, not the main path.

Tolerances:
  * ``nmc_matmul``: the int32 accumulator equal bit for bit; float32 out
    equal for act none/relu (the epilogue rounds a product, then a sum, as
    the plain version does) and within rtol 1e-5 / atol 1e-4 for silu/gelu
    (``expf`` / ``tanhf`` against PyTorch's); bfloat16 out equal for
    none/relu and within one bf16 ulp (rtol 2^-7) for silu/gelu.
  * ``flash_attention``: float32 within atol 2e-5 of ``chunked_attention``
    (the tolerance of the reference's kernel tests: another summation
    order); bfloat16 within atol 1e-2 / rtol 1.6e-2 (one bf16 ulp of the
    output).  Its optional log-sum-exp (float32 in both) within atol 1e-4
    / rtol 1e-5: float32 sums in another order, the tensor-core route's
    ``exp2`` approximation.
  * ``vrf_alu``: equal bit for bit (integer programs).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import nmc_matmul as _mm
from repro_torch.kernels import ref
from repro_torch.kernels import vrf_alu as _vrf

#: decode (1 and 4 slots) and prefill row counts of the serving path
MATMUL_M = (1, 4, 384)
#: qwen1.5-0.5B's projections: q/k/v/o, up/gate, down, the LM head
MATMUL_KN = ((1024, 1024), (1024, 2816), (2816, 1024), (1024, 151936))
#: moonshot-v1-16b-a3b's: q/k/v/o, the shared experts' up/gate and down
#: (2 x 1408 wide), the LM head (its routed experts are not nmc_matmul)
MOE_MATMUL_KN = ((2048, 2048), (2048, 2816), (2816, 2048), (2048, 163840))
#: deepseek-v2-lite-16b's: MLA's wq (16 x 192), w_dkv (kv_lora_rank 512),
#: w_krope (64), w_uk / w_uv (512 -> 16 x 128) and wo; the first dense
#: layer's up/gate and down (10944); the shared experts' up/gate and down
#: (2 x 1408); the LM head
MLA_MATMUL_KN = ((2048, 3072), (2048, 512), (2048, 64), (512, 2048),
                 (2048, 2048), (2048, 10944), (10944, 2048), (2048, 2816),
                 (2816, 2048), (2048, 102400))
#: pixtral-12b's: q (32 x 128), k/v (8 x 128), up/gate, img_proj, o, down,
#: the LM head
VLM_MATMUL_KN = ((5120, 4096), (5120, 1024), (5120, 14336), (5120, 5120),
                 (4096, 5120), (14336, 5120), (5120, 131072))
#: whisper-tiny's: q/k/v/o (6 x 64), the gelu MLP's up and down, the LM
#: head (N = 51865, not a multiple of 16: the ``dp4a`` route)
WHISPER_MATMUL_KN = ((384, 384), (384, 1536), (1536, 384), (384, 51865))
#: zamba2-2.7b's shared block: q/k/v/o (32 x 80), up/gate, down; the LM
#: head (its Mamba2 projections stay float and are not nmc_matmul)
HYBRID_MATMUL_KN = ((2560, 2560), (2560, 10240), (10240, 2560),
                    (2560, 32000))
#: xlstm-125m's LM head, its only ``nmc_matmul`` (its blocks stay float)
XLSTM_MATMUL_KN = ((768, 50304),)
#: the (K, N) of every served model's projections, each once
SERVING_MATMUL_KN = tuple(dict.fromkeys(
    MATMUL_KN + MOE_MATMUL_KN + MLA_MATMUL_KN + VLM_MATMUL_KN
    + WHISPER_MATMUL_KN + HYBRID_MATMUL_KN + XLSTM_MATMUL_KN))
#: the served (K, N) off the tensor-core route: whisper-tiny's LM head
DP4A_SERVING_KN = ((384, 51865),)
#: pixtral-12b's prefill rows in the smoke run: 4 prompts of 1024 image and
#: 128 text tokens
VLM_PREFILL_M = 4 * (1024 + 128)
#: whisper-tiny's prefill rows in the smoke run: the decoder's 4 prompts
#: of 64 tokens, and the encoder's 4 x 1500 frames
WHISPER_PREFILL_M = 4 * 64
WHISPER_ENCODER_M = 4 * 1500
#: whisper-tiny's encoder projections (every (K, N) but the head's)
WHISPER_ENCODER_KN = WHISPER_MATMUL_KN[:3]
#: ragged shapes: no dimension a multiple of the kernel's tiles (the
#: ``dp4a`` route)
MATMUL_RAGGED = ((7, 33, 70), (17, 2817, 129), (65, 5, 3))
#: the edges of the tensor-core route (``nmc_matmul.plan``): the last M of
#: the 16-row tile and the first of the 128-row one, split K with K not a
#: multiple of the split (a partial last slab), a partial second tile in M
#: and in N, the smallest K, a 64-token prefill; and N = 8 and 136, not
#: multiples of 16 (the ``dp4a`` route)
MATMUL_EDGES = ((16, 1024, 1024), (17, 1024, 1024), (4, 2832, 1024),
                (5, 1040, 144), (130, 1040, 272), (1, 32, 151936),
                (64, 2816, 1024), (3, 64, 8), (5, 1040, 136))

ATTENTION_CASES = {
    # qwen1.5-0.5B prefill: 16 heads of 64, causal
    "qwen-128": dict(b=1, hq=16, hkv=16, sq=128, skv=128, d=64, dv=64),
    "qwen-384": dict(b=1, hq=16, hkv=16, sq=384, skv=384, d=64, dv=64),
    "qwen-1000": dict(b=1, hq=16, hkv=16, sq=1000, skv=1000, d=64, dv=64),
    # qwen1.5-0.5B training: a microbatch of 4 rows of 512 tokens, causal
    "qwen-train-512": dict(b=4, hq=16, hkv=16, sq=512, skv=512, d=64,
                           dv=64),
    # moonshot-v1-16b-a3b prefill: 16 heads of 128 (kv 16), causal
    "moonshot-256": dict(b=1, hq=16, hkv=16, sq=256, skv=256, d=128,
                         dv=128),
    # h2o-danube-1.8B-like: GQA 32/8, head dim 80, sliding window
    "danube-gqa-window": dict(b=1, hq=32, hkv=8, sq=384, skv=384, d=80,
                              dv=80, window=128),
    # MLA-like value width
    "dv-ne-d": dict(b=1, hq=4, hkv=4, sq=128, skv=128, d=192, dv=128),
    # deepseek-v2-lite-16b's MLA prefill: 16 heads, D = nope + rope = 192,
    # Dv = 128, causal (the CUDA-core route in bf16 too)
    "deepseek-mla-256": dict(b=1, hq=16, hkv=16, sq=256, skv=256, d=192,
                             dv=128),
    # pixtral-12b's prefill: 1024 image + 128 text tokens, GQA 32/8 of 128
    "pixtral-1152": dict(b=1, hq=32, hkv=8, sq=1152, skv=1152, d=128,
                         dv=128),
    # every row fully masked (q past the keys), a ragged Skv
    "masked-rows": dict(b=1, hq=2, hkv=1, sq=40, skv=70, d=64, dv=64,
                        window=4, q_offset=80),
    # non-causal, ragged Sq and Skv, two batches
    "ragged-noncausal": dict(b=2, hq=4, hkv=2, sq=33, skv=100, d=32, dv=48,
                             causal=False),
    # whisper-tiny's encoder self-attention over 4 x 1500 frames, 6 heads
    # of 64, non-causal
    "whisper-enc-1500": dict(b=4, hq=6, hkv=6, sq=1500, skv=1500, d=64,
                             dv=64, causal=False),
    # its cross-attention to the encoder output: a 64-token prompt, and one
    # decode step (Sq = 1)
    "whisper-cross-64": dict(b=4, hq=6, hkv=6, sq=64, skv=1500, d=64,
                             dv=64, causal=False),
    "whisper-cross-decode": dict(b=4, hq=6, hkv=6, sq=1, skv=1500, d=64,
                                 dv=64, causal=False),
    # that decode step's cross-attention on a model axis of 2: every head
    # over half the frames, with the log-sum-exp that combines the halves
    # (``ops.attention_partial``)
    "whisper-cross-partial-750": dict(b=4, hq=6, hkv=6, sq=1, skv=750, d=64,
                                      dv=64, causal=False, lse=True),
    # zamba2-2.7b's shared block at a 512-token prompt: 32 heads of 80,
    # causal, its 4096 sliding window
    "zamba2-512": dict(b=1, hq=32, hkv=32, sq=512, skv=512, d=80, dv=80,
                       window=4096),
    # the edges of the tensor-core kernel's 64-key tiles and 16-row warps:
    # a prompt of exactly one tile and one of a partial tile
    "qwen-64": dict(b=1, hq=16, hkv=16, sq=64, skv=64, d=64, dv=64),
    "qwen-50": dict(b=1, hq=16, hkv=16, sq=50, skv=50, d=64, dv=64),
    # a ragged causal prompt, not a multiple of 64
    "qwen-500": dict(b=1, hq=16, hkv=16, sq=500, skv=500, d=64, dv=64),
    # a prefill continuing a cache: q rows at kv positions 200..299
    "prefill-continue": dict(b=1, hq=16, hkv=16, sq=100, skv=300, d=64,
                             dv=64, q_offset=200),
    # a window edge inside a 64-key tile, GQA 8/2
    "window-mid-tile": dict(b=1, hq=8, hkv=2, sq=256, skv=256, d=64, dv=64,
                            window=100),
}

#: the cases with a head dim over 128, which take the CUDA-core route in
#: bf16 too (``flash_attention.route``)
HEAD_DIM_OVER_128 = ("dv-ne-d", "deepseek-mla-256")

BF16_ULP = 2.0 ** -7


def matmul_tolerance(act: str, out_dtype) -> tuple:
    """(rtol, atol) of ``nmc_matmul`` against its plain version."""
    if act in ("none", "relu"):
        return 0.0, 0.0
    return (1e-5, 1e-4) if out_dtype == torch.float32 else (BF16_ULP, 1e-4)


def attention_tolerance(dtype) -> tuple:
    """(rtol, atol) of ``flash_attention`` against ``chunked_attention``."""
    return (0.0, 2e-5) if dtype == torch.float32 else (1.6e-2, 1e-2)


def lse_tolerance() -> tuple:
    """(rtol, atol) of ``flash_attention``'s log-sum-exp against
    ``chunked_attention``'s, in either dtype."""
    return 1e-5, 1e-4


def close_attention(name: str, got, want, dtype) -> float:
    """An attention launch's output against the plain version's (each a
    tensor, or (out, lse) where the launch returned its log-sum-exp):
    :func:`attention_tolerance` on ``out``, :func:`lse_tolerance` on
    ``lse``.  Returns the output's max abs err."""
    if isinstance(got, tuple):
        close(f"{name} lse", got[1], want[1], *lse_tolerance())
        got, want = got[0], want[0]
    return close(name, got, want, *attention_tolerance(dtype))


def close(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
          atol: float) -> float:
    """The max abs difference; raises beyond ``atol + rtol * |want|``."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside rtol {rtol} / atol "
            f"{atol}; max abs err {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def serving_matmul_shapes() -> list:
    """``(M, K, N)`` of every served model's projections: each (K, N) at
    the rows of :data:`MATMUL_M`, pixtral's at its prefill rows, and
    whisper's at its decoder's and its encoder's prefill rows."""
    return [(m, k, n) for m in MATMUL_M for k, n in SERVING_MATMUL_KN] + \
        [(VLM_PREFILL_M, k, n) for k, n in VLM_MATMUL_KN] + \
        [(WHISPER_PREFILL_M, k, n) for k, n in WHISPER_MATMUL_KN] + \
        [(WHISPER_ENCODER_M, k, n) for k, n in WHISPER_ENCODER_KN]


def serving_route(k: int, n: int) -> str:
    """The route a served (K, N) is expected on: ``"dp4a"`` for
    :data:`DP4A_SERVING_KN`, else ``"tensor_core"``."""
    return "dp4a" if (k, n) in DP4A_SERVING_KN else "tensor_core"


def matmul_inputs(m: int, k: int, n: int, device, seed: int = 0) -> tuple:
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-127, 128, (m, k), generator=gen, device=device,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, device=device,
                      dtype=torch.int8)
    scale = torch.rand(n, generator=gen, device=device) * 9e-4 + 1e-4
    bias = torch.randn(n, generator=gen, device=device)
    return x, w, scale, bias


def check_matmul(m: int, k: int, n: int, device, seed: int = 0) -> dict:
    """Kernel vs plain for one (M, K, N): the accumulator, then every
    activation into float32 and bfloat16.  Returns {case: max abs err}."""
    x, w, scale, bias = matmul_inputs(m, k, n, device, seed)
    errs = {"acc": close(f"nmc_matmul {m}x{k}x{n} acc",
                          _mm.nmc_matmul(x, w, None, out_dtype=torch.int32),
                          ref.nmc_matmul(x, w, None, out_dtype=torch.int32),
                          0.0, 0.0)}
    for out_dtype, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for act in ref.ACTS:
            got = _mm.nmc_matmul(x, w, scale, bias, act=act,
                                 out_dtype=out_dtype)
            want = ref.nmc_matmul(x, w, scale, bias, act=act,
                                  out_dtype=out_dtype)
            errs[f"{act}/{label}"] = close(
                f"nmc_matmul {m}x{k}x{n} {act} {label}", got, want,
                *matmul_tolerance(act, out_dtype))
    return errs


def attention_inputs(case: dict, dtype, device, seed: int = 0) -> tuple:
    gen = torch.Generator(device=device).manual_seed(seed)
    c = case

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    return (rand(c["b"], c["hq"], c["sq"], c["d"]),
            rand(c["b"], c["hkv"], c["skv"], c["d"]),
            rand(c["b"], c["hkv"], c["skv"], c["dv"]))


def attention_route(name: str, dtype) -> str:
    """The route (``flash_attention.route``) a case of
    :data:`ATTENTION_CASES` takes in ``dtype``."""
    case = ATTENTION_CASES[name]
    return _fa.route(dtype, case["d"], case["dv"])


def attention_kw(case: dict) -> dict:
    """A case's masking: causal (the default), window, q_offset."""
    return dict(causal=case.get("causal", True), window=case.get("window"),
                q_offset=case.get("q_offset", 0))


def check_attention(name: str, dtype, device, seed: int = 0) -> float:
    """Kernel vs ``chunked_attention`` for one case of
    :data:`ATTENTION_CASES` (and its log-sum-exp where the case asks for
    it, ``lse``).  Returns the output's max abs err."""
    case = ATTENTION_CASES[name]
    q, k, v = attention_inputs(case, dtype, device, seed)
    kw = dict(attention_kw(case), return_lse=case.get("lse", False))
    got = _fa.flash_attention(q, k, v, **kw)
    want = _fa.chunked_attention(q, k, v, **kw)
    return close_attention(f"flash_attention {name} {dtype}", got, want,
                           dtype)


#: the cases whose gradient :func:`check_attention_grad` checks: the
#: training shape, GQA with a window, rows that see no key, non-causal
#: with Dv != D and ragged lengths, MLA's value width
ATTENTION_GRAD_CASES = ("qwen-train-512", "danube-gqa-window", "masked-rows",
                        "ragged-noncausal", "dv-ne-d")


def attention_grad_tolerance(dtype) -> tuple:
    """(rtol, atol) of attention's gradient through the kernel against
    autograd of the plain version: the same float32 backward on the same
    inputs but another formula (float32 rounding), then in bf16 one
    rounding of each gradient."""
    return (1e-4, 1e-5) if dtype == torch.float32 else (1.6e-2, 1e-2)


def check_attention_grad(name: str, dtype, device, seed: int = 0) -> dict:
    """``ops.attention``'s gradients (dq, dk, dv of ``sum(o * do)``) for one
    case of :data:`ATTENTION_GRAD_CASES`: through the kernel (one launch,
    inside :class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`)
    against autograd of the plain version under ``ops.force_plain()``.
    Returns {"dq", "dk", "dv": max abs err}."""
    from repro_torch.kernels import ops
    case = ATTENTION_CASES[name]
    q, k, v = attention_inputs(case, dtype, device, seed)
    do = attention_inputs(dict(case, d=case["dv"]), dtype, device,
                          seed + 1)[0]
    kw = attention_kw(case)

    def grads():
        qkv = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(ops.attention(*qkv, **kw), qkv, do)
    before = _fa.flash_attention.launches
    got = grads()
    if _fa.flash_attention.launches != before + 1:
        raise AssertionError(f"attention grad {name}: the forward did not "
                             f"launch the kernel once")
    with ops.force_plain():
        want = grads()
    return {label: close(f"attention grad {name} {dtype} {label}", g, w,
                         *attention_grad_tolerance(dtype))
            for label, g, w in zip(("dq", "dk", "dv"), got, want)}


# ---------------------------------------------------------------------------
# vrf_alu
# ---------------------------------------------------------------------------

VV, VX = ref.VRF_MODE_VV, ref.VRF_MODE_VX
#: the kernels demo's two programs (examples/nmc_kernels_demo.py)
VRF_DEMO_PROGRAMS = {
    # leaky-relu of v1 into v3 via the paper's max(x, x >> 2) trick
    "leaky_relu": [("sra", 2, 0, 1, 2, VX), ("max", 3, 2, 1, 0, VV)],
    # fused (v1 * v4 + v5) ^ v1, then clamp to [-100, 100]
    "fused_chain": [("mul", 6, 4, 1, 0, VV), ("add", 6, 5, 6, 0, VV),
                    ("xor", 7, 1, 6, 0, VV), ("min", 7, 0, 7, 100, VX),
                    ("max", 7, 0, 7, -100, VX)],
}
#: the demo's file: 32 registers of 4096 elements
VRF_DEMO_SHAPE = (32, 4096)
#: a VL that is a multiple of the kernel's 256-thread block, and one that
#: is not
VRF_VLS = (4096, 4096 + 77)
VRF_DTYPES = ref.VRF_DTYPES
_NP = {torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32}


def vrf_every_op_program() -> list:
    """Every op in vv and in vx mode, each into its own register, with vx
    scalars past the element range (truncated first) and negative shift
    amounts (taken mod the width)."""
    entries = []
    for i, op in enumerate(ref.VRF_OPS):
        entries.append((op, 8 + i, 1, 2, 0, VV))
        entries.append((op, 20 + i % 12, 0, 3, (-1) ** i * (300 + 37 * i),
                        VX))
    entries.append(("sll", 4, 5, 2, 0, VV))
    entries.append(("mv", 5, 0, 0, -129, VX))
    return entries


def vrf_wrap_extremes(dtype) -> tuple:
    """The wrap-extremes case of the reference's kernel tests: a (16, 256)
    file with the type's extremes, and a program whose mul / add / sub /
    shifts must wrap two's-complement."""
    info = np.iinfo(_NP[dtype])
    bits = info.bits
    vrf = np.zeros((16, 256), _NP[dtype])
    vrf[1, :] = info.min
    vrf[2, :] = info.max
    vrf[3, :] = np.tile(np.array([info.min, info.max, -1, 1], vrf.dtype), 64)
    entries = [("mul", 4, 1, 2, 0, VV), ("add", 5, 2, 4, 0, VV),
               ("sub", 6, 1, 5, 0, VV), ("mul", 7, 3, 3, 0, VV),
               ("sll", 8, 0, 7, bits - 1, VX), ("srl", 9, 0, 1, 1, VX),
               ("sra", 10, 0, 1, 1, VX), ("add", 11, 0, 2, 1, VX)]
    return vrf, entries


def vrf_random_program(rng, n_instr: int, n_regs: int) -> list:
    ops = ref.VRF_OPS
    return [(ops[rng.integers(len(ops))], int(rng.integers(n_regs)),
             int(rng.integers(n_regs)), int(rng.integers(n_regs)),
             int(rng.integers(-2 ** 31, 2 ** 31)), int(rng.integers(2)))
            for _ in range(n_instr)]


def vrf_random_file(rng, shape: tuple, dtype) -> np.ndarray:
    info = np.iinfo(_NP[dtype])
    return rng.integers(info.min, info.max + 1, shape, dtype=_NP[dtype])


#: elements of sentinel kept after a checked file (and before it, at an
#: offset): a kernel that writes outside the file changes them
VRF_GUARD = 64
_SENTINEL = 0x5A


def check_vrf_alu(vrf: np.ndarray, entries: list, device,
                  offset: int = 0) -> int:
    """Kernel vs plain on one file and program, both on ``device``: the
    kernel's in-place result must equal the plain version's bit for bit.
    The kernel's file is a contiguous view ``offset`` elements into a
    buffer of sentinels, which must come out unchanged.  Returns the max
    abs difference (0)."""
    prog = _vrf.make_prog(entries)
    n = vrf.size
    buf = torch.full((offset + n + VRF_GUARD,), _SENTINEL,
                     dtype=torch.from_numpy(vrf).dtype, device=device)
    got = buf[offset:offset + n].view(vrf.shape)
    got.copy_(torch.as_tensor(vrf))
    _vrf.vrf_alu(got, prog)
    want = ref.vrf_alu(torch.as_tensor(vrf, device=device).clone(), prog)
    err = int((got.long() - want.long()).abs().max()) if n else 0
    if err or not torch.equal(got, want):
        raise AssertionError(f"vrf_alu {tuple(vrf.shape)} {vrf.dtype} at "
                             f"offset {offset}: kernel != plain (max abs "
                             f"err {err})")
    if (buf[:offset] != _SENTINEL).any() \
            or (buf[offset + n:] != _SENTINEL).any():
        raise AssertionError(f"vrf_alu {tuple(vrf.shape)} {vrf.dtype} at "
                             f"offset {offset}: wrote outside the file")
    return err


def vrf_cases(seed: int = 0, n_random: int = 50) -> list:
    """``(label, file, entries)`` cases: both demo programs, every op in both
    modes and the wrap extremes at int8, int16 and int32, on a
    block-multiple and a ragged VL, and ``n_random`` random programs of
    1-64 instructions spread over the types and VLs."""
    rng = np.random.default_rng(seed)
    cases = []
    for dtype in VRF_DTYPES:
        for vl in VRF_VLS:
            f = vrf_random_file(rng, (VRF_DEMO_SHAPE[0], vl), dtype)
            for name, entries in VRF_DEMO_PROGRAMS.items():
                cases.append((f"{name}/{dtype}/VL{vl}", f, entries))
            cases.append((f"every-op/{dtype}/VL{vl}", f,
                          vrf_every_op_program()))
        vrf, entries = vrf_wrap_extremes(dtype)
        cases.append((f"wrap-extremes/{dtype}", vrf, entries))
    for i in range(n_random):
        dtype = VRF_DTYPES[i % len(VRF_DTYPES)]
        vl = VRF_VLS[(i // len(VRF_DTYPES)) % len(VRF_VLS)]
        n_regs = int(rng.integers(1, 33))
        f = vrf_random_file(rng, (n_regs, vl), dtype)
        cases.append((f"random-{i}/{dtype}/VL{vl}", f,
                      vrf_random_program(rng, int(rng.integers(1, 65)),
                                         n_regs)))
    return cases


#: the timed random program: 64 instructions over 32 registers
VRF_TIMED_RANDOM = dict(seed=19, n_instr=64, n_regs=32)
#: a VL whose rows are not 16-byte aligned at any element width
VRF_RAGGED_VL = 4096 + 77


def vrf_timed_random_program() -> list:
    t = VRF_TIMED_RANDOM
    return vrf_random_program(np.random.default_rng(t["seed"]),
                              t["n_instr"], t["n_regs"])


def vrf_shift_case(rng, dtype, vl: int) -> tuple:
    """vv shifts with an amount per lane: v1 holds values (the type's
    extremes among them), v2 amounts that are negative, zero, at or past
    the element width, or in range; every shift of v1 by v2, by v1 and by
    itself, in place too."""
    info = np.iinfo(_NP[dtype])
    vrf = vrf_random_file(rng, (8, vl), dtype)
    vrf[1, :4] = (info.min, info.max, -1, 1)
    amounts = np.array([-1, -info.bits, 0, info.bits, info.bits + 3,
                        info.bits - 1, 2 * info.bits + 1, info.min, info.max])
    vrf[2] = np.resize(amounts, vl).astype(vrf.dtype)
    vrf[2, ::7] = rng.integers(-3 * info.bits, 3 * info.bits, vrf[2, ::7].size)
    entries = [(op, 3 + i, 2, 1, 0, VV)
               for i, op in enumerate(("sll", "srl", "sra"))]
    entries += [("sra", 6, 1, 2, 0, VV), ("srl", 7, 1, 1, 0, VV),
                ("sll", 1, 2, 1, 0, VV)]
    return vrf, entries


def vrf_edge_cases(seed: int = 0) -> list:
    """``(label, file, entries, offset, launches)`` cases of the kernel's
    edges, each with the launches it takes: rows not 16-byte aligned
    (:data:`VRF_RAGGED_VL`) at every element width; a contiguous view at
    an odd element offset; a program longer than one launch holds, and one
    that touches more registers than a launch holds; vv shifts with
    per-lane amounts at every width; an empty program and VL 0, which
    launch nothing."""
    rng = np.random.default_rng(seed)
    fused = VRF_DEMO_PROGRAMS["fused_chain"]
    cases = []
    for dtype in VRF_DTYPES:
        f = vrf_random_file(rng, (VRF_DEMO_SHAPE[0], VRF_RAGGED_VL), dtype)
        cases.append((f"ragged-rows/every-op/{dtype}", f,
                      vrf_every_op_program(), 0, 1))
        f, entries = vrf_shift_case(rng, dtype, VRF_RAGGED_VL)
        cases.append((f"ragged-rows/vv-shifts/{dtype}", f, entries, 0, 1))
        for offset in (1, 3):
            f = vrf_random_file(rng, VRF_DEMO_SHAPE, dtype)
            cases.append((f"offset-{offset}/fused_chain/{dtype}", f, fused,
                          offset, 1))
        f = vrf_random_file(rng, (VRF_DEMO_SHAPE[0], 4096 + 8), dtype)
        cases.append((f"offset-1/every-op/{dtype}", f,
                      vrf_every_op_program(), 1, 1))
        f, entries = vrf_shift_case(rng, dtype, 4096)
        cases.append((f"vv-shifts/{dtype}", f, entries, 0, 1))
    n_long = 2 * _vrf.MAX_INSTR + 88
    f = vrf_random_file(rng, (32, 4096), torch.int8)
    cases.append((f"long-{n_long}/int8", f,
                  vrf_random_program(rng, n_long, 32), 0, 3))
    wide = [("add", (3 * i) % 300, (3 * i + 1) % 300, (3 * i + 2) % 300, i,
             i % 2) for i in range(200)]
    f = vrf_random_file(rng, (300, 256), torch.int16)
    cases.append(("wide-300-registers/int16", f, wide, 0,
                  len(_vrf.split(_vrf.make_prog(wide).tolist()))))
    cases.append(("empty-program/int32", vrf_random_file(
        rng, (8, 256), torch.int32), [], 0, 0))
    cases.append(("vl-0/int8", np.zeros((8, 0), np.int8), fused, 0, 0))
    return cases


def check_vrf_case(case: tuple, device) -> int:
    """One case of :func:`vrf_edge_cases` on ``device``: kernel vs plain bit
    for bit (:func:`check_vrf_alu`), and on the card the launches it
    states."""
    label, f, entries, offset, launches = case
    before = _vrf.vrf_alu.launches
    err = check_vrf_alu(f, entries, device, offset)
    got = _vrf.vrf_alu.launches - before
    if torch.device(device).type == "cuda" and got != launches:
        raise AssertionError(f"vrf_alu {label}: {got} launches, not "
                             f"{launches}")
    return err
