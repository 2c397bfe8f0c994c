"""The LM-layer kernels against their plain versions, at the serving path's
shapes, with the tolerances stated.

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
    output).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import nmc_matmul as _mm
from repro_torch.kernels import ref

#: decode (1 and 4 slots) and prefill row counts of the serving path
MATMUL_M = (1, 4, 384)
#: qwen1.5-0.5B's projections: q/k/v/o, up/gate, down, the LM head
MATMUL_KN = ((1024, 1024), (1024, 2816), (2816, 1024), (1024, 151936))
#: ragged shapes: no dimension a multiple of the kernel's tiles
MATMUL_RAGGED = ((7, 33, 70), (17, 2817, 129), (65, 5, 3))

ATTENTION_CASES = {
    # qwen1.5-0.5B prefill: 16 heads of 64, causal
    "qwen-128": dict(b=1, hq=16, hkv=16, sq=128, skv=128, d=64, dv=64),
    "qwen-384": dict(b=1, hq=16, hkv=16, sq=384, skv=384, d=64, dv=64),
    "qwen-1000": dict(b=1, hq=16, hkv=16, sq=1000, skv=1000, d=64, dv=64),
    # h2o-danube-1.8B-like: GQA 32/8, head dim 80, sliding window
    "danube-gqa-window": dict(b=1, hq=32, hkv=8, sq=384, skv=384, d=80,
                              dv=80, window=128),
    # MLA-like value width
    "dv-ne-d": dict(b=1, hq=4, hkv=4, sq=128, skv=128, d=192, dv=128),
    # every row fully masked (q past the keys), a ragged Skv
    "masked-rows": dict(b=1, hq=2, hkv=1, sq=40, skv=70, d=64, dv=64,
                        window=4, q_offset=80),
    # non-causal, ragged Sq and Skv, two batches
    "ragged-noncausal": dict(b=2, hq=4, hkv=2, sq=33, skv=100, d=32, dv=48,
                             causal=False),
}

BF16_ULP = 2.0 ** -7


def matmul_tolerance(act: str, out_dtype) -> tuple:
    """(rtol, atol) of ``nmc_matmul`` against its plain version."""
    if act in ("none", "relu"):
        return 0.0, 0.0
    return (1e-5, 1e-4) if out_dtype == torch.float32 else (BF16_ULP, 1e-4)


def attention_tolerance(dtype) -> tuple:
    """(rtol, atol) of ``flash_attention`` against ``chunked_attention``."""
    return (0.0, 2e-5) if dtype == torch.float32 else (1.6e-2, 1e-2)


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


def check_attention(name: str, dtype, device, seed: int = 0) -> float:
    """Kernel vs ``chunked_attention`` for one case of
    :data:`ATTENTION_CASES`.  Returns the max abs err."""
    case = ATTENTION_CASES[name]
    q, k, v = attention_inputs(case, dtype, device, seed)
    kw = dict(causal=case.get("causal", True), window=case.get("window"),
              q_offset=case.get("q_offset", 0))
    got = _fa.flash_attention(q, k, v, **kw)
    want = _fa.chunked_attention(q, k, v, **kw)
    return close(f"flash_attention {name} {dtype}", got, want,
                 *attention_tolerance(dtype))
