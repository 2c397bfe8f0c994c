"""W8A8 matmul with a fused epilogue: the hand-written CUDA kernel's wrapper.

The counterpart of the JAX package's Pallas ``nmc_matmul``:
``y[M,N] = act((x_q[M,K] @ w_q[K,N]) * scale[N] + bias[N])`` with int8
operands, an int32 accumulator and the dequant + bias + activation epilogue
fused before the one store.  The kernel (``repro_torch/csrc/nmc_matmul.cu``,
built for ``sm_90a`` at first use) takes any M, N and K; the Pallas kernel
needed every dimension to divide its tiles, which qwen1.5-0.5B's
``d_ff`` = 2816 and vocabulary of 151936 do not.

On CPU tensors the wrapper runs the plain version (:func:`ref.nmc_matmul`),
and only because the tensors lie on the CPU; on CUDA tensors it launches
the kernel or raises.  ``nmc_matmul.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import cuda_build
from repro_torch.kernels import ref

ACT_ID = {name: i for i, name in enumerate(ref.ACTS)}
OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_VP, _I = ctypes.c_void_p, ctypes.c_int
#: the C interface of csrc/nmc_matmul.cu: x, w, scale, bias, out, M, N, K,
#: act, out_kind, stream
ARGTYPES = [_VP] * 5 + [_I] * 5 + [_VP]


def _check(name: str, t: torch.Tensor, dtype, shape: tuple, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"nmc_matmul: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"nmc_matmul: {name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"nmc_matmul: {name} is on {t.device}, expected "
                         f"{device}")
    if not t.is_contiguous():
        raise ValueError(f"nmc_matmul: {name} must be contiguous")


def nmc_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
               scale: torch.Tensor | None, bias: torch.Tensor | None = None,
               *, act: str = "none", out_dtype=torch.float32) -> torch.Tensor:
    """``act((x_q @ w_q) * scale + bias)`` as ``out_dtype`` (float32 or
    bfloat16); ``out_dtype=torch.int32`` returns the int32 accumulator
    (``scale`` and ``bias`` None, ``act`` "none")."""
    if x_q.device.type == "cpu":
        return ref.nmc_matmul(x_q, w_q, scale, bias, act=act,
                              out_dtype=out_dtype)
    if act not in ACT_ID:
        raise ValueError(f"nmc_matmul: unknown act {act!r}")
    if out_dtype not in OUT_KIND:
        raise TypeError(f"nmc_matmul: out_dtype must be one of "
                        f"{list(OUT_KIND)}, got {out_dtype}")
    if x_q.dim() != 2 or w_q.dim() != 2:
        raise ValueError("nmc_matmul: x_q and w_q must be 2-D")
    m, k = x_q.shape
    n = w_q.shape[1]
    dev = x_q.device
    _check("x_q", x_q, torch.int8, (m, k), dev)
    _check("w_q", w_q, torch.int8, (k, n), dev)
    if out_dtype == torch.int32:
        if scale is not None or bias is not None or act != "none":
            raise ValueError("nmc_matmul: out_dtype=int32 returns the raw "
                             "accumulator; scale, bias and act must be unset")
    else:
        scale = scale.to(torch.float32)
        _check("scale", scale, torch.float32, (n,), dev)
        if bias is not None:
            bias = bias.to(torch.float32)
            _check("bias", bias, torch.float32, (n,), dev)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    fn = cuda_build.entry("nmc_matmul", ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x_q.data_ptr(), w_q.data_ptr(),
                None if scale is None else scale.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                m, n, k, ACT_ID[act], OUT_KIND[out_dtype], stream)
    cuda_build.check_launch("nmc_matmul", rc)
    nmc_matmul.launches += 1
    return out


nmc_matmul.launches = 0
