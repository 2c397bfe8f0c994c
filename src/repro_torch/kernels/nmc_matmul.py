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
the kernel or raises.

The CUDA source holds two kernel bodies, and its entry picks one before
the launch and reports it; :func:`route` states the same rule, which the
wrapper applies first (and raises if the entry took another route):

* ``"tensor_core"``: K a positive multiple of 16, N a multiple of 16, x
  and w 16-byte aligned (every serving shape): ``mma.sync`` m16n8k32 int8
  products with int32 accumulation, x brought in by ``cp.async``, w
  transposed to K-major on its way into shared memory.  :func:`plan`
  chooses its tile and how K is split across blocks; with more than one
  split each block stores its int32 partial sums in a workspace that the
  wrapper allocates, and a second, small kernel adds them in split order
  and runs the epilogue on the finished sums (exact).
* ``"dp4a"``: every other shape (``checks.MATMUL_RAGGED``), on the CUDA
  cores with ``__dp4a``, exact for any M, N and K.

``nmc_matmul.launches`` counts the launches and
``nmc_matmul.launches_by_route`` splits them by route.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch import cuda_build
from repro_torch.kernels import ref

ACT_ID = {name: i for i, name in enumerate(ref.ACTS)}
OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
#: the kernel bodies, by their id in the C source's ``enum Route``
ROUTE_ID = {"dp4a": 0, "tensor_core": 1}
ROUTE_NAME = {i: name for name, i in ROUTE_ID.items()}
#: the tensor-core route's K and N multiple (16 bytes: one ``cp.async``)
TC_MULTIPLE = 16
#: the tensor-core kernel's compiled tiles, (BM, BN, BK), as in the C
#: source's ``TileThin`` / ``TileWide``: 16-row tiles for decode (M <= 16),
#: 128-row tiles for prefill
TILE_THIN = (16, 128, 64)
TILE_WIDE = (128, 128, 64)
#: the card's SM count (H100 SXM); on the card the wrapper reads the
#: device's own (:func:`sm_count`)
SM_COUNT = 132
#: split K until the grid holds one block per SM, but no split shorter
#: than this many BK slabs (the best split counts measured on the card,
#: PERF.md)
MIN_SPLIT_SLABS = 4
_VP, _I = ctypes.c_void_p, ctypes.c_int
#: the C interface of csrc/nmc_matmul.cu: x, w, scale, bias, out, ws, M, N,
#: K, act, out_kind, bm, bn, splits, k_per_split, the route taken (out),
#: stream
ARGTYPES = [_VP] * 6 + [_I] * 9 + [_VP] * 2


def route(k: int, n: int, aligned: bool = True) -> str:
    """The kernel body a launch with this K and N takes (``aligned``: x and
    w 16-byte aligned): ``"tensor_core"`` or ``"dp4a"`` (module
    docstring)."""
    if k > 0 and k % TC_MULTIPLE == 0 and n % TC_MULTIPLE == 0 and aligned:
        return "tensor_core"
    return "dp4a"


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, k: int, sm_count: int = SM_COUNT) -> tuple:
    """``(bm, bn, splits, k_per_split)`` of the tensor-core kernel for an
    ``m x k x n`` product: the tile (:data:`TILE_THIN` for ``m <= 16``,
    else :data:`TILE_WIDE`), and K cut into ``splits`` ranges of
    ``k_per_split`` (whole BK slabs; the last range may be shorter) so that
    the output tiles times the splits reach ``sm_count`` blocks, each range
    at least :data:`MIN_SPLIT_SLABS` slabs long (or all of K).  Split ``z``
    covers K indices ``[z * k_per_split, min(k, (z + 1) * k_per_split))``.
    """
    if m < 1 or n < 1 or k < 1:
        raise ValueError(f"nmc_matmul.plan: need M, N, K >= 1, got "
                         f"{m}x{k}x{n}")
    bm, bn, bk = TILE_THIN if m <= TILE_THIN[0] else TILE_WIDE
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    slabs = math.ceil(k / bk)
    want = math.ceil(sm_count / tiles)
    per = min(slabs, max(MIN_SPLIT_SLABS, slabs // want))
    return bm, bn, math.ceil(slabs / per), per * bk


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SM count of CUDA device ``device_index``."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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
    kind = route(k, n, x_q.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    bm = bn = splits = k_per_split = 0
    ws = None
    if kind == "tensor_core" and m > 0:
        bm, bn, splits, k_per_split = plan(m, n, k, sm_count(dev.index or 0))
        if splits > 1:                    # each split's partial sums
            ws = torch.empty(splits * m * n, dtype=torch.int32, device=dev)
    fn = cuda_build.entry("nmc_matmul", ARGTYPES)
    taken = _I(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x_q.data_ptr(), w_q.data_ptr(),
                None if scale is None else scale.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), m, n, k, ACT_ID[act],
                OUT_KIND[out_dtype], bm, bn, splits, k_per_split,
                ctypes.byref(taken), stream)
    cuda_build.check_launch("nmc_matmul", rc)
    took = ROUTE_NAME.get(taken.value)
    if took != kind:
        raise RuntimeError(f"nmc_matmul: the kernel took route "
                           f"{taken.value}, the wrapper's rule says {kind}")
    nmc_matmul.launches += 1
    nmc_matmul.launches_by_route[took] += 1
    if out_dtype == torch.int32:
        nmc_matmul.launches_int32 += 1
    return out


nmc_matmul.launches = 0
nmc_matmul.launches_by_route = dict.fromkeys(ROUTE_ID, 0)
#: the launches that returned the raw int32 accumulator (a row-parallel
#: W8A8 linear's partial product)
nmc_matmul.launches_int32 = 0
