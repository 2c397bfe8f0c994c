"""Plain PyTorch versions of the LM-layer kernels (the port's oracles).

The counterpart of the JAX package's ``kernels/ref.py``: the W8A8 matmul
with its fused epilogue, the activation table, the two int8 quantizers,
the NM-Carus VRF ALU (``vrf_alu``, a program-as-data interpreter) and
plain-softmax attention.  Each runs on the device of its tensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ACTS = ("none", "relu", "silu", "gelu")


def nmc_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
               scale: torch.Tensor | None, bias: torch.Tensor | None = None,
               act: str = "none", out_dtype=torch.float32) -> torch.Tensor:
    """``y = act((x_q @ w_q) * scale + bias)``.

    x_q: (M, K) int8, w_q: (K, N) int8, scale: (N,) f32 (= s_x * s_w),
    bias: (N,) f32 or None.  ``out_dtype=torch.int32`` returns the int32
    accumulator itself (``scale`` and ``bias`` None, ``act`` "none").

    The product is exact, at the NM-Carus ``vmacc`` width (never
    accumulate at operand width).  CUDA has no integer ``matmul``, so on
    the card it accumulates in float64: every partial sum is an integer
    far below 2^53.  On the CPU it accumulates in int64."""
    wide = torch.float64 if x_q.is_cuda else torch.int64
    acc = (x_q.to(wide) @ w_q.to(wide)).to(torch.int32)
    if out_dtype == torch.int32:
        if scale is not None or bias is not None or act != "none":
            raise ValueError("out_dtype=int32 returns the raw accumulator: "
                             "scale, bias and act must be unset")
        return acc
    return epilogue(acc, scale, bias, act, out_dtype)


def epilogue(acc: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor | None = None, act: str = "none",
             out_dtype=torch.float32) -> torch.Tensor:
    """:func:`nmc_matmul`'s dequantize epilogue on an int32 accumulator
    (M, N): ``act(acc * scale + bias)`` in float32, as ``out_dtype``."""
    # two roundings, as the reference: a product, then a sum (no FMA)
    y = acc.to(torch.float32) * scale.to(torch.float32)[None, :]
    if bias is not None:
        y = y + bias.to(torch.float32)[None, :]
    return apply_act(y, act).to(out_dtype)


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "none":
        return y
    if act == "relu":
        return torch.clamp_min(y, 0)
    if act == "silu":
        return y * torch.sigmoid(y)
    if act == "gelu":                      # jax.nn.gelu's default
        return F.gelu(y, approximate="tanh")
    raise ValueError(act)


def quantize_rowwise(w: torch.Tensor, axis: int = 0):
    """Symmetric per-output-channel int8 quantization of a weight matrix."""
    amax = torch.amax(w.abs(), dim=axis, keepdim=True)
    s = torch.clamp_min(amax, 1e-8) / 127.0
    wq = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return wq, s.reshape(-1)


def quantize_dynamic(x: torch.Tensor, amax: torch.Tensor | None = None):
    """Per-tensor dynamic symmetric int8 quantization of activations: one
    scale over the whole tensor, in the tensor's dtype.  ``amax``: the
    tensor's absolute maximum where ``x`` is one rank's part of it (the
    maximum over every part), ``x``'s own when None."""
    if amax is None:
        amax = torch.amax(x.abs())
    s = torch.clamp_min(amax, 1e-8) / 127.0
    xq = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return xq, s


# ---------------------------------------------------------------------------
# vrf_alu: the NM-Carus VPU as a fused element-wise program interpreter
# ---------------------------------------------------------------------------

# op ids (shared with the CUDA kernel, csrc/vrf_alu.cu)
VRF_OPS = ("add", "sub", "mul", "min", "max", "and", "or", "xor",
           "sll", "srl", "sra", "mv")
VRF_OP_ID = {n: i for i, n in enumerate(VRF_OPS)}
VRF_MODE_VV, VRF_MODE_VX = 0, 1
#: the columns of an ``(n_instr, 6)`` int32 program
VRF_FIELDS = ("op", "vd", "vs1", "vs2", "scalar", "mode")
VRF_DTYPES = (torch.int8, torch.int16, torch.int32)


def _wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 values -> their two's-complement value at ``bits``, in int64."""
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def _vrf_binop(opid: int, a: torch.Tensor, b: torch.Tensor,
               bits: int) -> torch.Tensor:
    """One VRF op on int64 lanes holding ``bits``-wide signed values; the
    result is wrapped to ``bits``.  The shift amount is ``b`` as an
    unsigned 32-bit value mod ``bits``, so -3 shifts by 5 at 8 bits;
    ``sll`` / ``srl`` shift the unsigned view, ``sra`` the signed one;
    ``mv`` broadcasts ``b``."""
    mask = (1 << bits) - 1
    sh = b & (bits - 1)            # == (b mod 2^32) mod bits: bits | 2^32
    op = VRF_OPS[opid]
    if op == "add":
        r = a + b
    elif op == "sub":
        r = a - b
    elif op == "mul":
        r = a * b
    elif op == "min":
        r = torch.minimum(a, b)
    elif op == "max":
        r = torch.maximum(a, b)
    elif op == "and":
        r = a & b
    elif op == "or":
        r = a | b
    elif op == "xor":
        r = a ^ b
    elif op == "sll":
        r = (a & mask) << sh
    elif op == "srl":
        r = (a & mask) >> sh
    elif op == "sra":
        r = a >> sh
    else:                          # mv
        r = b.expand_as(a)
    return _wrap(r, bits)


def check_vrf_program(prog, n_regs: int) -> list:
    """Validate an ``(n_instr, 6)`` program against an ``n_regs`` file and
    return its rows as host ints.  Raises ``ValueError`` on an unknown op
    or a register index outside ``[0, n_regs)``: the reference clamps an
    out-of-range ``vd`` in its kernel and drops the write in its oracle,
    and the port takes neither reading."""
    prog = torch.as_tensor(prog)
    if prog.dim() != 2 or prog.shape[1] != len(VRF_FIELDS):
        raise ValueError(f"vrf_alu: program must be (n_instr, "
                         f"{len(VRF_FIELDS)}), got {tuple(prog.shape)}")
    if prog.dtype != torch.int32:
        raise TypeError(f"vrf_alu: program must be int32, got {prog.dtype}")
    rows = prog.cpu().tolist()
    for t, (op, vd, vs1, vs2, _, _) in enumerate(rows):
        if not 0 <= op < len(VRF_OPS):
            raise ValueError(f"vrf_alu: instruction {t}: unknown op {op}")
        for name, r in (("vd", vd), ("vs1", vs1), ("vs2", vs2)):
            if not 0 <= r < n_regs:
                raise ValueError(f"vrf_alu: instruction {t}: {name}={r} "
                                 f"outside the {n_regs}-register file")
    return rows


def vrf_alu(vrf: torch.Tensor, prog) -> torch.Tensor:
    """Execute ``prog`` (int32 ``(n_instr, 6)``: op, vd, vs1, vs2, scalar,
    mode) over ``vrf`` (``(n_regs, VL)`` int8/int16/int32) **in place** and
    return ``vrf``, one tensor op per instruction on the device of ``vrf``.

    Mode 0 (vv) takes operand b from ``vrf[vs1]``; any other mode (vx)
    takes the scalar truncated to the element type (300 acts as 44 at
    int8).  Every result wraps two's-complement at the element width."""
    if vrf.dtype not in VRF_DTYPES:
        raise TypeError(f"vrf_alu: VRF must be one of {VRF_DTYPES}, got "
                        f"{vrf.dtype}")
    if vrf.dim() != 2:
        raise ValueError("vrf_alu: VRF must be (n_regs, VL)")
    bits = vrf.element_size() * 8
    for op, vd, vs1, vs2, scalar, mode in check_vrf_program(prog,
                                                             vrf.shape[0]):
        a = vrf[vs2].to(torch.int64)
        if mode == VRF_MODE_VV:
            b = vrf[vs1].to(torch.int64)
        else:
            b = _wrap(torch.tensor(scalar, dtype=torch.int64,
                                   device=vrf.device), bits)
        vrf[vd] = _vrf_binop(op, a, b, bits).to(vrf.dtype)
    return vrf


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              q_offset: int = 0) -> torch.Tensor:
    """Plain-softmax attention.  q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D).
    GQA by head repetition; ``window`` = sliding-window size (None = full);
    ``q_offset`` puts q token i at kv index q_offset + i.  Fully masked
    rows output 0 (the flash kernel and ``chunked_attention`` give the mean
    of V there instead; see ``flash_attention``)."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(d)
    skv = k.shape[2]
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)               # fully masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
