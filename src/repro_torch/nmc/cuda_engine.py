"""CUDA engine backend: each NMC wave is one hand-written kernel launch.

The counterpart of the JAX package's Pallas engine.  A bucketed wave of T
same-shape programs runs as **one** launch of ``caesar_wave`` or
``carus_wave`` (``repro_torch/csrc/*.cu``, built for ``sm_90a`` at first use
by :mod:`repro_torch.cuda_build`): one block per tile, the tile's 32 KiB
image resident in shared memory for the whole instruction stream, and the
int32 word image updated in place — the paper's near-memory thesis applied
to the simulator: N instructions cost one memory round trip, not N.

Lowering contract:

* **tile-batch dimension -> grid.**  Tile ``t`` of the wave is block ``t``;
  tiles are independent by construction, so blocks never communicate.
* **memory image -> shared memory, in place.**  Both kernels take the int32
  word image (``[T, 8192]`` for Caesar, ``[T, 32, 256]`` for Carus) and
  unpack / pack lanes inside the kernel, so no separate passes run around
  the launch.
* **instruction stream -> runtime data.**  The kernels never specialise on
  a program's contents, only on SEW (one template instance per width), so
  the pools' kernel-handle cache keys on shape alone.

The wrappers :func:`caesar_wave` and :func:`carus_wave` check device, dtype,
shape and contiguity, launch on ``torch.cuda.current_stream()`` and count
their launches in a plain integer (``caesar_wave.launches``).  On CPU
tensors they run the plain PyTorch version instead (the engines of
:mod:`repro_torch.core`), and only because the tensors lie on the CPU; on a
CUDA tensor they launch the kernel or raise — there is no fallback.  The
``"cuda"`` engines themselves refuse CPU state outright.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import cuda_build
from repro_torch.core import isa
from repro_torch.core.caesar import CaesarEngine
from repro_torch.core.carus import CarusVPU
from repro_torch.nmc.engine import CaesarTile, CarusTile

CAESAR_FIELDS = isa.CAESAR_TRACE_DTYPE.names
CARUS_FIELDS = isa.CARUS_TRACE_DTYPE.names

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned (the kernels "
                         f"move the image in 16-byte vectors)")


def caesar_wave(fields: dict, mem: torch.Tensor, sew: int) -> torch.Tensor:
    """Run a wave of NM-Caesar streams: ``fields`` holds int32 ``[T, n]``
    ``op/dest/src1/src2``; ``mem`` is the int32 ``[T, 8192]`` image,
    updated **in place** and returned."""
    if mem.device.type == "cpu":
        mem.copy_(CaesarEngine().run_stream(mem, fields, sew)[0])
        return mem
    n_tiles, mem_words = mem.shape
    n_instr = fields["op"].shape[-1]
    _check("mem", mem, (n_tiles, 8192), mem.device)
    for k in CAESAR_FIELDS:
        _check(k, fields[k], (n_tiles, n_instr), mem.device)
    fn = cuda_build.entry("caesar_wave", [_VP] * 5 + [_I] * 4 + [_VP])
    with torch.cuda.device(mem.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(fields[k].data_ptr() for k in CAESAR_FIELDS),
                mem.data_ptr(), n_tiles, n_instr, mem_words, sew, stream)
    cuda_build.check_launch("caesar_wave", rc)
    caesar_wave.launches += 1
    return mem


def carus_wave(fields: dict, vrf: torch.Tensor, sew: int) -> torch.Tensor:
    """Run a wave of NM-Carus traces: ``fields`` holds the eight int32
    ``[T, n]`` CARUS_TRACE_DTYPE fields; ``vrf`` is the int32
    ``[T, 32, 256]`` register file, updated **in place** and returned."""
    if vrf.device.type == "cpu":
        vrf.copy_(CarusVPU().run_trace(vrf, fields, sew)[0])
        return vrf
    n_tiles, n_regs, reg_words = vrf.shape
    n_instr = fields["op"].shape[-1]
    _check("vrf", vrf, (n_tiles, 32, 256), vrf.device)
    for k in CARUS_FIELDS:
        _check(k, fields[k], (n_tiles, n_instr), vrf.device)
    fn = cuda_build.entry("carus_wave", [_VP] * 9 + [_I] * 5 + [_VP])
    with torch.cuda.device(vrf.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(fields[k].data_ptr() for k in CARUS_FIELDS),
                vrf.data_ptr(), n_tiles, n_instr, n_regs, reg_words, sew,
                stream)
    cuda_build.check_launch("carus_wave", rc)
    carus_wave.launches += 1
    return vrf


caesar_wave.launches = 0
carus_wave.launches = 0
KERNELS = (caesar_wave, carus_wave)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# Engine-protocol adapters
# ---------------------------------------------------------------------------

class _CudaMixin:
    """Shared plumbing: per-(sew, tiles, donate) kernel-handle cache; the
    state lives on the card."""

    backend = "cuda"
    _wave = None

    def _on_card(self, state: torch.Tensor) -> None:
        if state.device.type != "cuda":
            raise ValueError(
                f"backend='cuda' runs only on CUDA tensors, got a tensor on "
                f"{state.device}; use backend='torch' on the CPU")

    def init_state(self, image) -> torch.Tensor:
        state = super().init_state(image)
        self._on_card(state)
        return state

    def _make_batched(self, sew: int, donate: bool):
        wave = type(self)._wave

        def run_batch(batch_state, arrays):
            self._on_card(batch_state)
            state = batch_state if donate else batch_state.clone()
            fields = {k: torch.as_tensor(v, device=state.device)
                      .to(torch.int32).contiguous()
                      for k, v in arrays.items()}
            return wave(fields, state.contiguous(), sew)

        return run_batch


class CudaCaesarEngine(_CudaMixin, CaesarTile):
    """NM-Caesar tile on the card: the 8192-word image resident in shared
    memory for the whole instruction stream."""

    _wave = staticmethod(caesar_wave)

    def __init__(self, config=None, device="cuda"):
        super().__init__(config, device)


class CudaCarusEngine(_CudaMixin, CarusTile):
    """NM-Carus tile on the card: the VRF resident in shared memory as
    native-dtype elements, VL carried in a register."""

    _wave = staticmethod(carus_wave)

    def __init__(self, config=None, device="cuda"):
        super().__init__(config, device)
