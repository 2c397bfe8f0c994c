"""Engine protocol: one interface over both NMC tiles.

An :class:`Engine` knows how to *lower* a unified-IR
:class:`repro_torch.nmc.program.Program` to the tensors its executor consumes,
*run* it against a tile state (Caesar: flat memory words; Carus: the VRF),
*extract* output elements from a final state, and *cost* it through the
mechanistic timing/energy models.

Two backends implement it (:data:`BACKENDS`):

* ``"torch"`` — the plain PyTorch engines of :mod:`repro_torch.core.caesar`
  and :mod:`repro_torch.core.carus`.  They run on the device of the tensors
  they are given (numpy images land on the CPU).
* ``"cuda"`` — the hand-written wave kernels
  (:mod:`repro_torch.nmc.cuda_engine`).  Their state lives on the card;
  given a CPU tensor they raise.

``"auto"`` means the card: it resolves to ``"cuda"`` and raises when no card
is present — the CPU is an explicit opt-in (``backend="torch"``), never a
silent fallback.

``batched_fn(sew, n_tiles, donate)`` returns the ``(state[T, ...],
arrays[T, n]) -> state`` wave executor the pools call; ``scan_fn(sew)`` is
its single-tile flavour.  ``CaesarOp.NOP`` / ``VOp.VNOP`` entries leave the
carried state bit-exactly unchanged in every backend, so a padded program's
final state equals the unpadded one's.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import alu
from repro_torch.core.caesar import CaesarConfig, CaesarEngine
from repro_torch.core.carus import CarusConfig, CarusVPU
from repro_torch.nmc.program import Program


@runtime_checkable
class Engine(Protocol):
    name: str

    def lower(self, program: Program) -> dict: ...
    def init_state(self, image) -> torch.Tensor: ...
    def run(self, state, program: Program): ...
    def scan_fn(self, sew: int): ...
    def extract(self, state, out_slice: tuple[int, int], sew: int): ...
    def cost(self, program: Program, host_cycles: float = 0.0): ...


class _EngineBase:
    backend = "torch"
    state_shape: tuple = ()

    def __init__(self, device=None):
        self.device = torch.device(device if device is not None else "cpu")
        self._fns: dict = {}

    def lower(self, program: Program) -> dict:
        assert program.engine == self.name, (program.engine, self.name)
        return program.lower(self.device)

    def init_state(self, image) -> torch.Tensor:
        """Host image -> a fresh int32 state tensor.  A tensor stays on its
        own device; anything else is copied to the engine's device."""
        if isinstance(image, torch.Tensor):
            state = image.to(torch.int32).clone()
        else:
            state = torch.tensor(np.asarray(image, np.int32),
                                 device=self.device)
        return state.reshape(self.state_shape)

    def extract(self, state, out_slice: tuple[int, int], sew: int
                ) -> np.ndarray:
        """Final tile state -> output elements (host-side view); only the
        output words cross to the host."""
        start, nw = out_slice
        flat = state.reshape(-1)[start:start + nw]
        if isinstance(flat, torch.Tensor):
            flat = flat.cpu().numpy()
        return alu.unpack_np(np.asarray(flat), alu.NP_DTYPES[sew])

    def cost(self, program: Program, host_cycles: float = 0.0):
        from repro_torch.core import timing
        return timing.program_cycles(program, host_cycles)

    def energy(self, program: Program, host_cycles: float = 0.0):
        from repro_torch.core import energy
        return energy.program_energy(program, host_cycles)

    def run(self, state, program: Program):
        assert program.engine == self.name, (program.engine, self.name)
        return self.scan_fn(program.sew)(state, program.lower(state.device))

    def scan_fn(self, sew: int):
        """Single-tile flavour of :meth:`batched_fn` (a wave of one)."""
        fn = self.batched_fn(sew, 1)

        def run_one(state, arrays):
            batch = {k: torch.as_tensor(v, device=state.device)[None]
                     for k, v in arrays.items()}
            return fn(state[None], batch)[0]

        return run_one

    def batched_fn(self, sew: int, n_tiles: int, donate: bool = False):
        """``(batch_state[T, ...], batch_arrays[T, n]) -> batch_state`` —
        the pool-facing wave executor, cached per ``(sew, n_tiles,
        donate)``."""
        key = (sew, n_tiles, donate)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._make_batched(sew, donate)
            self._fns[key] = fn
        return fn

    def _make_batched(self, sew: int, donate: bool):
        raise NotImplementedError


class CaesarTile(_EngineBase):
    """NM-Caesar tile: state is the flat 8192-word 2-bank memory image."""

    name = "caesar"

    def __init__(self, config: CaesarConfig | None = None, device=None):
        super().__init__(device)
        self.sim = CaesarEngine(config)
        self.state_shape = (self.sim.cfg.mem_words,)

    def _make_batched(self, sew: int, donate: bool):
        # the plain engine never writes its input, so donation is moot
        def run_batch(batch_state, arrays):
            return self.sim.run_stream(batch_state, arrays, sew)[0]
        return run_batch


class CarusTile(_EngineBase):
    """NM-Carus tile: state is the (n_regs, reg_words) VRF."""

    name = "carus"

    def __init__(self, config: CarusConfig | None = None, device=None):
        super().__init__(device)
        self.sim = CarusVPU(config)
        cfg = self.sim.cfg
        self.state_shape = (cfg.n_regs, cfg.reg_words)

    def _make_batched(self, sew: int, donate: bool):
        def run_batch(batch_state, arrays):
            return self.sim.run_trace(batch_state, arrays, sew)[0]
        return run_batch


#: Execution backends implementing the Engine protocol.  "torch" is the
#: plain PyTorch engine on the device of its tensors; "cuda" is the
#: hand-written wave kernels on the card.
BACKENDS = ("torch", "cuda")

_DEFAULT_ENGINES: dict[tuple[str, str], Engine] = {}


def resolve_backend(backend: str) -> str:
    """Map ``"auto"`` to the card.  There is no CPU fallback: without a
    card ``"auto"`` raises, and the CPU is asked for with ``"torch"``."""
    if backend == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: backend='auto' runs the NMC engines on the "
                "card; pass backend='torch' to run the plain PyTorch "
                "engines on the CPU")
        return "cuda"
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}: valid backends are "
            f"{BACKENDS + ('auto',)}")
    return backend


def get_engine(name: str, backend: str = "auto") -> Engine:
    """Default (paper-configuration) engine instances, shared per process.

    ``backend`` selects the implementation: ``"torch"`` (plain PyTorch),
    ``"cuda"`` (hand-written kernels), or ``"auto"`` (the card).
    """
    backend = resolve_backend(backend)
    key = (name, backend)
    if key not in _DEFAULT_ENGINES:
        if name not in ("caesar", "carus"):
            raise KeyError(name)
        if backend == "torch":
            cls = CaesarTile if name == "caesar" else CarusTile
        else:
            from repro_torch.nmc.cuda_engine import (CudaCaesarEngine,
                                                     CudaCarusEngine)
            cls = CudaCaesarEngine if name == "caesar" else CudaCarusEngine
        _DEFAULT_ENGINES[key] = cls()
    return _DEFAULT_ENGINES[key]


def implementations() -> tuple[tuple[str, str], ...]:
    """All registered ``(engine, backend)`` variants — the conformance
    matrix the tests sweep."""
    return tuple((n, b) for n in ("caesar", "carus") for b in BACKENDS)
