"""The NMC stack behind one import: ``from repro_torch import nmc``.

Authoring — write numpy-style Python, get the whole stack::

    from repro_torch import nmc

    @nmc.kernel                       # trace + engine auto-selection, SEW 8
    def fused(t, x, y):
        t.store((t.load(x) * 3 + t.load(y)).max(0))

    out = fused(xs, ys)               # sync: lower, schedule, run, extract
    fut = fused.call_async(xs, ys)    # async future — bit-exact vs sync

Calls run on the card by default (``backend="cuda"``); on the CPU pass a
runtime built with ``NmcRuntime(backend="torch")``.

Layers (each usable directly for expert control):

* :mod:`repro_torch.nmc.frontend` — the traced frontend: :func:`kernel` /
  :func:`jit` compile a Python function over :class:`NmcValue` tracers
  into a :class:`CompiledKernel`; engine auto-selection with
  :class:`UnsupportedOnEngine` diagnostics.
* :mod:`repro_torch.nmc.registry` — the op registry and the shared
  :class:`NmcRuntime` (one bucketed executor cache for sync + async).
* :mod:`repro_torch.nmc.program` — the engine-agnostic structured-array
  :class:`Program` IR covering NM-Caesar bus-op streams and NM-Carus
  xvnmc issue traces, plus the padding NOP and bucket rules.
* :mod:`repro_torch.nmc.engine` — the :class:`Engine` protocol (lower /
  run / extract / cost), the plain PyTorch tile engines, and the backend
  registry (``get_engine(name, backend)``).
* :mod:`repro_torch.nmc.cuda_engine` — the hand-written CUDA wave
  kernels: ``backend="cuda"`` runs a whole bucketed wave as one launch.
* :mod:`repro_torch.nmc.pool` — the batched executors: exact-shape
  :class:`TilePool`, shape-bucketed :class:`BucketedPool` and the
  persistently-resident :class:`ResidentPool`.
* :mod:`repro_torch.nmc.runtime` — the async double-buffered
  :class:`DispatchQueue`: futures, shadow-buffer staging, batched launch
  waves.
* :mod:`repro_torch.nmc.check` and :mod:`repro_torch.nmc.opt` — the static
  verifier and the translation-validated IR optimizer.

The partitioning planner and the wave scheduler (``tiles > 1``) are not
ported yet.
"""

from repro_torch.nmc.program import (PROG_DTYPE, Program, caesar_entry,
                                     carus_entry, instr_bucket, nop_entry,
                                     stack_programs)
from repro_torch.nmc.engine import (BACKENDS, CaesarTile, CarusTile, Engine,
                                    get_engine, implementations,
                                    resolve_backend)
from repro_torch.nmc.pool import (BucketedPool, ResidentPool, TilePool,
                                  tile_bucket)
from repro_torch.nmc.runtime import (DeviceFuture, DispatchQueue,
                                     GatherFuture, NMCFuture)
from repro_torch.nmc.registry import (NmcRuntime, default_runtime,
                                      set_default_runtime)
from repro_torch.nmc.frontend import (CompiledKernel, LoweredKernel,
                                      LoweringError, NmcValue,
                                      ProgramBuilder, TileContext,
                                      UnsupportedOnEngine, jit, kernel, mac,
                                      select_engine)
from repro_torch.nmc.check import (CHECK_MODES, CheckReport, Diagnostic,
                                   VerificationError, assert_submittable,
                                   assert_wave, verify_chained_waves,
                                   verify_lowered, verify_program,
                                   verify_resident)
from repro_torch.nmc.opt import (OPT_LEVELS, OptError, OptReport,
                                 RewriteRecord, optimize)

__all__ = [
    # the one-call frontend
    "jit", "kernel", "mac", "CompiledKernel", "LoweredKernel", "NmcValue",
    "ProgramBuilder", "TileContext", "UnsupportedOnEngine", "LoweringError",
    "select_engine",
    # static verification
    "CHECK_MODES", "CheckReport", "Diagnostic", "VerificationError",
    "verify_program", "verify_lowered", "verify_resident",
    "verify_chained_waves", "assert_wave", "assert_submittable",
    # analysis-driven IR optimizer
    "OPT_LEVELS", "OptError", "OptReport", "RewriteRecord", "optimize",
    # shared execution runtime
    "NmcRuntime", "default_runtime", "set_default_runtime",
    # unified program IR
    "PROG_DTYPE", "Program", "caesar_entry", "carus_entry", "nop_entry",
    "instr_bucket", "stack_programs",
    # engines / backends
    "CaesarTile", "CarusTile", "Engine", "get_engine", "BACKENDS",
    "implementations", "resolve_backend",
    # pools / scheduler
    "TilePool", "BucketedPool", "ResidentPool", "tile_bucket",
    # async dispatch runtime
    "DispatchQueue", "NMCFuture", "DeviceFuture", "GatherFuture",
]
