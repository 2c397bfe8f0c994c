"""Meshes over an initialised ``torch.distributed`` world, and the launcher
that starts its ranks.

The counterpart of the JAX package's ``launch/mesh.py``:
:func:`make_mesh` and :func:`make_local_mesh`.  Where the reference
reshapes its device list, the port lays its world's ranks out row-major
over the axes and creates one process group per axis and one for the data
axes together (every rank creates every group, in the same order, as
``torch.distributed`` requires).  :func:`make_production_mesh` lays out
the reference's production meshes, (data 16, model 16) and (pod 2, data
16, model 16), over a world of 256 or 512 ranks; the dry run
(:mod:`repro_torch.launch.dryrun`) builds them over a fake world on the
``meta`` device.

:func:`run_ranks` starts ``world`` processes (``spawn``), initialises each
over a ``file://`` store in a fresh temporary directory (parallel test
workers never race for a TCP port) with the backend the caller names, calls
``fn`` on each rank and returns the ranks' return values.  NCCL is the
default, one card per rank; gloo serves ranks that share one card or run
on the CPU.  The backend moves tensors and never decides where they are
computed: ``device="cuda"`` runs rank r on card ``r % device_count``.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distributed import context
from repro_torch.models.config import resolve_device


def _groups(shape: tuple, axes: tuple) -> dict:
    """For every single axis and the data axes together: the process group
    of this rank (None where it spans one rank).  Every rank creates every
    group in the same order."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = 1
    for s in shape:
        n *= s
    coords = {r: dict(zip(axes, _unravel(r, shape))) for r in range(n)}
    keys = [(a,) for a in axes]
    dax = tuple(a for a in context.DATA_AXES if a in axes)
    if len(dax) > 1:
        keys.append(dax)
    groups = {}
    for key in keys:
        if all(shape[axes.index(a)] == 1 for a in key):
            groups[key] = None
            continue
        blocks: dict = {}
        for r in range(n):
            other = tuple(coords[r][a] for a in axes if a not in key)
            blocks.setdefault(other, []).append(r)
        for ranks in blocks.values():
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[key] = group
    return groups


def _unravel(rank: int, shape: tuple) -> tuple:
    out = []
    for s in reversed(shape):
        rank, c = divmod(rank, s)
        out.append(c)
    return tuple(reversed(out))


def make_mesh(shape: tuple, axes: tuple, device=None) -> context.Mesh:
    """A mesh of ``shape`` named ``axes`` over the initialised world (its
    size must be the product of ``shape``; a one-rank mesh needs no world).
    ``device``: where this rank computes, the card when None."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"a mesh of {shape} needs {n} ranks, the world has "
                         f"{world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return context.Mesh(axis_names=axes, shape=dict(zip(axes, shape)),
                        coords=dict(zip(axes, _unravel(rank, shape))),
                        groups=_groups(shape, axes),
                        device=resolve_device(device),
                        backend=dist.get_backend() if dist.is_initialized()
                        else "none")


#: the production meshes: (shape, axes) single-pod and multi-pod
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> context.Mesh:
    """Single pod: (data=16, model=16), 256 ranks.  Multi-pod: (pod=2,
    data=16, model=16), 512 ranks.  Over the initialised world, which must
    have that many ranks (:func:`make_mesh` raises otherwise); ``device``
    is where this rank computes, ``meta`` for the dry run."""
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes, device)


def make_local_mesh(model_parallel: int = 1, device=None) -> context.Mesh:
    """A (data, model) mesh over the whole world with ``model_parallel``
    (at most the world size) ranks on ``model``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    mp_ = max(1, min(model_parallel, world))
    if world % mp_:
        raise ValueError(f"a world of {world} ranks is not a multiple of "
                         f"model_parallel {mp_}")
    return make_mesh((world // mp_, mp_), ("data", "model"), device)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def rank_device(device: str) -> torch.device:
    """This rank's device for ``device`` ("cuda": card rank % count)."""
    if device == "cuda":
        return torch.device("cuda", dist.get_rank() %
                            torch.cuda.device_count())
    return torch.device(device)


def _rank_main(fn, rank: int, world: int, init: str, backend: str,
               device: str, timeout: float, out_dir: str, args: tuple):
    if device == "cpu":
        torch.set_num_threads(1)
    try:
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            dev = rank_device(device)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            result = ("ok", fn(dev, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(os.path.join(out_dir, f"rank_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    if result[0] == "error":
        raise SystemExit(1)


def run_ranks(fn, world: int, *args, backend: str = "nccl",
              device: str = "cuda", timeout: float = 600.0,
              collective_timeout: float | None = None) -> list:
    """Run ``fn(device, *args)`` on ``world`` spawned ranks of one
    ``torch.distributed`` world and return their return values, by rank.
    ``fn`` must be importable (a module-level function), its arguments and
    return values picklable.  Every rank is joined within ``timeout``
    seconds; a rank that raises, exits without a result or is still
    running then fails the call (a RuntimeError with each failed rank's
    traceback), and a rank still running is killed.  Collectives time out
    after ``collective_timeout`` seconds (``timeout`` when None), so that
    one rank's failure does not leave the others waiting."""
    ctx = mp.get_context("spawn")
    env = {"OMP_NUM_THREADS": "1"} if device == "cpu" else {}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
            init = f"file://{os.path.join(tmp, 'store')}"
            procs = [ctx.Process(
                target=_rank_main,
                args=(fn, r, world, init, backend, device,
                      collective_timeout or timeout, tmp, args))
                for r in range(world)]
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results, errors = [], []
            for r, p in enumerate(procs):
                path = os.path.join(tmp, f"rank_{r}.pkl")
                if r in hung:
                    errors.append(f"rank {r}: still running after "
                                  f"{timeout} s, killed")
                    continue
                if not os.path.exists(path):
                    errors.append(f"rank {r}: exited with code {p.exitcode} "
                                  f"and no result")
                    continue
                with open(path, "rb") as f:
                    status, value = pickle.load(f)
                if status != "ok":
                    errors.append(f"rank {r}:\n{value}")
                results.append(value)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if errors:
        raise RuntimeError(f"{len(errors)} of {world} ranks failed:\n"
                           + "\n".join(errors))
    return results
