"""Elastic scaling + node-failure runtime.

The counterpart of the JAX package's ``runtime/elastic.py``.  On a real
cluster this sits on the coordination service: it watches the ranks'
health and, on a membership change, (i) drains in-flight steps, (ii)
rebuilds the mesh over the surviving or new ranks, (iii) restores the last
committed checkpoint resharded onto the new mesh and (iv) resumes: the
data pipeline is a pure function of the step, so no stream state needs
migrating.

The membership watcher is simulated (tests script resize events by step);
the re-mesh and reshard path is real: :func:`reshard_state` moves a state
onto a new mesh shape by gathering each full tensor (on the old mesh, when
its shardings are given) and slicing it for the new one.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import torch.distributed as dist

from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_mesh

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class ClusterView:
    n_devices: int
    generation: int = 0


class MembershipWatcher:
    """Simulated membership: tests script resize events by step index; the
    first view counts the world's ranks (1 without a world)."""

    def __init__(self, events: Optional[dict[int, int]] = None):
        self.events = events or {}
        self.view = ClusterView(n_devices=dist.get_world_size()
                                if dist.is_initialized() else 1)

    def poll(self, step: int) -> Optional[ClusterView]:
        if step in self.events:
            self.view = ClusterView(self.events[step],
                                    self.view.generation + 1)
            return self.view
        return None


def make_mesh_for(n_devices: int, model_parallel: int = 1, device=None):
    """Best-effort (data, model) mesh over ``n_devices`` ranks (the
    world's size): ``model`` the largest divisor of ``n_devices`` not over
    ``model_parallel``."""
    mp = max(1, min(model_parallel, n_devices))
    while n_devices % mp:
        mp -= 1
    return make_mesh((n_devices // mp, mp), ("data", "model"), device)


def reshard_state(state: dict, new_mesh, spec_fn: Callable,
                  old_shardings: Optional[dict] = None) -> dict:
    """``state`` (a tree of tensors: full ones, or local slices under the
    matching tree ``old_shardings``) on ``new_mesh``: each leaf gathered
    in full, then sliced by ``spec_fn(full_state, new_mesh)`` (a tree of
    Shardings, such as ``sharding.param_shardings``).  A collective when
    ``old_shardings`` is given."""
    def full(tree, shards):
        if isinstance(tree, dict):
            return {k: full(v, None if shards is None else shards[k])
                    for k, v in tree.items()}
        return tree if shards is None else sharding.gather_full(tree, shards)

    def cut(tree, shards):
        if isinstance(tree, dict):
            return {k: cut(v, shards[k]) for k, v in tree.items()}
        return sharding.local_slice(tree, shards)
    whole = full(state, old_shardings)
    return cut(whole, spec_fn(whole, new_mesh))


class HeartbeatMonitor:
    """Tracks per-step liveness; at scale this would be fed by the
    coordinator.  A missed deadline marks a suspected node failure and
    triggers the trainer's restart path."""

    def __init__(self, timeout_s: float = 300.0):
        self.timeout_s = timeout_s
        self.last_beat: Optional[float] = None
        self.failures: int = 0

    def beat(self, now: float):
        if self.last_beat is not None and \
                now - self.last_beat > self.timeout_s:
            self.failures += 1
            log.warning("heartbeat gap %.1fs > %.1fs: suspected failure",
                        now - self.last_beat, self.timeout_s)
        self.last_beat = now
