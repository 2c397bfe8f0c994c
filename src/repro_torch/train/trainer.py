"""Fault-tolerant training loop.

The counterpart of the JAX package's ``train/trainer.py``, on one device
or, with ``mesh``, on every rank of a mesh (each rank draws the same full
state from the seed and keeps its slices, reads the global batch and keeps
its rows; rank 0 alone writes the checkpoints, every rank restores them
sliced onto the mesh):

* periodic asynchronous checkpoints (the step loop never waits on the
  disk),
* automatic restart from the latest checkpoint on a ``RuntimeError`` in a
  step (a CUDA error, a lost card or a collective past the process
  group's timeout raises one too), up to ``max_restarts``: the data
  pipeline is a pure function of the step, so the token stream after the
  restore is the same; on a mesh every rank restarts from the same step
  (rank 0's pending write is committed before any rank looks for it),
* straggler detection: a step slower than ``straggler_factor`` times the
  rolling median of the last 50 is recorded (at scale it would trigger a
  hot-spare swap).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import DataConfig, make_dataset
from repro_torch.distributed import context as C
from repro_torch.models.config import ModelConfig, resolve_device
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib

log = logging.getLogger("repro_torch.train")


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    log_every: int = 10
    n_microbatches: int = 1
    compress_grads: bool = False
    straggler_factor: float = 3.0
    max_restarts: int = 3
    seed: int = 0


class Trainer:
    """Trains ``cfg`` from random weights (``torch.Generator`` seeded with
    ``tc.seed`` on the device) on the synthetic stream; runs on the card
    unless ``device`` names another, on ``mesh.device`` with a mesh."""

    def __init__(self, cfg: ModelConfig, tc: TrainerConfig,
                 opt_cfg: Optional[adamw.AdamWConfig] = None,
                 data_cfg: Optional[DataConfig] = None, device=None,
                 mesh: Optional[C.Mesh] = None):
        self.cfg = cfg
        self.tc = tc
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(
            total_steps=tc.total_steps)
        self.data_cfg = data_cfg or DataConfig(global_batch=8, seq_len=128,
                                               seed=tc.seed)
        self.dataset = make_dataset("synthetic", self.data_cfg, cfg)
        self.checkpointer = ckpt.AsyncCheckpointer(tc.ckpt_dir)
        self.step_times: list[float] = []
        self.straggler_events: list[int] = []
        self.restarts = 0
        self._train_step = step_lib.make_train_step(
            cfg, self.opt_cfg, tc.n_microbatches, tc.compress_grads)

    # -- state ---------------------------------------------------------------
    def init_state(self) -> tuple:
        """(model, optimizer state, step 0), freshly drawn."""
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        model, opt_state = step_lib.init_train_state(
            gen, self.cfg, self.tc.compress_grads, self.device, self.mesh)
        return model, opt_state, 0

    def _shardings(self, model, opt_state):
        return None if model.layout is None \
            else model.layout.state_shardings(opt_state)

    def _settle(self):
        """Rank 0's pending writes committed, then every rank past this
        point (a barrier on a mesh)."""
        self.checkpointer.wait()
        if self.mesh is not None and dist.is_initialized():
            dist.barrier()

    def maybe_restore(self, model, opt_state) -> tuple:
        """The latest committed checkpoint loaded into ``model`` and
        ``opt_state``: (model, opt_state, its step); step 0 without one."""
        last = ckpt.latest_step(self.tc.ckpt_dir)
        if last is None:
            return model, opt_state, 0
        log.info("restoring from step %d", last)
        params = dict(model.named_parameters())
        restored = ckpt.restore(self.tc.ckpt_dir, last,
                                {"params": params, "opt": opt_state},
                                self._shardings(model, opt_state))
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(restored["params"][name])
        return model, restored["opt"], last

    def batch_at(self, step: int) -> dict:
        """The dataset's batch for ``step`` as tensors on the device."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.dataset.batch_at(step).items()}

    # -- loop ----------------------------------------------------------------
    def run(self, fail_at: Optional[int] = None) -> dict:
        """Train to total_steps.  ``fail_at`` injects a crash once (tests)."""
        self._settle()
        model, opt_state, start = self.init_state()
        model, opt_state, start = self.maybe_restore(model, opt_state)
        step = start
        metrics = {}
        failed_once = False
        while step < self.tc.total_steps:
            try:
                if fail_at is not None and step == fail_at and not failed_once:
                    failed_once = True
                    raise RuntimeError("injected node failure")
                t0 = time.perf_counter()
                model, opt_state, metrics = self._train_step(
                    model, opt_state, self.batch_at(step))
                loss = float(metrics["loss"])     # waits for the step
                dt = time.perf_counter() - t0
                self._straggler_check(step, dt)
                step += 1
                if step % self.tc.ckpt_every == 0 or \
                        step == self.tc.total_steps:
                    self.checkpointer.submit(
                        step, {"params": dict(model.named_parameters()),
                               "opt": opt_state},
                        self._shardings(model, opt_state))
                if step % self.tc.log_every == 0:
                    log.info("step %d loss %.4f (%.0f ms)", step, loss,
                             dt * 1e3)
            except RuntimeError as e:
                self.restarts += 1
                if self.restarts > self.tc.max_restarts:
                    raise
                log.warning("step %d failed (%s); restarting from ckpt",
                            step, e)
                self._settle()
                model = opt_state = None       # free the old state first
                model, opt_state, step = self.init_state()
                model, opt_state, step = self.maybe_restore(model, opt_state)
        self._settle()
        return {"final_step": step, "metrics": metrics,
                "restarts": self.restarts,
                "stragglers": list(self.straggler_events)}

    def _straggler_check(self, step: int, dt: float):
        self.step_times.append(dt)
        hist = self.step_times[-50:]
        if len(hist) >= 5:
            med = float(np.median(hist))
            if dt > self.tc.straggler_factor * med:
                self.straggler_events.append(step)
                log.warning("straggler at step %d: %.0f ms vs median %.0f ms"
                            " — would trigger hot-spare mitigation", step,
                            dt * 1e3, med * 1e3)
