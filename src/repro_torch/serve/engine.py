"""Serving engine: prefill + decode with in-place KV caches and continuous
batching.

The counterpart of the JAX package's ``serve/engine.py``.  With
``nmc_mode='w8a8'`` every projection runs the quantized int8 path (params
converted once by :func:`quantize_params`), which on the card is the
hand-written ``nmc_matmul`` kernel, and every prefill layer's attention is
the ``flash_attention`` kernel.

:class:`ServeEngine` implements slot-based continuous batching: a fixed
decode batch of ``n_slots`` slots; a finished sequence frees its slot, and
queued requests are prefilled into free slots (at batch 1).  All device
work — prefill admission and decode steps — is submitted as queued work
through a :class:`repro_torch.nmc.DispatchQueue` (``submit_call``): CUDA
launches are asynchronous, and the engine blocks only where the host needs
a sampled token.  A batch of admissions launches all its prefills before
the first cache merge.

The engine runs on the card unless ``device="cpu"`` is asked for.
W8A8 projections offloaded to the simulated NMC tile array
(:meth:`ServeEngine.nmc_project`) run on one tile: sharding across tiles
and the resident-block path wait for the port's partitioning planner and
``serve/block.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import nmc
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, resolve_device
from repro_torch.nmc import DispatchQueue


def quantize_params(params: lm.DecoderLM, cfg: ModelConfig) -> lm.DecoderLM:
    """The NMC int8 serving form of trained params (a copy; norm gains and
    embeddings are shared with ``params``)."""
    return L.quantize_tree(params)


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, batch):
        return lm.prefill(params, batch, cfg, max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, tokens, caches, cache_len):
        return lm.decode_step(params, tokens, caches, cache_len, cfg)
    return decode_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int = 16
    out: Optional[list] = None


class ServeEngine:
    """Slot-based continuous batching on one device."""

    def __init__(self, cfg: ModelConfig, params: lm.DecoderLM,
                 n_slots: int = 4, max_len: int = 256,
                 nmc_queue: Optional[DispatchQueue] = None,
                 nmc_tiles: int = 1, max_prefills: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params are on {params.device}, the engine "
                             f"serves on {self.device}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        # admission control: at most this many prefills launch per step
        # (None = one per free slot), so prefill work interleaves with
        # decode steps instead of stalling every active slot behind a
        # burst of arrivals
        if max_prefills is not None and max_prefills < 1:
            raise ValueError(
                f"max_prefills must be >= 1 or None, got {max_prefills!r}")
        self.max_prefills = max_prefills
        if nmc_queue is None:
            nmc_queue = nmc.default_runtime().queue \
                if self.device.type == "cuda" \
                else nmc.NmcRuntime(backend="torch").queue
        self.nmc_queue = nmc_queue
        self.nmc_tiles = int(nmc_tiles)
        if self.nmc_tiles < 1:
            raise ValueError(f"nmc_tiles must be >= 1, got {nmc_tiles!r}")
        self._nmc_rt = nmc.NmcRuntime.for_queue(self.nmc_queue)
        self._nmc_proj: dict = {}       # (m, k, n, sew) -> CompiledKernel
        self.decode = make_decode_step(cfg)
        self.prefill = make_prefill_step(cfg, max_len)
        self.caches = lm.init_caches(params, cfg, n_slots, max_len,
                                     dtype=cfg.dtype)
        # explicit per-leaf batch axes from the family that built the cache
        self._cache_axes = lm.cache_batch_axes(cfg, self.caches)
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self.slot_len = np.zeros(n_slots, np.int32)
        self.slot_remaining = np.zeros(n_slots, np.int32)
        self.slot_last_tok = np.zeros(n_slots, np.int32)
        self.queue: list[Request] = []
        self.done: list[Request] = []

    # -- NMC tile-array offload ----------------------------------------------
    def nmc_project(self, x8, w8, sew: int = 8) -> np.ndarray:
        """One W8A8 projection ``y = x8 @ w8`` executed on the simulated
        NMC tile array through this engine's dispatch queue: activation
        entries are scalar taps, weight rows resident vectors.  At the
        default ``sew=8`` the result wraps at 8 bits (two's complement),
        like the quantized kernels the Table V matmul models; ``sew=32``
        widens the int8 operands for exact int32 accumulation.  Runs on
        one tile: ``nmc_tiles > 1`` raises ``NotImplementedError`` until
        the port's partitioning planner lands."""
        if self.nmc_tiles > 1:
            raise NotImplementedError(
                "nmc_project with nmc_tiles > 1 needs the partitioning "
                "planner (nmc/partition.py), which the PyTorch port does "
                "not have yet; use nmc_tiles=1")
        x8 = np.asarray(x8, np.int8)
        w8 = np.asarray(w8, np.int8)
        m, k = x8.shape
        if w8.shape[0] != k:
            raise ValueError(f"shapes {x8.shape} @ {w8.shape} do not chain")
        n = int(w8.shape[1])
        kern = self._nmc_proj.get((m, k, n, sew))
        if kern is None:
            def proj(t, X, W):
                a = t.consts(X)
                rows = [t.load(W[r]) for r in range(k)]
                for i in range(m):
                    acc = None
                    for kk in range(k):
                        acc = nmc.mac(acc, a[i, kk], rows[kk])
                    t.store(acc)
            kern = nmc.jit(proj, sew=sew, tiles=1, runtime=self._nmc_rt)
            self._nmc_proj[(m, k, n, sew)] = kern
        if sew == 8:
            return np.asarray(kern(x8, w8)).reshape(m, n)
        return np.asarray(kern(x8.astype(np.int32),
                               w8.astype(np.int32))).reshape(m, n)

    def resident_block(self, layer: int = 0, rows: Optional[int] = None,
                       tiles: Optional[int] = None):
        """The resident W8A8 decoder block on the tile array: not ported
        yet."""
        raise NotImplementedError(
            "resident_block needs serve/block.py, which the PyTorch port "
            "does not have yet (ROADMAP.md, queue 1)")

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request):
        req.out = []
        self.queue.append(req)

    @torch.inference_mode()
    def _admit(self):
        # two-phase admission: launch a prefill for every (free slot,
        # queued request) pair first, then resolve and merge caches
        launches = []
        for s in range(self.n_slots):
            if self.max_prefills is not None \
                    and len(launches) >= self.max_prefills:
                break
            if self.slot_req[s] is None and self.queue:
                req = self.queue.pop(0)
                tokens = torch.as_tensor(np.asarray(req.prompt)[None],
                                         device=self.device)
                fut = self.nmc_queue.submit_call(self.prefill, self.params,
                                                 {"tokens": tokens})
                launches.append((s, req, fut))
        for s, req, fut in launches:
            logits, caches1 = fut.value
            for name, full in self.caches["layers"].items():
                _insert_slot(full, caches1["layers"][name], s,
                             self._cache_axes["layers"][name])
            tok = int(torch.argmax(logits[0]))
            req.out.append(tok)
            self.slot_req[s] = req
            self.slot_len[s] = len(req.prompt) + 1
            self.slot_remaining[s] = req.max_new - 1
            self.slot_last_tok[s] = tok
            # prefill itself produced one token; a request exhausted by it
            # (max_new=1, or the prompt already fills max_len) retires here
            # instead of riding a decode step that would emit an extra token
            if self.slot_remaining[s] <= 0 or self.slot_len[s] >= self.max_len:
                self.done.append(req)
                self.slot_req[s] = None

    # -- decode loop ----------------------------------------------------------
    @torch.inference_mode()
    def step(self):
        self._admit()
        active = [s for s in range(self.n_slots) if self.slot_req[s]]
        if not active:
            return False
        toks = torch.as_tensor(self.slot_last_tok[:, None],
                               device=self.device)
        clen = torch.as_tensor(self.slot_len, device=self.device)
        fut = self.nmc_queue.submit_call(self.decode, self.params, toks,
                                         self.caches, clen)
        logits, self.caches = fut.value
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for s in active:
            req = self.slot_req[s]
            req.out.append(int(nxt[s]))
            self.slot_last_tok[s] = int(nxt[s])
            self.slot_len[s] += 1
            self.slot_remaining[s] -= 1
            if self.slot_remaining[s] <= 0 or self.slot_len[s] >= self.max_len:
                self.done.append(req)
                self.slot_req[s] = None
        return True

    def run(self, max_steps: int = 1000):
        steps = 0
        while (self.queue or any(self.slot_req)) and steps < max_steps:
            self.step()
            steps += 1
        return self.done


def _insert_slot(full: torch.Tensor, one: torch.Tensor, s: int,
                 axis: int) -> None:
    """Write a batch-1 cache entry into slot ``s`` of the batched cache, in
    place, along the explicit ``axis`` from :func:`lm.cache_batch_axes`."""
    full.narrow(axis, s, 1).copy_(one)
