"""Serving engine: prefill + decode with in-place KV caches and continuous
batching.

The counterpart of the JAX package's ``serve/engine.py``, for the dense,
MoE (MLA attention included), hybrid SSM and xLSTM families; admission
walks the cache tree (dicts, lists, tuples) and writes each leaf of the
prompt's batch-1 caches into its slot on the batch axis
:func:`lm.cache_batch_axes` gives: KV caches, the hybrid's Mamba2 states,
the xLSTM's per-block float32 states.  A VLM or an
encoder-decoder model cannot be served, as in the reference: admission
prefills the prompt's tokens only, and the model's prefill raises
``KeyError: 'images'`` or ``KeyError: 'frames'``.  With
``nmc_mode='w8a8'`` every projection runs the quantized int8 path (params
converted once by :func:`quantize_params`; MoE expert banks become int8,
the router stays float; the hybrid's Mamba2 projections and the xLSTM's
blocks stay float, as the reference's ``quantize_tree`` leaves them, so an
xLSTM model's only int8 projection is its head), which on the card is the
hand-written ``nmc_matmul`` kernel, and every prefill attention is the
``flash_attention`` kernel.  Idle decode slots are fed
to ``decode_step`` like live ones, as in the reference: in a MoE model
they are routed too and take expert capacity, so a request's tokens
depend on what shares its batch.

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
(:meth:`ServeEngine.nmc_project`) are column-sharded across ``nmc_tiles``
tiles by the partitioning planner, and :meth:`ServeEngine.resident_block`
serves one decoder layer with its weights resident on the tile array
(:mod:`repro_torch.serve.block`).
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


def quantize_params(params: lm.LMBase, cfg: ModelConfig) -> lm.LMBase:
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

    def __init__(self, cfg: ModelConfig, params: lm.LMBase,
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
        """One W8A8 projection ``y = x8 @ w8`` executed on the NMC tile
        array, sharded across ``nmc_tiles`` tiles by the partitioning
        planner: activation entries are scalar taps, weight rows are
        resident vectors, and the ``"axis"`` strategy gives each tile a
        contiguous column slice of every weight row (the same layout the
        resident-block path keeps on-array), the gather reassembling
        ``(m, n)``.  At the default ``sew=8`` the result carries bit-exact
        int8 wrap-at-8 semantics (two's complement), matching the quantized
        kernels the Table V matmul models; ``sew=32`` widens the int8
        operands into 32-bit lanes for exact int32 accumulation (the
        resident-block serving contract).

        Projections routed here run on the simulated tile array through
        the same planner and bucketed executor cache as ``nmc.jit``
        kernels, submitted to *this engine's* dispatch queue
        (``nmc_queue``), so prefill/decode work and projection waves drain
        through one discipline.  Demo-scale by design — one projection per
        call, shapes bounded by a tile's SRAM macro."""
        x8 = np.asarray(x8, np.int8)
        w8 = np.asarray(w8, np.int8)
        m, k = x8.shape
        if w8.shape[0] != k:
            raise ValueError(f"shapes {x8.shape} @ {w8.shape} do not chain")
        n = int(w8.shape[1])
        # keyed on the full shape (m, k, n) plus sew: two weights with the
        # same (m, k) but different output widths n must not share a cache
        # entry, and sew=32 callers must not collide with sew=8
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
            # "axis" column-shards the weight loads (each tile holds its
            # slice of W, cpool replicated) — the layout wide projections
            # need to fit a tile's bank, and the one ResidentProjection
            # keeps on-array
            kern = nmc.jit(proj, sew=sew, tiles=self.nmc_tiles,
                           partition="axis", runtime=self._nmc_rt)
            self._nmc_proj[(m, k, n, sew)] = kern
        if sew == 8:
            return np.asarray(kern(x8, w8)).reshape(m, n)
        # widen int8 operands into sew-bit lanes: accumulation is exact
        # (k * 127^2 < 2^31 for any tile-resident k), true W8A8 GEMM
        return np.asarray(kern(x8.astype(np.int32),
                               w8.astype(np.int32))).reshape(m, n)

    def resident_block(self, layer: int = 0, rows: Optional[int] = None,
                       tiles: Optional[int] = None):
        """Build a :class:`repro_torch.serve.block.ResidentBlock` over one
        decoder layer's weights: the whole W8A8 block (q/k/v/o projections
        + MLP) runs as chained partitioned waves on the tile array with the
        quantized weights resident — loaded once, reused every token; only
        activation words cross the bus per call.

        ``rows`` is the per-call token-row count (defaults to this engine's
        slot count); ``tiles`` the per-projection shard width (defaults to
        ``nmc_tiles``).  Dispatches through this engine's queue, so block
        waves and serving traffic share one discipline."""
        from repro_torch.serve.block import ResidentBlock, layer_params
        if self.cfg.family not in ("dense", "vlm"):
            raise ValueError(
                f"resident_block supports stacked dense decoder layers, "
                f"not family {self.cfg.family!r}")
        lp = layer_params(self.params.layers[layer])
        return ResidentBlock(self.cfg, lp, queue=self.nmc_queue,
                             rows=rows if rows is not None else self.n_slots,
                             tiles=tiles if tiles is not None
                             else self.nmc_tiles)

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
            _insert_tree(self.caches, caches1, s, self._cache_axes)
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


def _insert_tree(full, one, s: int, axes) -> None:
    """Write the batch-1 cache tree ``one`` into slot ``s`` of the batched
    cache tree ``full`` (dicts, lists and tuples of tensors), in place,
    leaf by leaf along the explicit axes from :func:`lm.cache_batch_axes`."""
    if isinstance(full, torch.Tensor):
        full.narrow(axes, s, 1).copy_(one)
        return
    for k in (full if isinstance(full, dict) else range(len(full))):
        _insert_tree(full[k], one[k], s, axes[k])
