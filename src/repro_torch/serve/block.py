"""Resident W8A8 transformer-block serving on the tile array (DESIGN.md §12).

The serving layer's steady state is the paper's memory-mode / compute-mode
duality at block granularity: a decoder layer's quantized weights are DMA'd
onto the tile array **once** (memory-mode write), and every decoded token
then runs the whole block — attention q/k/v/o projections plus the MLP
up/gate/down GEMMs — as a chain of partitioned waves against the resident
weights, with only the per-call activation words and instruction streams
crossing the 32-bit system bus.

Three cooperating pieces:

* :class:`ResidentProjection` — one ``y = X @ W`` GEMM kept resident on a
  dedicated set of tiles.  Built once per weight: the kernel is traced,
  column-sharded across the array (``partition="axis"`` — each tile owns a
  contiguous column slice of ``W``, so the *weights* are partitioned, not
  replicated), and lowered to a fixed wave of tile images.  Per call, only
  the activation scalar-tap pool changes: the builder proves the memory
  layout is value-independent (two traces over different activations must
  agree on :attr:`repro_torch.nmc.partition.PartitionPlan.signature`, program
  entries and every non-``t.consts`` image word) and then serves every
  call by *patching* exactly the cpool words
  (:meth:`repro_torch.nmc.pool.ResidentPool.patch` via the queue's ``patch=``
  submission) — weights never cross the bus again.  If the proof fails the
  projection degrades to a correct full-reload path (never wrong, just not
  resident).
* :class:`ResidentBlock` — the whole decoder block.  Host stages (RMSNorm,
  dynamic per-row activation quantization, GQA attention softmax, SiLU
  gating, dequantization epilogues) run in float on the host — the paper's
  eCPU/host split: NMC tiles own the integer GEMMs, the host owns the
  cheap nonlinearities.  Every GEMM routes through a pluggable ``mm``
  backend, so the resident path, the per-projection
  :meth:`repro_torch.serve.engine.ServeEngine.nmc_project` path and the
  exact PyTorch int32 GEMM (:meth:`ResidentBlock.torch_mm`) share every
  non-GEMM instruction — bit-exact
  equality of the three paths reduces to bit-exact int32 GEMMs, which SEW
  32 guarantees (``k * 127^2 < 2^31``: int8 operands in 32-bit lanes
  accumulate exactly).
* :func:`ResidentBlock.step_cycles` — the modeled cost of one token step:
  the four dependent waves (q/k/v | o | up/gate | down) through
  :func:`repro_torch.core.timing.chained_wave_cycles`, with steady-state stages
  charged only their patched activation words on the input DMA leg.

Engine restriction: NM-Caesar only.  Caesar materializes every ``t.consts``
element as one splat word in tile memory, so patching the cpool span
retargets the resident program.  NM-Carus embeds scalar-tap *values* in the
instruction stream (``EMVX``/``sval1``), so patching the VRF alone cannot
change what a resident Carus program computes — the builder rejects it.

Positional rotation (RoPE) is deliberately outside this block: it acts on
q/k *after* projection and is host-side float work like the softmax, so the
resident GEMM contract is unchanged by it.  Callers that need positions
apply the rotation between :meth:`ResidentBlock.step`'s projections — the
block models the paper's tile-array workload, not a full LM stack.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import nmc
from repro_torch.core import timing
from repro_torch.kernels import ref
from repro_torch.nmc import check as nmc_check
from repro_torch.nmc.pool import WORD_BYTES
from repro_torch.nmc.runtime import DispatchQueue, GatherFuture

#: Unique id per ResidentProjection: its tiles live in a private namespace
#: ``("resident", uid, shard)`` that can never collide with the runtime's
#: ``("jit", k)`` tiles or the pools' ``("build", n)`` / ``("lane", k)``
#: ids — residency depends on nobody ever re-installing these tiles.
_IDS = itertools.count()


# ---------------------------------------------------------------------------
# Host-side numerics (shared verbatim by all three mm backends)
# ---------------------------------------------------------------------------

def splat_words(vals: np.ndarray, sew: int) -> np.ndarray:
    """Vectorized :func:`repro_torch.nmc.frontend.splat_word`: replicate each
    SEW-bit value across its 32-bit word (identity at SEW 32).  These are
    the words a ``t.consts`` element occupies in an NM-Caesar image — the
    patch payload of the resident serving path."""
    v = np.asarray(vals).astype(np.int64) & ((1 << sew) - 1)
    w = np.zeros(v.shape, np.int64)
    for k in range(32 // sew):
        w = w | (v << (sew * k))
    return (w & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def quantize_rows(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Dynamic symmetric per-row int8 activation quantization (the W8A8
    "A8" half): each row scales by ``max|x| / 127``."""
    x = np.asarray(x, np.float32)
    amax = np.max(np.abs(x), axis=-1)
    s = np.maximum(amax, 1e-8) / 127.0
    q = np.clip(np.rint(x / s[:, None]), -127, 127).astype(np.int8)
    return q, s


def quantize_cols(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-column int8 weight quantization (the "W8"
    half — the same rule as :func:`repro_torch.models.layers.linear_quantize`,
    in numpy)."""
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=0)
    s = np.maximum(amax, 1e-8) / 127.0
    q = np.clip(np.rint(w / s[None, :]), -127, 127).astype(np.int8)
    return q, s


def _quantize_linear(p: dict) -> tuple[np.ndarray, np.ndarray,
                                       Optional[np.ndarray]]:
    """A linear param leaf -> (int8 weight, per-column scale, bias|None).
    Accepts both trained (``{"w", "b"?}``) and already-quantized serving
    (``{"w_q", "scale", "b"?}``) forms."""
    if "w_q" in p:
        w8 = np.asarray(p["w_q"], np.int8)
        s = np.asarray(p["scale"], np.float32)
    else:
        w8, s = quantize_cols(np.asarray(p["w"], np.float32))
    b = np.asarray(p["b"], np.float32) if "b" in p else None
    return w8, s, b


def layer_params(block) -> dict:
    """One decoder layer of the port's model
    (:class:`repro_torch.models.lm.DecoderBlock`) as the nested dict of
    numpy leaves :class:`ResidentBlock` takes: ``attn`` / ``mlp`` linears
    (trained ``{"w", "b"?}`` or quantized ``{"w_q", "scale", "b"?}``) and
    the ``ln1`` / ``ln2`` gains."""
    def linear(lin) -> dict:
        keys = ("w_q", "scale", "b") if lin.w_q is not None else ("w", "b")
        return {k: getattr(lin, k).detach().float().cpu().numpy()
                if k != "w_q" else lin.w_q.detach().cpu().numpy()
                for k in keys if getattr(lin, k) is not None}
    attn, mlp = block.attn, block.mlp
    out = {"attn": {n: linear(getattr(attn, n))
                    for n in ("wq", "wk", "wv", "wo")},
           "mlp": {n: linear(getattr(mlp, n)) for n in ("wi", "wo")},
           "ln1": {"g": block.ln1.g.detach().float().cpu().numpy()},
           "ln2": {"g": block.ln2.g.detach().float().cpu().numpy()}}
    if mlp.wg is not None:
        out["mlp"]["wg"] = linear(mlp.wg)
    return out


def _rmsnorm(x: np.ndarray, g: np.ndarray, eps: float) -> np.ndarray:
    xf = np.asarray(x, np.float32)
    r = 1.0 / np.sqrt(np.mean(xf * xf, axis=-1, keepdims=True) + eps)
    return xf * r * g[None, :]


def _silu(x: np.ndarray) -> np.ndarray:
    return x / (1.0 + np.exp(-x))


# ---------------------------------------------------------------------------
# One GEMM resident on a set of tiles
# ---------------------------------------------------------------------------

class ResidentProjection:
    """One W8A8 projection ``y = X @ W`` with ``W`` resident on the array.

    ``W`` (``(k, n)`` int8) is column-sharded across ``tiles`` NM-Caesar
    tiles at SEW 32 (exact int32 accumulation) by the ``"axis"`` partition
    strategy: each shard's image holds its column slice of every weight
    row (bank 1) plus the replicated activation scalar-tap pool (bank 0).
    The build proves the image layout is independent of activation
    *values*; per call only the cpool words are patched onto the resident
    state and the wave re-dispatches — ``ResidentPool.loads`` counts the
    one-time weight DMA, ``patches``/``patch_bytes`` the per-call
    activation traffic.
    """

    def __init__(self, name: str, w8: np.ndarray, queue: DispatchQueue,
                 rows: int, tiles: int, engine: str = "caesar"):
        if engine != "caesar":
            raise nmc.LoweringError(
                f"resident projection '{name}' requires NM-Caesar: NM-Carus "
                f"embeds scalar-tap values in the instruction stream "
                f"(EMVX/sval1), so patching resident VRF words cannot "
                f"retarget the program")
        self.name = name
        self.queue = queue
        self.w8 = np.ascontiguousarray(np.asarray(w8, np.int8))
        self.k, self.n = (int(d) for d in self.w8.shape)
        self.m = int(rows)
        self.sew = 32
        m, k = self.m, self.k

        def proj(t, X, W):
            a = t.consts(X)
            cols = [t.load(W[r]) for r in range(k)]
            for i in range(m):
                acc = None
                for r in range(k):
                    acc = nmc.mac(acc, a[i, r], cols[r])
                t.store(acc)

        proj.__name__ = f"resident_{name}"
        self.kern = nmc.jit(proj, engine="caesar", sew=self.sew,
                            tiles=int(tiles), partition="axis")
        self._w32 = self.w8.astype(np.int32)
        # value-independence proof: lower the wave over two activation
        # fillings (a deterministic non-zero probe and all-zeros) — the
        # plan signature, every program entry and every image word outside
        # the cpool spans must agree, or patching is unsound
        probe = ((np.arange(m * k, dtype=np.int64) * 37 + 11) % 251 - 125)
        probe = probe.astype(np.int32).reshape(m, k)
        plan_p, lks_p = self.kern.lower_wave(probe, self._w32)
        plan_z, lks_z = self.kern.lower_wave(np.zeros((m, k), np.int32),
                                             self._w32)
        self.static = _layout_static(plan_p, lks_p, plan_z, lks_z)
        self.plan, self.lks = plan_p, lks_p
        # residency hazard pass (repro_torch.nmc.check.residency): statically
        # prove per shard that patch spans never alias the resident
        # weight spans and no program write mutates image-defined words —
        # the contract every later patch-only submit depends on
        self.hazard_reports = tuple(
            nmc_check.verify_resident(lk, kernel=f"{proj.__name__}[{j}]")
            for j, lk in enumerate(lks_p))
        for rep in self.hazard_reports:
            rep.raise_if_errors()
        uid = next(_IDS)
        self.tiles = tuple(("resident", uid, j) for j in range(len(lks_p)))
        self._installed = False

    @property
    def n_shards(self) -> int:
        return len(self.lks)

    # -- execution -----------------------------------------------------------
    def submit(self, x8) -> GatherFuture:
        """Queue the projection over one activation batch ``(m, k)``;
        returns the gather future immediately (so q/k/v can land in one
        launch wave).  First call ships the weight images; every later
        call patches only the cpool words."""
        x = np.asarray(x8)
        assert x.shape == (self.m, self.k), (x.shape, (self.m, self.k))
        x32 = np.ascontiguousarray(x.astype(np.int32))
        if not self.static:
            # correct-but-cold fallback: value-dependent layout means the
            # whole image reloads per call (residency proof failed)
            plan, lks = self.kern.lower_wave(x32, self._w32)
            futs = [self.queue.submit(t, lk.program, image=lk.mem,
                                      out_slice=lk.out_slice, post=lk.post)
                    for t, lk in zip(self.tiles, lks)]
            return GatherFuture(futs, plan.gather)
        words = splat_words(x32.reshape(-1), self.sew)
        futs = []
        for tile, lk in zip(self.tiles, self.lks):
            patch = []
            for lo, ne in lk.cpool_spans:
                assert ne == words.size, (self.name, ne, words.size)
                patch.append((lo, words))
            futs.append(self.queue.submit(
                tile, lk.program,
                image=None if self._installed else lk.mem,
                out_slice=lk.out_slice, post=lk.post, patch=patch))
        self._installed = True
        return GatherFuture(futs, self.plan.gather)

    def __call__(self, x8) -> np.ndarray:
        return np.asarray(self.submit(x8).result()).reshape(self.m, self.n)

    # -- cost model ----------------------------------------------------------
    def stage_costs(self, steady: bool = True) -> list[timing.StageCost]:
        """One :class:`repro_torch.core.timing.StageCost` per shard.  Cold stages
        charge the full image DMA on the input leg (``used_words``, the
        :func:`repro_torch.core.timing.stage_cost` convention); steady stages
        charge only the patched cpool words — the resident contract that
        per-call memory-mode traffic is O(activations), not O(image).
        Instruction-stream bytes are charged by neither (same as
        ``stage_cost``), so steady-vs-cold compares memory-mode DMA only;
        :meth:`patch_bytes_per_call` exposes the raw byte count for
        benchmark-side accounting."""
        out = []
        for j, lk in enumerate(self.lks):
            cold = timing.stage_cost(lk, name=f"{self.name}[{j}]")
            if not steady or not self.static:
                out.append(cold)
                continue
            patch_words = sum(ne for _, ne in lk.cpool_spans)
            out.append(timing.StageCost(
                cold.name,
                dma_in_cycles=timing.dma_cycles(patch_words * WORD_BYTES),
                compute_cycles=cold.compute_cycles,
                dma_out_cycles=cold.dma_out_cycles))
        return out

    @property
    def patch_bytes_per_call(self) -> int:
        """Bytes patched onto the array per steady-state call: every
        shard's replicated cpool words.  Matches what one resident call
        adds to ``ResidentPool.patch_bytes`` exactly (asserted in
        tests/test_torch_block.py); instruction-stream bytes are separate
        (``ResidentPool.dispatch`` accounting)."""
        return sum(ne for lk in self.lks
                   for _, ne in lk.cpool_spans) * WORD_BYTES


def _layout_static(plan_a, lks_a, plan_b, lks_b) -> bool:
    """True iff two lowerings of one kernel over different activation
    values agree on everything but the ``t.consts`` image words."""
    if plan_a.signature != plan_b.signature or len(lks_a) != len(lks_b):
        return False
    for a, b in zip(lks_a, lks_b):
        if a.cpool_spans != b.cpool_spans or a.out_slice != b.out_slice:
            return False
        if not np.array_equal(a.program.entries, b.program.entries):
            return False
        fa = np.asarray(a.mem).reshape(-1)
        fb = np.asarray(b.mem).reshape(-1)
        if fa.size != fb.size:
            return False
        keep = np.ones(fa.size, bool)
        for lo, ne in a.cpool_spans:     # Caesar: one splat word / element
            keep[lo:lo + ne] = False
        if not np.array_equal(fa[keep], fb[keep]):
            return False
    return True


# ---------------------------------------------------------------------------
# The whole decoder block, weights resident
# ---------------------------------------------------------------------------

class ResidentBlock:
    """One W8A8 decoder block (GQA attention + MLP) served off the tile
    array with all seven projection weights resident.

    ``step(x, state)`` advances ``m`` independent decode rows by one token:
    four dependent GEMM waves (q/k/v — o — up/gate — down) chained through
    the dispatch queue, all host stages in float32 numpy.  The ``mm``
    hook swaps the GEMM backend — ``None`` (resident tiles, the real
    path), :meth:`project_mm` (per-projection ``ServeEngine.nmc_project``
    at SEW 32) or :meth:`torch_mm` (exact PyTorch int32 GEMM) —
    while every other instruction is shared, so the three paths are
    bit-exact equal (tests/test_torch_block.py).
    """

    def __init__(self, cfg, layer_params: dict, queue: Optional[DispatchQueue]
                 = None, rows: int = 4, tiles: int = 1):
        self.cfg = cfg
        self.m = int(rows)
        self.queue = queue if queue is not None \
            else nmc.default_runtime().queue
        self.d = int(cfg.d_model)
        self.heads = int(cfg.n_heads)
        self.kv_heads = int(cfg.n_kv_heads)
        self.hd = int(cfg.head_dim) or self.d // self.heads
        attn, mlp = layer_params["attn"], layer_params["mlp"]
        self.gated = "wg" in mlp
        self.g1 = np.asarray(layer_params["ln1"]["g"], np.float32)
        self.g2 = np.asarray(layer_params["ln2"]["g"], np.float32)
        specs = [("wq", attn["wq"]), ("wk", attn["wk"]), ("wv", attn["wv"]),
                 ("wo", attn["wo"]), ("wi", mlp["wi"])]
        if self.gated:
            specs.append(("wg", mlp["wg"]))
        specs.append(("wo2", mlp["wo"]))
        self.w8: dict = {}
        self.w_scale: dict = {}
        self.bias: dict = {}
        self._proj: dict = {}
        for name, p in specs:
            w8, s, b = _quantize_linear(p)
            self.w8[name], self.w_scale[name], self.bias[name] = w8, s, b
            self._proj[name] = ResidentProjection(
                name, w8, self.queue, rows=self.m, tiles=tiles)
        # the four dependent waves of one step must be tile-disjoint, or
        # wave k+1's DMA-in races wave k's DMA-out on a shared tile; the
        # private ("resident", uid, shard) namespace makes this hold by
        # construction — the hazard pass proves it stays that way
        self.wave_report = nmc_check.verify_chained_waves(
            self._step_wave_tiles(), kernel="resident_block")
        self.wave_report.raise_if_errors()

    def _step_wave_tiles(self) -> list:
        """Tile IDs of the four dependent GEMM waves of one step
        (mirrors :meth:`step_waves`): [q/k/v], [o], [up(/gate)], [down]."""
        qkv = [t for n in ("wq", "wk", "wv") for t in self._proj[n].tiles]
        up = list(self._proj["wi"].tiles)
        if self.gated:
            up += self._proj["wg"].tiles
        return [qkv, list(self._proj["wo"].tiles), up,
                list(self._proj["wo2"].tiles)]

    # -- introspection -------------------------------------------------------
    @property
    def pool(self):
        """The ResidentPool under the queue — where the residency counters
        (``loads`` / ``patches`` / ``patch_bytes``) live."""
        return self.queue.pool

    @property
    def n_shards(self) -> int:
        """Total tile count the block occupies (sum over projections)."""
        return sum(p.n_shards for p in self._proj.values())

    @property
    def static(self) -> bool:
        """True iff every projection passed the value-independence proof
        (all weights genuinely resident; no full-reload fallbacks)."""
        return all(p.static for p in self._proj.values())

    @property
    def patch_bytes_per_call(self) -> int:
        """Activation bytes patched onto the array per block step (sum
        over all seven projections' shards)."""
        return sum(p.patch_bytes_per_call for p in self._proj.values())

    # -- mm backends ---------------------------------------------------------
    def torch_mm(self, name: str, x8: np.ndarray) -> np.ndarray:
        """Exact int32 GEMM reference: the plain ``nmc_matmul`` accumulator
        (int64 on the CPU) over the int8 operands — exactly what SEW-32 MAC
        chains accumulate."""
        acc = ref.nmc_matmul(torch.as_tensor(np.asarray(x8, np.int8)),
                             torch.as_tensor(self.w8[name]), None,
                             out_dtype=torch.int32)
        return acc.numpy()

    def project_mm(self, engine) -> Callable:
        """mm backend routing each GEMM through
        :meth:`repro_torch.serve.engine.ServeEngine.nmc_project` at SEW 32 (the
        per-projection tile-array comparison path)."""
        return lambda name, x8: engine.nmc_project(x8, self.w8[name], sew=32)

    # -- block step ----------------------------------------------------------
    def init_state(self, max_len: int = 64) -> dict:
        """Fresh attention state: per-row k/v history (float32, post-
        dequantization values) plus the current length."""
        shape = (self.m, int(max_len), self.kv_heads, self.hd)
        return {"k": np.zeros(shape, np.float32),
                "v": np.zeros(shape, np.float32), "len": 0}

    def _project(self, names: list, x: np.ndarray, mm) -> dict:
        """Quantize once, run the named GEMMs (one launch wave on the
        resident path: all submits precede the first resolve), dequantize
        with the shared epilogue."""
        x8, sx = quantize_rows(x)
        if mm is None:
            futs = [(n, self._proj[n].submit(x8)) for n in names]
            raw = {n: np.asarray(f.result()) for n, f in futs}
        else:
            raw = {n: np.asarray(mm(n, x8)) for n in names}
        out = {}
        for n in names:
            y = raw[n].reshape(self.m, -1).astype(np.float32) \
                * (sx[:, None] * self.w_scale[n][None, :])
            if self.bias[n] is not None:
                y = y + self.bias[n][None, :]
            out[n] = y
        return out

    def _attention(self, q, k_hist, v_hist) -> np.ndarray:
        """Host-side GQA attention (float32 softmax; kv heads repeat up to
        query heads).  q: (m, H, hd); histories: (m, T, KVH, hd)."""
        rep = self.heads // self.kv_heads
        kf = np.repeat(k_hist, rep, axis=2)
        vf = np.repeat(v_hist, rep, axis=2)
        s = np.einsum("mhd,mthd->mht", q, kf) / np.sqrt(float(self.hd))
        s = s - s.max(axis=-1, keepdims=True)
        p = np.exp(s)
        p = p / p.sum(axis=-1, keepdims=True)
        return np.einsum("mht,mthd->mhd", p, vf)

    def step(self, x, state: dict, mm=None) -> tuple[np.ndarray, dict]:
        """One decode step for ``m`` rows: ``(m, d) -> (m, d)``, updating
        ``state`` in place (callers comparing backends pass independent
        states)."""
        x = np.asarray(x, np.float32)
        assert x.shape == (self.m, self.d), (x.shape, (self.m, self.d))
        h = _rmsnorm(x, self.g1, self.cfg.norm_eps)
        qkv = self._project(["wq", "wk", "wv"], h, mm)
        q = qkv["wq"].reshape(self.m, self.heads, self.hd)
        knew = qkv["wk"].reshape(self.m, self.kv_heads, self.hd)
        vnew = qkv["wv"].reshape(self.m, self.kv_heads, self.hd)
        t = int(state["len"])
        assert t < state["k"].shape[1], "attention state full — raise max_len"
        state["k"][:, t] = knew
        state["v"][:, t] = vnew
        state["len"] = t + 1
        att = self._attention(q, state["k"][:, :t + 1], state["v"][:, :t + 1])
        x = x + self._project(
            ["wo"], att.reshape(self.m, self.heads * self.hd), mm)["wo"]
        h = _rmsnorm(x, self.g2, self.cfg.norm_eps)
        if self.gated:
            up = self._project(["wi", "wg"], h, mm)
            mid = up["wi"] * _silu(up["wg"])
        else:
            mid = _silu(self._project(["wi"], h, mm)["wi"])
        x = x + self._project(["wo2"], mid, mm)["wo2"]
        return x, state

    # -- cost model ----------------------------------------------------------
    def step_waves(self, steady: bool = True) -> list:
        """The four dependent GEMM waves of one step as StageCost lists:
        [q/k/v], [o], [up(/gate)], [down]."""
        qkv = [s for n in ("wq", "wk", "wv")
               for s in self._proj[n].stage_costs(steady)]
        up = list(self._proj["wi"].stage_costs(steady))
        if self.gated:
            up += self._proj["wg"].stage_costs(steady)
        return [qkv, self._proj["wo"].stage_costs(steady), up,
                self._proj["wo2"].stage_costs(steady)]

    def step_cycles(self, steady: bool = True) -> float:
        """Modeled cycles of one block step: the dependent wave chain
        through :func:`repro_torch.core.timing.chained_wave_cycles` on an array
        wide enough that every shard owns its tile (which is how the
        resident tiles are actually laid out)."""
        waves = self.step_waves(steady)
        return timing.chained_wave_cycles(waves,
                                          max(len(w) for w in waves))
