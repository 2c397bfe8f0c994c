"""Sharding rules: parameter, optimizer-moment, batch and cache specs, and
the two functions that turn a spec into data.

The counterpart of the JAX package's ``distributed/sharding.py``, with its
layout (DESIGN.md Layer C):

* ``model`` axis: tensor parallelism over attention heads, FFN hidden,
  MoE experts, Mamba2 heads and d_inner, the vocabulary (head and
  embedding);
* ``data`` (and ``pod``) axes: batch parallelism; the optimizer moments
  are sharded over the data axes too, on their largest divisible free dim
  (ZeRO-2);
* caches: batch over data, the longest free dim over ``model``.

A spec is a tuple with one entry per dimension: an axis name, a tuple of
names, or None.  The rules read the last two components of a parameter's
path (``wq`` / ``wk`` / ... column-sharded, ``wo`` / ``down`` / ``out_proj``
row-sharded, norms and routers replicated), as the reference's do.  The
reference's leaves stack the layers in front and its rules count from the
end, so a port tensor, one layer's slice, takes the reference leaf's spec
with the leading stack dimensions dropped; a Mamba2 layer's
``conv_x_w`` is the reference's ``conv_x/w``.  The ZeRO-2 extension is the
reference's on the stacked leaf's shape (:func:`stacked_shapes`), its
stack dims then dropped: where the reference would put the data axes on a
stack dim, a port tensor keeps that moment whole on every data rank.

:func:`local_slice` cuts a full tensor down to this rank's slice,
:func:`gather_full` rebuilds the full tensor from every rank's slice,
:func:`relayout` moves a slice from one spec to another (gathered where
the old one splits, narrowed where the new one does: a prefill's K / V
from local heads to local slots), :func:`local_offset` gives a slice's
first global index on a dim (a cache's first slot).  The int8 serving
weights are laid out by the parameters' rules (:func:`tensor_shardings`).
A cache tree is walked by :func:`map_tree` and :func:`flat_tree`, its
leaves described before allocation by :class:`CacheField`;
:class:`ServedState` moves a recurrent block's state between the cache's
layout and the one the block computes in, and :class:`StackSplit` a
layer's cache between the rank that holds it (where the rule splits a
layer stack over the data axes) and the ranks that own its rows.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import torch

from repro_torch.distributed import context
from repro_torch.distributed.compress import leaf_of

MODEL = context.MODEL_AXIS

# parents whose "w" shards the OUTPUT (last) dim over `model`
# NB: img_proj is deliberately NOT here (the reference's note: its output
# feeds the residual stream, and a model-sharded feature axis there forces
# an all-gather of x in front of every projection of every layer)
_COL = {"wq", "wk", "wv", "wi", "wg", "up", "up_gate", "in_z", "in_x",
        "w_uk", "w_uv", "head", "w_z", "w_i", "w_f", "w_o"}
# parents whose "w" shards the INPUT (second-to-last) dim over `model`
_ROW = {"wo", "down", "out_proj"}
# replicated parents (small projections / routers / norms)
_REPL = {"router", "in_b", "in_c", "in_dt", "conv_bc", "w_dkv", "w_krope",
         "norm", "ln1", "ln2", "lnx", "norm_ckv", "final_norm", "enc_norm",
         "ffn_norm", "out_norm", "pos_dec"}
# head-indexed vectors sharded over `model` on their last dim
_HEADVEC = {"A_log", "D", "dt_bias"}

#: a Mamba2 layer's conv weights, flat in the port (``conv_x_w``)
_CONV = re.compile(r"^(conv_x|conv_bc)_(w|b)$")


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh: the counterpart of ``NamedSharding``."""
    mesh: Any
    spec: tuple


def path_of(name: str) -> list:
    """A port parameter's name as the reference's path components."""
    parts = name.split(".")
    m = _CONV.match(parts[-1])
    return parts[:-1] + [m.group(1), m.group(2)] if m else parts


def _spec_for(names: list, nd: int) -> tuple:
    last = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""

    def dim(i, axis_name):
        s = [None] * nd
        s[i] = axis_name
        return tuple(s)
    repl = (None,) * nd
    if last == "table" and parent == "embed":
        return dim(-2, MODEL)                       # vocab-sharded embedding
    if last == "table":                             # pos embeddings
        return repl
    if parent == "moe" and last in ("wi", "wg", "wo",
                                    "wi_q", "wg_q", "wo_q") and nd >= 3:
        return dim(-3, MODEL)                       # expert-sharded
    if parent == "moe" and last in ("wi_s", "wg_s", "wo_s"):
        return dim(-2, MODEL)                       # per-(expert,out) scales
    if any(n in _REPL for n in names[-2:]):
        return repl
    if last in _HEADVEC:
        return dim(-1, MODEL)
    if last.startswith("r_"):                       # sLSTM recurrent (h,p,p)
        return dim(-3, MODEL)
    if parent == "conv_x":
        return dim(-1, MODEL) if nd >= 1 else ()
    if parent in _COL:
        return dim(-1, MODEL) if last in ("w", "b", "w_q", "scale") else repl
    if parent in _ROW:
        return dim(-2, MODEL) if last in ("w", "w_q") else repl
    return repl


def param_specs(params: dict) -> dict:
    """{name: spec} for a {name: tensor} dict (``named_parameters()``)."""
    return {n: _spec_for(path_of(n), t.dim()) for n, t in params.items()}


def _axes_of(part) -> tuple:
    return () if part is None else \
        (part if isinstance(part, tuple) else (part,))


def fix_divisibility(spec: tuple, shape: tuple, mesh) -> tuple:
    """Drop mesh axes from dims they don't divide (whisper's 51865 vocab
    over 16 ranks: replicated instead of a crash).  ``mesh`` needs only
    ``.shape``, a {axis: size} mapping."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, part in zip(shape, parts):
        size = math.prod(mesh.shape[a] for a in _axes_of(part))
        out.append(part if part is not None and dim % size == 0 else None)
    return tuple(out)


def _extend_with_data(spec: tuple, shape: tuple, mesh) -> tuple:
    """ZeRO-2: add pod/data sharding on the largest divisible free dim."""
    dax = tuple(a for a in context.DATA_AXES if a in mesh.axis_names)
    if not dax:
        return spec
    dsize = math.prod(mesh.shape[a] for a in dax)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if parts[i] is None and shape[i] % dsize == 0:
            parts[i] = dax if len(dax) > 1 else dax[0]
            return tuple(parts)
    return spec


def stacked_shapes(params: dict) -> dict:
    """{name: the shape of the reference's leaf it belongs to}: its own
    shape behind the stack's dims (a hybrid's Mamba2 layers two deep,
    groups then layers; the other stacks one)."""
    idx = {}
    for n in params:
        leaf = leaf_of(n)
        if leaf != n:
            prefix = n.split(".", 1)[0]
            nums = []
            for p in n.split(".")[1:]:
                if not p.isdigit():
                    break
                nums.append(int(p))
            depth = 2 if prefix == "mamba" else 1
            top = idx.setdefault(leaf, [0] * depth)
            for i in range(depth):
                top[i] = max(top[i], nums[i] + 1)
    return {n: tuple(idx.get(leaf_of(n), ())) + tuple(t.shape)
            for n, t in params.items()}


def param_shardings(params: dict, mesh) -> dict:
    """{name: Sharding} with divisibility fixed on the FULL shapes."""
    specs = param_specs(params)
    return {n: Sharding(mesh, fix_divisibility(specs[n], tuple(t.shape),
                                               mesh))
            for n, t in params.items()}


def tensor_shardings(named: dict, mesh, whole_kv: bool = False) -> dict:
    """{name: Sharding} of a model's parameters, or of its buffers (an
    int8 serving weight ``w_q`` and its ``scale``, an int8 expert bank and
    its scales: the same rules read the same paths), divisibility fixed on
    the full shapes.  ``whole_kv``: ``model`` does not divide the KV heads,
    so GQA's ``wk`` / ``wv`` stay whole (the rule would split their
    columns through a head; each rank takes the heads it reads)."""
    out = param_shardings(named, mesh)
    if whole_kv:
        for n, t in named.items():
            if path_of(n)[-3:-1] in (["attn", "wk"], ["attn", "wv"]):
                out[n] = Sharding(mesh, (None,) * t.dim())
    return out


def moment_specs(params: dict, mesh, fixed: dict | None = None) -> dict:
    """{name: the moments' spec}: the parameter's, fixed (``fixed``, when
    given, holds them), extended with the data axes as the reference
    extends its stacked leaf, the stack dims then dropped."""
    stacked = stacked_shapes(params)
    if fixed is None:
        fixed = {n: sh.spec for n, sh in param_shardings(params,
                                                         mesh).items()}
    out = {}
    for n, t in params.items():
        full = stacked[n]
        lead = len(full) - t.dim()
        spec = (None,) * lead + tuple(fixed[n])
        out[n] = _extend_with_data(spec, full, mesh)[lead:]
    return out


def opt_state_shardings(opt_state: dict, params: dict, mesh) -> dict:
    """Moments: param sharding + extra data-axis sharding (ZeRO-2);
    ``params`` at their full shapes."""
    mspec = {n: Sharding(mesh, s)
             for n, s in moment_specs(params, mesh).items()}
    return {"m": mspec, "v": dict(mspec), "step": Sharding(mesh, ())}


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def _data(mesh) -> tuple:
    dax = tuple(a for a in context.DATA_AXES if a in mesh.axis_names)
    return dax, math.prod(mesh.shape[a] for a in dax)


def batch_shardings(batch: dict, mesh) -> dict:
    """tokens/frames/images: shard the batch dim over pod+data if
    divisible."""
    dax, dsize = _data(mesh)

    def spec(x):
        if x.dim() == 0:
            return Sharding(mesh, ())
        if x.shape[0] % dsize == 0 and dsize > 1:
            part = dax if len(dax) > 1 else dax[0]
            return Sharding(mesh, (part,) + (None,) * (x.dim() - 1))
        return Sharding(mesh, (None,) * x.dim())
    return {k: spec(x) for k, x in batch.items()}


def cache_shardings(caches, mesh, batch: int):
    """KV caches / recurrent states (a tree of dicts, lists and tuples):
    the batch dim over data if divisible; the longest remaining dim over
    ``model`` if divisible, and for batch-unsharded shapes over data and
    ``model`` together where that divides."""
    dax, dsize = _data(mesh)
    msize = mesh.shape.get(MODEL, 1)

    def spec(x):
        parts = [None] * x.dim()
        bdim = next((i for i, s in enumerate(x.shape) if s == batch), None)
        batch_sharded = False
        if bdim is not None and batch % dsize == 0 and dsize > 1:
            parts[bdim] = dax if len(dax) > 1 else dax[0]
            batch_sharded = True
        free = [i for i in range(x.dim()) if parts[i] is None and i != bdim]
        free.sort(key=lambda i: -x.shape[i])
        for i in free:
            if msize > 1 and x.shape[i] % msize == 0:
                if not batch_sharded and dsize > 1 and \
                        x.shape[i] % (msize * dsize) == 0:
                    parts[i] = (*dax, MODEL)
                else:
                    parts[i] = MODEL
                break
        return Sharding(mesh, tuple(parts))

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return spec(tree)
    return walk(caches)


# ---------------------------------------------------------------------------
# specs to data
# ---------------------------------------------------------------------------

def local_shape(shape: tuple, sh: Sharding) -> tuple:
    """The shape of this rank's slice of a tensor of ``shape`` under
    ``sh``."""
    return tuple(n // sh.mesh.size(split_axes(sh, d)) if split_axes(sh, d)
                 else n for d, n in enumerate(shape))


def map_tree(fn, tree, shardings=None):
    """``fn(leaf, its Sharding)`` over a tree of dicts, lists and tuples
    (a cache tree and :func:`cache_shardings` of it, or any other tree
    of that structure; None: ``fn(leaf, None)``), the same tree back."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, None if shardings is None
                            else shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, None if shardings is None
                                   else shardings[i])
                          for i, v in enumerate(tree))
    return fn(tree, shardings)


def flat_tree(tree, pre: str = "") -> dict:
    """``{"key.field": leaf}`` of a tree of dicts, lists and tuples (an
    xLSTM's ``"blocks.3.0"``)."""
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k2: v2 for k, v in items
                for k2, v2 in flat_tree(v, f"{pre}{k}.").items()}
    return {pre[:-1]: tree}


class CacheField:
    """A leaf of a cache tree before it is allocated: its shape, dtype and
    initial value.  :func:`cache_shardings` reads ``shape`` and ``dim()``
    only, so a layout worked out inside a traced step allocates
    nothing."""

    def __init__(self, shape: tuple, dtype: torch.dtype, fill: float = 0.0):
        self.shape, self.dtype, self.fill = torch.Size(shape), dtype, fill

    def dim(self) -> int:
        return len(self.shape)

    def full(self, device=None, sh: Sharding | None = None) -> torch.Tensor:
        """The field at its initial value: whole, or this rank's slice
        under ``sh``."""
        shape = tuple(self.shape) if sh is None \
            else local_shape(tuple(self.shape), sh)
        return torch.full(shape, self.fill, dtype=self.dtype, device=device)


class ServedState:
    """What a recurrent block (Mamba2, mLSTM, sLSTM) needs to serve on a
    mesh: it computes its state (a dict or a tuple of fields) in the
    layout its ``state_specs(batch_part)`` gives (its heads), while the
    cache holds that state under :func:`cache_shardings` (``state_sh``,
    the same tree of Shardings)."""

    def _layouts(self, state_sh) -> Any:
        """(the cache's Sharding, the computing spec) of each field."""
        first = next(iter(state_sh.values())) if isinstance(state_sh, dict) \
            else state_sh[0]
        return map_tree(lambda sh, w: (sh, w), state_sh,
                        self.state_specs(first.spec[0]))

    def laid_out(self, state, state_sh):
        """A state in the computing layout as this rank's slice under
        ``state_sh``: gathered where the cache splits a dim the
        computation does not, narrowed where it splits one the computation
        holds whole."""
        return map_tree(lambda t, p: relayout(t, Sharding(p[0].mesh, p[1]),
                                              p[0].spec),
                        state, self._layouts(state_sh))

    def gathered(self, state, state_sh):
        """``state`` (this rank's slices under ``state_sh``) in the
        computing layout; ``state`` itself off a mesh (``state_sh``
        None)."""
        if state_sh is None:
            return state
        return map_tree(lambda t, p: relayout(t, p[0], p[1]), state,
                        self._layouts(state_sh))

    def write_back(self, state, new, state_sh) -> None:
        """The stepped state ``new`` (in the computing layout) into
        ``state``, in place: this rank's slices under ``state_sh`` (as
        they are off a mesh); a field stepped in place is left as it
        is."""
        if state_sh is not None:
            new = self.laid_out(new, state_sh)

        def put(t, n):
            if n is not t:
                t.copy_(n)
        map_tree(put, state, new)


class WholeStack:
    """A cache key's stacked fields that no data axis splits on a stack
    dim: each layer's cache is this rank's rows as they lie in the
    stack."""

    def keep(self, idx: tuple, layer):
        """The layer's cache as the stack holds it: ``layer`` itself."""
        return layer

    def fetch(self, stack, idx: tuple):
        """Layer ``idx``'s cache (views into ``stack``, updated in
        place)."""
        return map_tree(lambda t, _: t[idx], stack)

    def store(self, stack, idx: tuple, layer) -> None:
        """Nothing to do: :meth:`fetch` gave views."""


WHOLE_STACK = WholeStack()


class StackSplit(WholeStack):
    """A cache key's stacked fields whose stack dim ``dim`` (of full size
    ``size``) :func:`cache_shardings` puts the data ``axes`` on, because it
    is the first dim of the batch's size (ROADMAP fact 21; a 4-layer
    decoder serving 4 rows): each data rank holds every row's cache of the
    layers of its slice of the stack, while it computes its own rows
    (``rows``: this rank's first row and their count).  A layer's rows
    move between the rank that holds the layer and the ranks that own
    them: gathered over ``axes`` onto the holder (:meth:`keep`,
    :meth:`store`), broadcast from it and narrowed to the rows
    (:meth:`fetch`)."""

    def __init__(self, mesh, axes: tuple, dim: int, size: int, rows: tuple):
        self.mesh, self.axes, self.dim = mesh, axes, dim
        self.per = size // mesh.size(axes)
        self.first, self.rows = rows

    def _holder(self, idx: tuple) -> int:
        return idx[self.dim] // self.per

    def _local(self, idx: tuple) -> tuple:
        return idx[:self.dim] + (idx[self.dim] % self.per,) \
            + idx[self.dim + 1:]

    def keep(self, idx: tuple, layer):
        """Layer ``idx``'s cache of every row on the rank that holds it
        (None on the others) from each rank's ``layer``, its rows."""
        whole = map_tree(
            lambda t, _: context.all_gather(t, self.axes, self.mesh, 0), layer)
        return whole if self._holder(idx) == self.mesh.index(self.axes) \
            else None

    def fetch(self, stack, idx: tuple):
        """This rank's rows of layer ``idx``'s cache (new tensors), from
        the rank whose slice of ``stack`` holds it."""
        local, root = self._local(idx), self._holder(idx)
        return map_tree(
            lambda t, _: context.broadcast(t[local], self.axes, self.mesh,
                                           root)
            .narrow(0, self.first, self.rows).contiguous(), stack)

    def store(self, stack, idx: tuple, layer) -> None:
        """Every rank's rows of layer ``idx`` (each rank's ``layer``, as
        :meth:`fetch` gave it and a step updated it) written into the
        holder's slice of ``stack``."""
        whole = self.keep(idx, layer)
        if whole is not None:
            map_tree(lambda t, w: t[self._local(idx)].copy_(w), stack, whole)


def local_slice(full: torch.Tensor, sh: Sharding) -> torch.Tensor:
    """This rank's slice of ``full`` under ``sh`` (a copy, so that the full
    tensor can be freed)."""
    out = full
    for dim, part in enumerate(sh.spec):
        axes = _axes_of(part)
        if not axes:
            continue
        n = sh.mesh.size(axes)
        size = full.shape[dim] // n
        out = out.narrow(dim, sh.mesh.index(axes) * size, size)
    return out if out is full else out.clone()


def gather_full(local: torch.Tensor, sh: Sharding) -> torch.Tensor:
    """The full tensor from every rank's slice under ``sh`` (a
    collective: every rank of the mesh calls it)."""
    out = local
    for dim, part in enumerate(sh.spec):
        axes = _axes_of(part)
        if axes:
            out = context.all_gather(out, axes, sh.mesh, dim)
    return out


def split_axes(sh: Sharding, dim: int) -> tuple:
    """The mesh axes that split ``dim`` under ``sh`` (row-major), () where
    it is whole."""
    return _axes_of(sh.spec[dim]) if dim < len(sh.spec) else ()


def local_offset(sh: Sharding, dim: int, local_size: int) -> int:
    """The global index of this rank's first element on ``dim`` of a tensor
    laid out by ``sh`` whose local slice holds ``local_size`` there: a
    cache's first slot on its sequence split over ``model``, or over the
    data axes and ``model`` together (a batch-1 cache); 0 where ``dim`` is
    whole."""
    axes = split_axes(sh, dim)
    return sh.mesh.index(axes) * local_size if axes else 0


def relayout(local: torch.Tensor, src: Sharding, dst: tuple) -> torch.Tensor:
    """``local``, this rank's slice under ``src``, as its slice under the
    spec ``dst`` on the same mesh: every dim whose axes differ gathered
    over ``src``'s axes first (a collective along them), then narrowed to
    ``dst``'s.  Where the specs agree, ``local`` itself."""
    mesh = src.mesh
    nd = local.dim()
    src_parts = [split_axes(src, d) for d in range(nd)]
    dst_parts = [_axes_of(dst[d]) if d < len(dst) else () for d in range(nd)]
    out = local
    for d in range(nd):
        if src_parts[d] != dst_parts[d] and src_parts[d]:
            out = context.all_gather(out, src_parts[d], mesh, d)
    for d in range(nd):
        if src_parts[d] != dst_parts[d] and dst_parts[d]:
            size = out.shape[d] // mesh.size(dst_parts[d])
            out = out.narrow(d, mesh.index(dst_parts[d]) * size, size)
    return out


def is_model_sharded(sh: Sharding) -> bool:
    return any(MODEL in _axes_of(p) for p in sh.spec)


def data_dim(sh: Sharding):
    """The dim of ``sh`` that holds the data axes, or None."""
    dax = set(context.DATA_AXES)
    for dim, part in enumerate(sh.spec):
        if set(_axes_of(part)) & dax:
            return dim
    return None


@dataclasses.dataclass
class Layout:
    """A sharded model's layout on its mesh: every parameter's Sharding
    (on its full shape), the moments' (ZeRO-2), and the parameters whose
    local gradient is partial over ``model`` (replicated weights read
    inside a model-parallel region: the MoE router, keys and values that
    ``model`` does not divide, MLA's latent projections, Mamba2's B / C /
    dt projections, ``conv_bc`` and gated-norm gain; under
    ``seq_parallel`` also every replicated weight that acts on this rank's
    rows of a sequence-split stream, ``seq_partial``): the train step sums
    those over ``model`` (:meth:`partial_for`)."""
    mesh: Any
    params: dict
    moments: dict
    partial: frozenset = frozenset()
    seq_partial: frozenset = frozenset()

    def partial_for(self, split: bool) -> frozenset:
        """The names whose gradients are partial over ``model`` after a
        forward that did (``split``) or did not split its stream on the
        sequence (``LMBase.splits_rows``): ``seq_partial`` only in the
        first case."""
        return self.partial if split else self.partial - self.seq_partial

    def state_shardings(self, opt_state: dict) -> dict:
        """The Shardings of the train state ``{"params", "opt"}``."""
        opt = {"m": self.moments, "v": dict(self.moments),
               "step": Sharding(self.mesh, ())}
        if "grad_err" in opt_state:
            opt["grad_err"] = self.params
        return {"params": self.params, "opt": opt}
