"""The (data, model) mesh over ``torch.distributed``: which axes the model
runs under, this rank's place on them, and the collectives that explicit
tensor parallelism needs.

The counterpart of the JAX package's ``distributed/context.py``.  There a
mesh names the devices of one program and GSPMD (``shard_map`` inside the
MoE) places the work; here every rank is a process, a :class:`Mesh` holds
one ``torch.distributed`` process group per axis (and one for the data
axes together), and the layout is written out by the modules themselves
(column- and row-parallel products, vocab-parallel embedding and head,
expert-local dispatch).  ``shard_map`` has no counterpart: the modules'
explicit layout replaces it.

:func:`set_mesh`, :func:`get_mesh`, :func:`use_mesh`, :func:`data_axes`
and :func:`has_model_axis` keep the reference's semantics: with no mesh
everything is single-rank.

The collectives sum in float32 (a bf16 partial sum is cast up first and the
result cast back).  The autograd-aware ones are the four of tensor
parallelism: :func:`copy_to_model` (forward identity, backward all-reduce
over ``model``), :func:`reduce_from_model` (forward all-reduce, backward
identity), :func:`gather_from_model` (forward all-gather on one dim,
backward the local slice), :func:`gather_to_heads` (forward all-gather
of column slices into whole heads, backward reduce-scatter: each rank
then keeps other columns of what follows), :func:`leave_whole` (leave a
region whose output every rank computed whole: forward the output,
backward its gradient on model rank 0 alone) and :func:`mean_over_model`;
:func:`gather_from_data` (forward all-gather of rows over the data axes,
backward their sum and the local rows), with which a MoE layer under data
parallelism alone routes the global batch as the reference's GSPMD does;
and the three of sequence parallelism, where the residual stream holds
this rank's rows of the sequence between the model-parallel regions:
:func:`gather_from_seq` (enter a region: forward all-gather on the
sequence dim, backward reduce-scatter), :func:`reduce_scatter_to_seq`
(leave it: forward reduce-scatter, backward all-gather) and
:func:`split_to_seq` (split a replicated stream: forward the local rows,
backward all-gather).  :func:`enter_region` and :func:`leave_region` pick
a region's entry and exit, with or without sequence parallelism.

Serving adds three that autograd never sees: :func:`all_max`, the
maximum in the operand's own dtype (the W8A8 activation scale's absolute
maximum, a decode attention's running maximum); :func:`sum_exact`, an
integer sum (a row-parallel W8A8 accumulator, int32); and the reductions
and gathers over axes that hold no process group together (a batch-1
cache's sequence over the data axes and ``model``), run one axis after
the other.

A backend may run a collective on host tensors only: :data:`HOST_STAGED`
names, by backend, the collectives whose CUDA tensors go through a pinned
host buffer.  The choice follows the backend and the tensor's device,
never a caught error.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXES = ("pod", "data")      # batch-parallel axes (present subset used)
MODEL_AXIS = "model"

#: the collectives that a backend takes on host tensors only, by backend:
#: a CUDA tensor goes through a pinned host buffer for them.  Gloo reduces,
#: gathers and broadcasts CUDA tensors itself; its point-to-point send
#: hands a CUDA pointer to the socket (``writev``: Bad address, or the
#: process aborts), so the pipeline's ring is staged
HOST_STAGED = {"gloo": frozenset({"send_recv"})}

_MESH: Optional["Mesh"] = None

#: collectives run, by name: [calls, bytes this rank sent or contributed,
#: bytes staged through host memory, bytes of the result this rank holds]
#: (telemetry, reset by :func:`reset_traffic`)
traffic: dict = {}


def reset_traffic() -> None:
    traffic.clear()


def _count(op: str, t: torch.Tensor, staged: bool, result: int) -> None:
    row = traffic.setdefault(op, [0, 0, 0, 0])
    nbytes = _nbytes(t)
    row[0] += 1
    row[1] += nbytes
    row[2] += nbytes if staged else 0
    row[3] += result


@dataclasses.dataclass(eq=False)
class Mesh:
    """Named axes over the ranks of an initialised world, row-major (the
    last axis varies fastest): ``shape`` maps each axis to its size (as the
    reference's ``mesh.shape``), ``coords`` to this rank's index on it;
    ``groups`` maps a tuple of axes to the process group of the ranks that
    share every other coordinate (None where the tuple spans one rank);
    ``device`` is where this rank computes, ``backend`` the world's."""
    axis_names: tuple
    shape: dict
    coords: dict
    groups: dict
    device: torch.device
    backend: str

    def _axes(self, axes) -> tuple:
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def size(self, axes) -> int:
        """The number of ranks along ``axes`` (an axis or a tuple)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major index along ``axes``."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        return self.groups.get(self._axes(axes))

    def global_rank(self, **coords) -> int:
        """The world rank at this rank's coordinates with ``coords``
        replaced."""
        rank = 0
        for a in self.axis_names:
            rank = rank * self.shape[a] + coords.get(a, self.coords[a])
        return rank

    def data_axes(self) -> tuple:
        return tuple(a for a in DATA_AXES if a in self.axis_names)

    def model_size(self) -> int:
        return self.shape.get(MODEL_AXIS, 1)


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    old = _MESH
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(old)


def data_axes() -> tuple:
    return () if _MESH is None else _MESH.data_axes()


def has_model_axis() -> bool:
    return _MESH is not None and _MESH.model_size() > 1


# ---------------------------------------------------------------------------
# collectives (plain): no-ops where the axes span one rank
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _staged(op: str, mesh: Mesh, t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and \
        op in HOST_STAGED.get(mesh.backend, frozenset())


def _on_host(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A fresh float32 (or same-dtype, for other dtypes) copy to reduce."""
    if t.is_floating_point() and t.dtype != torch.float64:
        return t.to(torch.float32, copy=True)
    return t.clone()


def _one_by_one(mesh: Mesh, axes) -> tuple:
    """The axes to run a collective over one at a time, the last first:
    those of a tuple the mesh holds no process group for (``("data",
    "model")``, which splits a batch-1 cache's sequence), empty where the
    tuple has its own group or is one axis."""
    axes = mesh._axes(axes)
    if len(axes) < 2 or axes in mesh.groups:
        return ()
    return tuple(reversed(axes))


def all_reduce(t: torch.Tensor, axes, mesh: Mesh,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of ``t`` over ``axes`` as a new tensor of t's dtype
    (floats summed in float32, integers exactly in their own dtype);
    ``t`` itself where they span one rank.  Axes with no group of their
    own together are reduced one after the other."""
    if _one_by_one(mesh, axes):
        for a in _one_by_one(mesh, axes):
            t = all_reduce(t, a, mesh, op)
        return t
    group = mesh.group(axes)
    if group is None:
        return t
    work = _wide(t)
    _count("all_reduce", work, _staged("all_reduce", mesh, work),
           _nbytes(work))
    if _staged("all_reduce", mesh, work):
        host = _on_host(work)
        dist.all_reduce(host, op, group=group)
        work.copy_(host)
    else:
        dist.all_reduce(work, op, group=group)
    return work.to(t.dtype)


def all_max(t: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """The elementwise maximum of ``t`` over ``axes``, in t's own dtype
    (a max is exact, so nothing is widened; reduce float32 or integer
    operands: a backend need not take every dtype); ``t`` itself where
    they span one rank."""
    if _one_by_one(mesh, axes):
        for a in _one_by_one(mesh, axes):
            t = all_max(t, a, mesh)
        return t
    group = mesh.group(axes)
    if group is None:
        return t
    work = t.contiguous().clone()
    staged = _staged("all_reduce", mesh, work)
    _count("all_reduce", work, staged, _nbytes(work))
    host = _on_host(work) if staged else work
    dist.all_reduce(host, dist.ReduceOp.MAX, group=group)
    if host is not work:
        work.copy_(host)
    return work


def sum_exact(t: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """The sum of an integer ``t`` over ``axes`` in its own dtype, exact
    (the W8A8 row-parallel accumulator, int32: its partial sums add to
    the single-rank accumulator bit for bit)."""
    if t.is_floating_point():
        raise TypeError(f"sum_exact: an integer tensor, not {t.dtype}")
    return all_reduce(t, axes, mesh)


def all_gather(t: torch.Tensor, axes, mesh: Mesh, dim: int) -> torch.Tensor:
    """The ranks' ``t`` along ``axes`` concatenated on ``dim`` in their
    row-major order (axes with no group of their own together gathered
    one after the other, the last first: the row-major order again)."""
    if _one_by_one(mesh, axes):
        for a in _one_by_one(mesh, axes):
            t = all_gather(t, a, mesh, dim)
        return t
    group = mesh.group(axes)
    if group is None:
        return t
    n = mesh.size(axes)
    src = t.contiguous()
    _count("all_gather", src, _staged("all_gather", mesh, src),
           n * _nbytes(src))
    if _staged("all_gather", mesh, src):
        src = _on_host(src)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def reduce_scatter(t: torch.Tensor, axes, mesh: Mesh,
                   dim: int) -> torch.Tensor:
    """The sum of ``t`` over ``axes``, of which this rank keeps its part on
    ``dim`` (``t.shape[dim] / n`` rows, in row-major rank order), as a new
    tensor of t's dtype (floats summed in float32); ``t`` itself where the
    axes span one rank."""
    group = mesh.group(axes)
    if group is None:
        return t
    n = mesh.size(axes)
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"over {n} ranks")
    work = _wide(t.movedim(dim, 0)).contiguous()
    staged = _staged("reduce_scatter", mesh, work)
    _count("reduce_scatter", work, staged, _nbytes(work) // n)
    out = torch.empty((work.shape[0] // n,) + tuple(work.shape[1:]),
                      dtype=work.dtype, device=work.device)
    if staged:
        host, got = _on_host(work), _on_host(out)
        dist.reduce_scatter_tensor(got, host, group=group)
        out.copy_(got)
    else:
        dist.reduce_scatter_tensor(out, work, group=group)
    return out.movedim(0, dim).to(t.dtype).contiguous()


def broadcast(t: torch.Tensor, axes, mesh: Mesh, root: int = 0
              ) -> torch.Tensor:
    """``t`` of the rank at row-major index ``root`` along ``axes`` (the
    first by default), on every rank of the group (a new tensor)."""
    group = mesh.group(axes)
    if group is None:
        return t
    coords = {}
    for a in reversed(mesh._axes(axes)):
        coords[a], root = root % mesh.shape[a], root // mesh.shape[a]
    work = t.contiguous().clone()
    _count("broadcast", work, _staged("broadcast", mesh, work),
           _nbytes(work))
    host = _on_host(work) if _staged("broadcast", mesh, work) else work
    dist.broadcast(host, mesh.global_rank(**coords), group=group)
    if host is not work:
        work.copy_(host)
    return work


def send_recv(t: torch.Tensor, axis: str, mesh: Mesh, shift: int = 1
              ) -> torch.Tensor:
    """Around a ring along ``axis``: send ``t`` to the rank ``shift``
    ahead and return what the rank ``shift`` behind sent."""
    group = mesh.group(axis)
    if group is None:
        return t
    n, i = mesh.shape[axis], mesh.coords[axis]
    src = t.contiguous()
    staged = _staged("send_recv", mesh, src)
    _count("send_recv", src, staged, _nbytes(src))
    if staged:
        src = _on_host(src)
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src,
                      mesh.global_rank(**{axis: (i + shift) % n}), group),
           dist.P2POp(dist.irecv, out,
                      mesh.global_rank(**{axis: (i - shift) % n}), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out.to(t.device) if staged else out


#: the most elements :func:`all_reduce_many` sums in one collective
BUCKET = 1 << 26


def all_reduce_many(tensors: list, axes, mesh: Mesh,
                    scale: float = 1.0) -> list:
    """Each tensor's float32 sum over ``axes`` times ``scale``, in buckets
    of at most :data:`BUCKET` elements (one collective each); the results
    are float32."""
    out = [None] * len(tensors)
    if mesh.group(axes) is None:
        return [t.float() * scale if scale != 1.0 else t.float()
                for t in tensors]
    start = 0
    while start < len(tensors):
        stop, n = start, 0
        while stop < len(tensors) and (stop == start or
                                       n + tensors[stop].numel() <= BUCKET):
            n += tensors[stop].numel()
            stop += 1
        flat = torch.cat([t.float().reshape(-1)
                          for t in tensors[start:stop]])
        flat = all_reduce(flat, axes, mesh)
        if scale != 1.0:
            flat.mul_(scale)
        off = 0
        for i in range(start, stop):
            k = tensors[i].numel()
            out[i] = flat[off:off + k].view(tensors[i].shape)
            off += k
        start = stop
    return out


# ---------------------------------------------------------------------------
# collectives with autograd: explicit tensor parallelism
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, MODEL_AXIS, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, MODEL_AXIS, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return all_gather(x, MODEL_AXIS, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(MODEL_AXIS)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None


class _MeanOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.n = mesh.model_size()
        return all_reduce(x, MODEL_AXIS, mesh) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _OwnedByFirst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.first = mesh.index(MODEL_AXIS) == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return all_gather(x, mesh.data_axes(), mesh, 0)

    @staticmethod
    def backward(ctx, g):
        axes = ctx.mesh.data_axes()
        g = all_reduce(g, axes, ctx.mesh)
        return g.narrow(0, ctx.mesh.index(axes) * ctx.n, ctx.n), None


class _GatherReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(x, MODEL_AXIS, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, MODEL_AXIS, ctx.mesh, ctx.dim), None, None


class _ReduceScatterToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return reduce_scatter(x, MODEL_AXIS, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, MODEL_AXIS, ctx.mesh, ctx.dim), None, None


class _SplitToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        n = x.shape[dim] // mesh.model_size()
        return x.narrow(dim, mesh.index(MODEL_AXIS) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, MODEL_AXIS, ctx.mesh, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Enter a model-parallel region: x as it is; its gradient summed over
    the model ranks (each holds the part its local slice produced)."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Leave a model-parallel region: the model ranks' partial x summed;
    its gradient passed to each as it is."""
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh: Mesh, dim: int = -1
                      ) -> torch.Tensor:
    """The model ranks' slices of x concatenated on ``dim``; the gradient
    of each rank's slice is its part of the full gradient."""
    return _GatherFromModel.apply(x, mesh, dim % x.dim())


def gather_to_heads(x: torch.Tensor, mesh: Mesh, dim: int = -1
                    ) -> torch.Tensor:
    """The model ranks' column slices of x (a column-parallel projection's
    output, split through a head) concatenated on ``dim``, every head
    whole on every rank, for a layer whose ranks then keep different
    columns of its output: each rank's gradient of the whole x covers its
    own columns' part of the layer, so the gradient is summed over the
    model ranks and each rank's columns kept (a reduce-scatter).
    :func:`gather_from_model` narrows instead, which is right only where
    every rank's downstream is the same."""
    return _GatherReduceScatter.apply(x, mesh, dim % x.dim())


def gather_to_heads_if(x: torch.Tensor, mesh: Mesh, every: bool,
                       dim: int = -1) -> torch.Tensor:
    """:func:`gather_to_heads` where ``every`` (a layer that runs every
    head on every rank, its column-parallel slice split through a head);
    x itself otherwise."""
    return gather_to_heads(x, mesh, dim) if every else x


def leave_whole(y: torch.Tensor, mesh: Mesh, sp: bool) -> torch.Tensor:
    """Leave a model-parallel region whose output every model rank
    computed whole (a whole output projection after every head): with
    ``sp`` this rank's rows of the sequence (dim 1), the others' rows
    getting no gradient here; else ``y`` itself, its gradient kept by
    model rank 0 alone and zero on the others.  Either way each rank's
    gradients inside the region are its part of the whole, as after a
    row-parallel exit, and the region's entry sums them."""
    if sp:
        n = y.shape[1] // mesh.model_size()
        return y.narrow(1, mesh.index(MODEL_AXIS) * n, n)
    return _OwnedByFirst.apply(y, mesh)


def mean_over_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of x over the model ranks (the reference's ``pmean``)."""
    return _MeanOverModel.apply(x, mesh)


def gather_from_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The data ranks' rows of x (axis 0) concatenated in rank order; the
    gradient of this rank's rows is the sum of every rank's gradient of
    them."""
    return _GatherFromData.apply(x, mesh)


def gather_from_seq(x: torch.Tensor, mesh: Mesh, dim: int = 1
                    ) -> torch.Tensor:
    """Enter a model-parallel region from a sequence-split stream: the
    model ranks' rows of x concatenated on ``dim``; the gradient (partial:
    each rank's part of the region) summed over the model ranks and each
    rank's rows kept."""
    return _GatherReduceScatter.apply(x, mesh, dim % x.dim())


def reduce_scatter_to_seq(x: torch.Tensor, mesh: Mesh, dim: int = 1
                          ) -> torch.Tensor:
    """Leave a model-parallel region onto a sequence-split stream: the
    model ranks' partial x summed, this rank's rows on ``dim`` kept; the
    gradient of every row gathered from the rank that holds it."""
    return _ReduceScatterToSeq.apply(x, mesh, dim % x.dim())


def split_to_seq(x: torch.Tensor, mesh: Mesh, dim: int = 1
                 ) -> torch.Tensor:
    """This rank's rows on ``dim`` of x, the same on every model rank;
    the gradient of the whole x gathered from the ranks' rows."""
    return _SplitToSeq.apply(x, mesh, dim % x.dim())


def enter_region(x: torch.Tensor, mesh: Mesh, sp: bool) -> torch.Tensor:
    """Enter a model-parallel region: from this rank's rows of a
    sequence-split stream (``sp``, :func:`gather_from_seq`) or from a
    replicated one (:func:`copy_to_model`)."""
    return gather_from_seq(x, mesh) if sp else copy_to_model(x, mesh)


def leave_region(y: torch.Tensor, mesh: Mesh, sp: bool) -> torch.Tensor:
    """Leave a model-parallel region, the ranks' partial ``y`` summed: onto
    this rank's rows of a sequence-split stream (``sp``,
    :func:`reduce_scatter_to_seq`) or a replicated one
    (:func:`reduce_from_model`)."""
    return reduce_scatter_to_seq(y, mesh) if sp else reduce_from_model(y, mesh)
