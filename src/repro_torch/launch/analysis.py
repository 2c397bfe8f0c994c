"""The dry run's census of one rank's program: the per-device quantities
that the reference reads from XLA, counted op by op.

The counterpart of the JAX package's ``launch/hlo_analysis.py``.  The
reference compiles a cell and parses the optimized HLO text (dots and
convolutions, fusion-boundary bytes, collectives with their while-loop
trip counts).  Eager PyTorch has no compiled program to parse: the
program is the sequence of operations the rank dispatches, so the
census is a :class:`~torch.utils._python_dispatch.TorchDispatchMode` that
sees every one of them as it runs (on the ``meta`` device in the dry run,
on real tensors elsewhere).  Eager PyTorch runs every loop iteration, so
there is no while body to expand and no ``*_body_once`` field.  It counts:

* ``flops``: the products, by the formulas of
  :mod:`torch.utils.flop_counter` (``flop_registry``: ``2 m n k`` per
  matrix product, as the reference counts a dot), in the census's own
  mode: ``FlopCounterMode``'s module tracker keeps the activations a
  checkpoint recomputes alive to the end of the backward, which would
  move the peak;
* ``hbm_bytes``: operand plus result bytes of every operation that is
  not a view or a metadata operation (allocation, ``set_``, a scalar
  read).  In eager mode every operation is its own kernel, so this is
  the eager program's memory traffic, where the reference counts fusion
  boundaries;
* ``attn_fallback_bytes``: the same bytes for the operations of the plain
  attention, forward and backward
  (:data:`repro_torch.kernels.flash_attention.FALLBACK`, the counterpart
  of the reference's ``named_scope("flashattn_fallback")``): the I/O that
  the attention kernel replaces; ``attn_fallback_flops``, its products
  (the attention's flops, which a layer that runs every head on every
  rank replicates over ``model``);
* ``collectives`` by kind, each with ``count``, ``result_bytes`` and
  ``link_bytes``, and their sum ``collective_link_bytes``, from
  :data:`repro_torch.distributed.context.traffic` with the reference's
  ring accounting (an all-reduce moves twice its result, every other
  kind once) and names (``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``collective-permute`` for the ring shift); the
  port's broadcast keeps its own name;
* memory by storage lifetime: ``argument_bytes`` (the storages of the
  step's arguments), ``output_bytes`` (those it returns, an argument
  updated in place among them), ``peak_bytes`` (the most bytes held at
  once, the arguments included: a storage counts from the operation that
  creates it to its release, and one that only Python's cycle collector
  frees counts until it runs, as on the card; the census names the
  operation that reached the peak, ``peak_op``, and the bytes live at the
  peak by the operation that made them, ``peak_by_op``) and
  ``temp_bytes`` (the peak less the arguments and the new outputs).

Only public APIs are used: ``TorchDispatchMode``, ``flop_registry``,
untyped storages (one Python object per storage while it lives) and
``weakref``.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import context
from repro_torch.kernels.flash_attention import FALLBACK

aten = torch.ops.aten

#: the port's collective names as the reference's HLO kinds
KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter",
         "send_recv": "collective-permute", "broadcast": "broadcast"}
#: link bytes per result byte under ring algorithms
RING_FACTOR = {"all-reduce": 2.0}

#: operations that move no data: allocations and metadata
_METADATA = frozenset({
    aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten.lift_fresh.default,
    aten.set_.source_Storage, aten.set_.source_Storage_storage_offset,
    aten.set_.source_Tensor, aten.resize_.default,
    aten._local_scalar_dense.default})


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def leaves(obj) -> list:
    """The tensors of a step's arguments or results: a module's
    parameters and buffers, the leaves of dicts, lists and tuples."""
    if isinstance(obj, torch.nn.Module):
        return [*obj.parameters(), *obj.buffers()]
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in leaves(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in leaves(v)]
    return []


def collectives(before: dict, after: dict) -> dict:
    """{kind: {count, result_bytes, link_bytes}} of the collectives counted
    between two copies of ``context.traffic``."""
    out = {}
    for op, row in after.items():
        old = before.get(op, [0, 0, 0, 0])
        count, result = row[0] - old[0], row[3] - old[3]
        if count:
            kind = KINDS[op]
            out[kind] = {"count": count, "result_bytes": result,
                         "link_bytes": RING_FACTOR.get(kind, 1.0) * result}
    return out


class _Ops(TorchDispatchMode):
    """Bytes by operation and storage lifetimes (see the module)."""

    def __init__(self, census: "Census"):
        super().__init__()
        self.census = census

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket not in flop_registry:
            # a composite (reaching the mode undecomposed where autograd
            # is off, as in inference mode) is counted by its parts
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        c = self.census
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            n = count(*args, **kwargs, out_val=out)
            c.flops += n
            if FALLBACK.get():
                c.attn_fallback_flops += n
        if not func.is_view and func not in _METADATA:
            n = _bytes(args) + _bytes(kwargs) + _bytes(out)
            c.hbm_bytes += n
            if FALLBACK.get():
                c.attn_fallback_bytes += n
        for t in leaves(out):
            c.hold(t, func)
        return out


class Census:
    """A context that counts one rank's program (the module's quantities).
    ``args``: the step's arguments, held live from the start.  After the
    block, :meth:`finish` with the step's results gives the record's
    ``census`` and ``memory``."""

    def __init__(self, args=()):
        self.flops = self.hbm_bytes = self.attn_fallback_bytes = 0
        self.attn_fallback_flops = 0
        self.live: dict = {}
        self.live_bytes = self.peak_bytes = self.allocated_bytes = 0
        self.peak_op, self.live_by_op, self.peak_by_op = None, {}, {}
        for t in leaves(args):
            self.hold(t, "arguments")
        self.argument_bytes = self.live_bytes
        #: bytes of every storage created inside the block
        self.allocated_bytes = 0
        self._arg_keys = set(self.live)

    def hold(self, t: torch.Tensor, op=None) -> None:
        """Count ``t``'s storage live until it is released (``op`` made
        it)."""
        st = t.untyped_storage()     # one object per storage while it lives
        key = id(st)
        if key in self.live:
            return
        n, op = st.nbytes(), str(op)
        self.live[key] = (n, op)
        self.live_bytes += n
        self.live_by_op[op] = self.live_by_op.get(op, 0) + n
        self.allocated_bytes += n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes, self.peak_op = self.live_bytes, op
            self.peak_by_op = dict(self.live_by_op)
        weakref.finalize(st, self._release, key)

    def _release(self, key) -> None:
        n, op = self.live.pop(key, (0, None))
        self.live_bytes -= n
        if op is not None:
            self.live_by_op[op] -= n

    def __enter__(self):
        self._traffic = {k: list(v) for k, v in context.traffic.items()}
        self._ops = _Ops(self)
        self._ops.__enter__()
        return self

    def __exit__(self, *exc):
        self._ops.__exit__(*exc)
        self.collectives = collectives(self._traffic, context.traffic)

    def finish(self, results) -> dict:
        """{"census": ..., "memory": ...} once the step returned
        ``results``."""
        outs = {}
        for t in leaves(results):
            st = t.untyped_storage()
            outs[id(st)] = st.nbytes()
        new = sum(n for k, n in outs.items() if k not in self._arg_keys)
        return {
            "census": {
                "flops": int(self.flops),
                "hbm_bytes": self.hbm_bytes,
                "attn_fallback_bytes": self.attn_fallback_bytes,
                "attn_fallback_flops": int(self.attn_fallback_flops),
                "collective_link_bytes": sum(
                    c["link_bytes"] for c in self.collectives.values()),
                "collectives": self.collectives,
                "peak_op": self.peak_op,
                "peak_by_op": {op: n for op, n in sorted(
                    self.peak_by_op.items(), key=lambda kv: -kv[1])
                    if n}},
            "memory": {
                "argument_bytes": self.argument_bytes,
                "output_bytes": sum(outs.values()),
                "temp_bytes": max(self.peak_bytes - self.argument_bytes
                                  - new, 0),
                "peak_bytes": self.peak_bytes}}
