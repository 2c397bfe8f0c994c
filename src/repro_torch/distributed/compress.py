"""Gradient compression with error feedback: int8 symmetric quantization.

The counterpart of the JAX package's ``distributed/compress.py``, over a
name -> tensor dict.  Each gradient, plus the error the previous step's
compression left, is quantized to int8 with one scale per leaf of the
parameter tree, ``max(|g|) / 127``; what the rounding lost is kept as the
next error, so the compression is unbiased over steps.  The reference's
tree stacks every layer's copy of a weight into one leaf, so the port's
per-layer tensors of one weight share one scale (:func:`leaf_of`).  The
train step compresses the gradient after its mean over the data ranks and
decompresses it at once, in the reference's order (mean, compress, clip,
update): the compressed all-reduce itself would sum other numbers and is
not the reference's.  On a mesh a model-sharded leaf's scale is the
maximum over the model ranks (``amax_over``).
"""

from __future__ import annotations

import re

import torch

#: the stacks whose layers the reference keeps in one leaf per weight (a
#: hybrid's Mamba2 layers two deep, groups then layers); an xLSTM's blocks
#: are a list there, one leaf each
_STACKED = re.compile(r"^(layers|dense_layers|enc_layers"
                      r"|mamba(?=\.\d+\.\d+))\.\d+\.(\d+\.)?")


def leaf_of(name: str) -> str:
    """The reference's leaf a parameter of the port belongs to: its name
    with the layer index of a stack as ``*`` (``layers.3.attn.wq.w`` ->
    ``layers.*.attn.wq.w``, ``mamba.2.5.in_x.w`` -> ``mamba.*.in_x.w``)."""
    return _STACKED.sub(lambda m: m.group(1) + ".*.", name)


def _scale(gs: list, amax_over=None, names=()) -> torch.Tensor:
    amax = torch.max(torch.stack([torch.max(torch.abs(g)) for g in gs]))
    if amax_over is not None:
        amax = amax_over(names, amax)
    return torch.clamp_min(amax, 1e-8) / 127.0


def _quantize(g: torch.Tensor, scale: torch.Tensor) -> tuple:
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return (q, scale), g - q.float() * scale


def compress(g: torch.Tensor, err: torch.Tensor) -> tuple:
    """((int8 values, float32 scale), the new error), the error feedback
    added first."""
    g = g.float() + err
    return _quantize(g, _scale([g]))


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params: dict) -> dict:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def compress_tree(grads: dict, err_state: dict, amax_over=None) -> tuple:
    """({name: (q, scale)}, {name: new error}); one scale for the tensors
    of one leaf of the reference's tree (:func:`leaf_of`).  ``amax_over
    (names, amax)``, when given, returns the leaf's maximum over the ranks
    that hold its other slices."""
    leaves: dict = {}
    for name in grads:
        leaves.setdefault(leaf_of(name), []).append(name)
    qs, errs = {}, {}
    for names in leaves.values():
        gs = [grads[n].float() + err_state[n] for n in names]
        scale = _scale(gs, amax_over, names)
        for name, g in zip(names, gs):
            qs[name], errs[name] = _quantize(g, scale)
    return qs, errs


def decompress_tree(cgrads: dict) -> dict:
    return {name: decompress(*qs) for name, qs in cgrads.items()}
