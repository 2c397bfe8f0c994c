"""Carry a parameter tree of the JAX reference across to the port.

:func:`params_from_jax` takes the reference's dense-LM params as a nested
dict of numpy arrays — float, or quantized by its ``quantize_params`` —
with the layer axis stacked first, and builds the port's
:class:`~repro_torch.models.lm.DecoderLM` holding the same numbers, so both
packages compute the same function.  It reads numpy only: the caller turns
the reference's arrays into numpy (``np.asarray``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no torch equivalent
        return torch.as_tensor(a.astype(np.float32)).to(device,
                                                        torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)       # a writable copy


def _linear(p: dict, device, layer: int | None = None) -> L.NmcLinear:
    def get(key):
        if key not in p:
            return None
        return _tensor(p[key] if layer is None else p[key][layer], device)
    if "w_q" in p:
        return L.NmcLinear(b=get("b"), w_q=get("w_q"), scale=get("scale"))
    return L.NmcLinear(get("w"), get("b"))


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> lm.DecoderLM:
    """The reference's dense-LM params (numpy leaves) as a DecoderLM on
    ``device`` (the card when None)."""
    device = resolve_device(device)
    lay = tree["layers"]

    def block(i: int) -> lm.DecoderBlock:
        at, ml = lay["attn"], lay["mlp"]
        return lm.DecoderBlock(
            L.RMSNorm(_tensor(lay["ln1"]["g"][i], device), cfg.norm_eps),
            A.GQAttention(*(_linear(at[n], device, i)
                            for n in ("wq", "wk", "wv", "wo"))),
            L.RMSNorm(_tensor(lay["ln2"]["g"][i], device), cfg.norm_eps),
            L.MLP(_linear(ml["wi"], device, i), _linear(ml["wo"], device, i),
                  _linear(ml["wg"], device, i) if "wg" in ml else None))

    return lm.DecoderLM(
        L.Embedding(_tensor(tree["embed"]["table"], device)),
        [block(i) for i in range(cfg.n_layers)],
        L.RMSNorm(_tensor(tree["final_norm"]["g"], device), cfg.norm_eps),
        _linear(tree["head"], device))
