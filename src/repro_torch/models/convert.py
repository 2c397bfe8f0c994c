"""Carry a parameter tree of the JAX reference across to the port.

:func:`params_from_jax` takes the reference's LM params (dense, MoE or VLM;
GQA or MLA attention) as a nested dict of numpy arrays — float, or
quantized by its ``quantize_params`` — with the layer axis stacked first,
and builds the port's :class:`~repro_torch.models.lm.DecoderLM` holding
the same numbers, so both packages compute the same function.  It reads
numpy only: the caller turns the reference's arrays into numpy
(``np.asarray``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import moe as MOE
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


def _mlp(p: dict, device, layer: int) -> L.MLP:
    return L.MLP(_linear(p["wi"], device, layer),
                 _linear(p["wo"], device, layer),
                 _linear(p["wg"], device, layer) if "wg" in p else None)


def _moe(p: dict, device, layer: int) -> MOE.MoE:
    """``router`` (float, or ``w_q`` / ``scale``), the banks ``wi`` / ``wg``
    / ``wo`` or their ``_q`` / ``_s`` forms, and the optional ``shared``."""
    banks = {k: _tensor(v[layer], device) for k, v in p.items()
             if k not in ("router", "shared")}
    return MOE.MoE(_linear(p["router"], device, layer), banks,
                   _mlp(p["shared"], device, layer) if "shared" in p
                   else None)


#: the attention linears, in each module's argument order
GQA_KEYS = ("wq", "wk", "wv", "wo")
MLA_KEYS = ("wq", "w_dkv", "w_krope", "w_uk", "w_uv", "wo")


def _attention(at: dict, cfg: ModelConfig, device, layer: int):
    if not cfg.mla:
        return A.GQAttention(*(_linear(at[n], device, layer)
                               for n in GQA_KEYS))
    # the reference normalises ckv with rmsnorm's default eps
    return A.MLAttention(*(_linear(at[n], device, layer) for n in MLA_KEYS),
                         L.RMSNorm(_tensor(at["norm_ckv"]["g"][layer],
                                           device)))


def _blocks(lay: dict, cfg: ModelConfig, device) -> list:
    def block(i: int) -> lm.DecoderBlock:
        ffn = {"moe": _moe(lay["moe"], device, i)} if "moe" in lay \
            else {"mlp": _mlp(lay["mlp"], device, i)}
        return lm.DecoderBlock(
            L.RMSNorm(_tensor(lay["ln1"]["g"][i], device), cfg.norm_eps),
            _attention(lay["attn"], cfg, device, i),
            L.RMSNorm(_tensor(lay["ln2"]["g"][i], device), cfg.norm_eps),
            **ffn)
    return [block(i) for i in range(len(lay["ln1"]["g"]))]


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> lm.DecoderLM:
    """The reference's LM params (numpy leaves) as a DecoderLM on
    ``device`` (the card when None): ``layers``, for a MoE model's first
    dense layers ``dense_layers``, and a VLM's ``img_proj``."""
    device = resolve_device(device)
    return lm.DecoderLM(
        L.Embedding(_tensor(tree["embed"]["table"], device)),
        _blocks(tree["layers"], cfg, device),
        L.RMSNorm(_tensor(tree["final_norm"]["g"], device), cfg.norm_eps),
        _linear(tree["head"], device),
        _blocks(tree["dense_layers"], cfg, device)
        if "dense_layers" in tree else [],
        _linear(tree["img_proj"], device) if "img_proj" in tree else None)
