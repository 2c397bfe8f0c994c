"""Carry a parameter tree of the JAX reference across to the port.

:func:`params_from_jax` takes the reference's LM params (dense, MoE, VLM,
hybrid, encoder-decoder or xLSTM; GQA or MLA attention) as a nested dict
of numpy arrays — float, or quantized by its ``quantize_params`` — with
the layer axis stacked first (a hybrid's Mamba2 layers ``(groups,
attn_every, ...)``; an xLSTM's blocks a list, unstacked), and builds the
port's model (:mod:`repro_torch.models.lm`) holding the same numbers, so
both packages compute the same function: float leaves as trainable
parameters, int8 ``w_q`` and its ``scale`` as buffers.  It reads numpy
only: the caller turns the reference's arrays into numpy
(``np.asarray``).  The tensors are always full: a model laid out on a mesh
takes its local slices afterwards (``lm.shard``, through
``sharding.local_slice``), as the reference's ``init`` is followed by a
``device_put``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.config import ModelConfig, resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no torch equivalent
        return torch.as_tensor(a.astype(np.float32)).to(device,
                                                        torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)       # a writable copy


def _linear(p: dict, device, layer=None) -> L.NmcLinear:
    """``layer``: the index into the stacked leaves (an int, a (group,
    layer) tuple, or None for unstacked ones)."""
    def get(key):
        if key not in p:
            return None
        return _tensor(p[key] if layer is None else p[key][layer], device)
    if "w_q" in p:
        return L.NmcLinear(b=get("b"), w_q=get("w_q"), scale=get("scale"))
    return L.NmcLinear(get("w"), get("b"))


def _mlp(p: dict, device, layer) -> L.MLP:
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


def _attention(at: dict, cfg: ModelConfig, device, layer):
    if not cfg.mla:
        return A.GQAttention(*(_linear(at[n], device, layer)
                               for n in GQA_KEYS))
    # the reference normalises ckv with rmsnorm's default eps
    return A.MLAttention(*(_linear(at[n], device, layer) for n in MLA_KEYS),
                         L.RMSNorm(_tensor(at["norm_ckv"]["g"][layer],
                                           device)))


def _rms(p: dict, device, layer, eps: float) -> L.RMSNorm:
    return L.RMSNorm(_tensor(p["g"] if layer is None else p["g"][layer],
                             device), eps)


def _ln(p: dict, device, layer: int, eps: float) -> L.LayerNorm:
    return L.LayerNorm(_tensor(p["g"][layer], device),
                       _tensor(p["b"][layer], device), eps)


def _block(lay: dict, cfg: ModelConfig, device, i) -> lm.DecoderBlock:
    ffn = {"moe": _moe(lay["moe"], device, i)} if "moe" in lay \
        else {"mlp": _mlp(lay["mlp"], device, i)}
    return lm.DecoderBlock(_rms(lay["ln1"], device, i, cfg.norm_eps),
                           _attention(lay["attn"], cfg, device, i),
                           _rms(lay["ln2"], device, i, cfg.norm_eps), **ffn)


def _blocks(lay: dict, cfg: ModelConfig, device) -> list:
    return [_block(lay, cfg, device, i) for i in range(len(lay["ln1"]["g"]))]


def _enc_blocks(lay: dict, cfg: ModelConfig, device) -> list:
    eps = cfg.norm_eps
    return [lm.EncoderBlock(_ln(lay["ln1"], device, i, eps),
                            _attention(lay["attn"], cfg, device, i),
                            _ln(lay["ln2"], device, i, eps),
                            _mlp(lay["mlp"], device, i))
            for i in range(len(lay["ln1"]["g"]))]


def _dec_blocks(lay: dict, cfg: ModelConfig, device) -> list:
    eps = cfg.norm_eps
    return [lm.CrossDecoderBlock(_ln(lay["ln1"], device, i, eps),
                                 _attention(lay["attn"], cfg, device, i),
                                 _ln(lay["lnx"], device, i, eps),
                                 _attention(lay["xattn"], cfg, device, i),
                                 _ln(lay["ln2"], device, i, eps),
                                 _mlp(lay["mlp"], device, i))
            for i in range(len(lay["ln1"]["g"]))]


def _mamba(p: dict, device, idx: tuple) -> SSM.Mamba2:
    """One Mamba2 layer at ``idx`` = (group, layer) of the stacked tree."""
    def t(a):
        return _tensor(a[idx], device)
    # the gated norm takes rmsnorm's default eps, as in the reference
    return SSM.Mamba2({k: _linear(p[k], device, idx) for k in SSM.PROJ_KEYS},
                      t(p["conv_x"]["w"]), t(p["conv_x"]["b"]),
                      t(p["conv_bc"]["w"]), t(p["conv_bc"]["b"]),
                      t(p["A_log"]), t(p["D"]), t(p["dt_bias"]),
                      L.RMSNorm(t(p["norm"]["g"])),
                      _linear(p["out_proj"], device, idx))


def _xlstm_block(p: dict, cfg: ModelConfig, device) -> nn.Module:
    """One xLSTM block's dict: an sLSTM one (``r_z`` ...) or an mLSTM
    one."""
    eps = cfg.norm_eps
    if "r_z" in p:
        return XL.SLSTM(_rms(p["norm"], device, None, eps),
                        {g: _linear(p[f"w_{g}"], device) for g in XL.GATES},
                        {g: _tensor(p[f"r_{g}"], device) for g in XL.GATES},
                        _rms(p["ffn_norm"], device, None, eps),
                        _linear(p["up"], device), _linear(p["down"], device))
    return XL.MLSTM(_rms(p["norm"], device, None, eps),
                    {k: _linear(p[k], device) for k in XL.MLSTM.KEYS},
                    _rms(p["out_norm"], device, None, eps))


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> lm.LMBase:
    """The reference's LM params (numpy leaves) as the port's model on
    ``device`` (the card when None): a DecoderLM (``layers``, for a MoE
    model's first dense layers ``dense_layers``, a VLM's ``img_proj``), a
    HybridLM (``mamba`` unstacked from ``(G, attn_every, ...)``,
    ``shared_attn``), an EncDecLM (``enc_layers``, ``layers`` with
    ``lnx`` / ``xattn``, ``pos_dec``, ``enc_norm``) or an XLSTMLM
    (``blocks``, each block's float weights as they are)."""
    device = resolve_device(device)
    embed = L.Embedding(_tensor(tree["embed"]["table"], device))
    final_norm = _rms(tree["final_norm"], device, None, cfg.norm_eps)
    head = _linear(tree["head"], device)
    if cfg.family == "hybrid":
        groups, per = np.asarray(tree["mamba"]["A_log"]).shape[:2]
        mamba = [[_mamba(tree["mamba"], device, (g, e)) for e in range(per)]
                 for g in range(groups)]
        return lm.HybridLM(embed, mamba,
                           _block(tree["shared_attn"], cfg, device, None),
                           final_norm, head)
    if cfg.family == "xlstm":
        return lm.XLSTMLM(embed, [_xlstm_block(p, cfg, device)
                                  for p in tree["blocks"]], final_norm, head)
    if cfg.family == "encdec":
        return lm.EncDecLM(
            embed, _enc_blocks(tree["enc_layers"], cfg, device),
            _dec_blocks(tree["layers"], cfg, device),
            L.Embedding(_tensor(tree["pos_dec"]["table"], device)),
            _rms(tree["enc_norm"], device, None, cfg.norm_eps), final_norm,
            head)
    return lm.DecoderLM(
        embed, _blocks(tree["layers"], cfg, device), final_norm, head,
        _blocks(tree["dense_layers"], cfg, device)
        if "dense_layers" in tree else [],
        _linear(tree["img_proj"], device) if "img_proj" in tree else None)
