"""Abstract inputs for the dry run: every (architecture x shape) cell's
arguments as tensors on the ``meta`` device (shapes and dtypes, no
memory, nothing drawn).

The counterpart of the JAX package's ``launch/specs.py``, with its names.
Where the reference builds ``ShapeDtypeStruct`` trees with
``jax.eval_shape``, the port builds its own modules and tensors on
``meta``: the parameters are an :class:`~repro_torch.models.lm.LMBase`
whose weights are meta tensors, the optimizer state and the batch dicts
of meta tensors.  Serving weights follow the reference: bf16 where the
training weights are float32, or under ``nmc_mode != "none"`` the int8
form of ``quantize_tree`` with its scales, the rest left float32 (the
hybrid's Mamba2 layers and the xLSTM's blocks stay float, facts 1 and 5
of ROADMAP.md).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib

META = torch.device("meta")


def _empty(shape: tuple, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def abstract_params(cfg: ModelConfig, serve: bool = False) -> lm.LMBase:
    """The model on ``meta``: float32 training weights; for serving bf16
    ones, or the int8 NMC form under ``cfg.nmc_mode != "none"``."""
    if serve and cfg.nmc_mode != "none":
        # the paper's technique: serving weights int8 with per-channel
        # scales, each block quantized as drawn
        return lm.draw_blocks(cfg, None, META, L.quantize_tree)
    model = lm.init_params(cfg, None, META)
    if serve:          # baseline serving runs bf16 weights
        for p in model.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(torch.bfloat16)
    return model


def abstract_opt_state(cfg: ModelConfig) -> dict:
    """AdamW's state beside :func:`abstract_params`, unsharded."""
    params = dict(abstract_params(cfg).named_parameters())
    return adamw.init_state(params)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The batch of one cell: tokens (with a VLM's images, an
    encoder-decoder's frames) for train and prefill; one new token and
    the cache lengths for decode."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        s_text = s - (cfg.n_img_tokens if cfg.family == "vlm" else 0)
        batch = {"tokens": _empty((b, s_text), torch.int32)}
        if cfg.family == "encdec":
            batch["frames"] = _empty((b, cfg.enc_seq, cfg.d_model),
                                     torch.bfloat16)
        if cfg.family == "vlm":
            batch["images"] = _empty((b, cfg.n_img_tokens, cfg.d_model),
                                     torch.bfloat16)
        return batch
    # decode: one new token against a seq_len cache
    return {"tokens": _empty((b, 1), torch.int32),
            "cache_len": _empty((b,), torch.int32)}


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """Sliding-window archs keep a ring cache of ``window`` slots."""
    if cfg.window is not None:
        return min(seq_len, cfg.window)
    return seq_len


def abstract_caches(cfg: ModelConfig, shape: ShapeSpec,
                    params: lm.LMBase | None = None) -> dict:
    """The unsharded model's decode caches on ``meta``: bf16, or int8 with
    scales under ``kv_cache_dtype="int8"``.  ``params``: the serving
    model, when the caller has it."""
    params = params if params is not None \
        else abstract_params(cfg, serve=True)
    return lm.init_caches(params, cfg, shape.global_batch,
                          cache_len_for(cfg, shape.seq_len),
                          dtype=torch.bfloat16)


def cell_fn_and_inputs(cfg: ModelConfig, shape: ShapeSpec,
                       opt_cfg: adamw.AdamWConfig | None = None,
                       local_batch: bool = False,
                       n_microbatches: int = 1) -> tuple:
    """(step function, abstract arguments, the indices of the arguments it
    updates in place): ``train_step(model, opt_state, batch)``,
    ``prefill(model, batch)`` or ``decode(model, tokens, caches,
    cache_len)``.  ``local_batch``: a train step is handed this data
    rank's rows (:func:`repro_torch.train.step.make_train_step`), split
    into ``n_microbatches``."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    if shape.kind == "train":
        fn = step_lib.make_train_step(cfg, opt_cfg, n_microbatches,
                                      local_batch=local_batch)
        model = abstract_params(cfg)
        args = (model, adamw.init_state(dict(model.named_parameters())),
                input_specs(cfg, shape))
        return fn, args, (0, 1)
    if shape.kind == "prefill":
        def prefill(params, batch):
            return lm.prefill(params, batch, cfg, shape.seq_len,
                              global_batch=shape.global_batch)
        return prefill, (abstract_params(cfg, serve=True),
                         input_specs(cfg, shape)), ()

    def decode(params, tokens, caches, cache_len):
        # on a model axis the caches' slices do not tell their full length
        return lm.decode_step(params, tokens, caches, cache_len, cfg,
                              max_len=cache_len_for(cfg, shape.seq_len))
    io = input_specs(cfg, shape)
    params = abstract_params(cfg, serve=True)
    args = (params, io["tokens"], abstract_caches(cfg, shape, params),
            io["cache_len"])
    return decode, args, (2,)
