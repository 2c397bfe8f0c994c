"""The launch counts ``chip_smoke.py`` holds each served model to on the
card, on the CPU: one W8A8 prefill and one decode step of every served
family at smoke size, with the LM kernels' calls recorded at the dispatch
layer (``chip_smoke.recorded_lm_kernel_calls``; on the CPU they run the
plain versions), make exactly ``chip_smoke.matmul_kn_per_call``
projections of each (K, N) and ``chip_smoke.attention_launches_per_call``
attention launches: one per attention layer at prefill (a hybrid's shared
block once per group; an encoder-decoder's encoder, decoder and
cross-attention), none at decode but an encoder-decoder's
cross-attention; an xLSTM's only launch is its head's ``nmc_matmul``."""

import collections

import jax  # noqa: F401  (imported by every port test file; unused here)
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.configs import base as cb
from repro_torch.models import layers as L
from repro_torch.models import lm


@pytest.mark.parametrize("arch", [chip_smoke.SERVE_ARCH, chip_smoke.MOE_ARCH,
                                  chip_smoke.MLA_ARCH, chip_smoke.VLM_ARCH,
                                  chip_smoke.ENCDEC_ARCH,
                                  chip_smoke.HYBRID_ARCH,
                                  chip_smoke.XLSTM_ARCH])
def test_prefill_and_decode_launches_match_the_smoke_counts(arch):
    cfg = cb.get(arch, smoke=True).scaled(nmc_mode="w8a8")
    params = lm.draw_blocks(cfg, torch.Generator().manual_seed(0), "cpu",
                            L.quantize_tree)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 5)))}
    if cfg.family == "vlm":
        batch["images"] = torch.from_numpy(rng.normal(
            size=(2, cfg.n_img_tokens, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    n = chip_smoke.batch_positions(batch)

    def counts(calls):
        return {k: sum(c[0] == k for c in calls)
                for k in ("nmc_matmul", "flash_attention")}

    def kn(calls):
        return dict(collections.Counter(
            (c[1][0].shape[1], c[1][1].shape[1]) for c in calls
            if c[0] == "nmc_matmul"))
    with chip_smoke.recorded_lm_kernel_calls() as calls:
        logits, caches = lm.prefill(params, batch, cfg, n + 4)
    assert counts(calls) == {
        "nmc_matmul": chip_smoke.matmuls_per_call(cfg, True),
        "flash_attention": chip_smoke.attention_launches_per_call(cfg, True)}
    assert kn(calls) == chip_smoke.matmul_kn_per_call(cfg, True)
    with chip_smoke.recorded_lm_kernel_calls() as calls:
        lm.decode_step(params, logits.argmax(-1)[:, None], caches,
                       torch.full((2,), n + 1, dtype=torch.int32), cfg)
    assert counts(calls) == {
        "nmc_matmul": chip_smoke.matmuls_per_call(cfg, False),
        "flash_attention": chip_smoke.attention_launches_per_call(cfg, False)}
    assert kn(calls) == chip_smoke.matmul_kn_per_call(cfg, False)


@pytest.mark.parametrize("arch,prefill,decode,attention", [
    (chip_smoke.ENCDEC_ARCH, 57, 33, (12, 4)),
    (chip_smoke.HYBRID_ARCH, 64, 64, (9, 0)),
    (chip_smoke.XLSTM_ARCH, 1, 1, (0, 0)),
])
def test_full_width_counts_of_the_new_families(arch, prefill, decode,
                                               attention):
    """whisper-tiny: encoder 4 x 6, decoder 4 x 8 (cross k and v are not
    nmc_matmul), the head; its head alone on dp4a.  zamba2-2.7b: the shared
    block's 7 projections in each of 9 groups, the head; all on the tensor
    cores.  xlstm-125m: the head (768, 50304) alone, on the tensor cores;
    no attention."""
    cfg = cb.get(arch)
    assert chip_smoke.matmuls_per_call(cfg, True) == prefill
    assert chip_smoke.matmuls_per_call(cfg, False) == decode
    assert (chip_smoke.attention_launches_per_call(cfg, True),
            chip_smoke.attention_launches_per_call(cfg, False)) == attention
    head = 1 if cfg.family == "encdec" else 0
    for pre, total in ((True, prefill), (False, decode)):
        assert chip_smoke.matmul_routes_per_call(cfg, pre) == \
            {"dp4a": head, "tensor_core": total - head}


@pytest.mark.parametrize("part,arch,want", [
    ("p", chip_smoke.ENCDEC_ARCH,
     {"nmc_matmul": 57 + 16 * 33,
      "matmul_routes": {"dp4a": 17, "tensor_core": 57 + 16 * 33 - 17},
      "matmul_int32": 4 * 2 + 4 * 3 + 16 * 4 * 3,
      "flash_attention": 12 + 16 * 4}),
    ("q", chip_smoke.XLSTM_ARCH,
     {"nmc_matmul": 17, "matmul_routes": {"dp4a": 0, "tensor_core": 17},
      "matmul_int32": 0, "flash_attention": 0}),
])
def test_scaleout_serving_parts_expect_their_launches(part, arch, want):
    """The launches ``chip_smoke.scaleout_serving_checks`` requires of the
    serving parts at full width and depth over a prefill and 16 steps:
    whisper-tiny's head whole on ``dp4a`` (the odd vocabulary), its
    row-parallel ``wo`` / ``down`` returning int32 (the encoder's 2 a layer
    at prefill, the decoder's self and cross ``wo`` and ``down``), its
    cross-attention one launch a layer at decode; xlstm-125m's head alone,
    no attention and no int32-out launch (its blocks stay float)."""
    cfg = cb.get(arch).scaled(nmc_mode="w8a8")
    steps = chip_smoke.SCALEOUT_SERVE_SIZES[part]["steps"]
    assert steps == 16
    assert chip_smoke.serving_part_expected(cfg, steps) == want
