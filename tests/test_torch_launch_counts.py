"""The launch counts ``chip_smoke.py`` holds each served model to on the
card, on the CPU: one W8A8 prefill and one decode step of every served
family at smoke size, with the LM kernels' calls recorded at the dispatch
layer (``chip_smoke.recorded_lm_kernel_calls``; on the CPU they run the
plain versions), make exactly ``chip_smoke.matmuls_per_call`` projections
and one attention launch per layer at prefill, none at decode."""

import jax  # noqa: F401  (imported by every port test file; unused here)
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.configs import base as cb
from repro_torch.models import layers as L
from repro_torch.models import lm


@pytest.mark.parametrize("arch", [chip_smoke.SERVE_ARCH, chip_smoke.MOE_ARCH,
                                  chip_smoke.MLA_ARCH, chip_smoke.VLM_ARCH])
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
    n = chip_smoke.batch_positions(batch)

    def counts(calls):
        return {k: sum(c[0] == k for c in calls)
                for k in ("nmc_matmul", "flash_attention")}
    with chip_smoke.recorded_lm_kernel_calls() as calls:
        logits, caches = lm.prefill(params, batch, cfg, n + 4)
    assert counts(calls) == {
        "nmc_matmul": chip_smoke.matmuls_per_call(cfg, True),
        "flash_attention": cfg.n_layers}
    with chip_smoke.recorded_lm_kernel_calls() as calls:
        lm.decode_step(params, logits.argmax(-1)[:, None], caches,
                       torch.full((2,), n + 1, dtype=torch.int32), cfg)
    assert counts(calls) == {
        "nmc_matmul": chip_smoke.matmuls_per_call(cfg, False),
        "flash_attention": 0}
