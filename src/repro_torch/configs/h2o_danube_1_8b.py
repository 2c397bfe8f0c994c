"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attention.
24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.  [arXiv:2401.16818; hf]
Sub-quadratic via SWA (window 4096)."""

from repro_torch.configs import base
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="dense", n_layers=24, d_model=2560,
        n_heads=32, n_kv_heads=8, d_ff=6912, vocab_size=32000,
        window=4096, rope_theta=10000.0)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="danube-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, window=32,
        remat=False)


base.register("h2o-danube-1.8b", full, smoke)
