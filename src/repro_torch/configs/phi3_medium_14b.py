"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352, RoPE SwiGLU GQA.  [arXiv:2404.14219]"""

from repro_torch.configs import base
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
        n_heads=40, n_kv_heads=10, d_ff=17920, vocab_size=100352,
        rope_theta=10000.0)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-smoke", family="dense", n_layers=2, d_model=80,
        n_heads=4, n_kv_heads=2, d_ff=160, vocab_size=256, remat=False)


base.register("phi3-medium-14b", full, smoke)
