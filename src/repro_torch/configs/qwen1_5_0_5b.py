"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (kv=16) d_ff=2816
vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5-0.5B]"""

from repro_torch.configs import base
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b", family="dense", n_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=16, d_ff=2816, vocab_size=151936,
        qkv_bias=True, rope_theta=1e6)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512, qkv_bias=True,
        remat=False)


base.register("qwen1.5-0.5b", full, smoke)
