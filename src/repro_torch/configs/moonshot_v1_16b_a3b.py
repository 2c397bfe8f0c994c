"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=163840, MoE 64 experts top-6 (kimi/moonlight).
[hf:moonshotai/Moonlight-16B-A3B]"""

from repro_torch.configs import base
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, vocab_size=163840,
        moe=True, n_experts=64, top_k=6, moe_d_ff=1408, n_shared_experts=2,
        capacity_factor=1.25, rope_theta=50000.0)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=96, vocab_size=256, moe=True,
        n_experts=8, top_k=2, moe_d_ff=96, n_shared_experts=2,
        capacity_factor=2.0, remat=False)


base.register("moonshot-v1-16b-a3b", full, smoke)
