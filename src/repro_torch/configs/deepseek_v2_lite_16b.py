"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H, MLA kv_lora=512,
MoE: 2 shared + 64 routed experts top-6, expert d_ff=1408, vocab=102400,
first layer dense (d_ff=10944).  [arXiv:2405.04434; hf]"""

from repro_torch.configs import base
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=102400,
        mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128, moe=True, n_experts=64, top_k=6, moe_d_ff=1408,
        n_shared_experts=2, first_dense_layers=1, dense_d_ff=10944,
        capacity_factor=1.25, rope_theta=10000.0)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=96, vocab_size=256, mla=True,
        kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        moe=True, n_experts=8, top_k=2, moe_d_ff=96, n_shared_experts=2,
        first_dense_layers=1, dense_d_ff=128, capacity_factor=2.0, remat=False)


base.register("deepseek-v2-lite-16b", full, smoke)
