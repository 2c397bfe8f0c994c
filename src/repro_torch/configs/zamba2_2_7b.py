"""zamba2-2.7b [hybrid]: 54 Mamba2 layers + a shared attention/MLP block
applied every 6 layers.  54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64.  [arXiv:2411.15242; hf]

The shared block uses a 4096 sliding window (Zamba2's training context).
"""

from repro_torch.configs import base
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv_heads=32, d_ff=10240, vocab_size=32000,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
        attn_every=6, window=4096, rope_theta=10000.0)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=16, attn_every=2, window=64, remat=False)


base.register("zamba2-2.7b", full, smoke)
