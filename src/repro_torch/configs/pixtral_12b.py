"""pixtral-12b [vlm]: pixtral-ViT frontend (a stub: the caller passes
precomputed patch embeddings as ``batch["images"]``) + mistral-nemo
backbone: 40L d_model=5120 32H (kv=8, head_dim=128) d_ff=14336
vocab=131072.  [hf:mistralai/Pixtral-12B-2409]"""

from repro_torch.configs import base
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
        vocab_size=131072, vlm=True, n_img_tokens=1024, rope_theta=1e9)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="pixtral-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=256,
        vlm=True, n_img_tokens=8, remat=False)


base.register("pixtral-12b", full, smoke)
