"""mistral-nemo-12b [dense]: 40L d_model=5120 32H (GQA kv=8, head_dim=128)
d_ff=14336 vocab=131072, 128k ctx.  [hf:mistralai/Mistral-Nemo-Base-2407]"""

from repro_torch.configs import base
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
        vocab_size=131072, rope_theta=1e6)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemo-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=256,
        remat=False)


base.register("mistral-nemo-12b", full, smoke)
