"""xlstm-125m [ssm]: 12L d_model=768 4H vocab=50304 — sLSTM + mLSTM blocks
(sLSTM at layers 3 and 9, others mLSTM; ~[7:1] mix of arXiv:2405.04517)."""

from repro_torch.configs import base
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="xlstm", n_layers=12, d_model=768,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
        slstm_layers=(3, 9), ssm_chunk=128)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="xlstm", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=256,
        slstm_layers=(1,), ssm_chunk=16, remat=False)


base.register("xlstm-125m", full, smoke)
