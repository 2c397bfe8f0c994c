"""whisper-tiny [audio]: enc-dec, 4+4L d_model=384 6H d_ff=1536 vocab=51865.
The conv frontend is a stub: the caller passes precomputed frame
embeddings (B, enc_seq, d_model) as ``batch["frames"]``.
[arXiv:2212.04356]"""

from repro_torch.configs import base
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="encdec", n_layers=4, n_enc_layers=4,
        d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536, vocab_size=51865,
        encdec=True, learned_pos=True, enc_seq=1500, act="gelu")


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec", n_layers=2, n_enc_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
        encdec=True, learned_pos=True, enc_seq=32, act="gelu", remat=False)


base.register("whisper-tiny", full, smoke)
