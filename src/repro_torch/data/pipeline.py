"""Deterministic, resumable data pipeline.

The counterpart of the JAX package's ``data/pipeline.py``: numpy batches,
the same as the reference's bit for bit (the reference's module imports
its model config, which imports JAX, so the port keeps this copy).

Production shape: every host reads only its shard of the global batch
(``host_batch = global_batch / n_hosts``), and batches are a pure function
of (seed, step) — so restart-from-checkpoint reproduces the exact token
stream with no data-loader state to persist beyond the step counter, and
elastic re-sharding (different host count after a resize) re-partitions the
same global stream.

Two sources:
  * ``SyntheticLM`` — seeded-PRNG token stream (benchmarks / tests / CI).
  * ``PackedFileDataset`` — memory-mapped uint16/uint32 token file, packed
    into fixed-length rows, sharded by host then by step (real corpora).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of n_hosts {self.n_hosts}")
        return self.global_batch // self.n_hosts


class SyntheticLM:
    """Deterministic synthetic LM batches: batch = f(seed, step, host)."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig):
        self.cfg = cfg
        self.mc = model_cfg

    def batch_at(self, step: int) -> dict:
        c, mc = self.cfg, self.mc
        out = {}
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.host_id]))
        fam = mc.family
        s_text = c.seq_len - (mc.n_img_tokens if fam == "vlm" else 0)
        out["tokens"] = rng.integers(0, mc.vocab_size,
                                     (c.host_batch, s_text), dtype=np.int32)
        if fam == "encdec":
            out["frames"] = rng.normal(
                size=(c.host_batch, mc.enc_seq, mc.d_model)).astype(np.float32)
        if fam == "vlm":
            out["images"] = rng.normal(
                size=(c.host_batch, mc.n_img_tokens, mc.d_model)
            ).astype(np.float32)
        return out

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class PackedFileDataset:
    """Memory-mapped token file -> fixed-length packed rows.

    Deterministic assignment: row r of the epoch permutation goes to
    (step, slot) = divmod(r, global_batch); each host takes its contiguous
    slot range.  The permutation is seeded, so any (host count, step) pair
    addresses the same global stream."""

    def __init__(self, path: str, cfg: DataConfig, dtype=np.uint16):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.n_rows = len(self.tokens) // (cfg.seq_len + 1)
        if self.n_rows < cfg.global_batch:
            raise ValueError(f"{path}: {self.n_rows} rows of "
                             f"{cfg.seq_len + 1} tokens, fewer than a batch "
                             f"of {cfg.global_batch}")

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        epoch, within = divmod(step * c.global_batch, self.n_rows)
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, epoch]))
        perm = rng.permutation(self.n_rows)
        lo = within + c.host_id * c.host_batch
        rows = perm[(lo + np.arange(c.host_batch)) % self.n_rows]
        L = c.seq_len + 1
        toks = np.stack([self.tokens[r * L:(r + 1) * L] for r in rows])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def make_dataset(kind: str, data_cfg: DataConfig, model_cfg: ModelConfig,
                 path: Optional[str] = None):
    if kind == "synthetic":
        return SyntheticLM(data_cfg, model_cfg)
    if kind == "file":
        if not path:
            raise ValueError("a file dataset needs a path")
        return PackedFileDataset(path, data_cfg)
    raise KeyError(kind)
