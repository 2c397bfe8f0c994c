"""Config registry: ``--arch <id>`` resolution + assigned input shapes.

The counterpart of the JAX package's ``configs/base.py``.  The port has the
dense family so far: ``qwen1.5-0.5b`` and ``h2o-danube-1.8b`` register a
full config (exact dims) and a ``smoke`` reduction for CPU tests; the other
architecture ids raise ``NotImplementedError`` until their family lands
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

from repro_torch.models.config import ModelConfig

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}

ARCH_IDS = (
    "zamba2-2.7b", "h2o-danube-1.8b", "qwen1.5-0.5b", "mistral-nemo-12b",
    "phi3-medium-14b", "xlstm-125m", "whisper-tiny", "moonshot-v1-16b-a3b",
    "deepseek-v2-lite-16b", "pixtral-12b",
)
PORTED = ("h2o-danube-1.8b", "qwen1.5-0.5b")

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in PORTED}


def register(name: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def get(name: str, smoke: bool = False) -> ModelConfig:
    if name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}: one of {ARCH_IDS}")
    if name not in PORTED:
        raise NotImplementedError(
            f"{name} is not ported to PyTorch yet: the port has the dense "
            f"family ({', '.join(PORTED)}); see ROADMAP.md, queue 1")
    if name not in _REGISTRY:
        importlib.import_module(_MODULES[name])
    return (_SMOKE if smoke else _REGISTRY)[name]()


# ---------------------------------------------------------------------------
# Assigned input shapes (identical across LM archs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """long_500k only for sub-quadratic archs."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names
