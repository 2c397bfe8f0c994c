"""Architecture configs (one module per ported arch) + shape registry."""

from repro_torch.configs.base import ARCH_IDS, SHAPES, applicable_shapes, get

__all__ = ["ARCH_IDS", "SHAPES", "applicable_shapes", "get"]
