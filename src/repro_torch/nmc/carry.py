"""Carry Programs and tile images over from the JAX reference.

For this system the "weights" are Programs and tile images.  Both functions
take plain numpy — the reference's ``Program.entries`` (``PROG_DTYPE``) and
its int32 images — never objects of the reference package, so the port can
run exactly what the reference lowered.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.nmc.engine import CaesarTile, CarusTile
from repro_torch.nmc.program import PROG_DTYPE, Program

_STATE_SHAPE = {"caesar": CaesarTile().state_shape,
                "carus": CarusTile().state_shape}


def program_from_reference(engine: str, sew: int, entries) -> Program:
    """A reference ``Program``'s ``PROG_DTYPE`` entries -> the port's
    :class:`Program` (byte-identical entries)."""
    arr = np.asarray(entries)
    if arr.dtype != PROG_DTYPE:
        raise TypeError(f"expected PROG_DTYPE entries, got {arr.dtype}")
    return Program(engine, int(sew), np.array(arr, dtype=PROG_DTYPE))


def state_from_reference(engine: str, image, device=None) -> torch.Tensor:
    """A reference tile image (Caesar: 8192 words; Carus: the 32 x 256
    VRF, any int32-valued numpy shape of that size) -> an int32 state
    tensor on ``device`` (CPU when ``None``)."""
    words = np.asarray(image)
    if words.dtype != np.int32:
        raise TypeError(f"expected an int32 image, got {words.dtype}")
    return torch.tensor(words, device=device).reshape(_STATE_SHAPE[engine])
