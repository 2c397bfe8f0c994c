"""The paper's core: NMC functional engines, ISA, timing & energy models.

Engine programs are represented in the unified IR of :mod:`repro_torch.nmc`;
the builders in :mod:`repro_torch.core.programs` emit it and the timing /
energy models cost it through one code path.  (The eCPU interpreter,
``ECpu``, is not ported yet.)
"""

from repro_torch.core import alu, constants, isa
from repro_torch.core.caesar import CaesarConfig, CaesarEngine, stream_to_arrays
from repro_torch.core.carus import (CarusConfig, CarusVPU, trace_entry,
                                    trace_to_arrays)

__all__ = [
    "alu", "constants", "isa",
    "CaesarConfig", "CaesarEngine", "stream_to_arrays",
    "CarusConfig", "CarusVPU", "trace_entry", "trace_to_arrays",
]
