"""The port stands alone and never falls back to the CPU on its own:
``repro_torch`` imports neither ``jax`` nor the reference package, the
default backend is the card and raises without one, and the ``cuda``
engines refuse CPU tensors."""

import ast
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (imported by every port test file; unused here)
import numpy as np
import pytest
import torch

from repro_torch import nmc
from repro_torch.core import programs
from repro_torch.nmc import engine

SRC = pathlib.Path(engine.__file__).resolve().parents[1]
REPO = SRC.parents[1]


def test_import_without_jax_or_reference():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch, repro_torch.nmc, repro_torch.core, "
            "repro_torch.core.programs, repro_torch.nmc.cuda_engine, "
            "repro_torch.nmc.carry, repro_torch.nmc.conformance, "
            "repro_torch.cuda_build; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules if sys.modules[m] is not None); "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC.parent)})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _imported_modules(path: pathlib.Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", sorted(SRC.rglob("*.py")) +
                         [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_imports_jax_or_reference(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, mod)


def test_auto_backend_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: engine.resolve_backend("auto"),
                 lambda: engine.get_engine("caesar"),
                 lambda: nmc.BucketedPool(),
                 lambda: nmc.ResidentPool(),
                 lambda: nmc.NmcRuntime(),
                 lambda: programs.run_build(programs.build(
                     "xor", 8, caesar_bytes=64, carus_bytes=64).caesar)):
        with pytest.raises(RuntimeError, match="backend='torch'"):
            call()
    assert engine.resolve_backend("torch") == "torch"
    assert engine.resolve_backend("cuda") == "cuda"
    with pytest.raises(ValueError):
        engine.resolve_backend("scan")


@pytest.mark.parametrize("name", ["caesar", "carus"])
def test_cuda_engine_refuses_cpu_tensors(name):
    eng = engine.get_engine(name, "cuda")
    state = engine.get_engine(name, "torch").init_state(
        np.zeros(8192, np.int32))
    with pytest.raises(ValueError, match="backend='torch'"):
        eng.init_state(state)
    prog = nmc.Program.from_entries(name, 8, [nmc.nop_entry(name)])
    with pytest.raises(ValueError, match="CUDA tensors"):
        eng.run(state, prog)
    with pytest.raises(ValueError, match="CUDA tensors"):
        eng.batched_fn(8, 1)(state[None], {k: torch.as_tensor(v)[None]
                                           for k, v in
                                           prog.lower_np().items()})
