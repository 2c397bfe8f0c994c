"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is a plain-C shared library (no PyTorch headers),
compiled with ``nvcc`` for Hopper (``sm_90a``) and bound with :mod:`ctypes`.
The build happens at first use, from the sources in the checkout, into
``csrc/build/<stem>-<hash>/`` (listed in ``.gitignore``), keyed by a hash of
the source and the flags: an unchanged source is never rebuilt.  All
sources compile in parallel, one ``nvcc`` each, started together.

Nothing here runs at import time; a machine without ``nvcc`` fails at the
first kernel launch with an error naming the compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[str, object] = {}
#: per source stem: {"seconds": build wall time (0.0 when cached),
#: "ptxas": the compiler's register / shared-memory report}
BUILD_LOG: dict[str, dict] = {}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "repro_torch/csrc at first use and need the CUDA "
                       "toolkit")


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}" / f"lib{src.stem}.so"


def build_all() -> dict[str, pathlib.Path]:
    """Compile every stale source in parallel; return ``{stem: .so path}``.
    A build writes to a temporary name and renames it into place, so
    concurrent builders never load a half-written library."""
    targets = {src.stem: (src, _target(src)) for src in sources()}
    procs = {}
    t0 = time.perf_counter()
    for stem, (src, out) in targets.items():
        if out.exists():
            BUILD_LOG.setdefault(stem, {"seconds": 0.0, "ptxas": "(cached)"})
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[stem] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return {stem: out for stem, (_, out) in targets.items()}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built, with every
    other stale source, on first use)."""
    lib = _LIBS.get(stem)
    if lib is None:
        paths = build_all()
        if stem not in paths:
            raise KeyError(f"no CUDA source csrc/{stem}.cu")
        for name, path in paths.items():
            if name not in _LIBS:
                _LIBS[name] = ctypes.CDLL(str(path))
        lib = _LIBS[stem]
    return lib


def entry(stem: str, argtypes: list):
    """The C function ``stem`` of ``csrc/<stem>.cu``, with its argument
    types declared (``ctypes.c_void_p`` for every pointer and the stream)
    and an ``int`` CUDA error code as its result."""
    fn = _ENTRIES.get(stem)
    if fn is None:
        fn = getattr(load(stem), stem)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[stem] = fn
    return fn


def check_launch(kernel: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")
