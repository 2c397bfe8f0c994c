"""The dispatch queue's staging: host images reach a tile's shadow buffer
through page-locked memory and a copy stream of the queue's own on the
card, and through ``init_state`` on the CPU; outputs and every counter stay
the reference's.

On the CPU, against the JAX reference (imported inside the fixture, so
that the ``gpu`` cases below run where there is no JAX): the Table V
builds through ``DispatchQueue`` under both schedulers, with the builds and
tile counts of ``tests/test_runtime.py`` (the full sweep on 4 round-robin
tiles, the small builds on 2), give the reference's outputs, queue and pool
counters, and the queue makes no stager.  The ``gpu`` cases need a card (decided inside the ``card``
fixture) and run there with

    python -m pytest -q -m gpu tests/test_torch_staging.py
"""

import numpy as np
import pytest
import torch

from repro_torch import nmc
from repro_torch.core import programs

SMALL = {"caesar_bytes": 2048, "carus_bytes": 4096}
QUEUE_COUNTERS = ("submitted", "launched", "resolved", "waves",
                  "mixed_engine_waves", "staged_while_busy", "calls")
POOL_COUNTERS = ("loads", "stores", "dispatches", "dispatch_calls",
                 "programs_run", "bytes_moved", "patches", "patch_bytes")


def _full_builds(prog_mod, sew: int) -> list:
    kbs = [prog_mod.build(name, sew) for name in prog_mod.ALL_KERNELS]
    return [getattr(kb, e) for kb in kbs for e in ("caesar", "carus")]


def _small_builds(prog_mod, sew: int = 8) -> list:
    kbs = [prog_mod.build(n, sew, **SMALL)
           for n in ("xor", "add", "mul", "relu")]
    return [getattr(kb, e) for kb in kbs for e in ("caesar", "carus")]


def _run(nmc_mod, builds, backend: str, mode: str, n_tiles: int) -> tuple:
    queue = nmc_mod.DispatchQueue(
        pool=nmc_mod.ResidentPool(backend=backend), mode=mode)
    outs = queue.run_builds(builds, n_tiles=n_tiles)
    return queue, outs, {n: getattr(queue, n) for n in QUEUE_COUNTERS}, \
        {n: getattr(queue.pool, n) for n in POOL_COUNTERS}


def _expected(mode: str, n_builds: int, n_tiles: int) -> dict:
    """The counters ``tests/test_runtime.py`` holds both schedulers to."""
    if mode == "inorder":
        return {"staged_while_busy": 0, "waves": n_builds}
    return {"staged_while_busy": n_builds - n_tiles,
            "waves": -(-n_builds // n_tiles)}


# ---------------------------------------------------------------------------
# the CPU: the reference's outputs and counters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    import jax  # noqa: F401  (the reference package runs on JAX)
    from repro import nmc as ref_nmc
    from repro.core import programs as ref_programs
    return ref_nmc, ref_programs


#: the full sweep at SEW 8 (each SEW takes ~25 s of the reference's time
#: here; the card's cases below take all three), the small builds at all
CASES = [("full", 8, 4), ("small", 8, 2), ("small", 16, 2), ("small", 32, 2)]


@pytest.mark.parametrize("mode", ["overlapped", "inorder"])
@pytest.mark.parametrize("kind,sew,n_tiles", CASES)
def test_queue_matches_reference(reference, kind, sew, n_tiles, mode):
    ref_nmc, ref_programs = reference
    make = _full_builds if kind == "full" else _small_builds
    builds = make(programs, sew)
    queue, outs, counters, pool = _run(nmc, builds, "torch", mode, n_tiles)
    _, want, ref_counters, ref_pool = _run(
        ref_nmc, make(ref_programs, sew), "scan", mode, n_tiles)
    assert queue.stager is None                 # the CPU path: init_state
    assert counters == ref_counters and pool == ref_pool
    assert {k: counters[k] for k in ("staged_while_busy", "waves")} == \
        _expected(mode, len(builds), n_tiles)
    assert counters["submitted"] == counters["resolved"] == len(builds)
    for eb, got, ref in zip(builds, outs, want):
        assert np.array_equal(np.asarray(got), np.asarray(ref))
        exp = np.asarray(eb.oracle).reshape(-1)
        assert (np.asarray(got).reshape(-1)[:exp.size] == exp).all()


def test_inorder_waits_before_staging():
    """The inorder scheduler resolves a tile's previous work before it
    stages the next image: nothing is ever staged while a tile is busy,
    and every item is a wave of its own."""
    builds = _small_builds(programs)
    queue, outs, counters, _ = _run(nmc, builds, "torch", "inorder", 2)
    assert counters["staged_while_busy"] == 0
    assert counters["waves"] == len(builds)
    sync = nmc.ResidentPool(backend="torch").run_builds(builds)
    for a, b in zip(outs, sync):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the staging copies run only on "
                    "the card)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["overlapped", "inorder"])
def test_copies_run_on_the_copy_stream_from_pinned_memory(card, mode):
    builds = _full_builds(programs, 8)
    queue, outs, counters, _ = _run(nmc, builds, "cuda", mode, 4)
    torch.cuda.synchronize()
    stager = queue.stager
    assert stager is not None and stager.copies == len(builds)
    assert stager.stream != torch.cuda.current_stream(card)
    assert stager.pinned and all(b.is_pinned() for b in stager.pinned)
    assert {k: counters[k] for k in ("staged_while_busy", "waves")} == \
        _expected(mode, len(builds), 4)


@pytest.mark.gpu
@pytest.mark.parametrize("sew", [8, 16, 32])
def test_staged_outputs_equal_inorder_plain_and_oracle(card, sew):
    builds = _full_builds(programs, sew)
    _, over, c_over, p_over = _run(nmc, builds, "cuda", "overlapped", 4)
    _, inorder, c_in, p_in = _run(nmc, builds, "cuda", "inorder", 4)
    _, plain, c_plain, p_plain = _run(nmc, builds, "torch", "overlapped", 4)
    assert c_over == c_plain and p_over == p_plain
    assert c_in == {**c_over, **_expected("inorder", len(builds), 4),
                    "mixed_engine_waves": 0}
    for eb, a, b, c in zip(builds, over, inorder, plain):
        assert np.array_equal(a, b) and np.array_equal(a, c)
        exp = np.asarray(eb.oracle).reshape(-1)
        assert (np.asarray(a).reshape(-1)[:exp.size] == exp).all()
