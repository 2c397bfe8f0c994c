"""The port's pools and async dispatch queue against the JAX reference's:
one fixed submission sequence through ``BucketedPool``, ``ResidentPool``
(load / dispatch / patch / store) and ``DispatchQueue`` (both schedulers,
round-robin tiles, chained programs, patches, a backend override and a
generic device call) must give the reference's outputs, final tile images
and every counter, and async must equal sync."""

import jax  # noqa: F401  (the reference package runs on JAX)
import numpy as np
import pytest
import torch

from repro import nmc as ref_nmc
from repro.core import programs as ref_programs
from repro_torch import nmc
from repro_torch.core import programs

SMALL = {"caesar_bytes": 1024, "carus_bytes": 1024}
POOL_COUNTERS = ("compiles", "dispatches", "programs_run", "pad_waste",
                 "useful_instrs", "bytes_moved")
RESIDENT_COUNTERS = ("loads", "stores", "dispatches", "dispatch_calls",
                     "programs_run", "bytes_moved", "patches", "patch_bytes",
                     "compiles")
QUEUE_COUNTERS = ("submitted", "launched", "resolved", "waves",
                  "mixed_engine_waves", "staged_while_busy", "calls")


def _builds(prog_mod):
    kbs = [prog_mod.build(n, 8, **SMALL) for n in ("xor", "add", "relu")]
    kbs.append(prog_mod.build("matmul", 16, p=8))
    return [getattr(kb, e) for kb in kbs for e in ("caesar", "carus")]


def _counters(obj, names):
    return {n: getattr(obj, n) for n in names}


def _images(pool, tiles):
    return [np.asarray(pool.state(t)).copy() for t in tiles]


def _sequence(nmc_mod, prog_mod, backend: str) -> dict:
    """The fixed submission sequence, run on one implementation."""
    builds = _builds(prog_mod)
    out = {}

    bp = nmc_mod.BucketedPool(backend=backend)
    out["bucketed"] = bp.run_builds(builds)
    out["bucketed_counters"] = _counters(bp, POOL_COUNTERS)

    rp = nmc_mod.ResidentPool(backend=backend)
    tiles = [("t", i) for i in range(len(builds))]
    for t, eb in zip(tiles, builds):
        rp.load(t, eb.program.engine, eb.mem)
    rp.dispatch([(t, eb.program) for t, eb in zip(tiles, builds)])
    words = np.arange(-8, 8, dtype=np.int32) * 77777
    rp.patch(tiles[0], [(0, words), (4096, words[:3])])
    rp.dispatch([(tiles[0], builds[0].program), (tiles[1], builds[1].program)])
    out["resident"] = [rp.store(t, eb.out_slice, eb.program.sew)
                       for t, eb in zip(tiles, builds)]
    out["resident_images"] = _images(rp, tiles)
    out["resident_counters"] = _counters(rp, RESIDENT_COUNTERS)
    out["resident_pool"] = _counters(rp.pool, ("pad_waste", "useful_instrs"))

    for mode in ("overlapped", "inorder"):
        q = nmc_mod.DispatchQueue(pool=nmc_mod.ResidentPool(backend=backend),
                                  mode=mode)
        res = q.run_builds(builds, n_tiles=3)
        lane = ("lane", 0)
        # chained programs on one tile: image, then chain, then patch
        f1 = q.submit(lane, builds[0].program, image=builds[0].mem,
                      out_slice=builds[0].out_slice)
        f2 = q.submit(lane, builds[0].program, out_slice=builds[0].out_slice)
        f3 = q.submit(lane, builds[0].program, patch=[(7, words[:5])],
                      out_slice=builds[0].out_slice, backend=backend)
        call = q.submit_call(lambda x: x * 3, np.arange(4))
        q.drain()
        out[f"queue_{mode}"] = res + [f.result() for f in (f1, f2, f3)]
        out[f"queue_{mode}_call"] = np.asarray(call.result())
        out[f"queue_{mode}_image"] = np.asarray(f3.state()).copy()
        out[f"queue_{mode}_counters"] = _counters(q, QUEUE_COUNTERS)
        out[f"queue_{mode}_pool"] = _counters(q.pool, RESIDENT_COUNTERS)
    return out


@pytest.fixture(scope="module")
def both():
    return (_sequence(ref_nmc, ref_programs, "scan"),
            _sequence(nmc, programs, "torch"))


def _eq(a, b):
    if isinstance(a, dict):
        assert a == b
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y))
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("part", [
    "bucketed", "bucketed_counters", "resident", "resident_images",
    "resident_counters", "resident_pool",
    "queue_overlapped", "queue_overlapped_call", "queue_overlapped_image",
    "queue_overlapped_counters", "queue_overlapped_pool",
    "queue_inorder", "queue_inorder_call", "queue_inorder_image",
    "queue_inorder_counters", "queue_inorder_pool"])
def test_sequence_matches_reference(both, part):
    ref, mine = both
    _eq(mine[part], ref[part])


def test_async_equals_sync_and_oracles(both):
    _, mine = both
    n = len(mine["bucketed"])
    for mode in ("overlapped", "inorder"):
        _eq(mine[f"queue_{mode}"][:n], mine["bucketed"])
    for eb, got in zip(_builds(programs), mine["bucketed"]):
        exp = np.asarray(eb.oracle).reshape(-1)
        assert (got.reshape(-1)[:exp.size] == exp).all()


def test_patch_leaves_launched_results_alone():
    """Resident state lives in int32 tensors; a patch makes a new buffer,
    so a future already launched keeps its own final state."""
    eb = _builds(programs)[0]
    q = nmc.DispatchQueue(pool=nmc.ResidentPool(backend="torch"))
    f1 = q.submit("t", eb.program, image=eb.mem)
    before = f1.state().clone()
    assert isinstance(before, torch.Tensor) and before.dtype == torch.int32
    f2 = q.submit("t", eb.program, patch=[(0, np.full(16, 5, np.int32))])
    f2.state()
    assert torch.equal(f1.state(), before)


def test_caesar_wave_with_out_of_image_address_is_rejected():
    from repro_torch.core.isa import CaesarOp
    bad = nmc.Program.from_entries(
        "caesar", 8, [nmc.caesar_entry(CaesarOp.ADD, 8192, 0, 1)])
    with pytest.raises(ValueError, match="outside"):
        nmc.BucketedPool(backend="torch").run(
            [bad], [np.zeros(8192, np.int32)])
