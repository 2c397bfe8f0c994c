"""The port's wave scheduler and plan autotuner against the JAX reference:
the ``SchedulePlan`` chosen in ``uniform`` and ``auto`` mode (strategy,
chunks, per-shard engines, dispatch order, modeled / uniform / seed
cycles) and the modeled wave cycles of the lowered shards equal the
reference's on the tile-count sweep's kernel families and on the
registry kernels; the autotune wins on matmul and conv2d at tiles 4 and
8, and the heterogeneous ``qrelu`` tape's 7 Caesar + 1 Carus wave, which
executes in one launch wave with the reference's queue counters.  Plans
execute on the plain PyTorch backend bit-exact, sync and async."""

import dataclasses

import jax  # noqa: F401  (the reference package runs on JAX)
import numpy as np
import pytest
import torch  # noqa: F401  (both frameworks share the process)

from benchmarks import scaling as ref_families
from repro import nmc as ref_nmc
from repro.core import programs as ref_programs
from repro.core import timing as ref_timing
from repro.nmc import schedule as ref_S
from repro_torch import nmc
from repro_torch.core import alu, programs, timing
from repro_torch.examples import tile_families
from repro_torch.nmc import partition as P
from repro_torch.nmc import schedule as S

_RT = nmc.NmcRuntime(backend="torch")


def _rand(shape, sew, rng):
    info = np.iinfo(alu.NP_DTYPES[sew])
    return rng.integers(info.min, info.max + 1, shape,
                        dtype=alu.NP_DTYPES[sew])


def _pair(name, sew):
    """One tile family from both packages: (ref kfn, args), (kfn, args)."""
    rk, rargs, _ = ref_families.make_kernels(sew, names=(name,))[name]
    k, args, _ = tile_families.make_kernels(sew, names=(name,))[name]
    for a, b in zip(rargs, args):
        assert np.array_equal(a, b)
    return (rk, rargs), (k, args)


def _wave_cycles(timing_mod, lks):
    return timing_mod.wave_cycles([timing_mod.stage_cost(lk) for lk in lks],
                                  len(lks))


def test_modes_and_plan_fields_match_reference():
    assert S.SCHEDULE_MODES == ref_S.SCHEDULE_MODES
    assert [f.name for f in dataclasses.fields(S.SchedulePlan)] == \
        [f.name for f in dataclasses.fields(ref_S.SchedulePlan)]
    assert S._PLAN_CAP == ref_S._PLAN_CAP


@pytest.mark.parametrize("mode", ["uniform", "auto"])
@pytest.mark.parametrize("name", tile_families.FAMILIES)
def test_family_plans_and_wave_cycles_match_reference(name, mode):
    """Every sweep family at tiles 2 / 4 / 8 / 16 and SEW 8: the chosen
    plan and the modeled cycles of the lowered wave equal the
    reference's."""
    (rk, rargs), (k, args) = _pair(name, 8)
    rck, ck = ref_nmc.jit(rk), nmc.jit(k)
    for tiles in (2, 4, 8, 16):
        want = rck.plan_schedule(*rargs, tiles=tiles, schedule=mode)
        got = ck.plan_schedule(*args, tiles=tiles, schedule=mode)
        assert dataclasses.astuple(got) == dataclasses.astuple(want), tiles
        _, rlks = rck.lower_wave(*rargs, tiles=tiles, schedule=mode)
        _, lks = ck.lower_wave(*args, tiles=tiles, schedule=mode)
        assert [lk.engine for lk in lks] == [lk.engine for lk in rlks]
        assert _wave_cycles(timing, lks) == _wave_cycles(ref_timing, rlks)


@pytest.mark.parametrize("name", ["matmul", "conv2d"])
def test_autotune_wins_match_reference(name):
    """The autotuner's modeled wins over the uniform plan on matmul and
    conv2d at tiles 4 and 8 (the reference's tune benchmark gate): the
    same numbers, tuned strictly below uniform."""
    (rk, rargs), (k, args) = _pair(name, 8)
    for tiles in (4, 8):
        want = ref_nmc.jit(rk, tiles=tiles).plan_schedule(*rargs,
                                                          schedule="auto")
        got = nmc.jit(k, tiles=tiles).plan_schedule(*args, schedule="auto")
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.modeled_cycles < got.uniform_cycles <= got.seed_cycles


@pytest.mark.parametrize("name", ["xor", "matmul", "conv2d", "maxpool",
                                  "axpy", "qrelu"])
def test_registry_tapes_autotune_like_reference(monkeypatch, name):
    seen = {"ref": [], "port": []}
    for key, mod in (("ref", ref_programs), ("port", programs)):
        def record(kfn, args, engine, sew, *a, _orig=mod._traced_build,
                   _key=key, **kw):
            seen[_key].append((kfn, args))
            return _orig(kfn, args, engine, sew, *a, **kw)
        monkeypatch.setattr(mod, "_traced_build", record)
    kw = {"matmul": {"p": 8}, "conv2d": {"n": 16, "f": 3},
          "qrelu": {"rows": 4, "row_bytes": 64}}.get(
        name, {"caesar_bytes": 1024, "carus_bytes": 1024})
    ref_programs.build(name, 8, **kw)
    programs.build(name, 8, **kw)
    for (rk, rargs), (k, args) in zip(seen["ref"], seen["port"]):
        rb, b = ref_nmc.jit(rk).trace(*rargs), nmc.jit(k).trace(*args)
        for tiles in (2, 4):
            for mode in ("uniform", "auto"):
                want = ref_S.plan_wave(rb, tiles, mode=mode)[0]
                got = S.plan_wave(b, tiles, mode=mode)[0]
                assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_qrelu_mixed_wave_in_one_launch_like_reference():
    """The heterogeneous qrelu tape autotunes to 7 Caesar + 1 Carus shards
    and runs as one launch wave mixing both engines, bit-exact vs the
    all-Carus uniform plan, with the reference's counters."""
    S.clear_plan_cache()
    ref_S.clear_plan_cache()
    rkfn, rargs = ref_programs.qrelu_case(8)
    kfn, args = programs.qrelu_case(8)
    ref_rt = ref_nmc.NmcRuntime(backend="scan")
    rt = nmc.NmcRuntime(backend="torch")
    rck = ref_nmc.jit(rkfn, tiles=8, partition="rows", runtime=ref_rt)
    ck = nmc.jit(kfn, tiles=8, partition="rows", runtime=rt)

    uni = ck.plan_schedule(*args, schedule="uniform")
    tuned = ck.plan_schedule(*args, schedule="auto")
    assert dataclasses.astuple(tuned) == dataclasses.astuple(
        rck.plan_schedule(*rargs, schedule="auto"))
    assert set(uni.engines) == {"carus"}
    assert tuned.mixed and sorted(tuned.engines).count("caesar") == 7
    assert tuned.engines.count("carus") == 1
    assert tuned.modeled_cycles < uni.modeled_cycles

    ref = ck(*args, schedule="uniform")
    assert np.array_equal(ref, rck(*rargs, schedule="uniform"))
    q = rt.queue
    w0, m0, d0 = q.waves, q.mixed_engine_waves, rt.resident.dispatch_calls
    out = ck(*args, schedule="auto")
    assert np.array_equal(ref, out)
    assert np.array_equal(ref, ck.oracle(*args))
    assert q.waves - w0 == 1
    assert q.mixed_engine_waves - m0 == 1
    assert rt.resident.dispatch_calls - d0 == 1
    assert np.array_equal(ref, ck.call_async(*args, schedule="auto")
                          .result())
    rck(*rargs, schedule="auto")
    rck.call_async(*rargs, schedule="auto").result()
    for attr in ("submitted", "waves", "mixed_engine_waves",
                 "staged_while_busy"):
        assert getattr(q, attr) == getattr(ref_rt.queue, attr), attr
    assert rt.resident.dispatch_calls == ref_rt.resident.dispatch_calls
    pplan, lks = ck.lower_wave(*args, schedule="auto")
    assert not nmc.verify_wave(pplan.parent, pplan, lks).errors


def test_plan_cache_and_user_plans():
    S.clear_plan_cache()
    rng = np.random.default_rng(5)

    def kfn(t, x):
        t.store((t.load(x) * 3 + 1).max(0))

    ck = nmc.jit(kfn, tiles=4, runtime=_RT)
    b1, b2 = ck.trace(_rand(100, 8, rng)), ck.trace(_rand(100, 8, rng))
    p1 = S.plan_wave(b1, 4, mode="auto")[0]
    assert S.plan_wave(b2, 4, mode="auto")[0] is p1
    assert S.plan_wave(b1, 4, mode="uniform")[0] is not p1
    x = _rand(100, 8, rng)
    user = S.SchedulePlan("axis", (10, 30, 25, 35), ("caesar", "carus") * 2,
                          (3, 1, 0, 2), 4, 8, 0.0, 0.0, 0.0, "user")
    assert np.array_equal(ck(x, schedule=user), ck.oracle(x))
    assert np.array_equal(ck.call_async(x, schedule=user).result(),
                          ck.oracle(x))
    with pytest.raises(ValueError, match="schedule"):
        nmc.jit(kfn, schedule="bogus")
    with pytest.raises(ValueError, match="schedule"):
        ck(x, schedule="bogus")
    bad = S.SchedulePlan("axis", (50, 50), ("caesar",), (0,), 2, 8,
                         0.0, 0.0, 0.0, "user")
    with pytest.raises(P.PartitionError, match="expects 1 shards"):
        S.realize(b1, bad)
    for name in ("SCHEDULE_MODES", "SchedulePlan", "autotune",
                 "uniform_plan", "plan_wave", "clear_plan_cache"):
        assert name in nmc.__all__
