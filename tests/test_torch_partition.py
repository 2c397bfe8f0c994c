"""The port's tile-parallel partitioning planner against the JAX reference:
on every registry kernel (``ALL_KERNELS`` + ``HETERO_KERNELS``, traced as
the registry builds trace them) x engine x SEW x tiles {2, 4}, the
``PartitionPlan`` of every strategy (its chunks and signature, or the
``PartitionError`` it raises) and the lowered shard wave (program entries,
images, ``out_slice``, scalar-pool spans, oracles) are byte-identical to
the reference's.  Partitioned calls execute on the plain PyTorch backend,
sync and async, bit-exact vs the single-tile path, with the reference's
queue and executor-cache counters."""

import jax  # noqa: F401  (the reference package runs on JAX)
import numpy as np
import pytest
import torch  # noqa: F401  (both frameworks share the process)

from repro import nmc as ref_nmc
from repro.core import programs as ref_programs
from repro.nmc import partition as ref_P
from repro_torch import nmc
from repro_torch.core import alu, programs
from repro_torch.nmc import partition as P

SEWS = (8, 16, 32)
SMALL = {"caesar_bytes": 1024, "carus_bytes": 1024}
REDUCED = {"matmul": {"p": 8}, "gemm": {"p": 8}, "conv2d": {"n": 16, "f": 3},
           "maxpool": {**SMALL, "width": 32},
           "qrelu": {"rows": 4, "row_bytes": 64}}
KERNELS = programs.ALL_KERNELS + programs.HETERO_KERNELS


def _rand(shape, sew, rng):
    info = np.iinfo(alu.NP_DTYPES[sew])
    return rng.integers(info.min, info.max + 1, shape,
                        dtype=alu.NP_DTYPES[sew])


def _registry_tapes(monkeypatch, name, sew):
    """The ``(kfn, args, engine)`` triples a registry build traces, from
    both packages, in build order."""
    seen = {"ref": [], "port": []}
    for key, mod in (("ref", ref_programs), ("port", programs)):
        def record(kfn, args, engine, sew, *a, _orig=mod._traced_build,
                   _key=key, **kw):
            seen[_key].append((kfn, args, engine))
            return _orig(kfn, args, engine, sew, *a, **kw)
        monkeypatch.setattr(mod, "_traced_build", record)
    kw = REDUCED.get(name, SMALL)
    ref_programs.build(name, sew, **kw)
    programs.build(name, sew, **kw)
    assert len(seen["ref"]) == len(seen["port"]) > 0
    return list(zip(seen["ref"], seen["port"]))


def _plan_or_error(mod, builder, tiles, strategy):
    try:
        return mod.plan(builder, tiles, strategy)
    except mod.PartitionError as exc:
        return str(exc)


def _same_wave(ref_wave, wave):
    (rplan, rlks), (plan, lks) = ref_wave, wave
    assert plan.signature == rplan.signature
    assert plan.requested_tiles == rplan.requested_tiles
    assert len(lks) == len(rlks)
    for lk, rlk in zip(lks, rlks):
        assert (lk.engine, lk.sew) == (rlk.engine, rlk.sew)
        assert lk.program.entries.tobytes() == rlk.program.entries.tobytes()
        assert np.asarray(lk.mem).tobytes() == np.asarray(rlk.mem).tobytes()
        assert lk.out_slice == rlk.out_slice
        assert lk.cpool_spans == rlk.cpool_spans
        assert np.array_equal(np.asarray(lk.oracle), np.asarray(rlk.oracle))


@pytest.mark.parametrize("sew", SEWS)
@pytest.mark.parametrize("name", KERNELS)
def test_registry_plans_and_shard_waves_byte_identical(monkeypatch, name,
                                                       sew):
    for (rk, rargs, engine), (k, args, _) in _registry_tapes(monkeypatch,
                                                             name, sew):
        rck = ref_nmc.jit(rk, engine=engine, sew=sew)
        ck = nmc.jit(k, engine=engine, sew=sew)
        rb, b = rck.trace(*rargs), ck.trace(*args)
        for tiles in (2, 4):
            for strategy in P.PARTITIONS:
                want = _plan_or_error(ref_P, rb, tiles, strategy)
                got = _plan_or_error(P, b, tiles, strategy)
                if isinstance(want, str):
                    assert got == want, (name, engine, tiles, strategy)
                    continue
                assert got.signature == want.signature
                assert np.array_equal(got.oracle(), want.oracle())
                assert np.array_equal(got.oracle(), b.oracle())
            _same_wave(rck.lower_wave(*rargs, tiles=tiles),
                       ck.lower_wave(*args, tiles=tiles))


@pytest.mark.parametrize("seed", range(8))
def test_axis_chunks_and_halos_match_reference(seed):
    rng = np.random.default_rng(seed)
    sew = SEWS[seed % 3]
    n = int(rng.integers(8, 400))
    amount = int(rng.integers(0, 4))
    tiles = int(rng.integers(1, 9))
    x = _rand(n, sew, rng)

    def kfn(t, x):
        v = t.load(x)
        if amount:
            t.store(v + v.slide_down(amount), n=v.ne - amount)
        else:
            t.store(v * 3 + 1)

    rb = ref_nmc.jit(kfn, sew=sew).trace(x)
    b = nmc.jit(kfn, sew=sew).trace(x)
    want, got = ref_P.plan(rb, tiles, "axis"), P.plan(b, tiles, "axis")
    assert got.signature == want.signature
    assert [pb.oracle().tobytes() for pb in got.builders] == \
        [pb.oracle().tobytes() for pb in want.builders]
    assert P.slide_halo(b) == ref_P.slide_halo(rb)
    total = n - amount                     # the stored element axis
    if total >= tiles:
        chunks = tuple(int(c) for c in rng.multinomial(
            total - tiles, [1 / tiles] * tiles) + 1)
        want = ref_P.plan(rb, tiles, "axis", chunks=chunks)
        got = P.plan(b, tiles, "axis", chunks=chunks)
        assert got.signature == want.signature
        assert np.array_equal(got.oracle(), b.oracle())


def test_partition_errors_match_reference():
    rng = np.random.default_rng(1)
    x, y = _rand(16, 8, rng), _rand(32, 8, rng)

    def two_axes(t, x, y):                 # dead load of a different length
        t.load(y)
        t.store(t.load(x) + 1)

    rb = ref_nmc.jit(two_axes).trace(x, y)
    b = nmc.jit(two_axes).trace(x, y)
    for strategy in ("axis", "rows", "auto"):
        with pytest.raises(P.PartitionError) as got:
            P.plan(b, 4, partition=strategy)
        with pytest.raises(ref_P.PartitionError) as want:
            ref_P.plan(rb, 4, partition=strategy)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="tiles"):
        P.plan(b, 0)
    with pytest.raises(ValueError, match="partition"):
        P.plan(b, 2, partition="diagonal")


@pytest.mark.parametrize("engine", ["caesar", "carus"])
def test_partitioned_calls_bit_exact_with_reference_counters(engine):
    rng = np.random.default_rng(2)
    x, y = _rand(96, 8, rng), _rand(96, 8, rng)
    A, B = _rand((8, 4), 8, rng), _rand((4, 48), 8, rng)

    def ew(t, x, y):
        t.store((t.load(x, bank=0) ^ t.load(y)).max(1))

    def matmul(mac):
        def mm(t, A, B):
            a = t.consts(A)
            rows = [t.load(B[r]) for r in range(4)]
            for i in range(8):
                acc = None
                for kk in range(4):
                    acc = mac(acc, a[i, kk], rows[kk])
                t.store(acc)
        return mm

    ref_rt = ref_nmc.NmcRuntime(backend="scan")
    rt = nmc.NmcRuntime(backend="torch")
    for ref_fn, fn, args in ((ew, ew, (x, y)),
                             (matmul(ref_nmc.mac), matmul(nmc.mac), (A, B))):
        rk = ref_nmc.jit(ref_fn, runtime=ref_rt)
        k = nmc.jit(fn, runtime=rt)
        base = np.asarray(k(*args, engine=engine))
        assert np.array_equal(base, rk(*args, engine=engine))
        for tiles in (2, 4):
            want = np.asarray(rk(*args, engine=engine, tiles=tiles))
            sync = np.asarray(k(*args, engine=engine, tiles=tiles))
            fut = k.call_async(*args, engine=engine, tiles=tiles)
            rk.call_async(*args, engine=engine, tiles=tiles).result()
            assert isinstance(fut, nmc.GatherFuture)
            assert len(fut.futures) == tiles
            asyn = np.asarray(fut.result())
            assert np.array_equal(sync, base) and np.array_equal(asyn, base)
            assert np.array_equal(want, base)
    for attr in ("submitted", "waves", "launched", "resolved"):
        assert getattr(rt.queue, attr) == getattr(ref_rt.queue, attr), attr
    for attr in ("compiles", "dispatches", "pad_waste", "bytes_moved"):
        assert getattr(rt.bucketed, attr) == getattr(ref_rt.bucketed, attr)
    assert len(rt.resident.tiles) == len(ref_rt.resident.tiles) == 4


def test_partition_plan_public_surface():
    assert nmc.plan_partition is P.plan
    for name in ("PartitionPlan", "PartitionError", "GatherFuture",
                 "plan_partition", "slide_halo", "verify_plan",
                 "verify_wave"):
        assert name in nmc.__all__
    assert P.PARTITIONS == ref_P.PARTITIONS
