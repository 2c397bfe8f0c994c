"""The port's host compiler stack against the JAX reference: every registry
kernel (``ALL_KERNELS`` + ``HETERO_KERNELS``) builds byte-identical lowered
Programs (entries, image, ``out_slice``, oracle) at reduced sizes, and the
traced ``nmc.jit`` frontend lowers and runs bit-exact, sync and async, on
the plain PyTorch backend.  Partitioned calls (``tiles > 1``) shard
across tiles like the reference's (details in
``tests/test_torch_partition.py``)."""

import dataclasses

import jax  # noqa: F401  (the reference package runs on JAX)
import numpy as np
import pytest
import torch  # noqa: F401  (both frameworks share the process)

from repro import nmc as ref_nmc
from repro.core import programs as ref_programs
from repro_torch import nmc
from repro_torch.core import programs

SEWS = (8, 16, 32)
SMALL = {"caesar_bytes": 1024, "carus_bytes": 1024}
REDUCED = {"matmul": {"p": 8}, "gemm": {"p": 8}, "conv2d": {"n": 16, "f": 3},
           "maxpool": {**SMALL, "width": 32},
           "qrelu": {"rows": 4, "row_bytes": 64}}
KERNELS = programs.ALL_KERNELS + programs.HETERO_KERNELS


def _builds(name, sew):
    kw = REDUCED.get(name, SMALL)
    return ref_programs.build(name, sew, **kw), programs.build(name, sew, **kw)


def test_kernel_registries_match():
    assert programs.TABLE_V_KERNELS == ref_programs.TABLE_V_KERNELS
    assert programs.ALL_KERNELS == ref_programs.ALL_KERNELS
    assert programs.HETERO_KERNELS == ref_programs.HETERO_KERNELS


@pytest.mark.parametrize("sew", SEWS)
@pytest.mark.parametrize("name", KERNELS)
def test_lowered_programs_byte_identical(name, sew):
    ref_kb, kb = _builds(name, sew)
    assert (kb.name, kb.sew, kb.n_outputs) == \
        (ref_kb.name, ref_kb.sew, ref_kb.n_outputs)
    for engine in ("caesar", "carus"):
        ref_eb, eb = getattr(ref_kb, engine), getattr(kb, engine)
        if ref_eb is None:
            assert eb is None
            continue
        p, rp = eb.program, ref_eb.program
        assert (p.engine, p.sew) == (rp.engine, rp.sew)
        assert p.entries.tobytes() == rp.entries.tobytes(), (name, engine)
        assert np.asarray(eb.mem).tobytes() == np.asarray(ref_eb.mem).tobytes()
        assert eb.out_slice == ref_eb.out_slice
        assert np.array_equal(np.asarray(eb.oracle), np.asarray(ref_eb.oracle))
        assert (eb.host_cycles, eb.ecpu_instrs, eb.n_outputs) == \
            (ref_eb.host_cycles, ref_eb.ecpu_instrs, ref_eb.n_outputs)
        if ref_eb.post is not None:
            x = np.arange(2 * eb.n_outputs + 64, dtype=np.int64) % 97 - 48
            x = x.astype(np.asarray(ref_eb.oracle).dtype)
            assert np.array_equal(eb.post(x), ref_eb.post(x))


def _fused_pair(sew, ref_runtime, runtime, **kw):
    def body(t, x, y):
        a, b = t.load(x, bank=0), t.load(y)
        s = (a * 3 + b).max(0)             # scalar mul, add, relu
        d = (a - b).min(s)                 # sub, vector min
        t.store(d >> 1)

    return (ref_nmc.jit(body, sew=sew, runtime=ref_runtime, **kw),
            nmc.jit(body, sew=sew, runtime=runtime, **kw))


@pytest.mark.parametrize("sew", SEWS)
def test_jit_lowering_and_optimizer_match_reference(sew):
    """Trace -> select -> lower -> O1 optimize -> verify: identical
    LoweredKernels on both engines."""
    rng = np.random.default_rng(sew)
    info = np.iinfo(programs.DTYPES[sew])
    x = rng.integers(info.min, info.max + 1, 96, dtype=programs.DTYPES[sew])
    y = rng.integers(info.min, info.max + 1, 96, dtype=programs.DTYPES[sew])
    ref_k, k = _fused_pair(sew, None, None)
    assert k.select_engine(x, y) == ref_k.select_engine(x, y)
    for engine in ("caesar", "carus"):
        lk, rlk = k.lower(x, y, engine=engine), ref_k.lower(x, y,
                                                          engine=engine)
        assert lk.program.entries.tobytes() == rlk.program.entries.tobytes()
        assert np.asarray(lk.mem).tobytes() == np.asarray(rlk.mem).tobytes()
        assert lk.out_slice == rlk.out_slice
    assert np.array_equal(k.oracle(x, y), ref_k.oracle(x, y))


@pytest.mark.parametrize("sew", SEWS)
def test_jit_sync_async_match_reference_runtime(sew):
    rng = np.random.default_rng(100 + sew)
    info = np.iinfo(programs.DTYPES[sew])
    x = rng.integers(info.min, info.max + 1, 64, dtype=programs.DTYPES[sew])
    y = rng.integers(info.min, info.max + 1, 64, dtype=programs.DTYPES[sew])
    ref_rt = ref_nmc.NmcRuntime(backend="scan")
    rt = nmc.NmcRuntime(backend="torch")
    ref_k, k = _fused_pair(sew, ref_rt, rt)
    for engine in ("caesar", "carus"):
        want = ref_k(x, y, engine=engine)
        assert np.array_equal(ref_k.call_async(x, y, engine=engine).result(),
                              want)
        sync = k(x, y, engine=engine)
        fut = k.call_async(x, y, engine=engine)
        assert isinstance(fut, nmc.NMCFuture)
        assert np.array_equal(sync, want), engine
        assert np.array_equal(fut.result(), want), engine
    assert (rt.queue.submitted, rt.queue.waves, rt.bucketed.compiles) == \
        (ref_rt.queue.submitted, ref_rt.queue.waves,
         ref_rt.bucketed.compiles)


def test_partitioned_calls_match_reference():
    """Partitioned calls (``tiles > 1``) work: the planner, the scheduler
    and the wave lowering match the reference, and sync / async calls are
    bit-exact vs the single-tile path."""
    ref_rt = ref_nmc.NmcRuntime(backend="scan")
    rt = nmc.NmcRuntime(backend="torch")

    def body(t, x):
        t.store(t.load(x) + 1)

    ref_k = ref_nmc.jit(body, runtime=ref_rt, tiles=2)
    k = nmc.jit(body, runtime=rt, tiles=2)
    x = np.arange(64, dtype=np.int8)
    want = (x + 1).astype(np.int8)
    assert np.array_equal(k(x), want)
    assert np.array_equal(k.call_async(x, tiles=4).result(), want)
    assert k.plan_partition(x).signature == ref_k.plan_partition(x).signature
    assert dataclasses.astuple(k.plan_schedule(x)) == \
        dataclasses.astuple(ref_k.plan_schedule(x))
    plan, lks = k.lower_wave(x)
    ref_plan, ref_lks = ref_k.lower_wave(x)
    assert plan.n_shards == ref_plan.n_shards == 2
    assert [lk.program.entries.tobytes() for lk in lks] == \
        [lk.program.entries.tobytes() for lk in ref_lks]
    assert np.array_equal(k(x, tiles=1), want)


def test_jit_kwargs_validate_eagerly():
    def body(t, x):
        t.store(t.load(x))

    for bad in ({"engine": "ceasar"}, {"sew": 12}, {"backend": "scan"},
                {"backend": "pallas"}, {"check": "strict"}, {"opt": "O3"},
                {"schedule": "fastest"}, {"tiles": 0}):
        with pytest.raises(ValueError):
            nmc.jit(body, **bad)
    for ok in ({"backend": "torch"}, {"backend": "cuda"},
               {"schedule": "auto"}):
        assert isinstance(nmc.jit(body, **ok), nmc.CompiledKernel)


def test_check_reports_match_reference():
    """The static verifier (a verbatim copy) flags the same diagnostics."""
    from repro.nmc import check as ref_check
    from repro_torch.nmc import check
    from repro_torch.nmc import conformance
    rng = np.random.default_rng(3)
    for engine, sew in (("caesar", 8), ("carus", 16)):
        progs, _ = conformance.random_wave(engine, sew, 2, 200, 3)
        for p in progs:
            entries = p.entries.copy()
            entries["op"][::17] = rng.integers(0, 19, entries[::17].size)
            mine = check.verify_program(nmc.Program(engine, sew, entries))
            ref = ref_check.verify_program(
                ref_nmc.Program(engine, sew, entries.copy()))
            assert [dataclasses.astuple(d) for d in mine.diagnostics] == \
                [dataclasses.astuple(d) for d in ref.diagnostics]


def test_check_cli_sweep_report_matches_reference(tmp_path, capsys):
    """``python -m repro_torch.nmc.check --all`` over every registry kernel
    x engine x SEW at paper shapes, and its partitioned-wave section,
    writes the reference's report."""
    from repro.nmc import check as ref_check
    from repro_torch.nmc import check
    mine, ref = tmp_path / "mine.json", tmp_path / "ref.json"
    assert check.main(["--all", "--report", str(mine)]) == 0
    assert ref_check.main(["--all", "--report", str(ref)]) == 0
    capsys.readouterr()
    assert mine.read_text() == ref.read_text()
