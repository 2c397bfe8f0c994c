"""The whole slice, end to end: a reduced Table V sweep (all nine kernels,
both engines) through the port's ``BucketedPool`` on the plain PyTorch
backend gives final tile images equal to the JAX reference's
``BucketedPool`` (``backend="scan"``), every oracle holds, and both pools
build the same number of executors."""

import jax  # noqa: F401  (the reference package runs on JAX)
import numpy as np
import pytest
import torch  # noqa: F401  (both frameworks share the process)

from repro.core import programs as ref_programs
from repro.nmc import BucketedPool as RefBucketedPool
from repro_torch import nmc
from repro_torch.core import programs

SMALL = {"caesar_bytes": 1024, "carus_bytes": 1024}
REDUCED = {"matmul": {"p": 8}, "gemm": {"p": 8}, "conv2d": {"n": 16, "f": 3},
           "maxpool": {**SMALL, "width": 32}}


def _kbs(prog_mod, sew):
    return [prog_mod.build(n, sew, **REDUCED.get(n, SMALL))
            for n in prog_mod.TABLE_V_KERNELS]


@pytest.mark.parametrize("sew", [8, 16, 32])
def test_reduced_table_v_sweep_equals_reference(sew):
    kbs, ref_kbs = _kbs(programs, sew), _kbs(ref_programs, sew)
    builds = [getattr(kb, e) for kb in kbs for e in ("caesar", "carus")]
    ref_builds = [getattr(kb, e) for kb in ref_kbs
                  for e in ("caesar", "carus")]

    pool = nmc.BucketedPool(backend="torch")
    ref_pool = RefBucketedPool(backend="scan")
    finals = pool.run([eb.program for eb in builds],
                      [eb.mem for eb in builds])
    ref_finals = ref_pool.run([eb.program for eb in ref_builds],
                              [eb.mem for eb in ref_builds])
    for eb, got, want in zip(builds, finals, ref_finals):
        assert np.array_equal(got, np.asarray(want)), \
            (eb.engine, eb.program.n_instr)
    assert (pool.compiles, pool.dispatches, pool.pad_waste,
            pool.bytes_moved) == (ref_pool.compiles, ref_pool.dispatches,
                                  ref_pool.pad_waste, ref_pool.bytes_moved)

    res = programs.verify_sweep(kbs, nmc.BucketedPool(backend="torch"))
    assert res == {(kb.name, sew): {"caesar": True, "carus": True}
                   for kb in kbs}
