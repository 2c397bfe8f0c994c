"""The five Table V kernel families as traced ``nmc.jit`` kernels, sized
for a quick tile-count sweep: elementwise (``mul``), ``relu``, ``matmul``,
``conv2d`` and ``maxpool`` — the families the reference sweeps across tile
counts in ``benchmarks/scaling.py``, with the same shapes and seeds.

:func:`make_kernels` returns ``{name: (kfn, args, host_post)}``;
``host_post`` is the host-side finishing stage (maxpool's horizontal
reduction, Section V-B1), applied identically after single-tile and
gathered multi-tile outputs so it never affects bit-exactness.
:func:`sweep` runs every family at every tile count, sync and async, and
holds each output to the single-tile output and the numpy oracle.
"""

from __future__ import annotations

import numpy as np

from repro_torch import nmc
from repro_torch.core import alu

TILES = (1, 2, 4, 8, 16)
SEWS = (8, 16, 32)
FAMILIES = ("mul", "relu", "matmul", "conv2d", "maxpool")


def make_kernels(sew: int, seed: int = 0, names=FAMILIES) -> dict:
    rng = np.random.default_rng(seed)
    dt = alu.NP_DTYPES[sew]
    info = np.iinfo(dt)

    def rand(shape):
        return rng.integers(info.min, info.max + 1, shape, dtype=dt)

    out: dict = {}
    if "mul" in names:
        def mul(t, x, y):
            t.store(t.load(x, bank=0) * t.load(y))
        out["mul"] = (mul, (rand(1536), rand(1536)), None)
    if "relu" in names:
        def relu(t, x):
            t.store(t.load(x).max(0))
        out["relu"] = (relu, (rand(1536),), None)
    if "matmul" in names:
        def matmul(t, A, B, m=8, k=8):
            a = t.consts(A)
            rows = [t.load(B[r]) for r in range(k)]
            for i in range(m):
                acc = None
                for kk in range(k):
                    acc = nmc.mac(acc, a[i, kk], rows[kk])
                t.store(acc)
        out["matmul"] = (matmul, (rand((8, 8)), rand((8, 256))), None)
    if "conv2d" in names:
        # shape constants bind as defaults: the closures must not read
        # loop-shared names at call time (late binding)
        def conv2d(t, A, F, rows_n=8, nn=128, f=3):
            fw = t.consts(F)
            av = [t.load(A[r]) for r in range(rows_n)]
            sh = {(dj, r): av[r].slide_down(dj)
                  for dj in range(1, f) for r in range(rows_n)}
            for i in range(rows_n - f + 1):
                acc = None
                for di in range(f):
                    for dj in range(f):
                        src = av[i + di] if dj == 0 else sh[(dj, i + di)]
                        acc = nmc.mac(acc, fw[di, dj], src)
                t.store(acc, n=nn - f + 1)
        out["conv2d"] = (conv2d, (rand((8, 128)), rand((3, 3))), None)
    if "maxpool" in names:
        pr, width = 16, 64
        X = rand((pr, width))
        even = np.ascontiguousarray(X[0::2]).reshape(-1)
        odd = np.ascontiguousarray(X[1::2]).reshape(-1)

        def maxpool(t, e, o):           # vertical stage on the tile array
            t.store(t.load(e, bank=0).max(t.load(o)))

        def horiz(v, pr=pr, width=width):   # horizontal stage on the host
            v = np.asarray(v).reshape(pr // 2, width)
            return np.maximum(v[:, 0::2], v[:, 1::2])
        out["maxpool"] = (maxpool, (even, odd), horiz)
    return out


def sweep(rt: nmc.NmcRuntime) -> dict:
    """Every family at every tile count on ``rt``, sync and async: each
    output must equal the single-tile output and the traced numpy oracle
    (raises ``AssertionError`` otherwise).  Returns the runs, the bucket
    keys the waves needed and the executor builds they took
    (``compiles``), which must not exceed the buckets."""
    from repro_torch.nmc.pool import tile_bucket
    compiles0 = rt.bucketed.compiles
    keys: set = set()
    runs = []
    for sew in SEWS:
        for name, (kfn, args, host_post) in make_kernels(sew).items():
            kern = nmc.jit(kfn, sew=sew, runtime=rt)
            post = host_post if host_post is not None else np.asarray
            oracle = np.asarray(post(kern.oracle(*args)))
            for engine in ("caesar", "carus"):
                base = np.asarray(post(kern(*args, engine=engine)))
                assert np.array_equal(base, oracle), (name, sew, engine)
                for n in TILES:
                    pplan, lks = kern.lower_wave(*args, engine=engine,
                                                 tiles=n)
                    progs = [lk.program for lk in lks]
                    assert len({p.bucket_key for p in progs}) == 1, \
                        "wave shards straddle instruction buckets"
                    keys.add((*progs[0].bucket_key, tile_bucket(len(progs))))
                    sync = np.asarray(post(kern(*args, engine=engine,
                                                tiles=n)))
                    fut = kern.call_async(*args, engine=engine, tiles=n)
                    asyn = np.asarray(post(fut.result()))
                    ok = np.array_equal(sync, base) and \
                        np.array_equal(asyn, base)
                    assert ok, (name, sew, engine, n)
                    runs.append((name, sew, engine, n, pplan.n_shards,
                                 pplan.strategy))
    compiles = rt.bucketed.compiles - compiles0
    assert compiles <= len(keys), (compiles, len(keys))
    return {"runs": runs, "buckets": len(keys), "compiles": compiles}
