"""The port's resident W8A8 decoder block and tile-sharded projections
against the JAX reference, on the reference tests' tiny qwen config with
the same quantized params (carried across by ``params_from_jax``):
``ResidentBlock`` steps, ``nmc_project(tiles=2)`` and the exact int32
GEMM agree bit for bit three ways and with the reference's outputs; the
weights cross the bus once and later steps patch only activation words,
with the reference's ``ResidentPool`` counters and modeled step cycles.
The tiles run the plain PyTorch engines."""

import jax
import jax.numpy as jnp  # noqa: F401
import numpy as np
import pytest
import torch  # noqa: F401  (both frameworks share the process)

from repro import nmc as ref_nmc
from repro.configs import base as jcb
from repro.models import lm as jlm
from repro.serve import block as ref_block
from repro.serve import engine as jserve
from repro_torch import nmc
from repro_torch.configs import base as cb
from repro_torch.models.convert import params_from_jax
from repro_torch.nmc import frontend
from repro_torch.serve import block
from repro_torch.serve.engine import ServeEngine

TINY = dict(d_model=16, n_heads=2, n_kv_heads=2, d_ff=32, nmc_mode="w8a8")
POOL_COUNTERS = ("loads", "patches", "patch_bytes", "bytes_moved",
                 "dispatches", "dispatch_calls")


def _queues():
    ref_q = ref_nmc.DispatchQueue(pool=ref_nmc.ResidentPool(
        pool=ref_nmc.NmcRuntime(backend="scan").bucketed))
    q = nmc.DispatchQueue(pool=nmc.ResidentPool(
        pool=nmc.NmcRuntime(backend="torch").bucketed))
    return ref_q, q


def _engines(n_slots=4, tiles=2):
    jcfg = jcb.get("qwen1.5-0.5b", smoke=True).scaled(**TINY)
    tcfg = cb.get("qwen1.5-0.5b", smoke=True).scaled(**TINY)
    jp = jserve.quantize_params(jlm.init_params(jax.random.PRNGKey(0), jcfg),
                                jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    ref_q, q = _queues()
    return (jserve.ServeEngine(jcfg, jp, n_slots=n_slots, max_len=32,
                               nmc_queue=ref_q, nmc_tiles=tiles),
            ServeEngine(tcfg, tp, n_slots=n_slots, max_len=32, nmc_queue=q,
                        nmc_tiles=tiles, device="cpu"))


def _counters(pool):
    return {k: getattr(pool, k) for k in POOL_COUNTERS}


def test_host_numerics_match_reference():
    rng = np.random.default_rng(0)
    for sew in (8, 16, 32):
        vals = rng.integers(-(1 << (sew - 1)), 1 << (sew - 1), 64,
                            dtype=np.int64).astype(np.int32)
        got = block.splat_words(vals, sew)
        assert np.array_equal(got, ref_block.splat_words(vals, sew))
        assert np.array_equal(got, [frontend.splat_word(int(v), sew)
                                    for v in vals])
    x = rng.normal(size=(5, 24)).astype(np.float32) * 3.0
    for fn in ("quantize_rows", "quantize_cols"):
        for g, w in zip(getattr(block, fn)(x), getattr(ref_block, fn)(x)):
            assert g.tobytes() == w.tobytes()


def test_resident_projection_matches_reference():
    ref_q, q = _queues()
    rng = np.random.default_rng(2)
    w8 = rng.integers(-128, 128, (8, 12), dtype=np.int8)
    want = ref_block.ResidentProjection("p", w8, ref_q, rows=3, tiles=2)
    got = block.ResidentProjection("p", w8, q, rows=3, tiles=2)
    assert got.static and want.static
    assert (got.n_shards, got.patch_bytes_per_call) == \
        (want.n_shards, want.patch_bytes_per_call)
    assert got.plan.signature == want.plan.signature
    for it in range(3):
        x8 = rng.integers(-128, 128, (3, 8), dtype=np.int8)
        y = got(x8)
        assert np.array_equal(y, want(x8))
        assert np.array_equal(y, x8.astype(np.int64) @ w8.astype(np.int64))
        assert _counters(q.pool) == _counters(ref_q.pool), it
    assert q.pool.loads == got.n_shards                  # weights DMA once
    assert q.pool.patch_bytes == 3 * got.patch_bytes_per_call
    assert [s.dma_in_cycles for s in got.stage_costs()] == \
        [s.dma_in_cycles for s in want.stage_costs()]
    with pytest.raises(nmc.LoweringError):
        block.ResidentProjection("p", w8, q, rows=2, tiles=1,
                                 engine="carus")


def test_resident_block_three_way_bit_exact_like_reference():
    jeng, eng = _engines()
    jblk = jeng.resident_block(layer=0, tiles=2)
    blk = eng.resident_block(layer=0, tiles=2)
    assert blk.static and blk.n_shards == jblk.n_shards == 14
    assert not blk.wave_report.errors
    assert blk.step_cycles(True) == jblk.step_cycles(True)
    assert blk.step_cycles(False) == jblk.step_cycles(False)
    assert blk.patch_bytes_per_call == jblk.patch_bytes_per_call
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, eng.cfg.d_model)).astype(np.float32)
    xs = {k: x.copy() for k in ("ref", "ref_prj", "res", "prj", "mm")}
    st = {k: blk.init_state(8) for k in xs}
    st["ref"], st["ref_prj"] = jblk.init_state(8), jblk.init_state(8)
    for step in range(2):
        xs["ref"], st["ref"] = jblk.step(xs["ref"], st["ref"])
        xs["res"], st["res"] = blk.step(xs["res"], st["res"])
        if step == 0:                  # cold: every weight image shipped
            assert eng.nmc_queue.pool.loads == blk.n_shards
        xs["ref_prj"], st["ref_prj"] = jblk.step(
            xs["ref_prj"], st["ref_prj"], mm=jblk.project_mm(jeng))
        xs["prj"], st["prj"] = blk.step(xs["prj"], st["prj"],
                                        mm=blk.project_mm(eng))
        assert _counters(eng.nmc_queue.pool) == \
            _counters(jeng.nmc_queue.pool), step
        xs["mm"], st["mm"] = blk.step(xs["mm"], st["mm"], mm=blk.torch_mm)
        for k in ("ref_prj", "res", "prj", "mm"):
            assert np.array_equal(xs[k], xs["ref"]), (step, k)
            assert np.array_equal(st[k]["k"], st["ref"]["k"])
            assert np.array_equal(st[k]["v"], st["ref"]["v"])
    loads = eng.nmc_queue.pool.loads
    pb = eng.nmc_queue.pool.patch_bytes
    blk.step(xs["res"], st["res"])     # steady: activation patches only
    assert eng.nmc_queue.pool.loads == loads
    assert eng.nmc_queue.pool.patch_bytes - pb == blk.patch_bytes_per_call
    assert st["res"]["len"] == 3


def test_nmc_project_sharded_matches_reference():
    jeng, eng = _engines(n_slots=1, tiles=2)
    rng = np.random.default_rng(4)
    x8 = rng.integers(-128, 128, (3, 4), dtype=np.int8)
    w8 = rng.integers(-128, 128, (4, 24), dtype=np.int8)
    exact = x8.astype(np.int64) @ w8.astype(np.int64)
    for sew in (8, 32):
        got = eng.nmc_project(x8, w8, sew=sew)
        assert np.array_equal(got, jeng.nmc_project(x8, w8, sew=sew))
        want = exact.astype(np.int8) if sew == 8 else exact
        assert np.array_equal(got, want)
    assert eng.nmc_queue.submitted == jeng.nmc_queue.submitted == 4
    assert _counters(eng.nmc_queue.pool) == _counters(jeng.nmc_queue.pool)
    assert (3, 4, 24, 32) in eng._nmc_proj
    assert eng._nmc_proj[(3, 4, 24, 8)].tiles == 2


def test_layer_params_and_family_check():
    jeng, eng = _engines()
    want = jax.tree.map(lambda a: np.asarray(a[0]),
                        jeng.params["layers"])
    got = block.layer_params(eng.params.layers[0])
    assert set(got) == set(want) and set(got["mlp"]) == set(want["mlp"])
    for part in ("attn", "mlp"):
        for name, leaves in want[part].items():
            assert set(got[part][name]) == set(leaves)
            for k, v in leaves.items():
                assert np.array_equal(got[part][name][k],
                                      np.asarray(v, got[part][name][k].dtype))
    eng.cfg = eng.cfg.scaled(family="moe")
    with pytest.raises(ValueError, match="dense"):
        eng.resident_block()
