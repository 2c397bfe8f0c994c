"""The port's serving engine on the CPU against the JAX reference's:
continuous batching returns the reference engine's tokens for the same
requests (danube-smoke in float32, params carried across by
``params_from_jax``), exact ``max_new`` counts, the ``max_prefills`` bound,
``max_len`` truncation, and the tile-array projection at one and two
tiles with the resident block over it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import lm as jlm
from repro.serve import engine as jserve
from repro_torch import nmc
from repro_torch.configs import base as cb
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import Request, ServeEngine, quantize_params


def _pair(arch="h2o-danube-1.8b", **kw):
    jcfg = jcb.get(arch, smoke=True).scaled(dtype=jnp.float32, **kw)
    tcfg = cb.get(arch, smoke=True).scaled(dtype=torch.float32, **kw)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           tcfg, "cpu")


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


def _serve(engine, prompts, max_new):
    for i, pr in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=pr, max_new=max_new))
    return sorted(engine.run(), key=lambda r: r.rid)


def _greedy(cfg, params, prompt, n_new, max_len=128):
    """Step-by-step single-sequence greedy decode on the port."""
    lg, caches = lm.prefill(params, {"tokens": torch.from_numpy(prompt[None])},
                            cfg, max_len)
    toks = [int(torch.argmax(lg[0]))]
    clen = torch.tensor([len(prompt) + 1], dtype=torch.int32)
    for _ in range(n_new - 1):
        lg, caches = lm.decode_step(params, torch.tensor([[toks[-1]]]),
                                    caches, clen, cfg)
        toks.append(int(torch.argmax(lg[0])))
        clen = clen + 1
    return toks


def test_continuous_batching_matches_reference_engine():
    jcfg, tcfg, jp, tp = _pair()
    prompts = _prompts(jcfg, (5, 9, 13, 7, 11), 0)   # more requests than slots
    want = _serve(jserve.ServeEngine(jcfg, jp, n_slots=2, max_len=128),
                  prompts, 6)
    got = _serve(ServeEngine(tcfg, tp, n_slots=2, max_len=128, device="cpu"),
                 prompts, 6)
    assert [r.out for r in got] == [r.out for r in want]
    assert got[0].out == _greedy(tcfg, tp, prompts[0], 6)


def test_w8a8_serving_matches_reference_engine():
    jcfg, tcfg, jp, tp = _pair("qwen1.5-0.5b", nmc_mode="w8a8")
    prompts = _prompts(jcfg, (6, 10, 8), 1)
    want = _serve(jserve.ServeEngine(jcfg, jserve.quantize_params(jp, jcfg),
                                     n_slots=2, max_len=64), prompts, 4)
    eng = ServeEngine(tcfg, quantize_params(tp, tcfg), n_slots=2,
                      max_len=64, device="cpu")
    got = _serve(eng, prompts, 4)
    assert [r.out for r in got] == [r.out for r in want]
    assert eng.params.head.w_q.dtype == torch.int8


@pytest.mark.parametrize("max_new", [1, 2, 16])
def test_max_new_exact_token_counts(max_new):
    _, tcfg, _, tp = _pair()
    eng = ServeEngine(tcfg, tp, n_slots=2, max_len=128, device="cpu")
    done = _serve(eng, _prompts(tcfg, (5,), 2), max_new)
    assert len(done) == 1 and len(done[0].out) == max_new


def test_max_prefills_bounds_admission():
    _, tcfg, _, tp = _pair()
    prompts = _prompts(tcfg, (5, 5, 5, 5), 8)
    eng = ServeEngine(tcfg, tp, n_slots=4, max_len=64, max_prefills=1,
                      device="cpu")
    for i, pr in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=pr, max_new=3))
    eng._admit()
    assert sum(r is not None for r in eng.slot_req) == 1
    assert len(eng.queue) == 3
    done = sorted(eng.run(), key=lambda r: r.rid)
    ref = _serve(ServeEngine(tcfg, tp, n_slots=4, max_len=64, device="cpu"),
                 prompts, 3)
    assert [r.out for r in done] == [r.out for r in ref]
    with pytest.raises(ValueError):
        ServeEngine(tcfg, tp, n_slots=1, max_len=32, max_prefills=0,
                    device="cpu")


def test_slot_reuse_truncation_and_single_layer_caches():
    _, tcfg, _, tp = _pair(n_layers=1)
    eng = ServeEngine(tcfg, tp, n_slots=1, max_len=64, device="cpu")
    prompts = _prompts(tcfg, (4, 6, 5), 4)
    before = {k: t.shape for k, t in eng.caches["layers"].items()}
    done = _serve(eng, prompts, 2)
    assert [r.rid for r in eng.done] == [0, 1, 2]  # FIFO, one slot reused
    assert all(len(r.out) == 2 for r in done)
    assert not eng.queue and not any(eng.slot_req)
    assert {k: t.shape for k, t in eng.caches["layers"].items()} == before
    for req in done:
        assert req.out == _greedy(tcfg, tp, req.prompt, 2)
    eng = ServeEngine(tcfg, tp, n_slots=1, max_len=8, device="cpu")
    assert len(_serve(eng, _prompts(tcfg, (5,), 6), 16)[0].out) == 8 - 5


def test_dispatch_queue_counts_device_work():
    _, tcfg, _, tp = _pair()
    own = nmc.NmcRuntime(backend="torch").queue
    eng = ServeEngine(tcfg, tp, n_slots=2, max_len=32, nmc_queue=own,
                      device="cpu")
    _serve(eng, _prompts(tcfg, (6,), 9), 3)
    assert own.calls == 3                  # one prefill + two decode steps


def test_nmc_project_and_resident_block():
    """``nmc_project`` on one tile and on two (exact at SEW 8 and 32, one
    cached projection per shape), and the engine's resident block bit-exact
    against its plain GEMM."""
    _, tcfg, _, tp = _pair("qwen1.5-0.5b", nmc_mode="w8a8")
    eng = ServeEngine(tcfg, quantize_params(tp, tcfg), n_slots=1, max_len=32,
                      device="cpu")
    rng = np.random.default_rng(3)
    x8 = rng.integers(-128, 128, (4, 4), dtype=np.int8)
    w8 = rng.integers(-128, 128, (4, 24), dtype=np.int8)
    exact = x8.astype(np.int64) @ w8.astype(np.int64)
    assert (eng.nmc_project(x8, w8) == exact.astype(np.int8)).all()
    assert (eng.nmc_project(x8, w8, sew=32) == exact).all()
    assert (4, 4, 24, 8) in eng._nmc_proj and (4, 4, 24, 32) in eng._nmc_proj
    assert eng.nmc_queue.submitted == 2
    wide = ServeEngine(tcfg, quantize_params(tp, tcfg), n_slots=1,
                       max_len=32, nmc_tiles=2, device="cpu")
    assert (wide.nmc_project(x8, w8) == exact.astype(np.int8)).all()
    assert (wide.nmc_project(x8, w8, sew=32) == exact).all()
    assert wide._nmc_proj[(4, 4, 24, 8)].tiles == 2
    blk = wide.resident_block()
    assert blk.static and blk.n_shards == 14 and blk.m == 1
    x = np.random.default_rng(4).normal(size=(1, tcfg.d_model)) \
        .astype(np.float32)
    got, _ = blk.step(x, blk.init_state(4))
    want, _ = blk.step(x, blk.init_state(4), mm=blk.torch_mm)
    assert np.array_equal(got, want)
