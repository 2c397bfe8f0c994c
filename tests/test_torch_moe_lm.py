"""The port's MoE LM (moonshot-smoke: attention + MoE blocks, optionally
after ``first_dense_layers`` dense ones) and its serving on the CPU against
the JAX reference, in float32, the reference's params carried across by
``params_from_jax``.  ``none`` and ``w8`` within rtol 1e-4 / atol 1e-5 (aux
too); ``w8a8`` within an RMS of 2e-2 of the logit scale and on the greedy
token, as the dense family's test (an activation within float noise of an
int8 rounding boundary may round the other way in one package).  Serving
in ``w8a8`` returns the reference engine's tokens for the same slots,
requests and admission order: idle slots are routed too and take expert
capacity, so single-sequence greedy decoding is not the yardstick."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import lm as jlm
from repro.serve import engine as jserve
from repro_torch.configs import base as cb
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import Request, ServeEngine, quantize_params

ARCH = "moonshot-v1-16b-a3b"
TOL = dict(rtol=1e-4, atol=1e-5)
jforward = jax.jit(jlm.forward, static_argnums=(2,))
jprefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
jdecode = jax.jit(jlm.decode_step, static_argnums=(4,))
# jitted: eager op-by-op dispatch takes seconds at smoke size
jinit = jax.jit(jlm.init_params, static_argnums=(1,))
jquantize = jax.jit(jserve.quantize_params, static_argnums=(1,))


@functools.lru_cache(maxsize=None)
def _jax_params(first_dense: int):
    jcfg = _cfgs(first_dense)[0]
    return jinit(jax.random.PRNGKey(0), jcfg)


def _cfgs(first_dense: int = 0, **kw):
    kw = dict(first_dense_layers=first_dense, dense_d_ff=80, **kw)
    return (jcb.get(ARCH, smoke=True).scaled(dtype=jnp.float32, **kw),
            cb.get(ARCH, smoke=True).scaled(dtype=torch.float32, **kw))


def _pair(mode: str, first_dense: int = 0):
    jcfg, tcfg = _cfgs(first_dense, nmc_mode=mode)
    jp = _jax_params(first_dense)
    if mode != "none":
        jp = jquantize(jp, jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape) \
        .astype(np.int32)


def _assert_logits(got, want, mode):
    got, want = got.numpy(), np.asarray(want)
    if mode != "w8a8":
        np.testing.assert_allclose(got, want, **TOL)
        return
    assert np.sqrt(np.mean((got - want) ** 2)) < 2e-2 * float(np.std(want))
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("first_dense, mode", [
    (0, "none"), (0, "w8"), (0, "w8a8"), (1, "w8a8")])
def test_forward_prefill_decode_match_reference(mode, first_dense):
    jcfg, tcfg, jp, tp = _pair(mode, first_dense)
    assert len(tp.dense_layers) == first_dense
    assert len(tp.layers) == jcfg.n_layers - first_dense
    toks = _tokens(jcfg, (2, 9), 3)
    want, want_aux = jforward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = lm.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    _assert_logits(got, want, mode)
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux),
                               **(TOL if mode != "w8a8" else dict(rtol=2e-2)))
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 24)
    tl, tc = lm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, 24)
    _assert_logits(tl, jl, mode)
    assert sorted(tc) == sorted(jc)
    clen = np.full(2, 10, np.int32)
    for t in range(3):
        step = _tokens(jcfg, (2, 1), 4 + t)
        jl, jc = jdecode(jp, jnp.asarray(step), jc, jnp.asarray(clen), jcfg)
        tl, tc = lm.decode_step(tp, torch.from_numpy(step), tc,
                                torch.from_numpy(clen), tcfg)
        _assert_logits(tl, jl, mode)
        clen = clen + 1
    if mode != "w8a8":
        for key in jc:
            for name in jc[key]:
                np.testing.assert_allclose(tc[key][name].float().numpy(),
                                           np.asarray(jc[key][name]), **TOL)


@pytest.mark.parametrize("first_dense", [0, 1])
def test_caches_and_batch_axes_match_reference(first_dense):
    jcfg, tcfg, jp, tp = _pair("none", first_dense)
    want = jlm.init_caches(jp, jcfg, 3, 16, dtype=jnp.float32)
    got = lm.init_caches(tp, tcfg, 3, 16, dtype=torch.float32)
    assert sorted(got) == sorted(want)
    for key in want:
        assert {n: tuple(t.shape) for n, t in got[key].items()} == \
            {n: tuple(t.shape) for n, t in want[key].items()}
    assert lm.cache_batch_axes(tcfg, got) == \
        jlm.cache_batch_axes(jcfg, want)


def _serve(engine, prompts, max_new):
    for i, pr in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=pr, max_new=max_new))
    return sorted(engine.run(), key=lambda r: r.rid)


@pytest.mark.parametrize("first_dense", [0, 1])
def test_w8a8_serving_matches_reference_engine(first_dense):
    """2 slots, 3 requests: the third waits for a slot, and the slot freed
    first keeps decoding idle beside the live one."""
    jcfg, tcfg, jp, tp = _pair("none", first_dense)
    jcfg, tcfg = (c.scaled(nmc_mode="w8a8") for c in (jcfg, tcfg))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (6, 9, 7)]
    want = _serve(jserve.ServeEngine(jcfg, jserve.quantize_params(jp, jcfg),
                                     n_slots=2, max_len=32), prompts, 4)
    eng = ServeEngine(tcfg, quantize_params(tp, tcfg), n_slots=2, max_len=32,
                      device="cpu")
    assert sorted(eng.caches) == (["dense_layers", "layers"] if first_dense
                                  else ["layers"])
    got = _serve(eng, prompts, 4)
    assert [r.out for r in got] == [r.out for r in want]
    assert all(len(r.out) == 4 for r in got)
    with pytest.raises(ValueError, match="family 'moe'"):
        eng.resident_block()               # dense layers only, as the reference
