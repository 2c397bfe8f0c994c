"""The port's MLA attention (deepseek-smoke: MLA + MoE blocks after
``first_dense_layers`` dense ones) and its serving on the CPU against the
JAX reference, in float32, the reference's params carried across by
``params_from_jax``.  ``none`` and ``w8`` within rtol 1e-4 / atol 1e-5
(logits, aux and the compressed ``ckv`` / ``krope`` caches); ``w8a8``
within an RMS of 2e-2 of the logit scale and on the greedy token, as the
MoE family's test (an activation within float noise of an int8 rounding
boundary may round the other way in one package).  Serving in ``w8a8``
returns the reference engine's tokens for the same slots, requests and
admission order."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import attention as JA
from repro.models import lm as jlm
from repro.serve import engine as jserve
from repro_torch.configs import base as cb
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import Request, ServeEngine, quantize_params


@pytest.fixture(autouse=True)
def _without_autograd():
    """The float weights are trainable parameters; these tests read the
    served numbers, so they run without recording autograd history."""
    with torch.no_grad():
        yield

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-4, atol=1e-5)
jforward = jax.jit(jlm.forward, static_argnums=(2,))
jprefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
jdecode = jax.jit(jlm.decode_step, static_argnums=(4,))
# jitted: eager op-by-op dispatch takes seconds at smoke size
jinit = jax.jit(jlm.init_params, static_argnums=(1,))
jquantize = jax.jit(jserve.quantize_params, static_argnums=(1,))


def _cfgs(first_dense: int = 1, **kw):
    kw = dict(first_dense_layers=first_dense, **kw)
    return (jcb.get(ARCH, smoke=True).scaled(dtype=jnp.float32, **kw),
            cb.get(ARCH, smoke=True).scaled(dtype=torch.float32, **kw))


@functools.lru_cache(maxsize=None)
def _jax_params(first_dense: int):
    return jinit(jax.random.PRNGKey(0), _cfgs(first_dense)[0])


def _pair(mode: str, first_dense: int = 1):
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


def _assert_caches(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert sorted(got[key]) == ["ckv", "krope"]
        for name in want[key]:
            np.testing.assert_allclose(got[key][name].float().numpy(),
                                       np.asarray(want[key][name]), **TOL)


@pytest.mark.parametrize("first_dense, mode", [
    (1, "none"), (1, "w8"), (1, "w8a8"), (0, "none"), (0, "w8a8")])
def test_forward_prefill_decode_match_reference(mode, first_dense):
    jcfg, tcfg, jp, tp = _pair(mode, first_dense)
    assert len(tp.dense_layers) == first_dense
    assert all(isinstance(b.attn, A.MLAttention)
               for _, blocks in tp.stacks() for b in blocks)
    toks = _tokens(jcfg, (2, 9), 3)
    want, want_aux = jforward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = lm.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    _assert_logits(got, want, mode)
    np.testing.assert_allclose(float(aux), float(want_aux),
                               **(TOL if mode != "w8a8" else dict(rtol=2e-2)))
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 24)
    tl, tc = lm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, 24)
    _assert_logits(tl, jl, mode)
    if mode != "w8a8":
        _assert_caches(tc, jc)
    clen = np.full(2, 10, np.int32)
    for t in range(3):
        step = _tokens(jcfg, (2, 1), 4 + t)
        jl, jc = jdecode(jp, jnp.asarray(step), jc, jnp.asarray(clen), jcfg)
        tl, tc = lm.decode_step(tp, torch.from_numpy(step), tc,
                                torch.from_numpy(clen), tcfg)
        _assert_logits(tl, jl, mode)
        clen = clen + 1
    if mode != "w8a8":
        _assert_caches(tc, jc)


@pytest.mark.parametrize("mode", ["none", "w8a8"])
def test_mla_layer_matches_reference(mode):
    """One MLA layer alone: the expanded form at two query offsets, prefill
    with its compressed cache, and 3 absorbed decode steps, rows at
    different cache lengths."""
    jcfg, tcfg, jp, tp = _pair(mode)
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tattn = tp.layers[0].attn
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    tol = TOL if mode == "none" else dict(rtol=2e-2, atol=2e-2)
    for off in (0, 5):
        np.testing.assert_allclose(
            tattn(torch.from_numpy(x), tcfg, q_offset=off).numpy(),
            np.asarray(JA.mla_apply(jattn, jnp.asarray(x), jcfg,
                                    q_offset=off)), **tol)
    jo, jc = JA.mla_prefill(jattn, jnp.asarray(x), jcfg, 16)
    to, tc = tattn.prefill(torch.from_numpy(x), tcfg, 16)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **tol)
    for name in ("ckv", "krope"):
        assert tc[name].shape == jc[name].shape
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **tol)
    clen = np.array([10, 7], np.int32)
    for _ in range(3):
        xt = rng.normal(size=(2, 1, 64)).astype(np.float32)
        jo, jc = JA.mla_decode(jattn, jnp.asarray(xt), jcfg, jc,
                               jnp.asarray(clen))
        to, tc = tattn.decode_step(torch.from_numpy(xt), tcfg, tc,
                                   torch.from_numpy(clen))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **tol)
        clen = clen + 1
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **tol)


@pytest.mark.parametrize("mode", ["none", "w8a8"])
def test_prefill_cache_equals_a_second_projection(mode):
    """The reference's ``mla_prefill`` projects ``ckv`` and ``krope`` a
    second time; the port keeps the forward's: equal bit for bit."""
    _, tcfg, _, tp = _pair(mode)
    tcfg = tcfg.scaled(dtype=torch.bfloat16)
    attn = tp.layers[0].attn
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 9, 64)).astype(np.float32)).to(torch.bfloat16)
    _, cache = attn.prefill(x, tcfg, 12)
    cos, sin = L.rope_table(torch.arange(9), tcfg.qk_rope_dim,
                            tcfg.rope_theta)
    ckv = attn.norm_ckv(attn.w_dkv(x, nmc_mode=mode))
    krope = L.apply_rope(attn.w_krope(x, nmc_mode=mode)[:, :, None, :],
                         cos, sin)[:, :, 0]
    assert cache["ckv"].dtype == cache["krope"].dtype == torch.bfloat16
    assert torch.equal(cache["ckv"][:, :9], ckv)
    assert torch.equal(cache["krope"][:, :9], krope)
    assert not cache["ckv"][:, 9:].any() and not cache["krope"][:, 9:].any()


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


def test_dense_layers_alone_match_reference():
    """deepseek-smoke cut to its dense first layer (``n_layers`` 1): the
    MoE stack holds no layer, and the reference's prefill returns its
    caches as zero-length leaves; the port's prefill does too, and its
    logits and a decode step's follow the reference."""
    kw = dict(n_layers=1)
    jcfg, tcfg = _cfgs(1, **kw)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = _tokens(tcfg, (2, 6), 3)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 12)
    tl, tc = lm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, 12)
    _assert_logits(tl, jl, "none")
    assert {k: {n: tuple(t.shape) for n, t in v.items()}
            for k, v in tc.items()} == \
        {k: {n: tuple(t.shape) for n, t in v.items()}
         for k, v in jc.items()}
    assert tc["layers"]["ckv"].shape[0] == 0
    nxt = _tokens(tcfg, (2, 1), 4)
    jl, _ = jdecode(jp, jnp.asarray(nxt), jc, jnp.full((2,), 7, jnp.int32),
                    jcfg)
    tl, _ = lm.decode_step(tp, torch.from_numpy(nxt), tc,
                           torch.full((2,), 7, dtype=torch.int32), tcfg)
    _assert_logits(tl, jl, "none")


def _serve(engine, prompts, max_new):
    for i, pr in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=pr, max_new=max_new))
    return sorted(engine.run(), key=lambda r: r.rid)


@pytest.mark.parametrize("first_dense", [0, 1])
def test_w8a8_serving_matches_reference_engine(first_dense):
    """2 slots, 3 requests: the third waits for a slot, and its prefill's
    ``ckv`` / ``krope`` go into the slot freed first."""
    jcfg, tcfg, jp, tp = _pair("none", first_dense)
    jcfg, tcfg = (c.scaled(nmc_mode="w8a8") for c in (jcfg, tcfg))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (6, 9, 7)]
    want = _serve(jserve.ServeEngine(jcfg, jserve.quantize_params(jp, jcfg),
                                     n_slots=2, max_len=32), prompts, 4)
    eng = ServeEngine(tcfg, quantize_params(tp, tcfg), n_slots=2, max_len=32,
                      device="cpu")
    assert {k: sorted(v) for k, v in eng.caches.items()} == \
        {k: ["ckv", "krope"] for k in (["dense_layers", "layers"]
                                       if first_dense else ["layers"])}
    got = _serve(eng, prompts, 4)
    assert [r.out for r in got] == [r.out for r in want]
    assert all(len(r.out) == 4 for r in got)


def test_block_by_block_build_equals_quantized_init():
    cfg = cb.get(ARCH, smoke=True)
    drawn = lm.draw_blocks(cfg, torch.Generator().manual_seed(3), "cpu",
                           L.quantize_tree)
    want = quantize_params(
        lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu"), cfg)
    got_bufs, want_bufs = dict(drawn.state_dict().items()), \
        dict(want.state_dict().items())
    assert sorted(got_bufs) == sorted(want_bufs)
    assert "layers.0.attn.norm_ckv.g" in got_bufs
    assert got_bufs["layers.0.attn.w_uk.w_q"].dtype == torch.int8
    for name, t in want_bufs.items():
        assert got_bufs[name].dtype == t.dtype and \
            torch.equal(got_bufs[name], t), name


def test_init_params_shapes_match_reference():
    """The port's own initialisation builds the reference's tree: the same
    buffers, shapes and dtypes as the reference's params carried across."""
    jcfg, tcfg = _cfgs()
    conv = params_from_jax(jax.tree.map(np.asarray, _jax_params(1)), tcfg,
                           "cpu")
    own = lm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert [(n, tuple(b.shape), b.dtype)
            for n, b in own.state_dict().items()] \
        == [(n, tuple(b.shape), b.dtype) for n, b in conv.state_dict().items()]
