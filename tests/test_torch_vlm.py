"""The port's VLM family (pixtral-smoke: a dense GQA backbone behind
``img_proj``, the projected image embeddings placed before the text) on
the CPU against the JAX reference, in float32, the reference's params
carried across by ``params_from_jax``.  Images are normal(0, 1) patch
embeddings from a numpy seed, as the reference's model tests make them.
``none`` and ``w8`` within rtol 1e-4 / atol 1e-5; ``w8a8`` within an RMS
of 2e-2 of the logit scale and on the greedy token, as the dense family's
test.  Neither package's serving engine passes images, so both refuse a
VLM with ``KeyError: 'images'``."""

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

ARCH = "pixtral-12b"
TOL = dict(rtol=1e-4, atol=1e-5)
jforward = jax.jit(jlm.forward, static_argnums=(2,))
jprefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
jdecode = jax.jit(jlm.decode_step, static_argnums=(4,))
jinit = jax.jit(jlm.init_params, static_argnums=(1,))
jquantize = jax.jit(jserve.quantize_params, static_argnums=(1,))


def _cfgs(**kw):
    return (jcb.get(ARCH, smoke=True).scaled(dtype=jnp.float32, **kw),
            cb.get(ARCH, smoke=True).scaled(dtype=torch.float32, **kw))


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jinit(jax.random.PRNGKey(0), _cfgs()[0])


def _pair(mode: str):
    jcfg, tcfg = _cfgs(nmc_mode=mode)
    jp = _jax_params()
    if mode != "none":
        jp = jquantize(jp, jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _batch(cfg, b: int, s_txt: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"images": rng.normal(size=(b, cfg.n_img_tokens, cfg.d_model))
            .astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (b, s_txt))
            .astype(np.int32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_logits(got, want, mode):
    got, want = got.numpy(), np.asarray(want)
    if mode != "w8a8":
        np.testing.assert_allclose(got, want, **TOL)
        return
    assert np.sqrt(np.mean((got - want) ** 2)) < 2e-2 * float(np.std(want))
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("mode", ["none", "w8", "w8a8"])
def test_forward_prefill_decode_match_reference(mode):
    jcfg, tcfg, jp, tp = _pair(mode)
    batch = _batch(jcfg, 2, 7, 1)
    n = jcfg.n_img_tokens + 7
    want, _ = jforward(jp, _j(batch), jcfg)
    got, aux = lm.forward(tp, _t(batch), tcfg)
    assert got.shape == (2, n, jcfg.vocab_size) and float(aux) == 0.0
    _assert_logits(got, want, mode)            # image positions included
    jl, jc = jprefill(jp, _j(batch), jcfg, 24)
    tl, tc = lm.prefill(tp, _t(batch), tcfg, 24)
    _assert_logits(tl, jl, mode)
    assert sorted(tc) == sorted(jc) == ["layers"]
    clen = np.full(2, n + 1, np.int32)
    for t in range(3):
        step = np.random.default_rng(7 + t).integers(
            0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jnp.asarray(step), jc, jnp.asarray(clen), jcfg)
        tl, tc = lm.decode_step(tp, torch.from_numpy(step), tc,
                                torch.from_numpy(clen), tcfg)
        _assert_logits(tl, jl, mode)
        clen = clen + 1
    if mode != "w8a8":
        for name in jc["layers"]:
            np.testing.assert_allclose(tc["layers"][name].numpy(),
                                       np.asarray(jc["layers"][name]), **TOL)


def test_images_change_the_text_logits():
    """The image positions feed the text's attention: other images, other
    logits at every text position."""
    _, tcfg, _, tp = _pair("none")
    a, b = _batch(tcfg, 1, 5, 2), _batch(tcfg, 1, 5, 3)
    b["tokens"] = a["tokens"]
    la, _ = lm.forward(tp, _t(a), tcfg)
    lb, _ = lm.forward(tp, _t(b), tcfg)
    n_img = tcfg.n_img_tokens
    assert not torch.allclose(la[:, n_img:], lb[:, n_img:], atol=1e-3)


def test_caches_and_batch_axes_match_reference():
    jcfg, tcfg, jp, tp = _pair("none")
    want = jlm.init_caches(jp, jcfg, 3, 16, dtype=jnp.float32)
    got = lm.init_caches(tp, tcfg, 3, 16, dtype=torch.float32)
    assert {n: tuple(t.shape) for n, t in got["layers"].items()} == \
        {n: tuple(t.shape) for n, t in want["layers"].items()}
    assert lm.cache_batch_axes(tcfg, got) == \
        jlm.cache_batch_axes(jcfg, want)


@pytest.mark.parametrize("entry", ["forward", "prefill"])
def test_batch_without_images_raises_in_both(entry):
    jcfg, tcfg, jp, tp = _pair("none")
    toks = _batch(jcfg, 1, 5, 4)["tokens"]
    jcall = {"forward": lambda b: jlm.forward(jp, b, jcfg),
             "prefill": lambda b: jlm.prefill(jp, b, jcfg, 16)}[entry]
    tcall = {"forward": lambda b: lm.forward(tp, b, tcfg),
             "prefill": lambda b: lm.prefill(tp, b, tcfg, 16)}[entry]
    with pytest.raises(KeyError, match="images"):
        jcall({"tokens": jnp.asarray(toks)})
    with pytest.raises(KeyError, match="images"):
        tcall({"tokens": torch.from_numpy(toks)})


def test_serving_engine_refuses_a_vlm_as_the_reference():
    """Admission prefills with the prompt's tokens only, in both packages."""
    jcfg, tcfg, jp, tp = _pair("none")
    jcfg, tcfg = (c.scaled(nmc_mode="w8a8") for c in (jcfg, tcfg))
    prompt = _batch(jcfg, 1, 6, 5)["tokens"][0]
    jeng = jserve.ServeEngine(jcfg, jserve.quantize_params(jp, jcfg),
                              n_slots=2, max_len=32)
    teng = ServeEngine(tcfg, quantize_params(tp, tcfg), n_slots=2,
                       max_len=32, device="cpu")
    for eng, request in ((jeng, jserve.Request), (teng, Request)):
        eng.submit(request(rid=0, prompt=prompt, max_new=2))
        with pytest.raises(KeyError, match="images"):
            eng.run()


def test_params_from_jax_carries_img_proj():
    for mode in ("none", "w8a8"):
        _, _, jp, tp = _pair(mode)
        jproj = jax.tree.map(np.asarray, jp["img_proj"])
        assert tp.img_proj is not None
        for name, want in jproj.items():
            got = getattr(tp.img_proj, name)
            assert got.numpy().dtype == want.dtype
            assert np.array_equal(got.numpy(), want), name


def test_block_by_block_build_draws_img_proj_last():
    cfg = cb.get(ARCH, smoke=True)
    order = []

    def each(m):
        order.append(type(m).__name__)
        return L.quantize_tree(m)
    drawn = lm.draw_blocks(cfg, torch.Generator().manual_seed(3), "cpu",
                           each)
    assert order == ["NmcLinear"] + ["DecoderBlock"] * cfg.n_layers + \
        ["NmcLinear"]
    assert drawn.img_proj.w_q.shape == (cfg.d_model, cfg.d_model)
    want = quantize_params(
        lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu"), cfg)
    got_bufs, want_bufs = dict(drawn.state_dict().items()), \
        dict(want.state_dict().items())
    assert sorted(got_bufs) == sorted(want_bufs)
    for name, t in want_bufs.items():
        assert got_bufs[name].dtype == t.dtype and \
            torch.equal(got_bufs[name], t), name


def test_init_params_shapes_match_reference():
    """The port's own initialisation builds the reference's tree: the same
    buffers, shapes and dtypes as the reference's params carried across."""
    jcfg, tcfg = _cfgs()
    conv = params_from_jax(jax.tree.map(np.asarray, _jax_params()), tcfg,
                           "cpu")
    own = lm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert [(n, tuple(b.shape), b.dtype)
            for n, b in own.state_dict().items()] \
        == [(n, tuple(b.shape), b.dtype) for n, b in conv.state_dict().items()]
