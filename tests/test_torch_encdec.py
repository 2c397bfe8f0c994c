"""The port's encoder-decoder family (whisper-smoke: a LayerNorm encoder
over precomputed frame embeddings, then RMSNorm ``enc_norm``; a decoder of
causal self-attention, cross-attention to the encoder output and a gelu
MLP over the tokens plus learned positions) on the CPU against the JAX
reference, in float32, the reference's params carried across by
``params_from_jax``.  Frames are normal(0, 1) from a numpy seed.  ``none``
and ``w8`` within rtol 1e-4 / atol 1e-5; ``w8a8`` within an RMS of 2e-2
of the logit scale and on the greedy token, as the dense family's test.
The cross keys and values are the w8 form in every mode, as the
reference's ``_cross_kv`` computes them.  Neither package's serving engine
passes frames, so both refuse the family with ``KeyError: 'frames'``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import layers as JL
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

ARCH = "whisper-tiny"
TOL = dict(rtol=1e-4, atol=1e-5)
jforward = jax.jit(jlm.forward, static_argnums=(2,))
jprefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
jdecode = jax.jit(jlm.decode_step, static_argnums=(4,))
jencode = jax.jit(jlm._encode, static_argnums=(2,))
jinit = jax.jit(jlm.init_params, static_argnums=(1,))
jquantize = jax.jit(jserve.quantize_params, static_argnums=(1,))


def _cfgs(**kw):
    return (jcb.get(ARCH, smoke=True).scaled(dtype=jnp.float32, **kw),
            cb.get(ARCH, smoke=True).scaled(dtype=torch.float32, **kw))


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jinit(jax.random.PRNGKey(0), _cfgs()[0])


@functools.lru_cache(maxsize=None)
def _pair(mode: str):
    jcfg, tcfg = _cfgs(nmc_mode=mode)
    jp = _jax_params()
    if mode != "none":
        jp = jquantize(jp, jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _batch(cfg, b: int, s: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"frames": rng.normal(size=(b, cfg.enc_seq, cfg.d_model))
            .astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (b, s))
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


def _assert_caches(got, want):
    assert sorted(got) == sorted(want) == ["cross_k", "cross_v", "layers"]
    for name in ("cross_k", "cross_v"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   **TOL)
    for name in want["layers"]:
        np.testing.assert_allclose(got["layers"][name].numpy(),
                                   np.asarray(want["layers"][name]), **TOL)


def test_layernorm_matches_reference():
    rng = np.random.default_rng(2)
    x = (3.0 + rng.normal(size=(2, 7, 48))).astype(np.float32)
    g = rng.normal(size=48).astype(np.float32)
    b = rng.normal(size=48).astype(np.float32)
    want = JL.layernorm({"g": jnp.asarray(g), "b": jnp.asarray(b)},
                        jnp.asarray(x), 1e-5)
    norm = L.LayerNorm(torch.from_numpy(g), torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(norm(torch.from_numpy(x)).numpy(),
                               np.asarray(want), **TOL)
    # computed in float32, cast back
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = norm(xb)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, norm(xb.float()).to(torch.bfloat16))


@pytest.mark.parametrize("mode", ["none", "w8a8"])
def test_encode_matches_reference(mode):
    jcfg, tcfg, jp, tp = _pair(mode)
    frames = _batch(jcfg, 2, 1, 3)["frames"]
    want = jencode(jp, jnp.asarray(frames), jcfg)
    with torch.inference_mode():
        got = tp.encode(torch.from_numpy(frames), tcfg)
    assert got.shape == (2, jcfg.enc_seq, jcfg.d_model)
    if mode == "none":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        want = np.asarray(want)
        assert np.sqrt(np.mean((got.numpy() - want) ** 2)) < \
            2e-2 * float(np.std(want))


@pytest.mark.parametrize("mode", ["none", "w8", "w8a8"])
def test_forward_prefill_decode_match_reference(mode):
    jcfg, tcfg, jp, tp = _pair(mode)
    batch = _batch(jcfg, 2, 7, 1)
    want, _ = jforward(jp, _j(batch), jcfg)
    got, aux = lm.forward(tp, _t(batch), tcfg)
    assert got.shape == (2, 7, jcfg.vocab_size) and float(aux) == 0.0
    _assert_logits(got, want, mode)
    jl, jc = jprefill(jp, _j(batch), jcfg, 24)
    tl, tc = lm.prefill(tp, _t(batch), tcfg, 24)
    _assert_logits(tl, jl, mode)
    if mode != "w8a8":
        _assert_caches(tc, jc)
    clen = np.full(2, 8, np.int32)
    for t in range(3):
        step = np.random.default_rng(7 + t).integers(
            0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jnp.asarray(step), jc, jnp.asarray(clen), jcfg)
        tl, tc = lm.decode_step(tp, torch.from_numpy(step), tc,
                                torch.from_numpy(clen), tcfg)
        _assert_logits(tl, jl, mode)
        clen = clen + 1
    if mode != "w8a8":
        _assert_caches(tc, jc)


@pytest.mark.parametrize("mode", ["none", "w8a8"])
def test_cross_caches_equal_the_reference_cross_kv(mode):
    """The prefill's cross keys and values are ``_cross_kv`` of the
    encoder output (the w8 form in w8a8 too: no activation rounding)."""
    jcfg, tcfg, jp, tp = _pair(mode)
    batch = _batch(jcfg, 2, 5, 4)
    enc = jencode(jp, jnp.asarray(batch["frames"]), jcfg)
    _, tc = lm.prefill(tp, _t(batch), tcfg, 16)
    for i in range(jcfg.n_layers):
        lp = jax.tree.map(lambda a: a[i], jp["layers"])
        k, v = jlm._cross_kv(lp, enc, jcfg)
        np.testing.assert_allclose(tc["cross_k"][i].numpy(), np.asarray(k),
                                   **TOL)
        np.testing.assert_allclose(tc["cross_v"][i].numpy(), np.asarray(v),
                                   **TOL)


def test_caches_and_batch_axes_match_reference():
    jcfg, tcfg, jp, tp = _pair("none")
    want = jlm.init_caches(jp, jcfg, 3, 16, dtype=jnp.float32)
    got = lm.init_caches(tp, tcfg, 3, 16, dtype=torch.float32)
    assert sorted(got) == sorted(want)
    assert {n: tuple(t.shape) for n, t in got["layers"].items()} == \
        {n: tuple(t.shape) for n, t in want["layers"].items()}
    for name in ("cross_k", "cross_v"):
        assert tuple(got[name].shape) == want[name].shape
        assert got[name].dtype == torch.float32 and not got[name].any()
    assert got["cross_k"].data_ptr() != got["cross_v"].data_ptr()
    assert lm.cache_batch_axes(tcfg, got) == \
        jlm.cache_batch_axes(jcfg, want) == \
        {"layers": {"k": 1, "v": 1}, "cross_k": 1, "cross_v": 1}


def test_decode_position_is_clipped_as_the_reference():
    """Rows at cache lengths past the 32768 learned positions and at 1:
    the position is ``clip(cache_len - 1, 0, 32767)`` in both."""
    jcfg, tcfg, jp, tp = _pair("none")
    batch = _batch(jcfg, 3, 4, 5)
    jl, jc = jprefill(jp, _j(batch), jcfg, 16)
    _, tc = lm.prefill(tp, _t(batch), tcfg, 16)
    clen = np.array([40000, lm.DEC_POSITIONS, 1], np.int32)
    step = _batch(jcfg, 3, 1, 6)["tokens"]
    jl, _ = jdecode(jp, jnp.asarray(step), jc, jnp.asarray(clen), jcfg)
    tl, _ = lm.decode_step(tp, torch.from_numpy(step), tc,
                           torch.from_numpy(clen), tcfg)
    _assert_logits(tl, jl, "none")
    assert tp.pos_dec.table.shape[0] == lm.DEC_POSITIONS == \
        jp["pos_dec"]["table"].shape[0]


def test_serving_engines_refuse_the_encdec_as_the_reference():
    """Admission prefills with the prompt's tokens only, in both packages;
    neither engine fails earlier, when it is built."""
    jcfg, tcfg, jp, tp = _pair("none")
    jcfg, tcfg = (c.scaled(nmc_mode="w8a8") for c in (jcfg, tcfg))
    prompt = _batch(jcfg, 1, 6, 5)["tokens"][0]
    jeng = jserve.ServeEngine(jcfg, jserve.quantize_params(jp, jcfg),
                              n_slots=2, max_len=32)
    teng = ServeEngine(tcfg, quantize_params(tp, tcfg), n_slots=2,
                       max_len=32, device="cpu")
    assert sorted(teng.caches) == ["cross_k", "cross_v", "layers"]
    for eng, request in ((jeng, jserve.Request), (teng, Request)):
        eng.submit(request(rid=0, prompt=prompt, max_new=2))
        with pytest.raises(KeyError, match="frames"):
            eng.run()


@pytest.mark.parametrize("entry", ["forward", "prefill"])
def test_batch_without_frames_raises_in_both(entry):
    jcfg, tcfg, jp, tp = _pair("none")
    toks = _batch(jcfg, 1, 5, 4)["tokens"]
    jcall = {"forward": lambda b: jlm.forward(jp, b, jcfg),
             "prefill": lambda b: jlm.prefill(jp, b, jcfg, 16)}[entry]
    tcall = {"forward": lambda b: lm.forward(tp, b, tcfg),
             "prefill": lambda b: lm.prefill(tp, b, tcfg, 16)}[entry]
    with pytest.raises(KeyError, match="frames"):
        jcall({"tokens": jnp.asarray(toks)})
    with pytest.raises(KeyError, match="frames"):
        tcall({"tokens": torch.from_numpy(toks)})


def _reference_buffers(tree: dict) -> dict:
    """The reference's leaves under the port's buffer names: stacked
    ``enc_layers`` / ``layers`` leaves split per layer."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        leaf = np.asarray(leaf)
        if keys[0] in ("enc_layers", "layers"):
            for i in range(leaf.shape[0]):
                out[".".join([keys[0], str(i)] + keys[1:])] = leaf[i]
        else:
            out[".".join(keys)] = leaf
    return out


@pytest.mark.parametrize("mode", ["none", "w8a8"])
def test_params_from_jax_carries_every_key(mode):
    _, _, jp, tp = _pair(mode)
    want = _reference_buffers(jp)
    got = {n: b.numpy() for n, b in tp.state_dict().items()}
    assert sorted(got) == sorted(want)
    assert "layers.0.xattn.wq.w" + ("_q" if mode != "none" else "") in got
    for name, w in want.items():
        assert got[name].dtype == w.dtype and np.array_equal(got[name], w), \
            name


def test_block_by_block_build_equals_quantized_init():
    cfg = cb.get(ARCH, smoke=True)
    order = []

    def each(m):
        order.append(type(m).__name__)
        return L.quantize_tree(m)
    drawn = lm.draw_blocks(cfg, torch.Generator().manual_seed(3), "cpu",
                           each)
    assert order == ["NmcLinear"] + ["EncoderBlock"] * cfg.n_enc_layers + \
        ["CrossDecoderBlock"] * cfg.n_layers
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
    assert abs(float(own.pos_dec.table.std()) - 0.02) < 1e-3
    assert float(own.enc_layers[0].ln1.b.abs().max()) == 0.0
