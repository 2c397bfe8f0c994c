"""The port's hybrid SSM family (zamba2-smoke: groups of Mamba2 layers,
each group followed by one shared attention/MLP block) on the CPU against
the JAX reference, in float32, the reference's params carried across by
``params_from_jax``.  One Mamba2 layer alone: prefill output and state
below, at and past one chunk, then 3 decode steps from that state (the
SSM state and both conv windows).  The LM in ``none`` / ``w8`` within
rtol 1e-4 / atol 1e-5 and in ``w8a8`` within an RMS of 2e-2 of the logit
scale and on the greedy token, as the dense family's test; serving in
``w8a8`` returns the reference engine's tokens for the same slots,
requests and admission order.  Two facts of the reference hold in both
packages: ``quantize_tree`` leaves the Mamba2 weights float (they are
stacked four deep), and a prompt longer than ``ssm_chunk`` that is not a
multiple of it raises."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models import ssm as JSSM
from repro.serve import engine as jserve
from repro_torch.configs import base as cb
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import ssm as SSM
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import Request, ServeEngine, quantize_params


@pytest.fixture(autouse=True)
def _without_autograd():
    """The float weights are trainable parameters; these tests read the
    served numbers, so they run without recording autograd history."""
    with torch.no_grad():
        yield

ARCH = "zamba2-2.7b"
TOL = dict(rtol=1e-4, atol=1e-5)
jforward = jax.jit(jlm.forward, static_argnums=(2,))
jprefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
jdecode = jax.jit(jlm.decode_step, static_argnums=(4,))
jinit = jax.jit(jlm.init_params, static_argnums=(1,))
jquantize = jax.jit(jserve.quantize_params, static_argnums=(1,))
jmamba = jax.jit(JSSM.mamba2_apply, static_argnums=(2, 3))
jmamba_decode = jax.jit(JSSM.mamba2_decode, static_argnums=(2,))


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


def _assert_tree(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if isinstance(w, dict):
            _assert_tree(got[key], w)
        else:
            assert tuple(got[key].shape) == w.shape, key
            np.testing.assert_allclose(got[key].numpy(), np.asarray(w),
                                       **TOL, err_msg=key)


def _layer(jp, tp, g=1, e=1):
    return jax.tree.map(lambda a: a[g, e], jp["mamba"]), tp.mamba[g][e]


# ---------------------------------------------------------------------------
# one Mamba2 layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [8, 16, 32], ids=["below", "one", "two"])
def test_mamba2_prefill_and_decode_match_reference(s):
    """Chunk 16: S = 8 (one short chunk), 16, 32 (the state carried
    across a chunk); then 3 decode steps from the prefilled state."""
    jcfg, tcfg, jp, tp = _pair("none")
    jl, tl = _layer(jp, tp)
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    jy, jst = jmamba(jl, jnp.asarray(x), jcfg, True)
    ty, tst = tl(torch.from_numpy(x), tcfg, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _assert_tree(tst, jst)
    tst = {k: v.clone() for k, v in tst.items()}
    for _ in range(3):
        xt = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = jmamba_decode(jl, jnp.asarray(xt), jcfg, jst)
        ty = tl.decode_step(torch.from_numpy(xt), tcfg, tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        _assert_tree(tst, jst)


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """``dt * A`` of 2-8 a step over a chunk of 16: a masked (i < j)
    segment's exponential overflows float32.  The reference exponentiates
    before masking, so its gradient in ``dt`` is NaN there (at chunk 1,
    the same function, it is finite); the port masks first: the same
    values bit for bit, and the gradient of the overflow-free chunk-1
    form, the reference's there."""
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 32, 4, 8, 8
    xh, bm, cm = (rng.normal(size=shape).astype(np.float32)
                  for shape in ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = np.full((b, s, h), 1.0, np.float32)
    a = -2.0 * np.arange(1, h + 1, dtype=np.float32)

    def jgrads(chunk):
        def loss(*args):
            y, st = JSSM._ssd_chunked(args[0], args[1], jnp.asarray(a),
                                      args[2], args[3], chunk)
            return jnp.sum(y ** 2) + jnp.sum(st ** 2)
        return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3))(
            xh, dt, bm, cm)], JSSM._ssd_chunked(xh, dt, jnp.asarray(a), bm,
                                                cm, chunk)

    def tgrads(chunk):
        ts = [torch.tensor(t, requires_grad=True) for t in (xh, dt, bm, cm)]
        with torch.enable_grad():    # the file's fixture disables it
            y, st = SSM.ssd_chunked(ts[0], ts[1], torch.tensor(a), ts[2],
                                    ts[3], chunk)
            (torch.sum(y ** 2) + torch.sum(st ** 2)).backward()
        return [t.grad.numpy() for t in ts], (y.detach(), st.detach())
    ref16, (jy, jst) = jgrads(16)
    assert np.isnan(ref16[1]).any()
    ref1, _ = jgrads(1)
    got16, (y, st) = tgrads(16)
    got1, _ = tgrads(1)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-5,
                               atol=1e-5)
    for g16, g1, r1 in zip(got16, got1, ref1):
        assert np.isfinite(g16).all()
        scale = float(np.abs(r1).max())
        np.testing.assert_allclose(g16, g1, rtol=1e-4, atol=1e-5 * scale)
        np.testing.assert_allclose(g16, r1, rtol=1e-4, atol=1e-5 * scale)


def test_ragged_prompt_past_the_chunk_raises_in_both():
    """S = chunk + 4: the reference's reshape into whole chunks fails, and
    the port raises rather than pad; in a Mamba2 layer and in the LM."""
    jcfg, tcfg, jp, tp = _pair("none")
    jl, tl = _layer(jp, tp)
    s = jcfg.ssm_chunk + 4
    x = np.zeros((1, s, jcfg.d_model), np.float32)
    with pytest.raises(TypeError, match="reshape"):
        JSSM.mamba2_apply(jl, jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="chunk"):
        tl(torch.from_numpy(x), tcfg)
    toks = _tokens(jcfg, (1, s), 1)
    with pytest.raises(TypeError, match="reshape"):
        jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 32)
    with pytest.raises(ValueError, match="chunk"):
        lm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, 32)


def test_quantize_tree_leaves_mamba2_float_in_both():
    """The reference quantizes a ``{"w": ...}`` of 2 or 3 dims only; the
    Mamba2 stack is (groups, attn_every, d_in, d_out).  The shared block
    and the head become int8 in both."""
    jcfg, tcfg, jp, tp = _pair("none")
    qj = jserve.quantize_params(jp, jcfg)
    qt = quantize_params(tp, tcfg)
    for key in SSM.PROJ_KEYS + ("out_proj",):
        assert sorted(qj["mamba"][key]) == ["w"]
        assert qj["mamba"][key]["w"].ndim == 4
        assert qj["mamba"][key]["w"].dtype == jnp.float32
    assert sorted(qj["mamba"]["conv_x"]) == ["b", "w"]
    assert "w_q" in qj["shared_attn"]["attn"]["wq"] and "w_q" in qj["head"]
    for group in qt.mamba:
        for layer in group:
            for key in SSM.PROJ_KEYS + ("out_proj",):
                lin = getattr(layer, key)
                assert lin.w is not None and lin.w_q is None
                assert lin.w.dtype == torch.float32
    assert qt.mamba[0][0] is tp.mamba[0][0]
    assert qt.shared_attn.attn.wq.w_q is not None and qt.head.w_q is not None
    conv = params_from_jax(jax.tree.map(np.asarray, qj), tcfg, "cpu")
    for a, b in zip(conv.state_dict().items(), qt.state_dict().items()):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype and \
            torch.equal(a[1], b[1]), a[0]


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "w8", "w8a8"])
def test_forward_prefill_decode_match_reference(mode):
    jcfg, tcfg, jp, tp = _pair(mode)
    toks = _tokens(jcfg, (2, 16), 3)
    want, _ = jforward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = lm.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert float(aux) == 0.0
    _assert_logits(got, want, mode)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 24)
    tl, tc = lm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, 24)
    _assert_logits(tl, jl, mode)
    if mode != "w8a8":
        _assert_tree(tc, jc)
    clen = np.full(2, 17, np.int32)
    for t in range(3):
        step = _tokens(jcfg, (2, 1), 4 + t)
        jl, jc = jdecode(jp, jnp.asarray(step), jc, jnp.asarray(clen), jcfg)
        tl, tc = lm.decode_step(tp, torch.from_numpy(step), tc,
                                torch.from_numpy(clen), tcfg)
        _assert_logits(tl, jl, mode)
        clen = clen + 1
    if mode != "w8a8":
        _assert_tree(tc, jc)


def test_caches_and_batch_axes_match_reference():
    jcfg, tcfg, jp, tp = _pair("none")
    want = jlm.init_caches(jp, jcfg, 3, 16, dtype=jnp.float32)
    got = lm.init_caches(tp, tcfg, 3, 16, dtype=torch.float32)
    assert sorted(got) == sorted(want) == ["attn", "mamba"]
    for key in want:
        assert {n: tuple(t.shape) for n, t in got[key].items()} == \
            {n: tuple(t.shape) for n, t in want[key].items()}
    axes = lm.cache_batch_axes(tcfg, got)
    assert axes == jlm.cache_batch_axes(jcfg, want)
    assert axes == {"mamba": {"ssm": 2, "conv_x": 2, "conv_bc": 2},
                    "attn": {"k": 1, "v": 1}}


def _serve(engine, prompts, max_new):
    for i, pr in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=pr, max_new=max_new))
    return sorted(engine.run(), key=lambda r: r.rid)


def test_w8a8_serving_matches_reference_engine():
    """2 slots, 3 requests (prompts of 16, 9 and 32 tokens: each at most
    one chunk or a whole number of them): the third waits for a slot, and
    its prefill's Mamba2 states and KV caches go into the slot freed
    first."""
    jcfg, tcfg, jp, tp = _pair("none")
    jcfg, tcfg = (c.scaled(nmc_mode="w8a8") for c in (jcfg, tcfg))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (16, 9, 32)]
    want = _serve(jserve.ServeEngine(jcfg, jserve.quantize_params(jp, jcfg),
                                     n_slots=2, max_len=48), prompts, 4)
    eng = ServeEngine(tcfg, quantize_params(tp, tcfg), n_slots=2, max_len=48,
                      device="cpu")
    assert {k: sorted(v) for k, v in eng.caches.items()} == \
        {"mamba": ["conv_bc", "conv_x", "ssm"], "attn": ["k", "v"]}
    got = _serve(eng, prompts, 4)
    assert [r.out for r in got] == [r.out for r in want]
    assert all(len(r.out) == 4 for r in got)


def _reference_buffers(tree: dict) -> dict:
    """The reference's leaves under the port's buffer names: the stacked
    ``mamba`` leaves split per (group, layer), its convs' ``w`` / ``b`` as
    ``conv_x_w`` ..."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        leaf = np.asarray(leaf)
        if keys[0] != "mamba":
            out[".".join(keys)] = leaf
            continue
        rest = keys[1:]
        if rest[0] in ("conv_x", "conv_bc"):
            rest = ["_".join(rest)]
        for g in range(leaf.shape[0]):
            for e in range(leaf.shape[1]):
                out[".".join(["mamba", str(g), str(e)] + rest)] = leaf[g, e]
    return out


@pytest.mark.parametrize("mode", ["none", "w8a8"])
def test_params_from_jax_carries_every_key(mode):
    _, _, jp, tp = _pair(mode)
    want = _reference_buffers(jp)
    got = {n: b.numpy() for n, b in tp.state_dict().items()}
    assert sorted(got) == sorted(want)
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
    assert order == ["NmcLinear"] + ["Mamba2"] * cfg.n_layers + \
        ["DecoderBlock"]
    want = quantize_params(
        lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu"), cfg)
    got_bufs, want_bufs = dict(drawn.state_dict().items()), \
        dict(want.state_dict().items())
    assert sorted(got_bufs) == sorted(want_bufs)
    assert got_bufs["mamba.0.0.in_z.w"].dtype == torch.float32
    assert got_bufs["shared_attn.attn.wq.w_q"].dtype == torch.int8
    for name, t in want_bufs.items():
        assert got_bufs[name].dtype == t.dtype and \
            torch.equal(got_bufs[name], t), name


def test_init_params_match_reference():
    """The port's own initialisation builds the reference's tree (the same
    buffers, shapes and dtypes as the reference's params carried across)
    with the reference's deterministic Mamba2 leaves, and the gated
    norm's default eps."""
    jcfg, tcfg = _cfgs()
    jp = _jax_params()
    conv = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    own = lm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert [(n, tuple(b.shape), b.dtype)
            for n, b in own.state_dict().items()] \
        == [(n, tuple(b.shape), b.dtype) for n, b in conv.state_dict().items()]
    layer = own.mamba[0][0]
    for name in ("A_log", "D", "conv_x_b", "conv_bc_b"):
        assert torch.equal(getattr(layer, name),
                           getattr(conv.mamba[0][0], name)), name
    dt = torch.nn.functional.softplus(layer.dt_bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-4) and \
        float(dt.max()) <= 0.1 * (1 + 1e-4)
    assert layer.norm.eps == 1e-5 and tcfg.norm_eps == 1e-5
    di = tcfg.d_inner
    x = np.random.default_rng(0).normal(size=(2, 3, di)).astype(np.float32)
    np.testing.assert_allclose(
        layer.norm(torch.from_numpy(x)).numpy(),
        np.asarray(JL.rmsnorm({"g": jnp.ones(di)}, jnp.asarray(x))), **TOL)
