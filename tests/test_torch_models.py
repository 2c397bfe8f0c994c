"""The port's dense LM (configs, layers, GQA attention, the decoder LM) on
the CPU against the JAX reference, in float32, with the reference's random
params carried across by ``params_from_jax``.  Tolerance rtol 1e-4 / atol
1e-5 for the float paths; in ``w8a8`` the logits lie within 2e-2 of the
logit scale and agree on the greedy token (int8 rounding amplifies the
last-bit differences of the float stages around it)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.serve import engine as jserve
from repro_torch.configs import base as cb
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import ServeEngine, quantize_params

ARCHS = ("qwen1.5-0.5b", "h2o-danube-1.8b")
TOL = dict(rtol=1e-4, atol=1e-5)
# the reference's entry points, compiled once per shape as its serving
# engine compiles them (op-by-op dispatch would dominate the test time)
jprefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
jdecode = jax.jit(jlm.decode_step, static_argnums=(4,))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed, n_layers):
    cfg = jcb.get(arch, smoke=True).scaled(n_layers=n_layers)
    return jlm.init_params(jax.random.PRNGKey(seed), cfg)


def _pair(arch, seed=0, **kw):
    """(jax cfg, torch cfg, jax params, port params) for a smoke config in
    float32, the port's params converted from the reference's."""
    jcfg = jcb.get(arch, smoke=True).scaled(dtype=jnp.float32, **kw)
    tcfg = cb.get(arch, smoke=True).scaled(dtype=torch.float32, **kw)
    jp = _jax_params(arch, seed, jcfg.n_layers)
    return jcfg, tcfg, jp, params_from_jax(_np_tree(jp), tcfg, "cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape) \
        .astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(arch, smoke):
    j, t = jcb.get(arch, smoke=smoke), cb.get(arch, smoke=smoke)
    for field in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab_size", "head_dim", "qkv_bias",
                  "rope_theta", "window", "act", "norm_eps", "nmc_mode",
                  "kv_cache_dtype"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.param_count() == j.param_count()
    assert t.dtype == torch.bfloat16
    assert cb.applicable_shapes(t) == jcb.applicable_shapes(j)


@pytest.mark.parametrize("arch", sorted(set(jcb.ARCH_IDS) - set(ARCHS)))
def test_unported_archs_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cb.get(arch)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "w8", "w8a8"])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_linear_matches_reference(mode, act):
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(48, 40)) / np.sqrt(48)).astype(np.float32)
    b = rng.normal(size=40).astype(np.float32)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    tp = L.NmcLinear(torch.from_numpy(w), torch.from_numpy(b))
    if mode != "none":
        jp, tp = JL.linear_quantize(jp), tp.quantized()
        assert np.array_equal(tp.w_q.numpy(), np.asarray(jp["w_q"]))
        np.testing.assert_array_equal(tp.scale.numpy(),
                                      np.asarray(jp["scale"]))
    want = JL.linear(jp, jnp.asarray(x), nmc_mode=mode, act=act)
    got = tp(torch.from_numpy(x), nmc_mode=mode, act=act)
    assert got.shape == (2, 5, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_norm_rope_embed_mlp_match_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    g = rng.normal(size=16).astype(np.float32)
    np.testing.assert_allclose(
        L.RMSNorm(torch.from_numpy(g))(torch.from_numpy(x)).numpy(),
        np.asarray(JL.rmsnorm({"g": jnp.asarray(g)}, jnp.asarray(x))), **TOL)
    pos = np.arange(3, 10)
    jc, js = JL.rope_table(jnp.asarray(pos), 16, 1e6)
    tc, ts = L.rope_table(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(
        L.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jc, js)), **TOL)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (2, 6))
    assert np.array_equal(
        L.Embedding(torch.from_numpy(table))(torch.from_numpy(ids),
                                             torch.float32).numpy(),
        np.asarray(JL.embed({"table": jnp.asarray(table)}, jnp.asarray(ids),
                            jnp.float32)))
    jp = JL.mlp_init(jax.random.PRNGKey(3), 16, 32)
    tp = L.MLP(*(L.NmcLinear(torch.tensor(np.asarray(jp[n]["w"])))
                 for n in ("wi", "wo", "wg")))
    h = rng.normal(size=(3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tp(torch.from_numpy(h)).numpy(),
        np.asarray(JL.mlp(jp, jnp.asarray(h))), **TOL)


def test_quantize_tree_matches_reference_and_leaves_the_original():
    jcfg, tcfg, jp, tp = _pair("qwen1.5-0.5b")
    qj = _np_tree(jserve.quantize_params(jp, jcfg))
    qt = quantize_params(tp, tcfg)
    assert tp.head.w is not None and tp.head.w_q is None
    assert qt.head.w is None and qt.embed.table is tp.embed.table
    conv = params_from_jax(qj, tcfg, "cpu")
    for a, b in zip(conv.buffers(), qt.buffers()):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def _layer0(jp):
    return jax.tree.map(lambda a: a[0], jp["layers"]["attn"])


@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8"])
def test_gqa_prefill_and_decode_match_reference(kv_cache_dtype):
    jcfg, tcfg, jp, tp = _pair("h2o-danube-1.8b",
                               kv_cache_dtype=kv_cache_dtype)
    jattn, tattn = _layer0(jp), tp.layers[0].attn
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    jo, jc = JA.gqa_prefill(jattn, jnp.asarray(x), jcfg, 24)
    to, tc = tattn.prefill(torch.from_numpy(x), tcfg, 24)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert sorted(tc) == sorted(jc)
    for name in jc:
        np.testing.assert_allclose(tc[name].float().numpy(),
                                   np.asarray(jc[name], np.float32), **TOL)
    jc = {k: jnp.asarray(v) for k, v in jc.items()}
    clen = np.array([10, 10], np.int32)
    for step in range(3):
        xt = rng.normal(size=(2, 1, 64)).astype(np.float32)
        jo, jc = JA.gqa_decode(jattn, jnp.asarray(xt), jcfg, jc,
                               jnp.asarray(clen))
        to, tc = tattn.decode_step(torch.from_numpy(xt), tcfg, tc,
                                   torch.from_numpy(clen))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        clen = clen + 1
    for name in jc:
        np.testing.assert_allclose(tc[name].float().numpy(),
                                   np.asarray(jc[name], np.float32), **TOL)


def test_gqa_apply_matches_reference():
    jcfg, tcfg, jp, tp = _pair("qwen1.5-0.5b")
    x = np.random.default_rng(5).normal(size=(2, 11, 64)).astype(np.float32)
    for kw in (dict(), dict(causal=False), dict(q_offset=3)):
        np.testing.assert_allclose(
            tp.layers[0].attn(torch.from_numpy(x), tcfg, **kw).numpy(),
            np.asarray(JA.gqa_apply(_layer0(jp), jnp.asarray(x), jcfg, **kw)),
            **TOL)


# ---------------------------------------------------------------------------
# the dense LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(jcfg, (2, 12), 6)
    want, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = lm.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _assert_logits(got, want, kv_cache_dtype):
    """float32 tolerance; with an int8 cache, a cached value that lands
    within float noise of a rounding boundary may round to the neighbouring
    int8 level in one package and not the other (one quantum, a few per
    run), so there the logits agree within 2e-3 of their scale and on the
    greedy token."""
    got, want = got.numpy(), np.asarray(want)
    if kv_cache_dtype == "bf16":
        np.testing.assert_allclose(got, want, **TOL)
        return
    assert float(np.abs(got - want).max()) < 2e-3 * float(np.std(want))
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch,max_len", [("qwen1.5-0.5b", 40),
                                          ("h2o-danube-1.8b", 48),
                                          ("h2o-danube-1.8b", 32)],
                         ids=["qwen", "danube", "danube-ring"])
@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8"])
def test_prefill_and_decode_match_reference(arch, max_len, kv_cache_dtype):
    """max_len 32 = danube-smoke's window: a ring cache, which the decode
    steps wrap around."""
    jcfg, tcfg, jp, tp = _pair(arch, kv_cache_dtype=kv_cache_dtype)
    toks = _tokens(jcfg, (2, 27), 7)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, max_len)
    tl, tc = lm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                        max_len)
    _assert_logits(tl, jl, kv_cache_dtype)
    forced = _tokens(jcfg, (8, 2, 1), 8)
    clen = np.full(2, 28, np.int32)
    for t in range(8 if max_len == 32 else 3):
        jl, jc = jdecode(jp, jnp.asarray(forced[t]), jc, jnp.asarray(clen),
                         jcfg)
        tl, tc = lm.decode_step(tp, torch.from_numpy(forced[t]), tc,
                                torch.from_numpy(clen), tcfg)
        _assert_logits(tl, jl, kv_cache_dtype)
        clen = clen + 1


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [9, 10])
def test_w8a8_logits_track_reference(arch, seed):
    """W8A8 prefill + one decode step.  Float noise in the last bit can put
    an activation on the other side of an int8 rounding boundary in one
    package, and such flips cascade through the later quantized layers
    (qwen-smoke with seed 9 shows it; seed 10 agrees to float precision).
    So the logits are held to an RMS error within 2e-2 of the logit scale
    and to the same greedy token."""
    jcfg, tcfg, jp, tp = _pair(arch, nmc_mode="w8a8")
    qj = jserve.quantize_params(jp, jcfg)
    qt = quantize_params(tp, tcfg)
    toks = _tokens(jcfg, (2, 10), seed)
    jl, jc = jprefill(qj, {"tokens": jnp.asarray(toks)}, jcfg, 32)
    tl, tc = lm.prefill(qt, {"tokens": torch.from_numpy(toks)}, tcfg, 32)
    nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    jl2, _ = jdecode(qj, jnp.asarray(nxt), jc, jnp.full((2,), 11, jnp.int32),
                     jcfg)
    tl2, _ = lm.decode_step(qt, torch.from_numpy(nxt), tc,
                            torch.full((2,), 11, dtype=torch.int32), tcfg)
    for j, t in ((jl, tl), (jl2, tl2)):
        j, t = np.asarray(j), t.numpy()
        assert np.sqrt(np.mean((t - j) ** 2)) < 2e-2 * float(np.std(j))
        assert np.array_equal(t.argmax(-1), j.argmax(-1))


def test_caches_and_batch_axes():
    _, tcfg, _, tp = _pair("qwen1.5-0.5b", n_layers=1)
    caches = lm.init_caches(tp, tcfg, 3, 16, dtype=torch.float32)
    assert caches["layers"]["k"].shape == (1, 3, 4, 16, 16)
    assert lm.cache_batch_axes(tcfg, caches) == {"layers": {"k": 1, "v": 1}}


def test_entry_points_target_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = cb.get("qwen1.5-0.5b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(cfg)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({}, cfg)


def test_init_params_shapes_match_reference():
    jcfg = jcb.get("h2o-danube-1.8b", smoke=True)
    tcfg = cb.get("h2o-danube-1.8b", smoke=True)
    jp = _np_tree(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    tp = lm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    conv = params_from_jax(jp, tcfg, "cpu")
    got = [(n, tuple(b.shape), b.dtype) for n, b in tp.named_buffers()]
    want = [(n, tuple(b.shape), b.dtype) for n, b in conv.named_buffers()]
    assert got == want
    assert abs(float(tp.head.w.std()) - 1 / np.sqrt(64)) < 0.01
    for family in ("moe", "hybrid"):
        with pytest.raises(NotImplementedError):
            lm.init_params(tcfg.scaled(family=family), device="cpu")
