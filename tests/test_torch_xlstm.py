"""The port's xLSTM family (xlstm-smoke: mLSTM blocks with an sLSTM block at
layer 1) on the CPU against the JAX reference, in float32, the reference's
params carried across by ``params_from_jax``.  One mLSTM block alone:
prefill output and ``(C, n, m)`` below, at and past one chunk, then 3
decode steps from that state; one sLSTM block: prefill output and ``(c,
n, m, h)``, then 3 decode steps.  The LM in ``none`` / ``w8`` within rtol
1e-4 / atol 1e-5 and in ``w8a8`` within an RMS of 2e-2 of the logit scale
and on the greedy token, as the hybrid family's test; decode after
prefill equals the port's own teacher-forced forward; serving in ``w8a8``
returns the reference engine's tokens for the same slots, requests and
admission order.  Two facts of the reference hold in both packages:
``quantize_tree`` leaves every block float (the blocks are a list, and it
recurses into dicts only), so the head is the only int8 projection; and a
prompt longer than ``ssm_chunk`` that is not a multiple of it raises."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import lm as jlm
from repro.models import xlstm as JXL
from repro.serve import engine as jserve
from repro_torch.configs import base as cb
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import xlstm as XL
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import Request, ServeEngine, quantize_params


@pytest.fixture(autouse=True)
def _without_autograd():
    """The float weights are trainable parameters; these tests read the
    served numbers, so they run without recording autograd history."""
    with torch.no_grad():
        yield

ARCH = "xlstm-125m"
TOL = dict(rtol=1e-4, atol=1e-5)
SELF_TOL = dict(rtol=1e-4, atol=5e-5)
jforward = jax.jit(jlm.forward, static_argnums=(2,))
jprefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
jdecode = jax.jit(jlm.decode_step, static_argnums=(4,))
jinit = jax.jit(jlm.init_params, static_argnums=(1,))
jquantize = jax.jit(jserve.quantize_params, static_argnums=(1,))
jmlstm = jax.jit(JXL.mlstm_apply, static_argnums=(2, 4))
jmlstm_decode = jax.jit(JXL.mlstm_apply, static_argnums=(2,))
jslstm = jax.jit(JXL.slstm_apply, static_argnums=(2, 4))


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


def _assert_states(got, want):
    """A cache tree of the port (dicts, lists, tuples of tensors) against
    the reference's."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _assert_states(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_states(g, w)
    else:
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [8, 16, 32], ids=["below", "one", "two"])
def test_mlstm_prefill_and_decode_match_reference(s):
    """Chunk 16: S = 8 (one short chunk), 16, 32 (the memory carried
    across a chunk); then 3 decode steps from the prefilled state."""
    jcfg, tcfg, jp, tp = _pair("none")
    jb, tb = jp["blocks"][0], tp.blocks[0]
    assert isinstance(tb, XL.MLSTM)
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    jy, jst = jmlstm(jb, jnp.asarray(x), jcfg, None, True)
    ty, tst = tb(torch.from_numpy(x), tcfg, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _assert_states(tst, jst)
    for _ in range(3):
        xt = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = jmlstm_decode(jb, jnp.asarray(xt), jcfg, jst)
        ty = tb.decode_step(torch.from_numpy(xt), tcfg, tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        _assert_states(tst, jst)


@pytest.mark.parametrize("s", [5, 24])
def test_slstm_prefill_and_decode_match_reference(s):
    jcfg, tcfg, jp, tp = _pair("none")
    jb, tb = jp["blocks"][1], tp.blocks[1]
    assert isinstance(tb, XL.SLSTM)
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    jy, jst = jslstm(jb, jnp.asarray(x), jcfg, None, True)
    ty, tst = tb(torch.from_numpy(x), tcfg, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _assert_states(tst, jst)
    for _ in range(3):
        xt = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = jslstm(jb, jnp.asarray(xt), jcfg, jst, True)
        ty = tb.decode_step(torch.from_numpy(xt), tcfg, tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        _assert_states(tst, jst)


def test_ragged_prompt_past_the_chunk_raises_in_both():
    """S = chunk + 4: the reference's reshape into whole chunks fails, and
    the port raises rather than pad; in an mLSTM block and in the LM."""
    jcfg, tcfg, jp, tp = _pair("none")
    s = jcfg.ssm_chunk + 4
    x = np.zeros((1, s, jcfg.d_model), np.float32)
    with pytest.raises(TypeError, match="reshape"):
        JXL.mlstm_apply(jp["blocks"][0], jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="chunk"):
        tp.blocks[0](torch.from_numpy(x), tcfg)
    toks = _tokens(jcfg, (1, s), 1)
    with pytest.raises(TypeError, match="reshape"):
        jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 32)
    with pytest.raises(ValueError, match="chunk"):
        lm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, 32)


def test_quantize_tree_leaves_every_block_float_in_both():
    """The reference's ``quantize_tree`` returns a list unchanged: every
    block keeps ``{"w": ...}`` (the sLSTM's ``r_*`` float32 (H, P, P)), and
    only the head becomes int8; the port's blocks opt out the same way."""
    jcfg, tcfg, jp, tp = _pair("none")
    qj = jserve.quantize_params(jp, jcfg)
    qt = quantize_params(tp, tcfg)
    assert isinstance(qj["blocks"], list)
    for i, blk in enumerate(qj["blocks"]):
        keys = XL.MLSTM.KEYS if i not in jcfg.slstm_layers else \
            [f"w_{g}" for g in XL.GATES] + ["up", "down"]
        for key in keys:
            assert sorted(blk[key]) == ["w"], (i, key)
            assert blk[key]["w"].dtype == jnp.float32
        if i in jcfg.slstm_layers:
            h, p = jcfg.n_heads, jcfg.d_model // jcfg.n_heads
            assert blk["r_z"].shape == (h, p, p)
    assert sorted(qj["head"]) == ["scale", "w_q"]
    for blk, orig in zip(qt.blocks, tp.blocks):
        assert blk is orig
        for name, buf in blk.state_dict().items():
            assert buf.dtype == torch.float32, name
    assert qt.head.w_q is not None and qt.head.w_q.dtype == torch.int8
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
    _assert_states(tc, jc)                  # the head does not feed them
    clen = np.full(2, 17, np.int32)
    for t in range(3):
        step = _tokens(jcfg, (2, 1), 4 + t)
        jl, jc = jdecode(jp, jnp.asarray(step), jc, jnp.asarray(clen), jcfg)
        tl, tc = lm.decode_step(tp, torch.from_numpy(step), tc,
                                torch.from_numpy(clen), tcfg)
        _assert_logits(tl, jl, mode)
        clen = clen + 1
    _assert_states(tc, jc)


@pytest.mark.parametrize("s", [8, 16, 32])
def test_decode_after_prefill_equals_own_forward(s):
    """Prefill s tokens, decode the next 3: each step's logits are the
    teacher-forced forward's at that position (the forward over s + 3
    tokens, rounded up to whole chunks past one: other chunk boundaries
    than the prefill's), within rtol 1e-4 / atol 5e-5: the reference's own
    decode differs from its forward by up to 1.7e-5 here."""
    _, tcfg, _, tp = _pair("none")
    chunk = tcfg.ssm_chunk
    n = s + 3 if s + 3 <= chunk else -(-(s + 3) // chunk) * chunk
    toks = torch.from_numpy(_tokens(tcfg, (2, n), 7 + s))
    want, _ = lm.forward(tp, {"tokens": toks}, tcfg)
    logits, caches = lm.prefill(tp, {"tokens": toks[:, :s]}, tcfg, s + 4)
    np.testing.assert_allclose(logits.numpy(), want[:, s - 1].numpy(),
                               **SELF_TOL)
    for t in range(3):
        logits, caches = lm.decode_step(
            tp, toks[:, s + t:s + t + 1], caches,
            torch.full((2,), s + t + 1, dtype=torch.int32), tcfg)
        np.testing.assert_allclose(logits.numpy(), want[:, s + t].numpy(),
                                   **SELF_TOL)


def test_caches_and_batch_axes_match_reference():
    """A list of per-block state tuples, float32 whatever ``dtype`` is,
    batch first."""
    jcfg, tcfg, jp, tp = _pair("none")
    want = jlm.init_caches(jp, jcfg, 3, 16, dtype=jnp.bfloat16)
    got = lm.init_caches(tp, tcfg, 3, 16, dtype=torch.bfloat16)
    _assert_states(got, want)
    assert [len(st) for st in got["blocks"]] == [3, 4, 3]
    axes = lm.cache_batch_axes(tcfg, got)
    assert axes == jlm.cache_batch_axes(jcfg, want)
    assert axes == {"blocks": [(0, 0, 0), (0, 0, 0, 0), (0, 0, 0)]}


def _serve(engine, prompts, max_new):
    for i, pr in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=pr, max_new=max_new))
    return sorted(engine.run(), key=lambda r: r.rid)


def test_w8a8_serving_matches_reference_engine():
    """2 slots, 3 requests (prompts of 16, 9 and 32 tokens: each at most
    one chunk or a whole number of them): the third waits for a slot, and
    its prefill's states go into the slot freed first."""
    jcfg, tcfg, jp, tp = _pair("none")
    jcfg, tcfg = (c.scaled(nmc_mode="w8a8") for c in (jcfg, tcfg))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (16, 9, 32)]
    want = _serve(jserve.ServeEngine(jcfg, jserve.quantize_params(jp, jcfg),
                                     n_slots=2, max_len=48), prompts, 4)
    eng = ServeEngine(tcfg, quantize_params(tp, tcfg), n_slots=2, max_len=48,
                      device="cpu")
    assert [len(st) for st in eng.caches["blocks"]] == [3, 4, 3]
    got = _serve(eng, prompts, 4)
    assert [r.out for r in got] == [r.out for r in want]
    assert all(len(r.out) == 4 for r in got)


def _reference_buffers(tree: dict) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(p.idx) if hasattr(p, "idx") else p.key for p in path]
        out[".".join(keys)] = np.asarray(leaf)
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
    assert order == ["NmcLinear", "MLSTM", "SLSTM", "MLSTM"]
    want = quantize_params(
        lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu"), cfg)
    got_bufs, want_bufs = dict(drawn.state_dict().items()), \
        dict(want.state_dict().items())
    assert sorted(got_bufs) == sorted(want_bufs)
    assert got_bufs["blocks.0.up.w"].dtype == torch.float32
    assert got_bufs["head.w_q"].dtype == torch.int8
    for name, t in want_bufs.items():
        assert got_bufs[name].dtype == t.dtype and \
            torch.equal(got_bufs[name], t), name


def test_init_params_match_reference():
    """The port's own initialisation builds the reference's tree: the same
    buffers, shapes and dtypes as the reference's params carried across,
    the recurrent weights at 0.1-normal scale."""
    jcfg, tcfg = _cfgs()
    conv = params_from_jax(jax.tree.map(np.asarray, _jax_params()), tcfg,
                           "cpu")
    own = lm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert [(n, tuple(b.shape), b.dtype)
            for n, b in own.state_dict().items()] \
        == [(n, tuple(b.shape), b.dtype) for n, b in conv.state_dict().items()]
    assert abs(float(own.blocks[1].r_z.std()) - 0.1) < 0.02
    assert abs(float(own.blocks[0].up.w.std()) - 1 / np.sqrt(64)) < 0.01
