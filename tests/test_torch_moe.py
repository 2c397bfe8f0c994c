"""The port's MoE layer (``repro_torch.models.moe``) on the CPU against the
JAX reference's ``moe_apply`` (single shard), in float32, with the
reference's random params carried across as ``params_from_jax`` carries
them: the routing indices equal, ``y`` and ``aux`` within rtol 1e-4 /
atol 1e-5.  Also the int8 expert banks (equal to the reference's bit for
bit), the quantized-router branch, the router left in float by
``quantize_params``, and the block-by-block quantized build."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models import moe as JMOE
from repro.serve import engine as jserve
from repro_torch.configs import base as cb
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import moe as MOE
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import quantize_params


@pytest.fixture(autouse=True)
def _without_autograd():
    """The float weights are trainable parameters; these tests read the
    served numbers, so they run without recording autograd history."""
    with torch.no_grad():
        yield

ARCH = "moonshot-v1-16b-a3b"
TOL = dict(rtol=1e-4, atol=1e-5)


def _cfgs(**kw):
    jcfg = jcb.get(ARCH, smoke=True).scaled(dtype=jnp.float32, **kw)
    tcfg = cb.get(ARCH, smoke=True).scaled(dtype=torch.float32, **kw)
    return jcfg, tcfg


def _port_moe(jp) -> MOE.MoE:
    """The reference's (unstacked) MoE params as the port's module, through
    ``params_from_jax``'s own carrying (a layer axis of one)."""
    return convert._moe(jax.tree.map(lambda a: np.asarray(a)[None], jp),
                        "cpu", 0)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _reference_routing(jp, x, cfg):
    """The reference's top-k experts per token (``_moe_local``'s lines)."""
    wr = jp["router"].get("w")
    if wr is None:
        wr = jp["router"]["w_q"].astype(jnp.float32) \
            * jp["router"]["scale"][None, :]
    x2 = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(x2 @ wr.astype(jnp.float32), axis=-1)
    return np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])


def _assert_moe_matches(jp, tmoe, jcfg, tcfg, x) -> MOE.Routing:
    want_y, want_aux = JMOE.moe_apply(jp, jnp.asarray(x), jcfg)
    got_y, got_aux = tmoe(torch.from_numpy(x), tcfg)
    routing = MOE.route(torch.from_numpy(x).reshape(-1, x.shape[-1]),
                        tmoe.router_weight(torch.float32), tcfg)
    np.testing.assert_array_equal(routing.top_e.numpy(),
                                  _reference_routing(jp, x, jcfg))
    assert got_y.shape == x.shape and got_aux.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)
    return routing


@pytest.mark.parametrize("shared", [2, 0], ids=["shared", "no-shared"])
@pytest.mark.parametrize("case", ["generous", "tight"])
def test_moe_apply_matches_reference(case, shared):
    """generous: capacity factor 4 over 14 tokens (nothing dropped); tight:
    4 tokens, top-2 of 8, capacity factor 1 -> cap 1 (assignments
    dropped)."""
    cf, shape = (4.0, (2, 7, 64)) if case == "generous" else (1.0, (1, 4, 64))
    jcfg, tcfg = _cfgs(capacity_factor=cf, n_shared_experts=shared)
    jp = JMOE.moe_init(jax.random.PRNGKey(11), jcfg)
    tmoe = _port_moe(jp)
    assert (tmoe.shared is None) == (shared == 0)
    r = _assert_moe_matches(jp, tmoe, jcfg, tcfg, _x(shape, 12))
    if case == "generous":
        assert r.cap == 14 and bool(r.keep.all())
    else:
        assert r.cap == 1 and 0 < int((~r.keep).sum()) < 8


def test_quantized_banks_match_reference():
    jcfg, tcfg = _cfgs(capacity_factor=1.0, nmc_mode="w8")
    jp = JMOE.moe_init(jax.random.PRNGKey(13), jcfg)
    for key in ("wi", "wg", "wo"):
        wq, s = JL._quantize_expert_bank(jp[key])
        tq, ts = L.quantize_expert_bank(torch.tensor(np.asarray(jp[key])))
        assert tq.dtype == torch.int8 and tq.shape == wq.shape
        np.testing.assert_array_equal(tq.numpy(), np.asarray(wq))
        np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=0,
                                   atol=1e-7)
    qj = JL.quantize_tree(jp)
    qt = _port_moe(jp).quantized()
    assert set(qt.bank_keys) == {k for k in qj if k[:2] in ("wi", "wg", "wo")}
    for key in qt.bank_keys:
        np.testing.assert_array_equal(getattr(qt, key).numpy(),
                                      np.asarray(qj[key]))
    _assert_moe_matches(qj, qt, jcfg, tcfg, _x((2, 3, 64), 14))
    # the reference's quantized tree carried across equals the port's own
    _assert_moe_matches(qj, _port_moe(qj), jcfg, tcfg, _x((1, 4, 64), 15))


def test_quantized_router_branch_matches_reference():
    jcfg, tcfg = _cfgs()
    jp = JMOE.moe_init(jax.random.PRNGKey(16), jcfg)
    jp = {**jp, "router": JL.linear_quantize(jp["router"])}
    tmoe = _port_moe(jp)
    assert tmoe.router.w is None and tmoe.router.w_q.dtype == torch.int8
    _assert_moe_matches(jp, tmoe, jcfg, tcfg, _x((2, 5, 64), 17))


def test_quantize_params_leaves_the_router_float():
    jcfg, tcfg = _cfgs(nmc_mode="w8a8")
    jp = jax.jit(jlm.init_params, static_argnums=(1,))(jax.random.PRNGKey(0),
                                                       jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    qt = quantize_params(tp, tcfg)
    conv = params_from_jax(jax.tree.map(np.asarray,
                                        jserve.quantize_params(jp, jcfg)),
                           tcfg, "cpu")
    for blk, src in zip(qt.layers, tp.layers):
        router = blk.moe.router
        assert router.w_q is None and router.w.dtype == torch.float32
        assert router.w is src.moe.router.w
        assert blk.moe.wi_q.dtype == torch.int8
        assert blk.moe.shared.wi.w_q.dtype == torch.int8
        assert src.moe.wi.dtype == torch.float32          # original intact
    got = [(n, b) for n, b in qt.state_dict().items()]
    want = [(n, b) for n, b in conv.state_dict().items()]
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("first_dense", [0, 1])
def test_block_by_block_build_equals_quantize_params(first_dense):
    """``draw_blocks`` quantizing each block as it is drawn equals
    ``quantize_params(init_params(...))`` bit for bit."""
    cfg = cb.get(ARCH, smoke=True).scaled(
        nmc_mode="w8a8", first_dense_layers=first_dense, dense_d_ff=80)
    whole = quantize_params(
        lm.init_params(cfg, torch.Generator().manual_seed(5), "cpu"), cfg)
    each = lm.draw_blocks(cfg, torch.Generator().manual_seed(5), "cpu",
                          L.quantize_tree)
    got = list(each.state_dict().items())
    want = list(whole.state_dict().items())
    assert [n for n, _ in got] == [n for n, _ in want]
    assert any(n.startswith("layers.0.moe.wi_q") for n, _ in got)
    assert any(n.startswith("dense_layers.") for n, _ in got) == \
        bool(first_dense)
    for (name, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_moe_init_matches_reference_shapes():
    jcfg, tcfg = _cfgs()
    jp = JMOE.moe_init(jax.random.PRNGKey(0), jcfg)
    want = _port_moe(jp)
    got = MOE.MoE.init(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert [(n, tuple(b.shape), b.dtype)
            for n, b in got.state_dict().items()] \
        == [(n, tuple(b.shape), b.dtype) for n, b in want.state_dict().items()]
    assert abs(float(got.wo.std()) - 1 / np.sqrt(tcfg.moe_d_ff)) < 0.01
    with pytest.raises(ValueError, match="expert banks"):
        MOE.MoE(got.router, {"wi": got.wi})
