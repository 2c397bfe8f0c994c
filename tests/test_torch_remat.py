"""The training knobs of ``ModelConfig`` against the JAX reference on the
CPU: the fields and every config's knob values, and activation
checkpointing (``remat``, ``remat_policy``) on one rank, float32 smoke
configs.

Tolerances: those of ``tests/test_torch_train.py`` against the reference
(loss ``rtol 1e-5``; gradients ``rtol 1e-4`` with an ``atol`` of ``1e-5``
of the tensor's largest).  Against the same model without checkpointing
the loss and every gradient are bit for bit the same: the recompute runs
the same operations on the same inputs.

That checkpointing happens is shown by the bytes the forward leaves alive
for the backward: every tensor an operation makes during the forward is
followed by a weak reference, and the storages still alive once the
forward has returned are counted.  The saved-tensor hooks of autograd
cannot order the two policies: a checkpointed region hands them nothing
under either, and ``"dots"`` keeps its products in the selective
checkpoint's own cache.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro.configs import base as jcb
from repro.models import config as jconfig
from repro.models import lm as jlm
from repro_torch.configs import base as cb
from repro_torch.data import pipeline as tpipe
from repro_torch.models import config as tconfig
from repro_torch.models.convert import params_from_jax
from repro_torch.train import step as tstep

#: one smoke config of each family, MLA's too
ARCHS = ("qwen1.5-0.5b", "moonshot-v1-16b-a3b", "deepseek-v2-lite-16b",
         "zamba2-2.7b", "pixtral-12b", "whisper-tiny", "xlstm-125m")
KNOBS = ("remat", "remat_policy", "scan_layers", "seq_parallel")
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-5
#: tokens a row: two zamba2 / xlstm chunks of 16
SEQ = 32


def _cfgs(arch: str, **kw) -> tuple:
    return (jcb.get(arch, smoke=True).scaled(dtype=jnp.float32, **kw),
            cb.get(arch, smoke=True).scaled(dtype=torch.float32, **kw))


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

def test_config_fields_match_reference_in_order():
    assert [f.name for f in dataclasses.fields(tconfig.ModelConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.ModelConfig)]
    for name in KNOBS:
        assert tconfig.ModelConfig.__dataclass_fields__[name].default == \
            jconfig.ModelConfig.__dataclass_fields__[name].default, name


@pytest.mark.parametrize("arch", jcb.ARCH_IDS)
def test_knobs_of_every_config_match_reference(arch):
    """``full()`` keeps the defaults (remat on), ``smoke()`` turns remat
    off, in both packages."""
    for smoke in (False, True):
        j, t = jcb.get(arch, smoke=smoke), cb.get(arch, smoke=smoke)
        for name in KNOBS:
            assert getattr(t, name) == getattr(j, name), (smoke, name)
    assert cb.get(arch).remat and not cb.get(arch, smoke=True).remat


# ---------------------------------------------------------------------------
# activation checkpointing on one rank
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    return jax.tree.map(np.asarray,
                        jlm.init_params(jax.random.PRNGKey(0),
                                        _cfgs(arch)[0]))


@functools.lru_cache(maxsize=None)
def _batch(arch: str) -> dict:
    tcfg = _cfgs(arch)[1]
    data = tpipe.SyntheticLM(tpipe.DataConfig(global_batch=2, seq_len=SEQ,
                                              seed=5), tcfg)
    b = data.batch_at(1)
    rng = np.random.default_rng(5)
    b["mask"] = (rng.random(b["tokens"].shape) < 0.7).astype(np.int32)
    return b


def _port(arch: str, **kw) -> tuple:
    """(loss, metrics, {name: gradient}) of the port's step gradient."""
    tcfg = _cfgs(arch, **kw)[1]
    model = params_from_jax(_jax_params(arch), tcfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    return tstep.grads_of(tstep.make_loss(tcfg), model, batch)


@functools.lru_cache(maxsize=None)
def _port_off(arch: str) -> tuple:
    return _port(arch)


def _reference(arch: str, **kw) -> tuple:
    jcfg, tcfg = _cfgs(arch, **kw)
    (loss, met), g = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))(
            _jax_params(arch), {k: jnp.asarray(v)
                                for k, v in _batch(arch).items()})
    named = params_from_jax(jax.tree.map(np.asarray, g), tcfg, "cpu")
    return float(loss), {k: float(v) for k, v in met.items()}, \
        {n: t.detach() for n, t in named.named_parameters()}


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_loss_and_gradients(arch, policy):
    """Checkpointed, the port's loss and gradients are its own without
    checkpointing bit for bit, and the reference's with the same
    ``remat`` / ``remat_policy``."""
    loss, met, g = _port(arch, remat=True, remat_policy=policy)
    loss0, met0, g0 = _port_off(arch)
    assert float(loss) == float(loss0)
    assert {k: float(v) for k, v in met.items()} == \
        {k: float(v) for k, v in met0.items()}
    assert sorted(g) == sorted(g0)
    for name in g0:
        assert torch.equal(g[name], g0[name]), name
    jl, jmet, jg = _reference(arch, remat=True, remat_policy=policy)
    np.testing.assert_allclose(float(loss), jl, rtol=1e-5)
    for key in ("nll", "aux"):
        np.testing.assert_allclose(float(met[key]), jmet[key], rtol=1e-5,
                                   atol=1e-7)
    assert sorted(g) == sorted(jg)
    for name, w in jg.items():
        atol = GRAD_ATOL_SCALE * float(w.abs().max()) + 1e-12
        np.testing.assert_allclose(g[name].numpy(), w.numpy(),
                                   rtol=GRAD_RTOL, atol=atol, err_msg=name)


class _Alive(TorchDispatchMode):
    """Follows every tensor an operation makes inside the block by a weak
    reference."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.refs.append(weakref.ref(t))
        return out


def _bytes_kept(arch: str, **kw) -> int:
    """The bytes of the storages made during the forward (the loss's) and
    still alive when it has returned: what the backward will read."""
    tcfg = _cfgs(arch, **kw)[1]
    model = params_from_jax(_jax_params(arch), tcfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    with torch.enable_grad(), _Alive() as alive:
        loss, _ = tstep.make_loss(tcfg)(model, batch)
    gc.collect()
    storages = {}
    for ref in alive.refs:
        t = ref()
        if t is not None:
            st = t.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
    assert loss.requires_grad
    return sum(storages.values())


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "xlstm-125m"])
def test_checkpointing_keeps_fewer_bytes_for_backward(arch):
    """qwen-smoke keeps fewer bytes for its backward under ``"dots"``
    than without checkpointing, and fewer still under ``"full"``; the
    xLSTM, whose blocks the reference does not checkpoint, keeps the same
    under all three."""
    off = _bytes_kept(arch)
    dots = _bytes_kept(arch, remat=True, remat_policy="dots")
    full = _bytes_kept(arch, remat=True, remat_policy="full")
    if arch == "xlstm-125m":
        assert off == dots == full
    else:
        assert off > dots > full > 0, (off, dots, full)
