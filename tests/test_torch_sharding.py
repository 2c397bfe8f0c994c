"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX reference's, leaf by leaf, for the full configs of all ten
architectures, and the functions that turn a spec into data on a one-rank
mesh.

The port's full models are built on the ``meta`` device; the reference's
on ``jax.eval_shape(lm.init_params)``.  A port tensor is one layer's slice
of a reference leaf that stacks the layers in front, so its spec is the
reference leaf's with the leading stack dims dropped.  The meshes are
stand-ins (``fix_divisibility`` and the ZeRO-2 extension read only
``.shape`` and ``.axis_names``): (data 16, model 16) and (data 2, model
4).  The reference's ``opt_state_shardings`` is ``_extend_with_data`` over
``fix_divisibility`` of each leaf's spec; the test composes those two
reference functions, since ``NamedSharding`` needs a real mesh.
"""

from __future__ import annotations

import functools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import base as jcb
from repro.distributed import sharding as jsh
from repro.models import lm as jlm
from repro_torch.configs import base as cb
from repro_torch.distributed import compress, context, sharding
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm

MESHES = {"16x16": {"data": 16, "model": 16}, "2x4": {"data": 2, "model": 4}}


def _mesh(name: str):
    shape = MESHES[name]
    return types.SimpleNamespace(shape=shape, axis_names=tuple(shape))


@functools.lru_cache(maxsize=None)
def _reference(arch: str) -> dict:
    """{port-style name with '*' for stacks: (spec, stacked shape)}."""
    shapes = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                    jcb.get(arch)))
    specs = jsh.param_specs(shapes)
    out = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(shapes)[0],
            jax.tree_util.tree_leaves(specs,
                                      is_leaf=lambda x: isinstance(x, P))):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out[".".join(keys)] = (spec, tuple(leaf.shape))
    return out


@functools.lru_cache(maxsize=None)
def _port(arch: str) -> dict:
    model = lm.init_params(cb.get(arch), torch.Generator(), device="meta")
    return dict(model.named_parameters())


def _ref_key(name: str) -> str:
    """The reference's path of a port parameter: the stack indices
    dropped, a Mamba2 conv weight split into its two components."""
    return ".".join(p for p in sharding.path_of(compress.leaf_of(name))
                    if p != "*")


def _padded(spec, nd: int) -> tuple:
    parts = tuple(spec)
    return parts + (None,) * (nd - len(parts))


@pytest.mark.parametrize("arch", jcb.ARCH_IDS)
def test_param_specs_match_reference(arch):
    ref, port = _reference(arch), _port(arch)
    specs = sharding.param_specs(port)
    assert sorted({_ref_key(n) for n in port}) == sorted(ref)
    stacked = sharding.stacked_shapes(port)
    for name, t in port.items():
        spec, shape = ref[_ref_key(name)]
        lead = len(shape) - t.dim()
        assert stacked[name] == shape, name
        assert _padded(spec, len(shape))[lead:] == specs[name], name


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", jcb.ARCH_IDS)
def test_fix_divisibility_and_moments_match_reference(arch, mesh):
    ref, port, m = _reference(arch), _port(arch), _mesh(mesh)
    fixed = sharding.param_shardings(port, m)
    moments = sharding.opt_state_shardings({}, port, m)
    assert sorted(moments) == ["m", "step", "v"]
    assert moments["step"].spec == ()
    for name, t in port.items():
        spec, shape = ref[_ref_key(name)]
        lead = len(shape) - t.dim()
        want_fix = _padded(jsh.fix_divisibility(spec, shape, m),
                           len(shape))
        want_mom = _padded(jsh._extend_with_data(
            jsh.fix_divisibility(spec, shape, m), shape, m), len(shape))
        assert fixed[name].spec == want_fix[lead:], name
        assert moments["m"][name].spec == want_mom[lead:], name
        assert moments["v"][name].spec == want_mom[lead:], name
        assert sharding.fix_divisibility(sharding.param_specs(
            {name: t})[name], tuple(t.shape), m) == want_fix[lead:], name


def test_col_row_rules():
    """The reference's ``test_col_row_rules`` on the port's names."""
    params = {"wq.w": torch.zeros(64, 128), "wo.w": torch.zeros(128, 64),
              "wo.b": torch.zeros(64), "norm.g": torch.zeros(64),
              "moe.wi": torch.zeros(8, 64, 96),
              "moe.router.w": torch.zeros(64, 8),
              "mamba.0.1.conv_x_w": torch.zeros(4, 32)}
    specs = sharding.param_specs(params)
    assert specs["wq.w"] == (None, "model")
    assert specs["wo.w"] == ("model", None)
    assert specs["wo.b"] == (None,)
    assert specs["norm.g"] == (None,)
    assert specs["moe.wi"] == ("model", None, None)
    assert specs["moe.router.w"] == (None, None)
    assert specs["mamba.0.1.conv_x_w"] == (None, "model")


def test_divisibility_guard():
    """whisper's 51865 vocab survives on a one-rank axis, is dropped on
    16 ranks, as the reference's guard."""
    one = _mesh("16x16")
    one.shape = {"data": 1, "model": 1}
    assert sharding.fix_divisibility(("model", None), (51865, 384),
                                     one) == ("model", None)
    assert sharding.fix_divisibility(("model", None), (51865, 384),
                                     _mesh("16x16")) == (None, None)
    assert jsh.fix_divisibility(P("model", None), (51865, 384),
                                _mesh("16x16")) == P(None, None)


def _reference_specs(fn, *args):
    """The specs the reference's ``fn`` puts into its ``NamedSharding`` s
    (which need a real mesh): the constructor replaced by one that keeps
    the spec."""
    orig = jsh.NamedSharding
    jsh.NamedSharding = lambda mesh, spec: spec
    try:
        return fn(*args)
    finally:
        jsh.NamedSharding = orig


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_cache_specs_match_reference(mesh):
    m = _mesh(mesh)
    batch = {"tokens": np.zeros((32, 8), np.int32),
             "frames": np.zeros((3, 5, 4), np.float32)}
    caches = {"layers": {"k": np.zeros((2, 32, 4, 64, 8)),
                         "v": np.zeros((2, 32, 4, 64, 8))},
              "mamba": [np.zeros((3, 2, 32, 16)), np.zeros((1, 5))]}
    got = sharding.batch_shardings(
        {k: torch.from_numpy(v) for k, v in batch.items()}, m)
    want = _reference_specs(jsh.batch_shardings, batch, m)
    for k, v in batch.items():
        assert got[k].spec == _padded(want[k], v.ndim), k
    got_c = sharding.cache_shardings(jax.tree.map(torch.from_numpy, caches),
                                     m, 32)
    want_c = _reference_specs(jsh.cache_shardings, caches, m, 32)
    for key in ("k", "v"):
        assert got_c["layers"][key].spec == _padded(
            want_c["layers"][key], 5), key
    for i, x in enumerate(caches["mamba"]):
        assert got_c["mamba"][i].spec == _padded(want_c["mamba"][i],
                                                 x.ndim), i


def test_local_slice_and_gather_on_one_rank():
    """A one-rank mesh needs no world: every slice is the whole tensor and
    the gather returns it."""
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    assert mesh.size("model") == 1 and mesh.index(("data", "model")) == 0
    assert mesh.group("model") is None and not context.has_model_axis()
    t = torch.arange(24.0).reshape(4, 6)
    sh = sharding.Sharding(mesh, (None, "model"))
    assert torch.equal(sharding.local_slice(t, sh), t)
    assert torch.equal(sharding.gather_full(t, sh), t)
    with context.use_mesh(mesh):
        assert context.get_mesh() is mesh
        assert context.data_axes() == ("data",)
        assert not context.has_model_axis()
    assert context.get_mesh() is None
