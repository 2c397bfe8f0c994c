"""The port's dry run (``repro_torch.launch.{specs,analysis,dryrun}``,
``launch.mesh.make_production_mesh``) against the JAX reference's.

* The abstract inputs of every (architecture x shape) cell at full width,
  bytes by dtype, against the reference's ``launch.specs`` under
  ``jax.eval_shape``.
* Every cell of ``--all --both-meshes`` laid out over a fake world of 256
  and 512 ranks: the split (10 train and 23 serving cells a mesh laid
  out, the serving ones traced at full width with their depth cut to one
  layer, a MoE model's first dense layers and one MoE layer, or one
  zamba2 group; no layout refused,
  heads that model 16 does not divide included), each cell's argument
  bytes a device at full depth equal to those the
  reference's own specs imply (its ``param_specs``, ``fix_divisibility``,
  ZeRO-2 extension, ``batch_shardings`` and ``cache_shardings`` on
  stand-in meshes), after the port's named departures, and one serving
  cell traced at full width and depth.
* The census against a real run of the same step over gloo on the CPU
  (collectives and flops equal; the peak checked by bounds), and its
  flops against the reference's ``hlo_analysis`` of the compiled cell.
"""

from __future__ import annotations

import functools
import math
import types

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs import base as jcb
from repro.distributed import sharding as jsh
from repro.launch import hlo_analysis
from repro.launch import specs as JS
from repro_torch.configs import base as cb
from repro_torch.distributed import compress, sharding
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.launch import specs as S
from repro_torch.launch.analysis import KINDS, leaves

#: stand-ins for the production meshes (the reference's sharding
#: functions read ``.shape`` and ``.axis_names``)
MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}

#: the cells the port refuses to lay out: none (heads that a model axis of
#: 16 does not divide run every head on every rank, ROADMAP fact 18)
LAYOUT_REFUSED = ()
#: where model 16 does not divide the KV heads, the port keeps the
#: self-attentions' wk / wv whole (``lm.shard``); the reference splits
#: their columns
WHOLE_KV = ("h2o-danube-1.8b", "mistral-nemo-12b", "pixtral-12b",
            "phi3-medium-14b", "whisper-tiny")

CELLS = [(arch, sh) for arch in cb.ARCH_IDS
         for sh in cb.applicable_shapes(cb.get(arch))]


def _stand_in(multi_pod: bool):
    shape = MESHES[multi_pod]
    return types.SimpleNamespace(shape=shape, axis_names=tuple(shape))


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _by_dtype(tensors) -> dict:
    out: dict = {}
    for x in tensors:
        out[_dtype(x)] = out.get(_dtype(x), 0) + \
            math.prod(x.shape) * x.dtype.itemsize
    return out


def _ref_leaves(tree) -> list:
    return jax.tree_util.tree_leaves(tree)


@functools.lru_cache(maxsize=None)
def _ref_args(arch: str, shape: str, nmc_mode: str = "none"):
    cfg = jcb.get(arch)
    if nmc_mode != "none":
        cfg = cfg.scaled(nmc_mode=nmc_mode)
    return JS.cell_fn_and_inputs(cfg, jcb.SHAPES[shape])[1]


# ---------------------------------------------------------------------------
# the config's counts and the abstract inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_active_param_count_matches_reference(arch, smoke):
    port, ref = cb.get(arch, smoke=smoke), jcb.get(arch, smoke=smoke)
    assert port.active_param_count() == ref.active_param_count()
    assert port.param_count() == ref.param_count()
    if not port.moe:
        assert port.active_param_count() == port.param_count()
    else:
        assert port.active_param_count() < port.param_count()


def _port_bytes(module) -> dict:
    return _by_dtype(leaves(module))


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_inputs_match_reference(arch):
    """Bytes by dtype of every cell's abstract arguments at full width
    against the reference cell's: training weights, the optimizer state
    and the batch (train), bf16 serving weights and the batch (prefill),
    the new tokens, the caches and their lengths (decode); and the w8a8
    serving weights."""
    cfg, jcfg = cb.get(arch), jcb.get(arch)
    for sh in cb.applicable_shapes(cfg):
        shape = cb.SHAPES[sh]
        fn, args, donate = S.cell_fn_and_inputs(cfg, shape)
        ref = _ref_args(arch, sh)
        assert donate == {"train": (0, 1), "prefill": (),
                          "decode": (2,)}[shape.kind]
        assert len(args) == len(ref)
        # the weights and moments are one tensor a layer in the port, a
        # stacked leaf in the reference: their bytes agree, the others'
        # shapes too
        weights = 2 if shape.kind == "train" else 1
        for i, (got, want) in enumerate(zip(args, ref)):
            assert all(t.device.type == "meta" for t in leaves(got))
            assert _by_dtype(leaves(got)) == _by_dtype(_ref_leaves(want)), \
                (sh, i)
            if i >= weights:
                assert sorted(tuple(t.shape) for t in leaves(got)) == \
                    sorted(tuple(x.shape) for x in _ref_leaves(want)), \
                    (sh, i)
        if shape.kind != "decode":
            batch = args[-1]
            assert {k: _dtype(x) for k, x in batch.items()} == \
                {k: str(x.dtype) for k, x in ref[-1].items()}, sh
        assert S.cache_len_for(cfg, shape.seq_len) == \
            JS.cache_len_for(jcfg, jcb.SHAPES[sh].seq_len)
    w8, jw8 = cfg.scaled(nmc_mode="w8a8"), jcfg.scaled(nmc_mode="w8a8")
    assert _by_dtype(leaves(S.abstract_params(w8, serve=True))) == \
        _by_dtype(_ref_leaves(JS.abstract_params(jw8, serve=True)))


def test_kv_int8_caches_match_reference():
    cfg = cb.get("qwen1.5-0.5b").scaled(kv_cache_dtype="int8")
    jcfg = jcb.get("qwen1.5-0.5b").scaled(kv_cache_dtype="int8")
    shape = cb.SHAPES["decode_32k"]
    assert _by_dtype(leaves(S.abstract_caches(cfg, shape))) == _by_dtype(
        _ref_leaves(JS.abstract_caches(jcfg, jcb.SHAPES["decode_32k"])))


def test_init_params_draws_as_before_on_the_cpu():
    """The meta route leaves the CPU's draws alone: no generator draws
    the seed-0 generator's numbers, as before."""
    cfg = cb.get("qwen1.5-0.5b", smoke=True)
    from repro_torch.models import lm
    a = lm.init_params(cfg, None, "cpu")
    b = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n


# ---------------------------------------------------------------------------
# production meshes and the fake world
# ---------------------------------------------------------------------------

def test_production_meshes_over_a_fake_world():
    for multi_pod, size in ((False, 256), (True, 512)):
        with dryrun.fake_world(size):
            mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
            want = tmesh.PRODUCTION[multi_pod]
            assert mesh.axis_names == want[1]
            assert tuple(mesh.shape.values()) == want[0]
            assert all(c == 0 for c in mesh.coords.values())
            assert mesh.device.type == "meta"
            ranks = {k: dist.get_process_group_ranks(g)
                     for k, g in mesh.groups.items()}
            assert ranks[("model",)] == list(range(16))
            assert ranks[("data",)] == list(range(0, 256, 16))
            if multi_pod:
                assert ranks[("pod",)] == [0, 256]
                assert ranks[("pod", "data")] == \
                    list(range(0, 256, 16)) + list(range(256, 512, 16))
        assert not dist.is_initialized()
    for multi_pod, size in ((False, 512), (True, 256), (False, 128)):
        with dryrun.fake_world(size):
            with pytest.raises(ValueError, match="ranks"):
                tmesh.make_production_mesh(multi_pod=multi_pod)
        assert not dist.is_initialized()


def test_run_cell_refuses_an_existing_world_and_always_closes_its_own():
    with dryrun.fake_world(4):
        with pytest.raises(RuntimeError, match="default process group"):
            dryrun.run_cell("qwen1.5-0.5b", "decode_32k", False)
    assert not dist.is_initialized()
    # a layout the port refuses, as the reference's shard_map fails on it:
    # MoE experts that model does not divide (deepseek-smoke's 8 on 3)
    with pytest.raises(NotImplementedError, match="8 experts over"):
        dryrun.run_cell("deepseek-v2-lite-16b", SMOKE_SHAPE, False,
                        cfg_override=cb.get("deepseek-v2-lite-16b",
                                            smoke=True),
                        mesh_shape=(1, 3))
    assert not dist.is_initialized()


def test_abstract_opt_state_matches_reference():
    assert _by_dtype(leaves(S.abstract_opt_state(cb.get("qwen1.5-0.5b")))) \
        == _by_dtype(_ref_leaves(JS.abstract_opt_state(
            jcb.get("qwen1.5-0.5b"))))


# ---------------------------------------------------------------------------
# every cell laid out: the split and the argument bytes
# ---------------------------------------------------------------------------

def _storage_bytes(tensors) -> int:
    return sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                for t in tensors}.values())


def _laid_out(arch: str, sh: str, multi_pod: bool) -> dict:
    """A cell laid out as ``run_cell`` lays it out, not traced: the bytes
    of rank 0's arguments."""
    cfg, shape = cb.get(arch), cb.SHAPES[sh]
    with dryrun.fake_world(512 if multi_pod else 256):
        mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
        _, args, _ = S.cell_fn_and_inputs(cfg, shape, local_batch=True)
        args = dryrun.lay_out(args, cfg, shape, mesh)
        return {"refused": None, "census": None,
                "mesh": dryrun.mesh_name(tuple(mesh.shape.values())),
                "n_devices": math.prod(mesh.shape.values()),
                "memory": {"argument_bytes": _storage_bytes(leaves(args)),
                           "peak_bytes": None}}


@functools.lru_cache(maxsize=None)
def _outcome(arch: str, sh: str, multi_pod: bool):
    """The cell laid out at full width and depth, not traced (its
    arguments' bytes), or the layout's refusal."""
    try:
        rec = _laid_out(arch, sh, multi_pod)
    except NotImplementedError as e:
        return str(e)
    assert not dist.is_initialized()
    return rec


def _cut_depth(arch: str) -> int:
    """The depth a serving cell is traced at in the split's test: one
    layer, a MoE model's first dense layers and one MoE layer (expert
    parallelism traced), one group of a hybrid (an xLSTM's one mLSTM
    block: its sLSTM blocks loop over every position, too slow for the
    test at 32768 and 524288)."""
    cfg = cb.get(arch)
    if cfg.family == "hybrid":
        return cfg.attn_every
    return cfg.first_dense_layers + 1 if cfg.moe else 1


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                           "2x16x16"])
def test_expected_split(multi_pod):
    """No cell's layout and no cell's step is refused: the 23 serving
    cells a mesh (prefill_32k and decode_32k of the GQA decoders, the VLM,
    the MoE models and MLA, the hybrid, the encoder-decoder and the
    xLSTM; long_500k of danube, zamba2 and the xLSTM) are traced with a
    census and a peak, at full width with the depth cut
    (:func:`_cut_depth`, for the test's time; ``launch.dryrun --all``
    traces them at full depth), and the 10 train cells are laid out."""
    refused_layout, serving, train = [], [], []
    for arch, sh in CELLS:
        out = _outcome(arch, sh, multi_pod)
        if isinstance(out, str):
            assert "over a model axis of 16" in out
            refused_layout.append((arch, sh))
        elif cb.SHAPES[sh].kind == "train":
            train.append((arch, sh))
        else:
            rec = dryrun.run_cell(arch, sh, multi_pod,
                                  n_layers=_cut_depth(arch))
            assert not dist.is_initialized()
            assert rec["refused"] is None, (arch, sh)
            c, mem = rec["census"], rec["memory"]
            assert c["flops"] > 0 and set(c["collectives"]) >= \
                {"all-reduce", "all-gather"}, (arch, sh)
            assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
            assert "ok:" in dryrun.summary(rec)
            serving.append((arch, sh))
    assert sorted(refused_layout) == sorted(
        c for c in CELLS if c[0] in LAYOUT_REFUSED)
    assert len(refused_layout) == 0
    assert sorted(serving) == sorted(
        c for c in CELLS if c[0] not in LAYOUT_REFUSED
        and cb.SHAPES[c[1]].kind != "train")
    assert len(serving) == 23
    assert len(train) == 10 and {cb.SHAPES[s].kind for _, s in train} == \
        {"train"}


def _ref_specs(fn, *args):
    """The specs the reference's ``fn`` puts into its ``NamedSharding`` s
    (which need a real mesh)."""
    orig = jsh.NamedSharding
    jsh.NamedSharding = lambda mesh, spec: spec
    try:
        return fn(*args)
    finally:
        jsh.NamedSharding = orig


def _axes(part) -> tuple:
    return () if part is None else \
        (part if isinstance(part, tuple) else (part,))


def _bytes_a_device(shape: tuple, dtype, spec, m) -> int:
    parts = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    n = 1
    for dim, part in zip(shape, parts):
        size = math.prod(m.shape[a] for a in _axes(part))
        assert dim % size == 0
        n *= dim // size
    return n * dtype.itemsize


def _leaf_paths(tree) -> list:
    return [(".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@functools.lru_cache(maxsize=None)
def _stack_dims(arch: str) -> dict:
    """{reference leaf path: its leading stack dims}, from the port's
    one-layer tensors."""
    port = dict(S.abstract_params(cb.get(arch)).named_parameters())
    stacked = sharding.stacked_shapes(port)
    return {".".join(p for p in sharding.path_of(compress.leaf_of(name))
                     if p != "*"): len(stacked[name]) - t.dim()
            for name, t in port.items()}


def _expected_params(arch: str, params, m, moments: bool) -> int:
    """Bytes a device of the reference's weights under its specs (with
    ZeRO-2 for ``moments``, each of m and v in float32), after the
    port's departures."""
    cfg = cb.get(arch)
    whole_kv = not cfg.mla and cfg.n_kv_heads % m.shape["model"]
    specs = jax.tree_util.tree_leaves(jsh.param_specs(params),
                                      is_leaf=lambda x: isinstance(x, P))
    lead = _stack_dims(arch)
    total = 0
    for (path, leaf), spec in zip(_leaf_paths(params), specs):
        shape = tuple(leaf.shape)
        key = ".".join(p for p in path.split(".") if not p.isdigit())
        if whole_kv and key.split(".")[-2] in ("wk", "wv") and \
                key.split(".")[-3] == "attn":
            spec = P()                         # departure: wk / wv whole
        spec = jsh.fix_divisibility(spec, shape, m)
        if not moments:
            total += _bytes_a_device(shape, leaf.dtype, spec, m)
            continue
        spec = tuple(jsh._extend_with_data(spec, shape, m))
        spec += (None,) * (len(shape) - len(spec))
        # departure (fact 12): data axes on a stack dim stay off a
        # one-layer port tensor
        n = lead.get(key, 0)
        spec = (None,) * n + spec[n:]
        total += 2 * _bytes_a_device(shape, jax.numpy.dtype("float32"),
                                     spec, m)
    return total


def _expected_tree(tree, specs, m) -> int:
    flat = jax.tree_util.tree_leaves(tree)
    flat_specs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    return sum(_bytes_a_device(tuple(x.shape), x.dtype, s, m)
               for x, s in zip(flat, flat_specs))


def _expected_argument_bytes(arch: str, sh: str, multi_pod: bool,
                             nmc_mode: str = "none") -> int:
    m = _stand_in(multi_pod)
    shape = jcb.SHAPES[sh]
    args = _ref_args(arch, sh, nmc_mode)
    if shape.kind == "train":
        params, _, batch = args
        return (_expected_params(arch, params, m, False)
                + _expected_params(arch, params, m, True) + 4   # step
                + _expected_tree(batch, _ref_specs(jsh.batch_shardings,
                                                   batch, m), m))
    if shape.kind == "prefill":
        params, batch = args
        return (_expected_params(arch, params, m, False)
                + _expected_tree(batch, _ref_specs(jsh.batch_shardings,
                                                   batch, m), m))
    params, tokens, caches, cache_len = args
    return (_expected_params(arch, params, m, False)
            + _expected_tree(tokens, _ref_specs(jsh.batch_shardings,
                                                tokens, m), m)
            + _expected_tree(caches, _ref_specs(
                jsh.cache_shardings, caches, m, shape.global_batch), m)
            + math.prod(cache_len.shape) * 4)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                           "2x16x16"])
def test_argument_bytes_match_reference_specs(multi_pod):
    whole_kv = set()
    for arch, sh in CELLS:
        if arch in LAYOUT_REFUSED:
            continue
        cfg = cb.get(arch)
        if not cfg.mla and cfg.family != "xlstm" and cfg.n_kv_heads % 16:
            whole_kv.add(arch)
        rec = _outcome(arch, sh, multi_pod)
        assert rec["memory"]["argument_bytes"] == \
            _expected_argument_bytes(arch, sh, multi_pod), (arch, sh)
        assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
        assert rec["n_devices"] == (512 if multi_pod else 256)
    assert sorted(whole_kv) == sorted(WHOLE_KV)


@pytest.mark.parametrize("arch,sh", [("qwen1.5-0.5b", "decode_32k"),
                                     ("mistral-nemo-12b", "prefill_32k")])
def test_w8a8_serving_argument_bytes_match_reference_specs(arch, sh):
    """The int8 serving weights (buffers) laid out by the same rules, wk /
    wv whole where model 16 does not divide the KV heads (mistral)."""
    rec = dryrun.run_cell(arch, sh, False, nmc_mode="w8a8")
    assert rec["nmc_mode"] == "w8a8" and rec["refused"] is None
    assert rec["memory"]["argument_bytes"] == \
        _expected_argument_bytes(arch, sh, False, "w8a8")


def test_one_full_width_cell_end_to_end():
    """qwen1.5-0.5b ``train_4k`` on 16x16, traced: the record's keys and
    positive quantities; no kernel is built."""
    from repro_torch import cuda_build
    built = []
    orig = cuda_build.build_all
    cuda_build.build_all = lambda: built.append(1)
    try:
        rec = dryrun.run_cell("qwen1.5-0.5b", "train_4k", False)
    finally:
        cuda_build.build_all = orig
    assert not built and not dist.is_initialized()
    assert set(rec) == {"arch", "shape", "kind", "mesh", "n_devices",
                        "nmc_mode", "tag", "trace_s", "census", "memory",
                        "refused", "params", "active_params", "tokens"}
    c, mem = rec["census"], rec["memory"]
    assert rec["refused"] is None and rec["tokens"] == 256 * 4096
    assert set(c) == {"flops", "hbm_bytes", "attn_fallback_bytes",
                      "attn_fallback_flops", "collective_link_bytes",
                      "collectives", "peak_op", "peak_by_op"}
    assert sum(c["peak_by_op"].values()) == mem["peak_bytes"]
    assert c["peak_by_op"]["arguments"] <= mem["argument_bytes"]
    assert c["flops"] > 0 and c["hbm_bytes"] > c["attn_fallback_bytes"] > 0
    assert c["flops"] > c["attn_fallback_flops"] > 0
    assert set(c["collectives"]) >= {"all-reduce", "all-gather"}
    for kind, k in c["collectives"].items():
        assert k["count"] > 0 and k["result_bytes"] > 0
        assert k["link_bytes"] == (2 if kind == "all-reduce" else 1) * \
            k["result_bytes"]
    assert c["collective_link_bytes"] == sum(
        k["link_bytes"] for k in c["collectives"].values())
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["temp_bytes"] \
        > mem["argument_bytes"] > 0
    assert mem["output_bytes"] > 0
    assert mem["argument_bytes"] == _expected_argument_bytes(
        "qwen1.5-0.5b", "train_4k", False)
    assert "ok:" in dryrun.summary(rec)


def test_full_width_decode_cell_end_to_end():
    """qwen1.5-0.5b ``decode_32k`` on 16x16 at full width and depth,
    traced: each rank's 8 rows against 2048 of the 32768 slots, the new
    token's q, k and v gathered over ``model`` in each of the 24 layers,
    the ranks' partials combined (a max and a sum) and the vocab-parallel
    logits gathered; the argument bytes those of the reference's
    specs."""
    rec = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", False)
    assert not dist.is_initialized()
    c, mem = rec["census"], rec["memory"]
    assert rec["refused"] is None and rec["tokens"] == 128
    assert mem["argument_bytes"] == _expected_argument_bytes(
        "qwen1.5-0.5b", "decode_32k", False)
    layers = cb.get("qwen1.5-0.5b").n_layers
    # per layer: q, k, v gathered; the head's logits once
    assert c["collectives"]["all-gather"]["count"] == 3 * layers + 1
    # per layer: the partials' max and sum, the row-parallel wo and MLP
    # wo; the embedding's sum over the vocabulary once
    assert c["collectives"]["all-reduce"]["count"] == 4 * layers + 1
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert c["flops"] > 0 and "ok:" in dryrun.summary(rec)


# ---------------------------------------------------------------------------
# the census against a real run and against the reference's HLO
# ---------------------------------------------------------------------------

SMOKE_SHAPE = cb.ShapeSpec("smoke", 64, 4, "train")


def test_census_equals_a_real_gloo_run():
    """Dense and MoE smoke steps on (data 1, model 2): the dry run's
    collectives (calls and bytes by kind) and flops equal those that
    ``context.traffic`` and ``FlopCounterMode`` count over rank 0 of the
    same step run for real with gloo on the CPU.  The peak: equal to the
    census of the real run (real storages, the same lifetimes), at least
    the arguments plus the float32 gradients (all live when the gradient
    function returns), at most the arguments plus every byte allocated
    in the step."""
    archs = ("qwen1.5-0.5b", "moonshot-v1-16b-a3b")
    cells = [(cb.get(a, smoke=True), SMOKE_SHAPE) for a in archs]
    real = tmesh.run_ranks(dryrun.measured_steps, 2, cells, (1, 2),
                           backend="gloo", device="cpu", timeout=240)[0]
    for arch, (cfg, _), got in zip(archs, cells, real):
        rec = dryrun.run_cell(arch, SMOKE_SHAPE, False, cfg_override=cfg,
                              mesh_shape=(1, 2))
        c = rec["census"]
        assert c["flops"] == got["flops"] > 0, arch
        want = {KINDS[op]: {"count": row[0], "result_bytes": row[3]}
                for op, row in got["traffic"].items()}
        assert {k: {"count": v["count"], "result_bytes": v["result_bytes"]}
                for k, v in c["collectives"].items()} == want, arch
        assert want["all-reduce"]["count"] > 0
        mem = rec["memory"]
        assert mem["peak_bytes"] == got["step"]["memory"]["peak_bytes"]
        local = sum(t.numel() for t in leaves(S.abstract_params(cfg))) // 2
        assert mem["peak_bytes"] >= mem["argument_bytes"] + 4 * local
        assert mem["peak_bytes"] <= mem["argument_bytes"] + \
            got["allocated_bytes"]
    assert not dist.is_initialized()


def test_remat_lowers_the_census_peak():
    """An 8-layer gradient on real CPU tensors: with remat the census's
    peak holds one layer's activations, not every layer's (a flop counter
    that tracks modules would keep the recomputed ones alive)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.analysis import Census
    from repro_torch.models import lm
    from repro_torch.train import step as step_lib
    base = cb.get("qwen1.5-0.5b", smoke=True).scaled(n_layers=8)
    tokens = torch.randint(base.vocab_size, (2, 256), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))
    peaks = {}
    for remat in (False, True):
        cfg = base.scaled(remat=remat)
        model = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        census = Census((model, tokens))
        with ops.force_plain(), census:
            step_lib.grads_of(step_lib.make_loss(cfg), model,
                              {"tokens": tokens})
        peaks[remat] = census.peak_bytes
    assert peaks[True] < 0.5 * peaks[False], peaks


def _reference_flops(arch: str, kind: str, seq: int, rows: int) -> float:
    cfg = jcb.get(arch, smoke=True)
    fn, args, _ = JS.cell_fn_and_inputs(cfg, jcb.ShapeSpec("t", seq, rows,
                                                           kind))
    return hlo_analysis.analyze(
        jax.jit(fn).lower(*args).compile().as_text())["flops"]


def _recompute_flops(cfg, rows: int, seq: int) -> int:
    """The products the port's attention backward does beyond autodiff's:
    ``attention_backward`` recomputes the forward (Q K^T and P V) and
    forms Q K^T once more, per attention call."""
    b_h_s = rows * cfg.n_heads * seq
    d = dv = cfg.head_dim
    fwd = 2 * b_h_s * seq * (d + dv)
    per_call = fwd + 2 * b_h_s * seq * d
    calls = cfg.n_layers if cfg.family != "hybrid" else \
        cfg.n_layers // cfg.attn_every
    return calls * per_call if cfg.family != "xlstm" else 0


@pytest.mark.parametrize("arch,kind,seq", [
    ("qwen1.5-0.5b", "train", 1024), ("moonshot-v1-16b-a3b", "train", 1024),
    ("zamba2-2.7b", "train", 1024), ("xlstm-125m", "train", 64),
    ("qwen1.5-0.5b", "prefill", 1024)])
def test_flops_match_reference_hlo(arch, kind, seq):
    """One rank, remat off (the smoke configs): the census's flops within
    1% of the reference's ``hlo_analysis`` of the compiled cell, after the
    closed-form recompute term of the port's attention backward (no term
    at prefill; at 1024 positions no key padding in the reference's
    chunks)."""
    cfg = cb.get(arch, smoke=True)
    assert not cfg.remat
    rows = 2
    rec = dryrun.run_cell(arch, cb.ShapeSpec("t", seq, rows, kind), False,
                          cfg_override=cfg, mesh_shape=(1, 1))
    want = _reference_flops(arch, kind, seq, rows)
    extra = _recompute_flops(cfg, rows, seq) if kind == "train" else 0
    got = rec["census"]["flops"] - extra
    assert abs(got - want) <= 0.01 * want, (got, want, extra)
