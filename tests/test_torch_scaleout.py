"""The port's scale-out (``repro_torch.{distributed,launch,runtime}`` and
the mesh-aware train step) against the JAX reference on the CPU: ranks
spawned by ``launch.mesh.run_ranks`` over gloo, smoke configs in float32.

One spawn per world size runs every check of its meshes
(``distributed.checks.sequence``): two ranks for the (1, 2) and (2, 1)
meshes, one head over model 2 (attention, MLA, Mamba2, xLSTM), the
hybrid's data parallelism, the xLSTM over several chunks, at full depth and with a
row-parallel FFN, whisper with an odd vocabulary and the elastic
reshard; four for (2, 2), (1, 4) (with heads that model 4 does not
divide: :data:`VARIANTS`) and the 4-stage pipeline; both for the
backward of ``context.gather_to_heads``.  Each spawn is joined within a
timeout.  The reference runs in this process on one device, except its
own runs on four fake devices (2 x 2: the MoE models, moonshot's GQA and
deepseek's MLA; qwen and moonshot with sequence parallelism and
activation checkpointing; qwen's masked loss in two microbatches; 1 x 4:
the heads model 4 does not divide), in one subprocess.

Sequence parallelism (``seq_parallel`` with ``remat``) runs as further
cases of the same worlds: each case against the same mesh's step
without it and against the reference, its traffic with reduce-scatters
and its split norm gains summed over ``model``; where it cannot split (a
sequence ``model`` does not divide, the encoder-decoder, the xLSTM) the
step without it.  The masked loss over a data split against the
single-rank masked step and the reference's.

Tolerances: those of ``tests/test_torch_train.py`` (loss ``rtol 1e-5``;
gradients ``rtol 1e-4`` with an ``atol`` of ``1e-5`` of the tensor's
largest; one step from a mid-run optimizer state, params / ``m`` / ``v``
``rtol 1e-5`` / ``atol 1e-6``; with compression, the reference's own
compression and AdamW applied to the gathered gradients: the error state
bit for bit, the rest ``rtol 1e-6`` / ``atol 1e-8``), and every gathered
gradient against the port's single-rank run at the gradients' tolerance.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import base as jcb
from repro.distributed import compress as jgc
from repro.distributed.pipeline import bubble_fraction as jbubble
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as cb
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import checks
from repro_torch.distributed.pipeline import bubble_fraction
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime.elastic import (HeartbeatMonitor, MembershipWatcher,
                                         make_mesh_for)
from repro_torch.train import step as tstep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: smoke configs drawn at other widths, by name: (architecture, knobs).
#: Model 4 does not divide their heads (ROADMAP fact 18): whisper-smoke
#: with 6 heads of 16 (1.5 a rank), xlstm-smoke with 2 heads (half a head
#: a rank, as xlstm-125m on model 16), phi3-smoke with 6 query and 2 KV
#: heads of 16 (whole ``wk`` / ``wv``, 1.5 query heads a rank); model 2
#: does not divide the single head of the ``-1h`` ones (deepseek-smoke's
#: one MLA head: ``wq``'s 24 columns split through its nope part, and
#: with a value dim of 15 ``w_uv`` and ``wo`` whole, as deepseek-v2-lite's
#: on model 3; zamba2-smoke's one SSM head of 128)
VARIANTS = {
    "whisper-6h": ("whisper-tiny", dict(d_model=96, n_heads=6,
                                        n_kv_heads=6)),
    "xlstm-2h": ("xlstm-125m", dict(n_heads=2, n_kv_heads=2)),
    "phi3-6h": ("phi3-medium-14b", dict(d_model=96, n_heads=6, n_kv_heads=2,
                                        head_dim=16)),
    "xlstm-1h": ("xlstm-125m", dict(n_heads=1, n_kv_heads=1)),
    "whisper-1h": ("whisper-tiny", dict(n_heads=1, n_kv_heads=1)),
    "pixtral-1h": ("pixtral-12b", dict(n_heads=1, n_kv_heads=1)),
    "deepseek-1h": ("deepseek-v2-lite-16b", dict(n_heads=1, n_kv_heads=1)),
    "deepseek-1h-dv15": ("deepseek-v2-lite-16b",
                         dict(n_heads=1, n_kv_heads=1, v_head_dim=15)),
    "zamba2-1h": ("zamba2-2.7b", dict(ssm_head_dim=128))}
ARCHS = {"qwen": "qwen1.5-0.5b", "moonshot": "moonshot-v1-16b-a3b",
         "deepseek": "deepseek-v2-lite-16b", "zamba2": "zamba2-2.7b",
         "xlstm": "xlstm-125m", "whisper": "whisper-tiny",
         "pixtral": "pixtral-12b"} | {v: v for v in VARIANTS}
#: the MoE models, whose (2, 2) step follows the reference's own 2 x 2 run
MOE_ARCHS = ("moonshot", "deepseek")
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-5
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
ROWS, SEQ = 4, 16
#: zamba2-smoke's 4 SSD chunks of 16, xlstm-smoke's 4 mLSTM chunks (the
#: other cases run one chunk)
CHUNKS_SEQ = 64
SPAWN_TIMEOUT = 240.0

#: (arch, mesh shape, microbatches, compression) of the two-rank world
STEPS_2 = [("qwen", (1, 2), 1, False), ("qwen", (2, 1), 1, False),
           ("moonshot", (1, 2), 1, False), ("moonshot", (2, 1), 1, False),
           ("qwen", (2, 1), 2, False), ("moonshot", (2, 1), 2, False),
           ("qwen", (2, 1), 1, True), ("moonshot", (2, 1), 1, True),
           ("qwen", (1, 2), 1, True), ("deepseek", (1, 2), 1, False),
           ("zamba2", (1, 2), 1, False), ("xlstm", (1, 2), 1, False),
           ("whisper", (1, 2), 1, False), ("pixtral", (1, 2), 1, False)]
#: of the four-rank world; model 4 is the reference's own model size
#: (deepseek-smoke: 4 heads, 8 experts; zamba2-smoke: 8 SSM heads, 4
#: attention heads; xlstm-smoke: 4 heads, its sLSTM FFN whole;
#: pixtral-smoke: 2 KV heads, so wk / wv whole)
STEPS_4 = [("qwen", (2, 2), 1, False), ("moonshot", (2, 2), 1, False),
           ("deepseek", (2, 2), 1, False), ("zamba2", (2, 2), 1, False),
           ("deepseek", (1, 4), 1, False), ("zamba2", (1, 4), 1, False),
           ("xlstm", (1, 4), 1, False), ("whisper", (2, 2), 1, False),
           ("pixtral", (1, 4), 1, False)] + \
    [(v, (1, 4), 1, False) for v in ("whisper-6h", "xlstm-2h", "phi3-6h")]
#: one smoke config of each family whose single head (an MLA head, a
#: Mamba2 SSM head) a model axis of 2 does not divide: each rank runs
#: every head
HEADS_REFUSED = {"xlstm-125m": "xlstm-1h", "whisper-tiny": "whisper-1h",
                 "pixtral-12b": "pixtral-1h",
                 "deepseek-v2-lite-16b": "deepseek-1h",
                 "deepseek-whole-wo": "deepseek-1h-dv15",
                 "zamba2-2.7b": "zamba2-1h"}
#: the cases where the port's single rank itself is not within the
#: gradients' tolerance of the reference's single-device step on a few
#: elements, with the most such elements: zamba2-1h's Mamba2 ``D``, one
#: element per layer summing the one SSM head's 4 x 16 x 128 terms, which
#: cancel to ~1e-4 (``mamba.1.1.D``: 7.2 times the tolerance from the
#: reference on this CPU, the sharded step 0.65 times it from the single
#: rank).  Such an element is held to the single rank, every other one
#: to both.
ILL_CONDITIONED = {"zamba2-1h": 2}
#: xlstm-smoke with d_f = 128, so that its sLSTM FFN's ``down`` is
#: row-parallel on model 2 (at d_f 85 it stays whole)
XLSTM_EVEN_FFN = dict(proj_factor_slstm=2.0)
#: xlstm-smoke at xlstm-125m's depth and block pattern, 8 mLSTM chunks a row
XLSTM_DEEP, XLSTM_DEEP_SEQ = dict(n_layers=12, slstm_layers=(3, 9)), 128
#: sequence parallelism with activation checkpointing
SP = dict(seq_parallel=True, remat=True)
#: the sequence-parallel cases (arch, mesh shape); those on (2, 2) follow
#: the reference's own 2 x 2 run with the same knobs
SP_CASES = [("qwen", (1, 2)), ("moonshot", (1, 2)), ("deepseek", (1, 2)),
            ("zamba2", (1, 2)), ("pixtral", (1, 2)), ("qwen", (2, 2)),
            ("moonshot", (2, 2))]
#: where sequence parallelism cannot split: 15 tokens on model 2, and the
#: families whose stream it leaves whole
SP_WHOLE = ["qwen-15", "whisper", "xlstm"]
SP_SEQ_ODD = 15
#: each row's share of kept targets in the masked batch: the kept counts
#: differ between the data ranks and between the microbatches
MASK_KEEP = (0.9, 0.3, 0.6, 0.15)
MASK_SHAPES = [(2, 1), (2, 2)]


def _cfgs(arch: str, **kw) -> tuple:
    """(reference, port) smoke configs in float32 of an architecture or a
    :data:`VARIANTS` name."""
    arch, widths = VARIANTS.get(arch, (arch, {}))
    kw = widths | kw
    return (jcb.get(arch, smoke=True).scaled(dtype=jnp.float32, **kw),
            cb.get(arch, smoke=True).scaled(dtype=torch.float32, **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _weights(arch: str):
    return jlm.init_params(jax.random.PRNGKey(0), _cfgs(arch)[0])


def _named(tree, tcfg) -> dict:
    """A reference tree shaped as the params under the port's names
    (numpy)."""
    model = params_from_jax(_np(tree), tcfg, "cpu")
    return {n: t.detach().numpy() for n, t in model.named_parameters()}


def _dense_tree(named: dict, like) -> dict:
    """The port's {name: array} as the reference's tree (``layers``
    stacked on axis 0)."""
    n_layers = len(like["layers"]["ln1"]["g"])

    def leaf(path, _):
        keys = [p.key for p in path]
        if keys[0] == "layers":
            rest = ".".join(keys[1:])
            return jnp.asarray(np.stack([named[f"layers.{i}.{rest}"]
                                         for i in range(n_layers)]))
        return jnp.asarray(named[".".join(keys)])
    return jax.tree_util.tree_map_with_path(leaf, like)


@functools.lru_cache(maxsize=None)
def _opt_state(arch: str, compress: bool):
    """A mid-run optimizer state (the reference's tree): nonzero moments,
    step 2 (numpy-seeded), as ``test_torch_train.py``'s."""
    rng = np.random.default_rng(7)

    def draw(scale, square=False):
        def one(p):
            x = rng.normal(size=p.shape).astype(np.float32) * scale
            return jnp.asarray(x * x + 1e-4 if square else x)
        return jax.tree.map(one, _weights(arch))
    state = {"m": draw(1e-2), "v": draw(1e-2, square=True),
             "step": jnp.asarray(2, jnp.int32)}
    if compress:
        state["grad_err"] = draw(1e-4)
    return state


def _port_state(arch: str, compress: bool) -> dict:
    tcfg = _cfgs(arch)[1]
    st = _opt_state(arch, compress)
    out = {k: _named(st[k], tcfg) for k in st if k != "step"}
    out["step"] = int(st["step"])
    return out


def _batch(arch: str, mask: bool = False) -> dict:
    data = tpipe.SyntheticLM(tpipe.DataConfig(global_batch=ROWS,
                                              seq_len=SEQ, seed=3),
                             _cfgs(arch)[1])
    b = data.batch_at(1)
    if mask:
        rng = np.random.default_rng(11)
        keep = np.array(MASK_KEEP)[:, None]
        b["mask"] = (rng.random(b["tokens"].shape) < keep).astype(np.int32)
    return b


@functools.lru_cache(maxsize=None)
def _reference(arch: str, n_mb: int, mask: bool = False) -> dict:
    """The reference's single-device step: its gradients (per microbatch
    ``value_and_grad``, summed and divided), metrics, params and moments,
    under the port's names."""
    jcfg, tcfg = _cfgs(arch)
    jp = _weights(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(arch, mask).items()}
    vg = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(p, b, jcfg),
                                    has_aux=True))
    rows = ROWS // n_mb
    total = None
    for i in range(n_mb):
        _, g = vg(jp, {k: v[i * rows:(i + 1) * rows]
                       for k, v in batch.items()})
        total = g if total is None else jax.tree.map(jnp.add, total, g)
    grads = jax.tree.map(lambda x: x / n_mb, total)
    new, st, met = jax.jit(jstep.make_train_step(
        jcfg, jadamw.AdamWConfig(**OPT), n_mb))(
            jp, _opt_state(arch, False), batch)
    return {"grads": _named(grads, tcfg), "params": _named(new, tcfg),
            "m": _named(st["m"], tcfg), "v": _named(st["v"], tcfg),
            "metrics": {k: float(v) for k, v in met.items()}}


@functools.lru_cache(maxsize=None)
def _single(arch: str, n_mb: int, compress: bool, mask: bool = False
            ) -> dict:
    """The port's single-rank step on the same state: its gradients."""
    _, tcfg = _cfgs(arch)
    model = params_from_jax(_np(_weights(arch)), tcfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(arch, mask).items()}
    _, _, g = tstep.accumulated_grads(tstep.make_loss(tcfg), model, tb, n_mb)
    return {n: t.numpy() for n, t in g.items()}


def _assert_close_grads(got: dict, want: dict, what: str,
                        single: dict | None = None, most: int = 0):
    """``got`` within the gradients' tolerance of ``want``; with
    ``single`` (the port's single rank, which ``got`` is held to as well)
    the elements where ``single`` itself is not within it of ``want`` are
    left out, at most ``most`` of them (:data:`ILL_CONDITIONED`)."""
    assert sorted(got) == sorted(want)
    left_out = 0
    for name, w in want.items():
        atol = GRAD_ATOL_SCALE * float(np.abs(w).max()) + 1e-12
        g = got[name]
        if single is not None:
            apart = np.abs(single[name] - w) > atol + GRAD_RTOL * np.abs(w)
            left_out += int(apart.sum())
            g, w = g[~apart], w[~apart]
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=f"{what} {name}")
    assert left_out <= most, (what, left_out)


def _step_call(key, shape, n_mb, compress, mask: bool = False,
               **kw) -> tuple:
    arch = ARCHS[key]
    return ("sharded_step", (_cfgs(arch, **kw)[1], shape,
                             _np(_weights(arch)), _port_state(arch, compress),
                             _batch(arch, mask), OPT, n_mb, compress))


def _spawn(world: int, calls: dict) -> dict:
    results = run_ranks(checks.sequence, world, list(calls.values()),
                        backend="gloo", device="cpu",
                        timeout=SPAWN_TIMEOUT, collective_timeout=120.0)
    return dict(zip(calls, results[0]))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    ckdir = str(tmp_path_factory.mktemp("elastic") / "ck")
    calls = {case: _step_call(*case) for case in STEPS_2}
    for arch, variant in HEADS_REFUSED.items():
        calls[("one head", arch)] = _step_call(variant, (1, 2), 1, False)
    calls["gather_to_heads"] = ("gather_to_heads_check", ())
    calls["zamba2"] = _step_call_dp_or_kv("zamba2-2.7b", (2, 1))
    calls["kv1"] = _step_call_dp_or_kv("qwen1.5-0.5b", (1, 2), n_kv_heads=1)
    calls["zamba2_chunks"] = _step_call_dp_or_kv("zamba2-2.7b", (1, 2),
                                                 seq=CHUNKS_SEQ)
    calls["xlstm_chunks"] = _step_call_dp_or_kv("xlstm-125m", (1, 2),
                                                seq=CHUNKS_SEQ)
    calls["xlstm_even_ffn"] = _step_call_dp_or_kv("xlstm-125m", (1, 2),
                                                  **XLSTM_EVEN_FFN)
    calls["xlstm_deep"] = _step_call_dp_or_kv("xlstm-125m", (1, 2),
                                              XLSTM_DEEP_SEQ, **XLSTM_DEEP)
    calls["whisper_odd_vocab"] = _step_call_dp_or_kv("whisper-tiny", (1, 2),
                                                     vocab_size=255)
    for key, shape in SP_CASES:
        if shape == (1, 2):
            calls[("sp", key, shape)] = _step_call(key, shape, 1, False, **SP)
    calls[("sp", "qwen-15")] = _step_call_dp_or_kv(
        "qwen1.5-0.5b", (1, 2), SP_SEQ_ODD, **SP)
    for key in ("whisper", "xlstm"):
        calls[("sp", key)] = _step_call(key, (1, 2), 1, False, **SP)
    calls[("mask", (2, 1))] = _step_call("qwen", (2, 1), 2, False, mask=True)
    calls["elastic"] = ("elastic_check", (
        _cfgs("qwen1.5-0.5b")[1],
        dict(total_steps=4, ckpt_every=2, log_every=100, ckpt_dir=ckdir),
        dict(global_batch=4, seq_len=16), OPT, 3, (1, 2), 1))
    out = _spawn(2, calls)
    out["ckdir"] = ckdir
    return out


def _single_rank_case(arch: str, seq: int = SEQ, **kw) -> tuple:
    """(port config, reference weights, batch of ``seq`` tokens a row) of
    a config held to the port's single-rank run only."""
    jcfg, tcfg = _cfgs(arch, **kw)
    w = _np(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    data = tpipe.SyntheticLM(tpipe.DataConfig(global_batch=ROWS,
                                              seq_len=seq, seed=3), tcfg)
    return tcfg, w, data.batch_at(1)


def _step_call_dp_or_kv(arch: str, shape: tuple, seq: int = SEQ,
                        **kw) -> tuple:
    tcfg, w, batch = _single_rank_case(arch, seq, **kw)
    model = params_from_jax(w, tcfg, "cpu")
    zeros = {n: np.zeros(p.shape, np.float32)
             for n, p in model.named_parameters()}
    state = {"m": zeros, "v": dict(zeros), "step": 0}
    return ("sharded_step", (tcfg, shape, w, state, batch, OPT, 1, False))


def _single_rank_grads(arch: str, seq: int = SEQ, **kw) -> tuple:
    tcfg, w, batch = _single_rank_case(arch, seq, **kw)
    model = params_from_jax(w, tcfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _, g = tstep.accumulated_grads(tstep.make_loss(tcfg), model, tb)
    return float(loss), {n: t.numpy() for n, t in g.items()}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    rng = np.random.default_rng(0)
    n_stages, n_micro, b, d = 4, 8, 16, 32
    stages = [{"w": (rng.normal(size=(d, d)) * 0.3).astype(np.float32),
               "b": rng.normal(size=(d,)).astype(np.float32)}
              for _ in range(n_stages)]
    x = rng.normal(size=(b, d)).astype(np.float32)
    calls = {case: _step_call(*case) for case in STEPS_4}
    for key, shape in SP_CASES:
        if shape == (2, 2):
            calls[("sp", key, shape)] = _step_call(key, shape, 1, False, **SP)
    calls[("mask", (2, 2))] = _step_call("qwen", (2, 2), 2, False, mask=True)
    calls["pipeline"] = ("pipeline_check",
                         (checks.tanh_stage, stages, x, n_micro))
    calls["gather_to_heads"] = ("gather_to_heads_check", ())
    return _spawn(4, calls)


def _result(world2, world4, case) -> dict:
    return (world4 if case in STEPS_4 else world2)[case]


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [c for c in STEPS_2 + STEPS_4
                                  if not (c[0] in MOE_ARCHS
                                          and c[1] == (2, 2))],
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}-mb{c[2]}"
                         f"{'-int8' if c[3] else ''}")
def test_sharded_step_matches_reference(world2, world4, case):
    arch, shape, n_mb, compress = case
    _assert_step_matches(_result(world2, world4, case), arch, n_mb, compress)


def _assert_step_matches(got: dict, arch: str, n_mb: int, compress: bool):
    """A sharded step against the reference's single-device step and the
    port's single rank: gradients, metrics, the updated params and
    moments (compressed: the reference's compression and AdamW on the
    gathered gradients)."""
    ref = _reference(ARCHS[arch], n_mb)
    single = _single(ARCHS[arch], n_mb, compress)
    _assert_close_grads(got["grads"], single, "single rank")
    most = ILL_CONDITIONED.get(arch, 0)
    _assert_close_grads(got["grads"], ref["grads"], "reference",
                        single if most else None, most)
    assert sorted(got["metrics"]) == sorted(ref["metrics"])
    for key in ("loss", "nll", "aux", "lr") + (() if compress
                                                else ("grad_norm",)):
        np.testing.assert_allclose(got["metrics"][key], ref["metrics"][key],
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert got["step"] == 3
    if not compress:
        for key in ("params", "m", "v"):
            for n, w in ref[key].items():
                np.testing.assert_allclose(got[key][n], w, **STEP_TOL,
                                           err_msg=f"{key} {n}")
        return
    # the reference's compression and AdamW on the gathered gradients
    jp = _weights(ARCHS[arch])
    jst = _opt_state(ARCHS[arch], True)
    tcfg = _cfgs(ARCHS[arch])[1]
    cg, err = jgc.compress_tree(_dense_tree(got["grads"], jp),
                                jst["grad_err"])
    core = {k: jst[k] for k in ("m", "v", "step")}
    wp, wst, wmet = jadamw.apply_updates(jp, jgc.decompress_tree(cg), core,
                                         jadamw.AdamWConfig(**OPT))
    np.testing.assert_allclose(got["metrics"]["grad_norm"],
                               float(wmet["grad_norm"]), rtol=1e-6)
    for key, want in (("params", wp), ("m", wst["m"]), ("v", wst["v"]),
                      ("grad_err", err)):
        for n, w in _named(want, tcfg).items():
            if key == "grad_err":
                assert np.array_equal(got[key][n], w), n
            else:
                np.testing.assert_allclose(got[key][n], w, rtol=1e-6,
                                           atol=1e-8, err_msg=f"{key} {n}")


def test_layout_of_the_steps(world2):
    """ZeRO-2 on (2, 1): each moment is half the parameter along its data
    dim, but where the reference puts the data axis on its leaf's stack
    dim (the stacked q/k/v biases, (2, 64): the layer axis is the only
    free one, ``model`` holding the other), which a port tensor lacks, so
    that moment stays whole.  On a model axis only the MoE router is
    summed over it."""
    q21 = world2[("qwen", (2, 1), 1, False)]
    full = dict(lm.init_params(_cfgs("qwen1.5-0.5b")[1], torch.Generator(),
                               "meta").named_parameters())
    whole = sorted(n for n, s in q21["local_m"].items()
                   if s == tuple(full[n].shape))
    assert whole == sorted(f"layers.{i}.attn.{w}.b" for i in range(2)
                           for w in ("wq", "wk", "wv"))
    for n, s in q21["local_m"].items():
        if n not in whole:
            assert 2 * int(np.prod(s)) == full[n].numel(), n
    assert world2[("qwen", (1, 2), 1, False)]["partial"] == []
    moe = world2[("moonshot", (1, 2), 1, False)]["partial"]
    assert moe and all(".moe.router." in n for n in moe)


#: the reference's own runs on a (data, model) mesh of 4 fake devices:
#: name -> (arch key, config knobs, microbatches, masked, mesh), 2 x 2 but
#: for the heads that model 4 does not divide, on 1 x 4
REF_2X2 = {"moonshot": ("moonshot", {}, 1, False, (2, 2)),
           "deepseek": ("deepseek", {}, 1, False, (2, 2)),
           "qwen-sp": ("qwen", SP, 1, False, (2, 2)),
           "moonshot-sp": ("moonshot", SP, 1, False, (2, 2)),
           "qwen-mask": ("qwen", {}, 2, True, (2, 2))} | \
    {v: (v, {}, 1, False, (1, 4)) for v in ("whisper-6h", "xlstm-2h",
                                            "phi3-6h")}


@pytest.fixture(scope="module")
def reference_2x2(tmp_path_factory):
    """The reference's own train step on a mesh of 4 fake devices, from
    the same state and batch, of each run of :data:`REF_2X2` (one
    subprocess for all): {name: its results}."""
    tmp = tmp_path_factory.mktemp("ref2x2")
    specs = []
    for name, (key, kw, n_mb, mask, shape) in REF_2X2.items():
        arch = ARCHS[key]
        state = _np(_opt_state(arch, False))
        batch = _batch(arch, mask)
        np.savez(tmp / f"in_{name}.npz", **batch,
                 **{f"{k}/{jax.tree_util.keystr(p)}": v
                    for k in ("m", "v")
                    for p, v in jax.tree_util.tree_flatten_with_path(
                        state[k])[0]})
        base, widths = VARIANTS.get(arch, (arch, {}))
        specs.append(json.dumps(dict(name=name, arch=base, kw=widths | kw,
                                     n_mb=n_mb, mesh=shape)))
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_2X2, str(tmp),
                          json.dumps(OPT)] + specs,
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    results = {}
    for name, (key, *_) in REF_2X2.items():
        arch = ARCHS[key]
        res = np.load(tmp / f"out_{name}.npz")
        tcfg = _cfgs(arch)[1]
        like = _weights(arch)

        def tree(prefix):
            return jax.tree_util.tree_map_with_path(
                lambda p, _: res[f"{prefix}/{jax.tree_util.keystr(p)}"],
                like)
        results[name] = {"grads": _named(tree("grads"), tcfg),
                        "params": _named(tree("params"), tcfg),
                        "m": _named(tree("m"), tcfg),
                        "v": _named(tree("v"), tcfg),
                        "metrics": json.loads(str(res["metrics"]))}
    return results


_REF_2X2 = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    sys.path.insert(0, "src")
    from repro.configs import base as cb
    from repro.distributed import context, sharding
    from repro.launch.mesh import make_mesh
    from repro.models import lm
    from repro.optim import adamw
    from repro.train import step as step_lib

    tmp, opt = sys.argv[1], json.loads(sys.argv[2])
    key = jax.tree_util.keystr
    for item in sys.argv[3:]:
        spec = json.loads(item)
        name, n_mb = spec["name"], spec["n_mb"]
        mesh = make_mesh(np.array(jax.devices()).reshape(spec["mesh"]),
                         ("data", "model"))
        cfg = cb.get(spec["arch"], smoke=True).scaled(dtype=jnp.float32,
                                                      **spec["kw"])
        inp = np.load(os.path.join(tmp, f"in_{name}.npz"))
        params = lm.init_params(jax.random.PRNGKey(0), cfg)
        state = {k: jax.tree_util.tree_map_with_path(
            lambda p, _: jnp.asarray(inp[f"{k}/{key(p)}"]), params)
            for k in ("m", "v")}
        state["step"] = jnp.asarray(2, jnp.int32)
        batch = {k: jnp.asarray(inp[k]) for k in ("tokens", "mask",
                                                  "frames") if k in inp}
        rows = batch["tokens"].shape[0] // n_mb
        with context.use_mesh(mesh):
            ps = jax.device_put(params,
                                sharding.param_shardings(params, mesh))
            vg = jax.jit(jax.value_and_grad(
                lambda p, b: lm.loss_fn(p, b, cfg), has_aux=True))
            grads = None
            for i in range(n_mb):
                _, g = vg(ps, {k: v[i * rows:(i + 1) * rows]
                               for k, v in batch.items()})
                grads = g if grads is None else jax.tree.map(jnp.add,
                                                             grads, g)
            grads = jax.tree.map(lambda x: x / n_mb, grads)
            new, st, met = jax.jit(step_lib.make_train_step(
                cfg, adamw.AdamWConfig(**opt), n_mb))(ps, state, batch)
        out = {"metrics": json.dumps({k: float(v) for k, v in met.items()})}
        for label, t in (("grads", grads), ("params", new), ("m", st["m"]),
                         ("v", st["v"])):
            for p, v in jax.tree_util.tree_flatten_with_path(t)[0]:
                out[f"{label}/{key(p)}"] = np.asarray(v)
        np.savez(os.path.join(tmp, f"out_{name}.npz"), **out)
""")


def _follows_the_reference_2x2(world4, reference_2x2, key):
    got, ref = world4[(key, (2, 2), 1, False)], reference_2x2[key]
    _assert_close_grads(got["grads"], ref["grads"], "reference 2x2")
    for k in ("loss", "nll", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    single = _reference(ARCHS[key], 1)["metrics"]
    assert abs(got["metrics"]["aux"] - single["aux"]) > 1e-3
    for k in ("params", "m", "v"):
        for n, w in ref[k].items():
            np.testing.assert_allclose(got[k][n], w, **STEP_TOL,
                                       err_msg=f"{k} {n}")


def test_moe_on_2x2_follows_the_reference_2x2_run(world4, reference_2x2):
    """On (2, 2) the capacity, the drops and ``aux`` come from each data
    shard's tokens: the gradient is the mean of each shard's own, the
    reported ``aux`` data shard 0's (the reference's own 2 x 2 run, not
    its single-device step)."""
    _follows_the_reference_2x2(world4, reference_2x2, "moonshot")


def test_mla_moe_on_2x2_follows_the_reference_2x2_run(world4,
                                                      reference_2x2):
    """deepseek-smoke on (2, 2): MLA on local heads and the expert-parallel
    MoE, each data shard routed alone, as the reference's own 2 x 2 run."""
    _follows_the_reference_2x2(world4, reference_2x2, "deepseek")


# ---------------------------------------------------------------------------
# sequence parallelism and the masked loss over a data split
# ---------------------------------------------------------------------------

def _assert_same_step(got: dict, want: dict, what: str):
    _assert_close_grads(got["grads"], want["grads"], what)
    for k in ("loss", "nll", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=1e-5, atol=1e-7,
                                   err_msg=f"{what} {k}")
    for k in ("params", "m", "v"):
        for n, w in want[k].items():
            np.testing.assert_allclose(got[k][n], w, **STEP_TOL,
                                       err_msg=f"{what} {k} {n}")


def _split_norms(names) -> set:
    """The norm gains that act on this rank's rows of a split stream: every
    decoder block's ``ln1`` / ``ln2`` and ``final_norm``, or the hybrid's
    shared block's two."""
    names = set(names)
    if "shared_attn.ln1.g" in names:
        return {"shared_attn.ln1.g", "shared_attn.ln2.g"}
    return {n for n in names if n.endswith((".ln1.g", ".ln2.g"))} | \
        {"final_norm.g"}


@pytest.mark.parametrize("case", SP_CASES,
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}")
def test_sequence_parallel_step(world2, world4, reference_2x2, case):
    """``seq_parallel`` with ``remat``: the same mesh's step without them
    (loss, gradients, the updated state) and the reference's (its
    single-device step on (1, 2), its own 2 x 2 run with the same knobs on
    (2, 2)); reduce-scatters in the gradient's traffic, none without it;
    the split norm gains summed over ``model`` beside the step's other
    partial gradients."""
    key, shape = case
    world = world4 if shape == (2, 2) else world2
    got, tp = world[("sp", key, shape)], world[(key, shape, 1, False)]
    _assert_same_step(got, tp, "TP step")
    if shape == (2, 2):
        _assert_same_step(got, reference_2x2[f"{key}-sp"], "reference 2x2")
    else:
        _assert_same_step(got, _reference(ARCHS[key], 1), "reference")
    assert got["traffic"]["reduce_scatter"][0] > 0
    assert "reduce_scatter" not in tp["traffic"]
    assert set(got["partial"]) == set(tp["partial"]) | \
        _split_norms(got["grads"])
    assert got["partial_now"] == got["partial"]


@pytest.mark.parametrize("case", SP_WHOLE)
def test_sequence_parallel_without_a_split(world2, case):
    """Where ``shard_seq`` is a no-op (15 tokens on a model axis of 2; the
    encoder-decoder and the xLSTM, whose stream the reference never
    splits) the step with ``seq_parallel`` and ``remat`` runs no
    reduce-scatter and is the step without them."""
    got = world2[("sp", case)]
    assert "reduce_scatter" not in got["traffic"]
    if case == "qwen-15":
        loss, grads = _single_rank_grads("qwen1.5-0.5b", SP_SEQ_ODD)
        _assert_close_grads(got["grads"], grads, "single rank")
        np.testing.assert_allclose(got["metrics"]["loss"], loss, rtol=1e-5)
        # the norm gains would be partial had the stream been split
        assert set(got["partial"]) == _split_norms(got["grads"])
        assert got["partial_now"] == []
        return
    tp = world2[(case, (1, 2), 1, False)]
    _assert_same_step(got, tp, "TP step")
    _assert_same_step(got, _reference(ARCHS[case], 1), "reference")
    assert got["partial"] == got["partial_now"] == tp["partial"]


@pytest.mark.parametrize("shape", MASK_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_masked_loss_over_a_data_split(world2, world4, reference_2x2,
                                       shape):
    """qwen-smoke with a target mask in 2 microbatches over 2 data ranks,
    the kept counts differing between the ranks and the microbatches:
    each microbatch's loss is the global masked mean, so the loss, ``nll``
    and gradients are the single-rank masked step's and the reference's
    (its single-device step, and on (2, 2) its own 2 x 2 run)."""
    mask = _batch(ARCHS["qwen"], mask=True)["mask"][:, 1:]
    counts = mask.reshape(2, 2, -1).sum(axis=-1)     # (microbatch, rank)
    assert len(set(counts.ravel().tolist())) == counts.size
    got = (world4 if shape == (2, 2) else world2)[("mask", shape)]
    _assert_close_grads(got["grads"], _single(ARCHS["qwen"], 2, False, True),
                        "single rank")
    _assert_same_step(got, _reference(ARCHS["qwen"], 2, True), "reference")
    if shape == (2, 2):
        _assert_same_step(got, reference_2x2["qwen-mask"], "reference 2x2")


# ---------------------------------------------------------------------------
# families, pipeline, elastic
# ---------------------------------------------------------------------------

def test_hybrid_data_parallel_matches_single_rank(world2):
    """zamba2-smoke on (2, 1): its gradients the port's single-rank ones,
    its loss the single-rank loss."""
    got = world2["zamba2"]
    loss, grads = _single_rank_grads("zamba2-2.7b")
    _assert_close_grads(got["grads"], grads, "single rank")
    np.testing.assert_allclose(got["metrics"]["loss"], loss, rtol=1e-5)


def test_mamba2_tensor_parallel_over_several_chunks(world2):
    """zamba2-smoke on (1, 2) at 4 SSD chunks a row: the inter-chunk
    recurrence on local heads gives the single-rank loss and gradients."""
    got = world2["zamba2_chunks"]
    loss, grads = _single_rank_grads("zamba2-2.7b", CHUNKS_SEQ)
    _assert_close_grads(got["grads"], grads, "single rank")
    np.testing.assert_allclose(got["metrics"]["loss"], loss, rtol=1e-5)


def test_kv_heads_that_model_does_not_divide(world2):
    """qwen-smoke with one KV head on (1, 2): ``wk`` / ``wv`` stay whole,
    each rank takes the KV head its query heads read, and their partial
    gradients are summed over ``model`` to the single-rank ones."""
    got = world2["kv1"]
    loss, grads = _single_rank_grads("qwen1.5-0.5b", n_kv_heads=1)
    _assert_close_grads(got["grads"], grads, "single rank")
    np.testing.assert_allclose(got["metrics"]["loss"], loss, rtol=1e-5)
    assert got["partial"] == sorted(f"layers.{i}.attn.{w}.{p}"
                                    for i in range(2) for w in ("wk", "wv")
                                    for p in ("w", "b"))


def test_mla_partial_gradients(world2):
    """deepseek-smoke on (1, 2): the whole tensors read inside the
    model-parallel region, summed over ``model``, are exactly MLA's latent
    projections (in the dense layer too) and the MoE router."""
    got = world2[("deepseek", (1, 2), 1, False)]
    want = {f"{stack}.attn.{w}" for stack in ("dense_layers.0", "layers.0")
            for w in ("w_dkv.w", "w_krope.w", "norm_ckv.g")}
    assert got["partial"] == sorted(want | {"layers.0.moe.router.w"})


def test_mamba2_partial_gradients(world2):
    """zamba2-smoke on (1, 2): the partial set is exactly each Mamba2
    layer's ``in_b``, ``in_c``, ``in_dt``, ``conv_bc_*`` and the gated
    norm's gain; the shared GQA block has none (its KV heads divide)."""
    got = world2[("zamba2", (1, 2), 1, False)]
    want = {f"mamba.{g}.{e}.{n}" for g in range(2) for e in range(2)
            for n in ("in_b.w", "in_c.w", "in_dt.w", "conv_bc_w",
                      "conv_bc_b", "norm.g")}
    assert got["partial"] == sorted(want)


def test_mlstm_tensor_parallel_over_several_chunks(world2):
    """xlstm-smoke on (1, 2) at 4 mLSTM chunks a row: the inter-chunk
    matrix memory on local heads gives the single-rank loss and
    gradients."""
    got = world2["xlstm_chunks"]
    loss, grads = _single_rank_grads("xlstm-125m", CHUNKS_SEQ)
    _assert_close_grads(got["grads"], grads, "single rank")
    np.testing.assert_allclose(got["metrics"]["loss"], loss, rtol=1e-5)


def test_xlstm_loss_at_full_depth(world2):
    """xlstm-smoke at 12 blocks (sLSTM at 3 and 9) on (1, 2) in float32:
    the sharded step's loss is the single-rank loss to float32 rounding,
    though the model's loss and gradients are chaotic under rounding
    (``chip_smoke.SCALEOUT_SPREAD_PARTS`` holds its bf16 loss on the card
    to its own 1-ulp spread)."""
    got = world2["xlstm_deep"]
    loss, _ = _single_rank_grads("xlstm-125m", XLSTM_DEEP_SEQ, **XLSTM_DEEP)
    np.testing.assert_allclose(got["metrics"]["loss"], loss, rtol=1e-6)


def test_slstm_row_parallel_ffn(world2):
    """xlstm-smoke at d_f 128 on (1, 2): the sLSTM FFN's ``up`` and
    ``down`` both split, the product formed whole from the gathered ``up``
    and read by rows: the single-rank loss and gradients."""
    got = world2["xlstm_even_ffn"]
    loss, grads = _single_rank_grads("xlstm-125m", **XLSTM_EVEN_FFN)
    _assert_close_grads(got["grads"], grads, "single rank")
    np.testing.assert_allclose(got["metrics"]["loss"], loss, rtol=1e-5)
    assert got["local_m"]["blocks.1.up.w"] == (64, 128)
    assert got["local_m"]["blocks.1.down.w"] == (64, 64)


def test_encdec_with_an_odd_vocabulary(world2):
    """whisper-smoke with 255 tokens on (1, 2), as whisper-tiny's 51865:
    ``embed`` and ``head`` stay whole on each rank (the head's logits
    need no gather), and the step gives the single-rank loss and
    gradients; at 256 both are split over ``model``."""
    got = world2["whisper_odd_vocab"]
    loss, grads = _single_rank_grads("whisper-tiny", vocab_size=255)
    _assert_close_grads(got["grads"], grads, "single rank")
    np.testing.assert_allclose(got["metrics"]["loss"], loss, rtol=1e-5)
    assert got["local_m"]["embed.table"] == (255, 64)
    assert got["local_m"]["head.w"] == (64, 255)
    even = world2[("whisper", (1, 2), 1, False)]["local_m"]
    assert even["embed.table"] == (128, 64)
    assert even["head.w"] == (64, 128)


def test_xlstm_partial_gradients(world2):
    """xlstm-smoke on (1, 2): the partial set is exactly the mLSTM blocks'
    ``out_norm.g`` (read by slices) and ``wf.w`` (the rule keeps it whole;
    each rank reads its heads' gates); the sLSTM block has none."""
    got = world2[("xlstm", (1, 2), 1, False)]
    want = {f"blocks.{i}.{n}" for i in (0, 2)
            for n in ("out_norm.g", "wf.w")}
    assert got["partial"] == sorted(want)


def _fake_mesh(model: int):
    """A (data 1, model ``model``) mesh of rank 0 with no process group:
    enough for ``shard``, which slices and marks without collectives."""
    from repro_torch.distributed import context
    return context.Mesh(("data", "model"), {"data": 1, "model": model},
                        {"data": 0, "model": 0}, {}, torch.device("cpu"),
                        "gloo")


@pytest.mark.parametrize("model, kw, kinds", [
    (2, {}, ("col", None)), (4, {}, (None, None)),
    (2, XLSTM_EVEN_FFN, ("col", "row"))],
    ids=["model2", "model4", "model2-even-ffn"])
def test_slstm_ffn_layouts(model, kw, kinds):
    """The sLSTM FFN's layout follows its linears' own ``parallel``:
    xlstm-smoke's d_f 85 keeps ``down`` whole on model 2 and both whole on
    model 4; at d_f 128 both split on model 2."""
    tcfg = _cfgs("xlstm-125m", **kw)[1]
    model_ = lm.shard(lm.init_params(tcfg, torch.Generator(), "cpu"), tcfg,
                      _fake_mesh(model))
    blk = model_.blocks[1]
    assert (blk.up.parallel, blk.down.parallel) == kinds
    assert blk.mesh is not None and blk.w_z.parallel == "col"


def test_mla_layout_where_model_splits_only_wq():
    """deepseek-smoke cut to its dense layer on model 3, as
    deepseek-v2-lite-16b's on (1, 3) in ``chip_smoke.py``'s (u): 3 does not
    divide its 4 heads, ``wq``'s 96 columns split through a head, ``w_uk``
    / ``w_uv`` / ``wo``'s 64 stay whole, so every rank runs every head
    and every whole tensor of the layer is partial; with a MoE layer the
    8 experts do not divide over 3, where the reference's ``shard_map``
    fails, and ``shard`` refuses."""
    tcfg = _cfgs("deepseek-v2-lite-16b", n_layers=1)[1]
    model_ = lm.shard(lm.init_params(tcfg, torch.Generator(), "cpu"), tcfg,
                      _fake_mesh(3))
    attn = model_.dense_layers[0].attn
    assert attn.every_head and attn.mesh is not None
    assert [getattr(attn, n).parallel for n in lm.MLA_SPLIT] == \
        ["col", None, None, None]
    assert attn.wq.w.shape == (64, 32)
    assert sorted(model_.layout.partial) == sorted(
        f"dense_layers.0.attn.{n}" for n in (
            "w_dkv.w", "w_krope.w", "norm_ckv.g", "w_uk.w", "w_uv.w",
            "wo.w"))
    tcfg = _cfgs("deepseek-v2-lite-16b")[1]
    with pytest.raises(NotImplementedError,
                       match="8 experts over a model axis of 3"):
        lm.shard(lm.init_params(tcfg, torch.Generator(), "cpu"), tcfg,
                 _fake_mesh(3))


def test_encdec_partial_gradients(world2):
    """whisper-smoke on (1, 2): nothing is partial: the encoder output
    enters the region once, and every cross K/V head divides."""
    assert world2[("whisper", (1, 2), 1, False)]["partial"] == []


def test_vlm_partial_gradients(world2):
    """pixtral-smoke on (1, 2): nothing is partial; ``img_proj`` runs
    whole outside every model-parallel region, its gradient whole."""
    assert world2[("pixtral", (1, 2), 1, False)]["partial"] == []
    tcfg = _cfgs("pixtral-12b")[1]
    model_ = lm.shard(lm.init_params(tcfg, torch.Generator(), "cpu"), tcfg,
                      _fake_mesh(2))
    assert model_.img_proj.parallel is None and model_.img_proj.mesh is None


@pytest.mark.parametrize("arch", HEADS_REFUSED)
def test_model_axis_refuses_heads_it_does_not_divide(world2, arch):
    """One head over a model axis of 2, which ``shard`` used to refuse:
    each rank runs every head (ROADMAP fact 18; an MLA head and a Mamba2
    SSM head too), and the step (loss, gradients, the updated state) is
    the reference's single-device step and the port's single rank's."""
    _assert_step_matches(world2[("one head", arch)], HEADS_REFUSED[arch], 1,
                         False)


@pytest.mark.parametrize("arch, whole", [
    ("deepseek-v2-lite-16b", ()),
    ("deepseek-whole-wo", ("w_uv.w", "wo.w")),
    ("zamba2-2.7b", ("A_log", "D", "dt_bias"))])
def test_partial_gradients_of_one_head(world2, arch, whole):
    """deepseek-1h, deepseek-1h-dv15 and zamba2-1h on (1, 2): the whole
    tensors read inside the region are partial, beside the ones of
    divided heads: MLA's latent projections, and at a value dim of 15 its
    whole ``w_uv`` and ``wo`` too (model rank 0 alone carries the whole
    output's gradient); the SSM head vectors, which the rule keeps
    whole."""
    got = world2[("one head", arch)]["partial"]
    if arch.startswith("deepseek"):
        want = {f"{stack}.attn.{w}" for stack in ("dense_layers.0",
                                                  "layers.0")
                for w in ("w_dkv.w", "w_krope.w", "norm_ckv.g") + whole}
        want.add("layers.0.moe.router.w")
    else:
        want = {f"mamba.{g}.{e}.{n}" for g in range(2) for e in range(2)
                for n in ("in_b.w", "in_c.w", "in_dt.w", "conv_bc_w",
                          "conv_bc_b", "norm.g") + whole}
    assert got == sorted(want)


#: the (1, 4) cases whose heads model 4 does not divide
FRACTIONAL = ("whisper-6h", "xlstm-2h", "phi3-6h")


@pytest.mark.parametrize("variant", FRACTIONAL)
def test_heads_model_does_not_divide_follow_the_reference_1x4(
        world4, reference_2x2, variant):
    """Heads that model 4 does not divide, every rank running every head:
    the step (loss, gradients, the updated state) is the reference's own
    run on a 1 x 4 mesh, which splits the same projections through a
    head; the q / k / v gathers' backward reduce-scatters.  The
    reference's 1 x 4 run rounds its sums in another order than its
    single-device step, and for xlstm-2h a few gradient elements of the
    two differ by more than the gradients' tolerance (17 of some 10^5 in
    a CPU run): an element where the reference's two runs disagree so is
    held to either, every other one to the 1 x 4 run."""
    got = world4[(variant, (1, 4), 1, False)]
    ref, one = reference_2x2[variant], _reference(variant, 1)
    assert sorted(got["grads"]) == sorted(ref["grads"])
    split, total = 0, 0
    for name, w in ref["grads"].items():
        g, w1 = got["grads"][name], one["grads"][name]
        atol = GRAD_ATOL_SCALE * float(np.abs(w).max()) + 1e-12

        def within(a, b):
            return np.abs(a - b) <= atol + GRAD_RTOL * np.abs(b)
        apart = ~within(w1, w)
        split, total = split + int(apart.sum()), total + w.size
        ok = np.where(apart, within(g, w) | within(g, w1), within(g, w))
        assert ok.all(), (name, np.argwhere(~ok)[:5])
    assert split <= 1e-3 * total, (split, total)
    for k in ("loss", "nll", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for k in ("params", "m", "v"):
        for n, w in ref[k].items():
            np.testing.assert_allclose(got[k][n], w, **STEP_TOL,
                                       err_msg=f"{k} {n}")
    assert got["traffic"]["reduce_scatter"][0] > 0


def test_partial_gradients_where_heads_do_not_divide(world4):
    """On (1, 4): the whole ``wk`` / ``wv`` of every self-attention (whisper's
    encoder and decoder, phi3's; whisper's cross-attention splits them by
    columns), and the mLSTM's ``out_norm.g``, ``wf`` and its whole
    ``wi``; the sLSTM block has none (its whole ``r_*`` sees the same
    gradient on every rank)."""
    def got(v):
        return world4[(v, (1, 4), 1, False)]["partial"]
    assert got("whisper-6h") == sorted(
        f"{stack}.{i}.attn.{w}.w" for stack in ("enc_layers", "layers")
        for i in range(2) for w in ("wk", "wv"))
    assert got("phi3-6h") == sorted(f"layers.{i}.attn.{w}.w"
                                    for i in range(2) for w in ("wk", "wv"))
    assert got("xlstm-2h") == sorted(f"blocks.{i}.{n}" for i in (0, 2)
                                     for n in ("out_norm.g", "wf.w", "wi.w"))


@pytest.mark.parametrize("world", [2, 4])
def test_gather_to_heads_backward_is_a_reduce_scatter(world2, world4,
                                                      world):
    """Column slices cut through a head, gathered into whole heads, each
    rank keeping other columns of what follows: the gradient through
    ``gather_to_heads`` is one rank's; through ``gather_from_model``'s
    narrowing backward it is not."""
    res = (world2 if world == 2 else world4)["gather_to_heads"]
    assert res["gather_to_heads"] < 1e-5, res
    assert res["gather_from_model"] > 1e-2, res


def test_pipeline_matches_sequential(world4):
    """4 stages, 8 microbatches of 2 rows: ``pipeline_apply`` equals the
    stages in sequence (``test_pipeline.py``'s bound)."""
    res = world4["pipeline"]
    assert res["err"] < 1e-5, res
    assert res["bubble"] == jbubble(4, 8) == bubble_fraction(4, 8)


def test_bubble_fraction():
    assert bubble_fraction(4, 12) == jbubble(4, 12) == 3 / 15
    assert bubble_fraction(1, 8) == jbubble(1, 8) == 0.0


def test_elastic_reshard_checkpoint(world2):
    """A trainer on (1, 2), crashed at step 3 and restored from step 2
    (the replayed step's loss equal bit for bit), writes its step-4
    checkpoint; restored onto (2, 1) through ``reshard_state`` and through
    ``ckpt.restore`` with shardings, the gathered state equals the written
    one bit for bit, as do the parameters moved back onto (1, 2) from
    their (2, 1) slices; and one more step runs."""
    res = world2["elastic"]
    assert res["run"] == {"final_step": 4, "restarts": 1}
    assert res["last"] == 4
    assert res["same"] == {"reshard": True, "restore": True,
                           "round_trip": True}
    steps = [s["step"] for s in res["steps"]]
    assert steps == [0, 1, 2, 2, 3]
    assert res["steps"][2]["loss"] == res["steps"][3]["loss"]
    assert [c["step"] for c in res["checkpoints"]] == [2, 4]
    assert np.isfinite(res["resumed_loss"])


def test_the_reference_restores_the_sharded_checkpoint(world2):
    """The checkpoint the (1, 2) ranks wrote loads in the reference's
    ``ckpt.restore`` bit for bit against the port's own restore."""
    ckdir = world2["ckdir"]
    tcfg = _cfgs("qwen1.5-0.5b")[1]
    model, opt = tstep.init_train_state(torch.Generator(), tcfg,
                                        device="cpu")
    params = dict(model.named_parameters())
    mine = ckpt.restore(ckdir, 4, {"params": params, "opt": opt})
    like = jax.tree.map(lambda t: jnp.zeros(tuple(t.shape), jnp.float32)
                        if t.dtype == torch.float32 else
                        jnp.zeros((), jnp.int32),
                        {"params": {n: p.detach() for n, p in
                                    params.items()}, "opt": opt})
    theirs = jckpt.restore(ckdir, 4, like)
    flat_mine = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), mine))
    flat_theirs = jax.tree.leaves(_np(theirs))
    assert len(flat_mine) == len(flat_theirs) == 3 * len(params) + 1
    for a, b in zip(flat_mine, flat_theirs):
        assert a.tobytes() == b.tobytes()


def test_membership_watcher_and_mesh_rebuild():
    w = MembershipWatcher(events={3: 1})
    assert w.view.n_devices == 1
    assert w.poll(1) is None
    v = w.poll(3)
    assert v is not None and v.generation == 1
    mesh = make_mesh_for(v.n_devices, model_parallel=1, device="cpu")
    assert mesh.size(("data", "model")) == 1


def test_heartbeat_monitor():
    hb = HeartbeatMonitor(timeout_s=1.0)
    hb.beat(0.0)
    hb.beat(0.5)
    hb.beat(5.0)
    assert hb.failures == 1


def test_data_ranks_rows(tmp_path):
    """``local_rows`` gives each data rank its share of every microbatch,
    so the ranks' rows of microbatch i, in order, are the global
    microbatch i; a file dataset's host shards are the global batch's
    rows, the synthetic stream is seeded per host (the trainer reads the
    global batch and keeps its rows)."""
    import types
    x = torch.arange(16).reshape(8, 2)
    for n_mb in (1, 2):
        parts = []
        for i in range(2):
            mesh = types.SimpleNamespace(
                data_axes=lambda: ("data",), size=lambda axes: 2,
                index=lambda axes, i=i: i)
            parts.append(tstep.local_rows({"tokens": x}, mesh,
                                          n_mb)["tokens"])
        for j, mb in enumerate(tstep.split_batch({"tokens": x}, n_mb)):
            got = torch.cat([tstep.split_batch({"tokens": p},
                                               n_mb)[j]["tokens"]
                             for p in parts])
            assert torch.equal(got, mb["tokens"])
    tcfg = _cfgs("qwen1.5-0.5b")[1]
    one = tpipe.SyntheticLM(tpipe.DataConfig(global_batch=4, seq_len=8),
                            tcfg).batch_at(2)["tokens"]
    two = [tpipe.SyntheticLM(tpipe.DataConfig(global_batch=4, seq_len=8,
                                              n_hosts=2, host_id=h),
                             tcfg).batch_at(2)["tokens"] for h in (0, 1)]
    assert np.array_equal(two[0], one[:2])
    assert not np.array_equal(two[1], one[2:])
    path = tmp_path / "tokens.bin"
    np.arange(40 * 9, dtype=np.uint16).tofile(path)
    whole = tpipe.PackedFileDataset(str(path), tpipe.DataConfig(
        global_batch=4, seq_len=8)).batch_at(3)
    for h in (0, 1):
        part = tpipe.PackedFileDataset(str(path), tpipe.DataConfig(
            global_batch=4, seq_len=8, n_hosts=2, host_id=h)).batch_at(3)
        assert np.array_equal(part["tokens"],
                              whole["tokens"][2 * h:2 * h + 2])
