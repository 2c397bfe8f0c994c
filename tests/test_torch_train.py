"""The port's training pieces (``repro_torch.{optim,train,distributed,data}``
and ``models.lm.loss_fn``) against the JAX reference on the CPU, at smoke
size, in float32.  Weights come across through ``params_from_jax``; a
reference tree of gradients, moments or errors is compared by feeding it
through ``params_from_jax`` too and matching the port's tensors by name.

Tolerances (float32, both sides on the CPU):
* gradients of the loss: ``rtol 1e-4`` and an ``atol`` of ``1e-5`` of the
  tensor's largest reference gradient (XLA and PyTorch sum in other
  orders; a gradient that is 0 in exact arithmetic, such as a key bias's,
  is rounding noise on both sides);
* loss and metrics: ``rtol 1e-5``;
* one train step from a state with nonzero moments (so that AdamW's update
  is a smooth function of the gradient): new params, ``m`` and ``v``
  ``rtol 1e-5`` / ``atol 1e-6``; with int8 compression, where a gradient
  that lands on the other side of a half step moves by a whole int8 step,
  the update the port applied is held to the reference's own compression
  and AdamW applied to the port's gradients: the error state bit for bit,
  params, ``m`` and ``v`` within ``rtol 1e-6`` / ``atol 1e-8`` (the clip's
  global norm is a sum in another order, the bias corrections powers);
* the compression: bit for bit; AdamW and its schedule within ``rtol
  1e-6`` to ``2e-6`` (cosine and power are each library's own
  approximation; the moments bit for bit when the clip is inactive), the
  global norm (a sum in another order) ``rtol 1e-6``;
* data batches: bit for bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.data import pipeline as jpipe
from repro.distributed import compress as jgc
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.configs import base as cb
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import compress as tgc
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep

#: one smoke config of each family
FAMILY_ARCHS = {"dense": "qwen1.5-0.5b", "moe": "moonshot-v1-16b-a3b",
                "vlm": "pixtral-12b", "hybrid": "zamba2-2.7b",
                "encdec": "whisper-tiny", "xlstm": "xlstm-125m"}
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-5
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _cfgs(arch: str, **kw) -> tuple:
    return (jcb.get(arch, smoke=True).scaled(dtype=jnp.float32, **kw),
            cb.get(arch, smoke=True).scaled(dtype=torch.float32, **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str, seed: int = 0):
    return jlm.init_params(jax.random.PRNGKey(seed), _cfgs(arch)[0])


def _named(tree, tcfg) -> dict:
    """A reference tree shaped as the params (gradients, moments, errors)
    under the port's parameter names."""
    model = params_from_jax(_np(tree), tcfg, "cpu")
    return {n: t.detach() for n, t in model.named_parameters()}


def _dense_tree(named: dict, like) -> dict:
    """The inverse for a dense model: the port's {name: tensor} as the
    reference's tree (``layers`` stacked on axis 0)."""
    n_layers = len(like["layers"]["ln1"]["g"])

    def leaf(path, _):
        keys = [p.key for p in path]
        if keys[0] == "layers":
            rest = ".".join(keys[1:])
            return jnp.asarray(np.stack([named[f"layers.{i}.{rest}"].numpy()
                                         for i in range(n_layers)]))
        return jnp.asarray(named[".".join(keys)].numpy())
    return jax.tree_util.tree_map_with_path(leaf, like)


def _batch(tcfg, rows: int, seq: int, seed: int, mask: bool) -> dict:
    """A synthetic batch of the port's pipeline (numpy), with a 0/1 mask
    over the tokens when asked."""
    data = tpipe.SyntheticLM(tpipe.DataConfig(global_batch=rows,
                                              seq_len=seq, seed=seed), tcfg)
    b = data.batch_at(3)
    if mask:
        rng = np.random.default_rng(seed)
        b["mask"] = (rng.random(b["tokens"].shape) < 0.7).astype(np.int32)
    return b


def _assert_grads(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        atol = GRAD_ATOL_SCALE * float(w.abs().max()) + 1e-12
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   rtol=GRAD_RTOL, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# the loss and its gradient, every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_loss_and_grad_match_reference(family):
    """``lm.loss_fn`` and its gradient against ``jax.value_and_grad`` of the
    reference's, with a target mask (a VLM's image positions dropped)."""
    arch = FAMILY_ARCHS[family]
    jcfg, tcfg = _cfgs(arch)
    seq = 8 + (tcfg.n_img_tokens if family == "vlm" else 0)
    batch = _batch(tcfg, 2, seq, seed=1, mask=True)
    jp = _jax_params(arch)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    model = params_from_jax(_np(jp), tcfg, "cpu")
    loss_fn = tstep.make_loss(tcfg)
    tl, tmet, tg = tstep.grads_of(loss_fn, model,
                                  {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for key in ("nll", "aux"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5, atol=1e-7)
    if family == "moe":
        assert float(tmet["aux"]) > 0.0
    _assert_grads(tg, _named(jg, tcfg))


def test_loss_without_a_mask_is_the_mean_nll():
    _, tcfg = _cfgs("qwen1.5-0.5b")
    batch = _batch(tcfg, 2, 8, seed=2, mask=False)
    model = params_from_jax(_np(_jax_params("qwen1.5-0.5b")), tcfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, met = lm.loss_fn(model, tb, tcfg)
        logits, _ = model(tb, tcfg)
    want = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, tcfg.vocab_size).float(),
        tb["tokens"][:, 1:].reshape(-1).long())
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    assert float(met["aux"]) == 0.0 and float(met["nll"]) == float(loss)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

def _opt_state(jp, seed: int, compress: bool) -> dict:
    """A mid-run optimizer state: nonzero moments, step 2 (the reference's
    tree; numpy-seeded)."""
    rng = np.random.default_rng(seed)

    def draw(scale, square=False):
        def one(p):
            x = rng.normal(size=p.shape).astype(np.float32) * scale
            return jnp.asarray(x * x + 1e-4 if square else x)
        return jax.tree.map(one, jp)
    state = {"m": draw(1e-2), "v": draw(1e-2, square=True),
             "step": jnp.asarray(2, jnp.int32)}
    if compress:
        state["grad_err"] = draw(1e-4)
    return state


def _port_state(state: dict, tcfg) -> dict:
    out = {k: _named(state[k], tcfg) for k in state if k != "step"}
    out["step"] = torch.tensor(int(state["step"]), dtype=torch.int32)
    return out


def _reference_grads(jp, batch: dict, jcfg, n_mb: int):
    """The reference train step's gradient: per microbatch
    ``value_and_grad``, summed in float32 and divided by the count."""
    vg = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(p, b, jcfg),
                                    has_aux=True))
    rows = batch["tokens"].shape[0] // n_mb
    total = None
    for i in range(n_mb):
        _, g = vg(jp, {k: jnp.asarray(v[i * rows:(i + 1) * rows])
                       for k, v in batch.items()})
        total = g if total is None else jax.tree.map(jnp.add, total, g)
    return jax.tree.map(lambda x: x / n_mb, total)


@pytest.mark.parametrize("n_mb, compress", [(1, False), (2, False),
                                            (1, True), (2, True)])
def test_train_step_matches_reference(n_mb, compress):
    jcfg, tcfg = _cfgs("qwen1.5-0.5b")
    oc_j, oc_t = jadamw.AdamWConfig(**OPT), tadamw.AdamWConfig(**OPT)
    jp = _jax_params("qwen1.5-0.5b")
    jstate = _opt_state(jp, 7, compress)
    batch = _batch(tcfg, 4, 16, seed=3, mask=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jnew, jst, jmet = jax.jit(jstep.make_train_step(jcfg, oc_j, n_mb,
                                                    compress))(jp, jstate, jb)

    model = params_from_jax(_np(jp), tcfg, "cpu")
    tstate = _port_state(jstate, tcfg)
    _, _, tg = tstep.accumulated_grads(tstep.make_loss(tcfg), model, tb,
                                       n_mb)
    _assert_grads(tg, _named(_reference_grads(jp, batch, jcfg, n_mb), tcfg))
    before = _dense_tree({n: p.detach().clone()
                          for n, p in model.named_parameters()}, jp)
    model2, tstate2, tmet = tstep.make_train_step(tcfg, oc_t, n_mb,
                                                  compress)(model, tstate, tb)
    assert model2 is model and tstate2 is tstate
    assert sorted(tmet) == sorted(jmet) == ["aux", "grad_norm", "loss", "lr",
                                            "nll"]
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert int(tstate["step"]) == int(jst["step"]) == 3
    got = {n: p.detach() for n, p in model.named_parameters()}
    if not compress:
        for name, want in [("params", _named(jnew, tcfg)),
                           ("m", _named(jst["m"], tcfg)),
                           ("v", _named(jst["v"], tcfg))]:
            mine = got if name == "params" else tstate[name]
            for n, w in want.items():
                np.testing.assert_allclose(mine[n].numpy(), w.numpy(),
                                           **STEP_TOL, err_msg=f"{name} {n}")
        return
    # compression: the reference's tail of the step on the port's gradients
    g = _dense_tree(tg, jp)
    cg, err = jgc.compress_tree(g, jstate["grad_err"])
    core = {k: jstate[k] for k in ("m", "v", "step")}
    wp, wst, _ = jadamw.apply_updates(before, jgc.decompress_tree(cg), core,
                                      oc_j)
    for name, mine, want in [("params", got, wp), ("m", tstate["m"], wst["m"]),
                             ("v", tstate["v"], wst["v"]),
                             ("grad_err", tstate["grad_err"], err)]:
        for n, w in _named(want, tcfg).items():
            if name == "grad_err":
                assert torch.equal(mine[n], w), n
            else:
                np.testing.assert_allclose(mine[n].numpy(), w.numpy(),
                                           rtol=1e-6, atol=1e-8,
                                           err_msg=f"{name} {n}")


def test_init_train_state_and_eval_step():
    _, tcfg = _cfgs("qwen1.5-0.5b")
    model, state = tstep.init_train_state(torch.Generator().manual_seed(0),
                                          tcfg, compress_grads=True,
                                          device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert sorted(state) == ["grad_err", "m", "step", "v"]
    for key in ("m", "v", "grad_err"):
        assert list(state[key]) == names
        assert all(t.dtype == torch.float32 and not t.any()
                   for t in state[key].values())
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    assert all(p.requires_grad for p in model.parameters())
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(tcfg, 2, 8, seed=0, mask=False).items()}
    out = tstep.make_eval_step(tcfg)(model, batch)
    assert sorted(out) == ["aux", "loss", "nll"]
    assert not out["loss"].requires_grad and np.isfinite(float(out["loss"]))


def test_split_batch_matches_the_reference_reshape():
    x = torch.arange(24).reshape(6, 4)
    parts = tstep.split_batch({"tokens": x}, 3)
    for i, p in enumerate(parts):
        assert torch.equal(p["tokens"], x.reshape(3, 2, 4)[i])
    with pytest.raises(ValueError, match="multiple"):
        tstep.split_batch({"tokens": x}, 4)


# ---------------------------------------------------------------------------
# the pure functions, bit for bit
# ---------------------------------------------------------------------------

def _random_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 7)).astype(np.float32),
            "b": rng.normal(size=(11,)).astype(np.float32) * 3,
            "c": rng.normal(size=(2, 3, 4)).astype(np.float32) * 1e-3}


def test_cosine_schedule_matches_reference():
    """Within ``rtol 2e-6``: the cosine is XLA's approximation on one side
    and PyTorch's on the other, an ulp apart at most, and ``1 + cos``
    near the end of the decay magnifies that ulp (every other operation is
    the same float32 arithmetic in the same order)."""
    for cfg in (dict(lr=3e-4, warmup_steps=3, total_steps=12),
                dict(lr=1e-3, warmup_steps=0, total_steps=5,
                     min_lr_ratio=0.0)):
        js = jadamw.cosine_schedule(jadamw.AdamWConfig(**cfg))
        ts = tadamw.cosine_schedule(tadamw.AdamWConfig(**cfg))
        for step in range(15):
            want = np.asarray(js(jnp.asarray(step, jnp.int32)))
            got = ts(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-6,
                                       err_msg=f"{cfg} {step}")


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_apply_updates_matches_reference(clip):
    """Three steps from zero moments, the clip active or not.  The moments
    bit for bit where the clip leaves the gradients as they are, else
    within ``rtol 1e-6`` (the clip's scale comes from the global norm, a
    sum in another order); the learning rate as the schedule's test; the
    params within ``rtol 1e-6`` (the bias corrections are powers, XLA's
    and PyTorch's own approximations)."""
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=5, grad_clip=clip)
    jc, tc = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    jp = {k: jnp.asarray(v) for k, v in _random_tree(0).items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in _random_tree(0).items()}
    jst, tst = jadamw.init_state(jp), tadamw.init_state(tp)
    for i in range(3):
        g = _random_tree(10 + i)
        jp, jst, jm = jadamw.apply_updates(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jst, jc)
        tp2, tst2, tm = tadamw.apply_updates(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, tst, tc)
        assert tp2 is tp and tst2 is tst
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=2e-6)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-9)
            for mine, want in ((tst["m"][k], jst["m"][k]),
                               (tst["v"][k], jst["v"][k])):
                if clip > 1:
                    assert np.array_equal(mine.numpy(), np.asarray(want))
                else:
                    np.testing.assert_allclose(mine.numpy(), np.asarray(want),
                                               rtol=1e-6, atol=1e-12)
        assert int(tst["step"]) == int(jst["step"]) == i + 1


def test_global_norm_and_clip():
    tree = _random_tree(3)
    want = float(jadamw.global_norm({k: jnp.asarray(v)
                                     for k, v in tree.items()}))
    t = {k: torch.from_numpy(v) for k, v in tree.items()}
    np.testing.assert_allclose(float(tadamw.global_norm(t)), want,
                               rtol=1e-6)
    clipped, norm = tadamw.clip_by_global_norm(t, 1.0)
    assert float(norm) == pytest.approx(want, rel=1e-6)
    assert float(tadamw.global_norm(clipped)) <= 1.0 + 1e-5
    same, _ = tadamw.clip_by_global_norm(t, 1e6)
    assert all(torch.equal(same[k], t[k]) for k in t)


def test_adamw_descends_quadratic():
    w = torch.tensor([3.0, -2.0, 1.0])
    params = {"w": w}
    state = tadamw.init_state(params)
    oc = tadamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                            weight_decay=0.0)
    for _ in range(150):
        tadamw.apply_updates(params, {"w": 2 * w}, state, oc)
    assert float(w.abs().max()) < 0.1


def test_compress_bit_equal():
    rng = np.random.default_rng(4)
    tree = _random_tree(5)
    tree["zero"] = np.zeros((3,), np.float32)
    err = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32)
           for k, v in tree.items()}
    jq, jerr = jgc.compress_tree({k: jnp.asarray(v) for k, v in tree.items()},
                                 {k: jnp.asarray(v) for k, v in err.items()})
    tq, terr = tgc.compress_tree({k: torch.from_numpy(v)
                                  for k, v in tree.items()},
                                 {k: torch.from_numpy(v)
                                  for k, v in err.items()})
    jd, td = jgc.decompress_tree(jq), tgc.decompress_tree(tq)
    for k in tree:
        assert tq[k][0].dtype == torch.int8
        assert np.array_equal(tq[k][0].numpy(), np.asarray(jq[k][0]))
        assert tq[k][1].numpy().tobytes() == np.asarray(jq[k][1]).tobytes()
        assert terr[k].numpy().tobytes() == np.asarray(jerr[k]).tobytes()
        assert td[k].numpy().tobytes() == np.asarray(jd[k]).tobytes()
    init = tgc.init_error_state({"w": torch.ones(2, 3)})
    assert init["w"].dtype == torch.float32 and not init["w"].any()


# ---------------------------------------------------------------------------
# the data pipeline, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_synthetic_batches_bit_equal(family):
    jcfg, tcfg = _cfgs(FAMILY_ARCHS[family])
    seq = 12 + (tcfg.n_img_tokens if family == "vlm" else 0)
    for hosts, host in ((1, 0), (2, 1)):
        kw = dict(global_batch=4, seq_len=seq, seed=5, n_hosts=hosts,
                  host_id=host)
        jd = jpipe.SyntheticLM(jpipe.DataConfig(**kw), jcfg)
        td = tpipe.SyntheticLM(tpipe.DataConfig(**kw), tcfg)
        for step in (0, 1, 9):
            want, got = jd.batch_at(step), td.batch_at(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k]), (step, k)
        it = td.iterate(2)
        assert np.array_equal(next(it)["tokens"], td.batch_at(2)["tokens"])


def test_packed_file_batches_bit_equal(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(6).integers(0, 60000, 17 * 10 + 5).astype(
        np.uint16).tofile(path)
    kw = dict(global_batch=4, seq_len=16, seed=2, n_hosts=2, host_id=1)
    jd = jpipe.PackedFileDataset(str(path), jpipe.DataConfig(**kw))
    td = tpipe.PackedFileDataset(str(path), tpipe.DataConfig(**kw))
    assert td.n_rows == jd.n_rows == 10
    for step in range(6):                     # crosses epochs
        want, got = jd.batch_at(step), td.batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), (step, k)
    _, tcfg = _cfgs("qwen1.5-0.5b")
    made = tpipe.make_dataset("file", tpipe.DataConfig(**kw), tcfg,
                              str(path))
    assert isinstance(made, tpipe.PackedFileDataset)
    with pytest.raises(ValueError):
        tpipe.make_dataset("file", tpipe.DataConfig(**kw), tcfg)
    with pytest.raises(ValueError):
        tpipe.PackedFileDataset(str(path), tpipe.DataConfig(global_batch=64,
                                                            seq_len=16))
    with pytest.raises(KeyError):
        tpipe.make_dataset("rows", tpipe.DataConfig(**kw), tcfg)
    with pytest.raises(ValueError):
        _ = tpipe.DataConfig(global_batch=3, seq_len=4, n_hosts=2).host_batch


# ---------------------------------------------------------------------------
# attention's autograd Function, its backward on the CPU
# ---------------------------------------------------------------------------

ATTN_CASES = {
    "gqa-causal": dict(b=2, hq=4, hkv=2, sq=12, skv=12, d=8, dv=8),
    "window": dict(b=1, hq=4, hkv=1, sq=16, skv=16, d=8, dv=8, window=5),
    "q-offset": dict(b=1, hq=2, hkv=2, sq=6, skv=14, d=8, dv=8, q_offset=8),
    "dv-ne-d": dict(b=1, hq=4, hkv=2, sq=9, skv=9, d=12, dv=6),
    "non-causal": dict(b=1, hq=2, hkv=1, sq=5, skv=11, d=8, dv=4,
                       causal=False),
    "rows-see-no-key": dict(b=1, hq=2, hkv=1, sq=6, skv=7, d=8, dv=8,
                            window=2, q_offset=12),
}


def _attn_inputs(c: dict, seed: int = 0) -> tuple:
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return (rand(c["b"], c["hq"], c["sq"], c["d"]),
            rand(c["b"], c["hkv"], c["skv"], c["d"]),
            rand(c["b"], c["hkv"], c["skv"], c["dv"]),
            rand(c["b"], c["hq"], c["sq"], c["dv"]))


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_attention_function_backward(name):
    """``FlashAttentionFn`` with the plain forward in the kernel's place:
    its output is the plain version's, and its backward
    (``attention_backward``) matches autograd of ``chunked_attention`` and
    ``jax.grad`` of the reference's ``chunked_attention``; a small
    ``kv_chunk`` runs several chunks."""
    c = ATTN_CASES[name]
    kw = dict(causal=c.get("causal", True), window=c.get("window"),
              q_offset=c.get("q_offset", 0))
    q, k, v, do = _attn_inputs(c)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.FlashAttentionFn.apply(*leaves, fa.chunked_attention,
                                    kw["causal"], kw["window"],
                                    kw["q_offset"])
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    plain_leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    plain_out = fa.chunked_attention(*plain_leaves, **kw, kv_chunk=4)
    assert torch.equal(out, fa.chunked_attention(*plain_leaves, **kw))
    plain = torch.autograd.grad(plain_out, plain_leaves, torch.from_numpy(do))
    chunked = fa.attention_backward(*(torch.from_numpy(x) for x in (q, k, v)),
                                    torch.from_numpy(do), **kw, kv_chunk=4)

    def jloss(q_, k_, v_):          # one chunk: no padded keys (module
        o = jops.chunked_attention(q_, k_, v_, **kw)   # docstring of fa)
        return jnp.sum(o * do)
    ref = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    for label, g, p, ch, r in zip("qkv", got, plain, chunked, ref):
        assert g.shape == p.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"d{label} vs torch")
        np.testing.assert_allclose(ch.numpy(), p.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"d{label} chunks")
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6, err_msg=f"d{label} vs jax")


def test_attention_function_backward_bf16():
    """bf16 inputs: the gradients come back in bf16, within one bf16
    rounding of the float32 ones."""
    c = ATTN_CASES["gqa-causal"]
    q, k, v, do = _attn_inputs(c, seed=1)
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
              for x in (q, k, v)]
    out = fa.FlashAttentionFn.apply(*leaves, fa.chunked_attention, True,
                                    None, 0)
    got = torch.autograd.grad(out, leaves,
                              torch.from_numpy(do).to(torch.bfloat16))
    f32 = fa.attention_backward(*(t.detach().float() for t in leaves),
                                torch.from_numpy(do).to(torch.bfloat16)
                                .float())
    for g, w in zip(got, f32):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.numpy(),
                                   rtol=8e-3, atol=1e-6)


def test_cpu_attention_stays_plain_autograd():
    """On the CPU ``ops.attention`` is the plain version, which autograd
    differentiates itself (no Function in the graph)."""
    from repro_torch.kernels import ops
    q, k, v, _ = _attn_inputs(ATTN_CASES["gqa-causal"])
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ops.attention(*leaves)
    assert "FlashAttentionFn" not in type(out.grad_fn).__name__
    assert torch.equal(out, fa.chunked_attention(*leaves))
