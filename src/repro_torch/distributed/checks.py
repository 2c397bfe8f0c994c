"""Rank functions that hold the sharded paths against one rank.

Each runs on every rank of a world started by
:func:`repro_torch.launch.mesh.run_ranks` (so each is a module-level
function of the package, importable by a spawned process) and returns
plain Python and numpy values: the CPU tests run them over gloo on small
configs, ``chip_smoke.py`` over gloo on the card at full width.

* :func:`sharded_step`: one train step of a model given as the
  reference's weights, laid out on a (data, model) mesh: the metrics, the
  gradients as the step reduces them, the updated parameters and moments,
  every one gathered in full on rank 0.
* :func:`gather_to_heads_check`: the gradient through
  ``context.gather_to_heads`` where the ranks keep different columns of
  what follows, against one rank's, and through ``gather_from_model``'s
  narrowing backward, which must miss it.
* :func:`pipeline_check`: ``pipeline_apply`` over a stage axis against
  the stages applied in sequence.
* :func:`elastic_check`: a trainer with a crash on one mesh, its
  checkpoint restored onto another through ``elastic.reshard_state`` and
  ``ckpt.restore`` with shardings, each rank's slices held to the same
  slices of the written state bit for bit, then one more step.
* :func:`sharded_serving`: prefill and decode steps of a model given as
  the reference's weights (quantized whole first under W8A8), laid out
  on a (data, model) mesh: the logits and the caches gathered on rank 0,
  the shapes of rank 0's slices (of the prefill's caches and of
  ``init_caches``').
* :func:`row_parallel_w8a8`: a W8A8 row-parallel linear's int32
  accumulator against one rank's, bit for bit.
* :func:`chip_scaleout`: ``chip_smoke.phase_scaleout``'s ranks at full
  width on the card: one train step of each of qwen (tensor and data
  parallel), moonshot (expert parallel), deepseek (MLA and expert
  parallel), zamba2 (Mamba2 and its shared block tensor parallel),
  xlstm, whisper and pixtral (tensor parallel) against the single-rank
  step, the elastic trainer, the pipeline, and W8A8 serving of qwen,
  deepseek, zamba2, whisper and xlstm (:data:`SERVE_PARTS`; a
  one-head deepseek and zamba2, and whisper's layer stack split over
  ``data``) against rank 0's single-rank serving; :func:`chip_every_head`,
  the same checks of a train step and of serving on a world of 3, 4 or 8
  ranks whose ``model`` axis does not divide the heads.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.distributed import pipeline, sharding
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw
from repro_torch.runtime import elastic
from repro_torch.train import step as step_lib

AXES = ("data", "model")


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def gather_tree(tree: dict, shardings: dict) -> dict:
    """{name: full tensor} of {name: local slice} (a collective; every
    rank gets the full tensors)."""
    return {n: sharding.gather_full(t.detach(), shardings[n])
            for n, t in tree.items()}


def _host(tree: dict, shardings: dict) -> dict | None:
    full = gather_tree(tree, shardings)
    return {n: _numpy(t) for n, t in full.items()} if _rank0() else None


def load_state(model: lm.LMBase, state: dict, device) -> dict:
    """A port optimizer state ({"m", "v"[, "grad_err"]}: {name: full
    numpy}, "step": int) sliced onto ``model``'s layout."""
    lay = model.layout

    def cut(arrays, shard_of):
        return {n: sharding.local_slice(torch.from_numpy(np.array(a)),
                                        shard_of[n]).to(device)
                for n, a in arrays.items()}
    out = {"m": cut(state["m"], lay.moments), "v": cut(state["v"],
                                                       lay.moments),
           "step": torch.tensor(state["step"], dtype=torch.int32,
                                device=device)}
    if "grad_err" in state:
        out["grad_err"] = cut(state["grad_err"], lay.params)
    return out


def sharded_step(device, cfg, shape: tuple, weights: dict, state: dict,
                 batch: dict, opt_kw: dict, n_mb: int = 1,
                 compress: bool = False) -> dict:
    """One train step on a ``shape`` (data, model) mesh from the
    reference's ``weights`` (numpy tree) and the optimizer ``state``
    (:func:`load_state`), on the global ``batch`` (numpy).  Returns, on
    rank 0 (None elsewhere): ``metrics`` (floats), ``grads`` (as the step
    reduces them, before compression), ``params``, ``m``, ``v`` and
    ``grad_err`` after the step, each {name: full numpy}; ``partial``,
    the names summed over ``model`` where the stream is split, and
    ``partial_now``, those the step summed; ``traffic``, the collectives
    of the gradient ({op: [calls, bytes, staged bytes, result bytes]})."""
    from repro_torch.distributed import context
    mesh = make_mesh(shape, AXES, device)
    model = lm.shard(params_from_jax(weights, cfg, device), cfg, mesh)
    lay = model.layout
    opt = load_state(model, state, device)
    tb = {k: torch.from_numpy(np.array(v)).to(device)
          for k, v in batch.items()}
    context.reset_traffic()
    local = step_lib.local_rows(tb, mesh, n_mb)
    split = model.splits_rows(local, cfg)
    _, _, g = step_lib.accumulated_grads(
        step_lib.make_loss(cfg), model, local, n_mb)
    g = step_lib.reduce_grads(g, lay, split)
    traffic = {k: list(v) for k, v in context.traffic.items()}
    grads = _host(g, lay.params)
    train = step_lib.make_train_step(cfg, adamw.AdamWConfig(**opt_kw), n_mb,
                                     compress)
    _, opt, metrics = train(model, opt, tb)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": grads, "step": int(opt["step"]),
           "params": _host(dict(model.named_parameters()), lay.params),
           "m": _host(opt["m"], lay.moments),
           "v": _host(opt["v"], lay.moments),
           "partial": sorted(lay.partial),
           "partial_now": sorted(lay.partial_for(split)), "traffic": traffic,
           "local_m": {n: tuple(t.shape) for n, t in opt["m"].items()}}
    if compress:
        out["grad_err"] = _host(opt["grad_err"], lay.params)
    return out if _rank0() else None


def sharded_serving(device, cfg, shape: tuple, weights: dict, batch: dict,
                    next_tokens: np.ndarray, max_len: int) -> dict:
    """Prefill of the global ``batch`` (numpy: tokens, a VLM's images) and
    then one decode step for each row of ``next_tokens`` (steps, B) on a
    ``shape`` (data, model) mesh, the model from the reference's
    ``weights`` (quantized whole first where ``cfg.nmc_mode`` is not
    "none"), laid out by ``lm.shard``; each rank handed its rows.  Returns
    on rank 0 (None elsewhere), gathered in full (numpy): ``logits``, the
    prefill's and every step's; ``caches``, after the prefill and after
    the last step (as the reference's trees); ``local``, rank 0's cache
    shapes, and ``init_local``, those of its ``lm.init_caches``;
    ``traffic``, the collectives of the last step."""
    from repro_torch.distributed import context
    from repro_torch.models import layers as L
    mesh = make_mesh(shape, AXES, device)
    model = params_from_jax(weights, cfg, device)
    if cfg.nmc_mode != "none":
        model = L.quantize_tree(model)
    model = lm.shard(model, cfg, mesh)
    full = {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in batch.items()}
    rows_sh = sharding.batch_shardings(full, mesh)
    local = {k: sharding.local_slice(v, rows_sh[k]) for k, v in full.items()}
    n = full["tokens"].shape[0]
    logits_sh = sharding.Sharding(mesh, (rows_sh["tokens"].spec[0], None))
    cache_sh = sharding.cache_shardings(
        model.init_caches(cfg, n, max_len, cfg.dtype, "meta"), mesh, n)

    def gathered(logits, caches=None) -> tuple:
        out = _numpy(sharding.gather_full(logits, logits_sh))
        if caches is None:
            return out
        # a copy: a field the layout keeps whole is gathered as itself,
        # and the decode steps update it in place
        return out, sharding.map_tree(
            lambda t, sh: _numpy(sharding.gather_full(t, sh)).copy(), caches,
            cache_sh)
    logits, caches = lm.prefill(model, local, cfg, max_len, global_batch=n)
    first, prefill_caches = gathered(logits, caches)
    steps = [first]
    cache_len = torch.full((n,), full["tokens"].shape[1]
                           + (cfg.n_img_tokens if cfg.family == "vlm"
                              else 0), dtype=torch.int32, device=device)
    tokens = sharding.local_slice(
        torch.from_numpy(np.array(next_tokens)).to(device).T,
        rows_sh["tokens"])
    for i in range(tokens.shape[1]):
        cache_len = cache_len + 1
        context.reset_traffic()
        logits, caches = lm.decode_step(model, tokens[:, i:i + 1], caches,
                                        cache_len, cfg, max_len=max_len)
        traffic = {k: list(v) for k, v in context.traffic.items()}
        steps.append(gathered(logits))
    _, last_caches = gathered(logits, caches)
    def shapes(tree):
        return sharding.map_tree(lambda t, _: tuple(t.shape), tree)
    out = {"logits": steps, "caches": [prefill_caches, last_caches],
           "local": shapes(caches),
           "init_local": shapes(lm.init_caches(model, cfg, n, max_len,
                                               cfg.dtype)),
           "traffic": traffic}
    return out if _rank0() else None


def serving_misuse(device, cfg, max_len: int = 16) -> dict:
    """On a (world / 2, 2) mesh, the ``ValueError`` messages of a prefill
    of two rows that does not give its global batch (``"prefill"``) and of
    a decode step of one row over caches laid out for two (``"decode"``),
    or None where a call went through."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh((world // 2, 2), AXES, device)
    m = lm.shard(lm.init_params(cfg, torch.Generator(device=device)
                                .manual_seed(0), device), cfg, mesh)
    caches = lm.init_caches(m, cfg, 2 * (world // 2), max_len, cfg.dtype)
    tokens = torch.zeros((2, 4), dtype=torch.int64, device=device)
    calls = {"prefill": lambda: lm.prefill(m, {"tokens": tokens}, cfg,
                                           max_len),
             "decode": lambda: lm.decode_step(
                 m, tokens[:1, :1], caches,
                 torch.full((1,), 5, dtype=torch.int32, device=device), cfg,
                 max_len=max_len)}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def row_parallel_w8a8(device, w: np.ndarray, b: np.ndarray,
                      x: np.ndarray) -> dict | None:
    """A W8A8 linear of the float ``w`` (d_in, d_out) and bias ``b``,
    quantized whole, against its row-parallel layout over every rank of
    the world (a (1, world) mesh): on rank 0 whether the int32
    accumulator summed over ``model`` (``context.sum_exact``) equals the
    single-rank accumulator, and the layer's output the single-rank
    output, bit for bit (the plain ``nmc_matmul`` on the CPU)."""
    from repro_torch.distributed import context
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L
    world = dist.get_world_size()
    mesh = make_mesh((1, world), AXES, device)
    whole = L.NmcLinear(torch.from_numpy(w).to(device),
                        torch.from_numpy(b).to(device)).quantized()
    xt = torch.from_numpy(x).to(device)
    names = {"w_q": ("model", None), "scale": (None,), "b": (None,)}
    part = L.NmcLinear(
        **{k: sharding.local_slice(getattr(whole, k),
                                   sharding.Sharding(mesh, spec))
           for k, spec in names.items()})
    part.parallel, part.mesh = "row", mesh
    part.amax_axes, part.amax_mesh = (context.MODEL_AXIS,), mesh
    k = w.shape[0] // world
    x_loc = xt.narrow(-1, mesh.index(context.MODEL_AXIS) * k, k)
    xq, _ = ref.quantize_dynamic(xt)
    acc = context.sum_exact(
        ops.nmc_matmul(xq.narrow(-1, mesh.index(context.MODEL_AXIS) * k, k)
                       .contiguous(), part.w_q, None, out_dtype=torch.int32),
        context.MODEL_AXIS, mesh)
    want = ops.nmc_matmul(xq, whole.w_q, None, out_dtype=torch.int32)
    y = part(x_loc, nmc_mode="w8a8", act="silu")
    y1 = whole(xt, nmc_mode="w8a8", act="silu")
    if not _rank0():
        return None
    return {"accumulator_equal": bool(torch.equal(acc, want)),
            "output_equal": bool(torch.equal(y, y1)),
            "accumulator_dtype": str(acc.dtype)}


def gather_to_heads_check(device, seed: int = 0, heads: int = 3,
                          head_dim: int = 4) -> dict | None:
    """On a (1, world) mesh: column slices of x (rows, heads * head_dim)
    gathered into every head, a function that mixes the columns of each
    head (x times its head's softmax), each rank's columns of the result
    times its rows of ``w`` (a row-parallel product, summed over
    ``model``), the loss the sum of squares; 3 heads of 4 cut through a
    head on 2 and on 4 ranks.  Returns on rank 0 (None elsewhere) the
    largest difference, over the largest value, between the gradient of
    x (the ranks' slices gathered) and one rank's gradient of the same
    loss, for ``context.gather_to_heads`` and for ``gather_from_model``
    in its place."""
    from repro_torch.distributed import context
    world = dist.get_world_size()
    mesh = make_mesh((1, world), AXES, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    width = heads * head_dim
    x = torch.randn((5, width), generator=gen, device=device)
    w = torch.randn((width, 7), generator=gen, device=device)

    def mix(z):
        h = z.reshape(z.shape[0], heads, head_dim)
        return (h * torch.softmax(h, dim=-1)).reshape(z.shape)
    whole = x.clone().requires_grad_(True)
    (mix(whole) @ w).pow(2).sum().backward()
    n = width // world
    i = mesh.index(context.MODEL_AXIS)
    out = {}
    for name, gather in (("gather_to_heads", context.gather_to_heads),
                         ("gather_from_model", context.gather_from_model)):
        part = x.narrow(-1, i * n, n).clone().requires_grad_(True)
        y = mix(gather(part, mesh)).narrow(-1, i * n, n) @ \
            w.narrow(0, i * n, n)
        context.reduce_from_model(y, mesh).pow(2).sum().backward()
        g = context.all_gather(part.grad, context.MODEL_AXIS, mesh, -1)
        out[name] = float((g - whole.grad).abs().max()
                          / whole.grad.abs().max())
    return out if _rank0() else None


def tanh_stage(params: dict, h: torch.Tensor) -> torch.Tensor:
    """The reference test's stage: ``tanh(h @ w + b)``."""
    return torch.tanh(h @ params["w"] + params["b"])


def pipeline_check(device, stage_fn, stages: list, x: np.ndarray,
                   n_micro: int, axis: str = "pod") -> dict:
    """``pipeline_apply(stage_fn, stages[s], x)`` on a one-axis mesh of
    every rank (rank s holds stage s) against the stages in sequence on
    every rank.  ``stages``: each stage's {name: numpy array}."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh((world,), (axis,), device)
    stages = [{k: torch.from_numpy(np.array(v)).to(device)
               for k, v in st.items()} for st in stages]
    xt = torch.from_numpy(x).to(device)
    y = pipeline.pipeline_apply(stage_fn, stages[mesh.coords[axis]], xt,
                                mesh=mesh, axis=axis,
                                n_microbatches=n_micro)
    ref = xt
    for params in stages:
        ref = stage_fn(params, ref)
    return {"err": float((y - ref).abs().max()),
            "bubble": pipeline.bubble_fraction(world, n_micro)}


def elastic_check(device, cfg, tc_kw: dict, data_kw: dict, opt_kw: dict,
                  fail_at: int | None, shape_a: tuple, model_b: int) -> dict:
    """A trainer on mesh ``shape_a`` with a crash injected at ``fail_at``
    (each step's loss and each checkpoint's bytes and seconds recorded;
    its launches counted), its last checkpoint restored in full and
    resharded onto a mesh of ``model_b`` ranks on ``model``
    (``elastic.make_mesh_for``) by ``elastic.reshard_state``, and restored
    there by ``ckpt.restore`` with shardings: both held to the written
    state bit for bit, slice by slice (:func:`_equal_slices`); the
    parameters moved back onto
    ``shape_a`` by ``reshard_state`` from their shardings on the new mesh,
    likewise; then one more step on the new mesh.  ``tc_kw["ckpt_dir"]``
    must start empty.  Returns, on rank 0, what was recorded and whether
    each equality held (the launch counts on the other ranks)."""
    import time
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t0 = time.perf_counter()
    tc = TrainerConfig(**tc_kw)
    data_cfg, opt_cfg = DataConfig(**data_kw), adamw.AdamWConfig(**opt_kw)
    tr = Trainer(cfg, tc, opt_cfg, data_cfg,
                 mesh=make_mesh(shape_a, AXES, device))
    steps, saves = [], []
    orig_step, orig_batch = tr._train_step, tr.batch_at
    orig_write = ckpt.write_host

    def batch_at(step):
        steps.append({"step": step})
        return orig_batch(step)

    def train_step(*args):
        res = orig_step(*args)
        steps[-1]["loss"] = float(res[2]["loss"])
        return res

    def write_host(path, step, host):
        t = time.perf_counter()
        res = orig_write(path, step, host)
        saves.append({"step": step, "seconds": time.perf_counter() - t,
                      "bytes": sum(a.nbytes for a, _ in host.values())})
        return res
    tr.batch_at, tr._train_step = batch_at, train_step
    ckpt.write_host = write_host
    _reset(device)
    try:
        t1 = time.perf_counter()
        run = tr.run(fail_at=fail_at)
        run_s = time.perf_counter() - t1
        counted = _counted(device)
        tr.checkpointer.close()
    finally:
        ckpt.write_host = orig_write
    del tr
    _free(device)
    last = ckpt.latest_step(tc.ckpt_dir)

    t1 = time.perf_counter()
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh_b = elastic.make_mesh_for(world, model_b, device)
    tr_b = Trainer(cfg, tc, opt_cfg, data_cfg, mesh=mesh_b)
    model, opt, _ = tr_b.init_state()
    shard_b = model.layout.state_shardings(opt)
    local = {"params": dict(model.named_parameters()), "opt": opt}
    written = ckpt.restore(tc.ckpt_dir, last, _full_like(local, shard_b))
    moved = elastic.reshard_state(written, mesh_b, lambda tree, m: shard_b)
    same = {"reshard": _equal_slices(moved, shard_b, written, device),
            "restore": _equal_slices(
                ckpt.restore(tc.ckpt_dir, last, local, shard_b), shard_b,
                written, device)}
    mesh_a = make_mesh(shape_a, AXES, device)
    shard_a = sharding.param_shardings(written["params"], mesh_a)
    back = elastic.reshard_state(moved["params"], mesh_a,
                                 lambda tree, m: shard_a, shard_b["params"])
    same["round_trip"] = _equal_slices(back, shard_a, written["params"],
                                       device)
    del written, back
    with torch.no_grad():
        for n, p in local["params"].items():
            p.copy_(moved["params"][n])
    opt = {k: ({n: t.to(device) for n, t in v.items()}
               if isinstance(v, dict) else v.to(device))
           for k, v in moved["opt"].items()}
    del moved
    restore_s = time.perf_counter() - t1
    _reset(device)
    _, _, metrics = tr_b._train_step(model, opt, tr_b.batch_at(last))
    counted_b = _counted(device)
    tr_b.checkpointer.close()
    del model, opt, local, tr_b
    _free(device)
    dist.barrier()
    out = {"run": {k: run[k] for k in ("final_step", "restarts")},
           "steps": steps, "checkpoints": saves, "run_seconds": run_s,
           "last": last, "same": same, "restore_seconds": restore_s,
           "resumed_loss": float(metrics["loss"]), "counted": counted,
           "counted_resumed": counted_b,
           "seconds": time.perf_counter() - t0}
    return out if _rank0() else {k: out[k] for k in ("counted",
                                                     "counted_resumed")}


def _full_like(local: dict, shardings: dict) -> dict:
    """Tensors of the full shapes (uncommitted host memory) for ``local``
    under ``shardings``."""
    if isinstance(local, dict):
        return {k: _full_like(v, shardings[k]) for k, v in local.items()}
    shape = list(local.shape)
    for dim, part in enumerate(shardings.spec):
        if part is not None:
            shape[dim] *= shardings.mesh.size(part)
    return torch.empty(shape, dtype=local.dtype)


def _equal_slices(local: dict, shardings: dict, full: dict,
                  device) -> bool:
    """Whether ``local`` gathered under ``shardings`` equals ``full`` bit
    for bit: every rank's slice equal to the same slice of ``full``
    (:func:`sharding.local_slice`, the inverse of ``gather_full``), agreed
    over the world by one all-reduce of a flag; nothing is gathered."""
    def same(loc, sh, ful) -> bool:
        if isinstance(loc, dict):
            return all(same(loc[k], sh[k], ful[k]) for k in sorted(loc))
        return bool(torch.equal(loc.cpu(),
                                sharding.local_slice(ful, sh).cpu()))
    differ = torch.tensor([0 if same(local, shardings, full) else 1],
                          device=device)
    if dist.is_initialized():
        dist.all_reduce(differ)
    return int(differ) == 0


def sequence(device, calls: list) -> list:
    """Run ``calls``, a list of (name of a function of this module,
    positional arguments), in order on every rank: one world for many
    checks.  Returns their results."""
    return [globals()[name](device, *args) for name, args in calls]


# ---------------------------------------------------------------------------
# on the card: chip_smoke.phase_scaleout's ranks (gloo, one card shared)
# ---------------------------------------------------------------------------

def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, 0 where both are 0."""
    num = float(torch.linalg.vector_norm(a.float() - b.float()))
    den = float(torch.linalg.vector_norm(b.float()))
    return num / den if den else (0.0 if num == 0.0 else float("inf"))


class _AttentionRecorder:
    """Records every ``flash_attention`` launch the models make (inputs,
    keywords, output) at the dispatch layer, the wrapper still counting."""

    def __enter__(self):
        import types
        from repro_torch.kernels import ops
        self.calls, self._ops, self._orig = [], ops, ops._fa
        orig = ops._fa.flash_attention

        def rec(*args, **kw):
            out = orig(*args, **kw)
            self.calls.append((args, kw, out))
            return out
        ops._fa = types.SimpleNamespace(flash_attention=rec)
        return self

    def __exit__(self, *exc):
        self._ops._fa = self._orig

    def replay(self) -> dict:
        """Every launch against the plain version (``kernels/checks.py``'s
        tolerances, the log-sum-exp's too where a launch returned it;
        raises beyond them): launches, shapes, the route each
        launch takes by ``flash_attention.route`` (launches and max abs
        err by route), max abs err."""
        from repro_torch.kernels import checks as kchecks
        from repro_torch.kernels import flash_attention as fa
        worst, shapes, routes, by_route = 0.0, {}, {}, {}
        with torch.no_grad():
            for i, (args, kw, out) in enumerate(self.calls):
                want = fa.chunked_attention(*args, **kw)
                err = kchecks.close_attention(f"attention launch {i}", out,
                                              want, args[0].dtype)
                worst = max(worst, err)
                key = str(tuple(args[0].shape))
                shapes[key] = shapes.get(key, 0) + 1
                r = fa.route(args[0].dtype, args[0].shape[-1],
                             args[2].shape[-1])
                routes[r] = routes.get(r, 0) + 1
                by_route[r] = max(by_route.get(r, 0.0), err)
        return {"launches": len(self.calls), "shapes": shapes,
                "routes": routes, "max_abs_err_by_route": by_route,
                "max_abs_err": worst}


class _MatmulRecorder:
    """Records every ``nmc_matmul`` launch the models make (inputs,
    keywords, output) at the dispatch layer, the wrapper still counting;
    :meth:`replay` holds each against the plain version: the raw int32
    accumulator (a row-parallel W8A8 linear's partial product) bit for
    bit, every other output at ``kernels/checks.matmul_tolerance``."""

    def __enter__(self):
        import types
        from repro_torch.kernels import ops
        self.calls, self._ops, self._orig = [], ops, ops._mm
        orig = ops._mm.nmc_matmul

        def rec(x_q, w_q, scale, bias=None, **kw):
            out = orig(x_q, w_q, scale, bias, **kw)
            self.calls.append((x_q, w_q, scale, bias, kw, out))
            return out
        ops._mm = types.SimpleNamespace(nmc_matmul=rec)
        return self

    def __exit__(self, *exc):
        self._ops._mm = self._orig

    def replay(self) -> dict:
        """Launches, int32-out launches, launches by (M, K, N) and output
        dtype, whether every int32-out one is bit-equal, and the other
        launches' max abs err (raises beyond their tolerance)."""
        from repro_torch.kernels import checks as kchecks
        from repro_torch.kernels import ref
        shapes, equal, int32, worst = {}, True, 0, 0.0
        with torch.no_grad():
            for i, (x_q, w_q, scale, bias, kw, out) in enumerate(self.calls):
                want = ref.nmc_matmul(x_q, w_q, scale, bias, **kw)
                if out.dtype == torch.int32:
                    int32 += 1
                    equal &= bool(torch.equal(out, want))
                else:
                    worst = max(worst, kchecks.close(
                        f"nmc_matmul launch {i}", out, want,
                        *kchecks.matmul_tolerance(kw.get("act", "none"),
                                                  out.dtype)))
                key = str((x_q.shape[0], *w_q.shape, str(out.dtype)))
                shapes[key] = shapes.get(key, 0) + 1
        return {"launches": len(self.calls), "int32": int32,
                "shapes": shapes, "bit_equal": equal, "max_abs_err": worst}


class _MoEDrops:
    """``[(tokens, assignments, assignments dropped)]`` of every MoE
    routing inside the block, in call order (``moe.route`` wrapped)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.calls, self._moe, self._orig = [], moe, moe.route

        def route(x, wr, cfg):
            r = self._orig(x, wr, cfg)
            self.calls.append((int(x.shape[0]), int(r.keep.numel()),
                               int((~r.keep).sum())))
            return r
        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._orig


class _TrafficBySite:
    """Collectives a rank runs inside each site of ``sites`` ({label:
    (class, method name)}, the methods wrapped for the block), by label
    and op: [calls, bytes] (``context.traffic``'s count); a site nested in
    another counts in the inner one only.  A backward's collectives run
    outside every forward method and count in none."""

    def __init__(self, sites: dict):
        self.sites = sites

    def __enter__(self):
        from repro_torch.distributed import context
        self.by_site, self._stack, self._wrapped = {}, [], []
        self._ctx, self._count = context, context._count

        def count(op, t, staged, result):
            self._count(op, t, staged, result)
            if self._stack:
                row = self.by_site.setdefault(self._stack[-1], {}) \
                    .setdefault(op, [0, 0])
                row[0] += 1
                row[1] += t.numel() * t.element_size()
        context._count = count
        for label, (cls, name) in self.sites.items():
            orig = getattr(cls, name)

            def wrapped(*args, _orig=orig, _label=label, **kw):
                self._stack.append(_label)
                try:
                    return _orig(*args, **kw)
                finally:
                    self._stack.pop()
            setattr(cls, name, wrapped)
            self._wrapped.append((cls, name, orig))
        return self

    def __exit__(self, *exc):
        self._ctx._count = self._count
        for cls, name, orig in self._wrapped:
            setattr(cls, name, orig)


def _xlstm_sites() -> dict:
    """(h)'s forward gathers: the mLSTM's ``u``, the sLSTM's hidden states
    (``forward`` outside its FFN) and its FFN's ``u``."""
    from repro_torch.models import xlstm
    return {"mlstm_u": (xlstm.MLSTM, "_proj"),
            "slstm_hs": (xlstm.SLSTM, "forward"),
            "slstm_ffn_u": (xlstm.SLSTM, "_ffn")}


def _launches() -> dict:
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa
    mm = kernels.nmc_matmul.nmc_matmul
    return {"flash_attention": fa.flash_attention.launches,
            "nmc_matmul": mm.launches,
            "attention_routes": dict(fa.flash_attention.launches_by_route),
            "matmul_routes": dict(mm.launches_by_route),
            "matmul_int32": mm.launches_int32}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _reset(device):
    from repro_torch import kernels
    from repro_torch.distributed import context
    _sync(device)
    kernels.reset_launch_counts()
    context.reset_traffic()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _counted(device) -> dict:
    from repro_torch.distributed import context
    _sync(device)
    return {**_launches(), "traffic": {k: list(v) for k, v in
                                       context.traffic.items()}}


def _peak_gb(device):
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


def _free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class _Events:
    """ms between two points by CUDA events (the host clock elsewhere)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def __enter__(self):
        import time
        if self.cuda:
            self.e = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            self.e[0].record()
        self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time
        if self.cuda:
            self.e[1].record()
            self.e[1].synchronize()
            self.ms = self.e[0].elapsed_time(self.e[1])
        else:
            self.ms = (time.perf_counter() - self.t) * 1e3


def _mid_run_state(shapes: dict, layout, seed: int, device) -> dict:
    """Moments of step 2: ``m`` zero, ``v`` ``1e-4 (1 + r^2)`` with r drawn
    from ``seed`` (the same on every rank, at full shapes, one tensor at a
    time), sliced onto ``layout``.  ``v`` above the clipped gradient's
    square makes the update linear in the gradient (from zero moments
    AdamW's first step is its sign, and a gradient that is rounding noise
    would flip it)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    m, v = {}, {}
    for n, shape in shapes.items():
        a = torch.zeros(shape, device=device)
        b = torch.randn(shape, generator=gen, device=device)
        b = 1e-4 * (1 + b * b)
        if layout is not None:
            a = sharding.local_slice(a, layout.moments[n])
            b = sharding.local_slice(b, layout.moments[n])
        m[n], v[n] = a, b
    return {"m": m, "v": v,
            "step": torch.tensor(2, dtype=torch.int32, device=device)}


def _model(cfg, seed: int, device, mesh=None) -> tuple:
    """(model drawn from ``seed``, laid out on ``mesh`` if given; its full
    parameter shapes)."""
    model = lm.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(seed), device)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    if mesh is not None:
        lm.shard(model, cfg, mesh)
    return model, shapes


def _reference(cfg, batch: dict, spec: dict, device) -> dict:
    """The single-rank step on rank 0: the loss and gradient through the
    kernels, the plain path's own spread under 1-ulp input noise (each
    gradient's limit), and the parameters after one update from the
    mid-run state.  A step that launched no kernel (the xLSTM's) is its
    own plain version, and is not run again."""
    from repro_torch.kernels import ops
    n_mb, seed = spec["n_mb"], spec["seed"]
    model, shapes = _model(cfg, seed, device)
    loss_fn = step_lib.make_loss(cfg)
    before = _launches()
    loss_k, _, g_k = step_lib.accumulated_grads(loss_fn, model, batch, n_mb)
    _sync(device)
    after = _launches()
    with ops.force_plain():
        if any(after[k] != before[k] for k in ("flash_attention",
                                                "nmc_matmul")):
            loss_p, _, g_p = step_lib.accumulated_grads(loss_fn, model,
                                                        batch, n_mb)
        else:
            loss_p, g_p = loss_k, g_k
        with nudged_inputs(model, seed + 1):
            loss_u, _, g_u = step_lib.accumulated_grads(loss_fn, model,
                                                        batch, n_mb)
    limits = {n: max(spec["grad_spread"] * rel_l2(g_u[n], g_p[n]),
                     spec["grad_floor"]) for n in g_k}
    del g_p, g_u
    params = dict(model.named_parameters())
    opt = _mid_run_state(shapes, None, seed + 2, device)
    adamw.apply_updates(params, dict(g_k), opt,
                        adamw.AdamWConfig(**spec["opt"]))
    del opt
    return {"loss": float(loss_k), "loss_plain": float(loss_p),
            "loss_spread": abs(float(loss_u) - float(loss_p))
            / abs(float(loss_p)),
            "grads": g_k, "limits": limits,
            "params": {n: p.detach() for n, p in params.items()}}


def nudged_inputs(model, seed: int, every_step: bool = False):
    """A context in which ``model``'s embedded inputs are moved by one ulp
    of their dtype at half the positions, the gradient passing through
    unchanged: the plain path's own spread under 1-ulp noise.  With
    ``every_step`` the token embedding's output is moved instead, at the
    prompt and at every decode step (a model whose input is its embedded
    tokens: the xLSTM); else the prompt's inputs only (``model.inputs``:
    a VLM's images and an encoder-decoder's positions too)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        obj, name = (model.embed, "forward") if every_step \
            else (model, "inputs")
        orig = getattr(obj, name)
        gen = torch.Generator(device=model.device).manual_seed(seed)

        def nudged(*args, **kw):
            x = orig(*args, **kw)
            flip = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
            host = x.detach().cpu()
            up = torch.nextafter(host, torch.full_like(host, 1e30))
            return x + torch.where(flip, (up - host).to(x.device),
                                   torch.zeros_like(x))
        setattr(obj, name, nudged)
        try:
            yield
        finally:
            delattr(obj, name)
    return ctx()


def _compare(got: dict, ref: dict, limits: dict) -> dict:
    """Each tensor's relative L2 against the reference's over its limit:
    the worst and every one past its limit."""
    worst, bad = {"name": None, "ratio": 0.0}, []
    for n, want in sorted(ref.items()):
        err = rel_l2(got[n], want)
        ratio = err / limits[n]
        if ratio > worst["ratio"]:
            worst = {"name": n, "ratio": ratio, "rel_l2": err,
                     "limit": limits[n]}
        if not err <= limits[n]:
            bad.append((n, err, limits[n]))
    return {"worst": worst, "bad": bad}


class _StepGrads:
    """Keeps the gradients a train step hands to the optimizer (reduced
    over the mesh, before clipping): ``adamw.apply_updates`` wrapped for
    the block."""

    def __enter__(self):
        self.grads, self._orig = None, adamw.apply_updates

        def keep(params, grads, *args, **kw):
            self.grads = grads
            return self._orig(params, grads, *args, **kw)
        adamw.apply_updates = keep
        return self

    def __exit__(self, *exc):
        adamw.apply_updates = self._orig


def _sharded_run(cfg, mesh, batch: dict, spec: dict, ref: dict | None,
                 device, profile: bool) -> dict:
    """One sharded train step from the mid-run state (the main path: its
    launches counted, every attention launch recorded and replayed; an
    xLSTM's collectives also by site, :func:`_xlstm_sites`), its events
    ms (and device ms when ``profile``), its gradients and updated
    parameters gathered against ``ref`` on rank 0."""
    n_mb, seed = spec["n_mb"], spec["seed"]
    model, shapes = _model(cfg, seed, device, mesh)
    lay = model.layout
    opt = _mid_run_state(shapes, lay, seed + 2, device)
    local = dict(model.named_parameters())
    dsize = mesh.size(mesh.data_axes())
    out = {"local_moments": sum(t.numel() for t in opt["m"].values()),
           "full_moments": sum(int(np.prod(s)) for s in shapes.values()),
           "moments_whole": sorted(n for n, t in opt["m"].items()
                                   if dsize > 1 and
                                   t.numel() == local[n].numel()),
           "moments_split": sum(t.numel() * dsize == local[n].numel()
                                for n, t in opt["m"].items()),
           "n_tensors": len(local)}
    train = step_lib.make_train_step(cfg, adamw.AdamWConfig(**spec["opt"]),
                                     n_mb)
    _reset(device)
    profile = profile and _rank0() and torch.device(device).type == "cuda"
    sites = _xlstm_sites() if cfg.family == "xlstm" else {}
    with _AttentionRecorder() as rec, _StepGrads() as kept, \
            _MoEDrops() as drops, _TrafficBySite(sites) as by_site:
        with _profiler() if profile else _null() as p:
            with _Events(device) as ev:
                _, opt, metrics = train(model, opt, batch)
            out["counted"] = _counted(device)
    out["moe_drops"] = drops.calls
    out["traffic_by_site"] = by_site.by_site
    out["partial"] = sorted(lay.partial)
    out["step_ms"] = ev.ms
    if profile:
        out["step_device_ms"] = _device_ms(p)
    out["peak_gb"] = _peak_gb(device)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["replay"] = rec.replay()
    del rec
    full = gather_tree(kept.grads, lay.params)
    del kept
    if ref is not None and _rank0():
        out["grads"] = _compare(full, ref["grads"], ref["limits"])
    del full
    params = gather_tree(dict(model.named_parameters()), lay.params)
    if ref is not None and _rank0():
        out["loss_rel"] = abs(out["metrics"]["loss"] - ref["loss"]) \
            / abs(ref["loss"])
        out["params"] = _compare(params, ref["params"], ref["limits"])
    return out


def _null():
    import contextlib
    return contextlib.nullcontext()


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _device_ms(prof) -> float | None:
    """The kernels' device time in a profile, None where it saw none."""
    from torch.autograd import DeviceType
    us = sum(ev.self_device_time_total for ev in prof.events()
             if ev.device_type != DeviceType.CPU
             and not getattr(ev, "is_user_annotation", False))
    return us * 1e-3 or None


#: ``chip_scaleout``'s one-step parts, in order: (part, config key of the
#: spec, mesh shape); (b) and (k) reuse (a)'s reference
STEP_PARTS = (("a", "qwen", (1, 2)), ("b", "qwen", (2, 1)),
              ("k", "qwen_sp", (1, 2)),
              ("c", "moe", (1, 2)), ("f", "mla", (1, 2)),
              ("g", "hybrid", (1, 2)), ("h", "xlstm", (1, 2)),
              ("i", "encdec", (1, 2)), ("j", "vlm", (1, 2)),
              ("v_mla", "mla_1h", (1, 2)), ("v_ssm", "hybrid_1h", (1, 2)))


def chip_scaleout(device, spec: dict) -> dict:
    """``chip_smoke.phase_scaleout`` on every rank of a world of two over
    gloo, both on ``device``: (a) tensor parallelism, qwen on (1, 2); (b)
    data parallelism with ZeRO-2, qwen on (2, 1); (c) expert parallelism,
    the cut moonshot on (1, 2); (d) the trainer on (1, 2) with a crash,
    of ``spec["trainer_model"]`` (qwen cut in depth), its checkpoint
    restored onto (2, 1) through ``reshard_state``; (e) the
    pipeline, qwen's blocks in 2 stages; (f) MLA with expert parallelism,
    the cut deepseek on (1, 2), 8 heads and 32 experts a rank; (g) Mamba2
    tensor parallelism, the cut zamba2 on (1, 2), 40 SSM and 16 attention
    heads a rank, its shared block applied by each of 2 groups; (h) xLSTM
    tensor parallelism, xlstm on (1, 2), 2 mLSTM and 2 sLSTM heads a rank;
    (i) the encoder-decoder, whisper on (1, 2), 3 heads a rank, ``embed``
    and ``head`` whole; (j) the VLM, the cut pixtral on (1, 2), 16 query
    and 4 KV heads a rank, ``img_proj`` whole; (k) sequence parallelism
    with activation checkpointing, (a)'s model, batch and mesh with
    ``seq_parallel`` and ``remat`` on, against (a)'s reference; (l)-(n)
    W8A8 serving on (1, 2) (:func:`_chip_serving`): qwen, deepseek and
    zamba2 at full width cut in depth; (o) that zamba2 with float weights
    in float32; (p) whisper at full width and depth and (q) xlstm at full
    width cut in depth, W8A8 (their cross K/V and states laid out by
    ``cache_shardings``); (r) that xlstm with float weights in float32;
    (v) a step and W8A8 serving of deepseek-smoke with one MLA head and
    zamba2-smoke with one SSM head on (1, 2), every head on every rank;
    (w) whisper W8A8 serving 4 rows on (2, 1), its 4-layer stack split over
    ``data`` (ROADMAP fact 21).  ``spec`` holds the configs, sizes and limits;
    ``spec["batches"]`` a part's (rows, sequence) where it differs from
    ``spec["rows"]`` and ``spec["seq"]``; ``spec["serve_sizes"]`` a
    serving part's sizes where they differ from ``spec["serve"]``.
    Returns each part's results and this rank's counted launches and
    collectives."""
    import time
    out, t_all = {"rank": dist.get_rank()}, time.perf_counter()
    for part, key, shape in STEP_PARTS:
        t0 = time.perf_counter()
        cfg = spec[key]
        batch = _batch_of(cfg, spec, key, device)
        if part not in ("b", "k"):            # they reuse (a)'s reference
            refs = _reference(cfg, batch, spec, device) if _rank0() else None
            _free(device)
            dist.barrier()
        mesh = make_mesh(shape, AXES, device)
        res = _sharded_run(cfg, mesh, batch, spec, refs, device,
                           profile=part == "a")
        if _rank0():
            res["reference"] = {k: refs[k] for k in ("loss", "loss_plain",
                                                     "loss_spread")}
        if part not in ("a", "b"):            # (k), after them, is the last
            refs = None
        _free(device)
        dist.barrier()
        res["seconds"] = time.perf_counter() - t0
        out[part] = res
    for part, key, shape in SERVE_PARTS:
        t0 = time.perf_counter()
        res = _chip_serving(device, spec[key], spec, shape,
                            spec.get("serve_sizes", {}).get(part,
                                                            spec["serve"]))
        res["seconds"] = time.perf_counter() - t0
        out[part] = res
    tr = spec["trainer"]
    out["d"] = elastic_check(
        device, spec["trainer_model"],
        dict(total_steps=tr["total_steps"], ckpt_every=tr["ckpt_every"],
             ckpt_dir=tr["ckpt_dir"], log_every=1, n_microbatches=tr["n_mb"],
             seed=spec["seed"]),
        dict(global_batch=tr["rows"], seq_len=tr["seq"], seed=0),
        spec["opt"], tr["fail_at"], (1, 2), 1)
    out["e"] = _chip_pipeline(device, spec)
    out["seconds"] = time.perf_counter() - t_all
    return out


def _batch_of(cfg, spec: dict, key: str, device) -> dict:
    """A train part's global batch (``spec["batches"][key]``'s rows and
    sequence, else ``spec["rows"]`` and ``spec["seq"]``), seed 0."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    rows, seq = spec.get("batches", {}).get(key, (spec["rows"],
                                                  spec["seq"]))
    data = SyntheticLM(DataConfig(global_batch=rows, seq_len=seq, seed=0),
                       cfg)
    return {k: torch.from_numpy(v).to(device)
            for k, v in data.batch_at(0).items()}


def chip_every_head(device, spec: dict) -> dict:
    """A part of ``chip_smoke.phase_scaleout`` on every rank of a world
    whose ``model`` axis does not divide the model's heads, so that each
    rank runs every head ((s) whisper-tiny on (1, 4), 1.5 heads a rank;
    (t) xlstm-125m on (1, 8), half a head a rank; (u) deepseek-v2-lite on
    (1, 3), 16 MLA heads, ``wq`` split through a head), all on ``device``: one
    train step of ``spec[spec["train"]]`` from the mid-run state against
    rank 0's single-rank step (:func:`_sharded_run`), then serving of
    ``spec[spec["serve"]]`` at ``spec["serve_sizes"][spec["part"]]``
    against rank 0's single-rank serving (:func:`_chip_serving`), both on
    (1, world).  Returns this rank's results of each (``"train"``,
    ``"serve"``) with their seconds."""
    import time
    shape = (1, dist.get_world_size())
    out = {"rank": dist.get_rank()}
    t0 = time.perf_counter()
    cfg = spec[spec["train"]]
    batch = _batch_of(cfg, spec, spec["train"], device)
    refs = _reference(cfg, batch, spec, device) if _rank0() else None
    _free(device)
    dist.barrier()
    res = _sharded_run(cfg, make_mesh(shape, AXES, device), batch, spec,
                       refs, device, profile=False)
    if _rank0():
        res["reference"] = {k: refs[k] for k in ("loss", "loss_plain",
                                                 "loss_spread")}
    del refs, batch
    _free(device)
    dist.barrier()
    res["seconds"] = time.perf_counter() - t0
    out["train"] = res
    t0 = time.perf_counter()
    res = _chip_serving(device, spec[spec["serve"]], spec, shape,
                        spec["serve_sizes"][spec["part"]])
    res["seconds"] = time.perf_counter() - t0
    out["serve"] = res
    return out


#: ``chip_scaleout``'s serving parts: (part, config key, mesh shape)
SERVE_PARTS = (("l", "serve_dense", (1, 2)), ("m", "serve_mla", (1, 2)),
               ("n", "serve_hybrid", (1, 2)),
               ("o", "serve_hybrid_float", (1, 2)),
               ("p", "serve_encdec", (1, 2)), ("q", "serve_xlstm", (1, 2)),
               ("r", "serve_xlstm_float", (1, 2)),
               ("v_mla_serve", "serve_mla_1h", (1, 2)),
               ("v_ssm_serve", "serve_hybrid_1h", (1, 2)),
               ("w", "serve_encdec", (2, 1)))


def _serving_model(cfg, seed: int, device, mesh=None):
    """The serving model drawn from ``seed``, under W8A8 each block
    quantized as drawn (the full weights, then laid out on ``mesh`` if
    given)."""
    from repro_torch.models import layers as L
    each = L.quantize_tree if cfg.nmc_mode == "w8a8" else (lambda m: m)
    model = lm.draw_blocks(cfg, torch.Generator(device=device)
                           .manual_seed(seed), device, each)
    return model if mesh is None else lm.shard(model, cfg, mesh)


def _serve(model, cfg, batch: dict, tokens, max_len: int, n: int,
           greedy: bool = False) -> dict:
    """Prefill ``batch`` then one decode step per column of ``tokens``
    (rows, steps; with ``greedy`` the previous step's top-1 instead, the
    first taken from ``tokens``): the logits of every step, the caches
    after the prefill (cloned) and at the end, the tokens fed, the
    launches (prefill and steps) and the first step's collectives."""
    from repro_torch.distributed import context
    logits, caches = lm.prefill(model, batch, cfg, max_len, global_batch=n)
    out = {"logits": [logits],
           "prefill_caches": sharding.map_tree(lambda t, _: t.clone(),
                                               caches, caches)}
    pos = batch["tokens"].shape[1] + (cfg.n_img_tokens
                                      if cfg.family == "vlm" else 0)
    cache_len = torch.full((n,), pos, dtype=torch.int32,
                           device=logits.device)
    fed = []
    for i in range(tokens.shape[1]):
        tok = logits.argmax(-1, keepdim=True).to(torch.int32) \
            if greedy and i else tokens[:, i:i + 1]
        fed.append(tok)
        cache_len = cache_len + 1
        if i == 0:
            traffic = {k: list(v) for k, v in context.traffic.items()}
        logits, caches = lm.decode_step(model, tok, caches, cache_len, cfg,
                                        max_len=max_len)
        if i == 0:
            out["step_traffic"] = {
                k: [a - b for a, b in zip(v, traffic.get(k, [0, 0, 0, 0]))]
                for k, v in context.traffic.items()
                if v[0] != traffic.get(k, [0])[0]}
        out["logits"].append(logits)
    out.update(caches=caches, tokens=torch.cat(fed, dim=1))
    return out


def _logit_stats(got: torch.Tensor, want: torch.Tensor) -> dict:
    got, want = got.float(), want.float()
    return {"max_abs_diff": float((got - want).abs().max()),
            "rms_diff": float((got - want).pow(2).mean().sqrt()),
            "logit_std": float(want.std()),
            "top1_agreement": float((got.argmax(-1) == want.argmax(-1))
                                    .float().mean())}


def _chip_serving(device, cfg, spec: dict, shape: tuple,
                  sv: dict) -> dict:
    """One serving part on every rank (every attention and ``nmc_matmul``
    launch of the sharded run replayed against the plain versions): rank
    0 first serves the W8A8 model on its own
    (prefill of ``sv``'s rows and prompt, an encoder-decoder's with
    ``sv["frames"]`` frame embeddings a row, then greedy decode
    steps; and once more with its prefill's embedded inputs moved by one
    ulp, or with ``sv["spread_every_step"]`` every step's embedded tokens:
    the model's own spread), the tokens it fed are broadcast, and
    the model laid out on ``shape`` serves the same tokens (each rank its
    rows).  Returns this rank's launches (prefill and steps:
    ``nmc_matmul`` by route and int32-out, ``flash_attention`` by route)
    and the first decode step's collectives; on rank 0 the single-rank
    run's launches, the sharded logits (every step, rows gathered) against
    the single rank's and the spread's against it, and the gathered caches
    after the prefill and at the end against the single rank's, by field
    (but an empty stack's):
    max abs err, whether within ``kernels/checks.attention_tolerance``
    (all of it, and the prompt's slots, which no decode step writes: None
    for a state with no slots), relative L2, and the spread's relative
    L2."""
    from repro_torch.distributed import context
    from repro_torch.kernels import checks as kchecks
    rows, n_steps, max_len = sv["rows"], sv["steps"], sv["max_len"]
    gen = torch.Generator(device=device).manual_seed(spec["seed"] + 5)
    batch = {"tokens": torch.randint(cfg.vocab_size, (rows, sv["prompt"]),
                                     generator=gen, device=device,
                                     dtype=torch.int32)}
    first = torch.randint(cfg.vocab_size, (rows, n_steps), generator=gen,
                          device=device, dtype=torch.int32)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((rows, sv["frames"], cfg.d_model),
                                      generator=gen, device=device)
    out, ref, spread = {}, None, None
    if _rank0():
        model = _serving_model(cfg, spec["seed"], device)
        _reset(device)
        ref = _serve(model, cfg, batch, first, max_len, rows, greedy=True)
        out["single_counted"] = _counted(device)
        with nudged_inputs(model, spec["seed"] + 1,
                           sv.get("spread_every_step", False)):
            spread = _serve(model, cfg, batch, ref["tokens"], max_len, rows)
        del model
        tokens = ref["tokens"]
    else:
        tokens = torch.zeros((rows, n_steps), dtype=torch.int32,
                             device=device)
    _free(device)
    tokens = context.broadcast(tokens, "model", make_mesh(
        (1, dist.get_world_size()), AXES, device))
    mesh = make_mesh(shape, AXES, device)
    model = _serving_model(cfg, spec["seed"], device, mesh)
    batch_sh = sharding.batch_shardings(batch, mesh)
    rows_sh = batch_sh["tokens"]
    local = {k: sharding.local_slice(t, batch_sh[k])
             for k, t in batch.items()}
    _reset(device)
    with _AttentionRecorder() as attn, _MatmulRecorder() as mm:
        with _Events(device) as ev:
            got = _serve(model, cfg, local,
                         sharding.local_slice(tokens, rows_sh), max_len,
                         rows)
        out["counted"] = _counted(device)
    out.update(attention_replay=attn.replay(), matmul_replay=mm.replay())
    del attn, mm
    out.update(step_traffic=got["step_traffic"],
               serve_ms=ev.ms, peak_gb=_peak_gb(device),
               local_caches={p: tuple(t.shape)
                             for p, t in
                             sharding.flat_tree(got["caches"]).items()})
    logits_sh = sharding.Sharding(mesh, (rows_sh.spec[0], None))
    cache_sh = sharding.cache_shardings(model.init_caches(
        cfg, rows, max_len, cfg.dtype, "meta"), mesh, rows)
    logits = torch.stack([sharding.gather_full(t, logits_sh)
                          for t in got["logits"]])
    caches = [sharding.map_tree(sharding.gather_full, got[k], cache_sh)
              for k in ("prefill_caches", "caches")]
    del got, model
    if _rank0():
        want = torch.stack(ref["logits"])
        out["logits"] = _logit_stats(logits, want)
        out["spread"] = _logit_stats(torch.stack(spread["logits"]), want)
        out["finite"] = bool(torch.isfinite(logits).all())
        out["positions"] = int(want.shape[0] * want.shape[1])
        rtol, atol = kchecks.attention_tolerance(cfg.dtype)
        out["caches"] = {}
        for when, key in (("prefill", "prefill_caches"), ("end", "caches")):
            want = sharding.flat_tree(ref[key])
            pert = sharding.flat_tree(spread[key])
            got_ = sharding.flat_tree(caches[when == "end"])
            out["caches"][when] = {p: {
                "max_abs_err": float((t.float() - want[p].float()).abs()
                                     .max()),
                "within_attention_tolerance": _within(t, want[p], rtol,
                                                      atol),
                "prompt_within_attention_tolerance": _within(
                    _prompt_slots(t, max_len, sv["prompt"]),
                    _prompt_slots(want[p], max_len, sv["prompt"]), rtol,
                    atol),
                "rel_l2": rel_l2(t, want[p]),
                "spread_rel_l2": rel_l2(pert[p], want[p])}
                for p, t in got_.items() if t.numel()}     # not an empty stack
    del ref, spread, caches
    _free(device)
    dist.barrier()
    return out


def _within(got, want, rtol: float, atol: float) -> bool | None:
    if got is None:
        return None
    got, want = got.float(), want.float()
    return bool(torch.all((got - want).abs() <= atol + rtol * want.abs()))


def _prompt_slots(t: torch.Tensor, max_len: int, prompt: int):
    """The first ``prompt`` slots of a cache field (on its one dim of
    ``max_len``), None for a field with no such dim (a Mamba2 state)."""
    dims = [d for d, n in enumerate(t.shape) if n == max_len]
    return t.narrow(dims[0], 0, prompt) if len(dims) == 1 else None


def _chip_pipeline(device, spec: dict) -> dict:
    """(e): ``pipeline_apply`` over 2 stages of qwen's decoder blocks (bf16
    forward) against the blocks in sequence on rank 0, microbatch by
    microbatch (the same shapes, so the same kernels)."""
    import time
    from repro_torch.kernels import checks as kchecks
    t0 = time.perf_counter()
    pp = spec["pipeline"]
    cfg = spec["qwen"]
    mesh = make_mesh((2,), ("pod",), device)
    model, _ = _model(cfg, spec["seed"], device)
    blocks = list(model.layers)
    per = len(blocks) // 2
    stage = blocks[mesh.coords["pod"] * per:(mesh.coords["pod"] + 1) * per]
    gen = torch.Generator(device=device).manual_seed(spec["seed"] + 3)
    x = torch.randn((pp["rows"], spec["seq"], cfg.d_model), generator=gen,
                    device=device).to(cfg.dtype)

    def stage_fn(blks, h):
        for blk in blks:
            h, _ = blk(h, cfg)
        return h
    with torch.no_grad():
        _reset(device)
        t1 = time.perf_counter()
        y = pipeline.pipeline_apply(stage_fn, stage, x, mesh=mesh,
                                    axis="pod",
                                    n_microbatches=pp["n_micro"])
        counted = _counted(device)
        run_s = time.perf_counter() - t1
        res = {"counted": counted, "run_seconds": run_s,
               "bubble": pipeline.bubble_fraction(2, pp["n_micro"])}
        if _rank0():
            mb = pp["rows"] // pp["n_micro"]
            ref = torch.cat([stage_fn(blocks, x[i:i + mb])
                             for i in range(0, pp["rows"], mb)])
            tol = kchecks.attention_tolerance(cfg.dtype)
            res["max_abs_err"] = kchecks.close("pipeline vs sequential", y,
                                               ref, *tol)
            res["finite"] = bool(torch.isfinite(y).all())
    del model, blocks, stage
    _free(device)
    dist.barrier()
    res["seconds"] = time.perf_counter() - t0
    return res
