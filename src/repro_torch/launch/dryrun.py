"""Multi-pod dry run: every (architecture x input shape) cell traced on the
production meshes, with no card, and the roofline's per-device inputs
counted.

The counterpart of the JAX package's ``launch/dryrun.py``.  The reference
lowers and compiles each cell for 256 or 512 forced CPU devices and reads
XLA's memory and cost analyses and the optimized HLO.  The port's ranks
are processes, so the dry run runs rank 0's program itself: it opens a
fake ``torch.distributed`` world of 256 or 512 ranks (the ``fake``
backend of ``torch.testing._internal.distributed.fake_pg``, a private
module: its collectives return at once; run under torch 2.13.0+cpu and
the card's 2.11), builds the mesh over it
(:func:`~repro_torch.launch.mesh.make_production_mesh`), lays the cell's
abstract arguments (:mod:`repro_torch.launch.specs`, on ``meta``) out
with ``lm.shard`` and the sharding rules, and runs the step once on the
``meta`` device under the census (:mod:`repro_torch.launch.analysis`).

Only route: the step runs under ``kernels.ops.force_plain(
kernel_autograd=True)``.  The kernels cannot run on ``meta``, as the
reference's Pallas kernels do not compile for its forced CPU devices;
the plain versions take their place inside the card's program (the
attention's autograd Function and plain backward as on the card), and no
kernel is built.  On ``cpu`` and ``cuda`` nothing changes.

For each cell a JSON record with the reference's keys where the meaning
is the same (``arch``, ``shape``, ``kind``, ``mesh``, ``n_devices``,
``nmc_mode``, ``tag``, ``params``, ``active_params``, ``tokens``,
``memory``), the census under ``census`` (for the reference's ``hlo``)
and ``trace_s`` (the layout and the step, for ``lower_s`` /
``compile_s``).  A cell whose layout works but whose step the port
refuses (a ``NotImplementedError`` from the step; no cell of ``--all``
has one) still gets its record: its arguments' bytes, the refusal's
message under ``refused`` and null step quantities.  A cell whose layout
is refused (MoE experts that ``model`` does not divide, where the
reference's ``shard_map`` fails too; no cell of ``--all`` meets one:
heads that ``model`` does not divide run every head on every rank, fact
18, and a layer stack split over a data axis is held by slices, fact 21)
writes the reference's ``.err``
traceback and ``FAILED`` line.  ``--save-hlo`` has no counterpart: there
is no compiled program to save.

Usage (no card, no nvcc):
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ShapeSpec,
                                      applicable_shapes, get)
from repro_torch.distributed import context, sharding
from repro_torch.kernels import ops
from repro_torch.launch import specs as S
from repro_torch.launch.analysis import Census
from repro_torch.launch.mesh import (PRODUCTION, make_mesh,
                                     make_production_mesh)
from repro_torch.models import lm
from repro_torch.optim import adamw

#: the default output directory (gitignored)
OUT = "results/dryrun_torch"


@contextlib.contextmanager
def fake_world(size: int):
    """A fake ``torch.distributed`` world of ``size`` ranks in which this
    process is rank 0, destroyed on leaving.  Refuses to start over an
    existing default group (a mesh built later in this process would read
    the world left behind)."""
    if dist.is_initialized():
        raise RuntimeError("the dry run opens its own fake world, and a "
                           "default process group already exists")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_name(shape: tuple) -> str:
    return "x".join(str(s) for s in shape)


def lay_out(args: tuple, cfg, shape: ShapeSpec, mesh) -> tuple:
    """Rank 0's slices of a cell's abstract arguments: the model through
    ``lm.shard`` (its int8 serving weights too; raises where the port
    refuses the layout), the moments by its layout's ZeRO-2 specs, the
    batch by ``batch_shardings``, the caches by ``cache_shardings``, the
    cache lengths whole."""
    model = lm.shard(args[0], cfg, mesh)

    def rows(batch: dict) -> dict:
        sh = sharding.batch_shardings(batch, mesh)
        return {k: sharding.local_slice(x, sh[k]) for k, x in batch.items()}
    if shape.kind == "train":
        _, opt, batch = args
        moments = model.layout.moments
        opt = {k: {n: sharding.local_slice(t, moments[n])
                   for n, t in opt[k].items()} for k in ("m", "v")} | \
            {"step": opt["step"]}
        return model, opt, rows(batch)
    if shape.kind == "prefill":
        return model, rows(args[1])
    _, tokens, caches, cache_len = args
    csh = sharding.cache_shardings(caches, mesh, shape.global_batch)
    return model, rows({"tokens": tokens})["tokens"], \
        sharding.map_tree(sharding.local_slice, caches, csh), cache_len


def trace_step(fn, args: tuple) -> tuple:
    """Run ``fn(*args)`` once under ``force_plain(kernel_autograd=True)``
    and the census: (the census, its ``{"census", "memory"}`` or None, the
    refusal's message or None).  A ``NotImplementedError`` from the step
    is the port's refusal."""
    census = Census(args)
    try:
        with ops.force_plain(kernel_autograd=True), census:
            results = fn(*args)
    except NotImplementedError as e:
        return census, None, f"{type(e).__name__}: {e}"
    return census, census.finish(results), None


def run_cell(arch: str, shape_name, multi_pod: bool,
             nmc_mode: str = "none", extra_tag: str = "",
             cfg_override=None, mesh_shape: tuple | None = None,
             n_microbatches: int = 1, **cfg_kw) -> dict:
    """One cell's record (the module's keys).  ``shape_name``: a name of
    ``SHAPES`` or a :class:`ShapeSpec`; ``mesh_shape``: a (data, model)
    mesh of that many fake ranks in place of the production mesh (tests,
    the smoke run); a train step takes ``n_microbatches``.  Raises where
    the port refuses the cell's layout; the fake world is destroyed
    either way."""
    cfg = cfg_override or get(arch)
    if cfg_kw:
        cfg = cfg.scaled(**cfg_kw)
    if nmc_mode != "none":
        cfg = cfg.scaled(nmc_mode=nmc_mode)
    shape = shape_name if isinstance(shape_name, ShapeSpec) \
        else SHAPES[shape_name]
    dims = PRODUCTION[multi_pod][0] if mesh_shape is None \
        else tuple(mesh_shape)
    with fake_world(math.prod(dims)):
        mesh = make_production_mesh(multi_pod=multi_pod) \
            if mesh_shape is None else \
            make_mesh(dims, ("data", "model"), "meta")
        t0 = time.perf_counter()
        with context.use_mesh(mesh):
            fn, args, _ = S.cell_fn_and_inputs(
                cfg, shape, local_batch=True, n_microbatches=n_microbatches)
            args = lay_out(args, cfg, shape, mesh)
            census, step, refused = trace_step(fn, args)
            del args
        trace_s = time.perf_counter() - t0
    return {
        "arch": arch, "shape": shape.name, "kind": shape.kind,
        "mesh": mesh_name(dims), "n_devices": math.prod(dims),
        "nmc_mode": nmc_mode, "tag": extra_tag,
        "trace_s": round(trace_s, 2),
        "census": step["census"] if step else None,
        "memory": step["memory"] if step else {
            "argument_bytes": census.argument_bytes, "output_bytes": None,
            "temp_bytes": None, "peak_bytes": None},
        "refused": refused,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "tokens": shape.global_batch * (shape.seq_len
                                        if shape.kind != "decode" else 1),
    }


def measured_steps(device, cells: list, mesh_shape: tuple,
                   seed: int = 0) -> list:
    """Rank function (:func:`repro_torch.launch.mesh.run_ranks`): for each
    (config, train shape) of ``cells``, the train step of :func:`run_cell`
    run for real on ``device`` over the world, the arguments laid out the
    same way (weights drawn from ``seed``, tokens uniform over the
    vocabulary): its flops by ``FlopCounterMode``, its collectives from
    ``context.traffic`` ({op: [calls, bytes, staged bytes, result
    bytes]}) and the census of the same run (``step``, with the bytes
    allocated in it)."""
    from torch.utils.flop_counter import FlopCounterMode
    mesh = make_mesh(mesh_shape, ("data", "model"), device)
    out = []
    for cfg, shape in cells:
        gen = torch.Generator(device=device).manual_seed(seed)
        fn, abstract, _ = S.cell_fn_and_inputs(cfg, shape, local_batch=True)
        batch = {k: torch.randint(cfg.vocab_size, x.shape, generator=gen,
                                  device=device, dtype=x.dtype)
                 if not x.is_floating_point() else
                 torch.randn(x.shape, generator=gen,
                             device=device).to(x.dtype)
                 for k, x in abstract[2].items()}
        del abstract
        model = lm.init_params(cfg, gen, device)
        opt = adamw.init_state(dict(model.named_parameters()))
        with context.use_mesh(mesh):
            args = lay_out((model, opt, batch), cfg, shape, mesh)
            del model, opt, batch
            before = {k: list(v) for k, v in context.traffic.items()}
            with FlopCounterMode(display=False) as flops:
                census, step, _ = trace_step(fn, args)
            del args
        out.append({
            "flops": int(flops.get_total_flops()),
            "traffic": {k: [a - b for a, b in
                            zip(v, before.get(k, [0, 0, 0, 0]))]
                        for k, v in context.traffic.items()
                        if v[0] != before.get(k, [0])[0]},
            "step": step, "allocated_bytes": census.allocated_bytes})
    return out


def summary(rec: dict) -> str:
    """The reference's one-line summary of a cell's record."""
    if rec["census"] is None:
        return (f"  ok (step refused): args/dev="
                f"{rec['memory']['argument_bytes'] / 2**30:.2f} GiB; "
                f"{rec['refused']}")
    c = rec["census"]
    ncoll = sum(k["count"] for k in c["collectives"].values())
    return (f"  ok: {rec['trace_s']}s trace, flops/dev={c['flops']:.3e}, "
            f"peak={rec['memory']['peak_bytes'] / 2**30:.2f} GiB, "
            f"coll_bytes/dev={c['collective_link_bytes']:.3e} "
            f"({ncoll:.0f} ops)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--nmc-mode", default="none",
                    choices=["none", "w8", "w8a8"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--remat-policy", default="full", choices=["full", "dots"])
    ap.add_argument("--kv-int8", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        cells = [(arch, sh) for arch in ARCH_IDS
                 for sh in applicable_shapes(get(arch))]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    for arch, sh in cells:
        for mp in meshes:
            tag = f"{arch}__{sh}__{'pod2' if mp else 'pod1'}"
            if args.nmc_mode != "none":
                tag += f"__{args.nmc_mode}"
            if args.tag:
                tag += f"__{args.tag}"
            out_path = os.path.join(args.out, tag + ".json")
            if os.path.exists(out_path):
                print(f"[skip] {tag} (exists)")
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                kw = {"seq_parallel": True} if args.seq_parallel else {}
                if args.remat_policy != "full":
                    kw["remat_policy"] = args.remat_policy
                if args.kv_int8:
                    kw["kv_cache_dtype"] = "int8"
                rec = run_cell(arch, sh, mp, args.nmc_mode, args.tag, **kw)
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(summary(rec), flush=True)
            except Exception as e:
                print(f"  FAILED: {type(e).__name__}: {e}", flush=True)
                with open(out_path + ".err", "w") as f:
                    f.write(traceback.format_exc())


if __name__ == "__main__":
    main()
