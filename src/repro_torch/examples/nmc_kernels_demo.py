"""NMC execution demo: the traced frontend, the bucketed tile scheduler
and the hand-written kernels, on the card.

0. ``nmc.kernel`` — author a custom fused kernel as numpy-style Python:
   one decorator gives tracing, engine auto-selection, unified-IR
   lowering, pooled scheduling and sync/async dispatch.
1. Bucketed multi-tile dispatch — a heterogeneous kernel sweep runs through
   :class:`repro_torch.nmc.BucketedPool`: instruction streams NOP-pad to
   power-of-two buckets, so the whole sweep builds one executor per
   ``(engine, sew, bucket)`` instead of one per kernel shape.
2. Resident tile array — :class:`repro_torch.nmc.ResidentPool` keeps tile
   memories on the device across dispatches (the paper's memory-mode /
   compute-mode duality): re-dispatching a program moves only instruction
   bytes, never tile state.
3. ``vrf_alu`` — the NM-Carus VPU as a program-as-data kernel: an
   N-instruction program runs against a register file in ONE launch (one
   memory round trip instead of N), bit-exact against the plain version.
4. ``nmc_matmul`` — the W8A8 vmacc loop with its fused
   dequant + bias + activation epilogue.

Everything runs on the card (the NMC engines through the ``cuda`` wave
kernels); ``--device cpu`` runs the plain PyTorch versions on the CPU.

Run:  PYTHONPATH=src python -m repro_torch.examples.nmc_kernels_demo
      PYTHONPATH=src python -m repro_torch.examples.nmc_kernels_demo \\
          --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import nmc
from repro_torch.core import programs, timing
from repro_torch.kernels import checks, ops, ref
from repro_torch.kernels.vrf_alu import make_prog
from repro_torch.models.config import resolve_device
from repro_torch.nmc import BucketedPool, DispatchQueue, ResidentPool


def frontend_demo(rt: nmc.NmcRuntime) -> dict:
    rng = np.random.default_rng(1)
    print("nmc.kernel: numpy-style authoring, the whole stack in one call")

    @nmc.kernel(runtime=rt)
    def leaky_gate(t, x, g):
        xv, gv = t.load(x, bank=0), t.load(g)
        t.store(xv.max(xv >> 2) & gv)        # leaky-relu, gated

    x = rng.integers(-128, 128, 1024, dtype=np.int8)
    g = rng.integers(-128, 128, 1024, dtype=np.int8)
    picked = leaky_gate.select_engine(x, g)
    sync = leaky_gate(x, g)
    futs = [leaky_gate.call_async(x, g, engine=e)
            for e in ("caesar", "carus")]
    agree = all((np.asarray(f.result()) == np.asarray(sync)).all()
                for f in futs)
    oracle_ok = bool((np.asarray(sync) == leaky_gate.oracle(x, g)).all())
    assert agree and oracle_ok, "frontend sync/async/oracle diverged"
    print(f"  auto-selected engine: {picked}; sync == async(caesar) == "
          f"async(carus) == numpy oracle: {agree and oracle_ok}")

    @nmc.kernel(runtime=rt)
    def needs_carus(t, x, g):
        t.store(t.load(x).maxu(t.load(g)))
    carus_pick = needs_carus.select_engine(x, g)
    print(f"  x.maxu(g) auto-selects: {carus_pick} "
          f"(unsigned compares are xvnmc-only)")
    return {"engine": picked, "maxu_engine": carus_pick,
            "bit_exact": agree and oracle_ok}


def nmc_scheduler_demo(backend: str) -> dict:
    small = {"caesar_bytes": 2048, "carus_bytes": 4096}
    kbs = [programs.build(name, 8, **small)
           for name in ("xor", "mul", "relu", "leaky_relu")]
    # a ragged size: 384 bus ops pad into the same 512 bucket as the others
    kbs.append(programs.build("add", 8, caesar_bytes=1536, carus_bytes=4096))
    builds = [eb for kb in kbs for eb in (kb.caesar, kb.carus)]

    print("bucketed scheduler: heterogeneous sweep, one build per bucket")
    pool = BucketedPool(backend=backend)
    outs = pool.run_builds(builds)
    exact = all((got.reshape(-1)[: eb.oracle.size]
                 == eb.oracle.reshape(-1)).all()
                for got, eb in zip(outs, builds))
    assert exact, "bucketed sweep diverged from the kernel oracles"
    shapes = {eb.program.shape_key for eb in builds}
    buckets = {eb.program.bucket_key for eb in builds}
    print(f"  {len(builds)} kernel instances, {len(shapes)} exact shapes -> "
          f"{len(buckets)} buckets, {pool.compiles} builds, "
          f"pad_waste={pool.pad_waste} slots, bit-exact={exact}")

    print("resident tile array: load once, dispatch many (compute mode)")
    rpool = ResidentPool(backend=backend)
    rpool.run_builds(builds[:2])
    loaded = rpool.bytes_moved
    rpool.dispatch([(t, eb.program)
                    for t, eb in zip(rpool.tiles, builds[:2])])
    redispatch = rpool.bytes_moved - loaded
    print(f"  initial load+run moved {loaded} B; re-dispatch moved "
          f"{redispatch} B (instruction stream only), "
          f"{rpool.compiles} builds total")

    print("async dispatch queue: double-buffered futures over a 2-tile array")
    queue = DispatchQueue(pool=ResidentPool(backend=backend))
    async_outs = queue.run_builds(builds, n_tiles=2)
    async_ok = all((got.reshape(-1)[: eb.oracle.size]
                    == eb.oracle.reshape(-1)).all()
                   for got, eb in zip(async_outs, builds))
    assert async_ok, "async futures diverged from the kernel oracles"
    stages = [timing.stage_cost(eb) for eb in builds]
    ser = timing.dispatch_cycles(stages, "serial")
    ovl = timing.dispatch_cycles(stages, "overlapped")
    print(f"  {queue.submitted} work items in {queue.waves} waves, "
          f"{queue.staged_while_busy} images staged while the tile was "
          f"busy, bit-exact={async_ok}")
    print(f"  modeled dispatch cost: serial {ser:.0f} cyc -> overlapped "
          f"{ovl:.0f} cyc ({ovl / ser:.2f}x, max(dma, compute) per stage)")
    return {"builds": len(builds), "buckets": len(buckets),
            "compiles": pool.compiles, "pad_waste": pool.pad_waste,
            "loaded_bytes": loaded, "redispatch_bytes": redispatch,
            "waves": queue.waves, "staged_while_busy":
                queue.staged_while_busy, "serial_cycles": ser,
            "overlapped_cycles": ovl}


def vrf_alu_demo(rng, device) -> dict:
    print("vrf_alu: one kernel, arbitrary programs (program = data)")
    vrf = torch.as_tensor(rng.integers(-100, 100, checks.VRF_DEMO_SHAPE)
                          .astype(np.int16), device=device)
    out = {}
    for name, entries in checks.VRF_DEMO_PROGRAMS.items():
        prog = make_prog(entries)
        got = ops.vrf_alu(vrf.clone(), prog)
        want = ref.vrf_alu(vrf.clone(), prog)
        ok = bool(torch.equal(got, want))
        assert ok, f"vrf_alu {name} diverged from the plain version"
        print(f"  {name}: {prog.shape[0]} instrs, one launch, bit-exact vs "
              f"plain={ok}")
        out[name] = ok
    return out


def nmc_matmul_demo(rng, device) -> float:
    print("nmc_matmul: W8A8 with fused epilogue (int32 accumulation)")
    m, k, n = 512, 1024, 512
    w = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32),
                        device=device) * 0.05
    x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32),
                        device=device)
    wq, sw = ref.quantize_rowwise(w)
    xq, sx = ref.quantize_dynamic(x)
    y = ops.nmc_matmul(xq, wq, sw * sx, None, act="relu",
                       out_dtype=torch.float32)
    exact = torch.clamp_min(x @ w, 0)
    rel = float(torch.linalg.norm(y - exact) / torch.linalg.norm(exact))
    assert rel < 0.015, rel
    print(f"  {m}x{k}x{n}: relative error vs fp32 {rel:.4f} "
          f"(int8 weights: {k*n/2**20:.1f} MiB vs fp32 {4*k*n/2**20:.1f})")
    return rel


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions on the CPU; the "
                         "default is the card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    backend = "cuda" if device.type == "cuda" else "torch"
    rng = np.random.default_rng(0)

    result = {"device": str(device)}
    result["frontend"] = frontend_demo(nmc.NmcRuntime(backend=backend))
    print()
    result["scheduler"] = nmc_scheduler_demo(backend)
    print()
    result["vrf_alu"] = vrf_alu_demo(rng, device)
    print()
    result["nmc_matmul_rel_err"] = nmc_matmul_demo(rng, device)
    return result


if __name__ == "__main__":
    main()
