#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA wave kernels from ``src/repro_torch/csrc``,
holds each against its plain PyTorch version on the card (bit for bit, on
random verifier-clean waves at the largest Table V buckets and on every
golden opcode program), drives the NMC main path through the entry points a
user calls — the Table V ``verify_sweep`` through ``BucketedPool``, the same
builds through ``ResidentPool`` + ``DispatchQueue``, and an ``nmc.jit``
kernel sync and async on both engines — and times both kernels beside their
plain versions and their bounds.

Output: progress lines, then a ``{"kernels": [...]}`` JSON line, the
``nvidia-smi`` name / power-limit line, and as the last line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Any failed phase exits non-zero; without
a card, or outside a checkout of the repository, it fails before printing a
result.  Imports nothing of JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
SEWS = (8, 16, 32)
WAVE_TILES = 128
LARGEST_BUCKET = {"caesar": 16384, "carus": 256}     # Table V, paper shapes
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
INT_OPS_PER_S = 1979e12              # H100 SXM int8 dense peak (data sheet)
KERNEL_META = {
    "caesar": {"name": "caesar_wave", "source":
               "src/repro_torch/csrc/caesar_wave.cu",
               "replaces": "src/repro/nmc/pallas_engine.py:73"},
    "carus": {"name": "carus_wave", "source":
              "src/repro_torch/csrc/carus_wave.cu",
              "replaces": "src/repro/nmc/pallas_engine.py:155"},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log_text: str) -> list[str]:
    keep = ("Compiling entry", "Used", "spill")
    return [ln.strip() for ln in log_text.splitlines()
            if any(k in ln for k in keep)]


# ---------------------------------------------------------------------------
# helpers over the port
# ---------------------------------------------------------------------------

def wave_tensors(programs, states, device):
    import numpy as np
    import torch
    from repro_torch.nmc.program import stack_programs
    fields = {k: torch.as_tensor(v, device=device)
              for k, v in stack_programs(programs).items()}
    return fields, torch.as_tensor(np.ascontiguousarray(states),
                                   device=device)


def plain_version(engine: str, fields, state, sew: int):
    from repro_torch.core.caesar import CaesarEngine
    from repro_torch.core.carus import CarusVPU
    if engine == "caesar":
        return CaesarEngine().run_stream(state, fields, sew)[0]
    return CarusVPU().run_trace(state, fields, sew)[0]


def kernel(engine: str):
    from repro_torch.nmc import cuda_engine
    return cuda_engine.caesar_wave if engine == "caesar" \
        else cuda_engine.carus_wave


def compare(engine: str, fields, state, sew: int) -> int:
    """Run kernel and plain version on the same card tensors; return the
    largest absolute difference of the final images (0 when bit-exact)."""
    import torch
    want = plain_version(engine, fields, state, sew)
    got = kernel(engine)(fields, state.clone(), sew)
    torch.cuda.synchronize()
    return int((got.long() - want.long()).abs().max())


def bound_ms(engine: str, programs) -> tuple[float, str]:
    """Least time for the wave: image in and out once, each instruction
    read once, against the lane operations its real (non-NOP) entries do."""
    from repro_torch.nmc.program import NOP_OP_ID
    n_instr = programs[0].n_instr
    per_instr = 16 if engine == "caesar" else 32
    nbytes = len(programs) * (2 * 32 * 1024 + per_instr * n_instr)
    lanes = 32 // programs[0].sew
    width = lanes if engine == "caesar" else 256 * lanes
    real = sum(int((p.entries["op"] != NOP_OP_ID[engine]).sum())
               for p in programs)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = real * width / INT_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_kernel(engine: str, fields, state, sew: int, reps: int) -> float:
    import torch
    fn = kernel(engine)
    buf = state.clone()
    fn(fields, buf, sew)                                  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(fields, buf, sew)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_plain(engine: str, fields, state, sew: int) -> float:
    """One run: the plain version takes seconds per Caesar wave, and the
    kernel-vs-plain phase already ran it at these shapes (warm)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain_version(engine, fields, state, sew)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(report: dict) -> None:
    from repro_torch import cuda_build
    t0 = time.perf_counter()
    cuda_build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {report['build_s']:.1f} s for "
        f"{[s.name for s in cuda_build.sources()]}")
    for stem, info in cuda_build.BUILD_LOG.items():
        for line in ptxas_summary(info["ptxas"]):
            log(f"  ptxas {stem}: {line}")


def phase_kernels_vs_plain(report: dict, device) -> dict:
    """Every kernel against its plain version: random waves at the largest
    Table V buckets, every SEW, then every golden opcode program."""
    from repro_torch.nmc import check, conformance
    from repro_torch.nmc.program import Program
    errs = {"caesar": 0, "carus": 0}
    waves = {}
    for engine in ("caesar", "carus"):
        for sew in SEWS:
            progs, states = conformance.random_wave(
                engine, sew, WAVE_TILES, LARGEST_BUCKET[engine], seed=sew)
            check.assert_wave(progs)
            for p in progs:
                check.verify_program(p).raise_if_errors()
            fields, state = wave_tensors(progs, states, device)
            err = compare(engine, fields, state, sew)
            log(f"kernel vs plain: {engine} sew={sew} T={WAVE_TILES} "
                f"n={LARGEST_BUCKET[engine]}: max_abs_err={err}")
            if err:
                raise AssertionError(f"{engine} sew={sew}: kernel != plain")
            errs[engine] = max(errs[engine], err)
            waves[(engine, sew)] = (progs, states)
    n_golden = 0
    for engine, label, entries in conformance.golden_cases():
        for sew in SEWS:
            prog = Program.from_entries(engine, sew, entries) \
                .pad_to(conformance.CONF_BUCKET)
            state = conformance.golden_state(engine, sew)[None]
            fields, st = wave_tensors([prog], state, device)
            err = compare(engine, fields, st, sew)
            if err:
                raise AssertionError(f"golden {engine}/{label} sew={sew}: "
                                     f"kernel != plain")
            n_golden += 1
    log(f"kernel vs plain: {n_golden} golden opcode programs bit-exact")
    report["max_abs_err"] = errs
    return waves


def phase_main_path(report: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch import nmc
    from repro_torch.core import programs as P
    from repro_torch.nmc import cuda_engine

    kbs = [P.build(name, sew) for name in P.TABLE_V_KERNELS for sew in SEWS]
    builds = [getattr(kb, e) for kb in kbs for e in ("caesar", "carus")]
    n_buckets = len({eb.program.bucket_key for eb in builds})

    cuda_engine.reset_launch_counts()
    # 1. the Table V sweep through the bucketed pool, on the card
    pool = nmc.BucketedPool(backend="cuda")
    t0 = time.perf_counter()
    res = P.verify_sweep(kbs, pool)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_launches = {"caesar": cuda_engine.caesar_wave.launches,
                      "carus": cuda_engine.carus_wave.launches}
    bad = [k for k, v in res.items() if not all(v.values())]
    if bad or len(res) != len(P.TABLE_V_KERNELS) * len(SEWS):
        raise AssertionError(f"verify_sweep oracle mismatch: {bad}")
    if pool.compiles > n_buckets:
        raise AssertionError(f"compiles {pool.compiles} > buckets "
                             f"{n_buckets}")
    log(f"main path: verify_sweep {len(res)} (kernel, sew) x 2 engines "
        f"all bit-exact in {sweep_s:.3f} s, launches {sweep_launches}; "
        f"compiles={pool.compiles} "
        f"buckets={n_buckets} dispatches={pool.dispatches} "
        f"pad_waste={pool.pad_waste} bytes_moved={pool.bytes_moved}")

    # 2. the same builds through the resident pool, sync and async
    sync_pool = nmc.ResidentPool(backend="cuda")
    sync = sync_pool.run_builds(builds)
    rp = nmc.ResidentPool(backend="cuda")
    queue = nmc.DispatchQueue(pool=rp)
    t0 = time.perf_counter()
    asyn = rp.run_builds(builds, queue=queue)
    resident_s = time.perf_counter() - t0
    for eb, a, s in zip(builds, asyn, sync):
        exp = np.asarray(eb.oracle).reshape(-1)
        if not (np.array_equal(a, s)
                and (a.reshape(-1)[:exp.size] == exp).all()):
            raise AssertionError("resident async != sync / oracle")
    log(f"main path: ResidentPool + DispatchQueue async == sync == oracle "
        f"({len(builds)} builds, {resident_s:.3f} s); "
        f"queue submitted={queue.submitted} launched={queue.launched} "
        f"resolved={queue.resolved} waves={queue.waves} "
        f"staged_while_busy={queue.staged_while_busy}; pool "
        f"loads={rp.loads} stores={rp.stores} dispatches={rp.dispatches} "
        f"bytes_moved={rp.bytes_moved}")

    # 3. the quickstart's fused nmc.jit kernel, sync and async, both engines
    rt = nmc.NmcRuntime(backend="cuda")

    @nmc.jit(runtime=rt)
    def fused(t, x, y):
        a, b = t.load(x, bank=0), t.load(y)
        t.store(((a * 3) + b).max(0))        # scaled-add + ReLU

    rng = np.random.default_rng(0)
    x = rng.integers(-128, 128, 2048, dtype=np.int8)
    y = rng.integers(-128, 128, 2048, dtype=np.int8)
    oracle = fused.oracle(x, y)
    for engine in ("caesar", "carus"):
        out = fused(x, y, engine=engine)
        fut = fused.call_async(x, y, engine=engine)
        if not ((out == oracle).all() and (fut.result() == out).all()):
            raise AssertionError(f"nmc.jit fused on {engine} diverged")
    log(f"main path: nmc.jit fused sync == async == oracle on both engines; "
        f"runtime compiles={rt.bucketed.compiles} "
        f"queue waves={rt.queue.waves}")

    launches = {"caesar": cuda_engine.caesar_wave.launches,
                "carus": cuda_engine.carus_wave.launches}
    log(f"main path launches: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    report.update(sweep_s=sweep_s, resident_s=resident_s,
                  compiles=pool.compiles, buckets=n_buckets,
                  sweep_launches=sweep_launches, launches=launches)
    return launches


def phase_timing(report: dict, waves: dict, device) -> dict:
    """ms per launch at T in {1, 128} at the largest Table V bucket; the
    plain version is timed at T=128 only (it takes seconds per wave)."""
    rows = []
    for (engine, sew), (progs, states) in sorted(waves.items()):
        for n_tiles in (1, WAVE_TILES):
            ps, st = progs[:n_tiles], states[:n_tiles]
            fields, state = wave_tensors(ps, st, device)
            ms = time_kernel(engine, fields, state, sew,
                             reps=20 if engine == "caesar" else 100)
            plain = time_plain(engine, fields, state, sew) \
                if n_tiles == WAVE_TILES else None
            bms, by = bound_ms(engine, ps)
            rows.append(dict(engine=engine, sew=sew, tiles=n_tiles,
                             n_instr=ps[0].n_instr, ms=ms, plain_ms=plain,
                             bound_ms=bms, bound_by=by))
            plain_txt = "not timed" if plain is None else f"{plain:.2f} ms"
            log(f"timing: {engine} sew={sew} T={n_tiles} "
                f"n={ps[0].n_instr}: kernel {ms:.4f} ms, plain "
                f"{plain_txt}, bound {bms:.5f} ms ({by})")
    report["timing"] = rows
    return {r["engine"]: r for r in rows
            if r["sew"] == 8 and r["tiles"] == WAVE_TILES}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs only on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository "
              f"({exc})", file=sys.stderr)
        return 1

    device = torch.device("cuda", 0)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"device: {name} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    report = {"device": name, "count": count, "nvidia_smi": smi}

    phase_build(report)
    waves = phase_kernels_vs_plain(report, device)
    launches = phase_main_path(report)
    timed = phase_timing(report, waves, device)

    kernels = []
    for engine, meta in KERNEL_META.items():
        row = timed[engine]
        kernels.append({**meta, "route": "cuda",
                        "launches": launches[engine],
                        "max_abs_err": report["max_abs_err"][engine],
                        "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": None})
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps({**report, "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
