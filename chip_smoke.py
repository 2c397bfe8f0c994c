#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, in parallel) and drives two paths of the port:

* NMC execution: the two wave kernels against their plain PyTorch versions
  on the card (bit for bit, on random verifier-clean waves at the largest
  Table V buckets and on every golden opcode program); the Table V
  ``verify_sweep`` through ``BucketedPool``, the same builds through
  ``ResidentPool`` + ``DispatchQueue``, and an ``nmc.jit`` kernel sync and
  async on both engines; both kernels timed beside their plain versions
  and their bounds.
* W8A8 serving: ``nmc_matmul`` and ``flash_attention`` against their plain
  versions at the serving path's shapes; qwen1.5-0.5B at full width (random
  weights from a seed, quantized) served by ``ServeEngine``, with every
  projection through ``nmc_matmul`` and every prefill layer's attention
  through ``flash_attention``; one prefill's logits through the kernels
  against the plain versions; both kernels timed beside their plain
  versions, their bounds and one PyTorch library call.

Output: progress lines, then a ``{"kernels": [...]}`` JSON line, the
``nvidia-smi`` name / power-limit line, and as the last line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Any failed phase exits non-zero; without
a card, or outside a checkout of the repository, it fails before printing a
result.  Imports nothing of JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import contextlib
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


# ---------------------------------------------------------------------------
# the LM layer: W8A8 serving of qwen1.5-0.5B through nmc_matmul and
# flash_attention
# ---------------------------------------------------------------------------

BF16_OPS_PER_S = 989e12              # H100 SXM bf16 dense tensor peak
F32_OPS_PER_S = 67e12                # H100 SXM f32 CUDA-core peak
SERVE_ARCH = "qwen1.5-0.5b"
SERVE = dict(n_slots=4, max_len=1024, requests=8, prompt_lo=64,
             prompt_hi=512, max_new=16)
PREFILL_LENGTHS = (64, 128, 256, 512)
LM_KERNEL_META = {
    "nmc_matmul": {"source": "src/repro_torch/csrc/nmc_matmul.cu",
                   "replaces": "src/repro/kernels/nmc_matmul.py:32"},
    "flash_attention": {"source": "src/repro_torch/csrc/flash_attention.cu",
                        "replaces": "src/repro/kernels/flash_attention.py:27"},
}
#: the shapes each LM kernel's JSON row reports: the prefill LM head of a
#: 384-token prompt, and that prompt's attention
ROW_MATMUL = (384, 1024, 151936)
ROW_ATTENTION = 384


def events_ms(fn, reps: int, flush=None) -> float:
    """Mean ms per call by CUDA events around each call, after a warm-up;
    ``flush`` (outside the timed span) evicts the 50 MB L2 first."""
    import torch
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def matmul_bound_ms(m: int, k: int, n: int, out_bytes: int) -> tuple:
    nbytes = m * k + k * n + 8 * n + m * n * out_bytes
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * m * n * k / INT_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attention_bound_ms(b, hq, hkv, s, d, dv, elem) -> dict:
    """Bytes: q, k, v read once and o written once.  Operations: 2 D + 2
    Dv per visible (causal) query-key pair, against the bf16 tensor peak
    (the f32 CUDA-core peak, the rate of the kernel's own f32 math, kept
    beside it)."""
    nbytes = elem * (b * hq * s * (d + dv) + b * hkv * s * (d + dv))
    flops = b * hq * s * (s + 1) // 2 * (2 * d + 2 * dv)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_bf16, t_f32 = flops / BF16_OPS_PER_S, flops / F32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_bf16) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_bf16 else "operations",
            "bound_f32_ms": max(t_bytes, t_f32) * 1e3}


def phase_lm_kernels_vs_plain(report: dict, device) -> dict:
    """nmc_matmul and flash_attention against their plain versions on the
    card at the serving path's shapes (tolerances: kernels/checks.py)."""
    import torch
    from repro_torch.kernels import checks
    worst = {"nmc_matmul": 0.0, "flash_attention": 0.0}
    cases = []
    shapes = [(m, k, n) for m in checks.MATMUL_M
              for k, n in checks.MATMUL_KN] + list(checks.MATMUL_RAGGED)
    for m, k, n in shapes:
        errs = checks.check_matmul(m, k, n, device)
        torch.cuda.synchronize()
        f32 = max(v for c, v in errs.items() if not c.endswith("bf16"))
        worst["nmc_matmul"] = max(worst["nmc_matmul"], f32)
        cases.append({"kernel": "nmc_matmul", "shape": [m, k, n], **errs})
        log(f"lm kernel vs plain: nmc_matmul M={m} K={k} N={n}: "
            + " ".join(f"{c}={v:.3g}" for c, v in errs.items()))
    for name in checks.ATTENTION_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            err = checks.check_attention(name, dtype, device)
            torch.cuda.synchronize()
            if dtype == torch.float32:
                worst["flash_attention"] = max(worst["flash_attention"], err)
            cases.append({"kernel": "flash_attention", "case": name,
                          "dtype": str(dtype), "max_abs_err": err})
            log(f"lm kernel vs plain: flash_attention {name} {dtype}: "
                f"max_abs_err={err:.3g}")
    report["lm_cases"] = cases
    report["lm_max_abs_err"] = worst
    return worst


@contextlib.contextmanager
def recorded_lm_kernel_calls():
    """Record the inputs and output of every LM-kernel launch the models
    make inside the block, at the dispatch layer (``kernels/ops.py``): the
    wrappers themselves run, and count, as usual."""
    import types
    from repro_torch.kernels import ops
    calls = []
    orig_mm, orig_fa = ops._mm, ops._fa

    def recorder(name, fn):
        def wrapper(*args, **kw):
            out = fn(*args, **kw)
            calls.append((name, args, kw, out))
            return out
        return wrapper
    ops._mm = types.SimpleNamespace(
        nmc_matmul=recorder("nmc_matmul", orig_mm.nmc_matmul))
    ops._fa = types.SimpleNamespace(
        flash_attention=recorder("flash_attention", orig_fa.flash_attention))
    try:
        yield calls
    finally:
        ops._mm, ops._fa = orig_mm, orig_fa


def replay_against_plain(calls) -> dict:
    """Every recorded launch against the plain version on its own inputs,
    with the tolerances of kernels/checks.py (raises beyond them)."""
    from repro_torch.kernels import checks, flash_attention as fa, ref
    worst = {"nmc_matmul": 0.0, "flash_attention": 0.0}
    count = {"nmc_matmul": 0, "flash_attention": 0}
    for i, (name, args, kw, out) in enumerate(calls):
        if name == "nmc_matmul":
            want = ref.nmc_matmul(*args, **kw)
            tol = checks.matmul_tolerance(kw["act"], kw["out_dtype"])
        else:
            want = fa.chunked_attention(*args, **kw)
            tol = checks.attention_tolerance(args[0].dtype)
        worst[name] = max(worst[name],
                          checks.close(f"{name} launch {i}", out, want, *tol))
        count[name] += 1
    return {"launches": count, "max_abs_err": worst}


def perturbed_plain_logits(params, tokens, cfg, seed: int = 1):
    """The plain path's logits with half the embedded inputs moved by one
    float32 ulp: the model's own sensitivity to last-bit noise."""
    import torch
    from repro_torch.kernels import ops
    with torch.inference_mode(), ops.force_plain():
        x = params.embed(tokens, cfg.dtype)
        gen = torch.Generator(device=x.device).manual_seed(seed)
        flip = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
        x = torch.where(flip, torch.nextafter(x, torch.full_like(x, 1e30)), x)
        for blk in params.layers:
            x = blk(x, cfg)
        return params.logits(x, cfg)


def compare_logits(params, cfg, prompt, device) -> dict:
    """One prompt through the kernels and under ``ops.force_plain()``, with
    the served bf16 activations and with float32 ones.

    1. Every kernel launch of the kernels' forward is replayed through its
       plain version on the same inputs, within the tolerances of
       kernels/checks.py: the kernels are right at this width and on these
       activations.
    2. The logits of every position (the prefill's are the last row).
       W8A8 with a per-tensor dynamic scale is discontinuous: where the two
       attention versions differ in the last bit (another summation
       order), an int8 rounding flips, and 24 layers carry it on.  Moving
       the plain path's inputs by one float32 ulp shows the model's own
       spread, printed beside.  The float32 prefill's top-1 token must
       agree; for both dtypes the RMS difference must stay under 25% of
       the logit scale and the top-1 tokens agree at half the positions
       or more, which a wrong kernel (unrelated logits: RMS about 140%,
       agreement near 0) fails."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    tokens = torch.as_tensor(prompt[None], device=device)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        c = cfg.scaled(dtype=dtype)
        with recorded_lm_kernel_calls() as calls:
            got, _ = lm.forward(params, {"tokens": tokens}, c)
        replay = replay_against_plain(calls)
        del calls
        with ops.force_plain():
            want, _ = lm.forward(params, {"tokens": tokens}, c)
        got, want = got[0].float(), want[0].float()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"non-finite {dtype} logits")
        top2 = want[-1].topk(2).values
        st = dict(replay=replay,
                  max_abs_diff=float((got - want).abs().max()),
                  rms_diff=float((got - want).pow(2).mean().sqrt()),
                  logit_std=float(want.std()),
                  top1_agreement=float((got.argmax(-1) == want.argmax(-1))
                                       .float().mean()),
                  last_top1_kernels=int(got[-1].argmax()),
                  last_top1_plain=int(want[-1].argmax()),
                  plain_top2_gap=float(top2[0] - top2[1]))
        if dtype == torch.float32:
            pert = perturbed_plain_logits(params, tokens, c)[0].float()
            st["ulp_perturbed_plain"] = dict(
                max_abs_diff=float((pert - want).abs().max()),
                rms_diff=float((pert - want).pow(2).mean().sqrt()),
                top1_agreement=float((pert.argmax(-1) == want.argmax(-1))
                                     .float().mean()))
        out[str(dtype)] = st
        log(f"serving: {dtype} forward of a {len(prompt)}-token prompt: "
            f"{replay['launches']} launches replayed through the plain "
            f"versions, max abs err {replay['max_abs_err']}; logits kernels "
            f"vs plain: max_abs_diff={st['max_abs_diff']:.4g} "
            f"rms={st['rms_diff']:.4g} (logit std {st['logit_std']:.4g}), "
            f"top-1 agreement {st['top1_agreement']:.4f}, prefill top-1 "
            f"kernels {st['last_top1_kernels']} plain "
            f"{st['last_top1_plain']} (plain top-2 gap "
            f"{st['plain_top2_gap']:.4g}); plain vs plain with 1-ulp "
            f"inputs: {st.get('ulp_perturbed_plain', 'not run')}")
        if st["rms_diff"] > 0.25 * st["logit_std"] \
                or st["top1_agreement"] < 0.5:
            raise AssertionError(f"{dtype} logits through the kernels stray "
                                 f"from the plain versions'")
        if dtype == torch.float32 and \
                st["last_top1_kernels"] != st["last_top1_plain"]:
            raise AssertionError("the float32 prefill's top-1 token differs "
                                 "between the kernels and the plain versions")
    return out


def phase_serving(report: dict, device, seed: int = 0) -> dict:
    """The port's W8A8 serving path at qwen1.5-0.5B's full width: random
    weights from a seeded generator, quantized, served by ServeEngine.
    The LM kernels' launch counts are set to 0 just before and read just
    after."""
    import numpy as np
    import torch
    from repro_torch import configs, kernels
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine, \
        quantize_params

    cfg = configs.get(SERVE_ARCH).scaled(nmc_mode="w8a8")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = quantize_params(lm.init_params(cfg, gen, device), cfg)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(SERVE["prompt_lo"], SERVE["prompt_hi"] + 1,
                           SERVE["requests"])
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lengths]
    eng = ServeEngine(cfg, params, n_slots=SERVE["n_slots"],
                      max_len=SERVE["max_len"], device=device)
    for i, pr in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=pr, max_new=SERVE["max_new"]))
    calls0 = eng.nmc_queue.calls
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    prefills = len(prompts)
    decode_steps = eng.nmc_queue.calls - calls0 - prefills
    per_forward = cfg.n_layers * 7 + 1
    log(f"serving {SERVE_ARCH} w8a8: {len(done)} requests, prompts "
        f"{sorted(int(n) for n in lengths)}, {prefills} prefills + "
        f"{decode_steps} decode steps in {serve_s:.3f} s; launches "
        f"{launches}")
    if len(done) != len(prompts) or any(len(r.out) != SERVE["max_new"]
                                        for r in done):
        raise AssertionError("a request did not return max_new tokens")
    if launches["nmc_matmul"] < per_forward * (prefills + decode_steps):
        raise AssertionError(f"nmc_matmul launched {launches['nmc_matmul']}"
                             f" < {per_forward} x {prefills + decode_steps}")
    if launches["flash_attention"] != cfg.n_layers * prefills:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} != "
                             f"{cfg.n_layers} x {prefills}")
    tokens = [t for r in done for t in r.out]
    if not all(0 <= t < cfg.vocab_size for t in tokens):
        raise AssertionError("a token outside the vocabulary")

    # one prompt through the kernels and through the plain versions (not
    # counted: the main path's counts were read above)
    logits = compare_logits(params, cfg, prompts[0], device)

    # prefill ms per prompt length, decode steps/s at n_slots
    prefill_ms = {}
    for n in PREFILL_LENGTHS:
        toks = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, n)), device=device)}
        prefill_ms[n] = events_ms(
            lambda: lm.prefill(params, toks, cfg, SERVE["max_len"]), reps=3)
    caches = lm.init_caches(params, cfg, SERVE["n_slots"], SERVE["max_len"],
                            dtype=cfg.dtype)
    step_toks = torch.zeros((SERVE["n_slots"], 1), dtype=torch.long,
                            device=device)
    clen = torch.full((SERVE["n_slots"],), 300, dtype=torch.int32,
                      device=device)
    step_ms = events_ms(
        lambda: lm.decode_step(params, step_toks, caches, clen, cfg), reps=20)
    log(f"serving: prefill ms by prompt length "
        f"{ {n: round(v, 3) for n, v in prefill_ms.items()} }; decode step "
        f"{step_ms:.3f} ms at {SERVE['n_slots']} slots = "
        f"{1e3 / step_ms:.1f} steps/s")
    report["serving"] = dict(
        arch=SERVE_ARCH, **SERVE, prompt_lengths=[int(n) for n in lengths],
        seconds=serve_s, prefills=prefills, decode_steps=decode_steps,
        launches=launches, logits=logits, prefill_ms=prefill_ms,
        decode_step_ms=step_ms, param_count=cfg.param_count())
    return launches


def int_mm_library(x, w, scale, bias, out_dtype):
    """``torch._int_mm`` plus the epilogue as torch ops, as a callable, or
    None and the reason why there is none for this shape."""
    import torch
    if x.shape[0] <= 16:
        return None, "torch._int_mm needs M > 16"
    try:
        torch._int_mm(x, w)
    except RuntimeError as exc:
        return None, f"torch._int_mm refused: {str(exc).splitlines()[0]}"
    return (lambda: (torch._int_mm(x, w).float() * scale + bias)
            .to(out_dtype)), None


def phase_lm_timing(report: dict, device) -> dict:
    """ms per launch of both LM kernels at the serving path's shapes,
    beside the plain version, the bound and one PyTorch library call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import checks, flash_attention as fa, \
        nmc_matmul as mm, ref
    flush_buf = torch.empty(128 << 20, dtype=torch.int8, device=device)
    flush = flush_buf.zero_
    rows = []
    for m in checks.MATMUL_M:
        for k, n in checks.MATMUL_KN:
            x, w, scale, bias = checks.matmul_inputs(m, k, n, device)
            kw = dict(act="none", out_dtype=torch.bfloat16)
            ms = events_ms(lambda: mm.nmc_matmul(x, w, scale, bias, **kw),
                           reps=10, flush=flush)
            plain = events_ms(lambda: ref.nmc_matmul(x, w, scale, bias, **kw),
                              reps=2, flush=flush)
            lib_fn, why = int_mm_library(x, w, scale, bias, torch.bfloat16)
            lib = None if lib_fn is None else events_ms(lib_fn, reps=10,
                                                        flush=flush)
            bms, by = matmul_bound_ms(m, k, n, 2)
            rows.append(dict(kernel="nmc_matmul", shape=[m, k, n], ms=ms,
                             plain_ms=plain, library_ms=lib,
                             library_null_reason=why, bound_ms=bms,
                             bound_by=by))
            lib_txt = f"{lib:.4f} ms" if lib is not None else f"null ({why})"
            log(f"timing: nmc_matmul M={m} K={k} N={n} bf16: kernel "
                f"{ms:.4f} ms, plain {plain:.3f} ms, library {lib_txt}, "
                f"bound {bms:.4f} ms ({by})")
    for s in (128, 384, 1000):
        case = dict(b=1, hq=16, hkv=16, sq=s, skv=s, d=64, dv=64)
        q, k, v = checks.attention_inputs(case, torch.bfloat16, device)
        ms = events_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                       reps=20)
        plain = events_ms(lambda: fa.chunked_attention(q, k, v, causal=True),
                          reps=3)
        lib = events_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps=20)
        bound = attention_bound_ms(1, 16, 16, s, 64, 64, 2)
        rows.append(dict(kernel="flash_attention", shape=[1, 16, s, 64],
                         ms=ms, plain_ms=plain, library_ms=lib, **bound))
        log(f"timing: flash_attention B=1 H=16 S={s} D=64 bf16 causal: "
            f"kernel {ms:.4f} ms, plain {plain:.3f} ms, library {lib:.4f} "
            f"ms, bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}; "
            f"{bound['bound_f32_ms']:.5f} ms at the f32 peak)")
    report["lm_timing"] = rows
    return {"nmc_matmul": next(r for r in rows if r["kernel"] == "nmc_matmul"
                               and r["shape"] == list(ROW_MATMUL)),
            "flash_attention": next(r for r in rows
                                    if r["kernel"] == "flash_attention"
                                    and r["shape"][2] == ROW_ATTENTION)}



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
    lm_errs = phase_lm_kernels_vs_plain(report, device)
    lm_launches = phase_serving(report, device)
    lm_timed = phase_lm_timing(report, device)

    kernels = []
    for engine, meta in KERNEL_META.items():
        row = timed[engine]
        kernels.append({**meta, "route": "cuda",
                        "launches": launches[engine],
                        "max_abs_err": report["max_abs_err"][engine],
                        "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": None})
    for kname, meta in LM_KERNEL_META.items():
        row = lm_timed[kname]
        kernels.append({"name": kname, **meta, "route": "cuda",
                        "launches": lm_launches[kname],
                        "max_abs_err": lm_errs[kname], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
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
