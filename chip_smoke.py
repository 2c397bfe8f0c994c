#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, in parallel) and drives fourteen paths of the port:

* NMC execution: the two wave kernels against their plain PyTorch versions
  on the card (bit for bit, on random verifier-clean waves at the largest
  Table V buckets, on Caesar waves dense with conflicts and the serial
  chain, on slide-dense and long Carus waves, and on every golden opcode
  program); the Table V ``verify_sweep`` through ``BucketedPool``, the
  same builds through ``ResidentPool`` + ``DispatchQueue`` (each image
  staged through pinned memory on the queue's copy stream), and an
  ``nmc.jit`` kernel sync and async on both engines; both kernels timed
  beside their plain versions and their bounds, the Caesar kernel on the
  Table V gemm and leaky_relu waves and the serial chain (with their
  rounds per window), the Carus kernel on the Table V gemm, matmul and
  conv2d waves and a slide-dense wave (with their records and barriers).
* W8A8 serving: ``nmc_matmul`` and ``flash_attention`` against their plain
  versions at the serving path's shapes and at the edges of their routes;
  qwen1.5-0.5B at full width (random weights from a seed, quantized)
  served by ``ServeEngine``, with every projection through ``nmc_matmul``
  (all on its tensor-core route) and every prefill layer's attention
  through ``flash_attention``; one prefill's logits through the kernels
  against the plain versions, beside the model's own spread under 1-ulp
  input noise; the device time of a decode step's kernels (profiler);
  both kernels timed beside their plain versions, their bounds and one
  PyTorch library call.
* W8A8 serving of the MoE family: moonshot-v1-16b-a3b at full width (16
  of its 48 layers, 64 experts top-6, vocab 163840; random weights from a seed,
  each block quantized as it is drawn) served by ``ServeEngine`` on the
  same traffic, every projection of attention, the shared experts and
  the head through ``nmc_matmul`` and every prefill attention through
  ``flash_attention`` (all on the tensor cores); every attention launch
  and a sample of the ``nmc_matmul`` ones replayed through the plain
  versions, the assignments each decode step drops, one prefill's logits
  against the plain versions; prefill and decode ms and the decode step's
  device time split between the kernels and the experts' dequantize and
  ``bmm`` (profiler).
* W8A8 serving of MLA: deepseek-v2-lite-16b at full width (27 layers, one
  dense, 26 MoE; MLA with kv_lora_rank 512) on the same traffic and with
  the same checks, its prefill attention (D 192, Dv 128) on
  ``flash_attention``'s CUDA-core route, its decode attention absorbed
  into float32 einsums over the compressed cache (a profiler range of
  its own in the decode step's split).
* The VLM: pixtral-12b at full width (20 of its 40 layers, d_model 5120)
  prefilling
  4 rows of 1024 image embeddings and 128 text tokens and decoding 16
  steps through ``lm.prefill`` / ``lm.decode_step`` (the serving engine,
  like the reference's, passes no images); launches, replays, logits
  against the plain versions, prefill and decode ms.
* The encoder-decoder: whisper-tiny at full width (4 + 4 layers, d_model
  384, vocab 51865) prefilling 4 rows of 1500 frame embeddings and a
  64-token prompt and decoding 32 steps through ``lm.prefill`` /
  ``lm.decode_step`` (the serving engine passes no frames): the encoder's
  non-causal attention and the decoder's cross-attention (at Sq 64 and
  at Sq 1) on ``flash_attention``, the gelu MLP on ``nmc_matmul``'s gelu
  epilogue and the LM head (N = 51865) on its ``dp4a`` route; launches by
  route, replays, logits, prefill and decode ms.
* W8A8 serving of the hybrid SSM: zamba2-2.7b at full width (30 of its 54
  Mamba2 layers, in 5 of its 9 groups, each followed by the one shared attention /
  MLP block, its own KV cache per group) served by ``ServeEngine`` on
  prompts of 64-512 tokens that the reference can prefill; the Mamba2
  projections stay float (as the reference's ``quantize_tree`` leaves
  them), the shared block and the head run ``nmc_matmul``, the shared
  block's prefill attention (D 80, window 4096) ``flash_attention``;
  launches, replays, logits, prefill and decode ms, the decode step's
  device split.
* W8A8 serving of the xLSTM: xlstm-125m at full width (6 of its 12
  blocks, sLSTM at 3, d_model 768, vocab 50304) served by
  ``ServeEngine`` on the hybrid's prompt lengths; its blocks stay float
  (as the reference's ``quantize_tree`` leaves them), so the LM head is
  the one ``nmc_matmul`` launch per prefill and per decode step, every
  one replayed; logits, prefill and decode ms, each prefill's and the
  decode step's device split (float projections, mLSTM, sLSTM time loop,
  head) and the sLSTM loop's share of the prefill's host time.
* Training: qwen1.5-0.5b at full width and depth (float32 master
  weights, random from a seed; bf16 activations), 8 rows of 512 tokens in
  2 microbatches, every layer's attention through ``flash_attention``
  inside its autograd Function (the backward plain PyTorch): one step's
  gradient through the kernels against the plain versions' (the loss,
  every parameter's gradient within twice the plain path's own spread
  under 1-ulp input noise, every attention launch replayed), then
  ``Trainer.run`` for 4 steps with a crash injected at step 3 and
  restored from the step-2 checkpoint (the replayed step's loss against
  its first attempt's, the checkpoints' bytes and seconds); the step's
  forward, backward and optimizer ms, the attention forward's and the
  backward recompute's device ms beside their bounds and SDPA's, peak
  memory.
* Scale-out: two ranks sharing the card over gloo
  (``launch.mesh.run_ranks``, rank function
  ``distributed.checks.chip_scaleout``): tensor parallelism (qwen1.5-0.5b
  at full width cut to 12 layers on data 1 x model 2), data parallelism with
  ZeRO-2 moments (on 2 x 1), expert parallelism (moonshot-v1-16b-a3b at
  full width cut to 2 layers, 32 experts a rank), MLA with expert
  parallelism (deepseek-v2-lite-16b at full width cut to 2 layers, 8 heads
  a rank on ``flash_attention``'s CUDA-core route) and Mamba2 tensor
  parallelism (zamba2-2.7b at full width cut to 2 groups of 6 layers, 40
  SSM heads a rank), each one train step against the single-rank step
  (loss, every gathered gradient and updated parameter, every attention
  launch replayed on the route it takes); the trainer on 1 x 2 with
  a crash, its checkpoint restored onto 2 x 1 through
  ``elastic.reshard_state`` bit for bit and one more step; the GPipe
  pipeline of those 12 blocks in 2 stages against the blocks in
  sequence; W8A8 serving on 1 x 2 (qwen1.5-0.5b at full width cut to 12 layers,
  deepseek-v2-lite-16b cut to 2 layers, zamba2-2.7b cut to 2 groups): a
  prefill of 4 x 512 tokens into caches of 640 slots split over the
  ranks, then 16 decode steps, against rank 0's single-rank serving
  (logits, gathered caches, launches; every ``nmc_matmul`` and
  attention launch replayed, the int32-out ones bit for bit).  Layouts
  with heads that the model axis does not divide, every rank running
  every head: whisper-tiny on 1 x 4, xlstm-125m on 1 x 8,
  deepseek-v2-lite-16b's dense layer on 1 x 3 (``wq`` split through a
  head), one MLA head and one SSM head on 1 x 2 at smoke width; and
  whisper-tiny serving 4 rows on 2 x 1, its 4-layer cache stack split
  over the data axis.
* The dry run (``python -m repro_torch.launch.dryrun``, no card): in a
  spawned CPU process beside the scale-out phase, the scale-out steps of
  tensor parallelism and of sequence parallelism with remat, and the
  serving part's decode step, traced on the
  ``meta`` device over a fake (data 1, model 2) world, their collectives
  required to equal, call for call and byte for byte, what rank 0 counted
  on the card; the training phase's activation-checkpointing gradients
  traced on one rank, their predicted peak memory printed beside the
  measured one.
* The dispatch queue's staging: 128 tiles, 4 image-carrying programs
  chained on each, on both engines and in both schedulers; outputs
  against the plain engines and the oracles, the queue's counters, every
  copy from pinned memory on the copy stream; wall ms, H2D ms per wave
  and the share of copy time inside a running wave kernel (device trace).
* The kernels demo (``python -m repro_torch.examples.nmc_kernels_demo``):
  ``vrf_alu`` against its plain version bit for bit (both demo programs,
  every op in both modes and the wrap extremes at int8 / int16 / int32 on
  a block-multiple and a ragged VL, 50 random programs), then the demo
  itself end to end; ``vrf_alu`` on its edge cases (rows not 16-byte
  aligned, views at odd offsets, programs longer or wider than one launch,
  vv shifts by lane, empty programs); ``vrf_alu`` at full size (32
  registers x 1,048,576 elements, the VRF of a 1024-tile NM-Carus array:
  the demo's ``fused_chain`` at int8 / int16 / int32, a 64-instruction
  random program at int8 / int32) and at the demo's shape, timed beside
  the empty kernel's launch floor, its plain version and its bound.
* Multi-tile NMC: the five tile-count-sweep kernel families at tiles 1, 2,
  4, 8 and 16, sync and async, on both wave kernels, and one autotuned
  mixed 7 Caesar + 1 Carus ``qrelu`` wave.
* The resident W8A8 block: one qwen-family decoder layer served off the
  tile array with its weights resident, bit-exact three ways.

Output: progress lines, then a ``{"kernels": [...]}`` JSON line, the
``nvidia-smi`` name / power-limit line, and as the last line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Any failed phase exits non-zero; without
a card, or outside a checkout of the repository, it fails before printing a
result.  Imports nothing of JAX or of the JAX package ``repro``.

    python3 chip_smoke.py --time-checkout DIR [--waves-only | --vrf-only]

times the checkout at DIR alone: its ``caesar_wave`` and ``carus_wave`` on
this script's waves, then (unless ``--waves-only``) its serving phase and
its ``nmc_matmul``; with ``--vrf-only`` only its ``vrf_alu``
(:func:`time_checkout`), to compare two checkouts in one call.
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


def compare(engine: str, fields, state, sew: int) -> tuple[int, float]:
    """Run kernel and plain version on the same card tensors; return the
    largest absolute difference of the final images (0 when bit-exact)
    and the plain version's ms (:func:`time_plain`)."""
    import torch
    want, plain_ms = time_plain(engine, fields, state, sew)
    got = kernel(engine)(fields, state.clone(), sew)
    torch.cuda.synchronize()
    return int((got.long() - want.long()).abs().max()), plain_ms


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


def time_kernel(engine: str, fields, state, sew: int, reps: int) -> dict:
    """ms per launch of a wave kernel by CUDA events: ``ms``, ``reps``
    launches back to back over their count (the wrapper's host time, ~40
    us, where it exceeds the kernel's), and ``device_ms``, the device time
    alone (each launch behind :func:`host_ahead`, mean of ``reps``)."""
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
    return {"ms": start.elapsed_time(end) / reps,
            "device_ms": events_ms(lambda: fn(fields, buf, sew), reps,
                                   flush=host_ahead)}


def time_plain(engine: str, fields, state, sew: int) -> tuple:
    """The plain version's final images and its ms by CUDA events, one run
    (it takes seconds per Caesar wave): the kernel-vs-plain phase times
    the run it checks against, and the timing phase reports that time."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = plain_version(engine, fields, state, sew)
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(report: dict) -> None:
    from repro_torch import cuda_build
    t0 = time.perf_counter()
    paths = cuda_build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {report['build_s']:.1f} s for "
        f"{[s.name for s in cuda_build.sources()]}")
    nvcc = subprocess.run([cuda_build._nvcc(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    report["nvcc"] = nvcc
    log(f"  nvcc: {nvcc}")
    for stem, info in cuda_build.BUILD_LOG.items():
        for line in ptxas_summary(info["ptxas"]):
            log(f"  ptxas {stem}: {line}")
    report["sass"] = {stem: sass_evidence(stem, paths[stem])
                      for stem in SASS_OPS}


#: SASS opcodes that show each kernel's design, by source and kernel
#: name: the bf16 (HMMA ... BF16) or int8 (IMMA ... S8) mma.sync, cp.async
#: (LDGSTS) and ldmatrix (LDSM) of the tensor-core kernels; the warp
#: shuffles (SHFL) and votes (VOTE), the writer table's shared atomic OR
#: (ATOMS.OR), the record ring's named barriers (BAR.ARV) and the field
#: ring's cp.async of the Caesar window kernel; the Carus kernel's
#: broadcast record loads (LDS.128), its cp.async staging (LDGSTS) and its
#: block barriers (BAR.SYNC: per chunk, around slides, before the image
#: goes out); the aligned vrf_alu instances' 128-bit global loads and
#: stores and 128-bit slab accesses, and no byte load (SASS_ABSENT)
SASS_OPS = {
    "caesar_wave": ("caesar_wave_kernel",
                    {"shfl": ("SHFL",), "vote": ("VOTE",),
                     "atoms_or": ("ATOMS.OR",), "bar_arv": ("BAR.ARV",),
                     "ldgsts": ("LDGSTS",)}),
    "carus_wave": ("carus_wave_kernel",
                   {"lds128": ("LDS.128",), "ldgsts": ("LDGSTS",),
                    "bar_sync": ("BAR.SYNC",)}),
    "flash_attention": ("flash_attention_tc_kernel",
                        {"hmma_bf16": ("HMMA.", "BF16"),
                         "ldgsts": ("LDGSTS",), "ldsm": ("LDSM",)}),
    "nmc_matmul": ("nmc_matmul_tc_kernel",
                   {"imma_s8": ("IMMA.", "S8"), "ldgsts": ("LDGSTS",),
                    "ldsm": ("LDSM",)}),
    "vrf_alu": ("vrf_alu_kernel",
                {"ldg128": ("LDG.", ".128"), "stg128": ("STG.", ".128"),
                 "lds128": ("LDS.128",), "sts128": ("STS.128",)}),
}
#: SASS opcodes a kernel of SASS_OPS must not have
SASS_ABSENT = {"vrf_alu": {"ldg_u8": ("LDG.", ".U8"),
                           "ldg_s8": ("LDG.", ".S8")}}


def sass_evidence(stem: str, lib) -> dict:
    """Count, in each kernel of :data:`SASS_OPS` in the library built from
    ``csrc/<stem>.cu``, the SASS instructions that show its design
    (``cuobjdump -sass``, from the toolkit beside nvcc); fails if a kernel
    lacks one of them or has one of :data:`SASS_ABSENT`."""
    from repro_torch import cuda_build
    kernel_name, ops = SASS_OPS[stem]
    absent = SASS_ABSENT.get(stem, {})
    ops = {**ops, **absent}
    tool = pathlib.Path(cuda_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = name if kernel_name in name else None
            if fn:
                counts[fn] = dict.fromkeys(ops, 0)
        elif fn:
            for op, keys in ops.items():
                counts[fn][op] += all(k in line for k in keys)
    if not counts or any(not all(v for k, v in c.items() if k not in absent)
                         or any(c[k] for k in absent)
                         for c in counts.values()):
        raise AssertionError(f"{stem}: a {kernel_name} without "
                             f"{' / '.join(ops)} (or with "
                             f"{' / '.join(absent)}) in its SASS: {counts}")
    for fn_name, c in counts.items():
        log(f"  sass {stem} {fn_name}: {c}")
    return counts


#: instructions of the conflict-dense and serial-chain checks (the plain
#: version takes about a millisecond per instruction on the card)
DENSE_N = 2048


def dense_caesar_waves(sew: int) -> dict:
    """Caesar waves whose windows are dense with conflicts: addresses from
    8 and from 32 words, and the serial chain (every instruction reads the
    word the one before it wrote)."""
    from repro_torch.nmc import conformance
    waves = {f"{n} words": conformance.random_wave(
        "caesar", sew, WAVE_TILES, DENSE_N, seed=sew + n, n_words=n)
        for n in (8, 32)}
    waves["serial chain"] = conformance.chain_wave(sew, WAVE_TILES, DENSE_N,
                                                   seed=sew)
    return waves


def dense_carus_waves(sew: int) -> dict:
    """Carus waves that stress the kernel's barriers and chunks: slide-dense
    (every other op a slide, half in place) at the largest bucket and at
    ``DENSE_N``, and a random wave of ``DENSE_N`` instructions (8 chunks,
    VL carried across them)."""
    from repro_torch.nmc import conformance
    n = LARGEST_BUCKET["carus"]
    return {"slide-dense": conformance.slide_wave(sew, WAVE_TILES, n,
                                                  seed=sew),
            "slide-dense long": conformance.slide_wave(sew, WAVE_TILES,
                                                       DENSE_N, seed=sew + 1),
            "random long": conformance.random_wave("carus", sew, WAVE_TILES,
                                                   DENSE_N, seed=sew + 2)}


def phase_kernels_vs_plain(report: dict, device) -> dict:
    """Every kernel against its plain version: random waves at the largest
    Table V buckets, every SEW; Caesar waves dense with conflicts and the
    serial chain, Carus waves dense with slides and longer than one chunk,
    every SEW; then every golden opcode program."""
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
            err, plain_ms = compare(engine, fields, state, sew)
            log(f"kernel vs plain: {engine} sew={sew} T={WAVE_TILES} "
                f"n={LARGEST_BUCKET[engine]}: max_abs_err={err}")
            if err:
                raise AssertionError(f"{engine} sew={sew}: kernel != plain")
            errs[engine] = max(errs[engine], err)
            waves[(engine, sew)] = (progs, states, plain_ms)
    for engine, dense in (("caesar", dense_caesar_waves),
                          ("carus", dense_carus_waves)):
        for sew in SEWS:
            for label, (progs, states) in dense(sew).items():
                check.assert_wave(progs)
                fields, state = wave_tensors(progs, states, device)
                err, _ = compare(engine, fields, state, sew)
                log(f"kernel vs plain: {engine} {label} sew={sew} "
                    f"T={len(progs)} n={progs[0].n_instr}: "
                    f"max_abs_err={err}")
                if err:
                    raise AssertionError(f"{engine} {label} sew={sew}: "
                                         f"kernel != plain")
                errs[engine] = max(errs[engine], err)
    n_golden = 0
    for engine, label, entries in conformance.golden_cases():
        for sew in SEWS:
            prog = Program.from_entries(engine, sew, entries) \
                .pad_to(conformance.CONF_BUCKET)
            state = conformance.golden_state(engine, sew)[None]
            fields, st = wave_tensors([prog], state, device)
            err, _ = compare(engine, fields, st, sew)
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
    if queue.stager is None or queue.stager.copies != len(builds):
        raise AssertionError("an image of the async run was not staged "
                             "through the pinned stager")
    log(f"main path: ResidentPool + DispatchQueue async == sync == oracle "
        f"({len(builds)} builds, {resident_s:.3f} s); "
        f"queue submitted={queue.submitted} launched={queue.launched} "
        f"resolved={queue.resolved} waves={queue.waves} "
        f"staged_while_busy={queue.staged_while_busy}, "
        f"{queue.stager.copies} images staged through pinned memory on the "
        f"copy stream; pool "
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


#: the staging phase: T tiles fed round-robin, K image-carrying programs
#: chained on each (every submit carries a full 32 KiB image: Caesar's
#: 8192-word memory, Carus's 32 x 256-word VRF), so a wave stages 4 MiB
STAGING = dict(tiles=128, chained=4)
#: its builds: the Table V kernels, on Caesar at SEW 8 (1024-13312
#: instructions; the plain engine, which the outputs are also held to,
#: takes ~0.5 ms an instruction on the host, ~18 s for these), on Carus at
#: SEW 8, 16 and 32
STAGING_SEWS = {"caesar": (8,), "carus": SEWS}


def staging_builds(engine: str) -> list:
    """The distinct builds of the staging phase for ``engine``."""
    from repro_torch.core import programs as P
    return [getattr(P.build(name, sew), engine)
            for sew in STAGING_SEWS[engine] for name in P.TABLE_V_KERNELS]


def staging_trace(run, name: str) -> tuple:
    """``run()`` under ``torch.profiler`` (device activity only): ``(its
    result, the staging copies, the wave kernels)``, each a list of
    ``(start us, end us)`` from the device trace.  The kernels are the
    ``caesar_wave`` / ``carus_wave`` launches; the copies every
    host-to-device copy from pinned memory on another stream than theirs
    (the trace's ``stream``), each checked to be one 32 KiB image.  The
    trace goes through ``chiprun_out/NAME`` and is removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    path = REPO / "chiprun_out" / name
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "_wave" in e.get("name", "")]
    streams = {e["args"]["stream"] for e in kernels}
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")
              and e["args"]["stream"] not in streams]
    if not kernels or any("Pinned" not in e["name"]
                          or e["args"].get("bytes") != 32768
                          for e in copies):
        raise AssertionError(f"staging trace: {len(kernels)} wave kernels, "
                             f"copies off their stream "
                             f"{sorted({(e['name'], e['args'].get('bytes')) for e in copies})}")

    def spans(evs):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in evs)
    return out, spans(copies), spans(kernels)


def copy_share_in_waves(copies: list, waves: list) -> dict:
    """From the device trace: the staging copies' total ms, the wave
    kernels' (their union) and the share of copy time inside a running
    wave kernel."""
    merged = []
    for a, b in waves:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    inside = 0.0
    for a, b in copies:
        for wa, wb in merged:
            inside += max(0.0, min(b, wb) - max(a, wa))
    copy_us = sum(b - a for a, b in copies)
    return {"copy_ms": copy_us * 1e-3,
            "wave_ms": sum(b - a for a, b in merged) * 1e-3,
            "hidden_share": inside / copy_us if copy_us else None}


def staged_run(engine: str, builds: list, mode: str, traced: bool):
    """The items through a ``DispatchQueue`` over ``ResidentPool(backend=
    "cuda")`` on :data:`STAGING`'s tiles: ``(outputs, queue, wall ms,
    (copies, kernels))``, wall ms by the host clock; with ``traced`` under
    the profiler (:func:`staging_trace`), else no spans."""
    import torch
    from repro_torch import nmc
    queue = nmc.DispatchQueue(pool=nmc.ResidentPool(backend="cuda"),
                              mode=mode)

    def run():
        return queue.run_builds(builds, n_tiles=STAGING["tiles"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if traced:
        outs, copies, kernels = staging_trace(
            run, f"staging_trace_{engine}_{mode}.json")
    else:
        outs, copies, kernels = run(), None, None
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return outs, queue, wall_ms, (copies, kernels)


def phase_staging(report: dict) -> dict:
    """The dispatch queue's staging on the card: T = 128 tiles, K = 4
    image-carrying programs chained on each, in Caesar and in Carus, once
    ``overlapped`` and once ``inorder``.  Every image goes through the
    queue's :class:`PinnedStager`: a page-locked host buffer, an
    asynchronous copy on the stager's own stream, the wave's wait on its
    event.  Checks, in both schedulers and on both engines: outputs bit
    for bit equal to each other, to the plain engines' (``backend=
    "torch"``, on the host) and to the oracles; the queue's counters as
    ``tests/test_runtime.py`` expects them; every image staged by the
    stager, on a stream other than the compute stream, from pinned
    buffers.  Reports each mode's wall ms (host clock, a run without
    profiler, best of 3), and from a run under the profiler (device
    trace) the H2D ms per wave, the share of copy time inside a running
    wave kernel, and that every staging copy ran on another stream than
    the kernels.  The wave kernels' counts are set to 0 just before the
    runs and read just after."""
    import numpy as np
    import torch
    from repro_torch import nmc
    from repro_torch.nmc import cuda_engine
    smi = report["nvidia_smi"]
    tiles, chained = STAGING["tiles"], STAGING["chained"]
    out, launches = {}, {}
    for engine in ("caesar", "carus"):
        distinct = staging_builds(engine)
        plain = nmc.ResidentPool(backend="torch").run_builds(distinct)
        for eb, got in zip(distinct, plain):
            exp = np.asarray(eb.oracle).reshape(-1)
            if not (got.reshape(-1)[:exp.size] == exp).all():
                raise AssertionError(f"staging: plain {engine} != oracle")
        n = tiles * chained
        builds = [distinct[k % len(distinct)] for k in range(n)]
        want = [plain[k % len(distinct)] for k in range(n)]
        rows = {}
        cuda_engine.reset_launch_counts()
        for mode in ("overlapped", "inorder"):
            walls = []
            for rep in range(4):
                traced = rep == 3
                outs, queue, wall_ms, (copies, kernels) = staged_run(
                    engine, builds, mode, traced)
                if not all(np.array_equal(a, b) for a, b in zip(outs, want)):
                    raise AssertionError(f"staging: {engine} {mode} output "
                                         f"!= plain / oracle")
                expect = {"staged_while_busy": 0, "waves": n} \
                    if mode == "inorder" else \
                    {"staged_while_busy": n - tiles, "waves": n // tiles}
                got = {k: getattr(queue, k) for k in expect}
                st = queue.stager
                if got != expect or queue.resolved != n or \
                        st.copies != n or st.bytes != n * 32768 or \
                        st.stream == torch.cuda.current_stream() or \
                        not st.pinned or \
                        not all(b.is_pinned() for b in st.pinned):
                    raise AssertionError(
                        f"staging: {engine} {mode}: counters {got} (want "
                        f"{expect}), resolved {queue.resolved}, copies "
                        f"{st.copies}, bytes {st.bytes}, pinned buffers "
                        f"{[b.is_pinned() for b in st.pinned]}")
                if traced:
                    if len(copies) != n:
                        raise AssertionError(
                            f"staging: {engine} {mode}: {len(copies)} "
                            f"copies of {n} off the kernels' stream")
                    share = copy_share_in_waves(copies, kernels)
                else:
                    walls.append(wall_ms)
            rows[mode] = dict(
                wall_ms=min(walls), wall_ms_runs=walls,
                waves=queue.waves, staged_while_busy=queue.staged_while_busy,
                copies=st.copies, copy_bytes=st.bytes,
                pinned_buffers=len(st.pinned),
                h2d_ms_per_wave=share["copy_ms"] / queue.waves,
                traced_wall_ms=wall_ms,
                wave_ms=share["wave_ms"], copy_ms=share["copy_ms"],
                hidden_share=share["hidden_share"],
                pool_loads=queue.pool.loads,
                pool_bytes_moved=queue.pool.bytes_moved)
            log(f"staging: {engine} {mode}, {n} items on {tiles} tiles "
                f"({len(distinct)} distinct builds, outputs == plain == "
                f"oracle): wall {min(walls):.3f} ms (best of "
                f"{len(walls)}), {queue.waves} waves, staged_while_busy "
                f"{queue.staged_while_busy}; {st.copies} copies of 32 KiB "
                f"on the copy stream from {len(st.pinned)} pinned buffers; "
                f"H2D {rows[mode]['h2d_ms_per_wave']:.4f} ms per wave "
                f"({share['copy_ms']:.3f} ms in all), wave kernels "
                f"{share['wave_ms']:.3f} ms in all, copy time inside a "
                f"running kernel {share['hidden_share']:.4f} [{smi}]")
        if rows["overlapped"]["pool_bytes_moved"] < n * 32768:
            raise AssertionError("staging: the pool accounted fewer bytes "
                                 "than the images")
        launches[engine] = {k.__name__: k.launches
                            for k in cuda_engine.KERNELS}
        if launches[engine][KERNEL_META[engine]["name"]] <= 0:
            raise AssertionError(f"staging: no {engine} wave launched")
        out[engine] = rows
    report["staging"] = dict(**STAGING, engines=out, launches=launches,
                             nvidia_smi=smi)
    return {k.__name__: sum(launches[e][k.__name__] for e in launches)
            for k in cuda_engine.KERNELS}


def phase_timing(report: dict, waves: dict, device) -> dict:
    """ms per launch at T in {1, 128} at the largest Table V bucket; the
    plain version's time at T=128 and SEW 8 only, the row the kernels
    line reports: that of its run in the kernel-vs-plain phase on the same
    wave (it takes 17-26 s per Caesar wave, so it is not run again).
    Then the Caesar waves of :func:`caesar_timed_waves` (Table V gemm and
    leaky_relu, the serial chain), each with its rounds per window, and
    the Carus waves of :func:`carus_timed_waves` (Table V gemm, matmul and
    conv2d, slide-dense), each with its records and barriers."""
    rows = []
    for (engine, sew), (progs, states, plain_ms) in sorted(waves.items()):
        for n_tiles in (1, WAVE_TILES):
            ps, st = progs[:n_tiles], states[:n_tiles]
            fields, state = wave_tensors(ps, st, device)
            times = time_kernel(engine, fields, state, sew,
                                reps=20 if engine == "caesar" else 100)
            plain = plain_ms if n_tiles == WAVE_TILES and sew == 8 else None
            bms, by = bound_ms(engine, ps)
            rows.append(dict(engine=engine, sew=sew, tiles=n_tiles,
                             n_instr=ps[0].n_instr, **times, plain_ms=plain,
                             bound_ms=bms, bound_by=by))
            cost = wave_cost(engine, ps)
            rows[-1].update(cost)
            plain_txt = "not timed" if plain is None else f"{plain:.2f} ms"
            log(f"timing: {engine} sew={sew} T={n_tiles} "
                f"n={ps[0].n_instr}: kernel {times['ms']:.4f} ms (device "
                f"{times['device_ms']:.4f}), plain "
                f"{plain_txt}, bound {bms:.5f} ms ({by}), "
                f"{cost_text(cost)}")
    report["timing"] = rows
    report["caesar_waves"] = time_waves(
        "caesar", caesar_timed_waves(random=False), device)
    report["carus_waves"] = time_waves(
        "carus", carus_timed_waves(random=False), device)
    return {r["engine"]: r for r in rows
            if r["sew"] == 8 and r["tiles"] == WAVE_TILES}


def wave_cost(engine: str, progs) -> dict:
    """The kernel's value-free cost of a wave's first program: Caesar's
    rounds per window (``cuda_engine.caesar_window_rounds``), Carus's
    executed records and barriers (``cuda_engine.carus_schedule``)."""
    from repro_torch.nmc import cuda_engine
    if engine == "caesar":
        rounds = cuda_engine.caesar_window_rounds(progs[0].entries)
        return {"rounds_per_window": float(rounds.mean())}
    sched = cuda_engine.carus_schedule(progs[0].entries, progs[0].sew)
    return {"records": len(sched.records), "barriers": sched.barriers,
            "slide_barriers": sched.slide_barriers}


def cost_text(cost: dict) -> str:
    if "rounds_per_window" in cost:
        return f"{cost['rounds_per_window']:.3f} rounds per window"
    return (f"{cost['records']} records, {cost['barriers']} barriers "
            f"({cost['slide_barriers']} around slides)")


def numpy_wave(engine: str, label: str, sew: int, progs, states) -> dict:
    """A wave as numpy arrays, with its bound and :func:`wave_cost`."""
    import numpy as np
    from repro_torch.nmc.program import stack_programs
    bms, by = bound_ms(engine, progs)
    return dict(label=label, sew=sew, tiles=len(progs),
                n_instr=progs[0].n_instr, **wave_cost(engine, progs),
                bound_ms=bms, bound_by=by, fields=stack_programs(progs),
                states=np.ascontiguousarray(states))


def caesar_timed_waves(random: bool) -> list[dict]:
    """Caesar waves to time, as numpy arrays, so that another checkout's
    kernel can run them too: with ``random`` the random waves of
    :func:`phase_kernels_vs_plain` (every SEW, T in {1, 128}); then, at
    T=128 and SEW 8, the Table V Caesar programs with the deepest windows
    (gemm: 4 rounds, leaky_relu: 2) and the serial chain (32 rounds)."""
    import numpy as np
    from repro_torch.core import programs as P
    from repro_torch.nmc import conformance
    n = LARGEST_BUCKET["caesar"]
    waves = []
    for sew in SEWS if random else ():
        progs, states = conformance.random_wave("caesar", sew, WAVE_TILES, n,
                                                seed=sew)
        waves += [numpy_wave("caesar", "random", sew, progs[:t], states[:t])
                  for t in (1, WAVE_TILES)]
    for name in ("gemm", "leaky_relu"):
        eb = P.build(name, 8).caesar
        waves.append(numpy_wave("caesar", f"table_v {name}", 8,
                                [eb.program] * WAVE_TILES,
                                np.stack([eb.mem] * WAVE_TILES)))
    progs, states = conformance.chain_wave(8, WAVE_TILES, n, seed=8)
    waves.append(numpy_wave("caesar", "serial chain", 8, progs, states))
    return waves


def carus_timed_waves(random: bool) -> list[dict]:
    """Carus waves to time, as numpy arrays: with ``random`` the random
    waves of :func:`phase_kernels_vs_plain` (every SEW, T in {1, 128});
    then, at T=128 and SEW 8, the Table V Carus programs padded to their
    buckets (gemm and matmul: 256, a third of it and more compacted out;
    conv2d: 128 with 16 slides) and the slide-dense wave."""
    import numpy as np
    from repro_torch.core import programs as P
    from repro_torch.nmc import conformance
    from repro_torch.nmc.program import instr_bucket
    n = LARGEST_BUCKET["carus"]
    waves = []
    for sew in SEWS if random else ():
        progs, states = conformance.random_wave("carus", sew, WAVE_TILES, n,
                                                seed=sew)
        waves += [numpy_wave("carus", "random", sew, progs[:t], states[:t])
                  for t in (1, WAVE_TILES)]
    for name in ("gemm", "matmul", "conv2d"):
        eb = P.build(name, 8).carus
        prog = eb.program.pad_to(instr_bucket(eb.program.n_instr))
        waves.append(numpy_wave("carus", f"table_v {name}", 8,
                                [prog] * WAVE_TILES,
                                np.stack([eb.mem] * WAVE_TILES)))
    progs, states = conformance.slide_wave(8, WAVE_TILES, n, seed=8)
    waves.append(numpy_wave("carus", "slide-dense", 8, progs, states))
    return waves


def time_waves(engine: str, waves: list[dict], device) -> list[dict]:
    """ms per launch of the wave kernel of ``engine`` (the package
    imported now) on each wave of :func:`caesar_timed_waves` or
    :func:`carus_timed_waves`."""
    import torch
    rows = []
    for w in waves:
        fields = {k: torch.as_tensor(v, device=device)
                  for k, v in w["fields"].items()}
        state = torch.as_tensor(w["states"], device=device)
        row = {k: v for k, v in w.items() if k not in ("fields", "states")}
        row.update(time_kernel(engine, fields, state, w["sew"],
                               reps=20 if engine == "caesar" else 100))
        rows.append(row)
        log(f"timing: {engine} {w['label']} sew={w['sew']} T={w['tiles']} "
            f"n={w['n_instr']}: kernel {row['ms']:.4f} ms (device "
            f"{row['device_ms']:.4f}), bound "
            f"{w['bound_ms']:.5f} ms ({w['bound_by']}), {cost_text(row)}")
    return rows


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
#: attention's timed shapes: a causal prefill of qwen1.5-0.5B (16 heads of
#: 64) at three prompt lengths in bf16, and once in float32
ATTENTION_SHAPES = ((128, "bfloat16"), (384, "bfloat16"), (1000, "bfloat16"),
                    (384, "float32"))
ATTENTION_REPS = 50
#: the attention cases of the encoder-decoder and the hybrid timed beside
#: the served models' (``checks.ATTENTION_CASES``); the partial one with
#: and without its log-sum-exp
ATTENTION_NEW_CASES = ("whisper-enc-1500", "whisper-cross-64",
                       "whisper-cross-decode", "whisper-cross-partial-750",
                       "zamba2-512")
SLEEP_CYCLES = 1_000_000             # about 0.5 ms at the H100's clock
MATMUL_REPS = 10
#: decode steps profiled for their kernels' device time
PROFILED_STEPS = 5
#: the rows ``torch._int_mm`` (which needs M > 16) gets at decode: x
#: zero-padded, the product sliced back
LIBRARY_PADDED_ROWS = 32
#: ``nmc_matmul`` calls per host-time reading, and the device sleep (about
#: 25 ms) that keeps every one of them from waiting on the card
HOST_CALLS = 200
HOST_SLEEP_CYCLES = 50_000_000


def event_times(fn, reps: int, flush=None) -> list:
    """ms of each of ``reps`` calls by CUDA events around the call, after a
    warm-up; ``flush`` runs first, outside the timed span: :func:`l2_flush`
    evicts the 50 MB L2, :func:`host_ahead` only lets the host get ahead."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def events_ms(fn, reps: int, flush=None) -> float:
    """Mean ms per call of :func:`event_times`."""
    return sum(event_times(fn, reps, flush)) / reps


def events_mean_median(fn, reps: int, flush=None) -> tuple:
    """(mean, median) ms per call of :func:`event_times`."""
    import statistics
    times = event_times(fn, reps, flush)
    return sum(times) / reps, statistics.median(times)


def l2_flush(device):
    """A callable that evicts the 50 MB L2 by reading 512 MB.  A read leaves
    clean lines behind, where clearing a buffer would leave dirty lines for
    the timed kernel to write back, and it outlasts a wrapper's host work,
    so the timed span that follows holds the kernel alone."""
    import torch
    buf = torch.ones(128 << 20, dtype=torch.float32, device=device)
    return lambda: buf.max()


def host_ahead() -> None:
    """A flush for :func:`events_ms` that keeps the device busy for about
    0.5 ms and nothing else: the host enqueues the timed call meanwhile, so
    the events bracket device work alone, without the wrapper's host time
    (the L2 is left as the previous call left it)."""
    import torch
    torch.cuda._sleep(SLEEP_CYCLES)


def matmul_bound_ms(m: int, k: int, n: int, out_bytes: int) -> tuple:
    nbytes = m * k + k * n + 8 * n + m * n * out_bytes
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * m * n * k / INT_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def visible_pairs(sq: int, skv: int, causal: bool = True, window=None,
                  q_offset: int = 0) -> int:
    """The query-key pairs one head's attention sees: key j for query i
    where ``j <= i + q_offset`` (causal) and ``j > i + q_offset - window``
    (a window)."""
    total = 0
    for i in range(sq):
        hi = min(skv, i + q_offset + 1) if causal else skv
        lo = max(0, i + q_offset - window + 1) if window is not None else 0
        total += max(0, hi - lo)
    return total


def attention_bound_ms(b, hq, hkv, sq, d, dv, elem, skv=None, causal=True,
                       window=None, q_offset=0, lse=False) -> dict:
    """Bytes: q, k, v read once and o written once (and with ``lse`` the
    float32 log-sum-exp of each row).  Operations: 2 D + 2 Dv per visible
    query-key pair (:func:`visible_pairs`; ``skv`` is ``sq`` when None),
    against the bf16 tensor peak (the f32 CUDA-core peak, the rate of the
    kernel's own f32 math, kept beside it)."""
    skv = sq if skv is None else skv
    nbytes = elem * (b * hq * sq * (d + dv) + b * hkv * skv * (d + dv)) \
        + (4 * b * hq * sq if lse else 0)
    flops = b * hq * visible_pairs(sq, skv, causal, window, q_offset) \
        * (2 * d + 2 * dv)
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
    attn_by_route = {"tensor_core": 0.0, "cuda_core": 0.0}
    cases = []
    from repro_torch.kernels import nmc_matmul as mm
    serving = checks.serving_matmul_shapes()
    for m, k, n in serving + list(checks.MATMUL_RAGGED) \
            + list(checks.MATMUL_EDGES):
        kind = mm.route(k, n)
        if (m, k, n) in serving and kind != checks.serving_route(k, n) or \
                (m, k, n) in checks.MATMUL_RAGGED and kind != "dp4a":
            raise AssertionError(f"nmc_matmul {m}x{k}x{n}: route {kind}")
        by_route = dict(mm.nmc_matmul.launches_by_route)
        errs = checks.check_matmul(m, k, n, device)
        torch.cuda.synchronize()
        if mm.nmc_matmul.launches_by_route[kind] != by_route[kind] + 9:
            raise AssertionError(f"nmc_matmul {m}x{k}x{n}: launches by "
                                 f"route {mm.nmc_matmul.launches_by_route}")
        f32 = max(v for c, v in errs.items() if not c.endswith("bf16"))
        worst["nmc_matmul"] = max(worst["nmc_matmul"], f32)
        plan = mm.plan(m, n, k, mm.sm_count(device.index)) \
            if kind == "tensor_core" else None
        cases.append({"kernel": "nmc_matmul", "shape": [m, k, n],
                      "route": kind, "plan": plan, **errs})
        log(f"lm kernel vs plain: nmc_matmul M={m} K={k} N={n} ({kind} "
            f"route, plan {plan}): "
            + " ".join(f"{c}={v:.3g}" for c, v in errs.items()))
    for name in checks.ATTENTION_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            err = checks.check_attention(name, dtype, device)
            torch.cuda.synchronize()
            kind = checks.attention_route(name, dtype)
            attn_by_route[kind] = max(attn_by_route[kind], err)
            cases.append({"kernel": "flash_attention", "case": name,
                          "dtype": str(dtype), "route": kind,
                          "max_abs_err": err})
            log(f"lm kernel vs plain: flash_attention {name} {dtype} "
                f"({kind} route): max_abs_err={err:.3g}")
    worst["flash_attention"] = attn_by_route
    report["lm_cases"] = cases
    report["lm_max_abs_err"] = worst
    return worst


@contextlib.contextmanager
def recorded_lm_kernel_calls(names=("nmc_matmul", "flash_attention"),
                             keep=None):
    """Record the inputs and output of every launch of the LM kernels in
    ``names`` that the models make inside the block (of those for which
    ``keep(name, args)`` is true, when given), at the dispatch layer
    (``kernels/ops.py``): the wrappers themselves run, and count, as
    usual."""
    import types
    from repro_torch.kernels import ops
    calls = []
    orig_mm, orig_fa = ops._mm, ops._fa

    def recorder(name, fn):
        if name not in names:
            return fn

        def wrapper(*args, **kw):
            out = fn(*args, **kw)
            if keep is None or keep(name, args):
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
    with the tolerances of kernels/checks.py (raises beyond them); the
    attention launches' worst error also by route."""
    from repro_torch.kernels import checks, flash_attention as fa, ref
    worst = {"nmc_matmul": 0.0, "flash_attention": 0.0}
    count = {"nmc_matmul": 0, "flash_attention": 0}
    attn_by_route = {}
    for i, (name, args, kw, out) in enumerate(calls):
        if name == "nmc_matmul":
            want = ref.nmc_matmul(*args, **kw)
            tol = checks.matmul_tolerance(kw["act"], kw["out_dtype"])
            err = checks.close(f"{name} launch {i}", out, want, *tol)
        else:
            want = fa.chunked_attention(*args, **kw)
            err = checks.close_attention(f"{name} launch {i}", out, want,
                                         args[0].dtype)
        worst[name] = max(worst[name], err)
        count[name] += 1
        if name == "flash_attention":
            kind = fa.route(args[0].dtype, args[0].shape[-1],
                            args[2].shape[-1])
            attn_by_route[kind] = max(attn_by_route.get(kind, 0.0), err)
    return {"launches": count, "max_abs_err": worst,
            "attention_by_route": attn_by_route}


def perturbed_plain_logits(params, batch, cfg, seed: int = 1):
    """The plain path's logits with half the embedded inputs (a VLM's
    projected images too; an encoder-decoder's frames and decoder inputs)
    moved by one ulp of the working type (``cfg.dtype``; the step is taken
    on the host, where ``nextafter`` takes every float type): the model's
    own sensitivity to last-bit noise."""
    import torch
    from repro_torch.kernels import ops
    gen = torch.Generator(device=params.device).manual_seed(seed)

    def nudge(x):
        flip = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
        host = x.cpu()
        up = torch.nextafter(host, torch.full_like(host, 1e30)).to(x.device)
        return torch.where(flip, up, x)
    with torch.inference_mode(), ops.force_plain():
        if cfg.family == "encdec":
            enc = params.encode(nudge(batch["frames"].to(cfg.dtype)), cfg)
            x = nudge(params.inputs(batch, cfg))
            return params.logits(params.hidden(x, enc, cfg), cfg)
        x = nudge(params.inputs(batch, cfg))
        return params.logits(params.hidden(x, cfg)[0], cfg)


def compare_logits(params, cfg, batch, device,
                   spread_factor: float | None = None,
                   spread_if_reached: bool = False) -> dict:
    """One prompt (``batch``: its ``"tokens"``, a VLM's ``"images"`` too,
    batch 1, on the card) through the kernels and under
    ``ops.force_plain()``, with the served bf16 activations and with
    float32 ones.

    1. Every kernel launch of the kernels' forward is replayed through its
       plain version on the same inputs, within the tolerances of
       kernels/checks.py: the kernels are right at this width and on these
       activations.
    2. The logits of every position (the prefill's are the last row).
       W8A8 with a per-tensor dynamic scale is discontinuous: where the two
       attention versions differ in the last bit (another summation
       order), an int8 rounding flips (in a MoE model, a routing pick
       too), and the later layers carry it on.  Moving the plain path's
       inputs by one ulp of the working type shows the model's own spread,
       printed beside, for both dtypes.  The float32 prefill's top-1 token
       through the kernels must be the plain path's, or the one the plain
       path picks under that 1-ulp noise, unless the float32 spread itself
       reaches the fixed limits below (zamba2-2.7b's: 1-ulp noise moves
       nearly every position's top-1, so the plain path's own top-1 is
       noise there and tells nothing of the kernels; the replays of 1. and
       the spread rule still hold).  For both dtypes the RMS
       difference must stay under 25% of the logit scale and the top-1
       tokens agree at half the positions or more; with ``spread_factor``
       (a model whose own spread reaches those limits) the RMS must stay
       under ``spread_factor`` times the 1-ulp spread's and the agreement
       at or above the 1-ulp spread's divided by ``spread_factor`` — for
       every dtype, or with ``spread_if_reached`` only for a dtype whose
       spread reaches the fixed limits.  A wrong kernel (unrelated logits:
       RMS about 140%, agreement near 0) fails either."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    out = {}
    n = batch["tokens"].shape[1]
    for dtype in (torch.float32, torch.bfloat16):
        c = cfg.scaled(dtype=dtype)
        with recorded_lm_kernel_calls() as calls:
            got, _ = lm.forward(params, batch, c)
        replay = replay_against_plain(calls)
        del calls
        with ops.force_plain():
            want, _ = lm.forward(params, batch, c)
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
        pert = perturbed_plain_logits(params, batch, c)[0].float()
        st["ulp_perturbed_plain"] = dict(
            max_abs_diff=float((pert - want).abs().max()),
            rms_diff=float((pert - want).pow(2).mean().sqrt()),
            top1_agreement=float((pert.argmax(-1) == want.argmax(-1))
                                 .float().mean()),
            last_top1=int(pert[-1].argmax()))
        del got, want, pert
        out[str(dtype)] = st
        log(f"logits: {cfg.name} {dtype} forward of a {n}-token prompt "
            f"({batch_positions(batch)} positions): "
            f"{replay['launches']} launches replayed through the plain "
            f"versions, max abs err {replay['max_abs_err']}; logits kernels "
            f"vs plain: max_abs_diff={st['max_abs_diff']:.4g} "
            f"rms={st['rms_diff']:.4g} (logit std {st['logit_std']:.4g}), "
            f"top-1 agreement {st['top1_agreement']:.4f}, prefill top-1 "
            f"kernels {st['last_top1_kernels']} plain "
            f"{st['last_top1_plain']} (plain top-2 gap "
            f"{st['plain_top2_gap']:.4g}); plain vs plain with 1-ulp "
            f"inputs: {st['ulp_perturbed_plain']}")
        spread = st["ulp_perturbed_plain"]
        rms_limit, agree_limit = 0.25 * st["logit_std"], 0.5
        reached = spread["rms_diff"] >= rms_limit or \
            spread["top1_agreement"] <= agree_limit
        rule = "fixed"
        if spread_factor is not None and (reached or not spread_if_reached):
            rule = "spread"
            rms_limit = spread_factor * spread["rms_diff"]
            agree_limit = spread["top1_agreement"] / spread_factor
        st.update(rms_limit=rms_limit, top1_agreement_limit=agree_limit,
                  rule=rule, spread_reaches_fixed_limits=reached)
        log(f"logits: {cfg.name} {dtype}: {rule} limits, rms <= "
            f"{rms_limit:.4g}, top-1 agreement >= {agree_limit:.4f} (the "
            f"1-ulp spread {'reaches' if reached else 'stays inside'} the "
            f"fixed limits)")
        if st["rms_diff"] > rms_limit or st["top1_agreement"] < agree_limit:
            raise AssertionError(f"{dtype} logits through the kernels stray "
                                 f"from the plain versions' (rms "
                                 f"{st['rms_diff']:.4g} > {rms_limit:.4g} or "
                                 f"top-1 agreement {st['top1_agreement']:.4f}"
                                 f" < {agree_limit:.4f})")
        st["top1_rule"] = dtype == torch.float32 and not reached
        if st["top1_rule"] and st["last_top1_kernels"] not in \
                (st["last_top1_plain"], spread["last_top1"]):
            raise AssertionError("the float32 prefill's top-1 token through "
                                 "the kernels is neither the plain path's "
                                 "nor the one it picks under 1-ulp noise")
        if dtype == torch.float32 and reached:
            log(f"logits: {cfg.name} float32: the 1-ulp spread reaches the "
                f"fixed limits, so the plain path's own top-1 is noise; the "
                f"top-1 rule is not applied")
    return out


def batch_positions(batch) -> int:
    """The positions a batch's forward covers: its images' and tokens'."""
    return sum(batch[k].shape[1] for k in ("images", "tokens") if k in batch)


def serving_model(device, seed: int = 0) -> tuple:
    """``(cfg, params)`` of the serving phase: qwen1.5-0.5B in W8A8 at full
    width, random weights from ``seed``, quantized; built by whichever
    ``repro_torch`` is imported."""
    import torch
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import quantize_params
    cfg = configs.get(SERVE_ARCH).scaled(nmc_mode="w8a8")
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, quantize_params(lm.init_params(cfg, gen, device), cfg)


def serving_prompts(cfg, rng, choices=None) -> tuple:
    """(lengths, prompts) of the :data:`SERVE` traffic, drawn from ``rng``:
    lengths uniform in ``prompt_lo`` .. ``prompt_hi``, or out of
    ``choices``."""
    import numpy as np
    lengths = rng.integers(SERVE["prompt_lo"], SERVE["prompt_hi"] + 1,
                           SERVE["requests"]) if choices is None \
        else rng.choice(choices, SERVE["requests"])
    return lengths, [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
                     for n in lengths]


def phase_serving(report: dict, device, seed: int = 0) -> dict:
    """The port's W8A8 serving path at qwen1.5-0.5B's full width: random
    weights from a seeded generator, quantized, served by ServeEngine.
    The LM kernels' launch counts are set to 0 just before and read just
    after."""
    import numpy as np
    import torch
    from repro_torch import configs, kernels
    from repro_torch.kernels import flash_attention as fa, ops
    from repro_torch.kernels import nmc_matmul as mm
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine, \
        quantize_params

    cfg, params = serving_model(device, seed)
    rng = np.random.default_rng(seed)
    lengths, prompts = serving_prompts(cfg, rng)

    def engine():
        eng = ServeEngine(cfg, params, n_slots=SERVE["n_slots"],
                          max_len=SERVE["max_len"], device=device)
        for i, pr in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=pr, max_new=SERVE["max_new"]))
        return eng
    eng = engine()
    calls0 = eng.nmc_queue.calls
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    attn_routes = dict(fa.flash_attention.launches_by_route)
    mm_routes = dict(mm.nmc_matmul.launches_by_route)
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
    if attn_routes["tensor_core"] != launches["flash_attention"]:
        raise AssertionError(f"bf16 serving attention off the tensor-core "
                             f"route: {attn_routes}")
    if mm_routes["tensor_core"] != launches["nmc_matmul"]:
        raise AssertionError(f"a serving projection off the tensor-core "
                             f"route: {mm_routes}")
    log(f"serving: nmc_matmul launches by route {mm_routes}")
    # the same run once more, recording every attention launch, each then
    # held against the plain version on its own inputs (not counted: the
    # main path's counts were read above; not in the timed run, whose
    # allocator the recording's live tensors would change)
    eng = engine()
    t0 = time.perf_counter()
    with recorded_lm_kernel_calls(("flash_attention",)) as attn_calls:
        eng.run()
        torch.cuda.synchronize()
    recorded_s = time.perf_counter() - t0
    attn_replay = replay_against_plain(attn_calls)
    del attn_calls, eng
    if attn_replay["launches"]["flash_attention"] != cfg.n_layers * prefills:
        raise AssertionError(f"the recorded run launched attention "
                             f"{attn_replay['launches']} times")
    log(f"serving: {attn_replay['launches']['flash_attention']} attention "
        f"launches (routes {attn_routes}) replayed through the plain "
        f"version, max abs err {attn_replay['max_abs_err']['flash_attention']}"
        f"; the recorded run took {recorded_s:.3f} s")
    tokens = [t for r in done for t in r.out]
    if not all(0 <= t < cfg.vocab_size for t in tokens):
        raise AssertionError("a token outside the vocabulary")

    # one prompt through the kernels and through the plain versions (not
    # counted: the main path's counts were read above)
    logits = compare_logits(
        params, cfg, {"tokens": torch.as_tensor(prompts[0][None],
                                                device=device)}, device)

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
    step_kernels = decode_step_kernel_ms(device, params, cfg)
    log(f"serving: prefill ms by prompt length "
        f"{ {n: round(v, 3) for n, v in prefill_ms.items()} }; decode step "
        f"{step_ms:.3f} ms at {SERVE['n_slots']} slots = "
        f"{1e3 / step_ms:.1f} steps/s; device time per step (profiler): "
        f"{step_kernels}")
    report["serving"] = dict(
        arch=SERVE_ARCH, **SERVE, prompt_lengths=[int(n) for n in lengths],
        seconds=serve_s, prefills=prefills, decode_steps=decode_steps,
        launches=launches, attention_routes=attn_routes,
        matmul_routes=mm_routes,
        attention_replay=attn_replay, recorded_run_seconds=recorded_s, logits=logits, prefill_ms=prefill_ms,
        decode_step_ms=step_ms, decode_step_kernels=step_kernels,
        param_count=cfg.param_count())
    return launches


def int_mm_library(x, w, scale, bias, out_dtype):
    """``torch._int_mm`` plus the epilogue as torch ops, as a callable; the
    rows x is zero-padded to (``_int_mm`` needs M > 16, so M <= 16 runs on
    :data:`LIBRARY_PADDED_ROWS` rows and the product is sliced back), or
    None; and the reason why there is no callable for this shape.  An N
    that is not a multiple of 8 (whisper's head, 51865) gets zero columns
    up to the next one, sliced off too (in the callable's time)."""
    import torch
    m, n = x.shape[0], w.shape[1]
    pad = LIBRARY_PADDED_ROWS if m <= 16 else None
    if pad is not None:
        x = torch.cat([x, x.new_zeros((pad - m, x.shape[1]))])
    if n % 8:
        w = torch.cat([w, w.new_zeros((w.shape[0], 8 - n % 8))], dim=1)
    try:
        torch._int_mm(x, w)
    except RuntimeError as exc:
        return None, pad, f"torch._int_mm refused: " \
            f"{str(exc).splitlines()[0]}"
    return (lambda: (torch._int_mm(x, w)[:m, :n].float() * scale + bias)
            .to(out_dtype)), pad, None


def matmul_per_forward(cfg) -> dict:
    """``nmc_matmul`` launches of each (K, N) in one forward of ``cfg``:
    q, k, v, o, up, gate and down once per layer, the LM head once."""
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
                 (d, cfg.n_kv_heads * hd), (cfg.n_heads * hd, d),
                 (d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)]
    counts = {(d, cfg.vocab_size): 1}
    for kn in per_layer:
        counts[kn] = counts.get(kn, 0) + cfg.n_layers
    return counts


def decode_step_kernel_ms(device, params, cfg) -> dict:
    """Device ms per decode step of the model ``params`` / ``cfg`` (from
    :func:`serving_model`) at ``SERVE["n_slots"]`` slots (cache length
    300), by ``torch.profiler`` over :data:`PROFILED_STEPS` steps: every
    kernel's, and ``nmc_matmul``'s (kernels named ``nmc_matmul...``);
    ``None`` where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm
    n = SERVE["n_slots"]
    caches = lm.init_caches(params, cfg, n, SERVE["max_len"],
                            dtype=cfg.dtype)
    toks = torch.zeros((n, 1), dtype=torch.long, device=device)
    clen = torch.full((n,), 300, dtype=torch.int32, device=device)
    lm.decode_step(params, toks, caches, clen, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            lm.decode_step(params, toks, caches, clen, cfg)
        torch.cuda.synchronize()
    total = gemm = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        total += us
        if "nmc_matmul" in ev.key:
            gemm += us
    per = 1e-3 / PROFILED_STEPS
    return {"steps": PROFILED_STEPS,
            "all_kernels_ms": total * per if total else None,
            "nmc_matmul_ms": gemm * per if total else None}


def matmul_kernel_ms(device) -> dict:
    """``{"ms": mean, "median_ms": median}`` of :data:`MATMUL_REPS` calls of
    ``nmc_matmul`` (bf16 out, act none, the L2 evicted before each) at the
    serving path's 12 shapes, keyed ``"MxKxN"``, for whichever
    ``repro_torch`` is imported: with another checkout's ``src`` first on
    ``sys.path``, that checkout's kernel, in the same call.  Uses only what
    every version of the port has."""
    import torch
    from repro_torch.kernels import checks, nmc_matmul as mm
    flush = l2_flush(device)
    out = {}
    for m in checks.MATMUL_M:
        for k, n in checks.MATMUL_KN:
            x, w, scale, bias = checks.matmul_inputs(m, k, n, device)
            mean, median = events_mean_median(
                lambda: mm.nmc_matmul(x, w, scale, bias, act="none",
                                      out_dtype=torch.bfloat16),
                reps=MATMUL_REPS, flush=flush)
            out[f"{m}x{k}x{n}"] = {"ms": mean, "median_ms": median}
            del x, w, scale, bias
    return out


def matmul_host_us(device) -> dict:
    """Host us per ``nmc_matmul`` call (the wrapper's checks, plan and
    allocations and the ctypes launch) at a decode step's shapes (M = 4,
    the four (K, N)), keyed ``"MxKxN"``: :data:`HOST_CALLS` calls on the
    host clock while the device sleeps, so that no call waits on the card;
    for whichever ``repro_torch`` is imported."""
    import torch
    from repro_torch.kernels import checks, nmc_matmul as mm
    out = {}
    for k, n in checks.MATMUL_KN:
        x, w, scale, bias = checks.matmul_inputs(4, k, n, device)
        mm.nmc_matmul(x, w, scale, bias, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda._sleep(HOST_SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            mm.nmc_matmul(x, w, scale, bias, out_dtype=torch.bfloat16)
        out[f"4x{k}x{n}"] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
        del x, w, scale, bias
    return out


def time_attention(case: dict, dtype, device) -> dict:
    """The kernel's and SDPA's ms on one attention at ``case``'s shape and
    masking (:func:`attention_case`, ``checks.ATTENTION_CASES``): ``ms`` /
    ``library_ms`` by events around each call (host work included, as PR
    12 and 13 measured it), ``device_ms`` / ``library_device_ms`` behind
    :func:`host_ahead` (device time alone).  A window that hides no key
    (zamba2's 4096 over 512 tokens) leaves SDPA's causal mask the same
    function; any other window or offset is refused here.  A case that
    asks for the log-sum-exp (``lse``) is timed with it, and the same
    launch without it beside (``no_lse_ms`` / ``no_lse_device_ms``); SDPA
    returns none."""
    import torch.nn.functional as F
    from repro_torch.kernels import checks, flash_attention as fa
    q, k, v = checks.attention_inputs(case, dtype, device)
    gqa = case["hq"] != case["hkv"]
    kw = checks.attention_kw(case)
    full = visible_pairs(case["sq"], case["skv"], kw["causal"])
    if kw["q_offset"] or visible_pairs(case["sq"], case["skv"],
                                       **kw) != full:
        raise ValueError(f"time_attention: SDPA has no window or offset "
                         f"({case})")

    lse = case.get("lse", False)

    def kern(with_lse=lse):
        return fa.flash_attention(q, k, v, **kw, return_lse=with_lse)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v,
                                              is_causal=kw["causal"],
                                              enable_gqa=gqa)
    row = dict(ms=events_ms(kern, ATTENTION_REPS),
               device_ms=events_ms(kern, ATTENTION_REPS, flush=host_ahead),
               library_ms=events_ms(sdpa, ATTENTION_REPS),
               library_device_ms=events_ms(sdpa, ATTENTION_REPS,
                                           flush=host_ahead))
    if lse:
        row.update(lse=True,
                   no_lse_ms=events_ms(lambda: kern(False), ATTENTION_REPS),
                   no_lse_device_ms=events_ms(lambda: kern(False),
                                              ATTENTION_REPS,
                                              flush=host_ahead))
    return row


def attention_case(s: int) -> dict:
    return dict(b=1, hq=16, hkv=16, sq=s, skv=s, d=64, dv=64)


def matmul_models(k: int, n: int) -> list:
    """The served models whose projections include (K, N)."""
    from repro_torch.kernels import checks
    lists = {SERVE_ARCH: checks.MATMUL_KN, MOE_ARCH: checks.MOE_MATMUL_KN,
             MLA_ARCH: checks.MLA_MATMUL_KN, VLM_ARCH: checks.VLM_MATMUL_KN,
             ENCDEC_ARCH: checks.WHISPER_MATMUL_KN,
             HYBRID_ARCH: checks.HYBRID_MATMUL_KN,
             XLSTM_ARCH: checks.XLSTM_MATMUL_KN}
    return [arch for arch, kn in lists.items() if (k, n) in kn]


def phase_lm_timing(report: dict, device) -> dict:
    """ms per launch of both LM kernels at every served model's shapes,
    beside the plain version, the bound and one PyTorch library call."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import checks, flash_attention as fa, \
        nmc_matmul as mm, ref
    flush = l2_flush(device)
    per_forward = matmul_per_forward(configs.get(SERVE_ARCH))
    rows = []
    for m, k, n in checks.serving_matmul_shapes():
        x, w, scale, bias = checks.matmul_inputs(m, k, n, device)
        kw = dict(act="none", out_dtype=torch.bfloat16)
        ms, median = events_mean_median(
            lambda: mm.nmc_matmul(x, w, scale, bias, **kw),
            reps=MATMUL_REPS, flush=flush)
        plain = events_ms(lambda: ref.nmc_matmul(x, w, scale, bias, **kw),
                          reps=2, flush=flush)
        lib_fn, pad, why = int_mm_library(x, w, scale, bias, torch.bfloat16)
        lib, lib_median = (None, None) if lib_fn is None else \
            events_mean_median(lib_fn, reps=MATMUL_REPS, flush=flush)
        bms, by = matmul_bound_ms(m, k, n, 2)
        plan = mm.plan(m, n, k, mm.sm_count(device.index)) \
            if mm.route(k, n) == "tensor_core" else None
        models = matmul_models(k, n)
        rows.append(dict(kernel="nmc_matmul", shape=[m, k, n],
                         models=models, kernel_route=mm.route(k, n),
                         plan=plan, ms=ms, median_ms=median, plain_ms=plain,
                         library_ms=lib, library_median_ms=lib_median,
                         library_padded_rows=pad, library_null_reason=why,
                         bound_ms=bms, bound_by=by,
                         launches_per_forward=per_forward.get((k, n))))
        lib_txt = f"{lib:.4f} ms" if lib is not None else f"null ({why})"
        if pad is not None:
            lib_txt += f" (x padded to {pad} rows)"
        log(f"timing: nmc_matmul M={m} K={k} N={n} bf16 ({', '.join(models)}"
            f"; {mm.route(k, n)} route, plan {plan}): kernel {ms:.4f} ms "
            f"(median {median:.4f}), "
            f"plain {plain:.3f} ms, library {lib_txt}, bound {bms:.4f} ms "
            f"({by})")
        del x, w, scale, bias, lib_fn
    # beside qwen's: deepseek's MLA prefill (D 192, Dv 128: the CUDA-core
    # route in bf16) at two prompt lengths, pixtral's (GQA 32/8), whisper's
    # encoder and cross-attention (non-causal, Skv 1500; Sq 64 and 1) and
    # zamba2's shared block (D 80, window 4096)
    mla = checks.ATTENTION_CASES["deepseek-mla-256"]
    cases = [(attention_case(s), dtype_name)
             for s, dtype_name in ATTENTION_SHAPES] + \
        [(c, "bfloat16") for c in (mla, dict(mla, sq=512, skv=512),
                                   checks.ATTENTION_CASES["pixtral-1152"])] \
        + [(checks.ATTENTION_CASES[name], "bfloat16")
           for name in ATTENTION_NEW_CASES]
    for case, dtype_name in cases:
        dtype = getattr(torch, dtype_name)
        s, kw = case["sq"], checks.attention_kw(case)
        row = time_attention(case, dtype, device)
        kind = fa.route(dtype, case["d"], case["dv"])
        q, k, v = checks.attention_inputs(case, dtype, device)
        plain = events_ms(lambda: fa.chunked_attention(
            q, k, v, **kw, return_lse=case.get("lse", False)), reps=3)
        bound = attention_bound_ms(case["b"], case["hq"], case["hkv"], s,
                                   case["d"], case["dv"], dtype.itemsize,
                                   skv=case["skv"], **kw,
                                   lse=case.get("lse", False))
        rows.append(dict(kernel="flash_attention",
                         shape=[case["b"], case["hq"], s, case["d"]],
                         skv=case["skv"], heads=[case["hq"], case["hkv"]],
                         dv=case["dv"], dtype=str(dtype), kernel_route=kind,
                         **kw, **row, plain_ms=plain, **bound))
        mask = ("causal" if kw["causal"] else "non-causal") + \
            (f", window {kw['window']}" if kw["window"] else "") + \
            (f", with lse (without: {row['no_lse_device_ms']:.5f} ms "
             f"device / {row['no_lse_ms']:.4f} ms events)"
             if row.get("lse") else "")
        log(f"timing: flash_attention B={case['b']} H={case['hq']}/"
            f"{case['hkv']} Sq={s} Skv={case['skv']} D={case['d']} "
            f"Dv={case['dv']} {dtype} {mask} ({kind} route): "
            f"kernel {row['device_ms']:.5f} ms device / {row['ms']:.4f} ms "
            f"events, plain {plain:.3f} ms, SDPA "
            f"{row['library_device_ms']:.5f} ms device / "
            f"{row['library_ms']:.4f} ms events, bound "
            f"{bound['bound_ms']:.5f} ms ({bound['bound_by']}; "
            f"{bound['bound_f32_ms']:.5f} ms at the f32 peak)")
        del q, k, v
    report["lm_timing"] = rows
    return {"nmc_matmul": next(r for r in rows if r["kernel"] == "nmc_matmul"
                               and r["shape"] == list(ROW_MATMUL)),
            "flash_attention": next(r for r in rows
                                    if r["kernel"] == "flash_attention"
                                    and r["shape"] == [1, 16, ROW_ATTENTION,
                                                       64]
                                    and r["dtype"] == str(torch.bfloat16))}


# ---------------------------------------------------------------------------
# the MoE family (moonshot-v1-16b-a3b; deepseek-v2-lite-16b with MLA) and the
# VLM (pixtral-12b) at full width
# ---------------------------------------------------------------------------

MOE_ARCH = "moonshot-v1-16b-a3b"
MLA_ARCH = "deepseek-v2-lite-16b"
VLM_ARCH = "pixtral-12b"
#: the recorded run replays through the plain version the first
#: ``nmc_matmul`` launch of each (M, K, N) and every this-many-th launch
MOE_REPLAY_STRIDE = 211
MOE_DECODE_REPS = 10
#: moonshot's own 1-ulp spread reaches compare_logits' fixed limits (bf16:
#: RMS 0.252 of the logit scale, top-1 agreement 0.501), so its limits are
#: this factor times that spread: bf16 RMS ~0.5 and agreement ~0.25, still
#: far from a wrong kernel's ~1.4 and ~0
MOE_LOGITS_SPREAD = 2.0
#: the VLM phase: rows of ``n_img_tokens`` image embeddings (normal(0, 1)
#: from the seed) and this many text tokens, prefilled into caches of
#: ``max_len`` and decoded greedily for ``steps`` steps
VLM = dict(rows=4, text=128, max_len=1280, steps=16)
VLM_REPLAY_STRIDE = 97
VLM_DECODE_REPS = 10
#: the encoder-decoder phase: rows of ``frames`` frame embeddings (normal(0,
#: 1) from the seed) and ``text``-token prompts, prefilled into caches of
#: ``max_len`` and decoded greedily for ``steps`` steps
ENCDEC_ARCH = "whisper-tiny"
ENCDEC = dict(rows=4, frames=1500, text=64, max_len=128, steps=32)
ENCDEC_REPLAY_STRIDE = 31
#: the hybrid SSM and the prompt lengths it is served on: those of
#: ``SERVE``'s 64-512 range that the reference can prefill (at most one
#: 128-token chunk, or a whole number of them)
HYBRID_ARCH = "zamba2-2.7b"
HYBRID_PROMPT_LENGTHS = (64, 128, 256, 384, 512)
#: the xLSTM, served on :data:`HYBRID_PROMPT_LENGTHS` too: its mLSTM blocks
#: prefill in chunks of 128 and, as the reference, fail on any other
#: length past one chunk
XLSTM_ARCH = "xlstm-125m"


#: the serving phases' depth cuts (layers; every width kept), so that the
#: whole run stays inside its time limit with the scale-out phase
#: (``PERF.md`` §4): moonshot 8 of 48 layers, pixtral 10 of 40, zamba2 18
#: of 54 (3 of 9 groups), xlstm 6 of 12 blocks (sLSTM at 3)
SERVE_DEPTH = {"moonshot-v1-16b-a3b": 8, "pixtral-12b": 10,
               "zamba2-2.7b": 18, "xlstm-125m": 6}


def block_by_block_model(arch: str, device, seed: int = 0) -> tuple:
    """``(cfg, params, build s)``: ``arch`` in W8A8 at full width (cut in
    depth by :data:`SERVE_DEPTH`), random weights from ``seed``.  A float32 model of this size does not fit the
    card (moonshot's is ~110 GB), so each block is quantized as soon as it
    is drawn (``lm.draw_blocks`` with ``quantize_tree``, in
    ``init_params``'s generator order: equal to
    ``quantize_params(init_params(...))`` bit for bit,
    ``tests/test_torch_moe.py``, ``test_torch_mla.py``,
    ``test_torch_vlm.py``)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    cfg = configs.get(arch).scaled(nmc_mode="w8a8")
    if arch in SERVE_DEPTH:
        cfg = cfg.scaled(n_layers=SERVE_DEPTH[arch])
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.draw_blocks(cfg, gen, device, L.quantize_tree)
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def matmul_kn_per_call(cfg, prefill: bool, row_parallel: bool = False,
                       model: int = 1) -> dict:
    """``{(K, N): launches}`` of ``nmc_matmul`` in one prefill or decode
    step of ``cfg`` in W8A8: per layer the attention's projections (GQA
    q/k/v/o, a cross-attention's q and o only, its k and v being the
    encoder output's in w8 form; MLA's wq, w_dkv, w_krope and wo, and at
    prefill w_uk and w_uv, which its absorbed decode reads as float
    weights) and the FFN's (a gated MLP's three, a gelu MLP's two, a MoE
    layer's shared experts' three; the router and the routed experts are
    plain); a hybrid's shared block once per group (its Mamba2 projections
    stay float); an encoder-decoder's encoder at prefill only; nothing of
    an xLSTM's blocks (they stay float); the LM head; at a VLM's prefill
    ``img_proj``.  ``model``: a ``model`` axis of that size lays each
    linear out by the rule, a column-parallel one's (K, N / model) and a
    row-parallel one's (K / model, N) where ``model`` divides that width
    (GQA's ``wk`` / ``wv`` only where it divides the KV heads), whole
    otherwise.  ``row_parallel``: only the linears it lays out
    row-parallel (an attention's ``wo``, an FFN's ``down``), whose
    launches there return the int32 accumulator."""
    import collections
    d, hd, h = cfg.d_model, cfg.head_dim, cfg.n_heads
    kn = collections.Counter()

    def add(k_n, n: int, kind: str | None = None, split: bool = True):
        k, m = k_n
        split = split and model > 1 and (
            (kind == "col" and m % model == 0)
            or (kind == "row" and k % model == 0))
        if split:
            k_n = (k // model, m) if kind == "row" else (k, m // model)
        if not row_parallel or (kind == "row" and split):
            kn[k_n] += n

    def gqa(n: int, cross: bool = False):
        add((d, h * hd), n, "col")
        if not cross:
            add((d, cfg.n_kv_heads * hd), 2 * n, "col",
                cfg.n_kv_heads % model == 0)
        add((h * hd, d), n, "row")

    def mla(n: int):
        r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim,
                         cfg.qk_rope_dim, cfg.v_head_dim)
        add((d, h * (dn + dr)), n, "col")
        for k_n in ((d, r), (d, dr)):
            add(k_n, n)
        add((h * dv, d), n, "row")
        if prefill:
            add((r, h * dn), n, "col")
            add((r, h * dv), n, "col")

    def mlp(n: int, f: int, gated: bool = cfg.act == "silu"):
        add((d, f), 2 * n if gated else n, "col")
        add((f, d), n, "row")
    fam, n_layers = cfg.family, cfg.n_layers
    if fam == "xlstm":
        pass
    elif fam == "hybrid":
        groups = n_layers // cfg.attn_every
        gqa(groups)
        mlp(groups, cfg.d_ff)
    elif fam == "encdec":
        if prefill:
            gqa(cfg.n_enc_layers)
            mlp(cfg.n_enc_layers, cfg.d_ff, gated=False)
        gqa(n_layers)
        gqa(n_layers, cross=True)
        mlp(n_layers, cfg.d_ff, gated=False)
    else:
        (mla if cfg.mla else gqa)(n_layers)
        n_dense = cfg.first_dense_layers if fam == "moe" else 0
        mlp(n_dense, cfg.dense_d_ff or cfg.d_ff)
        if fam != "moe":
            mlp(n_layers, cfg.d_ff)
        elif cfg.n_shared_experts:
            mlp(n_layers - n_dense, cfg.moe_d_ff * cfg.n_shared_experts,
                gated=True)
    add((d, cfg.vocab_size), 1, "col")
    if prefill and fam == "vlm":
        add((d, d), 1)
    return {k_n: c for k_n, c in kn.items() if c}


def matmuls_per_call(cfg, prefill: bool) -> int:
    """``nmc_matmul`` launches of one prefill or decode step of ``cfg`` in
    W8A8 (:func:`matmul_kn_per_call`)."""
    return sum(matmul_kn_per_call(cfg, prefill).values())


def matmul_routes_per_call(cfg, prefill: bool, model: int = 1) -> dict:
    """:func:`matmul_kn_per_call` (on a ``model`` axis of that size) by
    the route ``nmc_matmul.route`` gives each (K, N)."""
    from repro_torch.kernels import nmc_matmul as mm
    out = dict.fromkeys(mm.ROUTE_ID, 0)
    for (k, n), c in matmul_kn_per_call(cfg, prefill, model=model).items():
        out[mm.route(k, n)] += c
    return out


def attention_launches_per_call(cfg, prefill: bool) -> int:
    """``flash_attention`` launches of one prefill or decode step: one per
    attention layer at prefill (a hybrid's shared block once per group; an
    encoder-decoder's encoder, decoder self- and cross-attention), none at
    decode (the one-token attention is plain) but an encoder-decoder's
    cross-attention, one per decoder layer; none ever in an xLSTM."""
    if cfg.family == "xlstm":
        return 0
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers if prefill \
            else cfg.n_layers
    if not prefill:
        return 0
    return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" \
        else cfg.n_layers


def attention_head_dims(cfg) -> tuple:
    """(D, Dv) of ``cfg``'s prefill attention."""
    if cfg.mla:
        return cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    return cfg.head_dim, cfg.head_dim


def sampled_matmuls(stride: int):
    """A ``keep`` for :func:`recorded_lm_kernel_calls`: every attention
    launch, the first ``nmc_matmul`` launch of each (M, K, N) and every
    ``stride``-th one."""
    seen, count = set(), [0]

    def keep(name, args):
        if name != "nmc_matmul":
            return True
        count[0] += 1
        shape = (args[0].shape[0],) + tuple(args[1].shape)
        first = shape not in seen
        seen.add(shape)
        return first or count[0] % stride == 0
    return keep


@contextlib.contextmanager
def counted_moe_drops():
    """``[(tokens, assignments dropped)]`` of every MoE call inside the
    block, in call order, read from the routing each call used
    (``moe.route`` wrapped)."""
    from repro_torch.models import moe as MOE
    calls, orig = [], MOE.route

    def route(x, wr, cfg):
        r = orig(x, wr, cfg)
        calls.append((x.shape[0], (~r.keep).sum()))
        return r
    MOE.route = route
    try:
        yield calls
    finally:
        MOE.route = orig


def profiled_split(fn, calls: int) -> tuple:
    """``calls`` runs of ``fn`` under ``torch.profiler``: ``({label: device
    ms per call}, {label: host ms per call})``.  Device ms: every kernel's,
    ``nmc_matmul``'s and ``flash_attention``'s (by kernel name), and the
    kernels inside ``record_function`` ranges around the MoE layers'
    dequantize of the int8 banks (``MoE.expert_weights``) and expert
    ``bmm`` s (``moe.expert_ffn``), MLA's absorbed-decode einsums
    (``MLAttention.absorbed_attention``), the Mamba2 layers' float
    projections (``Mamba2._proj``: the weights cast to the activation
    dtype and the matmuls), conv and SSD update
    (``Mamba2.recurrent_step``) and gated norm with the float ``out_proj``
    (``Mamba2._gated_out``), the xLSTM blocks' float projections with
    their norms and gates (``MLSTM._proj`` / ``_out``, ``SLSTM._proj`` /
    ``_ffn``: each weight cast to the activation dtype, then the matmul),
    the mLSTM step (``xlstm.mlstm_step``; at prefill ``mlstm_chunked``),
    the sLSTM time loop (``SLSTM.recurrence``) and the final norm with the
    LM head (``LMBase.logits``); ``None`` where the profiler saw no device
    time.  Host ms: each range's, and the whole call's (``call``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import attention as A
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE
    from repro_torch.models import ssm as SSM
    from repro_torch.models import xlstm as XL
    ranges = {"moe.dequantize": ((MOE.MoE, "expert_weights"),),
              "moe.expert_bmm": ((MOE, "expert_ffn"),),
              "mla.absorbed": ((A.MLAttention, "absorbed_attention"),),
              "mamba.proj": ((SSM.Mamba2, "_proj"),),
              "mamba.recurrent": ((SSM.Mamba2, "recurrent_step"),),
              "mamba.gated_out": ((SSM.Mamba2, "_gated_out"),),
              "xlstm.float_proj": ((XL.MLSTM, "_proj"), (XL.MLSTM, "_out"),
                                   (XL.SLSTM, "_proj"), (XL.SLSTM, "_ffn")),
              "xlstm.mlstm": ((XL, "mlstm_step"), (XL, "mlstm_chunked")),
              "xlstm.slstm": ((XL.SLSTM, "recurrence"),),
              "lm.head": ((lm.LMBase, "logits"),)}
    origs = {(owner, attr): getattr(owner, attr)
             for pairs in ranges.values() for owner, attr in pairs}

    def labelled(fn, label):
        def wrapper(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return wrapper
    for label, pairs in ranges.items():
        for owner, attr in pairs:
            setattr(owner, attr, labelled(origs[(owner, attr)], label))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                with record_function("call"):
                    fn()
                torch.cuda.synchronize()
    finally:
        for (owner, attr), orig in origs.items():
            setattr(owner, attr, orig)
    us = dict.fromkeys(("all_kernels", "nmc_matmul", "flash_attention",
                        *ranges), 0.0)
    host = dict.fromkeys(("call", *ranges), 0.0)
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name in host:
            host[ev.name] += ev.cpu_time_total
            if ev.name in ranges:
                us[ev.name] += ev.device_time_total
        elif ev.device_type == DeviceType.CUDA and \
                not getattr(ev, "is_user_annotation", False):
            us["all_kernels"] += ev.self_device_time_total
            for kname in ("nmc_matmul", "flash_attention"):
                if kname in ev.name:
                    us[kname] += ev.self_device_time_total
    per = 1e-3 / calls
    device = {f"{k.replace('.', '_')}_ms": (v * per if us["all_kernels"]
                                            else None) for k, v in us.items()}
    return device, {f"{k.replace('.', '_')}_ms": v * per
                    for k, v in host.items()}


def decode_split(device, params, cfg, rows: int, cache_len: int,
                 max_len: int) -> dict:
    """Device ms per decode step at ``rows`` rows (cache length
    ``cache_len``), by ``torch.profiler`` over :data:`PROFILED_STEPS`
    steps, split as :func:`profiled_split` splits it."""
    import torch
    from repro_torch.models import lm
    caches = lm.init_caches(params, cfg, rows, max_len, dtype=cfg.dtype)
    toks = torch.zeros((rows, 1), dtype=torch.long, device=device)
    clen = torch.full((rows,), cache_len, dtype=torch.int32, device=device)
    lm.decode_step(params, toks, caches, clen, cfg)
    torch.cuda.synchronize()
    out, _ = profiled_split(
        lambda: lm.decode_step(params, toks, caches, clen, cfg),
        PROFILED_STEPS)
    out["steps"] = PROFILED_STEPS
    return out


def prefill_split(params, cfg, toks: dict, max_len: int) -> dict:
    """One prefill of ``toks`` split as :func:`profiled_split` splits it:
    device ms by range, and host ms by range beside the prefill's own
    (``host_call_ms``), so that ``host_xlstm_slstm_ms / host_call_ms`` is
    the sLSTM time loop's share of the prefill."""
    from repro_torch.models import lm
    device, host = profiled_split(
        lambda: lm.prefill(params, toks, cfg, max_len), 1)
    return {**device, **{f"host_{k}": v for k, v in host.items()}}


def check_lm_launches(name: str, cfg, launches: dict, attn_routes: dict,
                      mm_routes: dict, prefills: int,
                      decode_steps: int) -> None:
    """The main path's launches: ``nmc_matmul`` exactly
    :func:`matmuls_per_call` per prefill and decode step, each (K, N) on
    the route ``nmc_matmul.route`` gives it (:func:`matmul_routes_per_call`:
    every served projection on the tensor cores but whisper's LM head,
    N = 51865, on ``dp4a``); :func:`attention_launches_per_call` of
    ``flash_attention``, all on the route ``flash_attention.route`` gives
    ``cfg``'s head dims in bf16."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    want_mm = prefills * matmuls_per_call(cfg, True) + \
        decode_steps * matmuls_per_call(cfg, False)
    want_routes = {r: prefills * c + decode_steps * d
                   for (r, c), d in zip(
                       matmul_routes_per_call(cfg, True).items(),
                       matmul_routes_per_call(cfg, False).values())}
    want_attn = prefills * attention_launches_per_call(cfg, True) + \
        decode_steps * attention_launches_per_call(cfg, False)
    if launches["nmc_matmul"] != want_mm:
        raise AssertionError(f"{name}: nmc_matmul launched "
                             f"{launches['nmc_matmul']} != {want_mm}")
    if launches["flash_attention"] != want_attn:
        raise AssertionError(f"{name}: flash_attention launched "
                             f"{launches['flash_attention']} != "
                             f"{want_attn}")
    kind = fa.route(torch.bfloat16, *attention_head_dims(cfg))
    if attn_routes[kind] != launches["flash_attention"] or \
            mm_routes != want_routes:
        raise AssertionError(f"{name}: a launch off its route (attention "
                             f"{kind}, nmc_matmul {want_routes}): "
                             f"{attn_routes} {mm_routes}")


def phase_moe_serving(report: dict, device, seed: int = 0) -> dict:
    """moonshot-v1-16b-a3b served at full width (:func:`serve_full_width`)."""
    return serve_full_width(report, "moe_serving", MOE_ARCH, device, seed)


def phase_mla_serving(report: dict, device, seed: int = 0) -> dict:
    """deepseek-v2-lite-16b (MLA attention, one dense layer, 26 MoE
    layers) served at full width (:func:`serve_full_width`): its prefill
    attention on ``flash_attention``'s CUDA-core route (D 192, Dv 128),
    its decode attention absorbed into float32 einsums."""
    return serve_full_width(report, "mla_serving", MLA_ARCH, device, seed)


def phase_hybrid_serving(report: dict, device, seed: int = 0) -> dict:
    """zamba2-2.7b served at full width (:func:`serve_full_width`): 30 of
    its 54 Mamba2 layers (d_inner 5120, 80 SSM heads of 64, state 64) in 5
    of its 9 groups, each followed by the one shared block (32 heads of 80, window
    4096, d_ff 10240) with its own KV cache per group; vocab 32000.  The
    prompt lengths are drawn from :data:`HYBRID_PROMPT_LENGTHS`: the
    reference reshapes a prompt longer than its 128-token chunk into whole
    chunks and fails on any other length, so these are the lengths of
    ``SERVE``'s 64-512 range that it can prefill.  The Mamba2 projections
    stay float (the reference's ``quantize_tree`` leaves its 4-D stack so):
    36 ``nmc_matmul`` launches per prefill and per decode step (5 x 7 + the
    head), 5 ``flash_attention`` launches per prefill, none at decode."""
    return serve_full_width(report, "hybrid_serving", HYBRID_ARCH, device,
                            seed, HYBRID_PROMPT_LENGTHS)


def phase_xlstm_serving(report: dict, device, seed: int = 0) -> dict:
    """xlstm-125m served at full width (:func:`serve_full_width`): 6 of its
    12 blocks, sLSTM at 3 and mLSTM elsewhere (inner width 1536, 4
    heads of 384, chunk 128), d_model 768, vocab 50304.  The prompt
    lengths are drawn from :data:`HYBRID_PROMPT_LENGTHS`, the lengths of
    ``SERVE``'s 64-512 range that the reference can prefill (a prompt
    longer than one 128-token chunk must be a whole number of them).  The
    blocks stay float (the reference's ``quantize_tree`` leaves its list
    of blocks so), so the LM head (768, 50304) is the only ``nmc_matmul``:
    one launch per prefill and per decode step, on the tensor cores, each
    replayed through the plain version; no ``flash_attention``."""
    return serve_full_width(report, "xlstm_serving", XLSTM_ARCH, device,
                            seed, HYBRID_PROMPT_LENGTHS, replay_stride=1)


def serve_full_width(report: dict, key: str, arch: str, device,
                     seed: int = 0, prompt_lengths=None,
                     replay_stride: int = MOE_REPLAY_STRIDE) -> dict:
    """The port's W8A8 serving path for a model at full width (the depth
    of :data:`SERVE_DEPTH`):
    built block by block from a seeded generator, served by ServeEngine on
    the :data:`SERVE` traffic (prompt lengths out of ``prompt_lengths``
    when given).  The LM kernels' launch counts are set to 0 just before
    the run and read just after (:func:`check_lm_launches`).  Then the
    same run once more, recording every attention launch and a sample of
    the ``nmc_matmul`` ones (the first of each shape and every
    ``replay_stride``-th), each replayed through its plain version, and,
    for a MoE model, the assignments each MoE call drops; one prompt's
    logits against the plain versions (the spread rule: always for a MoE
    model, else if the model's own 1-ulp spread reaches the fixed limits);
    prefill and decode ms; the decode step's device split (and for an
    xLSTM each prefill's, :func:`prefill_split`)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import nmc_matmul as mm
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine
    smi = report["nvidia_smi"]
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, build_s = block_by_block_model(arch, device, seed)
    moe = cfg.family == "moe"
    resident_gib = torch.cuda.memory_allocated() / 2 ** 30
    d, dv = attention_head_dims(cfg)
    if moe:
        shape = (f"{cfg.n_layers} layers, {cfg.first_dense_layers} dense, "
                 f"d_model {cfg.d_model}, {cfg.n_heads} heads, attention D "
                 f"{d} Dv {dv}"
                 f"{f' (MLA, kv_lora_rank {cfg.kv_lora_rank})' if cfg.mla else ''}"
                 f", {cfg.n_experts} experts top-{cfg.top_k} + "
                 f"{cfg.n_shared_experts} shared, moe_d_ff {cfg.moe_d_ff}")
    elif cfg.family == "xlstm":
        shape = (f"{cfg.n_layers} blocks, sLSTM at {cfg.slstm_layers}, "
                 f"d_model {cfg.d_model}, {cfg.n_heads} heads, mLSTM inner "
                 f"{int(cfg.d_model * cfg.proj_factor_mlstm)}, chunk "
                 f"{cfg.ssm_chunk}")
    else:
        shape = (f"{cfg.n_layers} Mamba2 layers in "
                 f"{cfg.n_layers // cfg.attn_every} groups, d_model "
                 f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_heads} SSM "
                 f"heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, "
                 f"chunk {cfg.ssm_chunk}; shared block {cfg.n_heads} heads "
                 f"of {cfg.head_dim}, window {cfg.window}, d_ff {cfg.d_ff}")
    log(f"{key}: {arch} w8a8 at full width ({shape}, vocab "
        f"{cfg.vocab_size}) built block by block in {build_s:.3f} s, "
        f"{resident_gib:.2f} GiB on the card [{smi}]")
    rng = np.random.default_rng(seed)
    lengths, prompts = serving_prompts(cfg, rng, prompt_lengths)

    def engine():
        eng = ServeEngine(cfg, params, n_slots=SERVE["n_slots"],
                          max_len=SERVE["max_len"], device=device)
        for i, pr in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=pr, max_new=SERVE["max_new"]))
        return eng
    eng = engine()
    calls0 = eng.nmc_queue.calls
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    attn_routes = dict(fa.flash_attention.launches_by_route)
    mm_routes = dict(mm.nmc_matmul.launches_by_route)
    prefills = len(prompts)
    decode_steps = eng.nmc_queue.calls - calls0 - prefills
    del eng
    log(f"{key}: {len(done)} requests, prompts "
        f"{sorted(int(n) for n in lengths)}, {prefills} prefills + "
        f"{decode_steps} decode steps in {serve_s:.3f} s [{smi}]; launches "
        f"{launches}; nmc_matmul by route {mm_routes}, flash_attention by "
        f"route {attn_routes}")
    if len(done) != len(prompts) or any(len(r.out) != SERVE["max_new"]
                                        for r in done):
        raise AssertionError("a request did not return max_new tokens")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.out):
        raise AssertionError("a token outside the vocabulary")
    check_lm_launches(key, cfg, launches, attn_routes, mm_routes, prefills,
                      decode_steps)

    # the same run once more, recording every attention launch and a
    # sample of the nmc_matmul ones (each replayed through the plain
    # version on its own inputs) and the assignments each MoE call drops;
    # not counted, not timed
    eng = engine()
    with recorded_lm_kernel_calls(keep=sampled_matmuls(replay_stride)) \
            as calls, counted_moe_drops() as drops:
        again = eng.run()
        torch.cuda.synchronize()
    if [r.out for r in again] != [r.out for r in done]:
        raise AssertionError("the recorded run served other tokens")
    replay = replay_against_plain(calls)
    del calls, eng
    want_attn = prefills * attention_launches_per_call(cfg, True)
    if replay["launches"]["flash_attention"] != want_attn:
        raise AssertionError(f"the recorded run launched attention "
                             f"{replay['launches']} times")
    log(f"{key}: replayed {replay['launches']} launches through the "
        f"plain versions, max abs err {replay['max_abs_err']} (attention "
        f"by route {replay['attention_by_route']})")
    drops_report = {}
    if moe:
        n_moe = len(params.layers)
        decode = [int(d) for t, d in drops if t == SERVE["n_slots"]]
        per_step = [sum(decode[i:i + n_moe])
                    for i in range(0, len(decode), n_moe)]
        prefill_drops = [int(d) for t, d in drops if t != SERVE["n_slots"]]
        if len(per_step) != decode_steps or \
                len(prefill_drops) != n_moe * prefills:
            raise AssertionError(f"MoE calls: {len(decode)} at decode, "
                                 f"{len(prefill_drops)} at prefill")
        per_prefill = [sum(prefill_drops[i:i + n_moe])
                       for i in range(0, len(prefill_drops), n_moe)]
        assignments = SERVE["n_slots"] * cfg.top_k * n_moe
        log(f"{key}: assignments dropped per decode step (of "
            f"{assignments}, capacity 1 per expert per layer): mean "
            f"{np.mean(per_step):.2f}, min {min(per_step)}, max "
            f"{max(per_step)}; per prefill (all layers): {per_prefill}")
        drops_report = dict(dropped_per_decode_step=per_step,
                            dropped_per_prefill=per_prefill,
                            assignments_per_decode_step=assignments)
    elif drops:
        raise AssertionError(f"{key}: {len(drops)} MoE calls")

    logits = compare_logits(
        params, cfg, {"tokens": torch.as_tensor(prompts[0][None],
                                                device=device)}, device,
        spread_factor=MOE_LOGITS_SPREAD, spread_if_reached=not moe)

    prefill_ms, prefill_splits = {}, {}
    for n in PREFILL_LENGTHS:
        toks = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, n)), device=device)}
        prefill_ms[n] = events_ms(
            lambda: lm.prefill(params, toks, cfg, SERVE["max_len"]), reps=3)
        if cfg.family == "xlstm":
            prefill_splits[n] = prefill_split(params, cfg, toks,
                                              SERVE["max_len"])
    if prefill_splits:
        log(f"{key}: prefill split by length (device ms by range, host ms "
            f"by range and of the whole prefill, under the profiler; "
            f"ranges it did not enter left out): "
            f"{ {n: {k: round(v, 4) for k, v in d.items() if v} for n, d in prefill_splits.items()} }")
    caches = lm.init_caches(params, cfg, SERVE["n_slots"], SERVE["max_len"],
                            dtype=cfg.dtype)
    step_toks = torch.zeros((SERVE["n_slots"], 1), dtype=torch.long,
                            device=device)
    clen = torch.full((SERVE["n_slots"],), 300, dtype=torch.int32,
                      device=device)
    step_ms = events_ms(
        lambda: lm.decode_step(params, step_toks, caches, clen, cfg),
        reps=MOE_DECODE_REPS)
    del caches
    split = decode_split(device, params, cfg, SERVE["n_slots"], 300,
                         SERVE["max_len"])
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    phase_s = time.perf_counter() - t_phase
    log(f"{key}: prefill ms by prompt length "
        f"{ {n: round(v, 3) for n, v in prefill_ms.items()} }; decode step "
        f"{step_ms:.3f} ms at {SERVE['n_slots']} slots; device time per "
        f"decode step: {split}; peak {peak_gib:.2f} GiB; phase "
        f"{phase_s:.1f} s [{smi}]")
    report[key] = dict(
        arch=arch, n_layers=cfg.n_layers, **SERVE,
        prompt_lengths=[int(n) for n in lengths], build_s=build_s,
        resident_gib=resident_gib, peak_gib=peak_gib, seconds=serve_s,
        prefills=prefills, decode_steps=decode_steps, launches=launches,
        attention_routes=attn_routes, matmul_routes=mm_routes,
        replay=replay, **drops_report, logits=logits,
        prefill_ms=prefill_ms, prefill_split=prefill_splits,
        decode_step_ms=step_ms,
        decode_step_split=split, param_count=cfg.param_count(),
        phase_s=phase_s, nvidia_smi=smi)
    del params
    torch.cuda.empty_cache()
    return launches


def vlm_batch(cfg, rng, rows: int, device) -> dict:
    """``rows`` prompts of ``cfg.n_img_tokens`` image embeddings (normal(0,
    1), as the reference's model tests make them) and :data:`VLM` text
    tokens, drawn from ``rng``, on the card."""
    import numpy as np
    import torch
    images = rng.normal(size=(rows, cfg.n_img_tokens, cfg.d_model))
    tokens = rng.integers(0, cfg.vocab_size, (rows, VLM["text"]))
    return {"images": torch.as_tensor(images.astype(np.float32),
                                      device=device),
            "tokens": torch.as_tensor(tokens, device=device)}


def generate(params, cfg, batch, steps: int, max_len: int):
    """Prefill ``batch`` into caches of ``max_len``, then ``steps`` greedy
    decode steps: the (rows, steps + 1) tokens."""
    import torch
    from repro_torch.models import lm
    logits, caches = lm.prefill(params, batch, cfg, max_len)
    n = batch_positions(batch)
    tok = logits.argmax(-1)[:, None]
    out = [tok]
    clen = torch.full((tok.shape[0],), n + 1, dtype=torch.int32,
                      device=tok.device)
    for _ in range(steps):
        logits, caches = lm.decode_step(params, tok, caches, clen, cfg)
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
        clen = clen + 1
    return torch.cat(out, dim=1)


def phase_vlm(report: dict, device, seed: int = 0) -> dict:
    """The port's W8A8 VLM path at pixtral-12b's full width (20 of its 40
    layers, d_model 5120, 32 heads of 128 with kv 8, d_ff 14336, vocab
    131072), built block by block from a seeded generator: ``lm.prefill``
    of :data:`VLM` rows of 1024 image embeddings and 128 text tokens, then
    greedy ``lm.decode_step`` s (the serving engine, like the reference's,
    passes no images).  The LM kernels' launch counts are set to 0 just
    before and read just after (:func:`check_lm_launches`); the same run
    once more records every attention launch and a sample of the
    ``nmc_matmul`` ones, each replayed through its plain version; one
    row's logits against the plain versions (the fixed limits, or the
    spread rule if pixtral's own 1-ulp spread reaches them); prefill and
    decode ms and the decode step's device time."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import nmc_matmul as mm
    from repro_torch.models import lm
    smi = report["nvidia_smi"]
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, build_s = block_by_block_model(VLM_ARCH, device, seed)
    resident_gib = torch.cuda.memory_allocated() / 2 ** 30
    log(f"vlm: {VLM_ARCH} w8a8 at full width ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim} (kv "
        f"{cfg.n_kv_heads}), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.n_img_tokens} image tokens) built block by block in "
        f"{build_s:.3f} s, {resident_gib:.2f} GiB on the card [{smi}]")
    rng = np.random.default_rng(seed)
    batch = vlm_batch(cfg, rng, VLM["rows"], device)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = generate(params, cfg, batch, VLM["steps"], VLM["max_len"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    attn_routes = dict(fa.flash_attention.launches_by_route)
    mm_routes = dict(mm.nmc_matmul.launches_by_route)
    log(f"vlm: {VLM['rows']} rows of {cfg.n_img_tokens} image + "
        f"{VLM['text']} text tokens prefilled and decoded {VLM['steps']} "
        f"steps in {run_s:.3f} s [{smi}]; launches {launches}; nmc_matmul "
        f"by route {mm_routes}, flash_attention by route {attn_routes}")
    if tokens.shape != (VLM["rows"], VLM["steps"] + 1) or \
            not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"vlm: tokens {tuple(tokens.shape)} or out of "
                             f"the vocabulary")
    check_lm_launches("vlm", cfg, launches, attn_routes, mm_routes, 1,
                      VLM["steps"])

    with recorded_lm_kernel_calls(keep=sampled_matmuls(VLM_REPLAY_STRIDE)) \
            as calls:
        again = generate(params, cfg, batch, VLM["steps"], VLM["max_len"])
        torch.cuda.synchronize()
    if not torch.equal(again, tokens):
        raise AssertionError("vlm: the recorded run decoded other tokens")
    replay = replay_against_plain(calls)
    del calls
    if replay["launches"]["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"vlm: the recorded run launched attention "
                             f"{replay['launches']} times")
    log(f"vlm: replayed {replay['launches']} launches through the plain "
        f"versions, max abs err {replay['max_abs_err']} (attention by route "
        f"{replay['attention_by_route']})")

    one = {k: v[:1] for k, v in batch.items()}
    logits = compare_logits(params, cfg, one, device,
                            spread_factor=MOE_LOGITS_SPREAD,
                            spread_if_reached=True)

    prefill_ms = events_ms(
        lambda: lm.prefill(params, batch, cfg, VLM["max_len"]), reps=3)
    rows, n = VLM["rows"], cfg.n_img_tokens + VLM["text"]
    caches = lm.prefill(params, batch, cfg, VLM["max_len"])[1]
    step_toks = torch.zeros((rows, 1), dtype=torch.long, device=device)
    clen = torch.full((rows,), n + 1, dtype=torch.int32, device=device)
    step_ms = events_ms(
        lambda: lm.decode_step(params, step_toks, caches, clen, cfg),
        reps=VLM_DECODE_REPS)
    del caches
    split = decode_split(device, params, cfg, rows, n + 1, VLM["max_len"])
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    phase_s = time.perf_counter() - t_phase
    log(f"vlm: prefill {prefill_ms:.3f} ms ({rows} x {n} tokens); decode "
        f"step {step_ms:.3f} ms at {rows} rows; device time per decode "
        f"step: {split}; peak {peak_gib:.2f} GiB; phase {phase_s:.1f} s "
        f"[{smi}]")
    report["vlm"] = dict(
        arch=VLM_ARCH, n_layers=cfg.n_layers, **VLM,
        n_img_tokens=cfg.n_img_tokens, build_s=build_s,
        resident_gib=resident_gib, peak_gib=peak_gib, seconds=run_s,
        launches=launches, attention_routes=attn_routes,
        matmul_routes=mm_routes, replay=replay, logits=logits,
        tokens=tokens.tolist(), prefill_ms=prefill_ms, decode_step_ms=step_ms,
        decode_step_split=split, param_count=cfg.param_count(),
        phase_s=phase_s, nvidia_smi=smi)
    del params, batch, one
    torch.cuda.empty_cache()
    return launches


def encdec_batch(cfg, rng, device) -> dict:
    """:data:`ENCDEC` rows of frame embeddings (normal(0, 1), as pixtral's
    images) and text tokens, drawn from ``rng``, on the card."""
    import numpy as np
    import torch
    e = ENCDEC
    frames = rng.normal(size=(e["rows"], e["frames"], cfg.d_model))
    tokens = rng.integers(0, cfg.vocab_size, (e["rows"], e["text"]))
    return {"frames": torch.as_tensor(frames.astype(np.float32),
                                      device=device),
            "tokens": torch.as_tensor(tokens, device=device)}


def phase_encdec(report: dict, device, seed: int = 0) -> dict:
    """The port's W8A8 encoder-decoder path at whisper-tiny's full width and
    depth (4 encoder + 4 decoder layers, d_model 384, 6 heads of 64, d_ff
    1536, vocab 51865), built block by block from a seeded generator:
    ``lm.prefill`` of :data:`ENCDEC` rows of 1500 frame embeddings and a
    64-token prompt, then greedy ``lm.decode_step`` s (the serving engine,
    like the reference's, passes no frames).  The LM kernels' launch
    counts are set to 0 just before and read just after
    (:func:`check_lm_launches`): 57 ``nmc_matmul`` per prefill (encoder 4
    x 6, decoder 4 x 8, the head) and 33 per step, the head (N = 51865)
    on ``dp4a`` and the rest on the tensor cores; 12 ``flash_attention``
    per prefill (encoder, decoder self, cross) and 4 per step (cross at
    Sq = 1).  The same run once more records every attention launch and a
    sample of the ``nmc_matmul`` ones, each replayed through its plain
    version; one row's logits against the plain versions (the spread rule
    if whisper's own 1-ulp spread reaches the fixed limits); prefill and
    decode ms and the decode step's device time."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import nmc_matmul as mm
    from repro_torch.models import lm
    smi = report["nvidia_smi"]
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, build_s = block_by_block_model(ENCDEC_ARCH, device, seed)
    resident_gib = torch.cuda.memory_allocated() / 2 ** 30
    e = ENCDEC
    log(f"encdec: {ENCDEC_ARCH} w8a8 at full width ({cfg.n_enc_layers} "
        f"encoder + {cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}) built block by block in {build_s:.3f} s, "
        f"{resident_gib:.2f} GiB on the card [{smi}]")
    rng = np.random.default_rng(seed)
    batch = encdec_batch(cfg, rng, device)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = generate(params, cfg, batch, e["steps"], e["max_len"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    attn_routes = dict(fa.flash_attention.launches_by_route)
    mm_routes = dict(mm.nmc_matmul.launches_by_route)
    log(f"encdec: {e['rows']} rows of {e['frames']} frames + {e['text']} "
        f"text tokens prefilled and decoded {e['steps']} steps in "
        f"{run_s:.3f} s [{smi}]; launches {launches}; nmc_matmul by route "
        f"{mm_routes}, flash_attention by route {attn_routes}")
    if tokens.shape != (e["rows"], e["steps"] + 1) or \
            not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"encdec: tokens {tuple(tokens.shape)} or out "
                             f"of the vocabulary")
    check_lm_launches("encdec", cfg, launches, attn_routes, mm_routes, 1,
                      e["steps"])

    with recorded_lm_kernel_calls(
            keep=sampled_matmuls(ENCDEC_REPLAY_STRIDE)) as calls:
        again = generate(params, cfg, batch, e["steps"], e["max_len"])
        torch.cuda.synchronize()
    if not torch.equal(again, tokens):
        raise AssertionError("encdec: the recorded run decoded other tokens")
    replay = replay_against_plain(calls)
    del calls
    want_attn = attention_launches_per_call(cfg, True) + \
        e["steps"] * attention_launches_per_call(cfg, False)
    if replay["launches"]["flash_attention"] != want_attn:
        raise AssertionError(f"encdec: the recorded run launched attention "
                             f"{replay['launches']} times")
    log(f"encdec: replayed {replay['launches']} launches through the plain "
        f"versions, max abs err {replay['max_abs_err']} (attention by route "
        f"{replay['attention_by_route']})")

    one = {k: v[:1] for k, v in batch.items()}
    logits = compare_logits(params, cfg, one, device,
                            spread_factor=MOE_LOGITS_SPREAD,
                            spread_if_reached=True)

    prefill_ms = events_ms(
        lambda: lm.prefill(params, batch, cfg, e["max_len"]), reps=3)
    rows, n = e["rows"], e["text"]
    caches = lm.prefill(params, batch, cfg, e["max_len"])[1]
    step_toks = torch.zeros((rows, 1), dtype=torch.long, device=device)
    clen = torch.full((rows,), n + 1, dtype=torch.int32, device=device)
    step_ms = events_ms(
        lambda: lm.decode_step(params, step_toks, caches, clen, cfg),
        reps=VLM_DECODE_REPS)
    del caches
    split = decode_split(device, params, cfg, rows, n + 1, e["max_len"])
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    phase_s = time.perf_counter() - t_phase
    log(f"encdec: prefill {prefill_ms:.3f} ms ({rows} x {e['frames']} "
        f"frames + {n} tokens); decode step {step_ms:.3f} ms at {rows} "
        f"rows; device time per decode step: {split}; peak "
        f"{peak_gib:.2f} GiB; phase {phase_s:.1f} s [{smi}]")
    report["encdec"] = dict(
        arch=ENCDEC_ARCH, n_layers=cfg.n_layers,
        n_enc_layers=cfg.n_enc_layers, **e, build_s=build_s,
        resident_gib=resident_gib, peak_gib=peak_gib, seconds=run_s,
        launches=launches, attention_routes=attn_routes,
        matmul_routes=mm_routes, replay=replay, logits=logits,
        tokens=tokens.tolist(), prefill_ms=prefill_ms, decode_step_ms=step_ms,
        decode_step_split=split, param_count=cfg.param_count(),
        phase_s=phase_s, nvidia_smi=smi)
    del params, batch, one
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# vrf_alu, the kernels demo, multi-tile NMC and the resident block
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen1.5-0.5b"
#: the training phase: 8 rows of 512 tokens in 2 microbatches of 4; the
#: trainer's 4 steps with a checkpoint every 2 and a crash injected at
#: step 3 (restored from step 2, which is replayed)
TRAIN = dict(global_batch=8, seq_len=512, n_microbatches=2, total_steps=4,
             ckpt_every=2, fail_at=3)
#: a parameter's gradient through the kernels may differ from the plain
#: path's (relative L2) by this many times the plain path's own difference
#: under 1-ulp input noise, or by TRAIN_GRAD_FLOOR, whichever is larger
TRAIN_GRAD_SPREAD = 2.0
TRAIN_GRAD_FLOOR = 0.05
#: the loss through the kernels against the plain path's (relative)
TRAIN_LOSS_RTOL = 1e-3
#: the replayed step's loss against its first attempt (relative): its
#: forward reads the restored state, a bit-for-bit copy, so only a
#: nondeterministic forward could move it
TRAIN_REPLAY_RTOL = 1e-3
TRAIN_TIMED_STEPS = 3
#: the training phase's activation-checkpointing part: qwen1.5-0.5b at full
#: width and depth, 2 rows of 4096 tokens (the reference's ``train_4k``
#: sequence; its global batch of 256 cut to 2 for one card) in one
#: microbatch, one gradient each with remat off, "full" and "dots"
TRAIN_REMAT = dict(rows=2, seq_len=4096)
TRAIN_REMAT_RUNS = (("off", False, "full"), ("full", True, "full"),
                    ("dots", True, "dots"))
TRAIN_REMAT_TIMED = 3


def attention_backward_bound_ms(b, hq, hkv, sq, d, dv, elem) -> dict:
    """The least time of attention's backward at this shape, causal: q, k,
    v and dO read once, dQ, dK and dV written once; per visible pair the
    products S = Q K^T (2 D), dV = P^T dO and dP = dO V^T (2 Dv each), dQ
    and dK (2 D each), against the bf16 tensor peak."""
    nbytes = elem * (2 * b * hq * sq * (d + dv) + 2 * b * hkv * sq * (d + dv))
    flops = b * hq * visible_pairs(sq, sq) * (6 * d + 4 * dv)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def train_step_split_ms(model, opt_state, batch, cfg, opt_cfg,
                        n_mb: int) -> dict:
    """One train step's forward, backward and optimizer ms by CUDA events
    (summed over the microbatches), the mean of TRAIN_TIMED_STEPS steps
    after the caller's warm-up; the step updates ``model`` in place."""
    import torch
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib
    loss_fn = step_lib.make_loss(cfg)
    params = dict(model.named_parameters())
    totals = {"forward_ms": 0.0, "backward_ms": 0.0, "optimizer_ms": 0.0}

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    for _ in range(TRAIN_TIMED_STEPS):
        g = None
        for mb in step_lib.split_batch(batch, n_mb):
            e0 = event()
            with torch.enable_grad():
                loss, _ = loss_fn(model, mb)
                e1 = event()
                gm = torch.autograd.grad(loss, list(params.values()))
            e2 = event()
            g = list(gm) if g is None else [a + b for a, b in zip(g, gm)]
            torch.cuda.synchronize()
            totals["forward_ms"] += e0.elapsed_time(e1)
            totals["backward_ms"] += e1.elapsed_time(e2)
        grads = {n: x / n_mb for n, x in zip(params, g)}
        e0 = event()
        adamw.apply_updates(params, grads, opt_state, opt_cfg)
        e1 = event()
        torch.cuda.synchronize()
        totals["optimizer_ms"] += e0.elapsed_time(e1)
        del g, grads
    out = {k: v / TRAIN_TIMED_STEPS for k, v in totals.items()}
    out["step_ms"] = sum(out.values())
    return out


def kernel_us(prof) -> dict:
    """Device us of a profile's kernels: every kernel's, the
    ``flash_attention`` launches' (by kernel name) and their count, and
    the kernels inside each ``record_function`` range by its name."""
    from torch.autograd import DeviceType
    us = {"all_kernels": 0.0, "flash_attention": 0.0, "fa_launches": 0}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU:
            if ev.name.startswith("train."):
                us[ev.name] = us.get(ev.name, 0.0) + ev.device_time_total
        elif not getattr(ev, "is_user_annotation", False):
            us["all_kernels"] += ev.self_device_time_total
            if "flash_attention" in ev.name:
                us["flash_attention"] += ev.self_device_time_total
                us["fa_launches"] += 1
    return us


def profiled_device_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``: its kernels' time under
    ``torch.profiler`` over ``reps`` calls after a warm-up (host time
    between the launches left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return kernel_us(prof)["all_kernels"] * 1e-3 / reps


def profiled_train_step(model, opt_state, batch, cfg, opt_cfg,
                        n_mb: int) -> dict:
    """One train step under ``torch.profiler``: device ms of every kernel;
    of the forward (range ``train.gradient``: the kernels the calling
    thread launches there, the forwards and the gradients' accumulation),
    of the backward (the rest of the step: autograd launches it from its
    own device thread, outside the calling thread's ranges) and of the
    update (range ``train.optimizer``); of the ``flash_attention``
    launches (by kernel name) and of the backward's attention recomputes
    (range ``train.attention_backward`` around ``flash_attention
    .attention_backward``, entered on autograd's thread); None where the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib
    orig = fa.attention_backward

    def labelled(*args, **kw):
        with record_function("train.attention_backward"):
            return orig(*args, **kw)
    fa.attention_backward = labelled
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("train.gradient"):
                _, _, g = step_lib.accumulated_grads(
                    step_lib.make_loss(cfg), model, batch, n_mb)
            with record_function("train.optimizer"):
                adamw.apply_updates(dict(model.named_parameters()), g,
                                    opt_state, opt_cfg)
            torch.cuda.synchronize()
    finally:
        fa.attention_backward = orig
    us = kernel_us(prof)
    us["backward"] = us["all_kernels"] - us.get("train.gradient", 0.0) \
        - us.get("train.optimizer", 0.0)
    names = {"all_kernels": "all_kernels", "train.gradient": "forward",
             "backward": "backward", "train.optimizer": "optimizer",
             "flash_attention": "flash_attention",
             "train.attention_backward": "attention_backward"}
    out = {f"{label}_ms": (us.get(k, 0.0) * 1e-3 or None)
           for k, label in names.items()}
    out["flash_attention_launches"] = us["fa_launches"]
    return out


def training_remat(model, cfg, device, limits: dict, smi: str) -> dict:
    """(d) Gradients of ``model`` on a TRAIN_REMAT batch with each of
    TRAIN_REMAT_RUNS, from the same weights: the loss equal to the
    remat-off one bit for bit, every gradient within its ``limits`` (part
    (a)'s, TRAIN_GRAD_SPREAD times the plain path's 1-ulp spread) of the
    remat-off gradient and whether it is bit-equal; every
    ``flash_attention`` launch of the remat-off warm-up gradient (this
    shape is run nowhere else) replayed against the plain version, within
    the tolerances of kernels/checks.py; each run's peak memory
    allocated (the peak statistics reset before its first timed
    gradient), its ``flash_attention`` launches (one a layer, twice under
    remat: forward and recompute) and the ms by events of
    TRAIN_REMAT_TIMED gradients, after one untimed gradient with the same
    policy (which loads the checkpointing code and leaves the allocator
    the blocks that policy asks for), with the bytes allocated when the
    peak statistics were reset (the model, and whatever else the phase
    holds); "full"'s peak below remat-off's."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import checks as dchecks
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train import step as step_lib
    data = SyntheticLM(DataConfig(global_batch=TRAIN_REMAT["rows"],
                                  seq_len=TRAIN_REMAT["seq_len"], seed=1),
                       cfg)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch_at(0).items()}

    def timed(c):
        ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
        ev[0].record()
        out = step_lib.grads_of(step_lib.make_loss(c), model, batch)
        ev[1].record()
        ev[1].synchronize()
        return out, ev[0].elapsed_time(ev[1])
    runs, g_off, loss_off = {}, None, None
    replay = None
    for label, remat, policy in TRAIN_REMAT_RUNS:
        c = cfg.scaled(remat=remat, remat_policy=policy)
        if remat:
            timed(c)
        else:
            with recorded_lm_kernel_calls(("flash_attention",)) as calls:
                timed(c)
            with torch.no_grad():
                replay = replay_against_plain(calls)
            del calls
            if replay["launches"]["flash_attention"] != cfg.n_layers:
                raise AssertionError(f"training (d): {replay['launches']} "
                                     f"launches replayed, expected "
                                     f"{cfg.n_layers} flash_attention")
            log(f"training (d) remat off: {cfg.n_layers} attention launches"
                f" at {TRAIN_REMAT} replayed against the plain version, "
                f"max abs err {replay['max_abs_err']['flash_attention']:.3g}"
                f" by route {replay['attention_by_route']}; [{smi}]")
        torch.cuda.reset_peak_memory_stats(device)
        before_gb = torch.cuda.memory_allocated(device) / 1e9
        fa0 = fa.flash_attention.launches
        (loss, _, g), ms = timed(c)
        run = dict(ms=[ms],
                   peak_gb=torch.cuda.max_memory_allocated(device) / 1e9,
                   allocated_before_gb=before_gb,
                   flash_attention=fa.flash_attention.launches - fa0,
                   loss=float(loss))
        want = cfg.n_layers * (2 if remat else 1)
        if run["flash_attention"] != want:
            raise AssertionError(f"training (d) {label}: "
                                 f"{run['flash_attention']} flash_attention "
                                 f"launches, expected {want}")
        if g_off is None:
            g_off, loss_off = {n: t.cpu() for n, t in g.items()}, run["loss"]
        else:
            worst, bad, equal = {"name": None, "ratio": 0.0}, [], True
            for n, t in g.items():
                ref = g_off[n].to(device)
                equal = equal and torch.equal(t, ref)
                err = dchecks.rel_l2(t, ref)
                if err / limits[n] > worst["ratio"]:
                    worst = {"name": n, "ratio": err / limits[n],
                             "rel_l2": err}
                if not err <= limits[n]:
                    bad.append((n, err, limits[n]))
            run.update(grads_bit_equal=equal, worst_grad=worst)
            if bad or run["loss"] != loss_off:
                raise AssertionError(f"training (d) {label}: loss "
                                     f"{run['loss']} vs {loss_off} "
                                     f"without remat, gradients past their "
                                     f"limits {bad[:5]}")
        del g, loss
        for _ in range(TRAIN_REMAT_TIMED - 1):
            run["ms"].append(timed(c)[1])
        runs[label] = run
        log(f"training (d) remat {label}: {run}; [{smi}]")
    if not runs["full"]["peak_gb"] < runs["off"]["peak_gb"]:
        raise AssertionError(f"training (d): peak with remat 'full' "
                             f"{runs['full']['peak_gb']} GB, without "
                             f"{runs['off']['peak_gb']} GB")
    del g_off, batch
    torch.cuda.empty_cache()
    return dict(TRAIN_REMAT, runs=runs, replay=replay)


def phase_training(report: dict, device, seed: int = 0) -> dict:
    """The port's training path at qwen1.5-0.5B's full width and depth
    (float32 master weights, bf16 activations, ``nmc_mode="none"``): (a)
    one step's gradient through the kernels against the plain versions'
    (loss; every parameter's gradient by relative L2 within limits from
    the plain path's own spread under 1-ulp input noise; every
    ``flash_attention`` launch replayed against the plain version); (b)
    ``Trainer.run`` for 4 steps with a crash injected at step 3 and
    restored from the step-2 checkpoint (the main path: the LM kernels'
    launch counts are set to 0 just before and read just after); (c) the
    step's ms split by CUDA events, its device ms (profiler: the
    gradient, the update, the attention forward launches and the backward
    recomputes), one attention forward's and one backward recompute's at
    the training shape beside their bounds and SDPA's, peak memory.
    (a)-(c) run with ``remat=False`` (the full config's default is on), so
    that their launches and times stay comparable with earlier runs; (d)
    activation checkpointing at 2 x 4096 tokens
    (:func:`training_remat`)."""
    import math
    import shutil
    import torch
    import torch.nn.functional as F
    from repro_torch import configs, kernels
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import checks as dchecks
    from repro_torch.kernels import checks, flash_attention as fa, ops
    from repro_torch.kernels import nmc_matmul as mm
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = configs.get(TRAIN_ARCH).scaled(remat=False)
    if cfg.nmc_mode != "none" or cfg.dtype != torch.bfloat16:
        raise AssertionError(f"{TRAIN_ARCH} trains in bf16 without NMC, "
                             f"got {cfg.nmc_mode} {cfg.dtype}")
    n_mb, smi = TRAIN["n_microbatches"], report["nvidia_smi"]
    data_cfg = DataConfig(global_batch=TRAIN["global_batch"],
                          seq_len=TRAIN["seq_len"], seed=0)
    data = SyntheticLM(data_cfg, cfg)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model, opt_state = step_lib.init_train_state(
        torch.Generator(device=device).manual_seed(seed), cfg, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    n_tensors = len(params)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch_at(0).items()}
    loss_fn = step_lib.make_loss(cfg)
    log(f"training {TRAIN_ARCH}: {n_params} float32 parameters in "
        f"{n_tensors} tensors, drawn in {init_s:.2f} s; batch "
        f"{tuple(batch['tokens'].shape)} in {n_mb} microbatches")

    # (a) one step's gradient through the kernels and through the plain
    # versions, and the plain path's own spread
    per_mb = cfg.n_layers
    by_route0 = dict(fa.flash_attention.launches_by_route)
    mm0, fa0 = mm.nmc_matmul.launches, fa.flash_attention.launches
    with recorded_lm_kernel_calls(("flash_attention",)) as calls:
        loss_k, _, g_k = step_lib.accumulated_grads(loss_fn, model, batch,
                                                    n_mb)
        torch.cuda.synchronize()
    fa_n = fa.flash_attention.launches - fa0
    routes = {r: fa.flash_attention.launches_by_route[r] - n
              for r, n in by_route0.items()}
    if fa_n != per_mb * n_mb or routes["tensor_core"] != fa_n or \
            mm.nmc_matmul.launches != mm0:
        raise AssertionError(f"training step: {fa_n} flash_attention "
                             f"launches by route {routes} (expected "
                             f"{per_mb} x {n_mb} on the tensor cores), "
                             f"{mm.nmc_matmul.launches - mm0} nmc_matmul")
    with torch.no_grad():
        replay = replay_against_plain(calls)
    del calls
    with ops.force_plain():
        loss_p, _, g_p = step_lib.accumulated_grads(loss_fn, model, batch,
                                                    n_mb)
        with dchecks.nudged_inputs(model, seed + 1):
            loss_u, _, g_u = step_lib.accumulated_grads(loss_fn, model,
                                                        batch, n_mb)
    grads, worst = {}, {"name": None, "ratio": 0.0}
    for name in params:
        err = dchecks.rel_l2(g_k[name], g_p[name])
        spread = dchecks.rel_l2(g_u[name], g_p[name])
        limit = max(TRAIN_GRAD_SPREAD * spread, TRAIN_GRAD_FLOOR)
        norm = float(torch.linalg.vector_norm(g_k[name].float()))
        grads[name] = dict(rel_l2=err, spread=spread, limit=limit, norm=norm)
        if err / limit > worst["ratio"]:
            worst = {"name": name, "ratio": err / limit}
    del g_u
    loss_k, loss_p, loss_u = float(loss_k), float(loss_p), float(loss_u)
    loss_spread = abs(loss_u - loss_p) / abs(loss_p)
    qkv = {n: g for n, g in grads.items()
           if any(f".attn.{w}.w" in n for w in ("wq", "wk", "wv"))}
    log(f"training (a): loss kernels {loss_k:.6f} plain {loss_p:.6f} "
        f"(1-ulp spread {loss_spread:.3g}); gradients by relative L2 "
        f"kernels vs plain, the worst against its limit: {worst}; wq/wk/wv"
        f" worst {max(g['rel_l2'] for g in qkv.values()):.4g}, smallest "
        f"norm {min(g['norm'] for g in qkv.values()):.4g}; {fa_n} attention "
        f"launches replayed, max abs err {replay['max_abs_err']}; [{smi}]")
    ratios = sorted(g["rel_l2"] / g["spread"] for g in grads.values()
                    if g["spread"])
    log(f"training (a): kernels' difference over the 1-ulp spread, by "
        f"parameter: min {ratios[0]:.3g}, median "
        f"{ratios[len(ratios) // 2]:.3g}, max {ratios[-1]:.3g}")
    for name in sorted(grads, key=lambda n: -grads[n]["rel_l2"])[:8]:
        log(f"training (a): gradient {name}: {grads[name]}")
    bad = [n for n, g in grads.items() if not g["rel_l2"] <= g["limit"]]
    if bad or not all(g["norm"] > 0 for g in qkv.values()) or \
            len(qkv) != 3 * cfg.n_layers:
        raise AssertionError(f"gradients through the kernels outside their "
                             f"limits or zero: {[(n, grads[n]) for n in bad]}")
    if not abs(loss_k - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p):
        raise AssertionError(f"loss through the kernels {loss_k} vs plain "
                             f"{loss_p}")
    del g_k, g_p

    # (d) activation checkpointing, from the same weights
    remat = training_remat(model, cfg, device,
                           {n: g["limit"] for n, g in grads.items()}, smi)

    # (b) the trainer with a crash: the main path
    ckdir = REPO / "chiprun_out" / "train_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    tc = TrainerConfig(total_steps=TRAIN["total_steps"],
                       ckpt_every=TRAIN["ckpt_every"], ckpt_dir=str(ckdir),
                       log_every=1, n_microbatches=n_mb, seed=seed)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                total_steps=TRAIN["total_steps"])
    trainer = Trainer(cfg, tc, opt_cfg, data_cfg, device=device)
    steps, saves = [], []
    orig_step, orig_batch, orig_write = \
        trainer._train_step, trainer.batch_at, ckpt.write_host

    def batch_at(step):
        steps.append({"step": step})
        return orig_batch(step)

    def train_step(*args):
        out = orig_step(*args)
        steps[-1]["loss"] = float(out[2]["loss"])
        return out

    def write_host(path, step, host):
        t = time.perf_counter()
        out = orig_write(path, step, host)
        saves.append(dict(step=step, seconds=time.perf_counter() - t,
                          bytes=sum(a.nbytes for a, _ in host.values())))
        return out
    trainer.batch_at, trainer._train_step = batch_at, train_step
    ckpt.write_host = write_host
    del model, opt_state, params
    torch.cuda.empty_cache()
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = trainer.run(fail_at=TRAIN["fail_at"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels.KERNELS}
        attn_routes = dict(fa.flash_attention.launches_by_route)
        mm_routes = dict(mm.nmc_matmul.launches_by_route)
        trainer.checkpointer.close()
    finally:
        ckpt.write_host = orig_write
        shutil.rmtree(ckdir, ignore_errors=True)
    losses = [s["loss"] for s in steps]
    first = [s["loss"] for s in steps if s["step"] == TRAIN["fail_at"] - 1]
    log(f"training (b): Trainer.run(fail_at={TRAIN['fail_at']}) in "
        f"{run_s:.2f} s: final step {out['final_step']}, restarts "
        f"{out['restarts']}, steps run {[s['step'] for s in steps]}, losses "
        f"{losses}; checkpoints {saves}; launches {launches}, attention "
        f"routes {attn_routes}; [{smi}]")
    if out["final_step"] != TRAIN["total_steps"] or out["restarts"] != 1:
        raise AssertionError(f"trainer: {out}")
    if not all(math.isfinite(x) for x in losses) or len(first) != 2:
        raise AssertionError(f"trainer losses {steps}")
    if not abs(first[1] - first[0]) <= TRAIN_REPLAY_RTOL * abs(first[0]):
        raise AssertionError(f"the replayed step's loss {first[1]} vs its "
                             f"first attempt {first[0]}")
    if launches["flash_attention"] != per_mb * n_mb * len(steps) or \
            attn_routes["tensor_core"] != launches["flash_attention"] or \
            launches["nmc_matmul"]:
        raise AssertionError(f"trainer launches {launches}, attention "
                             f"routes {attn_routes}")
    del trainer

    # (c) times: the step split, the attention kernels, peak memory
    model, opt_state = step_lib.init_train_state(
        torch.Generator(device=device).manual_seed(seed), cfg, device=device)
    step_lib.make_train_step(cfg, opt_cfg, n_mb)(model, opt_state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    split = train_step_split_ms(model, opt_state, batch, cfg, opt_cfg, n_mb)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = profiled_train_step(model, opt_state, batch, cfg, opt_cfg, n_mb)
    del model, opt_state
    case = checks.ATTENTION_CASES["qwen-train-512"]
    fwd = time_attention(case, torch.bfloat16, device)
    fwd_bound = attention_bound_ms(case["b"], case["hq"], case["hkv"],
                                   case["sq"], case["d"], case["dv"], 2)
    q, k, v = checks.attention_inputs(case, torch.bfloat16, device)
    do = torch.randn_like(q)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def backward():
        return fa.attention_backward(q, k, v, do)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, is_causal=True)
        return torch.autograd.grad(o, leaves, do)
    reps = ATTENTION_REPS // 5
    bwd_bound = attention_backward_bound_ms(case["b"], case["hq"],
                                            case["hkv"], case["sq"],
                                            case["d"], case["dv"], 2)
    attn = dict(forward_device_ms=fwd["device_ms"], forward_ms=fwd["ms"],
                forward_bound_ms=fwd_bound["bound_ms"],
                forward_bound_by=fwd_bound["bound_by"],
                sdpa_forward_device_ms=fwd["library_device_ms"],
                backward_device_ms=profiled_device_ms(backward, reps),
                backward_ms=events_ms(backward, reps),
                backward_bound_ms=bwd_bound["bound_ms"],
                backward_bound_by=bwd_bound["bound_by"],
                sdpa_forward_backward_device_ms=profiled_device_ms(
                    sdpa_fwd_bwd, reps),
                sdpa_forward_backward_ms=events_ms(sdpa_fwd_bwd, reps))
    log(f"training (c): step ms by events {split}; peak memory "
        f"{peak_gb:.2f} GB; profiled step {prof}; attention at "
        f"the training shape {attn}; [{smi}]")
    report["training"] = dict(
        arch=TRAIN_ARCH, **TRAIN, n_params=n_params, n_tensors=n_tensors,
        init_seconds=init_s, loss_kernels=loss_k, loss_plain=loss_p,
        loss_ulp_spread=loss_spread, grads=grads, worst_grad=worst,
        replay=replay, launches=launches, attention_routes=attn_routes,
        matmul_routes=mm_routes, trainer_seconds=run_s,
        trainer_steps=steps, checkpoints=saves, step_split_ms=split,
        peak_memory_gb=peak_gb, profiled_step=prof, attention=attn,
        remat=remat, nvidia_smi=smi)
    return launches


SCALEOUT_MOE_LAYERS = 2
#: deepseek-v2-lite-16b cut to its dense first layer and one MoE layer
#: (~1.09 B parameters: ~17 GB of float32 p, g, m, v for rank 0's
#: single-rank reference; ~250 GB at 27 layers)
SCALEOUT_MLA_LAYERS = 2
#: zamba2-2.7b cut to 2 groups of 6 Mamba2 layers, so that the shared block
#: is applied twice and its gradient accumulates over groups (~0.75 B
#: parameters)
SCALEOUT_HYBRID_LAYERS = 12
#: pixtral-12b cut to 2 of 40 layers at full width, so that a gradient
#: accumulates across layers (~1.91 B parameters: ~31 GB of float32 p, g,
#: m, v for rank 0's single-rank reference; ~205 GB at 40)
SCALEOUT_VLM_LAYERS = 2
#: the elastic trainer's qwen1.5-0.5b cut to 4 of 24 layers at full width
#: (7.43 GB of training state at 24), to keep the whole run inside its time
#: limit
SCALEOUT_TRAINER_LAYERS = 4
#: qwen1.5-0.5b cut to 12 of 24 layers at full width for (a), (b), (k),
#: the pipeline (2 stages of 6 blocks) and (l)'s serving, and xlstm-125m
#: to 6 of 12 blocks (sLSTM at 3) for (h), (q), (r) and (t), to make room
#: in the time limit for (s)-(w); the training and serving phases keep
#: qwen's 24 layers
SCALEOUT_QWEN_LAYERS = 12
SCALEOUT_XLSTM_LAYERS = 6
#: the scale-out phase: whisper-tiny at full width and depth,
#: qwen1.5-0.5b, xlstm-125m, moonshot-v1-16b-a3b, deepseek-v2-lite-16b,
#: zamba2-2.7b and pixtral-12b at full width cut in depth (above), the training
#: phase's batch (8 rows of 512 tokens in 2 microbatches; whisper's with
#: 1500 frames a row), pixtral's 4 rows of 1536 positions (1024 image +
#: 512 text) in 2 microbatches; the trainer's 4 steps of 2 rows of 256
#: tokens with a checkpoint every 2 and a crash at step 3; the pipeline's
#: 8 rows of 512 in 4 microbatches over 2 stages
SCALEOUT = dict(rows=8, seq=512, n_mb=2, batches={"vlm": (4, 1536)},
                trainer=dict(rows=2, seq=256, n_mb=1, total_steps=4,
                             ckpt_every=2, fail_at=3),
                pipeline=dict(rows=8, n_micro=4))
#: the loss of a sharded step against the single-rank step (relative); for
#: the parts in SCALEOUT_SPREAD_PARTS, or twice the plain path's own 1-ulp
#: spread where that is larger (MOE_LOGITS_SPREAD): the MoE models' routing
#: is discrete (an ulp can move a top-k pick), and the hybrid's and the
#: xLSTM's losses are chaotic under rounding (on an H100: zamba2 cut to 12
#: layers 8.19e-5 under 1-ulp input noise, 5.2e-5 between kernels and
#: plain on one rank; xlstm-125m 4.56e-4 under 1-ulp noise, its bf16
#: sharded step 1.17e-4 from the single-rank one; in float32 on the CPU
#: the sharded step gives the single-rank loss exactly for zamba2 and to
#: rounding for the xLSTM at 12 blocks, tests/test_torch_scaleout.py)
SCALEOUT_LOSS_RTOL = 1e-4
SCALEOUT_SPREAD_PARTS = ("c", "f", "g", "h", "v_mla", "v_ssm")
#: (v): the split-through-a-head paths at smoke width in the 2-rank spawn
#: on (1, 2), a step and W8A8 serving each: deepseek-smoke with one MLA
#: head (``wq``'s 24 columns, ``w_uk`` / ``w_uv`` and ``wo`` split through
#: it) and zamba2-smoke with one SSM head of 128.  No full-width
#: configuration splits an MLA or SSM head on a world that fits one card:
#: deepseek-v2-lite's ``w_uk`` / ``w_uv`` (2048 columns, 16 heads) need
#: model 32, zamba2-2.7b's 80 SSM heads over 5120 columns too.  The
#: hybrid runs in float32 (SCALEOUT_FLOAT32), its step and its serving (as
#: (n)): its ``D`` and ``A_log`` gradients sum the one head's 2 x 512 x 128
#: terms, which cancel, and in bf16 the two ranks' partial sums moved
#: ``mamba.1.1.D`` by 0.48 rel L2 from one rank's (an H100 run), past any
#: limit a check could hold
SCALEOUT_ONE_HEAD = {"mla_1h": (MLA_ARCH, dict(n_heads=1, n_kv_heads=1)),
                     "hybrid_1h": (HYBRID_ARCH, dict(ssm_head_dim=128))}
SCALEOUT_FLOAT32 = ("hybrid_1h",)
SCALEOUT_TIMEOUT = 600.0
#: the scale-out phase's serving parts, two ranks on (data 1, model 2),
#: W8A8: (l) qwen1.5-0.5b at full width cut to SCALEOUT_QWEN_LAYERS, (m)
#: deepseek-v2-lite-16b at full width cut to 2 layers (its dense first
#: layer and one MoE layer: MLA and expert parallelism), (n) zamba2-2.7b at
#: full width cut to 2 groups (12 layers), its activations in float32 (in
#: bf16 its Mamba2 states after 512 tokens move by 0.71 rel L2 under a
#: 1-ulp nudge of the inputs: no check could tell a wrong state from a
#: right one; in float32 0.21, the int8 roundings flipping all the same),
#: and (o) that zamba2 with float weights in float32, where the sharded
#: run's caches can be held to the fixed limit; each prefills 4 rows of
#: 512 tokens into caches of 640 slots and decodes 16 steps of the tokens
#: the single rank picked greedily; (p)-(r) below
SCALEOUT_SERVE = dict(rows=4, prompt=512, max_len=640, steps=16)
SCALEOUT_SERVE_MLA_LAYERS = 2
SCALEOUT_SERVE_HYBRID_LAYERS = 12
#: the serving parts whose sizes differ from SCALEOUT_SERVE, at full
#: width: W8A8 in bf16, (p) whisper-tiny at full depth, 4 rows of 1500 frame
#: embeddings and a 64-token prompt into caches of 128 slots (its cross
#: K/V split over the frames); (q) xlstm-125m cut to
#: SCALEOUT_XLSTM_LAYERS, a 512-token prompt (4
#: chunks of 128; its states laid out by cache_shardings); 16 steps each.
#: (q)'s spread nudges every step's embedded tokens: its states forget the
#: prompt (on an H100 a prefill-only nudge moved mLSTM block 2's n,
#: ``blocks.2.1``, by 0.058 rel L2 after the prefill and 0.0087 after 16
#: steps), while the sharded run rounds its row-parallel sums anew at every
#: step; that spread widens every limit of (q), so (r) serves the same
#: xlstm-125m with float weights in float32, where the sharded run's
#: logits and caches are held to the fixed limits alone
SCALEOUT_SERVE_SIZES = {
    "p": dict(rows=4, frames=1500, prompt=64, max_len=128, steps=16),
    "q": dict(rows=4, prompt=512, max_len=640, steps=16,
              spread_every_step=True),
    "r": dict(rows=4, prompt=512, max_len=640, steps=16,
              spread_every_step=True)}
#: (w) serves as (p), 4 rows on (2, 1): whisper-tiny's 4 decoder layers
#: are the first dim of the batch's size, so the cache rule splits the
#: layer stack over data (ROADMAP fact 21)
SCALEOUT_SERVE_SIZES["w"] = SCALEOUT_SERVE_SIZES["p"]
#: (part, config key, label, spread factor (None: the fixed limits
#: alone), spread only where the 1-ulp spread reaches the fixed limits,
#: prefill exact): compare_logits' rules,
#: the MoE model always on its spread (its routing is discrete); where the
#: sharded prefill does the single rank's arithmetic (column-parallel
#: products, int32 row-parallel sums, attention on local heads: the dense,
#: MLA and encoder-decoder parts), the caches' prompt slots are held to the
#: attention tolerance after the prefill and after the last step
SCALEOUT_SERVE_PARTS = (("l", "serve_dense", "qwen W8A8", MOE_LOGITS_SPREAD,
                         True, True),
                        ("m", "serve_mla", "MLA + EP W8A8", MOE_LOGITS_SPREAD,
                         False, True),
                        ("n", "serve_hybrid", "Mamba2 W8A8 float32",
                         MOE_LOGITS_SPREAD, True, False),
                        ("o", "serve_hybrid_float", "Mamba2 float32",
                         MOE_LOGITS_SPREAD, True, False),
                        ("p", "serve_encdec", "enc-dec W8A8",
                         MOE_LOGITS_SPREAD, True, True),
                        ("q", "serve_xlstm", "xLSTM W8A8", MOE_LOGITS_SPREAD,
                         True, False),
                        ("r", "serve_xlstm_float", "xLSTM float32", None,
                         True, False),
                        ("v_mla_serve", "serve_mla_1h", "one MLA head W8A8",
                         MOE_LOGITS_SPREAD, False, True),
                        ("v_ssm_serve", "serve_hybrid_1h", "one SSM head W8A8",
                         MOE_LOGITS_SPREAD, True, False),
                        ("w", "serve_encdec", "enc-dec stack over data W8A8",
                         MOE_LOGITS_SPREAD, True, True))
#: the gathered caches after the prefill and after the last step against
#: the single rank's, each field by relative L2: within this (about 2.5
#: bf16 ulps), or within the part's spread factor times the single rank's
#: own 1-ulp spread of that field where that is larger, but never past
#: SCALEOUT_SERVE_CACHE_REL_L2_CAP (a zero state is 1 away, an unrelated
#: one of the same norm about 1.4)
SCALEOUT_SERVE_CACHE_REL_L2 = 1e-2
SCALEOUT_SERVE_CACHE_REL_L2_CAP = 0.5
#: the scale-out phase's parts on larger worlds, whose model axis does not
#: divide the heads, so that every rank runs every head (ROADMAP fact 18):
#: (part, ranks, train config key, serving config key, label, spread
#: factor, spread only where reached, prefill exact), the serving rules of
#: SCALEOUT_SERVE_PARTS.  (s) whisper-tiny on (1, 4), 1.5 of its 6 heads a
#: rank: one bf16 train step as (i), W8A8 serving as (p); (t) xlstm-125m
#: on (1, 8), half of one of its 4 heads a rank, float weights in float32:
#: one train step and serving as (r), held to the fixed limits alone.
#: Both at full width, (s) at full depth, (t) at (r)'s; both train steps
#: take their family's batch of (i) and (h).  (u) deepseek-v2-lite-16b on (1, 3), 16 MLA heads
#: over 3: ``wq``'s 3072 columns split through a head, 1024 a rank,
#: ``w_uk``, ``w_uv`` and ``wo`` whole (3 does not divide 2048); cut to its
#: dense first layer (SCALEOUT_MLA_EVERY_LAYERS), a float32 step on (f)'s
#: batch and W8A8 serving as (m).  (s) and (t) run at the same time, (u)
#: after them (SCALEOUT_EVERY_HEAD_WAVES: the three do not fit the card
#: together)
SCALEOUT_EVERY_HEAD = (("s", 4, "encdec", "serve_encdec",
                        "enc-dec every head W8A8", MOE_LOGITS_SPREAD, True,
                        True),
                       ("t", 8, "xlstm_float", "serve_xlstm_float",
                        "xLSTM every head float32", None, True, False),
                       ("u", 3, "mla_every", "serve_mla_every",
                        "MLA every head W8A8", MOE_LOGITS_SPREAD, False,
                        True))
SCALEOUT_EVERY_HEAD_WAVES = (("s", "t"), ("u",))
SCALEOUT_EVERY_HEAD_SIZES = {"s": SCALEOUT_SERVE_SIZES["p"],
                             "t": SCALEOUT_SERVE_SIZES["r"],
                             "u": SCALEOUT_SERVE}
#: deepseek-v2-lite-16b cut to its dense first layer for (u): its 64
#: routed experts do not divide over model 3, where the reference's
#: shard_map fails and the port refuses (``lm.shard``)
SCALEOUT_MLA_EVERY_LAYERS = 1


def scaleout_expected(cfg, moe_cfg, mla_cfg, hybrid_cfg, trainer_cfg,
                      encdec_cfg, vlm_cfg) -> dict:
    """``flash_attention`` launches a rank makes in each part of the
    phase: a step's attention layers (the hybrid's shared-block
    applications; the encoder-decoder's encoder, self- and cross-attention
    layers; none in the xLSTM) x microbatches, twice under remat (forward
    and recompute); the trainer's 5 steps run
    (0, 1, 2, the crash at 3, 2 replayed, 3) and the resumed one; the
    pipeline's stage of half the layers x its microbatches."""
    n_mb, tr = SCALEOUT["n_mb"], SCALEOUT["trainer"]
    return {"a": cfg.n_layers * n_mb, "b": cfg.n_layers * n_mb,
            "k": 2 * cfg.n_layers * n_mb,
            "c": moe_cfg.n_layers * n_mb,
            "d": trainer_cfg.n_layers * tr["n_mb"]
            * (tr["total_steps"] + 1),
            "d_resumed": trainer_cfg.n_layers * tr["n_mb"],
            "e": cfg.n_layers // 2 * SCALEOUT["pipeline"]["n_micro"],
            "f": mla_cfg.n_layers * n_mb,
            "g": hybrid_cfg.n_layers // hybrid_cfg.attn_every * n_mb,
            "h": 0,
            "i": (encdec_cfg.n_enc_layers + 2 * encdec_cfg.n_layers) * n_mb,
            "j": vlm_cfg.n_layers * n_mb}


def train_attention_launches(cfg, n_mb: int) -> int:
    """``flash_attention`` launches a rank makes in one train step of
    ``cfg`` without remat: one per attention layer and microbatch (a
    hybrid's shared block once per group; an encoder-decoder's encoder,
    self- and cross-attention layers; none in an xLSTM)."""
    if cfg.family == "xlstm":
        return 0
    if cfg.family == "encdec":
        return (cfg.n_enc_layers + 2 * cfg.n_layers) * n_mb
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every * n_mb
    return cfg.n_layers * n_mb


def attention_route(cfg) -> str:
    """The ``flash_attention`` route a model's training launches take
    (``kernels/flash_attention.route`` at its head dims: MLA's D = nope +
    rope, Dv = v)."""
    from repro_torch.kernels import flash_attention as fa
    if cfg.mla:
        return fa.route(cfg.dtype, cfg.qk_nope_dim + cfg.qk_rope_dim,
                        cfg.v_head_dim)
    return fa.route(cfg.dtype, cfg.head_dim, cfg.head_dim)


def phase_scaleout(report: dict, device, seed: int = 0) -> dict:
    """Scale-out on two ranks that share the card over gloo
    (``launch.mesh.run_ranks``; the rank function is
    ``distributed.checks.chip_scaleout``, the kernels already built): (a)
    tensor parallelism, qwen1.5-0.5b at full width cut to 12 layers on
    (data 1, model 2);
    (b) data parallelism with ZeRO-2, the same on (2, 1); (c) expert
    parallelism, moonshot-v1-16b-a3b at full width cut to 2 layers on (1,
    2), 32 experts a rank.  Each one step from a mid-run optimizer state,
    held against the single-rank step rank 0 computes first (the loss
    within SCALEOUT_LOSS_RTOL, every gathered gradient and updated
    parameter within the training phase's limits from the plain path's
    1-ulp spread), every attention launch replayed.  (d) ``Trainer(mesh=
    (1, 2))`` of qwen cut to 8 layers with a crash at step 3 (the replayed
    step's loss equal bit for bit), its checkpoint restored onto (2, 1) by
    ``elastic.reshard_state`` (each rank's slices equal to the written
    state's bit for bit) and one more step; (e) ``pipeline_apply``, 2
    stages of 6 blocks, 4 microbatches of 2 rows, against the blocks in
    sequence; (f)
    MLA with expert parallelism, deepseek-v2-lite-16b at full width cut to
    2 layers (the dense one and one MoE) on (1, 2), 8 heads and 32 experts
    a rank, its attention on ``flash_attention``'s CUDA-core route (D 192,
    Dv 128), the assignments dropped on each rank reported; (g) Mamba2
    tensor parallelism, zamba2-2.7b at full width cut to 12 layers (2
    groups) on (1, 2), 40 SSM heads and 16 attention heads a rank; (h)
    xLSTM tensor parallelism, xlstm-125m at full width cut to 6 blocks on
    (1, 2), 2 mLSTM and 2 sLSTM heads a rank, no attention, its collectives
    also by site; (i) the encoder-decoder, whisper-tiny at full width and
    depth on (1, 2), 3 heads a rank, ``embed`` and ``head`` whole (vocab
    51865); (j) the VLM, pixtral-12b at full width cut to 2 layers on (1,
    2), 16 query and 4 KV heads a rank, 4 rows of 1024 image + 512 text
    positions; (k) sequence parallelism with activation checkpointing,
    (a) with ``seq_parallel`` and ``remat`` on, against (a)'s reference,
    its collectives by op beside (a)'s (the recompute's count as
    they run) and its peak memory.  The parts but (k) pin ``remat=False``
    (the full configs' default is on), so that their launches,
    collectives and times stay comparable with earlier runs.  (f)-(j)
    and (k) are held to (a)-(c)'s gradient and parameter limits, (f)-(h) to (c)'s loss rule (SCALEOUT_SPREAD_PARTS), (i) and
    (j) to SCALEOUT_LOSS_RTOL; each launch is expected on the route
    ``flash_attention.route`` gives its shape.  Both ranks compute on the
    one card, so the times are correctness-run times, not a measure of
    scaling.  (l)-(r): serving on (1, 2), SCALEOUT_SERVE (and
    SCALEOUT_SERVE_SIZES for whisper's (p) and the xLSTM's (q), (r)) and
    :func:`scaleout_serving_checks`.  (v): a step and serving of one MLA
    head and one SSM head split over (1, 2) at smoke width
    (SCALEOUT_ONE_HEAD), under (f)'s and (g)'s rules; (w): whisper's
    serving as (p) on (2, 1), its layer stack split over data.  (s)-(u):
    a train step and serving on 4, 8 and 3 ranks whose model axis does
    not divide the heads (:func:`scaleout_every_head`)."""
    import dataclasses
    import math
    import re
    import shutil
    import torch
    from repro_torch import configs
    from repro_torch.distributed import checks as dchecks
    from repro_torch.launch.mesh import run_ranks
    cfg = configs.get(TRAIN_ARCH).scaled(n_layers=SCALEOUT_QWEN_LAYERS,
                                         remat=False)
    moe_cfg = configs.get(MOE_ARCH).scaled(n_layers=SCALEOUT_MOE_LAYERS,
                                           remat=False)
    mla_cfg = configs.get(MLA_ARCH).scaled(n_layers=SCALEOUT_MLA_LAYERS,
                                           remat=False)
    hybrid_cfg = configs.get(HYBRID_ARCH).scaled(
        n_layers=SCALEOUT_HYBRID_LAYERS, remat=False)
    xlstm_cfg = configs.get(XLSTM_ARCH).scaled(
        n_layers=SCALEOUT_XLSTM_LAYERS, remat=False)
    xlstm_float = xlstm_cfg.scaled(dtype=torch.float32)
    encdec_cfg = configs.get(ENCDEC_ARCH).scaled(remat=False)
    vlm_cfg = configs.get(VLM_ARCH).scaled(n_layers=SCALEOUT_VLM_LAYERS,
                                           remat=False)
    trainer_cfg = cfg.scaled(n_layers=SCALEOUT_TRAINER_LAYERS)
    sp_cfg = cfg.scaled(seq_parallel=True, remat=True)
    one_head = {k: configs.get(arch, smoke=True).scaled(
        remat=False, **kw, **({"dtype": torch.float32}
                              if k in SCALEOUT_FLOAT32 else {}))
        for k, (arch, kw) in SCALEOUT_ONE_HEAD.items()}
    mla_every = configs.get(MLA_ARCH).scaled(
        n_layers=SCALEOUT_MLA_EVERY_LAYERS, remat=False, dtype=torch.float32)
    serve_cfgs = scaleout_serving_configs()
    smi = report["nvidia_smi"]
    spec = dict(SCALEOUT, qwen=cfg, qwen_sp=sp_cfg, moe=moe_cfg,
                mla=mla_cfg, hybrid=hybrid_cfg, xlstm=xlstm_cfg,
                encdec=encdec_cfg, vlm=vlm_cfg, trainer_model=trainer_cfg,
                xlstm_float=xlstm_float, mla_every=mla_every, **one_head,
                serve=SCALEOUT_SERVE, serve_sizes=SCALEOUT_SERVE_SIZES,
                **serve_cfgs, seed=seed,
                grad_spread=TRAIN_GRAD_SPREAD, grad_floor=TRAIN_GRAD_FLOOR,
                opt=dict(lr=1e-3, warmup_steps=1, total_steps=10),
                trainer=dict(SCALEOUT["trainer"], ckpt_dir=str(
                    REPO / "chiprun_out" / "scaleout_ckpt")))
    ckdir = spec["trainer"]["ckpt_dir"]
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(dchecks.chip_scaleout, 2, spec, backend="gloo",
                          device="cuda", timeout=SCALEOUT_TIMEOUT,
                          collective_timeout=300.0)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    want = scaleout_expected(cfg, moe_cfg, mla_cfg, hybrid_cfg, trainer_cfg,
                             encdec_cfg, vlm_cfg)
    for part, key in (("v_mla", "mla_1h"), ("v_ssm", "hybrid_1h")):
        want[part] = train_attention_launches(one_head[key], SCALEOUT["n_mb"])
    want_route = {p: attention_route(c) for p, c in
                  (("a", cfg), ("b", cfg), ("k", sp_cfg),
                   ("c", moe_cfg), ("d", cfg),
                   ("d_resumed", cfg), ("e", cfg), ("f", mla_cfg),
                   ("g", hybrid_cfg), ("h", xlstm_cfg), ("i", encdec_cfg),
                   ("j", vlm_cfg), ("v_mla", one_head["mla_1h"]),
                   ("v_ssm", one_head["hybrid_1h"]))}
    launches = {"flash_attention": 0, "nmc_matmul": 0, "vrf_alu": 0}
    routes = {"tensor_core": 0, "cuda_core": 0}
    by_part, replay_by_route, counts = {}, {}, []

    def tally(part: str, got: dict) -> None:
        launches["flash_attention"] += got["launches"]
        row = by_part.setdefault(part.split("_")[0], {})
        for k, n in got["attention_routes"].items():
            routes[k] += n
            row[k] = row.get(k, 0) + n
        for k, err in got["replay_by_route"].items():
            replay_by_route[k] = max(replay_by_route.get(k, 0.0), err)
        counts.extend((rank, part, *rest) for rank, *rest in got["per_rank"])
    for part, key in (("d", "counted"), ("d_resumed", "counted_resumed"),
                      ("e", "counted")):
        tally(part, step_part_check(
            part, [(r["rank"], {"counted": r[part[0]][key]}) for r in ranks],
            want[part], want_route[part]))
    for part, key in (("a", "TP"), ("b", "DP ZeRO-2"),
                      ("k", "TP + SP + remat"), ("c", "EP"),
                      ("f", "MLA + EP"), ("g", "Mamba2 TP"),
                      ("h", "xLSTM TP"), ("i", "enc-dec TP"),
                      ("j", "VLM TP"), ("v_mla", "one MLA head TP"),
                      ("v_ssm", "one SSM head TP")):
        res = r0[part]
        loss_limit = SCALEOUT_LOSS_RTOL \
            if part not in SCALEOUT_SPREAD_PARTS else max(
            SCALEOUT_LOSS_RTOL,
            MOE_LOGITS_SPREAD * res["reference"]["loss_spread"])
        log(f"scaleout ({part}) {key}: loss {res['metrics']['loss']:.6f} vs "
            f"single rank {res['reference']['loss']:.6f} (rel "
            f"{res['loss_rel']:.3g}; plain {res['reference']['loss_plain']:.6f},"
            f" 1-ulp spread {res['reference']['loss_spread']:.3g}); "
            f"gradients worst {res['grads']['worst']}, params worst "
            f"{res['params']['worst']}; replay "
            f"{[r[part]['replay'] for r in ranks]}; step ms by events "
            f"{[round(r[part]['step_ms'], 1) for r in ranks]}"
            f"{'' if part != 'a' else ', device ms (rank 0) ' + str(res.get('step_device_ms'))}"
            f"; peak GB {[r[part]['peak_gb'] for r in ranks]}; "
            f"moments {[r[part]['local_moments'] for r in ranks]} of "
            f"{res['full_moments']}; collectives (calls, bytes, staged) "
            f"{res['counted']['traffic']}; partial over model "
            f"{len(res['partial'])}; MoE assignments dropped (tokens, "
            f"assignments, dropped) by rank "
            f"{[r[part]['moe_drops'] for r in ranks]}; "
            f"{res['seconds']:.1f} s; [{smi}]")
        if part == "k":
            log(f"scaleout (k) collectives (calls, bytes, staged) by rank, "
                f"forward, recompute and backward: "
                f"{[r['k']['counted']['traffic'] for r in ranks]} beside "
                f"(a)'s {[r['a']['counted']['traffic'] for r in ranks]}; "
                f"peak GB by rank {[r['k']['peak_gb'] for r in ranks]} "
                f"beside (a)'s {[r['a']['peak_gb'] for r in ranks]}; "
                f"attention launches replayed by rank "
                f"{[r['k']['replay']['shapes'] for r in ranks]}; "
                f"partial over model {res['partial'][:3]} ...")
            if any("reduce_scatter" not in r["k"]["counted"]["traffic"]
                   for r in ranks):
                raise AssertionError("scaleout (k): no reduce-scatter")
        if part == "h":
            log(f"scaleout (h) forward gathers by site (calls, bytes) by "
                f"rank: {[r['h']['traffic_by_site'] for r in ranks]}; "
                f"collectives in all by rank "
                f"{[r['h']['counted']['traffic'] for r in ranks]}")
        tally(part, step_part_check(part, [(r["rank"], r[part])
                                           for r in ranks],
                                    want[part], want_route[part],
                                    loss_limit))
    zero = r0["b"]
    log(f"scaleout (b) ZeRO-2: {zero['moments_split']} moments halved over "
        f"data, whole where the reference puts data on a layer stack "
        f"({len(zero['moments_whole'])}: {zero['moments_whole'][:4]} ...)")
    if zero["moments_split"] + len(zero["moments_whole"]) != \
            zero["n_tensors"] or not all(
                re.search(r"\.attn\.w[qkv]\.b$", n)
                for n in zero["moments_whole"]):
        raise AssertionError(f"ZeRO-2: moments halved "
                             f"{zero['moments_split']}, whole "
                             f"{zero['moments_whole']}")
    d, e = r0["d"], r0["e"]
    first = [s["loss"] for s in d["steps"]
             if s["step"] == SCALEOUT["trainer"]["fail_at"] - 1]
    log(f"scaleout (d) trainer (1, 2), {trainer_cfg.n_layers} layers: "
        f"{d['run']}, steps "
        f"{[(s['step'], s.get('loss')) for s in d['steps']]}, checkpoints "
        f"{d['checkpoints']} in {d['run_seconds']:.1f} s; restored onto "
        f"(2, 1) (reshard, restore) and back onto (1, 2) (round trip) bit "
        f"for bit: {d['same']} in {d['restore_seconds']:.1f} s, "
        f"resumed loss {d['resumed_loss']:.6f}; collectives "
        f"{d['counted']['traffic']}; {d['seconds']:.1f} s; [{smi}]")
    if d["run"] != {"final_step": SCALEOUT["trainer"]["total_steps"],
                    "restarts": 1} or len(first) != 2 or \
            first[0] != first[1] or not all(d["same"].values()) or \
            not math.isfinite(d["resumed_loss"]):
        raise AssertionError(f"scaleout (d): {d['run']}, replayed "
                             f"{first}, restored equal {d['same']}, "
                             f"resumed {d['resumed_loss']}")
    log(f"scaleout (e) pipeline 2 stages x {cfg.n_layers // 2} blocks, "
        f"{SCALEOUT['pipeline']['n_micro']} microbatches: max abs err "
        f"{e['max_abs_err']} vs the blocks in sequence, bubble fraction "
        f"{e['bubble']}, {e['run_seconds']:.2f} s; [{smi}]")
    if not e["finite"] or e["bubble"] != 0.2:
        raise AssertionError(f"scaleout (e): {e}")
    serving = scaleout_serving_checks(ranks, serve_cfgs, smi)
    every = scaleout_every_head(spec, serving, smi)
    for part, res in every.items():
        tally(part, res)
    for k in ("flash_attention", "nmc_matmul"):
        launches[k] += serving["launches"][k]
    for k, n in serving["attention_routes"].items():
        routes[k] += n
    for k, err in serving["attention_by_route"].items():
        replay_by_route[k] = max(replay_by_route.get(k, 0.0), err)
    replay_err = max(replay_by_route.values())
    log(f"scaleout: {launches['flash_attention']} flash_attention launches "
        f"on the main path by route {routes}, by part {by_part} (rank, "
        f"part, launches, nmc_matmul, routes: {counts}; serving parts "
        f"{serving['launches_by_part']}); {launches['nmc_matmul']} "
        f"nmc_matmul launches by route {serving['matmul_routes']}; replays "
        f"max abs err by route {replay_by_route}; "
        f"ranks {wall:.1f} s wall, {[round(r['seconds'], 1) for r in ranks]}"
        f" s in the ranks")

    def plain(res):
        return {k: v for k, v in res.items() if k not in ("steps",)}
    report["scaleout"] = dict(
        qwen_layers=SCALEOUT_QWEN_LAYERS, xlstm_layers=SCALEOUT_XLSTM_LAYERS,
        moe_layers=SCALEOUT_MOE_LAYERS, mla_layers=SCALEOUT_MLA_LAYERS,
        hybrid_layers=SCALEOUT_HYBRID_LAYERS, vlm_layers=SCALEOUT_VLM_LAYERS,
        trainer_layers=SCALEOUT_TRAINER_LAYERS,
        **{k: v for k, v in SCALEOUT.items()},
        serve=SCALEOUT_SERVE, serve_sizes=SCALEOUT_SERVE_SIZES,
        serve_mla_layers=SCALEOUT_SERVE_MLA_LAYERS,
        serve_hybrid_layers=SCALEOUT_SERVE_HYBRID_LAYERS,
        ranks=[{p: plain(v) for p, v in r.items()
                if p not in ("rank", "seconds")}
               | {"seconds": r["seconds"]} for r in ranks],
        trainer_steps=d["steps"], launches=launches, attention_routes=routes,
        attention_routes_by_part=by_part, serving=serving,
        every_head=every,
        matmul_routes=serving["matmul_routes"],
        replay={"attention_by_route": replay_by_route,
                "max_abs_err": {"nmc_matmul": serving["matmul_max_abs_err"],
                                "flash_attention": replay_err}},
        wall_seconds=wall, nvidia_smi=smi,
        **{f"{k}_config": dataclasses.asdict(c) | {"dtype": str(c.dtype)}
           for k, c in (("moe", moe_cfg), ("mla", mla_cfg),
                        ("hybrid", hybrid_cfg), ("xlstm", xlstm_cfg),
                        ("encdec", encdec_cfg), ("vlm", vlm_cfg),
                        ("sp", sp_cfg))})
    return launches


def step_part_check(part: str, ranks: list, want: int, route: str,
                    loss_limit: float | None = None) -> dict:
    """One train-step part of ``phase_scaleout`` (``ranks``: (rank, its
    result) in rank order, rank 0 first): on each rank ``want``
    ``flash_attention`` launches, all on ``route``, and no ``nmc_matmul``;
    where the result holds its replays, every launch replayed on that
    route; given ``loss_limit``, rank 0's loss within it of the
    single-rank step's (relative) and every gathered gradient and updated
    parameter within their limits.  Raises where it fails; returns the
    part's launches, routes, replay errors by route and per-rank launches
    (rank, flash_attention, nmc_matmul, routes)."""
    out = {"launches": 0, "attention_routes": {}, "replay_by_route": {},
           "per_rank": []}
    for rank, res in ranks:
        c, rep = res["counted"], res.get("replay")
        if c["flash_attention"] != want or c["nmc_matmul"] or \
                c["attention_routes"][route] != want or \
                (rep is not None and (rep["launches"] != want or
                                      rep["routes"] != ({route: want}
                                                        if want else {}))):
            raise AssertionError(
                f"scaleout ({part}) rank {rank}: launches {c}, replayed "
                f"{rep}, expected {want} flash_attention on the {route} "
                f"route and no nmc_matmul")
        out["launches"] += want
        out["per_rank"].append((rank, c["flash_attention"], c["nmc_matmul"],
                                c["attention_routes"]))
        for k, n in c["attention_routes"].items():
            out["attention_routes"][k] = out["attention_routes"].get(k, 0) + n
        for k, err in (rep or {}).get("max_abs_err_by_route", {}).items():
            out["replay_by_route"][k] = max(
                out["replay_by_route"].get(k, 0.0), err)
    if loss_limit is not None:
        res = ranks[0][1]
        res["loss_limit"] = loss_limit
        if res["grads"]["bad"] or res["params"]["bad"] or \
                not res["loss_rel"] <= loss_limit:
            raise AssertionError(f"scaleout ({part}): loss rel "
                                 f"{res['loss_rel']}, gradients past their "
                                 f"limits {res['grads']['bad'][:5]}, params "
                                 f"{res['params']['bad'][:5]}")
    return out


def scaleout_every_head(spec: dict, serving: dict, smi: str) -> dict:
    """Parts (s)-(u) of ``phase_scaleout`` (SCALEOUT_EVERY_HEAD): each
    on its own world of 4, 8 or 3 ranks sharing the card over gloo (rank
    function ``distributed.checks.chip_every_head``), a model whose heads
    the model axis does not divide, so that every rank runs every head.
    The worlds of a wave of SCALEOUT_EVERY_HEAD_WAVES run at the same time
    ((s) and (t): 12 ranks, ~60 GB of the card at their peaks), for the
    run's time limit.
    The train step by :func:`step_part_check`: on each rank as many
    ``flash_attention`` launches as one rank makes
    (:func:`train_attention_launches`: (i)'s count for whisper, none for
    the xLSTM, deepseek's one a layer and microbatch), each over every
    head; its loss within SCALEOUT_LOSS_RTOL.  The serving part by :func:`serving_part_check`
    (its launches added to ``serving``).  Returns each part's launches,
    routes, replays, seconds and results."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.distributed import checks as dchecks
    from repro_torch.launch.mesh import run_ranks

    def spawn(row) -> tuple:
        part, world, train_key, serve_key = row[:4]
        part_spec = dict(spec, part=part, train=train_key, serve=serve_key,
                         serve_sizes=SCALEOUT_EVERY_HEAD_SIZES)
        t0 = time.perf_counter()
        ranks = run_ranks(dchecks.chip_every_head, world, part_spec,
                          backend="gloo", device="cuda",
                          timeout=SCALEOUT_TIMEOUT, collective_timeout=300.0)
        return ranks, time.perf_counter() - t0
    rows = {row[0]: row for row in SCALEOUT_EVERY_HEAD}
    runs = {}
    for wave in SCALEOUT_EVERY_HEAD_WAVES:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with ThreadPoolExecutor(len(wave)) as pool:
            runs.update(zip(wave, pool.map(spawn, [rows[p] for p in wave])))
    out = {}
    for part, world, train_key, serve_key, label, factor, if_reached, \
            exact in SCALEOUT_EVERY_HEAD:
        ranks, wall = runs[part]
        cfg = spec[train_key]
        want = train_attention_launches(cfg, spec["n_mb"])
        t = ranks[0]["train"]
        per_rank = [(r["rank"], round(r["train"]["step_ms"], 1),
                     r["train"]["peak_gb"], round(r["train"]["seconds"], 1),
                     round(r["serve"]["seconds"], 1)) for r in ranks]
        log(f"scaleout ({part}) {cfg.name} train step on (1, {world}), "
            f"every head on every rank, "
            f"{spec['batches'].get(train_key, (spec['rows'], spec['seq']))}"
            f" (rows, tokens) in {spec['n_mb']} microbatches: loss "
            f"{t['metrics']['loss']:.6f} vs "
            f"single rank {t['reference']['loss']:.6f} (rel "
            f"{t['loss_rel']:.3g}; 1-ulp spread "
            f"{t['reference']['loss_spread']:.3g}); gradients worst "
            f"{t['grads']['worst']}, params worst {t['params']['worst']}; "
            f"per rank (rank, step ms, peak GB, train s, serve s) "
            f"{per_rank}; replay "
            f"{[r['train']['replay'] for r in ranks][:1]}; collectives "
            f"(rank 0) {t['counted']['traffic']}; partial over model "
            f"{len(t['partial'])}; ranks {wall:.1f} s wall; [{smi}]")
        res = step_part_check(part, [(r["rank"], r["train"]) for r in ranks],
                              want, attention_route(cfg), SCALEOUT_LOSS_RTOL)
        res.update(wall_seconds=wall, train_per_rank=per_rank)
        serving_part_check(serving, [(r["rank"], r["serve"]) for r in ranks],
                           part, spec[serve_key], label, factor, if_reached,
                           exact, SCALEOUT_EVERY_HEAD_SIZES[part], smi,
                           (1, world))
        res["ranks"] = [{k: {n: v for n, v in r[k].items()
                             if n not in ("grads", "params")}
                         for k in ("train", "serve")} for r in ranks]
        res["train"] = {k: t[k] for k in ("grads", "params", "loss_rel",
                                          "reference", "metrics")}
        out[part] = res
    return out


def scaleout_serving_configs() -> dict:
    """The serving parts' configs (SCALEOUT_SERVE), by spec key."""
    import torch
    from repro_torch import configs
    return {"serve_dense": configs.get(TRAIN_ARCH).scaled(
                n_layers=SCALEOUT_QWEN_LAYERS, nmc_mode="w8a8"),
            "serve_mla": configs.get(MLA_ARCH).scaled(
                n_layers=SCALEOUT_SERVE_MLA_LAYERS, nmc_mode="w8a8"),
            "serve_hybrid": configs.get(HYBRID_ARCH).scaled(
                n_layers=SCALEOUT_SERVE_HYBRID_LAYERS, nmc_mode="w8a8",
                dtype=torch.float32),
            "serve_hybrid_float": configs.get(HYBRID_ARCH).scaled(
                n_layers=SCALEOUT_SERVE_HYBRID_LAYERS, nmc_mode="none",
                dtype=torch.float32),
            "serve_encdec": configs.get(ENCDEC_ARCH).scaled(
                nmc_mode="w8a8"),
            "serve_xlstm": configs.get(XLSTM_ARCH).scaled(
                n_layers=SCALEOUT_XLSTM_LAYERS, nmc_mode="w8a8"),
            "serve_xlstm_float": configs.get(XLSTM_ARCH).scaled(
                n_layers=SCALEOUT_XLSTM_LAYERS, nmc_mode="none",
                dtype=torch.float32),
            "serve_mla_every": configs.get(MLA_ARCH).scaled(
                n_layers=SCALEOUT_MLA_EVERY_LAYERS, nmc_mode="w8a8"),
            **{f"serve_{k}": configs.get(arch, smoke=True).scaled(
                nmc_mode="w8a8", **kw, **({"dtype": torch.float32}
                                          if k in SCALEOUT_FLOAT32 else {}))
               for k, (arch, kw) in SCALEOUT_ONE_HEAD.items()}}


def serving_part_expected(cfg, steps: int, shape: tuple = (1, 2)) -> dict:
    """The launches a rank makes in a serving part of ``phase_scaleout``
    (a prefill and ``steps`` decode steps of ``cfg`` on a (data, model)
    mesh of ``shape``), from the config: ``nmc_matmul`` by route under
    W8A8 (:func:`matmul_routes_per_call` at the rank's slices: an odd
    vocabulary keeps the head whole, on ``dp4a``), the int32-out ones the
    ``model`` axis makes of the linears it lays out row-parallel (none in
    the xLSTM, whose blocks stay float; none on data axes alone),
    ``flash_attention`` (:func:`attention_launches_per_call`)."""
    from repro_torch.kernels import nmc_matmul as mm
    w8a8, model = cfg.nmc_mode == "w8a8", shape[1]
    pre, dec = (matmul_routes_per_call(cfg, p, model) for p in (True, False))
    routes = {r: (pre[r] + steps * dec[r]) if w8a8 else 0
              for r in mm.ROUTE_ID}
    rows = (sum(matmul_kn_per_call(cfg, True, True, model).values())
            + steps * sum(matmul_kn_per_call(cfg, False, True,
                                             model).values())) \
        if w8a8 else 0
    return {"nmc_matmul": sum(routes.values()), "matmul_routes": routes,
            "matmul_int32": rows,
            "flash_attention": attention_launches_per_call(cfg, True)
            + steps * attention_launches_per_call(cfg, False)}


def scaleout_serving_checks(ranks: list, cfgs: dict, smi: str) -> dict:
    """The serving parts (l)-(r), (v) and (w) of ``phase_scaleout``: on
    each rank the
    ``nmc_matmul`` launches of the sharded run equal the single rank's and
    the part's expected ones by route (:func:`serving_part_expected`: one
    launch a W8A8 linear either way, none with float weights, on the
    tensor cores but a whole head of an odd vocabulary; every launch
    replayed: a row-parallel one returns the int32 accumulator, held bit
    for bit, the others at ``kernels/checks.matmul_tolerance``); the
    ``flash_attention`` launches (the prefill's on local heads, an
    encoder-decoder's cross-attention at decode) equal the single rank's
    and the expected ones (none in the xLSTM), on the route
    ``flash_attention.route`` gives, replayed; on rank 0 the logits of the
    prefill and every step (the rows gathered) against the single rank's
    by compare_logits' rules (SCALEOUT_SERVE_PARTS), the gathered caches
    after the prefill and after the last step by relative L2
    (SCALEOUT_SERVE_CACHE_REL_L2, or the spread rule up to its cap; a
    part with no spread factor, the fixed limits alone) and,
    where the part's prefill is exact, their prompt slots by the attention
    tolerance.
    Returns the parts' launches, routes, replays and results."""
    out = {"launches": {"flash_attention": 0, "nmc_matmul": 0},
           "matmul_routes": {"tensor_core": 0, "dp4a": 0},
           "attention_routes": {"tensor_core": 0, "cuda_core": 0},
           "attention_by_route": {}, "matmul_max_abs_err": 0.0,
           "launches_by_part": {}, "parts": {}}
    from repro_torch.distributed import checks as dchecks
    shapes = {part: shape for part, _, shape in dchecks.SERVE_PARTS}
    for part, key, label, factor, if_reached, exact in \
            SCALEOUT_SERVE_PARTS:
        serving_part_check(out, [(r["rank"], r[part]) for r in ranks], part,
                           cfgs[key], label, factor, if_reached, exact,
                           SCALEOUT_SERVE_SIZES.get(part, SCALEOUT_SERVE),
                           smi, shapes[part])
    return out


def serving_part_check(out: dict, ranks: list, part: str, cfg, label: str,
                       factor, if_reached: bool, exact: bool, sv: dict,
                       smi: str, shape: tuple) -> None:
    """One serving part of ``phase_scaleout`` on a (data, model) mesh of
    ``shape`` (``ranks``: (rank, its result) in rank order, rank 0
    first), by the rules of :func:`scaleout_serving_checks`: raises where
    it fails, adds its launches, routes and replays to ``out`` and its
    rule to ``out["parts"]``."""
    rank0 = ranks[0][1]
    want = serving_part_expected(cfg, sv["steps"], shape)
    alone = serving_part_expected(cfg, sv["steps"], (1, 1))
    single = rank0["single_counted"]
    route = attention_route(cfg)
    mesh = str(tuple(shape))
    if any(single[k] != alone[k] for k in ("nmc_matmul", "matmul_routes",
                                           "flash_attention")):
        raise AssertionError(f"scaleout ({part}) single rank: launches "
                             f"{single}, expected {alone}")
    for rank, res in ranks:
        c, a, m = res["counted"], res["attention_replay"], \
            res["matmul_replay"]
        if any(c[k] != want[k] for k in want) or \
                c["nmc_matmul"] != m["launches"] or \
                c["matmul_int32"] != m["int32"] or not m["bit_equal"] or \
                c["attention_routes"][route] != c["flash_attention"] or \
                a["launches"] != c["flash_attention"]:
            raise AssertionError(
                f"scaleout ({part}) rank {rank}: launches {c}, "
                f"expected {want}, single rank {single}, attention "
                f"replay {a}, nmc_matmul replay {m}")
        for k in ("flash_attention", "nmc_matmul"):
            out["launches"][k] += c[k]
        for k, n in c["matmul_routes"].items():
            out["matmul_routes"][k] += n
        for k, n in c["attention_routes"].items():
            out["attention_routes"][k] += n
        for k, err in a["max_abs_err_by_route"].items():
            out["attention_by_route"][k] = max(
                out["attention_by_route"].get(k, 0.0), err)
        out["matmul_max_abs_err"] = max(out["matmul_max_abs_err"],
                                        m["max_abs_err"])
        out["launches_by_part"].setdefault(part, []).append(
            (rank, c["nmc_matmul"], c["matmul_int32"], c["flash_attention"]))
    res = rank0
    st, spread = res["logits"], res["spread"]
    rms_limit, agree_limit = 0.25 * st["logit_std"], 0.5
    reached = spread["rms_diff"] >= rms_limit or \
        spread["top1_agreement"] <= agree_limit
    rule = "fixed"
    if factor is not None and (reached or not if_reached):
        rule = "spread"
        rms_limit = factor * spread["rms_diff"]
        agree_limit = spread["top1_agreement"] / factor
    cache_bad, worst_cache = [], (None, 0.0)
    for when, fields in res["caches"].items():
        for path, c in fields.items():
            limit = SCALEOUT_SERVE_CACHE_REL_L2 if factor is None \
                else min(SCALEOUT_SERVE_CACHE_REL_L2_CAP,
                         max(SCALEOUT_SERVE_CACHE_REL_L2,
                             factor * c["spread_rel_l2"]))
            c["limit"] = limit
            if c["rel_l2"] / limit >= worst_cache[1]:
                worst_cache = (f"{when} {path}", c["rel_l2"] / limit)
            if not c["rel_l2"] <= limit or (
                    exact and c["prompt_within_attention_tolerance"]
                    is False):
                cache_bad.append((when, path, c))
    log(f"scaleout ({part}) serving {label}, {cfg.name} "
        f"{cfg.n_layers} layers on {mesh}: {res['positions']} positions "
        f"(prefill and {sv['steps']} steps x {sv['rows']} rows) vs the "
        f"single rank: logits "
        f"{st} ({rule} limits: rms <= {rms_limit:.4g}, top-1 agreement "
        f">= {agree_limit:.4f}; the single rank's 1-ulp spread "
        f"{spread}); caches (max abs err, within the attention "
        f"tolerance: all and the prompt's slots"
        f"{', enforced' if exact else ''}; "
        f"rel L2, the spread's rel L2) {res['caches']}, the "
        f"worst rel L2 over its limit {worst_cache}; local caches "
        f"(rank 0) "
        f"{res['local_caches']}; launches (rank, nmc_matmul, int32-out, "
        f"flash_attention) {out['launches_by_part'][part]}, single rank "
        f"{single['nmc_matmul']} / {single['flash_attention']}; a decode "
        f"step's collectives (calls, bytes, staged, result bytes) by "
        f"rank {[r['step_traffic'] for _, r in ranks]}; served in "
        f"{[round(r['serve_ms'], 1) for _, r in ranks]} ms by events,"
        f" peak GB {[r['peak_gb'] for _, r in ranks]}; "
        f"{res['seconds']:.1f} s; [{smi}]")
    if not res["finite"] or st["rms_diff"] > rms_limit or \
            st["top1_agreement"] < agree_limit or cache_bad:
        raise AssertionError(
            f"scaleout ({part}): logits {st} against {rule} limits "
            f"{rms_limit}, {agree_limit}; caches past their limits "
            f"{cache_bad}")
    out["parts"][part] = dict(rule=rule, rms_limit=rms_limit,
                              top1_agreement_limit=agree_limit,
                              spread_reaches_fixed_limits=reached)


#: the dry run's part: a (1, 2) fake world for scale-out (a) and (k), and
#: the training phase's (d) gradients on one rank, traced on ``meta`` in a
#: spawned CPU process (no default group, no kernel) while the scale-out
#: phase runs (~30 s of traces on one core); what it adds to the run, the
#: wait for its result after the scale-out phase and the comparison, must
#: stay under DRYRUN_BUDGET_S
DRYRUN_BUDGET_S = 30.0
DRYRUN_TIMEOUT = 300.0


def dryrun_child(conn, src: str) -> None:
    """The spawned process: ``launch.dryrun`` on the CPU over the scale-out
    phase's (a) and (k) steps (qwen1.5-0.5b at full width on a fake (data
    1, model 2) world, SCALEOUT's batch and microbatches; (k) with
    ``seq_parallel`` and ``remat``) and over (d)'s gradient function
    (TRAIN_REMAT's batch, remat off / "full" / "dots", one rank): each
    census, its trace seconds, sent back through ``conn``."""
    import traceback
    sys.path.insert(0, src)
    try:
        import torch
        torch.set_num_threads(1)
        from repro_torch import configs
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.launch import dryrun
        from repro_torch.launch import specs as S
        from repro_torch.train import step as step_lib
        cfg = configs.get(TRAIN_ARCH)
        out = {"torch": torch.__version__}
        shape = ShapeSpec("scaleout", SCALEOUT["seq"], SCALEOUT["rows"],
                          "train")
        # (a)'s and (k)'s configs as phase_scaleout builds them
        qwen = cfg.scaled(n_layers=SCALEOUT_QWEN_LAYERS)
        for part, c in (("a", qwen.scaled(remat=False)),
                        ("k", qwen.scaled(seq_parallel=True, remat=True))):
            out[part] = dryrun.run_cell(
                TRAIN_ARCH, shape, False, cfg_override=c, mesh_shape=(1, 2),
                n_microbatches=SCALEOUT["n_mb"])
        # (l)'s decode step: its rows against caches of max_len slots
        out["l"] = dryrun.run_cell(
            TRAIN_ARCH, ShapeSpec("scaleout_serve", SCALEOUT_SERVE["max_len"],
                                  SCALEOUT_SERVE["rows"], "decode"), False,
            cfg_override=scaleout_serving_configs()["serve_dense"],
            mesh_shape=(1, 2))
        remat_shape = ShapeSpec("remat", TRAIN_REMAT["seq_len"],
                                TRAIN_REMAT["rows"], "train")
        for label, remat, policy in TRAIN_REMAT_RUNS:
            c = cfg.scaled(remat=remat, remat_policy=policy)
            loss_fn = step_lib.make_loss(c)
            t0 = time.perf_counter()
            _, step, _ = dryrun.trace_step(
                lambda m, b, f=loss_fn: step_lib.grads_of(f, m, b),
                (S.abstract_params(c), S.input_specs(c, remat_shape)))
            out[f"d_{label}"] = dict(step, trace_s=time.perf_counter() - t0)
        conn.send(("ok", out))
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


@contextlib.contextmanager
def dryrun_in_background():
    """Start :func:`dryrun_child` in a spawned process; yield a function
    that waits for its result (raising with the child's traceback); the
    process is stopped on leaving."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=dryrun_child, args=(send, str(REPO / "src")))
    t0 = time.perf_counter()
    proc.start()
    send.close()

    def result() -> dict:
        if not recv.poll(max(0.0, DRYRUN_TIMEOUT -
                             (time.perf_counter() - t0))):
            raise AssertionError(f"dry run: no result within "
                                 f"{DRYRUN_TIMEOUT} s")
        status, value = recv.recv()
        if status != "ok":
            raise AssertionError(f"dry run failed:\n{value}")
        value["process_s"] = time.perf_counter() - t0
        return value
    try:
        yield result
    finally:
        if proc.is_alive():
            proc.join(5.0)
        if proc.is_alive():
            proc.terminate()
        proc.join()
        recv.close()


def phase_dryrun(report: dict, result) -> dict:
    """The dry run against the card (``launch/dryrun.py``, no card in
    it): (a)'s and (k)'s collectives as the dry run counts them on a fake
    (1, 2) world must equal, call for call and result byte for byte, what
    rank 0 of ``phase_scaleout`` counted on the card in the same window
    (``context.traffic`` around the train step); (d)'s predicted peak
    bytes (the gradient function on ``meta``, its arguments the model and
    the batch) beside the peak ``training_remat`` measured and the bytes
    allocated before it.  The wait for the child within
    DRYRUN_BUDGET_S."""
    from repro_torch.launch.analysis import KINDS
    smi = report["nvidia_smi"]
    t0 = time.perf_counter()
    dry = result()
    wait_s = time.perf_counter() - t0
    out = {"torch": dry["torch"], "process_s": dry["process_s"],
           "collectives": {}, "remat_peaks": {}}
    traced_s = 0.0
    for part in ("a", "k", "l"):
        rec = dry[part]
        traced_s += rec["trace_s"]
        ranks = report["scaleout"]["ranks"][0]
        card = ranks[part]["step_traffic"] if part == "l" else \
            ranks[part]["counted"]["traffic"]
        want = {KINDS[op]: [row[0], row[3]] for op, row in card.items()}
        got = {k: [v["count"], v["result_bytes"]]
               for k, v in rec["census"]["collectives"].items()}
        out["collectives"][part] = dict(
            dry_run=got, card=want, census=rec["census"],
            memory=rec["memory"], trace_s=rec["trace_s"],
            card_peak_gb=report["scaleout"]["ranks"][0][part]["peak_gb"])
        log(f"dry run ({part}) on a fake (1, 2) world: collectives (calls, "
            f"result bytes) {got}; on the card, rank 0 {want}; predicted "
            f"peak {rec['memory']['peak_bytes'] / 1e9:.2f} GB (the step "
            f"alone), card {out['collectives'][part]['card_peak_gb']:.2f} GB"
            f" (with the single-rank reference's state); "
            f"{rec['trace_s']:.1f} s; [{smi}]")
        if got != want:
            raise AssertionError(f"dry run ({part}): collectives {got}, the "
                                 f"card counted {want}")
    for label, _, _ in TRAIN_REMAT_RUNS:
        d = dry[f"d_{label}"]
        traced_s += d["trace_s"]
        run = report["training"]["remat"]["runs"][label]
        pred = d["memory"]["peak_bytes"] / 1e9
        row = dict(predicted_peak_gb=pred,
                   predicted_argument_gb=d["memory"]["argument_bytes"] / 1e9,
                   measured_peak_gb=run["peak_gb"],
                   allocated_before_gb=run["allocated_before_gb"],
                   gap_gb=run["peak_gb"] - pred,
                   flops=d["census"]["flops"], trace_s=d["trace_s"])
        out["remat_peaks"][label] = row
        log(f"dry run (d) remat {label}: predicted peak {pred:.2f} GB "
            f"(arguments {row['predicted_argument_gb']:.2f}), measured "
            f"{run['peak_gb']:.2f} GB, gap {row['gap_gb']:.2f} GB; "
            f"allocated when the peak was reset "
            f"{run['allocated_before_gb']:.2f} GB; {d['trace_s']:.1f} s; "
            f"[{smi}]")
    out.update(trace_s=traced_s, wait_s=wait_s)
    log(f"dry run: {traced_s:.1f} s of traces, the process "
        f"{dry['process_s']:.1f} s beside the scale-out phase, "
        f"{wait_s:.1f} s waited for after it; torch {dry['torch']}")
    if wait_s > DRYRUN_BUDGET_S:
        raise AssertionError(f"dry run: waited {wait_s:.1f} s for it, past "
                             f"{DRYRUN_BUDGET_S} s")
    report["dryrun"] = out
    return out


VRF_META = {"name": "vrf_alu", "source": "src/repro_torch/csrc/vrf_alu.cu",
            "replaces": "src/repro/kernels/vrf_alu.py:35"}
#: 32 registers x 1,048,576 elements: the VRF of a 1024-tile NM-Carus
#: array, 1 KiB per register per tile at SEW 8
VRF_FULL = (32, 1 << 20)
#: the resident block's layer: qwen1.5-0.5B's shape (heads of 64, d_ff =
#: 2.75 d_model) at the width PERF.md states, for the serving run's 4 rows
BLOCK = dict(d_model=320, n_heads=5, d_ff=880, rows=4, tiles=80)


def vrf_bound_ms(compiled, vl: int, elem: int) -> tuple:
    """Bytes: every register the program reads before writing it (vs2
    unless the op is mv, vs1 in vv mode) loaded once, every register it
    writes stored once: the whole program's load and store lists of
    ``kernels.vrf_alu.compile_prog``.  Operations: one per element per
    instruction, at the int8 peak."""
    t_bytes = (compiled.n_load + compiled.n_store) * vl * elem \
        / HBM_BYTES_PER_S
    t_ops = compiled.n_instr * vl / INT_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_vrf_vs_plain(report: dict, device) -> int:
    """vrf_alu against its plain version on the card, bit for bit, on
    every case of kernels/checks.py (50 random programs among them) and on
    its edge cases: rows not 16-byte aligned, views at odd offsets, long
    and wide programs (their launch counts asserted), vv shifts by lane,
    an empty program and VL 0 (no launch)."""
    import torch
    from repro_torch.kernels import checks
    worst, cases = 0, checks.vrf_cases(n_random=50)
    for label, f, entries in cases:
        worst = max(worst, checks.check_vrf_alu(f, entries, device))
    edges = checks.vrf_edge_cases()
    for case in edges:
        worst = max(worst, checks.check_vrf_case(case, device))
    torch.cuda.synchronize()
    log(f"vrf_alu vs plain: {len(cases)} cases (demo programs, every op x "
        f"mode, wrap extremes at int8/int16/int32, VL "
        f"{list(checks.VRF_VLS)}, 50 random programs) and {len(edges)} "
        f"edge cases ({', '.join(c[0] for c in edges)}) bit-exact, launch "
        f"counts as stated")
    report["vrf_cases"] = len(cases) + len(edges)
    return worst


#: the timed vrf_alu rows: (label, shape, dtype name); fused_chain is the
#: demo's program, random64 checks.vrf_timed_random_program
VRF_ROWS = (("fused_chain", VRF_FULL, "int8"),
            ("fused_chain", VRF_FULL, "int16"),
            ("fused_chain", VRF_FULL, "int32"),
            ("random64", VRF_FULL, "int8"),
            ("random64", VRF_FULL, "int32"),
            ("fused_chain", (32, 4096), "int16"))
#: public calls per host-time reading, at the demo's shape
VRF_CALLS = 200


def vrf_rows() -> list:
    """:data:`VRF_ROWS` with their programs' entries (plain data, so that
    another checkout's package can run the same rows)."""
    from repro_torch.kernels import checks
    programs = {"fused_chain": checks.VRF_DEMO_PROGRAMS["fused_chain"],
                "random64": checks.vrf_timed_random_program()}
    return [dict(label=label, shape=list(shape), dtype=dtype,
                 entries=programs[label]) for label, shape, dtype in VRF_ROWS]


def vrf_file(shape, dtype, device, seed: int = 0):
    import torch
    dt = getattr(torch, dtype)
    info = torch.iinfo(dt)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(info.min, info.max + 1, tuple(shape), generator=gen,
                         device=device, dtype=dt)


def vrf_call_us(entries: list, dtype: str, device) -> float:
    """Host us per public ``vrf_alu`` call of the imported package at the
    demo's shape: :data:`VRF_CALLS` calls back to back, then one
    synchronize, after a warm-up call."""
    import torch
    from repro_torch.kernels import vrf_alu as V
    from repro_torch.kernels import checks
    buf = vrf_file(checks.VRF_DEMO_SHAPE, dtype, device)
    prog = V.make_prog(entries)
    V.vrf_alu(buf, prog)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(VRF_CALLS):
        V.vrf_alu(buf, prog)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / VRF_CALLS * 1e6


def vrf_launcher(V, buf, prog):
    """A callable that launches the imported package's kernel alone on
    ``prog``, compiled ahead: ``compile_prog(rows, elem_bytes)``, or an
    earlier package's ``compile_prog(rows)`` whose code is copied to the
    card first."""
    import inspect
    from repro_torch.kernels import ref
    rows = ref.check_vrf_program(prog, buf.shape[0])
    if len(inspect.signature(V.compile_prog).parameters) == 2:
        compiled = V.compile_prog(rows, buf.element_size())
    else:
        compiled = V.compile_prog(rows).to(buf.device)
    return lambda: V.launch(buf, compiled)


def time_vrf_public(rows: list, device) -> list:
    """The imported package's ``vrf_alu`` on each row: the public call's ms
    by CUDA events with the L2 flushed first (a call that waits on the
    card, as a blocking copy does, pays the wait inside the span), host us
    per public call at the demo's shape, and the kernel alone on the
    program compiled ahead (:func:`vrf_launcher`), L2 flushed (``ms``) and
    with the host ahead (``device_ms``)."""
    from repro_torch.kernels import vrf_alu as V
    flush = l2_flush(device)
    warm = vrf_file(rows[0]["shape"], rows[0]["dtype"], device)
    events_ms(lambda: V.vrf_alu(warm, V.make_prog(rows[0]["entries"])),
              reps=20, flush=flush)
    del warm
    out = []
    for r in rows:
        buf = vrf_file(r["shape"], r["dtype"], device)
        prog = V.make_prog(r["entries"])
        ms = events_ms(lambda: V.vrf_alu(buf, prog), reps=20, flush=flush)
        us = vrf_call_us(r["entries"], r["dtype"], device)
        go = vrf_launcher(V, buf, prog)
        kms = events_ms(go, reps=20, flush=flush)
        kdev = events_ms(go, reps=50, flush=host_ahead)
        out.append(dict(label=r["label"], shape=r["shape"], dtype=r["dtype"],
                        public_ms=ms, vrf_call_us=us, ms=kms,
                        device_ms=kdev))
        log(f"timing: vrf_alu public {r['label']} {r['shape']} {r['dtype']}: "
            f"{ms:.4f} ms (events, L2 flushed), {us:.1f} us per call at the "
            f"demo shape; kernel alone {kms:.4f} ms (device {kdev:.4f})")
        del buf
    return out


def phase_vrf_full(report: dict, device) -> dict:
    """vrf_alu on :data:`VRF_ROWS`: the demo's fused_chain at full size (32
    registers x 1,048,576 elements) at int8 / int16 / int32, a
    64-instruction random program at int8 and int32, fused_chain at the
    demo's shape; and the empty kernel with the same parameters (the launch
    floor).  Each row: kernel vs plain bit for bit, the kernel alone by
    CUDA events with the L2 flushed before each launch (``ms``) and with
    the host ahead (``device_ms``), the public call's ms and host us per
    call (:func:`time_vrf_public`), the plain version's ms and the
    bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import vrf_alu as V
    flush = l2_flush(device)
    # the first timed spans of a process read high (clocks, first use of
    # the flush): a pass that is thrown away
    events_ms(lambda: V.launch_floor(device), reps=20, flush=flush)
    floor = dict(
        label="floor", ms=events_ms(lambda: V.launch_floor(device), reps=20,
                                    flush=flush),
        device_ms=events_ms(lambda: V.launch_floor(device), reps=50,
                            flush=host_ahead))
    log(f"timing: vrf_alu launch floor (empty kernel, same parameters): "
        f"{floor['ms']:.4f} ms (device {floor['device_ms']:.4f})")
    rows = []
    spec = vrf_rows()
    for r, tm in zip(spec, time_vrf_public(spec, device)):
        base = vrf_file(r["shape"], r["dtype"], device)
        prog = V.make_prog(r["entries"])
        got = V.vrf_alu(base.clone(), prog)
        want = ref.vrf_alu(base.clone(), prog)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"vrf_alu {r['label']} {r['shape']} "
                                 f"{r['dtype']}: kernel != plain")
        del got, want
        compiled = V.compile_prog(
            ref.check_vrf_program(prog, r["shape"][0]), base.element_size())
        plain = events_ms(lambda: ref.vrf_alu(base, prog), reps=3,
                          flush=flush)
        bms, by = vrf_bound_ms(compiled, r["shape"][1], base.element_size())
        rows.append(dict(
            label=r["label"], dtype=r["dtype"], shape=r["shape"],
            n_instr=compiled.n_instr, n_load=compiled.n_load,
            n_store=compiled.n_store, launches=len(compiled.launches),
            slots=[ln.n_slots for ln in compiled.launches],
            ms=tm["ms"], device_ms=tm["device_ms"], floor_ms=floor["ms"],
            floor_device_ms=floor["device_ms"], public_ms=tm["public_ms"],
            vrf_call_us=tm["vrf_call_us"], plain_ms=plain, bound_ms=bms,
            bound_by=by, max_abs_err=0))
        log(f"timing: vrf_alu {r['label']} {r['shape']} {r['dtype']} "
            f"({compiled.n_instr} instrs, {compiled.n_load} loads, "
            f"{compiled.n_store} stores, slots {rows[-1]['slots']}): kernel "
            f"{tm['ms']:.4f} ms (device {tm['device_ms']:.4f}), floor "
            f"{floor['ms']:.4f}, plain {plain:.3f} ms, bound {bms:.5f} ms "
            f"({by}), library null (no PyTorch call runs a program-as-data "
            f"VRF)")
        del base
    report["vrf_timing"] = rows
    report["vrf_floor"] = floor
    return rows[0]


def phase_demo(report: dict) -> dict:
    """The kernels demo end to end on the card: the vrf_alu path's entry
    point.  Every kernel count is set to 0 just before and read just
    after."""
    import torch
    from repro_torch import kernels
    from repro_torch.examples import nmc_kernels_demo
    from repro_torch.nmc import cuda_engine
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    cuda_engine.reset_launch_counts()
    t0 = time.perf_counter()
    result = nmc_kernels_demo.main([])
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches
                for k in kernels.KERNELS + cuda_engine.KERNELS}
    log(f"demo: nmc_kernels_demo on the card in {demo_s:.3f} s; launches "
        f"{launches}")
    if not (all(result["vrf_alu"].values())
            and result["frontend"]["bit_exact"]
            and result["nmc_matmul_rel_err"] < 0.015):
        raise AssertionError(f"the demo's checks failed: {result}")
    for name in ("vrf_alu", "nmc_matmul", "caesar_wave", "carus_wave"):
        if launches[name] <= 0:
            raise AssertionError(f"the demo launched no {name}")
    report["demo"] = dict(seconds=demo_s, launches=launches, result=result)
    return launches


def phase_multitile(report: dict) -> dict:
    """Multi-tile NMC on the card: every tile-count-sweep family at tiles
    1-16 and SEW 8/16/32 on both engines, sync and async, each output equal
    to the single-tile output and the numpy oracle, compiles <= buckets;
    then one autotuned 7 Caesar + 1 Carus qrelu wave that launches both
    wave kernels in one wave.  Counts set to 0 just before, read just
    after."""
    import numpy as np
    import torch
    from repro_torch import nmc
    from repro_torch.core import programs
    from repro_torch.examples import tile_families
    from repro_torch.nmc import cuda_engine
    from repro_torch.nmc import schedule as S
    rt = nmc.NmcRuntime(backend="cuda")
    torch.cuda.synchronize()
    cuda_engine.reset_launch_counts()
    t0 = time.perf_counter()
    sweep = tile_families.sweep(rt)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    log(f"multi-tile: {len(sweep['runs'])} partitioned runs (5 families x "
        f"SEW 8/16/32 x 2 engines x tiles {list(tile_families.TILES)}, each "
        f"sync + async) bit-exact vs single tile and oracle in "
        f"{sweep_s:.3f} s; compiles={sweep['compiles']} <= "
        f"buckets={sweep['buckets']}; queue waves={rt.queue.waves}")

    S.clear_plan_cache()
    kfn, args = programs.qrelu_case(8)
    ck = nmc.jit(kfn, tiles=8, partition="rows", runtime=rt)
    tuned = ck.plan_schedule(*args, schedule="auto")
    if sorted(tuned.engines) != ["caesar"] * 7 + ["carus"]:
        raise AssertionError(f"qrelu autotuned to {tuned.engines}")
    ref_out = ck(*args, schedule="uniform")
    q = rt.queue
    before = {k.__name__: k.launches for k in cuda_engine.KERNELS}
    w0, m0 = q.waves, q.mixed_engine_waves
    out = ck(*args, schedule="auto")
    torch.cuda.synchronize()
    wave = {k.__name__: k.launches - before[k.__name__]
            for k in cuda_engine.KERNELS}
    if not (np.array_equal(out, ref_out)
            and np.array_equal(out, ck.oracle(*args))):
        raise AssertionError("the mixed qrelu wave diverged")
    if (q.waves - w0, q.mixed_engine_waves - m0) != (1, 1) \
            or wave != {"caesar_wave": 1, "carus_wave": 1}:
        raise AssertionError(f"the mixed qrelu wave was not one wave of "
                             f"both kernels: {wave}")
    launches = {k.__name__: k.launches for k in cuda_engine.KERNELS}
    log(f"multi-tile: qrelu autotuned to 7 Caesar + 1 Carus shards "
        f"({tuned.modeled_cycles:.0f} modeled cycles vs uniform "
        f"{tuned.uniform_cycles:.0f}), one wave launching {wave}, bit-exact; "
        f"path launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a wave kernel was not launched: {launches}")
    report["multitile"] = dict(
        seconds=sweep_s, runs=len(sweep["runs"]), compiles=sweep["compiles"],
        buckets=sweep["buckets"], launches=launches,
        qrelu=dict(engines=list(tuned.engines),
                   modeled_cycles=tuned.modeled_cycles,
                   uniform_cycles=tuned.uniform_cycles, wave=wave))
    return launches


def phase_resident_block(report: dict, device, seed: int = 0) -> dict:
    """One decode step of a resident W8A8 qwen-family layer on the tile
    array (cold, then a steady step), bit-exact three ways (resident tiles,
    ``nmc_project`` and the exact int32 GEMM); after the first step only
    activation patches cross the bus.  Counts set to 0 just before the
    resident steps and read just after."""
    import numpy as np
    import torch
    from repro_torch import configs, nmc
    from repro_torch.models import lm
    from repro_torch.nmc import cuda_engine
    from repro_torch.serve.engine import ServeEngine, quantize_params
    b = BLOCK
    cfg = configs.get(SERVE_ARCH).scaled(
        n_layers=1, d_model=b["d_model"], n_heads=b["n_heads"],
        n_kv_heads=b["n_heads"], d_ff=b["d_ff"], nmc_mode="w8a8")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = quantize_params(lm.init_params(cfg, gen, device), cfg)
    queue = nmc.DispatchQueue(pool=nmc.ResidentPool(backend="cuda"))
    eng = ServeEngine(cfg, params, n_slots=b["rows"], max_len=64,
                      nmc_queue=queue, nmc_tiles=b["tiles"], device=device)
    t0 = time.perf_counter()
    blk = eng.resident_block(layer=0)
    build_s = time.perf_counter() - t0
    if not blk.static:
        raise AssertionError("a projection failed the residency proof")
    pool = queue.pool
    x = np.random.default_rng(seed).normal(
        size=(b["rows"], cfg.d_model)).astype(np.float32)

    torch.cuda.synchronize()
    cuda_engine.reset_launch_counts()
    t0 = time.perf_counter()
    y_res, st = blk.step(x, blk.init_state(8))
    cold_ms = (time.perf_counter() - t0) * 1e3
    loads, pb = pool.loads, pool.patch_bytes
    t0 = time.perf_counter()
    blk.step(y_res, st)
    steady_ms = (time.perf_counter() - t0) * 1e3
    launches = {k.__name__: k.launches for k in cuda_engine.KERNELS}
    if loads != blk.n_shards or pool.loads != loads \
            or pool.patch_bytes - pb != blk.patch_bytes_per_call:
        raise AssertionError(f"residency broken: loads {loads} -> "
                             f"{pool.loads} for {blk.n_shards} shards, "
                             f"patch bytes {pool.patch_bytes - pb}")
    if launches["caesar_wave"] <= 0:
        raise AssertionError(f"the block launched no caesar_wave: "
                             f"{launches}")
    if queue.stager is None or queue.stager.copies != loads:
        raise AssertionError("a resident weight image was not staged "
                             "through the pinned stager")

    t0 = time.perf_counter()
    y_prj, _ = blk.step(x, blk.init_state(8), mm=blk.project_mm(eng))
    project_s = time.perf_counter() - t0
    y_mm, _ = blk.step(x, blk.init_state(8), mm=blk.torch_mm)
    if not (np.array_equal(y_res, y_prj) and np.array_equal(y_res, y_mm)
            and np.isfinite(y_res).all()):
        raise AssertionError("resident / nmc_project / torch_mm diverged")
    log(f"resident block: qwen-family layer d_model={cfg.d_model} "
        f"heads={cfg.n_heads}x{cfg.head_dim} d_ff={cfg.d_ff}, "
        f"{b['rows']} rows, {blk.n_shards} Caesar shards ({b['tiles']} per "
        f"projection), built in {build_s:.1f} s; cold step {cold_ms:.1f} ms, "
        f"steady step {steady_ms:.1f} ms; weights loaded once "
        f"(loads={loads}), steady step patched "
        f"{blk.patch_bytes_per_call} B; {queue.stager.copies} images "
        f"staged through pinned memory; resident == nmc_project == torch_mm "
        f"bit for bit (nmc_project step {project_s:.1f} s); launches "
        f"{launches}")
    report["resident_block"] = dict(
        **b, build_s=build_s, cold_step_ms=cold_ms, steady_step_ms=steady_ms,
        project_step_s=project_s, shards=blk.n_shards, loads=loads,
        patches=pool.patches, patch_bytes_per_step=blk.patch_bytes_per_call,
        modeled_step_cycles=blk.step_cycles(True), launches=launches)
    return launches



def time_checkout(root: pathlib.Path, waves_only: bool = False,
                  vrf_only: bool = False) -> int:
    """``python3 chip_smoke.py --time-checkout DIR [--waves-only |
    --vrf-only]``: times the checkout at DIR.  With ``--vrf-only``, only
    its ``vrf_alu``: its public ``vrf_alu.vrf_alu`` on this script's rows
    and programs (:func:`vrf_rows`, :func:`time_vrf_public`), then its own
    ``chip_smoke.phase_vrf_full`` for its kernel-only reading.  Otherwise
    first its ``caesar_wave`` and ``carus_wave`` on
    the waves of :func:`caesar_timed_waves` and :func:`carus_timed_waves`
    (made by this tree's package, so that both checkouts run the same
    waves); then, unless ``--waves-only``, its
    serving phase (its own ``chip_smoke.phase_serving``) alone in this
    process, and this script's ``nmc_matmul`` timings of that checkout's
    package: device ms with the L2 evicted, host us per call, a decode
    step's device ms (profiler).  Prints them as one JSON line.  Run it in
    fresh processes on two checkouts in one call, alternating (parent,
    change, change, parent), to compare them on one card."""
    import importlib.util
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = root.resolve()
    sys.path.insert(0, str(REPO / "src"))
    if vrf_only:
        rows = vrf_rows()
    else:
        waves = {"caesar": caesar_timed_waves(random=True),
                 "carus": carus_timed_waves(random=True)}
    # from here on, the package under test is the checkout's
    sys.path.remove(str(REPO / "src"))
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    from repro_torch import cuda_build
    device = torch.device("cuda", 0)
    cuda_build.build_all()
    out = {"smi": nvidia_smi_line(), "package": repro_torch.__file__}
    spec = importlib.util.spec_from_file_location(
        "checkout_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    report = {}
    if vrf_only:
        out["vrf_public"] = time_vrf_public(rows, device)
        smoke.phase_vrf_full(report, device)
        out["vrf_kernel"] = report["vrf_timing"]
        out["vrf_floor"] = report.get("vrf_floor")
        print(json.dumps(out))
        return 0
    out.update({f"{e}_waves": time_waves(e, w, device)
                for e, w in waves.items()})
    if not waves_only:
        smoke.phase_serving(report, device)
        cfg, params = serving_model(device)
        out.update(
            serving={k: report["serving"][k]
                     for k in ("seconds", "decode_step_ms", "prefill_ms")},
            decode_step_kernels=decode_step_kernel_ms(device, params, cfg),
            matmul_ms=matmul_kernel_ms(device),
            matmul_host_us=matmul_host_us(device))
    print(json.dumps(out))
    return 0


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

    seconds = {}

    def timed_phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[label] = time.perf_counter() - t0
        log(f"phase {label}: {seconds[label]:.1f} s")
        return out

    timed_phase("build", phase_build, report)
    waves = timed_phase("kernels_vs_plain", phase_kernels_vs_plain, report,
                        device)
    launches = timed_phase("main_path", phase_main_path, report)
    staging_launches = timed_phase("staging", phase_staging, report)
    timed = timed_phase("timing", phase_timing, report, waves, device)
    lm_errs = timed_phase("lm_kernels_vs_plain", phase_lm_kernels_vs_plain,
                          report, device)
    lm_paths = {"serving": timed_phase("serving", phase_serving, report,
                                       device)}
    for path, phase in (("moe_serving", phase_moe_serving),
                        ("mla_serving", phase_mla_serving),
                        ("vlm", phase_vlm), ("encdec", phase_encdec),
                        ("hybrid_serving", phase_hybrid_serving),
                        ("xlstm_serving", phase_xlstm_serving),
                        ("training", phase_training)):
        lm_paths[path] = timed_phase(path, phase, report, device)
    with dryrun_in_background() as dry:
        lm_paths["scaleout"] = timed_phase("scaleout", phase_scaleout,
                                           report, device)
        timed_phase("dryrun", phase_dryrun, report, dry)
    lm_timed = timed_phase("lm_timing", phase_lm_timing, report, device)
    vrf_err = timed_phase("vrf_vs_plain", phase_vrf_vs_plain, report, device)
    demo_launches = timed_phase("demo", phase_demo, report)
    vrf_row = timed_phase("vrf_full", phase_vrf_full, report, device)
    tile_launches = timed_phase("multitile", phase_multitile, report)
    block_launches = timed_phase("resident_block", phase_resident_block,
                                 report, device)
    report["phase_seconds"] = seconds

    kernels = []
    for engine, meta in KERNEL_META.items():
        row = timed[engine]
        kernels.append({**meta, "route": "cuda",
                        "launches": launches[engine],
                        "max_abs_err": report["max_abs_err"][engine],
                        "ms": row["ms"], "device_ms": row["device_ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": None})
    # attention's error by route, every serving path's replays folded in
    # (deepseek's on the CUDA-core route); its row reports the route that
    # its times are of
    replays = [report["serving"]["attention_replay"]] + \
        [report[p]["replay"] for p in lm_paths if p != "serving"] + \
        [report["training"]["remat"]["replay"]]
    attn_errs = dict(lm_errs["flash_attention"])
    for rep in replays:
        for kind, err in rep["attention_by_route"].items():
            attn_errs[kind] = max(attn_errs[kind], err)
    for kname, meta in LM_KERNEL_META.items():
        row = lm_timed[kname]
        extra, err = {}, lm_errs[kname]
        if kname == "flash_attention":
            extra = {k: row[k] for k in ("device_ms", "library_device_ms",
                                         "kernel_route")}
            extra["training"] = report["training"]["attention"]
            extra["scaleout_attention_routes"] = \
                report["scaleout"]["attention_routes"]
            extra["max_abs_err_by_route"] = attn_errs
            err = attn_errs[row["kernel_route"]]
        else:
            extra = {k: row[k] for k in ("kernel_route", "plan", "median_ms",
                                         "library_median_ms",
                                         "library_padded_rows")}
            extra["launches_by_route"] = {
                r: sum(report[p]["matmul_routes"][r] for p in lm_paths)
                for r in report["serving"]["matmul_routes"]}
            err = max([err] + [rep["max_abs_err"][kname]
                               for rep in replays[1:]])
        extra["launches_by_path"] = {p: n[kname]
                                     for p, n in lm_paths.items()}
        kernels.append({"name": kname, **meta, "route": "cuda",
                        "launches": sum(n[kname] for n in lm_paths.values()),
                        "max_abs_err": err, "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], **extra})
    kernels.append({**VRF_META, "route": "cuda",
                    "launches": demo_launches["vrf_alu"],
                    "max_abs_err": vrf_err, "ms": vrf_row["ms"],
                    "device_ms": vrf_row["device_ms"],
                    "floor_ms": vrf_row["floor_ms"],
                    "plain_ms": vrf_row["plain_ms"],
                    "bound_ms": vrf_row["bound_ms"],
                    "bound_by": vrf_row["bound_by"], "library_ms": None})
    report["path_launches"] = {"nmc": launches,
                               "staging": staging_launches, **lm_paths,
                               "demo": demo_launches,
                               "multitile": tile_launches,
                               "resident_block": block_launches}
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
    if sys.argv[1:2] == ["--time-checkout"]:
        sys.exit(time_checkout(pathlib.Path(sys.argv[2]),
                               waves_only="--waves-only" in sys.argv[3:],
                               vrf_only="--vrf-only" in sys.argv[3:]))
    sys.exit(main())
