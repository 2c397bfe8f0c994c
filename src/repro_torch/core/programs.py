"""Kernel library: the paper's benchmark suite for NM-Caesar and NM-Carus.

Since the traced-frontend redesign (DESIGN.md §7) every builder is an
ordinary numpy-style kernel function compiled through
:mod:`repro_torch.nmc.frontend`: the function is traced once per engine, the
tracer's eager ``alu.*_np`` evaluation *is* the quantized oracle, and the
per-engine lowerings emit the same instruction structure the hand-written
builders used to:

* NM-Caesar operands land in opposite banks (loads in bank 1; constants,
  outputs and temporaries in bank 0) so sustained throughput is one op per
  2 cycles (Section III-A2); conv2d's shifted-replica trick falls out of
  ``slide_down`` on loaded values (the packed-SIMD alignment trick; cf. the
  C-SRAM comparison's data-replication remark, Table VII).
* NM-Carus chunks operands across vector registers and iterates with the
  *indirect register addressing* template of Section III-B1; ``t.consts``
  taps (matmul A entries, conv filter weights) are read through EMVX
  exactly like the eCPU does.
* Max-pooling's horizontal reduction runs on the host CPU / eCPU (Section
  V-B1: "the lack of subword reduction operations ... requires horizontal
  pooling to be implemented in software") and is accounted as host cycles.

Each builder returns a :class:`KernelBuild` holding, per engine, the
lowered instruction stream + initial memory image + output location and
the numpy oracle.  :class:`EngineBuild` / :class:`KernelBuild` are kept as
thin shims over the frontend's :class:`repro_torch.nmc.frontend.LoweredKernel`
so the pool/runtime/timing/energy layers and hand-constructed test builds
keep one artifact type.

Kernel default shapes follow Table V footnotes (a-g).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core import alu
from repro_torch.nmc import frontend
from repro_torch.nmc.frontend import mac as _mac
from repro_torch.nmc.program import Program, carus_entry

# Legacy alias: hand-built test traces still use this entry helper.
trace_entry = carus_entry

DTYPES = alu.NP_DTYPES


@dataclasses.dataclass
class EngineBuild:
    stream: list                      # unified-IR entries (nmc.program)
    mem: np.ndarray                   # initial memory / VRF image (int32 words)
    out_slice: tuple[int, int]        # (word_start, n_words) in flat memory view
    host_cycles: float = 0.0          # work left on the host CPU / eCPU
    ecpu_instrs: int = 0              # scalar instructions per vector instr (ovl.)
    oracle: np.ndarray | None = None  # expected final outputs for this engine
    post: Callable | None = None      # host-side finishing stage (e.g. h-pool)
    n_outputs: int = 0                # outputs produced by this engine's build
    engine: str = ""                  # "caesar" | "carus" (set by the builder)
    sew: int = 0                      # element width (set by the builder)
    _prog: Program | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def program(self) -> Program:
        """The build's unified-IR Program.  Legacy hand-built streams
        (tuples / CARUS_TRACE_DTYPE scalars) are converted on the fly."""
        if self._prog is None:
            self._prog = Program.from_legacy(self.stream, self.sew or 32,
                                             self.engine or None)
        return self._prog


@dataclasses.dataclass
class KernelBuild:
    name: str
    sew: int
    n_outputs: int
    oracle: np.ndarray                # expected output elements
    caesar: EngineBuild | None
    carus: EngineBuild | None


def _kernel_build(name: str, sew: int, caesar_pack, carus_pack) -> KernelBuild:
    """Tag the per-engine builds with engine/sew/oracle and assemble."""
    (cz, orc_c), (kz, orc_k, n_out) = caesar_pack, carus_pack
    for eb, orc, engine in ((cz, orc_c, "caesar"), (kz, orc_k, "carus")):
        eb.oracle, eb.n_outputs = orc, orc.size
        eb.engine, eb.sew = engine, sew
    return KernelBuild(name, sew, n_out, orc_k, cz, kz)


def _traced_build(kfn, args, engine: str, sew: int, host_cycles: float = 0.0,
                  post_wrap: Callable | None = None) -> tuple:
    """Trace + lower a frontend kernel for one engine; shim the result into
    an :class:`EngineBuild` (optionally composing a host-side finishing
    stage after the frontend's extraction ``post``)."""
    # opt="off": registry streams reproduce the paper's hand-written
    # kernels verbatim (Table V instruction counts) — the optimizer is
    # benchmarked against them, not baked into them
    lk = frontend.jit(kfn, engine=engine, sew=sew, opt="off").lower(*args)
    post = lk.post if post_wrap is None \
        else (lambda e, _p=lk.post, _w=post_wrap: _w(_p(e)))
    eb = EngineBuild(list(lk.stream), lk.mem, lk.out_slice,
                     host_cycles=host_cycles, ecpu_instrs=lk.ecpu_instrs,
                     post=post)
    # keep the full lowering (init spans, per-instruction provenance) so
    # the static verifier sweep (python -m repro_torch.nmc.check) can run the
    # dataflow passes over registry builds, not just the bare program
    eb.lowered = lk
    return eb, np.asarray(lk.oracle)


def _rng(seed):
    return np.random.default_rng(seed)


def _rand(rng, shape, sew):
    info = np.iinfo(DTYPES[sew])
    return rng.integers(info.min, info.max + 1, shape, dtype=DTYPES[sew])


# ---------------------------------------------------------------------------
# Element-wise kernels: XOR / ADD / MUL / ReLU / Leaky-ReLU
# ---------------------------------------------------------------------------

_EW_OPS: dict[str, Callable] = {
    "xor": lambda a, b: a ^ b,
    "add": lambda a, b: a + b,
    "mul": lambda a, b: a * b,
}


def build_elementwise(op_name: str, sew: int, caesar_bytes: int = 8 * 1024,
                      carus_bytes: int = 10 * 1024, seed: int = 0) -> KernelBuild:
    fn = _EW_OPS[op_name]
    rng = _rng(seed)

    def make(nbytes, engine):
        n = nbytes // (sew // 8)
        a, b = _rand(rng, n, sew), _rand(rng, n, sew)

        def kfn(t, x, y):
            # operands in opposite banks: one op per 2 cycles sustained
            t.store(fn(t.load(x, bank=0), t.load(y)))

        eb, oracle = _traced_build(kfn, (a, b), engine, sew)
        return eb, oracle, n

    cz, orc_c, _ = make(caesar_bytes, "caesar")
    kz, orc_k, n_out = make(carus_bytes, "carus")
    # oracles differ per engine (different sizes); stored per-engine
    return _kernel_build(op_name, sew, (cz, orc_c), (kz, orc_k, n_out))


def build_relu(sew: int, caesar_bytes: int = 8 * 1024,
               carus_bytes: int = 16 * 1024, seed: int = 1,
               leaky_shift: int = 0) -> KernelBuild:
    """ReLU (leaky_shift=0) or Leaky-ReLU with slope 2^-shift.

    Trick used on both engines: leaky_relu(x) = max(x, x >> shift) for
    arithmetic right shift — for shift=0 this degenerates to plain max(x, x)
    so plain ReLU uses max(x, 0) instead (1 op/word)."""
    rng = _rng(seed)
    name = "relu" if leaky_shift == 0 else "leaky_relu"

    def make(nbytes, engine):
        n = nbytes // (sew // 8)
        x = _rand(rng, n, sew)

        def kfn(t, xa):
            xv = t.load(xa)
            t.store(xv.max(0) if leaky_shift == 0
                    else xv.max(xv >> leaky_shift))

        eb, oracle = _traced_build(kfn, (x,), engine, sew)
        return eb, oracle, n

    cz, orc_c, _ = make(caesar_bytes, "caesar")
    kz, orc_k, n_out = make(carus_bytes, "carus")
    return _kernel_build(name, sew, (cz, orc_c), (kz, orc_k, n_out))


def build_axpy(sew: int, caesar_bytes: int = 2 * 1024,
               carus_bytes: int = 8 * 1024, seed: int = 5) -> KernelBuild:
    """Fused multiply-add over full vectors: out = c0 + w * x.

    Written naively — no bank placement hints, accumulator loaded as a
    plain operand — so its lowering carries exactly the slack the IR
    optimizer (repro_torch.nmc.opt, DESIGN.md §13) is built to reclaim: on
    NM-Carus the multi-use accumulator forces a VMV register copy that
    copy-coalescing deletes; on NM-Caesar all three operands land in one
    bank and bank-aware placement rehomes one span."""
    rng = _rng(seed)

    def make(nbytes, engine):
        n = nbytes // (sew // 8)
        c0, w, x = (_rand(rng, n, sew) for _ in range(3))

        def kfn(t, c0a, wa, xa):
            t.store(_mac(t.load(c0a), t.load(wa), t.load(xa)))

        eb, oracle = _traced_build(kfn, (c0, w, x), engine, sew)
        return eb, oracle, n

    cz, orc_c, _ = make(caesar_bytes, "caesar")
    kz, orc_k, n_out = make(carus_bytes, "carus")
    return _kernel_build("axpy", sew, (cz, orc_c), (kz, orc_k, n_out))


# ---------------------------------------------------------------------------
# Quantized ReLU + unsigned clamp: the registry's heterogeneous kernel
# ---------------------------------------------------------------------------

def qrelu_case(sew: int, rows: int = 8, row_bytes: int = 128,
               seed: int = 11) -> tuple:
    """The qrelu kernel function and its inputs: ``rows`` independent
    activation rows, all but the last requantized through the affine ReLU
    ``max(3x + 1, 0)`` (bus-expressible), the last clamped with the
    *unsigned* ``minu`` cap — an op NM-Caesar's bus ALU does not have
    (``OpSpec("minu", None, ...)``), so that one row's shard is
    Carus-only while the rest lower on either engine.  This is the
    deliberately heterogeneous tape the wave scheduler (DESIGN.md §14)
    splits into a mixed Caesar+Carus wave.  Returns ``(kfn, args)``."""
    rng = _rng(seed)
    n = row_bytes // (sew // 8)
    X = _rand(rng, (rows, n), sew)
    cap = (1 << (sew - 2)) - 1       # positive at every SEW; actually clamps

    def kfn(t, X):
        vals = [t.load(X[r]) for r in range(rows)]
        for r in range(rows - 1):
            t.store((vals[r] * 3 + 1).max(0))
        t.store(vals[rows - 1].minu(cap))

    return kfn, (X,)


def build_qrelu(sew: int, rows: int = 8, row_bytes: int = 128,
                seed: int = 11) -> KernelBuild:
    """Single-tile registry build of :func:`qrelu_case`.  The whole tape
    is Carus-only (the ``minu`` row), so ``caesar`` is ``None`` — Table V
    sweeps exclude it (no paper CPU baseline); it exists for the
    heterogeneous scheduling path, where the *rows-split* wave runs its
    bus-expressible shards on Caesar."""
    kfn, args = qrelu_case(sew, rows=rows, row_bytes=row_bytes, seed=seed)
    eb, oracle = _traced_build(kfn, args, "carus", sew)
    eb.oracle, eb.n_outputs = oracle, oracle.size
    eb.engine, eb.sew = "carus", sew
    return KernelBuild("qrelu", sew, oracle.size, oracle, None, eb)


# ---------------------------------------------------------------------------
# Matmul / GEMM:  A[8,8] x B[8,P]  (Table V footnotes b, c)
# ---------------------------------------------------------------------------

CAESAR_MATMUL_P = {32: 128, 16: 256, 8: 512}
CARUS_MATMUL_P = {32: 256, 16: 512, 8: 1024}


def build_matmul(sew: int, p: int | None = None, seed: int = 2,
                 gemm: bool = False, alpha: int = 3, beta: int = 2,
                 shift: int = 4) -> KernelBuild:
    """C = A@B (matmul) or C = (alpha*(A@B) >> s) + (beta*C0 >> s) (gemm,
    fixed-point scaling by powers-of-two-normalized integer constants)."""
    rng = _rng(seed)
    m, k = 8, 8

    def make(P, engine):
        A = _rand(rng, (m, k), sew)
        B = _rand(rng, (k, P), sew)
        C0 = _rand(rng, (m, P), sew) if gemm else np.zeros((m, P), DTYPES[sew])

        def kfn(t, A, B, C0):
            # A entries are scalar taps (EMVX reads / splat words); B rows
            # are resident vectors — the first tap is a mul, the rest
            # accumulate (MAC_INIT/MAC/MAC_STORE on Caesar, in-place
            # VMUL/VMACC.vx on Carus)
            a = t.consts(A)
            rows = [t.load(B[r]) for r in range(k)]
            c0 = [t.load(C0[r]) for r in range(m)] if gemm else None
            for i in range(m):
                acc = None
                for kk in range(k):
                    acc = _mac(acc, a[i, kk], rows[kk])
                if gemm:
                    acc = ((acc * alpha) >> shift) + ((c0[i] * beta) >> shift)
                t.store(acc)

        eb, oracle = _traced_build(kfn, (A, B, C0), engine, sew)
        return eb, oracle, m * P

    cz, orc_c, _ = make(p or CAESAR_MATMUL_P[sew], "caesar")
    kz, orc_k, n_out = make(p or CARUS_MATMUL_P[sew], "carus")
    return _kernel_build("gemm" if gemm else "matmul", sew,
                         (cz, orc_c), (kz, orc_k, n_out))


# ---------------------------------------------------------------------------
# 2D convolution:  A[8,n] (*) F[f,f], 'valid' (Table V footnote d)
# ---------------------------------------------------------------------------

CAESAR_CONV = {32: (64, 3), 16: (64, 4), 8: (128, 4)}   # (n, f)
CARUS_CONV = {32: (256, 3), 16: (512, 3), 8: (1024, 3)}


def build_conv2d(sew: int, n: int | None = None, f: int | None = None,
                 seed: int = 3) -> KernelBuild:
    rng = _rng(seed)
    rows = 8

    def make(nn, ff, engine):
        A = _rand(rng, (rows, nn), sew)
        F = _rand(rng, (ff, ff), sew)
        out_r, out_c = rows - ff + 1, nn - ff + 1

        def kfn(t, A, F):
            # filter taps as scalar consts; column offsets via slide_down —
            # VSLIDEDOWN on Carus, host-prepared byte-shifted replicas on
            # Caesar (slides of loaded values lower to data replication)
            fw = t.consts(F)
            av = [t.load(A[r]) for r in range(rows)]
            sh = {(dj, r): av[r].slide_down(dj)
                  for dj in range(1, ff) for r in range(rows)}
            for i in range(out_r):
                acc = None
                for di in range(ff):
                    for dj in range(ff):
                        src = av[i + di] if dj == 0 else sh[(dj, i + di)]
                        acc = _mac(acc, fw[di, dj], src)
                t.store(acc, n=out_c)     # 'valid' width

        eb, oracle = _traced_build(kfn, (A, F), engine, sew)
        return eb, oracle, out_r * out_c

    nn_c, ff_c = (n, f) if n else CAESAR_CONV[sew]
    nn_k, ff_k = (n, f) if n else CARUS_CONV[sew]
    cz, orc_c, _ = make(nn_c, ff_c, "caesar")
    kz, orc_k, n_out = make(nn_k, ff_k, "carus")
    return _kernel_build("conv2d", sew, (cz, orc_c), (kz, orc_k, n_out))


# ---------------------------------------------------------------------------
# Max pooling 2x2 stride 2 (vertical on NMC, horizontal on host — Sec. V-B1)
# ---------------------------------------------------------------------------

def build_maxpool(sew: int, caesar_bytes: int = 8 * 1024,
                  carus_bytes: int = 16 * 1024, seed: int = 4,
                  width: int = 128) -> KernelBuild:
    rng = _rng(seed)

    def pool_oracle(X):
        v = np.maximum(X[0::2], X[1::2])
        return np.maximum(v[:, 0::2], v[:, 1::2]).astype(DTYPES[sew])

    # host-side horizontal-pool cycle cost per output (fitted to Table V;
    # see EXPERIMENTS.md §Paper-validation for the residuals).  Sub-word
    # widths need lane extraction/repacking on the host (~16 cycles/output);
    # 32-bit is a plain load/load/max/store (~4 cycles/output).
    horiz_cpu = {8: 15.6, 16: 17.2, 32: 4.2}[sew]
    horiz_ecpu = {8: 10.0, 16: 11.3, 32: 13.2}[sew]

    def make(nbytes, engine):
        n = nbytes // (sew // 8)
        rows_n = n // width
        X = _rand(rng, (rows_n, width), sew)
        oracle = pool_oracle(X)
        n_out = (rows_n // 2) * (width // 2)
        even = np.ascontiguousarray(X[0::2]).reshape(-1)
        odd = np.ascontiguousarray(X[1::2]).reshape(-1)

        def kfn(t, e, o):
            # vertical stage on the NMC engine (even rows bank 0, odd rows
            # bank 1 on Caesar: no same-bank conflicts)
            t.store(t.load(e, bank=0).max(t.load(o)))

        def horiz(v):
            v = np.asarray(v).reshape(rows_n // 2, width)
            return np.maximum(v[:, 0::2], v[:, 1::2]).astype(DTYPES[sew])

        hc = n_out * (horiz_cpu if engine == "caesar" else horiz_ecpu)
        eb, _vert = _traced_build(kfn, (even, odd), engine, sew,
                                  host_cycles=hc, post_wrap=horiz)
        return eb, oracle, n_out

    cz, orc_c, _ = make(caesar_bytes, "caesar")
    kz, orc_k, n_out = make(carus_bytes, "carus")
    # engine oracles: the full pooled output (vertical stage on the NMC
    # engine + horizontal host stage applied by the composed post)
    return _kernel_build("maxpool", sew, (cz, orc_c), (kz, orc_k, n_out))


# ---------------------------------------------------------------------------

def build(name: str, sew: int, **kw) -> KernelBuild:
    if name in _EW_OPS:
        return build_elementwise(name, sew, **kw)
    if name == "relu":
        return build_relu(sew, **kw)
    if name == "leaky_relu":
        return build_relu(sew, leaky_shift=kw.pop("leaky_shift", 2), **kw)
    if name == "matmul":
        return build_matmul(sew, **kw)
    if name == "gemm":
        return build_matmul(sew, gemm=True, **kw)
    if name == "conv2d":
        return build_conv2d(sew, **kw)
    if name == "maxpool":
        return build_maxpool(sew, **kw)
    if name == "axpy":
        return build_axpy(sew, **kw)
    if name == "qrelu":
        return build_qrelu(sew, **kw)
    raise KeyError(name)


# the paper's Table V kernel set — these have published CPU baselines
# (constants.CPU_CYCLES_PER_OUTPUT) and throughput/energy reference rows
TABLE_V_KERNELS = ("xor", "add", "mul", "matmul", "gemm", "conv2d", "relu",
                   "leaky_relu", "maxpool")
# the full registry: Table V plus kernels added for the optimizer (axpy is
# deliberately naive — it exhibits the slack opt="O1" reclaims — and has no
# paper CPU baseline, so Table V sweeps exclude it)
ALL_KERNELS = TABLE_V_KERNELS + ("axpy",)
# kernels whose tape is deliberately heterogeneous (some store cones
# bus-expressible, some Carus-only) — built for the mixed-engine wave
# scheduler (DESIGN.md §14); excluded from ALL_KERNELS sweeps because
# they carry no per-engine build pair (qrelu's ``caesar`` is None)
HETERO_KERNELS = ("qrelu",)


# ---------------------------------------------------------------------------
# Execution helpers (used by tests and benchmarks) — all engine dispatch goes
# through the unified IR (repro_torch.nmc); the engines only ever see Programs.
# ---------------------------------------------------------------------------

def run_build(eb: EngineBuild, sew: int | None = None,
              backend: str = "auto") -> np.ndarray:
    """Execute one EngineBuild on its functional engine; return outputs
    (elements, with the host-side ``post`` stage applied).  ``sew`` overrides
    the build's own tag (needed for hand-constructed untagged builds);
    ``backend`` picks the engine implementation (the card by default)."""
    from repro_torch.nmc.engine import get_engine

    prog = eb.program if sew is None else eb.program.with_sew(sew)
    engine = get_engine(prog.engine, backend)
    final = engine.run(engine.init_state(eb.mem), prog)
    elems = engine.extract(final, eb.out_slice, prog.sew)
    return eb.post(elems) if eb.post else elems


def run_caesar(kb: KernelBuild, backend: str = "auto") -> np.ndarray:
    """Execute the Caesar build on the functional engine; return outputs."""
    return run_build(kb.caesar, kb.sew, backend)


def run_carus(kb: KernelBuild, backend: str = "auto") -> np.ndarray:
    """Execute the Carus build on the VPU engine; return outputs."""
    return run_build(kb.carus, kb.sew, backend)


def _matches_oracle(got: np.ndarray, eb: EngineBuild) -> bool:
    exp = np.asarray(eb.oracle).reshape(-1)
    return bool((got.reshape(-1)[:exp.size] == exp).all())


def verify(kb: KernelBuild, backend: str = "auto") -> dict[str, bool]:
    """Run both engines and compare against their oracles (bit-exact)."""
    return {engine: _matches_oracle(
                run_build(getattr(kb, engine), backend=backend),
                getattr(kb, engine))
            for engine in ("caesar", "carus")}


def verify_sweep(kbs: list[KernelBuild], pool=None) -> dict:
    """Batched functional verification of a whole kernel sweep.

    Dispatches every (kernel, sew, engine) instance through one
    :class:`repro_torch.nmc.pool.BucketedPool` (or any pool the caller hands in),
    so programs sharing an ``(engine, sew, instr-bucket)`` — e.g. the whole
    elementwise family at one SEW, or ragged matmul P-sweeps — share a
    single executor and run as one multi-tile wave.  Returns
    ``{(name, sew): {engine: ok}}`` — bit-exact against the same oracles as
    the single-instance :func:`verify`.
    """
    from repro_torch.nmc.pool import BucketedPool

    pool = pool if pool is not None else BucketedPool()
    builds, keys = [], []
    for kb in kbs:
        for engine in ("caesar", "carus"):
            eb = getattr(kb, engine)
            if eb is not None:
                builds.append(eb)
                keys.append((kb.name, kb.sew, engine))
    outs = pool.run_builds(builds)
    results: dict = {}
    for (name, sew, engine), eb, got in zip(keys, builds, outs):
        # AND-combine: a sweep may hold several instances of one (name, sew)
        # — e.g. fig12's matmul P-sweep — and every one must be bit-exact.
        slot = results.setdefault((name, sew), {})
        slot[engine] = slot.get(engine, True) and _matches_oracle(got, eb)
    return results
