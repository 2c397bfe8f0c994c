"""The port's NMC engines against the JAX reference's scan engines, bit for
bit: the per-opcode conformance matrix, a seeded random-program fuzzer over
every opcode and operand mode, the batched (wave) executors, and the CPU
path of the CUDA kernel wrappers.  The reference is pinned to
``backend="scan"``; the port runs ``backend="torch"``."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_engines as te
from repro.core.caesar import CaesarEngine as RefCaesar
from repro.core.carus import CarusVPU as RefCarus
from repro.nmc import engine as ref_engine
from repro.nmc.program import Program as RefProgram
from repro_torch.core import isa
from repro_torch.core.caesar import CaesarEngine
from repro_torch.core.carus import CarusVPU
from repro_torch.nmc import conformance, cuda_engine, engine
from repro_torch.nmc.carry import program_from_reference, state_from_reference
from repro_torch.nmc.program import Program, carus_entry

SEWS = (8, 16, 32)
CSRC = pathlib.Path(engine.__file__).resolve().parents[1] / "csrc"


def _ref_run(eng: str, sew: int, entries, state):
    prog = RefProgram.from_entries(eng, sew, entries)
    ref = ref_engine.get_engine(eng, "scan")
    return prog, np.asarray(ref.run(ref.init_state(state), prog))


def test_golden_cases_are_the_reference_matrix():
    mine = conformance.golden_cases()
    assert [(e, l) for e, l, _ in mine] == \
        [(e, l) for e, l, _ in te.CONFORMANCE_CASES]
    for (_, _, a), (_, _, b) in zip(mine, te.CONFORMANCE_CASES):
        assert np.array(a).tobytes() == np.array(b).tobytes()
    assert conformance.CONF_BUCKET == te.CONF_BUCKET
    for eng in ("caesar", "carus"):
        for sew in SEWS:
            assert (conformance.golden_state(eng, sew)
                    == te._conformance_state(eng, sew)).all()


@pytest.mark.parametrize("engine_name,label,entries", te.CONFORMANCE_CASES,
                         ids=[f"{e}-{l}" for e, l, _ in te.CONFORMANCE_CASES])
@pytest.mark.parametrize("sew", SEWS)
def test_conformance_matches_scan_reference(engine_name, label, entries, sew):
    state = te._conformance_state(engine_name, sew)
    ref_prog, want = _ref_run(engine_name, sew, entries, state)
    prog = program_from_reference(engine_name, sew,
                                  ref_prog.pad_to(te.CONF_BUCKET).entries)
    eng = engine.get_engine(engine_name, "torch")
    assert isinstance(eng, engine.Engine)
    got = eng.run(state_from_reference(engine_name, state), prog).numpy()
    assert got.shape == want.shape
    assert (got == want).all(), (engine_name, label, sew,
                                 np.argwhere(got != want)[:8].tolist())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sew", SEWS)
def test_caesar_fuzz_matches_scan_reference(sew, seed):
    """Random waves over the whole bus-op set: final image, MAC and DOT
    accumulators of every tile equal the reference's."""
    progs, states = conformance.random_wave("caesar", sew, 3, 48, seed)
    mem, mac, dot = CaesarEngine().run_stream(
        torch.as_tensor(states), _stack(progs), sew)
    for t, p in enumerate(progs):
        stream = {k: jnp.asarray(v) for k, v in p.lower_np().items()}
        rm, rmac, rdot = RefCaesar().run_stream(jnp.asarray(states[t]),
                                                stream, sew)
        assert (mem[t].numpy() == np.asarray(rm)).all(), (sew, seed, t)
        assert int(mac[t]) == int(rmac) and int(dot[t]) == int(rdot)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sew", SEWS)
def test_carus_fuzz_matches_scan_reference(sew, seed):
    """Random waves over every xvnmc opcode and mode — slides with wrapping
    offsets, EMVV/EMVX at negative indices, indirect addressing, VSETVL to
    negative or oversized lengths: final VRF, VL and the EMVX outputs of
    every tile equal the reference's."""
    progs, states = conformance.random_wave("carus", sew, 3, 48, seed)
    vrf, vl, outs = CarusVPU().run_trace(torch.as_tensor(states),
                                         _stack(progs), sew)
    for t, p in enumerate(progs):
        trace = {k: jnp.asarray(v) for k, v in p.lower_np().items()}
        rv, rvl, routs = RefCarus().run_trace(jnp.asarray(states[t]), trace,
                                              sew)
        assert (vrf[t].numpy() == np.asarray(rv)).all(), (sew, seed, t)
        assert int(vl[t]) == int(rvl)
        assert (outs[t].numpy() == np.asarray(routs)).all()


def _stack(progs):
    fields = progs[0].field_map()
    return {k: torch.as_tensor(np.stack([p.entries[ir] for p in progs]))
            for k, ir in fields}


@pytest.mark.parametrize("engine_name", ["caesar", "carus"])
@pytest.mark.parametrize("sew", SEWS)
def test_wave_wrappers_on_cpu_equal_per_tile_reference(engine_name, sew):
    """``caesar_wave`` / ``carus_wave`` on CPU tensors run the plain
    version, update the image in place, and equal the reference tile by
    tile; the torch engine's batched executor leaves its input alone."""
    progs, states = conformance.random_wave(engine_name, sew, 4, 32, 7)
    fields = {k: v.to(torch.int32) for k, v in _stack(progs).items()}
    wave = (cuda_engine.caesar_wave if engine_name == "caesar"
            else cuda_engine.carus_wave)
    before = wave.launches
    image = torch.as_tensor(states.copy())
    out = wave(fields, image, sew)
    assert out.data_ptr() == image.data_ptr()          # in place
    assert wave.launches == before                      # no kernel on CPU
    batched = engine.get_engine(engine_name, "torch").batched_fn(sew, 4)
    inp = torch.as_tensor(states.copy())
    assert (batched(inp, fields) == image).all()
    assert (inp.numpy() == states).all()
    for t, p in enumerate(progs):
        _, want = _ref_run(engine_name, sew, p.entries, states[t])
        assert (image[t].numpy() == want).all(), (engine_name, sew, t)


def test_indirect_addressing_equals_direct():
    vrf = np.zeros((32, 256), np.int32)
    rng = np.random.default_rng(0)
    vrf[1:3] = rng.integers(-2**31, 2**31, (2, 256), dtype=np.int64)
    base = [carus_entry(isa.VOp.VSETVL, sval1=1000)]
    direct = base + [carus_entry(isa.VOp.VADD, vd=3, vs1=1, vs2=2)]
    indirect = base + [carus_entry(
        isa.VOp.VADD, sval2=isa.pack_indices(3, 2, 1),
        mode=isa.MODE_VV | isa.MODE_INDIRECT)]
    eng = engine.get_engine("carus", "torch")
    outs = [eng.run(eng.init_state(vrf),
                    Program.from_entries("carus", 8, e))
            for e in (direct, indirect)]
    assert (outs[0] == outs[1]).all()


def _cu_enum(stem: str, name: str) -> dict:
    src = (CSRC / f"{stem}.cu").read_text()
    body = re.search(r"enum " + name + r" : int \{(.*?)\};", src, re.S)[1]
    return {k: int(v) for k, v in re.findall(r"(\w+) = (\d+)", body)}


def test_kernel_opcode_tables_match_isa():
    """The CUDA sources spell the opcode ids out; they must be the ISA's."""
    assert _cu_enum("caesar_wave", "CaesarOpId") == \
        {op.name: int(op) for op in isa.CaesarOp}
    assert _cu_enum("carus_wave", "VOpId") == \
        {op.name: isa.COMPACT_ID[op] for op in isa.VOP_COMPACT}
    assert _cu_enum("carus_wave", "Mode") == {
        "MODE_VV": isa.MODE_VV, "MODE_VX": isa.MODE_VX,
        "MODE_VI": isa.MODE_VI, "MODE_INDIRECT": isa.MODE_INDIRECT,
        "MODE_SLIDE1": isa.MODE_SLIDE1}


def test_implementations_registry_is_complete():
    impls = engine.implementations()
    assert set(impls) == {(n, b) for n in ("caesar", "carus")
                          for b in engine.BACKENDS}
    assert engine.BACKENDS == ("torch", "cuda")
    for name, backend in impls:
        eng = engine.get_engine(name, backend)
        assert eng.name == name and eng.backend == backend
        assert isinstance(eng, engine.Engine)


def test_kernel_build_targets_are_keyed_by_source_and_flags(monkeypatch):
    from repro_torch import cuda_build
    srcs = cuda_build.sources()
    assert [s.name for s in srcs] == ["caesar_wave.cu", "carus_wave.cu",
                                      "flash_attention.cu", "nmc_matmul.cu",
                                      "vrf_alu.cu"]
    targets = [cuda_build._target(s) for s in srcs]
    for src, t in zip(srcs, targets):
        assert t.parent.parent == cuda_build.BUILD_DIR
        assert t.name == f"lib{src.stem}.so"
        assert cuda_build._target(src) == t                 # stable
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert all(cuda_build._target(s) != t for s, t in zip(srcs, targets))
