"""The port's NM-Carus eCPU (RV32E interpreter + xvnmc offload, and the
assembler) against the JAX reference: the same assembled words, and after
running them the same VRF, GPRs, VL, retired counts and unified-IR issue
trace; the trace replays on the plain PyTorch tile pool to the eager
VRF.  Inputs are made with numpy from a seed and handed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import carus as ref_carus
from repro.core import ecpu as ref_ecpu
from repro_torch import nmc
from repro_torch.core import ECpu, CarusVPU, alu, assemble
from repro_torch.core import ecpu

INDIRECT_LOOP = """
    li   a0, 4
    li   t0, 1024
    vsetvli t1, t0, e8
    li   t2, 0x00140A00
    li   a1, 0x00010101
    li   t1, 0
loop:
    xvnmc.vaddr.vv t2
    add  t2, t2, a1
    addi t1, t1, 1
    blt  t1, a0, loop
    halt
"""

MIXED = """
    li   t0, 300
    vsetvli t1, t0, e16
    xvnmc.vmul.vv v20, v1, v2
    li   a2, -7
    xvnmc.vmacc.vx v20, v3, a2
    xvnmc.vslidedown.vi v21, v20, 3
    xvnmc.vslideup.vi v22, v20, 2
    xvnmc.vmaxu.vv v23, v1, v2
    xvnmc.vsra.vi v24, v1, 2
    li   a3, 17
    li   a4, 12345
    xvnmc.emvv v25, a3, a4
    xvnmc.emvx a5, v20, a3
    sw   a5, 512(zero)
    lw   s0, 512(zero)
    sub  s1, s0, a2
    slli s1, s1, 3
    li   t0, 2048
    vsetvli t1, t0, e32
    xvnmc.vand.vv v26, v25, v5
    bge  s1, zero, done
    xvnmc.vadd.vi v27, v26, 5
done:
    halt
"""

SOURCES = {"indirect-loop": INDIRECT_LOOP, "mixed": MIXED}


def _vrf(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-2 ** 31, 2 ** 31, (32, 256)).astype(np.int32)


def _run_both(src, seed):
    vrf = _vrf(seed)
    words = ref_ecpu.assemble(src)
    want = ref_ecpu.ECpu(ref_carus.CarusVPU(), jnp.asarray(vrf))
    want.load_program(words)
    want.run()
    got = ECpu(CarusVPU(), torch.from_numpy(vrf.copy()))
    got.load_program(assemble(src))
    got.run()
    return vrf, want, got


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_assembler_words_match_reference(name):
    assert assemble(SOURCES[name]) == ref_ecpu.assemble(SOURCES[name])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_run_matches_reference(name, seed):
    _, want, got = _run_both(SOURCES[name], seed)
    assert isinstance(got.vrf, torch.Tensor)
    assert np.array_equal(got.vrf.numpy(), np.asarray(want.vrf))
    assert got.x == want.x
    assert (got.pc, got.vl, got.sew) == (want.pc, want.vl, want.sew)
    assert (got.scalar_retired, got.vector_retired) == \
        (want.scalar_retired, want.vector_retired)
    assert got.emem.tobytes() == want.emem.tobytes()
    assert got.program().entries.tobytes() == \
        want.program().entries.tobytes()


def test_indirect_loop_adds_and_replays_on_the_pool():
    """The Section III-B1 loop: four indirect vadds over bank-aligned
    registers; the issue trace replays on the tile pool to the eager VRF."""
    rng = np.random.default_rng(1)
    a = rng.integers(-128, 128, 4096, dtype=np.int8)
    b = rng.integers(-128, 128, 4096, dtype=np.int8)
    vrf = np.zeros((32, 256), np.int32)
    for i in range(4):
        vrf[i] = alu.pack_np(a[i * 1024:(i + 1) * 1024])
        vrf[10 + i] = alu.pack_np(b[i * 1024:(i + 1) * 1024])
    cpu = ECpu(CarusVPU(), vrf, device="cpu")
    cpu.load_program(assemble(INDIRECT_LOOP))
    cpu.run()
    got = np.concatenate([alu.unpack_np(cpu.vrf[20 + i].numpy(), np.int8)
                          for i in range(4)])
    assert (got == a + b).all()
    assert cpu.vector_retired == 5          # vsetvli + 4 vadd
    prog = cpu.program()
    assert isinstance(prog, nmc.Program) and prog.n_instr == 5
    (final,) = nmc.TilePool(backend="torch").run([prog], [vrf])
    assert np.array_equal(np.asarray(final), cpu.vrf.numpy())


def test_array_vrf_goes_to_the_card_unless_the_cpu_is_asked_for():
    """An array-like VRF lands on the card by default, as the port's other
    entry points do: without a card that raises, and ``device="cpu"`` is
    the explicit opt-in.  A tensor VRF stays where it is."""
    vrf = np.zeros((32, 256), np.int32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ECpu(CarusVPU(), vrf)
    assert ECpu(CarusVPU(), vrf, device="cpu").vrf.device.type == "cpu"
    t = torch.zeros((32, 256), dtype=torch.int32)
    assert ECpu(CarusVPU(), t).vrf is t


def test_halt_and_errors():
    cpu = ECpu(CarusVPU(), np.zeros((32, 256), np.int32), device="cpu")
    cpu.load_program(assemble("loop:\n addi t0, t0, 1\n j loop"))
    with pytest.raises(RuntimeError, match="halt"):
        cpu.run(max_steps=50)
    with pytest.raises(ValueError, match="mnemonic"):
        assemble("frobnicate x1, x2")
    with pytest.raises(ValueError, match="opcode"):
        cpu.step(0x0000000B)
    assert ecpu.N_GPRS == ref_ecpu.N_GPRS
