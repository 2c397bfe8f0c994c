"""The Layer B kernels: ``nmc_matmul`` (W8A8 with a fused epilogue),
``flash_attention`` and ``vrf_alu`` (the NM-Carus VPU running a
program-as-data), each a hand-written CUDA kernel with its plain PyTorch
version beside it, the oracles in :mod:`ref`, and the dispatching entry
points in :mod:`ops`.  Nothing is built at import time."""

from repro_torch.kernels import flash_attention, nmc_matmul, ops, ref, \
    vrf_alu

#: the kernel wrappers; each counts its launches in ``.launches``
KERNELS = (nmc_matmul.nmc_matmul, flash_attention.flash_attention,
           vrf_alu.vrf_alu)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    flash_attention.flash_attention.launches_by_route = dict.fromkeys(
        flash_attention.ROUTE_ID, 0)
    nmc_matmul.nmc_matmul.launches_by_route = dict.fromkeys(
        nmc_matmul.ROUTE_ID, 0)
    nmc_matmul.nmc_matmul.launches_int32 = 0
    vrf_alu.vrf_alu.launches_by_route = dict.fromkeys(vrf_alu.ROUTE_ID, 0)


__all__ = ["KERNELS", "flash_attention", "nmc_matmul", "ops", "ref",
           "reset_launch_counts", "vrf_alu"]
