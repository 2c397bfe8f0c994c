"""The LM-layer kernels (Layer B): ``nmc_matmul`` (W8A8 with a fused
epilogue) and ``flash_attention``, each a hand-written CUDA kernel with its
plain PyTorch version beside it, the oracles in :mod:`ref`, and the
dispatching entry points in :mod:`ops`.  Nothing is built at import time."""

from repro_torch.kernels import flash_attention, nmc_matmul, ops, ref

#: the kernel wrappers; each counts its launches in ``.launches``
KERNELS = (nmc_matmul.nmc_matmul, flash_attention.flash_attention)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "flash_attention", "nmc_matmul", "ops", "ref",
           "reset_launch_counts"]
