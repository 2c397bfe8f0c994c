"""repro_torch: the NM-Caesar / NM-Carus near-memory computing system on
PyTorch, with its NMC wave kernels written by hand in CUDA for Hopper.

The JAX package ``repro`` is the reference this port is held against; this
package imports neither it nor ``jax``.  Entry points run on the card unless
the caller asks for the CPU (``backend="torch"``)."""

__version__ = "0.1.0"
