"""cafempc_tpu_torch — the PyTorch / CUDA port of `cafempc_tpu`.

The JAX package beside it is the reference this port is held against;
module names mirror it so every counterpart is easy to find.  This package
imports `torch` and numpy, and nothing of `jax` or of the JAX package: its
host-side numpy modules (`reference/gait.py`, `reference/quad_reference.py`,
`solver/options.py`, `runtime/warm_start.py`) are its own counterparts of
the JAX package's.

Layout conventions: the scenario batch is the leading dimension of every
per-scenario tensor; every tensor is created with an explicit `device` and
`dtype`; the hand-written CUDA kernels (`ops/csrc/`) are built with `nvcc`
at first use and run only on CUDA tensors, while CPU tensors take their
plain PyTorch twins (`ops/sweep.py`, `ops/linroll.py`).
"""

__version__ = "0.1.0"
