"""PyTorch/CUDA port of repic-tpu's directory consensus.

``repic_tpu`` (JAX on a TPU) stays the reference; this package runs
the same consensus over picker BOX directories with PyTorch on an
NVIDIA Hopper GPU, its three hot loops as hand-written CUDA kernels
(``csrc/``) built with ``nvcc`` at first use.  Every kernel has a
plain PyTorch version beside it, which is what a CPU tensor runs.

The package imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing of ``repic_tpu``.
"""

__version__ = "0.1.0"
