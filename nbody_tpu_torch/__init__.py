"""nbody_tpu_torch — the N-body precision-study framework on PyTorch + CUDA.

A port of ``nbody_tpu`` (JAX on a TPU, kept beside it as the reference)
to PyTorch on an NVIDIA H100. Each TPU kernel on a ported path becomes a
hand-written CUDA kernel for Hopper under ``csrc/``, built with nvcc at
first use (``_build.py``). This package imports ``torch`` and never
``jax``.

Ported so far: the direct engine's precision-ladder compare
(``python -m nbody_tpu_torch --stars 5000 --ticks 2000 --compare
float64,int4``). ROADMAP.md lists what waits.
"""

__version__ = "0.1.0"
