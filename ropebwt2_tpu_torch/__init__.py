"""ropebwt2_tpu_torch — the PyTorch/CUDA port of ropebwt2_tpu.

Batched BCR construction of the multi-string BWT of a DNA read set on one
NVIDIA H100 (flat int8 tier).  The layout mirrors ``ropebwt2_tpu``: each
module here has its counterpart at the same path there.  The two kernels
on the main path are hand-written CUDA C++ under ``csrc/``, compiled by
``nvcc`` at first use (``_build.py``); on CPU tensors every kernel wrapper
runs its plain PyTorch version instead.

The package imports torch and numpy only — never jax or ropebwt2_tpu.
"""

__version__ = "0.1.0"
