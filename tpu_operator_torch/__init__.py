"""PyTorch/CUDA port of ``tpu_operator`` for one NVIDIA H100.

Mirrors the reference package's layout (``ops/``, ``parallel/``, ``utils/``,
``validator/``) so each module has one obvious counterpart there. Importing
it builds nothing: the CUDA kernels under ``csrc/`` are compiled at their
first launch on a CUDA tensor (see ``_native``).
"""

__version__ = "0.1.0"
