"""PyTorch/CUDA port of ``blvm_tpu`` for NVIDIA Hopper (H100).

The JAX package ``blvm_tpu`` is the reference; this package mirrors its module
paths (``blvm_tpu/x/y.py`` <-> ``blvm_tpu_torch/x/y.py``), keeps its (B, T, C)
channels-last layout and flax parameter names, and never imports JAX. Host code
that ``blvm_tpu`` shares with the reference (metrics, tracker, transforms,
receptive-field arithmetic) is carried here as its own copy, because importing
anything from ``blvm_tpu`` imports JAX.

Hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc`` on first
use (:mod:`blvm_tpu_torch.ops.cuda`). Each kernel's wrapper runs its plain
PyTorch twin for CPU tensors and launches the kernel (or raises) for CUDA
tensors.
"""

__version__ = "0.1.0"
