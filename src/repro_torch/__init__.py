"""Stark's Strassen multiply in PyTorch, with hand-written CUDA kernels.

The port of the JAX package ``repro`` to PyTorch on an NVIDIA H100. Module
names and public function names follow ``repro`` so each counterpart is
easy to find; this package never imports JAX or ``repro``.

Every entry point runs on the device of the tensors it is given: on a CUDA
tensor a kernel wrapper launches its kernel (built from ``csrc/`` at first
use) or raises, and on a CPU tensor it computes the kernel's plain PyTorch
version.
"""
