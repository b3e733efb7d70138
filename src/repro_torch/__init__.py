"""Stark's Strassen multiply and model serving in PyTorch, with hand-written CUDA kernels.

The port of the JAX package ``repro`` to PyTorch on an NVIDIA H100. Module
names and public function names follow ``repro`` so each counterpart is
easy to find; this package never imports JAX or ``repro``.
``models/sharding.py`` ports the JAX package's logical-axis sharding: under
``use_sharding(mesh)`` the models run on a mesh of positions
(``core/mesh.py``; on one card every position is the card), with the
projections, the attention core and the expert FFN run once per position on
their slabs and the collectives counted in ``mesh.traffic``. With no context
every path runs on the global tensors.

Every entry point runs on the device of the tensors it is given: on a CUDA
tensor a kernel wrapper launches its kernel (built from ``csrc/`` at first
use) or raises, and on a CPU tensor it computes the kernel's plain PyTorch
version.
"""
