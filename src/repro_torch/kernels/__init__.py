"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) and their wrappers.

Each kernel directory holds the wrapper (``<name>.py``), its plain PyTorch
version (``ref.py``) and the public ops (``ops.py``), as in ``repro.kernels``.
"""
