"""Plain references: the same mathematics as the program, in plain PyTorch.

Nothing here imports the program, JAX or the JAX package: the tests hold
every module of this folder to that.
"""
