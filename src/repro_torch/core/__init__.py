"""Core library of the port: the Strassen algebra and matmul routing.

  coefficients  — Strassen/Winograd/naive8 schemes as constant matrices
  strassen      — serial recursive + batched-BFS Strassen
  precision     — the precision names and the TF32 switch per call
  backend       — matmul routing for the on-device kinds
"""
