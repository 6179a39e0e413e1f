"""PyTorch/CUDA port of the MATADOR Tsetlin machine: training, compiling
and serving.

A package beside ``repro`` (the JAX/Pallas reference) with the same module
layout.  It imports ``torch`` and ``numpy`` only.  Compiled artifacts and
checkpoints written by either package load in the other; training and
inference run through hand-written CUDA kernels for NVIDIA Hopper
(``kernels/csrc``) on a CUDA device and through their plain PyTorch
versions on the CPU.
"""
