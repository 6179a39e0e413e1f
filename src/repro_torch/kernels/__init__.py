"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions, the inference oracles (``ref``) and the dispatch layer (``ops``).

Kernels: fused_infer (dense clause chain + vote fold), sparse_infer
(block-sparse chain schedule), term_infer (two-stage shared-term schedule).
A wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors; ``_build`` compiles the sources at first CUDA use.
"""
