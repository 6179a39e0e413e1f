"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions, the oracles (``ref``) and the dispatch layer (``ops``).

Inference kernels: fused_infer (dense clause chain + vote fold),
sparse_infer (block-sparse chain schedule), term_infer (two-stage
shared-term schedule), clause_eval and class_sum (the unfused dense
pipeline).  Training kernels: fused_train (fire -> feedback -> delta in one
pass) and ta_update (the unfused delta).  xnor_popcount is the BNN
baseline's binarized matmul, flash_attention the LM substrate's causal
attention forward.
A wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors; ``_build`` compiles the sources at first CUDA use.
``autotune`` picks the launches of fused_infer, fused_train, sparse_infer
and term_infer, ranked by ``cost_model``.
"""
