// Block-sparse compiled-schedule TM inference for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sparse_infer.py:
// _sparse_infer_kernel (launched by sparse_tm_forward_tables).  Each unique
// clause of a compiled artifact is a chain of literal ids (its include
// bits); the kernel ANDs the bit-transposed literal rows on the chain and
// folds the fired clauses' multiplicity x polarity votes into int32 class
// sums.  Work scales with the artifact's include count, not with C x W.
//
// What bounds it and what the design does about it: see chain_walk.cuh.
// The TPU kernel's sequential (slab, tile) grid becomes one thread per
// (clause, sample word) that walks its clause's tile range from the CSR
// table; exact early exit keeps an in-order walk per 32-sample slab.  The
// bit transpose of the bucket's literals (jnp glue around the TPU kernel)
// is a first launch on the same stream into a buffer the caller allocates.

#include "chain_walk.cuh"

extern "C" int sparse_infer_launch(
    const uint32_t* lit, int b_total, int w_total, uint32_t* lit_t,
    int sw_total, const int32_t* chain_ids, int jp, const int32_t* votes,
    int n_rows, int k, const int32_t* indptr, int n_cblocks,
    const int32_t* tile_jb, const int32_t* tile_last, const int32_t* margin,
    int block_c, int block_j, int32_t* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = repro_torch::launch_bit_transpose(
      lit, b_total, w_total, sw_total, lit_t, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(repro_torch::launch_chain(
      lit_t, sw_total, chain_ids, jp, votes, n_rows, k, indptr, n_cblocks,
      tile_jb, tile_last, /*tile_off=*/0, margin, block_c, block_j, b_total,
      out, st));
}

extern "C" const char* sparse_infer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
