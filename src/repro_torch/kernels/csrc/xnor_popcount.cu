// XNOR-popcount binarized matmul for Hopper (sm_90a): the FINN-style BNN
// baseline's layer.  a (B, W) x w (O, W) packed words -> (B, O) int32,
// out[b, o] = 2 * (popcount(~(a[b] ^ w[o])) - (W * 32 - n_bits)) - n_bits:
// the dot of the {-1, +1} vectors the bits encode, with the zero padding
// bits of the last word (they match) taken out again.
//
// Replaces the Pallas TPU kernel repro/kernels/xnor_popcount.py:
// _xnor_kernel (launched by xnor_popcount).  The TPU version pads W to a
// multiple of its word block and corrects with the padded width; here W is
// not padded and the correction uses W itself, which gives the same
// integers.  The TPU grid's sequential word axis is the loop over words.
//
// Bounds on the H100: B x O x W population counts (16 per SM per clock on
// compute capability 9.0, a quarter of the 32-bit integer rate) against
// (B + O) x W x 4 bytes in and B x O x 4 out; at the BNN's 784-256 layer
// and batch 10,000 the counts bound it.  The design is the simplest
// that keeps both in check: one thread per (b, o) with the warp's 32
// lanes on 32 consecutive outputs o of one sample b, so a's word is one
// broadcast load per warp and the 32 weight rows (32 x W words) stay in L1
// across the word loop.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileO = 32;
constexpr int kTileB = 8;

__global__ void xnor_popcount_kernel(const uint32_t* __restrict__ a,
                                     const uint32_t* __restrict__ w,
                                     int32_t* __restrict__ out, int b_total,
                                     int o_total, int n_words, int n_bits) {
  const int o = blockIdx.x * kTileO + threadIdx.x;
  const int b = blockIdx.y * kTileB + threadIdx.y;
  if (o >= o_total || b >= b_total) return;
  const uint32_t* ar = a + static_cast<size_t>(b) * n_words;
  const uint32_t* wr = w + static_cast<size_t>(o) * n_words;
  int pop = 0;
  for (int i = 0; i < n_words; ++i) pop += __popc(~(__ldg(ar + i) ^ __ldg(wr + i)));
  const int matches = pop - (n_words * 32 - n_bits);
  out[static_cast<size_t>(b) * o_total + o] = 2 * matches - n_bits;
}

}  // namespace

extern "C" int xnor_popcount_launch(const uint32_t* a, const uint32_t* w,
                                    int32_t* out, int b_total, int o_total,
                                    int n_words, int n_bits, void* stream) {
  if (b_total <= 0 || o_total <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kTileO, kTileB);
  const dim3 grid((o_total + kTileO - 1) / kTileO, (b_total + kTileB - 1) / kTileB);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
  xnor_popcount_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      a, w, out, b_total, o_total, n_words, n_bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* xnor_popcount_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
