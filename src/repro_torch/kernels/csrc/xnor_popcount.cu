// XNOR-popcount binarized matmul for Hopper (sm_90a): the FINN-style BNN
// baseline's layer.  a (B, W) x w (O, W) packed words -> (B, O) int32,
// the dot of the {-1, +1} vectors the first n_bits bits encode:
//
//   dot = n_bits - 2 * pa - 2 * pw + 4 * s,   s = popcount(a & w),
//
// with pa and pw the rows' set bits, all over the first n_bits bits.  It
// equals the plain version's 2 * popcount(~(a ^ w)) - n_bits whenever the
// pad bits past n_bits agree in a and w (pack_bits zeroes them).
//
// Replaces the Pallas TPU kernel repro/kernels/xnor_popcount.py:
// _xnor_kernel (launched by xnor_popcount).  The TPU kernel's sequential
// word axis is the loop over slabs of up to 64 words here.
//
// Bounds on the H100: at the BNN's first layer (B 10,000, W 25, O 256) the
// call moves 11.3 MB (the int32 output is 91% of it), 3.4 us at 3.35 TB/s,
// while its B x O x n_bits one-bit products take 2.0 us on the int8 tensor
// cores' rate; the population-count unit alone would need 15.3 us.  So all
// three sums come from the tensor cores' one-bit product,
// mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc, which reads the packed
// words as they are: s from a and w, pa from a against all ones, pw from
// all ones against w, so no population count runs on the CUDA cores.
//
// A block's 8 warps each take 16 * MT samples x 32 outputs (MT x 4 tiles
// of 16 x 8): side by side along O for wide layers (48 x 256 a block, MT 3:
// B 10,000 is 209 blocks, one wave at 2 blocks an SM), stacked along B for
// narrow ones (256 x 32 at O <= 32, MT 2), so no warp idles at O 10.  The
// block's rows of a and of w come to shared memory by cp.async, as one
// contiguous run in 16-byte copies where they are whole rows (W <= 64
// words; else in 64-word slabs, 4 bytes a copy); the fragments are masked
// in registers (the last word to n_bits, words past W to zero).  The
// epilogue folds in n_bits, pa and pw, and neighbouring lanes swap halves
// so that each stores 4 outputs of one row as a 16-byte word (full 32-byte
// sectors; scalar stores where O is not a multiple of 4).
//
// What bounds it (%globaltimer stamps at the BNN's layers): about 1 us
// from a block's start to its first copies landing, the staging (every
// block reads w's rows), the products, then the stores, which all blocks
// issue once their products are done and which run at the device
// memory's rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 64;   // words staged a pass
// masked fragments read up to 7 words past a slab of rows (the last row's
// words c + 1 up to 8 * ceil(ws / 8) - 1), so the slab is padded by 8
constexpr int kPad = 8;

__device__ __forceinline__ void mma_and_popc(int (&c)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  }
}

// rows [r0, r0 + n) of words [k0, k0 + ws) of a (rows, n_words) matrix into
// dst (n, ws).  flat: ws == n_words and the run starts 16-byte aligned.
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* __restrict__ src,
                                      int r0, int n, int n_words, int k0, int ws,
                                      bool flat) {
  if (flat) {
    const uint32_t* s = src + static_cast<size_t>(r0) * n_words;
    const int total = n * n_words, quads = total / 4;
    for (int i = threadIdx.x; i < quads; i += kThreads) cp_async(dst + 4 * i, s + 4 * i, 16);
    for (int i = 4 * quads + threadIdx.x; i < total; i += kThreads) cp_async(dst + i, s + i, 4);
  } else {
    for (int i = threadIdx.x; i < n * ws; i += kThreads) {
      const int r = i / ws;
      cp_async(dst + i, src + static_cast<size_t>(r0 + r) * n_words + k0 + i - r * ws, 4);
    }
  }
}

// MT: 16-sample tiles a warp; wc: warps side by side along O (1, 2, 4 or
// 8).  A block is 16 * MT * (8 / wc) samples x 32 * wc outputs.
template <int MT>
__global__ void __launch_bounds__(kThreads, 2) xnor_popcount_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ w,
    int32_t* __restrict__ out, int b_total, int o_total, int n_words, int n_bits,
    int wc, int aligned) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int bm = 16 * MT * (kWarps / wc), bn = 32 * wc;
  const int b0 = blockIdx.x * bm, o0 = blockIdx.y * bn;
  const int nb = min(bm, b_total - b0), no = min(bn, o_total - o0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m_base = (warp / wc) * 16 * MT, n_base = (warp % wc) * 32;
  const uint32_t last_mask = n_bits % 32 ? (1u << (n_bits % 32)) - 1u : 0xffffffffu;
  constexpr uint32_t kOnes = 0xffffffffu;

  // s: a & w; pa: a & ones, {pa(row), -, pa(row + 8), -}; pw: ones & w,
  // {pw(col), pw(col + 1), -, -}
  int acc[MT][4][4] = {}, pa[MT][4] = {}, pw[4][4] = {};
  for (int k0 = 0; k0 < n_words; k0 += kSlab) {
    const int ws = min(kSlab, n_words - k0);
    const bool flat = aligned && ws == n_words;
    uint32_t* sa = smem;
    uint32_t* sw = smem + bm * ws;
    __syncthreads();   // the last slab's fragments are read
    stage(sa, a, b0, nb, n_words, k0, ws, flat);
    stage(sw, w, o0, no, n_words, k0, ws, flat);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int ch = 0; ch * 8 < ws; ++ch) {
      // a thread's k slots hold words c and c + 1 of the 8-word chunk, in A
      // and B alike; rows past the edge hold stale words, seen only by
      // outputs that are not stored
      const int c = ch * 8 + 2 * t, gw = k0 + c;
      const uint32_t m0 = gw < n_words ? (gw == n_words - 1 ? last_mask : kOnes) : 0u;
      const uint32_t m1 = gw + 1 < n_words ? (gw + 1 == n_words - 1 ? last_mask : kOnes) : 0u;
      uint32_t af[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const uint32_t* r = sa + (m_base + mi * 16 + g) * ws + c;
        af[mi][0] = r[0] & m0;
        af[mi][1] = r[8 * ws] & m0;
        af[mi][2] = r[1] & m1;
        af[mi][3] = r[8 * ws + 1] & m1;
        mma_and_popc(pa[mi], af[mi][0], af[mi][1], af[mi][2], af[mi][3], kOnes, kOnes);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        if (n_base + nj * 8 < no) {   // warp-uniform
          const uint32_t* r = sw + (n_base + nj * 8 + g) * ws + c;
          const uint32_t b0w = r[0] & m0, b1w = r[1] & m1;
          mma_and_popc(pw[nj], kOnes, kOnes, kOnes, kOnes, b0w, b1w);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            mma_and_popc(acc[mi][nj], af[mi][0], af[mi][1], af[mi][2], af[mi][3], b0w, b1w);
          }
        }
      }
    }
  }

  // acc[mi][nj] = {(row, col), (row, col + 1), (row + 8, col), (row + 8,
  // col + 1)} with row = m_base + mi * 16 + g, col = n_base + nj * 8 + 2t
  const bool vec4 = o_total % 4 == 0;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const int row = m_base + mi * 16 + g;
    const int pa0 = n_bits - 2 * pa[mi][0], pa1 = n_bits - 2 * pa[mi][2];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      if (n_base + nj * 8 >= no) continue;   // warp-uniform
      const int col = n_base + nj * 8 + 2 * t;
      const int pw0 = 2 * pw[nj][0], pw1 = 2 * pw[nj][1];
      const int* s = acc[mi][nj];
      const int d0 = pa0 - pw0 + 4 * s[0], d1 = pa0 - pw1 + 4 * s[1];
      const int d2 = pa1 - pw0 + 4 * s[2], d3 = pa1 - pw1 + 4 * s[3];
      if (vec4) {
        // even t takes row's 4 outputs from col, odd t row + 8's from col - 2
        const bool odd = t & 1;
        const int x0 = __shfl_xor_sync(0xffffffffu, odd ? d0 : d2, 1);
        const int x1 = __shfl_xor_sync(0xffffffffu, odd ? d1 : d3, 1);
        const int b = row + (odd ? 8 : 0), o = col - (odd ? 2 : 0);
        if (b < nb && o < no) {
          *reinterpret_cast<int4*>(out + static_cast<size_t>(b0 + b) * o_total + o0 + o) =
              odd ? make_int4(x0, x1, d2, d3) : make_int4(d0, d1, x0, x1);
        }
      } else {
        int32_t* r0 = out + static_cast<size_t>(b0 + row) * o_total + o0;
        int32_t* r1 = r0 + static_cast<size_t>(8) * o_total;
        if (row < nb) {
          if (col < no) r0[col] = d0;
          if (col + 1 < no) r0[col + 1] = d1;
        }
        if (row + 8 < nb) {
          if (col < no) r1[col] = d2;
          if (col + 1 < no) r1[col + 1] = d3;
        }
      }
    }
  }
}

// warps side by side along O: the fewest 32-output columns that cover O,
// as a power of two, at most 8
int warp_cols(int o_total) {
  int wc = 1;
  while (wc < 8 && 32 * wc < o_total) wc *= 2;
  return wc;
}

// 16-sample tiles a warp: 3 when the warps sit side by side along a wide O
// (48 x 256 a block: B 10,000 fits one wave at 2 blocks an SM), else 2
int m_tiles(int wc) { return wc == kWarps ? 3 : 2; }

int block_rows(int wc) { return 16 * m_tiles(wc) * (kWarps / wc); }

dim3 grid(int b_total, int o_total, int wc) {
  return dim3((b_total + block_rows(wc) - 1) / block_rows(wc),
              (o_total + 32 * wc - 1) / (32 * wc));
}

// a slab of BM + BN <= 304 rows (48 + 256 or 256 + 32 at most): up to 76 KB
int smem_bytes(int n_words, int wc) {
  return ((block_rows(wc) + 32 * wc) * min(n_words, kSlab) + kPad) * 4;
}

// past 48 KB of dynamic shared memory: opt in, on the current device
template <int MT>
cudaError_t opt_in(int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(xnor_popcount_kernel<MT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int MT>
cudaError_t occupancy(int b_total, int o_total, int n_words, int wc, int* info) {
  const int bytes = smem_bytes(n_words, wc);
  cudaError_t err = opt_in<MT>(bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, xnor_popcount_kernel<MT>);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, xnor_popcount_kernel<MT>,
                                                        kThreads, bytes);
  }
  if (err != cudaSuccess) return err;
  const dim3 g = grid(b_total, o_total, wc);
  info[0] = attr.numRegs;
  info[1] = kThreads;
  info[2] = blocks;
  info[3] = bytes;
  info[4] = static_cast<int>(attr.localSizeBytes);
  info[5] = static_cast<int>(g.x);
  info[6] = static_cast<int>(g.y);
  info[7] = wc;
  info[8] = block_rows(wc);
  return cudaSuccess;
}

}  // namespace

extern "C" int xnor_popcount_launch(const uint32_t* a, const uint32_t* w,
                                    int32_t* out, int b_total, int o_total,
                                    int n_words, int n_bits, void* stream) {
  if (b_total <= 0 || o_total <= 0) return static_cast<int>(cudaSuccess);
  const int wc = warp_cols(o_total);
  const dim3 g = grid(b_total, o_total, wc);
  if (g.y > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int bytes = smem_bytes(n_words, wc);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (m_tiles(wc) == 3) {
    err = opt_in<3>(bytes);
    if (err == cudaSuccess) {
      xnor_popcount_kernel<3><<<g, kThreads, bytes, s>>>(a, w, out, b_total, o_total,
                                                         n_words, n_bits, wc, aligned);
    }
  } else {
    err = opt_in<2>(bytes);
    if (err == cudaSuccess) {
      xnor_popcount_kernel<2><<<g, kThreads, bytes, s>>>(a, w, out, b_total, o_total,
                                                         n_words, n_bits, wc, aligned);
    }
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// registers, threads, blocks an SM, dynamic shared bytes, spill bytes a
// thread, then the grid, the warps side by side along O and the samples a
// block at this shape
extern "C" int xnor_popcount_occupancy(int b_total, int o_total, int n_words, int* info) {
  const int wc = warp_cols(o_total);
  return static_cast<int>(m_tiles(wc) == 3 ? occupancy<3>(b_total, o_total, n_words, wc, info)
                                           : occupancy<2>(b_total, o_total, n_words, wc, info));
}

extern "C" const char* xnor_popcount_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
