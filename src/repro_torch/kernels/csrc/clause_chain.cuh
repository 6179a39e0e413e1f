// The dense clause chain shared by fused_infer.cu and clause_eval.cu
// (Hopper, sm_90a).
//
// Both kernels replace a Pallas TPU kernel that ANDs every (sample,
// clause) pair's chain over all packed words:
// repro/kernels/fused_infer.py:_fused_infer_kernel (the chain folded with
// the votes into class sums) and repro/kernels/clause_eval.py:
// _clause_fire_kernel (the (B, C) fire matrix).  For a pair,
// viol = OR_w (inc[c, w] & ~lit[b, w]) and the clause fires iff viol == 0
// (an empty clause fires).  This header computes a block's fire bits into
// shared memory; each kernel adds its own epilogue.
//
// What bounds it on the H100: one three-input logic op (LOP3) per sample,
// clause and word, at 64 a clock on each SM (B x C x W: 50.2 M at the
// serve bucket, B 512, C 2000, W 49, 3.0 us at 16.7 T/s), against a few
// hundred KB of operands.  At training's batch 64 the work is an eighth
// of that and the launch itself (~1.15 us empty) is the floor, so there
// latency and a grid that covers the card matter.  The design:
//   * a register-tiled chain: a thread carries kTB x kTC = 4 x 4 viol
//     words.  Per word it loads its 4 literal words and 4 include words
//     as two 16-byte shared loads and does 16 LOP3s: one shared load per
//     8 logic ops, against two per op before.  Lanes are 8
//     sample groups x 4 clause groups, so a warp's loads are broadcasts
//     of 8 and 4 distinct 16-byte vectors from one word row;
//   * shared memory is word-major (lit[w][b], inc[w][c]) with rows padded
//     by 4 words: the 16-byte loads stay aligned, a load's vectors lie on
//     distinct banks, and the staging writes of a warp (8 words x 4 rows)
//     land on 32 distinct banks;
//   * asynchronous staging: chunks of kWCH words come by 4-byte cp.async
//     (rows of W words need not be 16-byte aligned: 49 words is 196
//     bytes), double-buffered, so chunk i + 1 is in flight while chunk i
//     is ANDed; rows out of range are zero-filled by the copy.  A thread
//     makes its copy addresses once (Stager): index math for each copy
//     took more instructions than the chain it fed;
//   * a grid that covers the card: a block is 4 warps over 32 samples and
//     16 x (4 / KS) clauses, and KS warps split the words of each pair
//     (their partial fire bits meet by AND; exact, AND commutes).  The
//     host takes the wide block (KS = 1: 32 x 64) where it still gives at
//     least one block an SM, else KS = 4 (32 x 16): B 512, C 2000: 16 x 32
//     blocks at KS 1; B 64, C 2048: 2 x 128 at KS 4.  A caller may pass
//     the split instead (1, 2 or 4; KS = 2 is 32 x 32): the autotuner
//     times all three (kernels/autotune.py);
//   * every word is ANDed, as the TPU kernel does: no early exit, so the
//     bound's B x C x W stays the work done.
// A block's fire bits end in shared memory as one 16-bit mask a sample
// per warp's 16 clauses (`fired` assembles a sample's block-wide mask).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace clause_chain {

constexpr int kTB = 4;                 // samples a thread
constexpr int kTC = 4;                 // clauses a thread
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// __launch_bounds__'s minimum blocks an SM: caps a thread at 80 registers
// (a fully unrolled chunk otherwise hoists loads up to 128 and spills)
constexpr int kMinBlocks = 6;
constexpr int kBB = 8 * kTB;           // samples a block: 8 lane groups
constexpr int kWCH = 32;               // words a staged chunk
constexpr int kPad = 4;                // words of padding a staged row

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 4 : 0;            // 0: zero-fill, read nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The block's shape for KS warps splitting the words.
template <int KS>
struct Shape {
  static_assert(KS == 1 || KS == 2 || KS == 4, "1, 2 or all 4 warps split the words");
  static constexpr int kWarpsC = kWarps / KS;   // warps along the clauses
  static constexpr int kBC = 4 * kTC * kWarpsC;   // clauses a block
  static constexpr int kPieces = kBC / 16;        // 16-bit fire masks a sample
};

// Shared state of a block: the double-buffered word chunks and the fire
// masks, fire[ks][b][p] for clauses 16p .. 16p + 15 over word share ks.
template <int KS>
struct Tile {
  static constexpr int kBC = Shape<KS>::kBC;
  alignas(16) uint32_t lit[2][kWCH][kBB + kPad];
  alignas(16) uint32_t inc[2][kWCH][kBC + kPad];
  uint16_t fire[KS][kBB][Shape<KS>::kPieces];
};

// One thread's cp.async copies of rows [row0, row0 + R) of a (n_rows,
// w_total) row-major matrix into chunk buffers dst[w][r] (row stride R +
// kPad).  Warp k copies words 8k .. 8k + 7 of a chunk, lane l word 8k + l %
// 8 of rows l / 8 % 4 + 4i: 32-byte runs of global memory, 32 distinct
// banks of shared memory.  The addresses are made once; a chunk adds kWCH
// words.  Rows past n_rows are zero-filled, words past w_total not copied
// (the chain stops before them).
template <int R>
struct Stager {
  static_assert(R % 4 == 0 && kWCH == 8 * kWarps, "a warp copies 8 words of 4i + r");
  const uint32_t* src;                 // row row0 + r, word w of chunk 0
  size_t stride4;                      // 4 rows
  int w, r, rows, w_total;

  __device__ __forceinline__ Stager(const uint32_t* m, int row0, int n_rows, int w_total_)
      : w(8 * (threadIdx.x >> 5) + (threadIdx.x & 7)), r((threadIdx.x >> 3) & 3),
        w_total(w_total_) {
    rows = n_rows - row0 - r;          // row r + 4i exists iff 4i < rows
    stride4 = 4 * static_cast<size_t>(w_total);
    src = m + static_cast<size_t>(row0 + r) * w_total + w;
  }

  __device__ __forceinline__ void copy(uint32_t (*dst)[R + kPad], int ch) const {
    if (ch * kWCH + w >= w_total) return;
    const uint32_t* s = src + ch * kWCH;
#pragma unroll
    for (int i = 0; i < R / 4; ++i) cp_async4(&dst[w][r + 4 * i], s + i * stride4, 4 * i < rows);
  }
};

// A thread's 4 x 4 chain over words [first, wn) of a staged chunk, step KS.
template <int KS>
__device__ __forceinline__ void chain_words(uint32_t (*lit)[kBB + kPad],
                                            uint32_t (*inc)[Shape<KS>::kBC + kPad],
                                            int first, int wn, int b_off, int c_off,
                                            uint32_t (&viol)[kTB][kTC]) {
  auto step = [&](int w) {
    const uint4 l = *reinterpret_cast<const uint4*>(&lit[w][b_off]);
    const uint4 c = *reinterpret_cast<const uint4*>(&inc[w][c_off]);
    const uint32_t lv[kTB] = {l.x, l.y, l.z, l.w};
    const uint32_t cv[kTC] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < kTB; ++i) {
#pragma unroll
      for (int j = 0; j < kTC; ++j) viol[i][j] |= cv[j] & ~lv[i];   // one LOP3
    }
  };
  if (wn == kWCH) {                    // a full chunk: word offsets are immediates
#pragma unroll
    for (int w = 0; w < kWCH; w += KS) step(w + first);
  } else {
#pragma unroll 4
    for (int w = first; w < wn; w += KS) step(w);
  }
}

// The fire bits of the block's kBB samples from b0 by kBC clauses from c0,
// into t.fire; `first` issues further cp.async copies into the first
// chunk's group.  Ends without a barrier: the caller syncs before reading
// t.fire.
template <int KS, class First>
__device__ __forceinline__ void fire_tile(Tile<KS>& t, const uint32_t* __restrict__ lit,
                                          const uint32_t* __restrict__ inc, int b0,
                                          int c0, int b_total, int c_total, int w_total,
                                          First first) {
  constexpr int kBC = Shape<KS>::kBC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wc = warp % Shape<KS>::kWarpsC, ks = warp / Shape<KS>::kWarpsC;
  const int sg = lane & 7, cg = lane >> 3;           // lane = sg + 8 cg
  const int n_chunks = (w_total + kWCH - 1) / kWCH;
  const Stager<kBB> lit_rows(lit, b0, b_total, w_total);
  const Stager<kBC> inc_rows(inc, c0, c_total, w_total);
  auto issue = [&](int ch) {
    if (ch < n_chunks) {
      lit_rows.copy(t.lit[ch & 1], ch);
      inc_rows.copy(t.inc[ch & 1], ch);
    }
  };
  issue(0);
  first();
  cp_async_commit();
  issue(1);
  cp_async_commit();

  uint32_t viol[kTB][kTC];
#pragma unroll
  for (int i = 0; i < kTB; ++i) {
#pragma unroll
    for (int j = 0; j < kTC; ++j) viol[i][j] = 0u;
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<1>();                // this thread's copies of chunk ch
    __syncthreads();                   // everyone's
    chain_words<KS>(t.lit[ch & 1], t.inc[ch & 1], ks, min(kWCH, w_total - ch * kWCH),
                    sg * kTB, wc * 16 + cg * kTC, viol);
    __syncthreads();                   // the buffer is free again
    issue(ch + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // a sample's 16 clauses of this warp: 4 bits from each of 4 lanes
#pragma unroll
  for (int i = 0; i < kTB; ++i) {
    uint32_t m = 0u;
#pragma unroll
    for (int j = 0; j < kTC; ++j) m |= static_cast<uint32_t>(viol[i][j] == 0u) << j;
    m <<= kTC * cg;
    m |= __shfl_xor_sync(0xffffffffu, m, 8);
    m |= __shfl_xor_sync(0xffffffffu, m, 16);
    if (cg == 0) t.fire[ks][sg * kTB + i][wc] = static_cast<uint16_t>(m);
  }
}

// Sample b's fire bits over the block's clauses (bit c: clause c0 + c),
// the word shares ANDed.  Bits past kBC are 0.
template <int KS>
__device__ __forceinline__ uint64_t fired(const Tile<KS>& t, int b) {
  uint64_t m = ~0ull;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint64_t x = 0;
#pragma unroll
    for (int p = 0; p < Shape<KS>::kPieces; ++p) {
      x |= static_cast<uint64_t>(t.fire[ks][b][p]) << (16 * p);
    }
    m &= x;
  }
  return m;
}

// Host side: the word split for a (B, C) launch: 1 where the wide block
// still puts a block on every SM, else 4.
inline int word_split(int b_total, int c_total) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long bt = (b_total + kBB - 1) / kBB;
  return bt * ((c_total + Shape<1>::kBC - 1) / Shape<1>::kBC) >= sms ? 1 : 4;
}

// The word split of a launch: `ks` when the caller passed one (1, 2 or
// 4), else the heuristic above; 0 for any other value.
inline int resolve_split(int ks, int b_total, int c_total) {
  if (ks == 0) return word_split(b_total, c_total);
  return ks == 1 || ks == 2 || ks == 4 ? ks : 0;
}

inline dim3 grid(int b_total, int c_total, int ks) {
  const int bc = Shape<1>::kBC / ks;   // 64, 32 or 16 clauses a block
  return dim3((b_total + kBB - 1) / kBB, (c_total + bc - 1) / bc);
}

// What an occupancy entry point reports of `kernel` launched on `grid`:
// registers, threads, blocks an SM, shared bytes and spill bytes a thread,
// then the grid and the word split.
template <class Kernel>
cudaError_t occupancy(Kernel kernel, dim3 g, int ks, int* info) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  info[0] = a.numRegs;
  info[1] = kThreads;
  info[2] = blocks;
  info[3] = static_cast<int>(a.sharedSizeBytes);
  info[4] = static_cast<int>(a.localSizeBytes);
  info[5] = static_cast<int>(g.x);
  info[6] = static_cast<int>(g.y);
  info[7] = ks;
  return cudaSuccess;
}

}  // namespace clause_chain
