// The batch-summed Tsetlin-automaton delta walk shared by fused_train.cu
// and ta_update.cu (Hopper, sm_90a).
//
// Both kernels replace a Pallas TPU kernel that sums each automaton's
// feedback over a batch: repro/kernels/ta_update.py:_ta_delta_kernel (fire
// bits and feedback types given) and repro/kernels/fused_train.py:
// _fused_train_kernel (both computed in the kernel).  They differ only in
// how a block learns the code of each (sample, clause) pair (bits 0-1
// feedback type, bit 2 fire); this header does the rest.  out[c, l] sums
// over the batch: Type I, +1 with P = p_act on a fired clause's lit
// literal, else -1 with P = p_inact; Type II, +1 on a fired clause's unlit,
// excluded literal.  The draw of (b, c, l) is
// hash_u32(((b + b_off) * c_dim + c_base + c) * L + l, seed) mod 2^32.
//
// What bounds it on the H100: about ten 32-bit integer operations per draw
// made (one per Type I pair and literal; 9.07 M draws at tm-mnist, batch
// 64: 5.4 us at 16.7 T/s) against the bank in and the (C, L) int32 delta
// out (15.7 MB: 4.7 us at 3.35 TB/s).  No tensor-core shape computes a
// multiply-xorshift hash, so the design is about latency, waves, idle
// lanes and redundant work:
//   * a block owns kCT clauses across ALL literals, each thread kV = 7
//     consecutive literals, looping over chunks of blockDim.x * kV
//     literals where L is wider: a pair's code is made once in the grid,
//     and tm-mnist's 1568 literals are exactly 224 threads, 7 full warps
//     (8 a thread would leave the seventh warp 4 live lanes);
//   * one warp lists, per clause, the pairs that change the delta (Type I,
//     and Type II of a fired clause) with ballots and population counts:
//     the walk visits nothing else, and every thread of the block walks
//     the same pair, so its branches never diverge;
//   * the listed samples' literals are staged in shared memory as packed
//     bit rows before the walk, which does no global load (a thread's
//     kV bits: one funnel shift of two staged words);
//   * a thread's kV draws of a pair are independent chains, and the
//     hash's first multiply becomes an add a literal (exact mod 2^32); an
//     unfired Type I pair draws against p_inact alone;
//   * kV registers hold one clause's sums at a time; a warp passes its
//     32 * kV sums through shared memory and stores (or, for a later
//     sample segment, adds) them as 16-byte words on neighbouring
//     addresses, so the 12.5 MB delta leaves in full sectors.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "hash_rng.cuh"

namespace ta_delta {

constexpr int kV = 7;                  // literals a thread
// clauses a block: 512 blocks at tm-mnist.  fused_train.cu also
// instantiates 2 and 8 (the autotuner's block_c, kernels/autotune.py);
// ta_update.cu keeps 4
constexpr int kCT = 4;
constexpr int kMaxThreads = 256;       // a literal chunk is at most 1792 wide
constexpr int kSegMax = 128;           // samples a segment (8 bits of an entry)
constexpr int kRowBudget = 32 * 1024;  // bytes of staged literal rows a segment

// A thread's exclude bits for CT clauses of kV literals: one word, or two
// past 32 bits (CT = 8).
template <int CT>
using Excl = typename std::conditional<(CT * kV <= 32), uint32_t, uint64_t>::type;

// Draw parameters: the hash's seed and thresholds, the clause dimension of
// the automaton index and the literal count.
struct Draw {
  uint32_t seed, t_act, t_inact, c_dim, l_total;
};

// A tile's shared state: the codes of the segment's (sample, clause)
// pairs, the pair lists, and a warp's staging of its sums for coalesced
// stores.  A pair entry holds its code in bits 0-2, the staged row of its
// sample in bits 8-15 and the sample's index in its segment from bit 16.
template <int CT>
struct TileOf {
  static constexpr int kClauses = CT;
  alignas(16) int32_t sums[kMaxThreads * kV];
  uint32_t pair[CT][kSegMax];
  uint8_t code[kSegMax][CT];
  int n[CT];
  int n_rows;                          // staged literal rows
  uint8_t row_sample[kSegMax];         // kCompact: the sample of each row
};
using Tile = TileOf<kCT>;

// Host side: threads of a block for L literals, and samples a segment for
// staged rows of row_bytes each.
inline int block_threads(int l_total) {
  const int need = (l_total + kV - 1) / kV;
  const int warps = (need + 31) / 32;
  return warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
}

inline int seg_samples(int b_total, int row_bytes) {
  int s = kRowBudget / row_bytes;
  s = s < kSegMax ? s : kSegMax;
  s = s < b_total ? s : b_total;
  return s > 1 ? s : 1;
}

// One warp lists, per clause of the tile, the pairs of the segment's ns
// samples that change the delta: Type I, and Type II of a fired clause
// (an unfired clause's Type II adds nothing).  Lists keep sample order.
// kCompact numbers the staged rows over the samples with a listed pair
// (ta_update stages only those); else a sample's row is its index.
template <bool kCompact, int CT>
__device__ __forceinline__ void build_lists(TileOf<CT>& t, int ns, int lane) {
  int n[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) n[c] = 0;
  int n_rows = 0;
  const uint32_t below = (1u << lane) - 1u;
  for (int base = 0; base < ns; base += 32) {
    const int s = base + lane;
    uint32_t codes[CT];
    uint32_t keep = 0u;                  // bit c: pair (s, c) is listed
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      codes[c] = s < ns ? t.code[s][c] : 0u;
      const uint32_t ft = codes[c] & 3u;
      if (ft == 1u || (ft == 2u && (codes[c] & 4u))) keep |= 1u << c;
    }
    int row = s;
    if (kCompact) {
      const uint32_t any = __ballot_sync(0xffffffffu, keep != 0u);
      row = n_rows + __popc(any & below);
      if (keep) t.row_sample[row] = static_cast<uint8_t>(s);
      n_rows += __popc(any);
    }
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const bool k = (keep >> c) & 1u;
      const uint32_t b = __ballot_sync(0xffffffffu, k);
      if (k) {
        t.pair[c][n[c] + __popc(b & below)] =
            (static_cast<uint32_t>(s) << 16) | (static_cast<uint32_t>(row) << 8) | codes[c];
      }
      n[c] += __popc(b);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < CT; ++c) t.n[c] = n[c];
    t.n_rows = kCompact ? n_rows : ns;
  }
}

// Bits kV * c + v: automata (c0 + c, l0 + v) that exclude (state < 0);
// 0 where l0 is past the literals.
template <int CT = kCT>
__device__ __forceinline__ Excl<CT> exclude_bits(const int8_t* ta, int c0, int n_c,
                                                 int l0, int l_total) {
  Excl<CT> ex = 0u;
  if (l0 >= l_total) return ex;
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    if (c < n_c) {
      const int8_t* p = ta + static_cast<size_t>(c0 + c) * l_total + l0;
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        if (l0 + v < l_total && __ldg(p + v) < 0) ex |= Excl<CT>(1) << (kV * c + v);
      }
    }
  }
  return ex;
}

// One clause's listed pairs, for a thread's literals l0 .. l0 + kV - 1:
// acc[v] gains each pair's feedback.  rows: the staged literal rows, bit
// l % 32 of word l / 32 of a row, row_words apart, with one readable word
// past the last row.  g_row = (b_off + s0) * c_dim + c_base + c, so sample
// s's draw of literal l hashes (g_row + s * c_dim) * L + l, all mod 2^32.
__device__ __forceinline__ void walk(const uint32_t* pairs, int n, const uint32_t* rows,
                                     int row_words, uint32_t excl, uint32_t g_row,
                                     uint32_t l0, const Draw& d, int32_t (&acc)[kV]) {
  const int w = static_cast<int>(l0 / 32), sh = static_cast<int>(l0 % 32);
  for (int i = 0; i < n; ++i) {
    const uint32_t e = pairs[i];
    const uint32_t* row = rows + static_cast<int>((e >> 8) & 0xffu) * row_words + w;
    const uint32_t lit = __funnelshift_r(row[0], row[1], sh);
    if ((e & 3u) == 1u) {
      const uint32_t gidx = (g_row + (e >> 16) * d.c_dim) * d.l_total + l0;
      const uint32_t x0 = gidx * tm_rng::kH1 + d.seed;
      if (e & 4u) {                                 // fired: lit literals gain
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          const uint32_t r = tm_rng::avalanche(x0 + static_cast<uint32_t>(v) * tm_rng::kH1);
          acc[v] += ((lit >> v) & 1u) ? static_cast<int32_t>(r < d.t_act)
                                      : -static_cast<int32_t>(r < d.t_inact);
        }
      } else {                                      // not fired: every literal loses
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          const uint32_t r = tm_rng::avalanche(x0 + static_cast<uint32_t>(v) * tm_rng::kH1);
          acc[v] -= static_cast<int32_t>(r < d.t_inact);
        }
      }
    } else {                                        // Type II, fired clause
      const uint32_t hit = ~lit & excl;
#pragma unroll
      for (int v = 0; v < kV; ++v) acc[v] += static_cast<int32_t>((hit >> v) & 1u);
    }
  }
}

// A thread's kV sums into out_row at l0 = lc + threadIdx.x * kV, written
// or (add) added.  A warp whose 32 * kV literals lie inside the row and
// start 16-byte aligned passes them through shared memory and stores them
// as 16-byte words, neighbouring lanes on neighbouring addresses; another
// warp stores a thread's sums one by one.
template <class T>
__device__ __forceinline__ void store(T& t, int32_t* out_row, int lc, int l_total,
                                      const int32_t (&acc)[kV], bool add) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int w0 = lc + warp * 32 * kV;
  int32_t* g = out_row + w0;
  if (w0 + 32 * kV <= l_total && (reinterpret_cast<uintptr_t>(g) & 15u) == 0) {
    int32_t* st = t.sums + warp * 32 * kV;
#pragma unroll
    for (int v = 0; v < kV; ++v) st[lane * kV + v] = acc[v];
    __syncwarp();
    for (int j = lane; j < 8 * kV; j += 32) {
      int4 a = reinterpret_cast<const int4*>(st)[j];
      if (add) {
        const int4 b = reinterpret_cast<const int4*>(g)[j];
        a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
      }
      reinterpret_cast<int4*>(g)[j] = a;
    }
    __syncwarp();
    return;
  }
  int32_t* p = g + lane * kV;
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    if (w0 + lane * kV + v < l_total) p[v] = add ? p[v] + acc[v] : acc[v];
  }
}

// The tile's walk over all L literals, chunk by chunk, clause by clause,
// and its delta rows stored: written for the batch's first segment
// (first), added for a later one.  ex0: the thread's exclude bits in the
// first chunk, loaded by the caller ahead of its front end so that their
// latency hides behind it.  No barrier inside.
template <int CT>
__device__ __forceinline__ void walk_tile(TileOf<CT>& t, const uint32_t* rows, int row_words,
                                          const int8_t* ta, int32_t* out, int c0, int n_c,
                                          Excl<CT> ex0, uint32_t g_row0, const Draw& d,
                                          bool first) {
  const int L = static_cast<int>(d.l_total);
  for (int lc = 0; lc < L; lc += blockDim.x * kV) {
    const int l0 = lc + threadIdx.x * kV;
    if (l0 >= L) break;
    const Excl<CT> ex = lc == 0 ? ex0 : exclude_bits<CT>(ta, c0, n_c, l0, L);
    for (int c = 0; c < n_c; ++c) {
      const int n = t.n[c];
      if (!first && n == 0) continue;
      int32_t acc[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) acc[v] = 0;
      walk(t.pair[c], n, rows, row_words,
           static_cast<uint32_t>(ex >> (kV * c)) & ((1u << kV) - 1u),
           g_row0 + static_cast<uint32_t>(c), static_cast<uint32_t>(l0), d, acc);
      store(t, out + static_cast<size_t>(c0 + c) * L, lc, L, acc, !first);
    }
  }
}

}  // namespace ta_delta
