// Chain walk and vote fold shared by the two schedule kernels
// (sparse_infer.cu and term_infer.cu).
//
// A compiled schedule gives every clause a chain of row ids into a table of
// sample-parallel bit rows: row r packs one literal (sparse_infer) or one
// AND term (term_infer) of 32 consecutive samples into one uint32 word, so
// `rows[r * stride + s]` holds 32 samples of word s.  A clause fires for a
// sample iff every row on its chain has that sample's bit set.  Both
// builders put a clause's real ids first and pad the row after them with a
// sentinel id whose row is all ones, so a clause's chain ends at its length
// `len` (ids before the first sentinel) and anything walked past it is an
// AND identity.  Chains are cut into tiles of `block_j` ids; the tiles of
// clause block `cb` are the tile-table range [tile_off + indptr[cb],
// tile_off + indptr[cb + 1]), and the block's votes fold only when the last
// tile of that range carries tile_last == 1 (a budgeted prefix schedule
// cuts a block short by leaving its last tile out, and such a block adds
// nothing).
//
// The TPU kernels walk this table as a sequential grid and carry the clause
// state across grid steps.  Hopper blocks run in no order, so here one
// thread walks one clause's chain for one 32-sample word.
//
// Bounds on the H100: a chain step is one 4-byte gather of a row that the
// chain picks, so the walk is bound by the latency of dependent loads, not
// by device memory (the literal table of a 512-sample bucket is 100 KB and
// stays in L2).  On tm-mnist's requests a word dies (all 32 samples false)
// within 3 ids at the median and no word outlives 16 ids, while a chain is
// 44 ids long on average, and under 0.1% of (sample, clause) pairs fire.
// What the time went to, on an H100 at the 512-sample bucket: the launch
// ~0.9 us, the first round of loads ~1.2 us (a dependent load from L2 took
// ~0.5 us there), the rest of the walk ~1.8 us, and the fold: one clause
// that fires for most samples put thousands of serial steps or atomics in
// one block.  The design:
//   * a round loads NI ids and gathers their NI rows at once (NI loads in
//     flight), ANDs them and stops as soon as the word is dead or the
//     clause's own chain has ended (`len`), never walking the sentinel
//     padding to the tile end;
//   * the first round is issued before the tile table is read: positions
//     [0, NI) of the chain row, where any position past `len` holds a
//     sentinel, so it is exact whatever the table says and the tile loads
//     overlap it; the second round's ids are loaded with it.  When a clause
//     block's tiles are not chain blocks 0, 1, ... in order (no builder
//     makes that), the walk is redone tile by tile;
//   * a CUDA block walks 256 / sw clauses for sw <= 8 sample words, its
//     clauses a stride apart through the clause block (the builders sort
//     clauses by chain length, and the shortest fire most), so a hot clause
//     meets the others' fold work in no block and its atomics spread over
//     ceil(sw_total / sw) blocks: 16 words a block was ~1.3 us slower.  sw
//     is the largest power of two up to 8 that the bucket's words need,
//     unless the caller passes its own (1, 2, 4 or 8: the autotuner's
//     block_s, kernels/autotune.py);
//   * the fold walks only what fired: a warp takes 32 clauses of one sample
//     word and skips it with one reduction when none fired, else 32
//     independent ballots give lane b the clauses that fired for sample b,
//     and lane b adds their votes rows (staged in shared memory by cp.async
//     during the walk) 8 classes at a time, with one int32 atomic a (sample,
//     class) and block: integer adds commute, so the sums are exact and
//     order-free.  `out` is zeroed by the bit transpose that precedes the
//     walk on the stream;
//   * early exit: the walk stores every chain's fired bits and a second
//     launch folds them clause block by clause block, one CUDA block a
//     sample word, certifying after each (see chain_early_kernel).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kThreads = 256;           // exact walk: threads a block
constexpr int kEarlyThreads = 512;      // early-exit fold: threads a block
constexpr int kNegSum = -(1 << 28);     // below any real class sum
constexpr int kMaxSlabWords = 8;        // sample words per CUDA block (exact mode)

// Bit transpose of the packed literals: (B, W) words, sample-major ->
// (W * 32 + 1) rows of `stride` >= sw_total words, literal-major, where row
// 32 * w + i, word s holds bit i of word w of samples 32 * s .. 32 * s + 31
// (LSB = first sample), and the last row is all ones (the chain sentinel).
// Padding samples read as 0.  One warp per (w, s): lane j loads sample 32 s + j's
// word, and 32 warp ballots turn the 32 x 32 bit block around in registers.
// The same launch zeroes the n_out class sums that the exact walk adds into.
__global__ void bit_transpose_kernel(
    const uint32_t* __restrict__ lit, int b_total, int w_total, int sw_total, int stride,
    uint32_t* __restrict__ lit_t, int32_t* __restrict__ out, int n_out) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = tid; i < n_out; i += gridDim.x * blockDim.x) out[i] = 0;
  if (tid < sw_total) lit_t[static_cast<size_t>(w_total) * 32 * stride + tid] = 0xFFFFFFFFu;
  const int warp = tid >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= w_total * sw_total) return;            // uniform per warp
  const int w = warp / sw_total;
  const int s = warp % sw_total;
  const int b = s * 32 + lane;
  const uint32_t x = b < b_total ? lit[static_cast<size_t>(b) * w_total + w] : 0u;
  uint32_t mine = 0u;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const uint32_t v = __ballot_sync(0xFFFFFFFFu, (x >> i) & 1u);
    if (lane == i) mine = v;
  }
  lit_t[static_cast<size_t>(w * 32 + lane) * stride + s] = mine;
}

inline cudaError_t launch_bit_transpose(const uint32_t* lit, int b_total,
                                        int w_total, int sw_total, int stride,
                                        uint32_t* lit_t, int32_t* out, int n_out,
                                        cudaStream_t stream) {
  long long threads = static_cast<long long>(w_total) * sw_total * 32;
  threads = threads > sw_total ? threads : sw_total;
  threads = threads > n_out ? threads : n_out;
  if (threads > 0) {
    const long long blocks = (threads + kThreads - 1) / kThreads;
    bit_transpose_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        lit, b_total, w_total, sw_total, stride, lit_t, out, n_out);
  }
  return cudaGetLastError();
}

// Word s of row `id` of a bit table whose rows lie `stride` words apart:
// the literal rows (sparse_infer) or the stage-1 term rows (term_infer).
__device__ __forceinline__ uint32_t row_word(const uint32_t* __restrict__ rows, int stride,
                                             int id, int s) {
  return __ldg(rows + static_cast<size_t>(id) * stride + s);
}

// AND `ok` with the rows at chain positions [j0, n) of one chain for sample
// word s: a round loads NI ids and gathers their NI rows at once; stops
// when the word is dead.
template <int NI>
__device__ __forceinline__ uint32_t chain_and(
    const int32_t* __restrict__ ids, int j0, int n, int s, const uint32_t* __restrict__ rows,
    int stride, uint32_t ok) {
  for (int j = j0; j < n && ok != 0u; j += NI) {
    uint32_t g = 0xFFFFFFFFu;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      if (j + i < n) g &= row_word(rows, stride, __ldg(ids + j + i), s);
    }
    ok &= g;
  }
  return ok;
}

// The chain positions of clause block [t0, t1) walked tile by tile, for a
// tile table in any order (the builders' tables take the contiguous path).
template <int NI>
__device__ uint32_t chain_and_tiles(
    const int32_t* __restrict__ ids, int len, const int32_t* __restrict__ tile_jb,
    int t0, int t1, int block_j, int s, const uint32_t* __restrict__ rows, int stride) {
  uint32_t ok = 0xFFFFFFFFu;
  for (int t = t0; t < t1 && ok != 0u; ++t) {
    const int lo = tile_jb[t] * block_j;
    ok = chain_and<NI>(ids + lo, 0, min(block_j, len - lo), s, rows, stride, ok);
  }
  return ok;
}

// Votes rows c0, c0 + stride, ... (n rows of k classes) into shared memory,
// one after the other, by 4-byte cp.async (a row of k words need not be
// 16-byte aligned); completes at cp_async_wait_all.  Called by every
// thread of the block.
__device__ __forceinline__ void stage_votes(int32_t* votes_s, const int32_t* __restrict__ votes,
                                            int c0, int stride, int n, int k) {
  for (int i = threadIdx.x; i < n * k; i += blockDim.x) {
    const int q = stride == 1 ? 0 : i / k;
    const int32_t* src = votes + static_cast<size_t>(c0 + q * stride) * k + (i - q * k);
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(votes_s + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// True on every thread iff the tiles [t0, t1) are chain blocks 0, 1, ... in
// order.  A barrier: every thread of the block calls it.
__device__ __forceinline__ bool tiles_in_order(const int32_t* __restrict__ tile_jb,
                                               int t0, int t1) {
  bool in_order = true;
  for (int i = threadIdx.x; i < t1 - t0; i += blockDim.x) in_order &= tile_jb[t0 + i] == i;
  return __syncthreads_and(in_order) != 0;
}

// Fold one warp's 32 clauses (lane q holds clause q's fired bits `v` over
// the 32 samples of one word; 0 past the chunk) into class sums:
// add(b, kk, partial) for every sample b and class kk whose partial is not
// 0.  Lane q's votes row is votes[q * row_stride ...], in shared memory
// when the kernel staged the rows, else in device memory.  One reduction
// skips a chunk where nothing fired; else 32 ballots, unrolled and
// independent of each other, turn the 32 x 32 bit block around so that
// lane b holds the clauses that fired for sample b, and lane b adds their
// votes rows 8 classes at a time, the 8 loads of a row in flight at once.
// (Walking only the fired samples instead, a dependent ballot or shuffle
// each, cost ~350 cycles a fired sample on the hottest block.)  All 32
// lanes call it.
template <class Add>
__device__ __forceinline__ void fold_warp(uint32_t v, const int32_t* votes, int row_stride,
                                          int k, Add add) {
  if (__reduce_or_sync(0xFFFFFFFFu, v) == 0u) return;
  const int lane = threadIdx.x & 31;
  uint32_t m = 0u;                       // lane b: the clauses that fired for sample b
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const unsigned x = __ballot_sync(0xFFFFFFFFu, (v >> b) & 1u);
    if (lane == b) m = x;
  }
  if (m == 0u) return;
  constexpr int kKC = 8;                 // classes a round
  for (int kc = 0; kc < k; kc += kKC) {
    int32_t acc[kKC] = {};
    for (uint32_t mm = m; mm != 0u; mm &= mm - 1u) {
      const int32_t* row = votes + (__ffs(mm) - 1) * row_stride + kc;
#pragma unroll
      for (int j = 0; j < kKC; ++j) {
        if (kc + j < k) acc[j] += row[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kKC; ++j) {
      if (kc + j < k && acc[j] != 0) add(lane, kc + j, acc[j]);
    }
  }
}

// Exact mode.  Grid: (clause blocks x chunks, sample-word slabs).  Chunk
// ch of clause block cb holds its clauses cb * block_c + ch + i * chunks: a
// stride through the clause block, because the builders order clauses by
// chain length and the shortest chains fire most, so contiguous chunks
// would pile the fold onto the first block (692 of a 512-sample bucket's
// ~800 fired pairs on tm-mnist).  Thread t walks the chunk's clause t / sw
// for sample word t % sw of the slab.  With `stage` the chunk's votes rows
// come to shared memory by cp.async while the chains are walked, so the
// fold reads no device memory.
template <int NI>
__global__ void __launch_bounds__(kThreads) chain_exact_kernel(
    const uint32_t* __restrict__ rows, int stride, int sw_total,
    const int32_t* __restrict__ chain,
    const int32_t* __restrict__ lens, int jp,
    const int32_t* __restrict__ votes, int n_rows, int k,
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ tile_jb,
    const int32_t* __restrict__ tile_last, int tile_off,
    int block_c, int block_j, int sw, bool stage, int32_t* __restrict__ out,
    uint32_t* __restrict__ fired) {
  extern __shared__ int32_t votes_s[];               // [cpb][k] with `stage`
  __shared__ uint32_t ok_s[kThreads];                // [cpb][sw]
  const int cpb = kThreads / sw;
  const int chunks = (block_c + cpb - 1) / cpb;
  const int cb = blockIdx.x / chunks;
  const int c0 = cb * block_c + blockIdx.x % chunks;
  const int c_stop = min((cb + 1) * block_c, n_rows);
  const int n_c = c0 < c_stop ? (c_stop - c0 + chunks - 1) / chunks : 0;
  const int lc = threadIdx.x / sw;
  const int c = c0 + lc * chunks;
  const int s = blockIdx.y * sw + threadIdx.x % sw;
  const bool live = lc < n_c && s < sw_total;
  const int32_t* ids = chain + static_cast<size_t>(live ? c : 0) * jp;
  if (stage) stage_votes(votes_s, votes, c0, chunks, n_c, k);

  // issued together: the tile range, the clause length and the first round
  const int t0 = tile_off + indptr[cb];
  const int t1 = tile_off + indptr[cb + 1];
  const int len = live ? lens[c] : 0;
  // positions [0, NI), whatever the tile table says: those past the chain's
  // own end hold sentinels
  uint32_t ok = live ? chain_and<NI>(ids, 0, min(NI, jp), s, rows, stride, 0xFFFFFFFFu) : 0u;
  int next[NI];                                      // the second round's ids, loaded now
#pragma unroll
  for (int i = 0; i < NI; ++i) next[i] = live && NI + i < jp ? __ldg(ids + NI + i) : 0;
  // uniform over the block: nothing votes, or the block never folds
  if (n_c <= 0 || t1 <= t0 || tile_last[t1 - 1] != 1) {
    if (fired != nullptr && live) fired[static_cast<size_t>(s) * n_rows + c] = 0u;
    cp_async_wait_all();
    return;
  }
  const int span = (t1 - t0) * block_j;
  const bool in_order = tiles_in_order(tile_jb, t0, t1);
  if (live && in_order && len <= span) {
    if (ok != 0u) {
      uint32_t g = 0xFFFFFFFFu;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        if (NI + i < len) g &= row_word(rows, stride, next[i], s);
      }
      ok = chain_and<NI>(ids, 2 * NI, len, s, rows, stride, ok & g);
    }
  } else if (live) {
    ok = chain_and_tiles<NI>(ids, len, tile_jb, t0, t1, block_j, s, rows, stride);
  }
  if (fired != nullptr) {                            // early exit folds them in order
    if (live) fired[static_cast<size_t>(s) * n_rows + c] = ok;
    return;
  }
  ok_s[threadIdx.x] = ok;                            // == ok_s[lc * sw + s % sw]
  cp_async_wait_all();
  __syncthreads();

  // fold: a warp takes (sample word, 32-clause chunk) tasks
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_task = sw * ((n_c + 31) / 32);
  const int32_t* vrows = stage ? votes_s : votes + static_cast<size_t>(c0) * k;
  const int row_stride = stage ? k : chunks * k;
  for (int task = warp; task < n_task; task += kThreads / 32) {
    const int ws = task % sw;
    const int q0 = (task / sw) * 32;
    const int sg = blockIdx.y * sw + ws;
    if (sg >= sw_total) continue;                    // uniform per warp
    const uint32_t v = q0 + lane < n_c ? ok_s[(q0 + lane) * sw + ws] : 0u;
    fold_warp(v, vrows + q0 * row_stride, row_stride, k, [&](int b, int kk, int32_t acc) {
      atomicAdd(out + static_cast<size_t>(sg * 32 + b) * k + kk, acc);
    });
  }
}

// Exact early-exit mode, the fold: the exact walk has stored every chain's
// fired bits, fired[s][c].  On this card the walk is bound by latency and
// runs every chain at once in the time of a few, so what the clause
// blocks' order makes sequential is only the fold and its certification.
// Grid: one CUDA block per sample word (32 samples).  The block folds the
// clause blocks in table order, keeps its slab's class sums in shared
// memory, and after each fold stops once every real sample's lead (top1 -
// top2, 0 on a tie) strictly exceeds the residual vote swing `margin[t]`
// of the fold tile: no later tile can change any argmax.  The fired words,
// the votes and each clause block's fold tile and margin come to shared
// memory first (as far as they fit; else they are read where they lie).
__global__ void __launch_bounds__(kEarlyThreads) chain_early_kernel(
    const uint32_t* __restrict__ fired, const int32_t* __restrict__ votes,
    int n_rows, int k, const int32_t* __restrict__ indptr, int n_cblocks,
    const int32_t* __restrict__ tile_last, int tile_off,
    const int32_t* __restrict__ margin, int block_c, int n_samples,
    bool stage_fired, bool stage_votes_all, bool stage_meta, int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  int32_t* sums = smem;                                          // [32][k]
  int32_t* p = sums + 32 * k;
  int2* meta_s = reinterpret_cast<int2*>(p);                     // [n_cblocks]: fold, margin
  p += stage_meta ? 2 * n_cblocks : 0;
  uint32_t* fired_s = reinterpret_cast<uint32_t*>(p);            // [n_rows]
  p += stage_fired ? n_rows : 0;
  int32_t* votes_s = p;                                          // [n_rows][k]
  __shared__ int done;
  const int s = blockIdx.x;
  const uint32_t* fw = fired + static_cast<size_t>(s) * n_rows;
  for (int i = threadIdx.x; i < 32 * k; i += blockDim.x) sums[i] = 0;
  if (threadIdx.x == 0) done = 0;
  if (stage_fired) {
    for (int c = threadIdx.x; c < n_rows; c += blockDim.x) {
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(fired_s + c));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(fw + c));
    }
  }
  if (stage_votes_all) stage_votes(votes_s, votes, 0, 1, n_rows, k);
  // a clause block folds iff it has tiles and its last one closes it
  auto fold_of = [&](int cb) {
    const int t0 = tile_off + indptr[cb];
    const int t1 = tile_off + indptr[cb + 1];
    const bool folds = t1 > t0 && tile_last[t1 - 1] == 1;
    return make_int2(folds, folds ? margin[t1 - 1] : 0);
  };
  if (stage_meta) {
    for (int cb = threadIdx.x; cb < n_cblocks; cb += blockDim.x) meta_s[cb] = fold_of(cb);
  }
  cp_async_wait_all();
  __syncthreads();
  const uint32_t* fr = stage_fired ? fired_s : fw;
  const int32_t* vr = stage_votes_all ? votes_s : votes;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int cb = 0; cb < n_cblocks; ++cb) {
    const int2 meta = stage_meta ? meta_s[cb] : fold_of(cb);
    if (!meta.x) continue;                           // uniform over the block
    const int c_lo = cb * block_c;
    const int c_stop = min(c_lo + block_c, n_rows);
    for (int q0 = c_lo + warp * 32; q0 < c_stop; q0 += blockDim.x) {
      const uint32_t v = q0 + lane < c_stop ? fr[q0 + lane] : 0u;
      fold_warp(v, vr + static_cast<size_t>(q0) * k, k, k,
                [&](int b, int kk, int32_t acc) { atomicAdd(sums + b * k + kk, acc); });
    }
    __syncthreads();
    if (cb == n_cblocks - 1) break;                  // nothing left to skip
    if (threadIdx.x < 32) {                          // warp 0: certify the slab
      const int bit = threadIdx.x;
      int lead = -kNegSum;                           // padding samples certify
      if (s * 32 + bit < n_samples) {                // top1, its count and top2 in one pass
        const int32_t* row = sums + bit * k;
        int top1 = kNegSum, second = kNegSum, n_top = 0;
#pragma unroll 4
        for (int kk = 0; kk < k; ++kk) {
          const int x = row[kk];
          if (x > top1) {
            second = top1;
            top1 = x;
            n_top = 1;
          } else if (x == top1) {
            ++n_top;
          } else {
            second = max(second, x);
          }
        }
        lead = n_top > 1 ? 0 : top1 - second;
      }
      const unsigned all = __all_sync(0xFFFFFFFFu, lead > meta.y);
      if (bit == 0 && all) done = 1;
    }
    __syncthreads();
    if (done) break;
  }
  for (int i = threadIdx.x; i < 32 * k; i += blockDim.x) {
    out[static_cast<size_t>(s) * 32 * k + i] = sums[i];
  }
}

// Sample words a block of the exact walk takes (a power of two, at most
// kMaxSlabWords): `slab` when the caller passed one (1, 2, 4 or 8), else
// the smallest power of two that covers sw_total, capped at kMaxSlabWords;
// 0 for any other value.  Its grid is (clause blocks x ceil(block_c /
// (kThreads / sw)), ceil(sw_total / sw)).
inline int slab_words(int slab, int sw_total) {
  if (slab != 0) {
    return slab > 0 && slab <= kMaxSlabWords && (slab & (slab - 1)) == 0 ? slab : 0;
  }
  int sw = 1;
  while (sw < sw_total && sw < kMaxSlabWords) sw <<= 1;
  return sw;
}

inline dim3 exact_grid(int sw, int sw_total, int n_cblocks, int block_c) {
  const int cpb = kThreads / sw;
  return dim3(n_cblocks * ((block_c + cpb - 1) / cpb), (sw_total + sw - 1) / sw);
}

// Whether `rows` rows of k words and `extra_words` more fit in the 48 KB of
// shared memory a block gets without opting in (less 1 KB for a kernel's
// few static words); what does not fit stays in device memory.
inline bool stage_fits(int rows, int k, int extra_words) {
  return (static_cast<size_t>(rows) * k + extra_words) * sizeof(int32_t) <= 47 * 1024;
}

// Shared memory the early-exit fold may opt in to (of the 227 KB a block
// can have).
constexpr size_t kEarlyShared = 200 * 1024;

// The exact walk's dynamic shared memory at sw sample words a block: the
// chunk's votes rows where they fit (with `fold`; the early-exit walk only
// stores its fired words).
inline size_t exact_shared(int sw, int k, bool fold) {
  const int cpb = kThreads / sw;
  return fold && stage_fits(cpb, k, 0) ? cpb * k * sizeof(int32_t) : 0;
}

// Launch the exact walk at `slab` sample words a block (0: slab_words'
// choice), or (margin != nullptr) the walk into `fired`, a (sw_total,
// n_rows) scratch the caller allocates, then the early-exit fold, on
// `stream`.
template <int NI>
inline cudaError_t launch_chain(
    const uint32_t* rows, int stride, int sw_total, const int32_t* chain, const int32_t* lens,
    int jp, const int32_t* votes, int n_rows, int k, const int32_t* indptr,
    int n_cblocks, const int32_t* tile_jb, const int32_t* tile_last,
    int tile_off, const int32_t* margin, int block_c, int block_j, int slab,
    int n_samples, int32_t* out, uint32_t* fired, cudaStream_t stream) {
  const int sw = slab_words(slab, sw_total);
  if (sw == 0) return cudaErrorInvalidValue;
  if (n_cblocks <= 0 || sw_total <= 0) return cudaSuccess;
  const size_t staged = exact_shared(sw, k, margin == nullptr);
  chain_exact_kernel<NI><<<exact_grid(sw, sw_total, n_cblocks, block_c), kThreads,
                                 staged, stream>>>(
      rows, stride, sw_total, chain, lens, jp, votes, n_rows, k, indptr, tile_jb,
      tile_last, tile_off, block_c, block_j, sw, staged > 0, out,
      margin == nullptr ? nullptr : fired);
  if (margin == nullptr) return cudaGetLastError();
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // shared words: the sums, then what fits of the clause blocks' fold
  // tiles, the fired words and the votes, in that order
  size_t words = static_cast<size_t>(32) * k;
  const auto take = [&](size_t n) {
    const bool fits = (words + n) * sizeof(int32_t) <= kEarlyShared;
    if (fits) words += n;
    return fits;
  };
  const bool stage_meta = take(2 * static_cast<size_t>(n_cblocks));
  const bool stage_fired = take(n_rows);
  const bool stage_votes_all = take(static_cast<size_t>(n_rows) * k);
  const size_t shm = words * sizeof(int32_t);
  if (shm > 48 * 1024) {
    const cudaError_t ea = cudaFuncSetAttribute(
        chain_early_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shm));
    if (ea != cudaSuccess) return ea;
  }
  chain_early_kernel<<<sw_total, kEarlyThreads, shm, stream>>>(
      fired, votes, n_rows, k, indptr, n_cblocks, tile_last, tile_off, margin,
      block_c, n_samples, stage_fired, stage_votes_all, stage_meta, out);
  return cudaGetLastError();
}

// What an occupancy entry point reports of `kernel` launched on `grid`:
// registers, threads, blocks an SM, shared bytes (static and dynamic) and
// spill bytes a thread, then grid x, grid y and the threads that walk one
// chain.
template <class Kernel>
cudaError_t occupancy(Kernel kernel, int threads, size_t dyn_shared, dim3 g, int* info) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, dyn_shared);
  }
  if (err != cudaSuccess) return err;
  info[0] = a.numRegs;
  info[1] = threads;
  info[2] = blocks;
  info[3] = static_cast<int>(a.sharedSizeBytes + dyn_shared);
  info[4] = static_cast<int>(a.localSizeBytes);
  info[5] = static_cast<int>(g.x);
  info[6] = static_cast<int>(g.y);
  info[7] = 1;
  return cudaSuccess;
}

// Registers, threads, blocks an SM, shared and spill bytes, grid and
// threads a chain of the exact walk at sw_total sample words and `slab`
// words a block (0: slab_words' choice).
template <int NI>
cudaError_t exact_occupancy(int sw_total, int n_cblocks, int block_c, int k, int slab,
                            int* info) {
  const int sw = slab_words(slab, sw_total);
  if (sw == 0) return cudaErrorInvalidValue;
  const size_t dyn = exact_shared(sw, k, true);
  return occupancy(chain_exact_kernel<NI>, kThreads, dyn,
                   exact_grid(sw, sw_total, n_cblocks, block_c), info);
}

}  // namespace repro_torch
