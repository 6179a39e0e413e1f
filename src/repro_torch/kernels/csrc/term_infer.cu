// Two-stage shared-term (factorized) compiled TM inference for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/term_infer.py:
// _term_infer_kernel (launched by factorized_tm_forward_tables).  Stage 1
// evaluates every unique (word, include-pattern) AND term of the artifact
// once per sample word into a term bit table; stage 2 walks each clause's
// chain of TERM ids over that table and folds the votes.  A term shared by
// n clauses costs its bit chain once plus n single-row gathers.
//
// The TPU keeps the (Tp, block_s) term table in VMEM between the two
// stages of one grid.  Here two designs, chosen per call by the wrapper
// (kernels/term_infer.py: slab_words_for), from the batch, the tables'
// shapes and the card:
//
// * Slab-resident, one launch (slab_term_eval_kernel), at large batches in
//   exact mode.  One CTA takes a slab of S sample words and holds in
//   shared memory all that slab needs: its transposed literal rows (32 W x
//   S words), its term table (Tp x S words), its fired table and the
//   votes' bit planes, so no table touches device memory.  On tm-mnist at
//   S = 4: 24.5 + 149.8 + 32.5 + 6 KiB (tm-cifar2: 32 + 157 + 32.5 + 2),
//   under the 227 KiB a block may opt in to; one 1024-thread CTA an SM.
//   The CTA transposes its literal words with warp shuffles, evaluates
//   every term, walks every clause's chain over the shared table (a lane a
//   clause, all S words at once: a term row is one 16-byte shared load at
//   S = 4) and folds what fired into its (32 S, K) class sums with one-bit
//   tensor-core products, then writes its rows of `out` once: no scratch,
//   no zeroing pass, no global atomics.  What bounds it, per CTA on an H100
//   (tm-mnist, cycles): the load 5.5k (latency), the transpose 3.3k, the
//   terms 8.8k and the walk 19.0k (16-byte shared gathers of random rows,
//   ~2.5-way bank conflicts, and the ids' L2 latency), the fold 8.5k (the
//   one-bit products' rate), 46k in all, 4 CTAs an SM at 65,536 samples.
//   Its CTAs take 14, 17 and 26 us a wave at S 1, 2 and 4, so the wrapper
//   runs it only where the slabs fill half the SMs, at the largest S that
//   does and whose tables, the votes' planes included, fit.
// * Three launches (bit transpose, stage 1, stage-2 walk), at the serve
//   bucket, for an explicit block_s and for early exit.  At 512 samples
//   the term table is 9,584 x 16 x 4 B = 0.6 MB (tm-mnist) and stays in the
//   50 MB L2; but a 512-sample bucket is 16 sample words, 4 slabs for 132
//   SMs.  At 65,536 samples the same table is 78.5 MB (tm-cifar2: 82.3 MB)
//   and goes round device memory, as do the 12.9 MB of transposed
//   literals: that is what the slab design removes.  Stage 1 is one
//   thread per (term, 4 sample words): a 16-byte load of each literal row
//   on the term's chain, issued together, sentinel ids skipped, bound by the
//   latency of two dependent loads.  On an H100 at the 512-sample bucket
//   that took it from 3.05 us (a thread a word) to 1.86 us.  Evaluating
//   terms where the walk reaches them instead, with no stage 1, made the
//   walk a chain of three dependent loads and was slower; so was a stage 1
//   that transposed each literal word it needed itself, with no transpose
//   launch (its blocks redid each word's transpose, 9.1 us against 1.8 +
//   3.1).  A launch before both bit-transposes the bucket's literals into a
//   caller-allocated buffer and zeroes the class sums; with exact early
//   exit a fourth launch folds in order (the walk stores its fired words).
//   Stage 2's bounds and design: see chain_walk.cuh.

#include <type_traits>

#include "chain_walk.cuh"

namespace {

using namespace repro_torch;

// Stage 1: term_bits[t * stride + s] = the AND of the literal rows on term
// t's chain for sample word s (ids >= n_lit_bits are sentinels).  A thread
// takes 4 words of one term: rows `stride` (a multiple of 4) words apart
// start 16-byte aligned, so each literal row is one 16-byte load, and a
// 4-id chain (term_w 4, tm-mnist's) one more.
__global__ void __launch_bounds__(kThreads) term_eval_kernel(
    const uint32_t* __restrict__ lit_t, int stride, const int32_t* __restrict__ term_chain,
    int term_w, bool ids_vec, int n_lit_bits, long long n, uint32_t* __restrict__ term_bits) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int groups = stride / 4;
  const int t = static_cast<int>(idx / groups);
  const int g = static_cast<int>(idx % groups);
  const int32_t* ids = term_chain + static_cast<size_t>(t) * term_w;
  uint4 v = make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu);
  const auto and_row = [&](int l) {
    if (l >= n_lit_bits) return;
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(lit_t + static_cast<size_t>(l) * stride) + g);
    v.x &= r.x;
    v.y &= r.y;
    v.z &= r.z;
    v.w &= r.w;
  };
  if (ids_vec) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(ids));
    and_row(q.x);
    and_row(q.y);
    and_row(q.z);
    and_row(q.w);
  } else {
    for (int i = 0; i < term_w; ++i) and_row(__ldg(ids + i));
  }
  reinterpret_cast<uint4*>(term_bits + static_cast<size_t>(t) * stride)[g] = v;
}

constexpr int kIds = 4;                 // ids a thread loads in one round

// ---- the slab-resident design: one launch a call --------------------------

constexpr int kSlabThreads = 1024;      // threads a block; one block an SM

__host__ __device__ inline int rup4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int rup8(int x) { return (x + 7) & ~7; }

// The slab design's dynamic shared memory, in 4-byte words: the literal rows
// (32 W x S, at 0), the term rows (max(Tp, 32 raw_stride) x S, where the raw
// literal words lie first), the clause blocks' walk plans (an int4 each),
// the (32 S, K) class sums, the fired table (32 S sample rows of `ldf`
// words: word j of row b has bit c set iff clause 32 j + c fired for
// sample b; chunks padded to a multiple of 8, one word more so that the
// walk's column writes hit 32 banks) and the votes' `np` bit planes as the
// fold's B operand (`plane_rows` rows of `ncp` words, a row for each
// (class, plane), padded to 8 rows).  Each region starts on a 16-byte
// boundary.  The wrapper's kernels/term_infer.py:slab_shared_words counts
// the same words, which is how it picks S.
struct SlabLayout {
  int terms, meta, sums, fired, planes;
  int ncp;          // 32-clause chunks, padded to a multiple of 8
  int ldf;          // words between two rows of the fired table: ncp + 1
  int plane_rows;   // k np rounded up to a multiple of 8
  int raw_stride;   // words between two samples' raw literal rows: odd
  int words;
};

inline SlabLayout slab_layout(int slab, int w_total, int tp, int k, int n_cblocks,
                              int n_rows, int np) {
  SlabLayout l;
  l.raw_stride = w_total | 1;
  l.ncp = rup8((n_rows + 31) / 32);
  l.ldf = l.ncp + 1;
  l.terms = rup4(32 * w_total * slab);
  l.meta = l.terms + rup4((tp > 32 * l.raw_stride ? tp : 32 * l.raw_stride) * slab);
  l.sums = l.meta + 4 * n_cblocks;
  l.fired = l.sums + rup4(32 * slab * k);
  l.planes = l.fired + rup4(32 * slab * l.ldf);
  l.plane_rows = rup8(k * np);
  l.words = l.planes + l.plane_rows * l.ncp;
  return l;
}

// v[0..S) &= the S words of a shared row (16-, 8- or 4-byte loads).
template <int S>
__device__ __forceinline__ void and_row(uint32_t (&v)[S], const uint32_t* row) {
  if constexpr (S >= 4) {
#pragma unroll
    for (int i = 0; i < S / 4; ++i) {
      const uint4 r = reinterpret_cast<const uint4*>(row)[i];
      v[4 * i] &= r.x;
      v[4 * i + 1] &= r.y;
      v[4 * i + 2] &= r.z;
      v[4 * i + 3] &= r.w;
    }
  } else if constexpr (S == 2) {
    const uint2 r = *reinterpret_cast<const uint2*>(row);
    v[0] &= r.x;
    v[1] &= r.y;
  } else {
    v[0] &= row[0];
  }
}

template <int S>
__device__ __forceinline__ void store_row(uint32_t* row, const uint32_t (&v)[S]) {
  if constexpr (S >= 4) {
#pragma unroll
    for (int i = 0; i < S / 4; ++i) {
      reinterpret_cast<uint4*>(row)[i] = make_uint4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                                    v[4 * i + 3]);
    }
  } else if constexpr (S == 2) {
    *reinterpret_cast<uint2*>(row) = make_uint2(v[0], v[1]);
  } else {
    row[0] = v[0];
  }
}

template <int S>
__device__ __forceinline__ bool any_word(const uint32_t (&v)[S]) {
  uint32_t a = 0u;
#pragma unroll
  for (int i = 0; i < S; ++i) a |= v[i];
  return a != 0u;
}

// ok &= the shared term rows of the 4 ids in q, those at positions j + i < n.
template <int S>
__device__ __forceinline__ void and_ids(uint32_t (&ok)[S], int4 q, int j, int n,
                                        const uint32_t* term_s) {
  and_row<S>(ok, term_s + q.x * S);
  if (j + 1 < n) and_row<S>(ok, term_s + q.y * S);
  if (j + 2 < n) and_row<S>(ok, term_s + q.z * S);
  if (j + 3 < n) and_row<S>(ok, term_s + q.w * S);
}

// AND the shared term rows at chain positions [0, n) into ok, a round of 4
// ids at a time (with `vec`, one 16-byte load, the next round's issued with
// this one's rows); stops once every word of the slab is dead.  The ids
// come from L2.  Rounds of 8, or 4 ids with 3 rounds in flight, were slower
// on an H100 (walk 22.1k and 22.3k cycles a CTA against 19.0k, tm-mnist).
template <int S>
__device__ __forceinline__ void walk_terms(const int32_t* __restrict__ ids, int n, bool vec,
                                           const uint32_t* term_s, uint32_t (&ok)[S]) {
  if (vec) {
    int4 q = n > 0 ? __ldg(reinterpret_cast<const int4*>(ids)) : make_int4(0, 0, 0, 0);
    for (int j = 0; j < n; j += 4) {
      const int4 nq = j + 4 < n ? __ldg(reinterpret_cast<const int4*>(ids + j + 4)) : q;
      and_ids<S>(ok, q, j, n, term_s);
      if (!any_word<S>(ok)) return;
      q = nq;
    }
  } else {
    for (int j = 0; j < n; ++j) {
      and_row<S>(ok, term_s + __ldg(ids + j) * S);
      if ((j & 3) == 3 && !any_word<S>(ok)) return;
    }
  }
}

// The 32 x 32 bit transpose of a warp's words: lane i gets the word whose
// bit j is bit i of lane j's x (what 32 ballots give), in five rounds of
// one shuffle that swap the off-diagonal blocks of 16, 8, 4, 2 and 1 bits.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  uint32_t m = 0x0000FFFFu;
#pragma unroll
  for (int j = 16; j != 0; j >>= 1, m ^= m << j) {
    const uint32_t p = __shfl_xor_sync(0xFFFFFFFFu, x, j);
    x = (lane & j) ? (x & ~m) | ((p >> j) & m) : (x & m) | ((p << j) & ~m);
  }
  return x;
}

// c += the one-bit product of a 16 x 256 A tile and a 256 x 8 B tile:
// c[i] += popc(A row & B column), as xnor_popcount.cu uses it.  Thread (g,
// t) = (lane / 4, lane % 4) holds A's words 2t, 2t + 1 of rows g (a0, a2)
// and g + 8 (a1, a3), B's words 2t, 2t + 1 of column g, and c for (row g,
// columns 2t, 2t + 1) and (row g + 8, the same columns).
__device__ __forceinline__ void mma_and_popc(int (&c)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One CTA a slab of S sample words (samples 32 S x, ..., 32 S x + 32 S - 1),
// in six phases between barriers: (0) the class sums zeroed, each clause
// block's walk plan (its tile range; 0: it never folds, 1: its tiles are
// chain blocks 0, 1, ... in order, 2: walked tile by tile), the votes' bit
// planes copied in (the `np` planes of `vote_planes` that hold every vote,
// kernels/term_infer.py:vote_planes), the slab's literal words loaded
// sample-major and coalesced, 16 bytes a load (scalar loads took 6.9k
// cycles a CTA against 5.5k on tm-mnist), into rows raw_stride (odd, so
// the transpose's reads hit 32 banks) words apart; (1) a warp a literal word
// turns its S 32 x 32 bit blocks around (transpose32) and stores each
// literal row's S words at once (a warp a (word, sample word) block, with
// S-way bank conflicts on the stores, took 4.4k cycles a CTA against 3.3k
// on tm-mnist); (2) a thread a term ANDs its literal rows (sentinel ids
// skipped) into its term row, four terms' ids in flight; (3) a warp takes 32
// clauses, a lane a clause, walks every chain over the shared term rows
// for all S words at once (chain_walk.cuh's semantics: to its own length,
// in order or tile by tile, folding only a block whose last tile closes
// it) and writes what fired, turned around, into the fired table; (4) the
// fold as one-bit tensor-core products: (samples x clauses) fired bits
// against (clauses x (class, plane)) vote bits give each sample's count of
// fired clauses with bit p of their vote set, and sum_p 2^p count (the top
// plane negative, np-bit two's complement) is its class sum; (5) the
// slab's rows of `out` are written once.  The products cost the same
// whatever fired; a walk over the fired clauses (fold_warp) cost a votes
// row each, ~20k cycles a warp on tm-mnist, and plane by plane population
// counts ~24k a CTA.  The name holds "term_eval_kernel":
// the benchmark's trace finds the factorized route by it.
template <int S>
__global__ void __launch_bounds__(kSlabThreads, 1) slab_term_eval_kernel(
    const uint32_t* __restrict__ lit, int b_total, int w_total,
    bool lit_vec, const int32_t* __restrict__ term_chain, int tp, int term_w, bool ids_vec,
    const int32_t* __restrict__ chain, const int32_t* __restrict__ lens, int jp,
    bool chain_vec, const uint32_t* __restrict__ vote_planes, int np, int n_rows, int k,
    const int32_t* __restrict__ indptr, int n_cblocks, const int32_t* __restrict__ tile_jb,
    const int32_t* __restrict__ tile_last, int tile_off, int block_c, int block_j,
    SlabLayout lay, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t slab_smem[];
  uint32_t* lit_s = slab_smem;                                        // [32 W][S]
  uint32_t* term_s = slab_smem + lay.terms;                           // [Tp][S]
  int4* meta_s = reinterpret_cast<int4*>(slab_smem + lay.meta);       // [n_cblocks]
  int32_t* sums = reinterpret_cast<int32_t*>(slab_smem + lay.sums);   // [32 S][k]
  uint32_t* fired_s = slab_smem + lay.fired;                          // [32 S][ldf]
  uint32_t* planes_s = slab_smem + lay.planes;                        // [k np, to 8][ncp]
  constexpr int kWarps = kSlabThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_lit = 32 * w_total;
  const int n_chunks = (n_rows + 31) / 32;
  const long long b0 = static_cast<long long>(blockIdx.x) * 32 * S;
  const int nb = static_cast<int>(min(static_cast<long long>(32 * S), b_total - b0));

  // (0)
  for (int i = tid; i < 32 * S * k; i += kSlabThreads) sums[i] = 0;
  for (int cb = tid; cb < n_cblocks; cb += kSlabThreads) {
    const int t0 = tile_off + indptr[cb];
    const int t1 = tile_off + indptr[cb + 1];
    int mode = 0;
    if (t1 > t0 && tile_last[t1 - 1] == 1) {
      mode = 1;
      for (int i = 0; i < t1 - t0; ++i) {
        if (tile_jb[t0 + i] != i) {
          mode = 2;
          break;
        }
      }
    }
    meta_s[cb] = make_int4(t0, t1, mode, (t1 - t0) * block_j);
  }
  for (int i = tid; i < lay.plane_rows * lay.ncp; i += kSlabThreads) {
    const int row = i / lay.ncp, j = i - row * lay.ncp;
    const int kk = row / np, p = row - kk * np;
    planes_s[i] = row < k * np && j < n_chunks
                      ? __ldg(vote_planes + (static_cast<size_t>(kk) * 32 + p) * n_chunks + j)
                      : 0u;
  }
  for (int i = tid; i < 32 * S * (lay.ncp - n_chunks); i += kSlabThreads) {
    const int r = i / (lay.ncp - n_chunks);
    fired_s[r * lay.ldf + n_chunks + (i - r * (lay.ncp - n_chunks))] = 0u;
  }
  uint32_t* raw = term_s;                                        // [32 S][raw_stride]
  const uint32_t* src = lit + b0 * w_total;
  const int n_src = nb * w_total;                                // words of this slab's samples
  for (int i = 4 * tid; i < 32 * S * w_total; i += 4 * kSlabThreads) {
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (lit_vec && i + 3 < n_src) {
      x = __ldg(reinterpret_cast<const uint4*>(src + i));
    } else {
      x.x = i < n_src ? __ldg(src + i) : 0u;
      x.y = i + 1 < n_src ? __ldg(src + i + 1) : 0u;
      x.z = i + 2 < n_src ? __ldg(src + i + 2) : 0u;
      x.w = i + 3 < n_src ? __ldg(src + i + 3) : 0u;
    }
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int b = (i + u) / w_total;
      raw[b * lay.raw_stride + (i + u - b * w_total)] = xs[u];
    }
  }
  __syncthreads();

  // (1) samples past b_total read as 0; no sentinel row: stage 1 skips its ids
  for (int w = warp; w < w_total; w += kWarps) {
    uint32_t v[S];
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = transpose32(raw[(32 * s + lane) * lay.raw_stride + w], lane);
    store_row<S>(lit_s + (32 * w + lane) * S, v);
  }
  __syncthreads();

  // (2)
  const auto eval_term = [&](int t, int4 q) {
    uint32_t v[S];
#pragma unroll
    for (int i = 0; i < S; ++i) v[i] = 0xFFFFFFFFu;
    if (q.x < n_lit) and_row<S>(v, lit_s + q.x * S);
    if (q.y < n_lit) and_row<S>(v, lit_s + q.y * S);
    if (q.z < n_lit) and_row<S>(v, lit_s + q.z * S);
    if (q.w < n_lit) and_row<S>(v, lit_s + q.w * S);
    store_row<S>(term_s + t * S, v);
  };
  if (ids_vec) {
    constexpr int kU = 4;
    for (int t0 = tid; t0 < tp; t0 += kU * kSlabThreads) {
      int4 q[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = t0 + u * kSlabThreads;
        q[u] = t < tp ? __ldg(reinterpret_cast<const int4*>(term_chain) + t)
                      : make_int4(n_lit, n_lit, n_lit, n_lit);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (t0 + u * kSlabThreads < tp) eval_term(t0 + u * kSlabThreads, q[u]);
      }
    }
  } else {
    for (int t = tid; t < tp; t += kSlabThreads) {
      uint32_t v[S];
#pragma unroll
      for (int i = 0; i < S; ++i) v[i] = 0xFFFFFFFFu;
      const int32_t* ids = term_chain + static_cast<size_t>(t) * term_w;
      for (int i = 0; i < term_w; ++i) {
        const int l = __ldg(ids + i);
        if (l < n_lit) and_row<S>(v, lit_s + l * S);
      }
      store_row<S>(term_s + t * S, v);
    }
  }
  __syncthreads();

  // (3) warp-uniform over 32-clause chunks: the transposes need every lane
  for (int q = warp; q < n_chunks; q += kWarps) {
    const int c = q * 32 + lane;
    uint32_t ok[S];
#pragma unroll
    for (int i = 0; i < S; ++i) ok[i] = 0u;
    if (c < n_rows) {
      const int4 m = meta_s[c / block_c];
      if (m.z != 0) {
#pragma unroll
        for (int i = 0; i < S; ++i) ok[i] = 0xFFFFFFFFu;
        const int32_t* ids = chain + static_cast<size_t>(c) * jp;
        const int len = lens[c];
        if (m.z == 1) {
          walk_terms<S>(ids, min(len, m.w), chain_vec, term_s, ok);
        } else {
          for (int t = m.x; t < m.y && any_word<S>(ok); ++t) {
            const int lo = tile_jb[t] * block_j;
            walk_terms<S>(ids + lo, min(block_j, len - lo), false, term_s, ok);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) fired_s[(s * 32 + lane) * lay.ldf + q] = transpose32(ok[s], lane);
  }
  __syncthreads();

  // (4) a warp a (16 samples, 8 (class, plane) columns) tile; splitting a
  // tile's chunks over the warps the tiles leave idle was slower on an H100
  // (tm-cifar2: 5.0k cycles a CTA against 4.0k)
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = lay.plane_rows / 8;
  for (int tile = warp; tile < 2 * S * n_tiles; tile += kWarps) {
    const int row = tile / n_tiles * 16 + g;
    const int col0 = tile % n_tiles * 8;
    int acc[4] = {0, 0, 0, 0};
    for (int c = 2 * t; c < lay.ncp; c += 8) {
      const uint32_t* a = fired_s + row * lay.ldf + c;
      const uint32_t* bw = planes_s + (col0 + g) * lay.ncp + c;
      mma_and_popc(acc, a[0], a[8 * lay.ldf], a[1], a[8 * lay.ldf + 1], bw[0], bw[1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = col0 + 2 * t + (i & 1);
      if (col >= k * np) continue;
      const int kk = col / np, p = col - kk * np;
      // 2^p, or -2^p for the sign plane; unsigned products wrap as int32 adds do
      const uint32_t w = p == np - 1 ? 0u - (1u << p) : 1u << p;
      const uint32_t v = static_cast<uint32_t>(acc[i]) * w;
      if (v != 0u) atomicAdd(sums + (row + (i >> 1) * 8) * k + kk, static_cast<int32_t>(v));
    }
  }
  __syncthreads();

  // (5)
  for (int i = tid; i < nb * k; i += kSlabThreads) out[b0 * k + i] = sums[i];
}

template <int S>
cudaError_t launch_slab(const uint32_t* lit, int b_total, int w_total, const int32_t* term_chain,
                        int tp, int term_w, const int32_t* chain, const int32_t* lens, int jp,
                        const uint32_t* vote_planes, int np, int n_rows, int k,
                        const int32_t* indptr, int n_cblocks, const int32_t* tile_jb,
                        const int32_t* tile_last, int tile_off, int block_c, int block_j,
                        size_t shared_max, int32_t* out, cudaStream_t st) {
  const SlabLayout lay = slab_layout(S, w_total, tp, k, n_cblocks, n_rows, np);
  const size_t shm = static_cast<size_t>(lay.words) * sizeof(int32_t);
  if (shm > shared_max) return cudaErrorInvalidValue;
  const int grid = ((b_total + 31) / 32 + S - 1) / S;
  if (grid == 0) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      slab_term_eval_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shm));
  if (e != cudaSuccess) return e;
  const bool ids_vec = term_w == 4 && reinterpret_cast<uintptr_t>(term_chain) % 16 == 0;
  const bool chain_vec = jp % 4 == 0 && reinterpret_cast<uintptr_t>(chain) % 16 == 0;
  const bool lit_vec = reinterpret_cast<uintptr_t>(lit) % 16 == 0;   // 32 S W words a slab
  slab_term_eval_kernel<S><<<grid, kSlabThreads, shm, st>>>(
      lit, b_total, w_total, lit_vec, term_chain, tp, term_w, ids_vec, chain, lens, jp, chain_vec,
      vote_planes, np, n_rows, k, indptr, n_cblocks, tile_jb, tile_last, tile_off,
      block_c, block_j, lay, out);
  return cudaGetLastError();
}

// f(std::integral_constant<int, S>()) for slab S in {1, 2, 4, 8}.
template <class F>
cudaError_t with_slab(int slab, F f) {
  switch (slab) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    case 8: return f(std::integral_constant<int, 8>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The slab design at `slab` (1, 2, 4 or 8) sample words a CTA, exact mode:
// `out` is (b_total, k) and every row of it is written; `vote_planes` are
// the votes' bit planes, `np` of them hold every vote (kernels/
// term_infer.py:vote_planes); `shared_max` is the opt-in shared bytes a
// block may have.
extern "C" int term_infer_slab_launch(
    const uint32_t* lit, int b_total, int w_total, const int32_t* term_chain, int tp,
    int term_w, const int32_t* clause_chain, const int32_t* lens, int jp,
    const uint32_t* vote_planes, int np, int n_rows, int k, const int32_t* indptr,
    int n_cblocks, const int32_t* tile_jb, const int32_t* tile_last, int n_term_tiles,
    int block_c, int block_j, int slab, int shared_max, int32_t* out, void* stream) {
  return static_cast<int>(with_slab(slab, [&](auto s) {
    return launch_slab<decltype(s)::value>(
        lit, b_total, w_total, term_chain, tp, term_w, clause_chain, lens, jp, vote_planes, np,
        n_rows, k, indptr, n_cblocks, tile_jb, tile_last, n_term_tiles, block_c, block_j,
        static_cast<size_t>(shared_max), out, static_cast<cudaStream_t>(stream));
  }));
}

// lit_t and term_bits are tables of rows `stride` words apart: sw_total
// rounded up to a multiple of 4 (the caller allocates them so).
extern "C" int term_infer_launch(
    const uint32_t* lit, int b_total, int w_total, uint32_t* lit_t,
    int sw_total, int stride, const int32_t* term_chain, int tp, int term_w,
    uint32_t* term_bits, const int32_t* clause_chain, const int32_t* lens,
    int jp, const int32_t* votes, int n_rows, int k, const int32_t* indptr,
    int n_cblocks, const int32_t* tile_jb, const int32_t* tile_last,
    int n_term_tiles, const int32_t* margin, int block_c, int block_j, int slab,
    int32_t* out, uint32_t* fired, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the padding words transpose too (samples past b_total read as 0), so
  // stage 1 reads no word that was never written
  cudaError_t e = launch_bit_transpose(lit, b_total, w_total, stride, stride, lit_t,
                                       out, sw_total * 32 * k, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = static_cast<long long>(tp) * (stride / 4);
  if (n > 0) {
    const bool ids_vec = term_w == 4 && reinterpret_cast<uintptr_t>(term_chain) % 16 == 0;
    term_eval_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        lit_t, stride, term_chain, term_w, ids_vec, w_total * 32, n, term_bits);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(launch_chain<kIds>(
      term_bits, stride, sw_total, clause_chain, lens, jp, votes,
      n_rows, k, indptr, n_cblocks, tile_jb, tile_last, n_term_tiles, margin,
      block_c, block_j, slab, b_total, out, fired, st));
}

// Registers, threads, blocks an SM, shared bytes, spill bytes, grid x, grid
// y and threads a chain of the stage-2 walk at B samples, n_cblocks clause
// blocks of block_c, k classes and `slab` sample words a block (0: the
// heuristic's, chain_walk.cuh: slab_words), into info[0..7].
extern "C" int term_infer_occupancy(int b_total, int n_cblocks, int block_c, int k, int slab,
                                    int* info) {
  return static_cast<int>(exact_occupancy<kIds>(
      (b_total + 31) / 32, n_cblocks, block_c, k, slab, info));
}

extern "C" const char* term_infer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
