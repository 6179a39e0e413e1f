// Class-sum vote tally for Hopper (sm_90a): fired (B, C) @ votes (C, K).
//
// Replaces the Pallas TPU kernel repro/kernels/class_sum.py:
// _class_sum_kernel (launched by class_sum), the paper's class-sum adder
// bank behind the clause chain.  out[b, k] = sum_c fired[b, c] * votes[c, k]
// in int32, computed here (no library matrix product): exact, and the adds
// run in a fixed order.  fired is read as bytes, signed (int8) or not
// (uint8), so either type goes in without a conversion launch.
//
// Bounds on the H100: B x C x K multiply-adds against B x C + C x K x 4
// bytes, well under a microsecond of either at tm-mnist (C 2000-2048, K
// 10), so what costs is latency and the votes traffic: a block that reads
// all C x K votes for one sample pulls 80 KB from L2 for 2 KB of fired
// bytes.  So a thread-block cluster of `split` blocks divides the clause
// axis, and each block takes `spb` samples (B 64: 8 x 2, 256 blocks; B
// 512: 8 x 8).  A block stages its 1/split of the votes (as many classes as
// the tile has, up to 32) and its spb fired rows in shared memory by 16-byte
// cp.async, then reads each votes word once, by one lane in order (a warp
// reads 32 // K whole rows a step, lane e holding class e % K of row e / K;
// K past 32 in tiles of 32), against its spb rows.  The sums meet in fixed
// order: across a warp's lanes by shuffles, across warps in one shared-memory
// pass, and across the cluster in rank 0, to which each rank writes its
// block sums through distributed shared memory between the two halves of
// a split cluster barrier (arrived at when the block starts, waited on
// before the writes).  No atomics, no memset, one launch.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;    // clauses staged a pass
constexpr int kMaxSplit = 8;   // portable cluster size

template <int SPB>
struct Smem {
  uint8_t fired[SPB][kChunk];
  int part[kWarps][SPB][32];       // the warps' sums
  int recv[kMaxSplit][SPB][32];    // rank 0: every rank's block sums
};

// the split phases of the cluster barrier: arrive (release, or relaxed),
// then wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// n bytes (a multiple of 4; of 16 and 16-byte aligned when vec) from global
// src to shared dst by the block's threads, 16 or 4 bytes a cp.async;
// zeros where ok is false
__device__ __forceinline__ void copy_async(void* dst, const void* src, int n, bool vec,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const char* s = static_cast<const char*>(src);
  const int step = vec ? 16 : 4;
  for (int i = threadIdx.x * step; i < n; i += kThreads * step) {
    if (vec) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d + i),
                   "l"(s + i), "r"(ok ? 16 : 0));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d + i),
                   "l"(s + i), "r"(ok ? 4 : 0));
    }
  }
}

// clauses a cluster rank takes: ceil(C / split), rounded up to 16
__device__ inline int rank_clauses(int c_total, int split) {
  return ((c_total + split - 1) / split + 15) / 16 * 16;
}

template <int SPB>
__global__ void __launch_bounds__(kThreads) class_sum_kernel(
    const uint8_t* __restrict__ fired, int fired_signed,
    const int32_t* __restrict__ votes, int32_t* __restrict__ out, int b_total,
    int c_total, int k_total, int split, int aligned) {
  __shared__ __align__(16) Smem<SPB> s;
  extern __shared__ __align__(16) int votes_s[];   // (kChunk, min(K, 32))
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = split > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b0 = (blockIdx.x / split) * SPB;
  const int cr = rank_clauses(c_total, split);
  const int c_lo = min(c_total, rank * cr), c_hi = min(c_total, c_lo + cr);
  const int sx = fired_signed ? 0x80 : 0;   // (x ^ sx) - sx: the byte's value
  // every rank has started before any writes to rank 0's shared memory:
  // arrive now, wait only before those writes
  if (split > 1) cluster_arrive_relaxed();

  for (int k0 = 0; k0 < k_total; k0 += 32) {
    // lane e < cps * kw takes class k0 + e % kw of the step's clause e / kw
    const int kw = min(32, k_total - k0), cps = 32 / kw;
    const int co = lane / kw;
    const bool active = lane < cps * kw;
    int acc[SPB] = {};
    for (int f0 = c_lo; f0 < c_hi; f0 += kChunk) {
      const int n = min(kChunk, c_hi - f0);
      if (f0 > c_lo) __syncthreads();   // the last chunk is read
      if (kw == k_total) {   // one tile: the rows are contiguous
        copy_async(votes_s, votes + static_cast<size_t>(f0) * k_total, n * k_total * 4,
                   aligned && (n * k_total) % 4 == 0, true);
      } else {
        for (int e = threadIdx.x; e < n * kw; e += kThreads) {
          const int c = e / kw;
          cp_async4(&votes_s[e], votes + static_cast<size_t>(f0 + c) * k_total + k0 + e - c * kw);
        }
      }
      for (int sb = 0; sb < SPB; ++sb) {
        const bool ok = b0 + sb < b_total;
        const uint8_t* row = fired + static_cast<size_t>(ok ? b0 + sb : 0) * c_total + f0;
        if (aligned) {
          copy_async(s.fired[sb], row, n, true, ok);
        } else {
          for (int j = threadIdx.x; j < n; j += kThreads) s.fired[sb][j] = ok ? row[j] : 0;
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      if (active) {
#pragma unroll 4
        for (int c = warp * cps + co; c < n; c += kWarps * cps) {
          const int v = votes_s[c * kw + lane % kw];
#pragma unroll
          for (int sb = 0; sb < SPB; ++sb) acc[sb] += ((s.fired[sb][c] ^ sx) - sx) * v;
        }
      }
    }
    // the warp's sums: lane k < kw adds lanes k + kw, k + 2 kw, ... in order
#pragma unroll
    for (int sb = 0; sb < SPB; ++sb) {
      int sum = acc[sb];
      for (int j = 1; j < cps; ++j) sum += __shfl_down_sync(0xffffffffu, acc[sb], j * kw);
      acc[sb] = sum;
    }
    if (k0 > 0) __syncthreads();   // the last tile's partials are read
    if (lane < kw) {
#pragma unroll
      for (int sb = 0; sb < SPB; ++sb) s.part[warp][sb][lane] = acc[sb];
    }
    __syncthreads();
    if (split > 1 && k0 == 0) cluster_wait();
    // the block's sums: the warps', in order
    for (int i = threadIdx.x; i < SPB * kw; i += kThreads) {
      const int sb = i / kw, k = i - sb * kw;
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += s.part[w][sb][k];
      if (split == 1) {
        if (b0 + sb < b_total) out[static_cast<size_t>(b0 + sb) * k_total + k0 + k] = sum;
      } else {
        *cluster.map_shared_rank(&s.recv[rank][sb][k], 0) = sum;
      }
    }
    if (split > 1) {
      cluster_arrive();   // release: the sums are in rank 0's recv
      cluster_wait();
      if (rank == 0) {
        for (int i = threadIdx.x; i < SPB * kw; i += kThreads) {
          const int sb = i / kw, k = i - sb * kw;
          int sum = 0;
#pragma unroll
          for (int r = 0; r < kMaxSplit; ++r) sum += r < split ? s.recv[r][sb][k] : 0;
          if (b0 + sb < b_total) out[static_cast<size_t>(b0 + sb) * k_total + k0 + k] = sum;
        }
      }
      if (k0 + 32 < k_total) {   // rank 0 has read recv before the next tile's sums
        cluster_arrive();
        cluster_wait();
      }
    }
  }
}

using Kernel = void (*)(const uint8_t*, int, const int32_t*, int32_t*, int, int, int,
                        int, int);

// The launch shape: blocks a cluster along the clause axis (a rank takes at
// least 256 clauses) and samples a block (about 2 blocks an SM at B 64).
struct Shape {
  int split, spb;
  Kernel kernel;
  int grid_x;
};

Shape choose(int b_total, int c_total) {
  const int split = max(1, min(kMaxSplit, (c_total + 255) / 256));
  const int want = b_total * split / 256;
  const int spb = want >= 8 ? 8 : want >= 4 ? 4 : want >= 2 ? 2 : 1;
  const Kernel kernel = spb == 8   ? class_sum_kernel<8>
                        : spb == 4 ? class_sum_kernel<4>
                        : spb == 2 ? class_sum_kernel<2>
                                   : class_sum_kernel<1>;
  return {split, spb, kernel, split * ((b_total + spb - 1) / spb)};
}

// the votes staged a pass: kChunk clauses of up to 32 classes
int votes_bytes(int k_total) { return kChunk * min(k_total, 32) * static_cast<int>(sizeof(int)); }

}  // namespace

extern "C" int class_sum_launch(const uint8_t* fired, int fired_signed,
                                const int32_t* votes, int32_t* out, int b_total,
                                int c_total, int k_total, void* stream) {
  if (b_total <= 0 || k_total <= 0) return static_cast<int>(cudaSuccess);
  const Shape sh = choose(b_total, c_total);
  // 16-byte copies: fired rows and votes 16-byte aligned
  const int aligned = c_total % 16 == 0 && reinterpret_cast<uintptr_t>(fired) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(votes) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.grid_x);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = votes_bytes(k_total);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, sh.kernel, fired, fired_signed, votes, out,
                                             b_total, c_total, k_total, sh.split, aligned);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// registers, threads, blocks an SM, shared bytes (static and dynamic),
// spill bytes a thread, then the grid, the cluster size and the samples a
// block the launch chooses at this shape
extern "C" int class_sum_occupancy(int b_total, int c_total, int k_total, int* info) {
  const Shape sh = choose(b_total, c_total);
  const int dynamic = votes_bytes(k_total);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, sh.kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sh.kernel, kThreads, dynamic);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = a.numRegs;
  info[1] = kThreads;
  info[2] = blocks;
  info[3] = static_cast<int>(a.sharedSizeBytes) + dynamic;
  info[4] = static_cast<int>(a.localSizeBytes);
  info[5] = sh.grid_x;
  info[6] = sh.split;
  info[7] = sh.spb;
  return static_cast<int>(cudaSuccess);
}

extern "C" const char* class_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
