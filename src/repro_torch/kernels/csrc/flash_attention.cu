// Causal flash attention forward for Hopper (sm_90a), the LM substrate's
// attention: q (B, S, H, hd) x k (B, T, KH, hd), v (B, T, KH, dv) ->
// o (B, S, H, dv).  The qk width hd and the v width dv are separate, as in
// the TPU kernel (hd from q and k, dv from v): each pads with zeros to a
// tile width, HDK for q and k and HDV for v and o.  Taken: dv <= hd <= 128
// (HDV = HDK), and hd in (128, 192] with dv <= 128 (HDK 192, HDV 128:
// DeepSeek-V2's MLA attends with qk width 128 + 64 over v width 128).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// _flash_kernel (pallas_call in flash_forward, :104).  Same function:
// scores s = (q . k) in float32 from the input values, scaled by hd^-0.5;
// the mask t <= s on row indices; the online softmax with running max m,
// sum l and accumulator acc in float32; p = exp(s - m) in float32, added to
// l before it is cast to the input type for the product with v;
// o = acc / max(l, 1e-30).  The TPU kernel takes kv expanded to H heads;
// here query head h reads kv head h / (H / KH), the same function with
// H / KH times less kv traffic.  The TPU grid's sequential kv axis is the
// loop over kv tiles inside one CUDA block.
//
// Training also takes each row's log-sum-exp, lse (B, S, H) float32 =
// (the row's max scaled score) + log(max(l, 1e-30)), the residual of the
// recomputing backward (repro/models/attention.py:_flash_fwd): both kernels
// write it from the epilogue's m and l when the lse pointer is not null,
// and skip it when it is (serving).
//
// Bounds on the H100: at the tinyllama prefill (B 16, S = T 1024, H 32,
// hd 64) the causal products are 68.8 GFLOP against ~151 MB of q, k, v and
// o, so the dense bf16 tensor-core rate (989 TFLOP/s) bounds it: 0.070 ms.
// At DeepSeek-V2's MLA prefill (B 16, S = T 1024, H = KH 128, 192 over 128)
// they are 688 GFLOP (0.70 ms) against 2.68 GB (0.80 ms): bytes bound it;
// at S 16,384 (B 1) 11.0 TFLOP (11.1 ms) against 2.68 GB: the products.
// At hd 64 the exponentials cost about as much again: one MUFU.EX2 per
// score at 16 per SM per clock takes as long as the score's 256 FLOPs at
// that rate.  A 128-row q tile does 128 FLOP per byte of k and v it reads,
// under the card's ~295 FLOP/B ridge, so k and v have to come from L2.
//
// Three kernels, chosen by the input type, the widths and the alignment:
//
// * bfloat16: flash_fwd_wgmma_kernel, on the tensor cores through
//   Hopper's warpgroup MMA.  A block of two warpgroups (8 warps) owns one
//   (batch * head, 128-row q tile); a warpgroup owns 64 query rows, a warp
//   16 of them.  The block walks 64-key kv tiles, the q tiles with the most
//   kv tiles first.  k and v tiles arrive in two-stage rings in shared
//   memory by 16-byte cp.async, stored in the swizzled layout wgmma reads
//   without bank conflicts (128-byte swizzle at hd 64).  Up to HDK 128 a
//   warp's q rows are loaded once into A fragments (ldmatrix) and stay in
//   registers; at HDK 192 those 48 registers a thread would spill beside
//   the accumulators, so q stays in shared memory and wgmma reads it from
//   there (an A descriptor over the warpgroup's 64 rows).
//   S = Q K^T is wgmma.m64n64k16 with K from shared memory; O += P V is
//   wgmma.m64nHDVk16 with P from registers and V read
//   transposed (MN-major) from shared memory; both accumulate in float32.
//   Each step issues S of tile j + 1 and P V of tile j asynchronously, then
//   runs the softmax of tile j + 1 on its accumulator fragments while the
//   PV product runs: a thread holds two rows' values, a row's max and sum
//   meet over the four lanes of a quad in two shuffles, and the float32 C
//   fragments of two adjacent n8 score columns, packed to bf16x2, are the
//   A fragment of the PV product, so P never touches shared memory.
//   p = 2^(s * scale * log2(e) - m * scale * log2(e)) in one FFMA and one
//   ex2.approx (relative error under 2^-22, far below the 2^-9 of p's bf16
//   rounding).  Masks are applied only on tiles that cross the diagonal or
//   the t_len edge.  The output is staged in the warp's own slice of the q
//   tile and written with 16-byte stores.  Head widths are padded with
//   zeros to HDK = HDV in {16, 32, 64, 128}, or to (192, 128); dv == hd
//   up to 64 takes an instantiation with one width (SPLIT false).  Where
//   hd or dv is not a multiple of 8 (or a pointer is not 16-byte aligned)
//   tiles are staged with 2-byte loads instead of cp.async, the products
//   unchanged.
// * bfloat16 at qk widths past 64 (hd 128; MLA's 192 over 128) with
//   16-byte rows and addresses: flash_fwd_wgmma_kernel_tma (HDK 128 or 192,
//   HDV 128), the same products, softmax and epilogue on
//   128-key tiles, with the q tiles of a head side by side in the grid (k
//   and v reach HBM about once per head, then come from L2) and a producer
//   warp that loads q, k and v by TMA into mbarrier rings while two consumer
//   warpgroups take turns on the tensor cores (its own note, below).
// * float32: flash_fwd_simt_kernel, on the CUDA cores (tensor cores take
//   float32 only as TF32, which would not keep the reference's 2e-5
//   tolerance).  One block per (batch * head, 64-row q
//   tile), four threads per query row, 64-key k/v tiles staged in shared
//   memory as float32, probabilities through shared memory.  Widths pad to
//   HDK = HDV in {32, 64, 128}, or to (192, 128).

#include <algorithm>
#include <cstdint>
#include <cuda.h>   // CUtensorMap and its encoder's types; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA-core kernel

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per kv tile
constexpr int kThreads = 256;    // four per query row
constexpr int kKeysPerThread = kBK / 4;

template <int HDK, int HDV>
constexpr size_t simt_smem_bytes() {
  return sizeof(float) *
         (kBQ * (HDK + 1) + kBK * (HDK + 1) + kBK * (HDV + 1) + kBQ * (kBK + 1));
}

// HDK, HDV: the qk and v widths padded (>= hd, >= dv); the padding is zero.
template <int HDK, int HDV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int s_len, int t_len, int n_heads,
                      int n_kv_heads, int hd, int dv, int causal, float scale) {
  constexpr int LD = HDK + 1;
  constexpr int LV = HDV + 1;
  constexpr int LP = kBK + 1;
  extern __shared__ float smem[];
  float* qs = smem;                  // kBQ x LD
  float* ks = qs + kBQ * LD;         // kBK x LD
  float* vs = ks + kBK * LD;         // kBK x LV
  float* ps = vs + kBK * LV;         // kBQ x LP

  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const int hk = h / (n_heads / n_kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2, quad = tid & 3;
  const int qrow = q0 + r;
  const size_t q_step = static_cast<size_t>(n_heads) * hd;
  const size_t k_step = static_cast<size_t>(n_kv_heads) * hd;
  const size_t v_step = static_cast<size_t>(n_kv_heads) * dv;
  const size_t o_step = static_cast<size_t>(n_heads) * dv;
  const float* qb = q + static_cast<size_t>(b) * s_len * q_step + static_cast<size_t>(h) * hd;
  const float* kb = k + static_cast<size_t>(b) * t_len * k_step + static_cast<size_t>(hk) * hd;
  const float* vb = v + static_cast<size_t>(b) * t_len * v_step + static_cast<size_t>(hk) * dv;

  for (int i = tid; i < kBQ * HDK; i += kThreads) {
    const int rr = i / HDK, d = i % HDK;
    float x = 0.f;
    if (q0 + rr < s_len && d < hd) x = qb[(q0 + rr) * q_step + d];
    qs[rr * LD + d] = x;
  }

  float m = kNegInf, l = 0.f;
  float acc[HDV / 4];
#pragma unroll
  for (int j = 0; j < HDV / 4; ++j) acc[j] = 0.f;

  int n_tiles = (t_len + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's readers are done; q is staged
    for (int i = tid; i < kBK * HDK; i += kThreads) {
      const int rr = i / HDK, d = i % HDK;
      ks[rr * LD + d] = k0 + rr < t_len && d < hd ? kb[(k0 + rr) * k_step + d] : 0.f;
    }
    for (int i = tid; i < kBK * HDV; i += kThreads) {
      const int rr = i / HDV, d = i % HDV;
      vs[rr * LV + d] = k0 + rr < t_len && d < dv ? vb[(k0 + rr) * v_step + d] : 0.f;
    }
    __syncthreads();

    // scores of this thread's keys quad, quad + 4, ..., quad + 60
    float s[kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDK; ++d) {
      const float qd = qs[r * LD + d];
#pragma unroll
      for (int i = 0; i < kKeysPerThread; ++i)
        s[i] = fmaf(qd, ks[(quad + 4 * i) * LD + d], s[i]);
    }
    float tile_max = kNegInf;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const int key = k0 + quad + 4 * i;
      const bool ok = key < t_len && (!causal || key <= qrow);
      s[i] = ok ? s[i] * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[i]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const float p = expf(s[i] - m_new);
      psum += p;
      ps[r * LP + quad + 4 * i] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncthreads();

    // this thread's output dimensions quad, quad + 4, ...
#pragma unroll
    for (int j = 0; j < HDV / 4; ++j) acc[j] *= corr;
#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      const float p = ps[r * LP + key];
#pragma unroll
      for (int j = 0; j < HDV / 4; ++j)
        acc[j] = fmaf(p, vs[key * LV + quad + 4 * j], acc[j]);
    }
  }

  if (qrow < s_len) {
    float* ob = o + (static_cast<size_t>(b) * s_len + qrow) * o_step + static_cast<size_t>(h) * dv;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < HDV / 4; ++j) {
      const int d = quad + 4 * j;
      if (d < dv) ob[d] = acc[j] / denom;
    }
    // the row's log-sum-exp for the backward: m is in scaled units here
    if (lse != nullptr && quad == 0)
      lse[(static_cast<size_t>(b) * s_len + qrow) * n_heads + h] = m + logf(denom);
  }
}

template <int HDK, int HDV>
int launch_simt(const void* q, const void* k, const void* v, void* o, void* lse, dim3 grid,
                int s_len, int t_len, int n_heads, int n_kv_heads, int hd, int dv, int causal,
                float scale, cudaStream_t stream) {
  constexpr size_t smem = simt_smem_bytes<HDK, HDV>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_simt_kernel<HDK, HDV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_fwd_simt_kernel<HDK, HDV><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), s_len,
      t_len, n_heads, n_kv_heads, hd, dv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel (wgmma)

using bf16 = __nv_bfloat16;

// Warpgroups per block, 64 query rows each: two measured faster than one
// at the tinyllama prefill
constexpr int kWarpgroups = 2;
constexpr int kTcThreads = 128 * kWarpgroups;
constexpr int kTcBQ = 64 * kWarpgroups;     // query rows per block
constexpr int kTcBK = 64;                   // keys per kv tile

// Shared tiles hold rows of HDP bf16 in swizzle atoms of AW = min(HDP, 64)
// elements (32, 64 or 128 bytes): the 16-byte chunk c of row r sits at
// chunk c ^ ((r * AW * 2 / 128) % (AW / 8)) of its atom row, the layout
// wgmma reads without bank conflicts; at HDP 128 (192) a tile is two
// (three) atoms wide, stored one after the other.
template <int HDP>
struct TcTile {
  static constexpr int AW = HDP < 64 ? HDP : 64;
  static constexpr int ACH = AW / 8;                  // 16-byte chunks per atom row
  static constexpr uint32_t SBO = 8 * AW * 2;         // bytes between 8-row groups
  // descriptor layout type: 128-, 64- or 32-byte swizzle
  static constexpr uint64_t SWIZZLE = static_cast<uint64_t>(AW == 64 ? 1 : AW == 32 ? 2 : 3) << 62;
  static constexpr int KV = kTcBK * HDP;              // elements of a k or v tile

  // element offset of chunk c of row r in a tile of `rows` rows
  static __device__ __forceinline__ int at(int r, int c, int rows) {
    const int cc = c % ACH;
    return (c / ACH) * rows * AW + r * AW + ((cc ^ ((r * AW * 2 >> 7) & (ACH - 1))) * 8);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// shared-memory writes of the generic proxy (cp.async, stores) become
// visible to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from touching registers that an in-flight wgmma owns
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory matrix descriptor: start, leading and stride byte
// offsets (in 16-byte units), swizzle mode
__device__ __forceinline__ uint64_t smem_desc(const bf16* p, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         swizzle;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// 2^x in one MUFU.EX2 (relative error under 2^-22); results under 2^-126
// flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// d (64 x 64, float32) (+)= a (64 x 16, registers) b (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_n64_k(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 64, float32) (+)= a (64 x 16, shared, K-major) b (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_n64_ss(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, float32) (+)= a (64 x 16, shared, K-major) b (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_n128_ss(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 16, float32) += a (64 x 16, registers) b (16 x 16, shared, MN-major)
__device__ __forceinline__ void wgmma_n16_mn(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (64 x 32, float32) += a (64 x 16, registers) b (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_n32_mn(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (64 x 64, float32) += a (64 x 16, registers) b (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_n64_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (64 x 128, float32) += a (64 x 16, registers) b (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_n128_mn(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 16) wgmma_n16_mn(d, a, b);
  else if constexpr (N == 32) wgmma_n32_mn(d, a, b);
  else if constexpr (N == 64) wgmma_n64_mn(d, a, b);
  else wgmma_n128_mn(d, a, b);
}

// rows [r0, r0 + n_rows) of a (rows, hd) matrix with row stride `step`
// elements -> a swizzled tile of width HDP, zero past `rows` and `hd`
template <int HDP>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int step, int r0,
                                           int rows, int n_rows, int hd, bool vec16) {
  using T = TcTile<HDP>;
  if (vec16) {
    constexpr int CPR = HDP / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < n_rows * CPR; i += kTcThreads) {
      const int r = i / CPR, c = i % CPR;
      const bool ok = r0 + r < rows && c * 8 < hd;
      const bf16* p = ok ? src + static_cast<size_t>(r0 + r) * step + c * 8 : src;
      cp_async16(dst + T::at(r, c, n_rows), p, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * HDP; i += kTcThreads) {
      const int r = i / HDP, d = i % HDP;
      bf16 x = __float2bfloat16(0.f);
      if (r0 + r < rows && d < hd) x = src[static_cast<size_t>(r0 + r) * step + d];
      dst[T::at(r, d / 8, n_rows) + d % 8] = x;
    }
  }
}

// S (64 x 64 per warpgroup) = Q K^T, Q from registers, K (64 keys) K-major
template <int HDP>
__device__ __forceinline__ void qk_issue(float (&s)[32], const uint32_t (&qf)[HDP / 16][4],
                                         const bf16* kt) {
  using T = TcTile<HDP>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const bf16* p = kt + (kk * 16 / T::AW) * kTcBK * T::AW + kk * 16 % T::AW;
    wgmma_n64_k(s, qf[kk], smem_desc(p, 16, T::SBO, T::SWIZZLE), kk > 0);
  }
  wgmma_commit();
}

// The same with Q read from shared memory: the warpgroup's 64 rows, from
// row q_row0 of the kTcBQ-row q tile, K-major like K (BK keys: 64 or 128)
template <int HDP, int BK = kTcBK>
__device__ __forceinline__ void qk_issue_ss(float (&s)[BK / 2], const bf16* qt, int q_row0,
                                            const bf16* kt) {
  using T = TcTile<HDP>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const int atom = kk * 16 / T::AW, col = kk * 16 % T::AW;
    const bf16* a = qt + atom * kTcBQ * T::AW + q_row0 * T::AW + col;
    const bf16* b = kt + atom * BK * T::AW + col;
    const uint64_t da = smem_desc(a, 16, T::SBO, T::SWIZZLE);
    const uint64_t db = smem_desc(b, 16, T::SBO, T::SWIZZLE);
    if constexpr (BK == 64) wgmma_n64_ss(s, da, db, kk > 0);
    else wgmma_n128_ss(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// S = Q K^T of one k tile, issued asynchronously, Q from shared memory
// (Q_SMEM: qs, the warpgroup's rows from q_row0) or from registers (qf)
template <int HDP, bool Q_SMEM>
__device__ __forceinline__ void qk_any(float (&s)[32],
                                       const uint32_t (&qf)[Q_SMEM ? 1 : HDP / 16][4],
                                       const bf16* qs, int q_row0, const bf16* kt) {
  if constexpr (Q_SMEM) qk_issue_ss<HDP>(s, qs, q_row0, kt);
  else qk_issue<HDP>(s, qf, kt);
}

// O (64 x HDP per warpgroup) += P V, P from registers, V (BK keys) MN-major
template <int HDP, int BK = kTcBK>
__device__ __forceinline__ void pv_issue(float (&acc)[HDP / 2], const uint32_t (&pf)[BK / 16][4],
                                         const bf16* vt) {
  using T = TcTile<HDP>;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    wgmma_pv<HDP>(acc, pf[j], smem_desc(vt + j * 16 * T::AW, BK * T::AW * 2, T::SBO,
                                        T::SWIZZLE));
  wgmma_commit();
}

// The online softmax step on one tile's score fragments: a thread holds
// rows row0 and row0 + 8, BK / 4 keys each.  Masks only where the tile
// crosses the diagonal or t_len.  p = exp(s * scale - m * scale) = 2^(s *
// sl2 - m * sl2), with m the running max of the unscaled scores, in
// float32, summed into l; s is overwritten by p; corr = exp(m_old - m_new)
// per row.
template <int BK = kTcBK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool masked, int k0, int row0,
                                             int t_len, int causal, float sl2, int tq) {
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    if (masked) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * tq + (e & 1);
        if (key >= t_len || (causal && key > row0 + (e >> 1) * 8)) s[4 * n + e] = kNegInf;
      }
    }
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  const float mb0 = mx0 * sl2, mb1 = mx1 * sl2;
  corr[0] = exp2_ftz(fmaf(m[0], sl2, -mb0));
  corr[1] = exp2_ftz(fmaf(m[1], sl2, -mb1));
  m[0] = mx0;
  m[1] = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    s[4 * n] = exp2_ftz(fmaf(s[4 * n], sl2, -mb0));
    s[4 * n + 1] = exp2_ftz(fmaf(s[4 * n + 1], sl2, -mb0));
    s[4 * n + 2] = exp2_ftz(fmaf(s[4 * n + 2], sl2, -mb1));
    s[4 * n + 3] = exp2_ftz(fmaf(s[4 * n + 3], sl2, -mb1));
    ps0 += s[4 * n] + s[4 * n + 1];
    ps1 += s[4 * n + 2] + s[4 * n + 3];
  }
  l[0] = l[0] * corr[0] + quad_sum(ps0);
  l[1] = l[1] * corr[1] + quad_sum(ps1);
}

// p packed to bf16: the C fragments of score tiles 2j and 2j + 1 are the A
// fragment j of P
template <int BK = kTcBK>
__device__ __forceinline__ void pack_p(uint32_t (&pf)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) pf[j][e] = pack_bf16(s[8 * j + 2 * e], s[8 * j + 2 * e + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= corr[(i >> 1) & 1];
}

// The epilogue of a warp's 16 rows from row_lo: o = acc / max(l, 1e-30) as
// bf16, staged in `os`, 16 x HDV bf16 of shared memory the warp owns (chunk
// c of row r at (r / 8 * CPR + c) * 64 + r % 8 * 8), then written with
// 16-byte stores (vec) or 2-byte ones; and, where lse is not null, the rows'
// log-sum-exp for the backward: m is in raw-dot units and l the
// natural-base sum, so lse = m * scale + log(l); the quad shares m and l
template <int HDV>
__device__ __forceinline__ void store_rows(const float (&acc)[HDV / 2], const float (&m)[2],
                                           const float (&l)[2], bf16* os, bf16* o, float* lse,
                                           int b, int h, int row_lo, int s_len, int n_heads,
                                           int dv, int o_step, float scale, bool vec) {
  constexpr int CPR = HDV / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, row0 = row_lo + g;
  const float d0 = fmaxf(l[0], 1e-30f), d1 = fmaxf(l[1], 1e-30f);
  if (lse != nullptr && tq == 0) {
    if (row0 < s_len)
      lse[(static_cast<size_t>(b) * s_len + row0) * n_heads + h] = fmaf(m[0], scale, logf(d0));
    if (row0 + 8 < s_len)
      lse[(static_cast<size_t>(b) * s_len + row0 + 8) * n_heads + h] =
          fmaf(m[1], scale, logf(d1));
  }
#pragma unroll
  for (int n = 0; n < HDV / 8; ++n) {
    *reinterpret_cast<uint32_t*>(os + n * 64 + g * 8 + 2 * tq) =
        pack_bf16(acc[4 * n] / d0, acc[4 * n + 1] / d0);
    *reinterpret_cast<uint32_t*>(os + (CPR + n) * 64 + g * 8 + 2 * tq) =
        pack_bf16(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
  }
  __syncwarp();
  bf16* ob = o + static_cast<size_t>(b) * s_len * o_step + static_cast<size_t>(h) * dv;
  if (vec) {
    for (int i = lane; i < 16 * CPR; i += 32) {
      const int r = i / CPR, c = i % CPR;
      if (row_lo + r < s_len && c * 8 < dv)
        *reinterpret_cast<uint4*>(ob + static_cast<size_t>(row_lo + r) * o_step + c * 8) =
            *reinterpret_cast<const uint4*>(os + ((r >> 3) * CPR + c) * 64 + (r & 7) * 8);
    }
  } else {
    for (int i = lane; i < 16 * HDV; i += 32) {
      const int r = i / HDV, d = i % HDV;
      if (row_lo + r < s_len && d < dv)
        ob[static_cast<size_t>(row_lo + r) * o_step + d] =
            os[((r >> 3) * CPR + (d >> 3)) * 64 + (r & 7) * 8 + (d & 7)];
    }
  }
}

// q, 2 k and 2 v stages in shared memory
template <int HDK, int HDV>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * (HDK * (kTcBQ + 2 * kTcBK) + HDV * 2 * kTcBK);
}

// HDK, HDV: the qk and v widths padded; HDK > 128 keeps q in shared memory.
// SPLIT: dv may differ from hd; without it v and o take q's and k's width
// and strides, and the kernel keeps no second width in registers.  Taken
// for dv == hd up to HDK 64, where two blocks an SM leave 128 registers a
// thread: there the second width's registers spill more (hd 64: 136 bytes
// of stack against 48) and the kernel ran 2.9% slower in turns
// (scripts/torch_flash_ab.py).  At HDK 128 (one block an SM) the split
// kernel ran 3.3% faster than a one-width one, so dv == hd takes it there
// too.  Resident blocks per SM the registers are budgeted for: two up to
// HDK 64, else one.
template <int HDK, int HDV, bool SPLIT>
__global__ void __launch_bounds__(kTcThreads, HDK > 64 ? 1 : 2)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int s_len, int t_len, int n_heads,
                       int n_kv_heads, int hd, int dv_, int q_step, int k_step, int v_step_,
                       int o_step_, int causal, float scale, int vec16) {
  static_assert(SPLIT || HDK == HDV, "one width needs HDK == HDV");
  const int dv = SPLIT ? dv_ : hd;
  const int v_step = SPLIT ? v_step_ : k_step, o_step = SPLIT ? o_step_ : q_step;
  using TK = TcTile<HDK>;
  using TV = TcTile<HDV>;
  constexpr bool Q_SMEM = HDK > 128;
  constexpr int BQ = kTcBQ, BK = kTcBK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // BQ rows
  bf16* ks = qs + BQ * HDK;                        // 2 stages of BK rows
  bf16* vs = ks + 2 * TK::KV;                      // 2 stages of BK rows

  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const int hk = h / (n_heads / n_kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int wrow = (threadIdx.x >> 5) * 16;   // the warp's first row in the q tile
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int row_lo = q0 + wrow, row0 = row_lo + g;
  // row strides in elements (a row is far under 2^31); offsets in size_t
  const bf16* qb = q + static_cast<size_t>(b) * s_len * q_step + static_cast<size_t>(h) * hd;
  const bf16* kb = k + static_cast<size_t>(b) * t_len * k_step + static_cast<size_t>(hk) * hd;
  const bf16* vb = v + static_cast<size_t>(b) * t_len * v_step + static_cast<size_t>(hk) * dv;
  const bool vec = vec16 != 0;
  const float sl2 = scale * 1.4426950408889634f;   // scale * log2(e)

  int n_tiles = (t_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  auto masked = [&](int t) {
    return (causal && t * BK + BK - 1 > row_lo) || t * BK + BK > t_len;
  };

  // q and k of tile 0, then k of tile 1 and v of tile 0
  stage_tile<HDK>(qs, qb, q_step, q0, s_len, BQ, hd, vec);
  stage_tile<HDK>(ks, kb, k_step, 0, t_len, BK, hd, vec);
  cp_async_commit();
  if (n_tiles > 1) stage_tile<HDK>(ks + TK::KV, kb, k_step, BK, t_len, BK, hd, vec);
  stage_tile<HDV>(vs, vb, v_step, 0, t_len, BK, dv, vec);
  cp_async_commit();
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  fence_proxy_async();
  __syncthreads();

  // the warp's 16 q rows as A fragments, in registers for the whole loop
  // (at HDK 192 wgmma reads the warpgroup's rows from shared memory)
  const int wg_row0 = (threadIdx.x >> 7) * 64;
  uint32_t qf[Q_SMEM ? 1 : HDK / 16][4];
  if constexpr (!Q_SMEM) {
#pragma unroll
    for (int kk = 0; kk < HDK / 16; ++kk) {
      const int r = wrow + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(qf[kk], qs + TK::at(r, 2 * kk + (lane >> 4), BQ));
    }
  }

  float acc[HDV / 2];
#pragma unroll
  for (int i = 0; i < HDV / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  float s[32];
  uint32_t pf[4][4];
  qk_any<HDK, Q_SMEM>(s, qf, qs, wg_row0, ks);
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile(s, m, l, corr, masked(0), 0, row0, t_len, causal, sl2, tq);
  pack_p(pf, s);

  // Tile t: issue S of tile t + 1 and O += P V of tile t on the tensor
  // cores; the softmax of tile t + 1 runs while the PV product does.  The
  // copies of k of tile t + 2 and v of tile t + 1 overlap the whole step.
  for (int t = 0; t + 1 < n_tiles; ++t) {
    cp_async_wait_all();   // k of tile t + 1 and v of tile t
    fence_proxy_async();
    __syncthreads();       // and every warp is done with the stages refilled now
    if (t + 2 < n_tiles)
      stage_tile<HDK>(ks + (t & 1) * TK::KV, kb, k_step, (t + 2) * BK, t_len, BK, hd, vec);
    stage_tile<HDV>(vs + ((t + 1) & 1) * TV::KV, vb, v_step, (t + 1) * BK, t_len, BK, dv, vec);
    cp_async_commit();
    qk_any<HDK, Q_SMEM>(s, qf, qs, wg_row0, ks + ((t + 1) & 1) * TK::KV);
    rescale(acc, corr);
    pv_issue<HDV>(acc, pf, vs + (t & 1) * TV::KV);
    wgmma_wait<1>();       // S of tile t + 1
    fence_regs(s);
    softmax_tile(s, m, l, corr, masked(t + 1), (t + 1) * BK, row0, t_len, causal, sl2, tq);
    wgmma_wait<0>();       // PV of tile t
    fence_regs(acc);
    fence_regs(pf);
    pack_p(pf, s);
  }
  cp_async_wait_all();     // v of the last tile
  fence_proxy_async();
  __syncthreads();
  rescale(acc, corr);
  pv_issue<HDV>(acc, pf, vs + ((n_tiles - 1) & 1) * TV::KV);
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(pf);

  // every warp's reads of q (ldmatrix, or wgmma at HDK 192) ended before
  // the __syncthreads above: the warp's 16 x HDV slice of the q tile stages o
  store_rows<HDV>(acc, m, l, qs + wrow * HDV, o, lse, b, h, row_lo, s_len, n_heads, dv, o_step,
                  scale, vec);
}

template <int HDK, int HDV, bool SPLIT>
int launch_wgmma_as(const void* q, const void* k, const void* v, void* o, void* lse,
                    int b_total, int s_len, int t_len, int n_heads, int n_kv_heads, int hd,
                    int dv, int causal, float scale, int vec16, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<HDK, HDV>();
  const dim3 grid(b_total * n_heads, (s_len + kTcBQ - 1) / kTcBQ);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<HDK, HDV, SPLIT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_fwd_wgmma_kernel<HDK, HDV, SPLIT><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse), s_len,
      t_len, n_heads, n_kv_heads, hd, dv, n_heads * hd, n_kv_heads * hd, n_kv_heads * dv,
      n_heads * dv, causal, scale, vec16);
  return static_cast<int>(cudaGetLastError());
}

// one width (dv == hd, up to HDK 64) or two
template <int HDK, int HDV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, int b_total,
                 int s_len, int t_len, int n_heads, int n_kv_heads, int hd, int dv, int causal,
                 float scale, int vec16, cudaStream_t stream) {
  if constexpr (HDK == HDV && HDK <= 64) {
    if (dv == hd)
      return launch_wgmma_as<HDK, HDV, false>(q, k, v, o, lse, b_total, s_len, t_len,
                                              n_heads, n_kv_heads, hd, dv, causal, scale,
                                              vec16, stream);
  }
  return launch_wgmma_as<HDK, HDV, true>(q, k, v, o, lse, b_total, s_len, t_len, n_heads,
                                         n_kv_heads, hd, dv, causal, scale, vec16, stream);
}

// ---------------------------------------------------------------------------
// bfloat16, warp-specialized: TMA loads, a head's q tiles side by side

constexpr int kTmaBK = 128;                        // keys per kv tile
constexpr int kTmaStages = 2;                      // k and v tiles in flight, each
constexpr int kTmaThreads = 128 * (kWarpgroups + 1);   // a producer warpgroup, two consumers
// named barriers (0 is __syncthreads): a consumer warpgroup's turn to issue
// its products, and each consumer warpgroup's own
constexpr int kTurnBar = 1, kWgBar = 3;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of TMA writes before the phase ends
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// a (64 columns, 1 head, rows, 1 batch) box at coordinates c0..c3 of a 4-D
// tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(bf16* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int HDK, int HDV>
struct TmaLayout {
  static constexpr uint32_t Q = kTcBQ * HDK * 2, K = kTmaBK * HDK * 2, V = kTmaBK * HDV * 2;
  // q | k stages | v stages | barriers: q, k full, v full, k empty, v empty
  static constexpr size_t BARS = Q + kTmaStages * (K + V);
  // 1024 bytes of slack align the base to the 128-byte swizzle's period
  static constexpr size_t BYTES = 1024 + BARS + (1 + 4 * kTmaStages) * sizeof(uint64_t);
};

// One block per (batch * head, 128-row q tile), as flash_fwd_wgmma_kernel,
// with two changes.  The q tile is blockIdx.x, fastest, with the heaviest
// first, and b * H + h is blockIdx.y: the blocks resident together are most
// of one head's q tiles (of a few heads' at short lengths), so a k or v tile
// reaches HBM about once per head and then comes from L2; query heads that
// share a kv head are adjacent.  And the block is warp-specialized: warp 0
// of warpgroup 0 (40 registers) loads q once and k and v tiles of kTmaBK
// keys by TMA into rings of kTmaStages, each stage with a full and an empty
// mbarrier, k and v apart so a k stage is refilled as soon as its S product
// is done; warpgroups 1 and 2 (232 registers) own 64 query rows each and
// run flash_fwd_wgmma_kernel's steps (S of tile t + 1 and PV of tile t
// issued together, the softmax of tile t + 1 under the PV product), with
// no block-wide barrier in the loop.  Two named barriers hand the turn to
// issue products from one consumer warpgroup to the other, so one's softmax
// runs under the other's products.  The tensor maps' 128-byte swizzle is
// TcTile's layout; the maps are 4-D (width, heads, rows, batch), so rows
// past a batch's end and columns past hd or dv arrive as zeros.
template <int HDK, int HDV>
__global__ void __launch_bounds__(kTmaThreads, 1)
flash_fwd_wgmma_kernel_tma(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                           float* __restrict__ lse, int s_len, int t_len, int n_heads,
                           int n_kv_heads, int dv, int causal, float scale) {
  using L = TmaLayout<HDK, HDV>;
  constexpr int BQ = kTcBQ, BK = kTmaBK, ST = kTmaStages;
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  unsigned char* base = smem_tma + ((1024 - (smem_addr(smem_tma) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(base);
  bf16* ks = reinterpret_cast<bf16*>(base + L::Q);
  bf16* vs = reinterpret_cast<bf16*>(base + L::Q + ST * L::K);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::BARS);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;

  const int b = blockIdx.y / n_heads, h = blockIdx.y % n_heads;
  const int hk = h / (n_heads / n_kv_heads);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  int n_tiles = (t_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(v_full + i, 1);
      mbar_init(k_empty + i, kWarpgroups);
      mbar_init(v_empty + i, kWarpgroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::Q);
#pragma unroll
      for (int a = 0; a < HDK / 64; ++a)
        tma_load(qs + a * BQ * 64, &qmap, q_full, a * 64, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % ST, use = t / ST;
        if (use > 0) mbar_wait(k_empty + st, (use - 1) & 1);
        mbar_expect_tx(k_full + st, L::K);
#pragma unroll
        for (int a = 0; a < HDK / 64; ++a)
          tma_load(ks + st * BK * HDK + a * BK * 64, &kmap, k_full + st, a * 64, hk, t * BK, b);
        if (use > 0) mbar_wait(v_empty + st, (use - 1) & 1);
        mbar_expect_tx(v_full + st, L::V);
#pragma unroll
        for (int a = 0; a < HDV / 64; ++a)
          tma_load(vs + st * BK * HDV + a * BK * 64, &vmap, v_full + st, a * 64, hk, t * BK, b);
      }
    }
  } else {
    // consumers: warpgroup cw owns rows cw * 64 ... of the q tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;
    const int warp = (threadIdx.x >> 5) - 4;      // 0..7 over both consumer warpgroups
    const int wrow = warp * 16;                    // the warp's first row in the q tile
    const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
    const int row_lo = q0 + wrow, row0 = row_lo + g;
    const bool leader = (threadIdx.x & 127) == 0;  // arrives on the empty barriers
    const float sl2 = scale * 1.4426950408889634f;
    auto masked = [&](int t) {
      return (causal && t * BK + BK - 1 > row_lo) || t * BK + BK > t_len;
    };
    // the turn to issue: warpgroup 0 first; each hands it over after issuing,
    // warpgroup 1 not after its last, so every arrival meets a wait
    auto take_turn = [&] { bar_sync(kTurnBar + cw, 256); };
    auto pass_turn = [&](int t) {
      if (cw == 0 || t + 1 < n_tiles) bar_arrive(kTurnBar + 1 - cw, 256);
    };
    if (cw == 1) bar_arrive(kTurnBar, 256);

    float acc[HDV / 2];
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
    float s[BK / 2];
    uint32_t pf[BK / 16][4];
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    take_turn();
    qk_issue_ss<HDK, BK>(s, qs, cw * 64, ks);
    pass_turn(0);
    wgmma_wait<0>();
    fence_regs(s);
    if (leader) mbar_arrive(k_empty);
    softmax_tile<BK>(s, m, l, corr, masked(0), 0, row0, t_len, causal, sl2, tq);
    pack_p<BK>(pf, s);

    for (int t = 0; t + 1 < n_tiles; ++t) {
      const int s0 = t % ST, s1 = (t + 1) % ST;
      mbar_wait(k_full + s1, ((t + 1) / ST) & 1);
      take_turn();
      qk_issue_ss<HDK, BK>(s, qs, cw * 64, ks + s1 * BK * HDK);
      rescale(acc, corr);
      mbar_wait(v_full + s0, (t / ST) & 1);
      pv_issue<HDV, BK>(acc, pf, vs + s0 * BK * HDV);
      pass_turn(t + 1);
      wgmma_wait<1>();       // S of tile t + 1
      fence_regs(s);
      if (leader) mbar_arrive(k_empty + s1);
      softmax_tile<BK>(s, m, l, corr, masked(t + 1), (t + 1) * BK, row0, t_len, causal, sl2, tq);
      wgmma_wait<0>();       // PV of tile t
      fence_regs(acc);
      fence_regs(pf);
      if (leader) mbar_arrive(v_empty + s0);
      pack_p<BK>(pf, s);
    }
    const int sl = (n_tiles - 1) % ST;
    mbar_wait(v_full + sl, ((n_tiles - 1) / ST) & 1);
    rescale(acc, corr);
    pv_issue<HDV, BK>(acc, pf, vs + sl * BK * HDV);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pf);

    // o staged in the warpgroup's own q rows (16 x HDV a warp: warps 0, 1 in
    // q's first 64-column atom, warps 2, 3 in its second), once every warp of
    // the warpgroup is past its last product
    bar_sync(kWgBar + cw, 128);
    const int wl = warp & 3;
    store_rows<HDV>(acc, m, l, qs + (wl >> 1) * BQ * 64 + cw * 64 * 64 + (wl & 1) * 32 * 64, o,
                    lse, b, h, row_lo, s_len, n_heads, dv, n_heads * dv, scale, true);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled through the runtime, so the library
// needs no -lcuda; null where the driver has none
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got{};
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &got);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    return e == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// (batch, rows, heads, width) bf16 as a 4-D map, innermost first, read in
// boxes of 64 columns x `box_rows` rows with the 128-byte swizzle; reads
// past an edge fill with zeros
bool encode_map(EncodeTiled enc, CUtensorMap* map, const void* p, int width, int heads, int rows,
                int batch, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(width) * heads * sizeof(bf16);
  const cuuint64_t strides[3] = {width * sizeof(bf16), row, row * rows};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// grid (q tiles, batches * H); gridDim.y's 65,535 is kept by launching
// batches in groups
template <int HDK, int HDV>
int launch_tma(const void* q, const void* k, const void* v, void* o, void* lse, int b_total,
               int s_len, int t_len, int n_heads, int n_kv_heads, int hd, int dv, int causal,
               float scale, cudaStream_t stream) {
  using L = TmaLayout<HDK, HDV>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (n_heads > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel_tma<HDK, HDV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int group = 65535 / n_heads, nq = (s_len + kTcBQ - 1) / kTcBQ;
  const size_t q_b = static_cast<size_t>(s_len) * n_heads * hd;
  const size_t k_b = static_cast<size_t>(t_len) * n_kv_heads * hd;
  const size_t v_b = static_cast<size_t>(t_len) * n_kv_heads * dv;
  const size_t o_b = static_cast<size_t>(s_len) * n_heads * dv;
  for (int b0 = 0; b0 < b_total; b0 += group) {
    const int nb = std::min(group, b_total - b0);
    CUtensorMap qm, km, vm;
    if (!encode_map(enc, &qm, static_cast<const bf16*>(q) + b0 * q_b, hd, n_heads, s_len, nb,
                    kTcBQ) ||
        !encode_map(enc, &km, static_cast<const bf16*>(k) + b0 * k_b, hd, n_kv_heads, t_len, nb,
                    kTmaBK) ||
        !encode_map(enc, &vm, static_cast<const bf16*>(v) + b0 * v_b, dv, n_kv_heads, t_len, nb,
                    kTmaBK))
      return static_cast<int>(cudaErrorInvalidValue);
    float* lse_b = static_cast<float*>(lse);
    if (lse_b != nullptr) lse_b += static_cast<size_t>(b0) * s_len * n_heads;
    const dim3 grid(nq, nb * n_heads);
    flash_fwd_wgmma_kernel_tma<HDK, HDV><<<grid, kTmaThreads, L::BYTES, stream>>>(
        qm, km, vm, static_cast<bf16*>(o) + b0 * o_b, lse_b, s_len, t_len, n_heads, n_kv_heads, dv,
        causal, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}

// the widths the kernels take: dv <= hd <= 128, or hd <= 192 with dv <= 128
// (flash_attention.py:takes)
bool bad_shape(int hd, int dv, int t_len, int n_heads, int n_kv_heads) {
  return dv <= 0 || dv > hd || hd > 192 || dv > 128 || t_len <= 0 || n_kv_heads <= 0 ||
         n_heads % n_kv_heads;
}

}  // namespace

// float32 on the CUDA cores
extern "C" int flash_forward_simt_launch(const void* q, const void* k, const void* v,
                                         void* o, void* lse, int b_total, int s_len, int t_len,
                                         int n_heads, int n_kv_heads, int hd, int dv,
                                         int causal, float scale, void* stream) {
  if (b_total <= 0 || s_len <= 0) return static_cast<int>(cudaSuccess);
  if (bad_shape(hd, dv, t_len, n_heads, n_kv_heads))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b_total * n_heads, (s_len + kBQ - 1) / kBQ);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 32)
    return launch_simt<32, 32>(q, k, v, o, lse, grid, s_len, t_len, n_heads, n_kv_heads, hd,
                               dv, causal, scale, st);
  if (hd <= 64)
    return launch_simt<64, 64>(q, k, v, o, lse, grid, s_len, t_len, n_heads, n_kv_heads, hd,
                               dv, causal, scale, st);
  if (hd <= 128)
    return launch_simt<128, 128>(q, k, v, o, lse, grid, s_len, t_len, n_heads, n_kv_heads, hd,
                                 dv, causal, scale, st);
  return launch_simt<192, 128>(q, k, v, o, lse, grid, s_len, t_len, n_heads, n_kv_heads, hd,
                               dv, causal, scale, st);
}

// bfloat16 on the tensor cores; *tma is set to 1 where the warp-specialized
// design ran
extern "C" int flash_forward_wgmma_launch(const void* q, const void* k, const void* v,
                                          void* o, void* lse, int b_total, int s_len, int t_len,
                                          int n_heads, int n_kv_heads, int hd, int dv,
                                          int causal, float scale, void* stream, int* tma) {
  *tma = 0;
  if (b_total <= 0 || s_len <= 0) return static_cast<int>(cudaSuccess);
  if (bad_shape(hd, dv, t_len, n_heads, n_kv_heads))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr_bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                              reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const int vec16 = hd % 8 == 0 && dv % 8 == 0 && addr_bits % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the warp-specialized design past qk width 64 (flash_attention.py:tma_design);
  // TMA needs 16-byte rows and addresses
  *tma = hd > 64 && vec16;
  if (*tma && hd > 128)
    return launch_tma<192, 128>(q, k, v, o, lse, b_total, s_len, t_len, n_heads, n_kv_heads, hd,
                                dv, causal, scale, st);
  if (*tma)
    return launch_tma<128, 128>(q, k, v, o, lse, b_total, s_len, t_len, n_heads, n_kv_heads, hd,
                                dv, causal, scale, st);
  if (hd <= 16)
    return launch_wgmma<16, 16>(q, k, v, o, lse, b_total, s_len, t_len, n_heads, n_kv_heads,
                                hd, dv, causal, scale, vec16, st);
  if (hd <= 32)
    return launch_wgmma<32, 32>(q, k, v, o, lse, b_total, s_len, t_len, n_heads, n_kv_heads,
                                hd, dv, causal, scale, vec16, st);
  if (hd <= 64)
    return launch_wgmma<64, 64>(q, k, v, o, lse, b_total, s_len, t_len, n_heads, n_kv_heads,
                                hd, dv, causal, scale, vec16, st);
  if (hd <= 128)
    return launch_wgmma<128, 128>(q, k, v, o, lse, b_total, s_len, t_len, n_heads, n_kv_heads,
                                  hd, dv, causal, scale, vec16, st);
  return launch_wgmma<192, 128>(q, k, v, o, lse, b_total, s_len, t_len, n_heads, n_kv_heads,
                                hd, dv, causal, scale, vec16, st);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
