// Causal flash attention forward for Hopper (sm_90a), the LM substrate's
// attention: q (B, S, H, hd) x k, v (B, T, KH, hd) -> o (B, S, H, hd),
// float32 or bfloat16 in and out, float32 inside.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// _flash_kernel (launched by flash_forward).  Same function: scores
// s = (q . k) * hd^-0.5 in float32, the mask t <= s on row indices, the
// online softmax with running max m, sum l and accumulator acc in float32,
// p = exp(s - m) cast to the input type before the product with v, and
// o = acc / max(l, 1e-30).  The TPU kernel takes kv expanded to H heads;
// here query head h reads kv head h / (H / KH), the same function with
// H / KH times less kv traffic.  The TPU grid's sequential kv axis is the
// loop over kv tiles inside one CUDA block.
//
// Bounds on the H100: at the tinyllama prefill (B 16, S = T 1024, H 32,
// hd 64) the causal products are ~69 GFLOP against ~151 MB of q, k, v and
// o, so the dense bf16 tensor-core rate bounds it.  This first version
// stays off the tensor cores (mma.sync / wgmma and TMA are later work):
// one CUDA block per (batch * head, 64-row q tile), 256 threads, four
// threads per query row.  Each 64-row k/v tile is staged in shared memory
// as float32 (rows padded by one word, so the lanes of a warp hit distinct
// banks); a thread scores 16 keys of its row, the row's four threads meet
// in two shuffles for the max and the sum, the probabilities go through
// shared memory, and each thread keeps a quarter of the row's output
// dimensions in registers.  Tiles wholly above the diagonal are skipped,
// and the q tiles with the most kv tiles are scheduled first.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per kv tile
constexpr int kThreads = 256;    // four per query row
constexpr int kKeysPerThread = kBK / 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (HDP + 1) + 2 * kBK * (HDP + 1) + kBQ * (kBK + 1));
}

// HDP: head dimension padded to a power of two (>= hd); the padding is zero.
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int s_len, int t_len,
                 int n_heads, int n_kv_heads, int hd, int causal, float scale) {
  constexpr int LD = HDP + 1;
  constexpr int LP = kBK + 1;
  extern __shared__ float smem[];
  float* qs = smem;                  // kBQ x LD
  float* ks = qs + kBQ * LD;         // kBK x LD
  float* vs = ks + kBK * LD;         // kBK x LD
  float* ps = vs + kBK * LD;         // kBQ x LP

  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const int hk = h / (n_heads / n_kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2, quad = tid & 3;
  const int qrow = q0 + r;
  const size_t q_step = static_cast<size_t>(n_heads) * hd;
  const size_t kv_step = static_cast<size_t>(n_kv_heads) * hd;
  const T* qb = q + static_cast<size_t>(b) * s_len * q_step + static_cast<size_t>(h) * hd;
  const T* kb = k + static_cast<size_t>(b) * t_len * kv_step + static_cast<size_t>(hk) * hd;
  const T* vb = v + static_cast<size_t>(b) * t_len * kv_step + static_cast<size_t>(hk) * hd;

  for (int i = tid; i < kBQ * HDP; i += kThreads) {
    const int rr = i / HDP, d = i % HDP;
    float x = 0.f;
    if (q0 + rr < s_len && d < hd) x = to_f(qb[(q0 + rr) * q_step + d]);
    qs[rr * LD + d] = x;
  }

  float m = kNegInf, l = 0.f;
  float acc[HDP / 4];
#pragma unroll
  for (int j = 0; j < HDP / 4; ++j) acc[j] = 0.f;

  int n_tiles = (t_len + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's readers are done; q is staged
    for (int i = tid; i < kBK * HDP; i += kThreads) {
      const int rr = i / HDP, d = i % HDP;
      float kx = 0.f, vx = 0.f;
      if (k0 + rr < t_len && d < hd) {
        kx = to_f(kb[(k0 + rr) * kv_step + d]);
        vx = to_f(vb[(k0 + rr) * kv_step + d]);
      }
      ks[rr * LD + d] = kx;
      vs[rr * LD + d] = vx;
    }
    __syncthreads();

    // scores of this thread's keys quad, quad + 4, ..., quad + 60
    float s[kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
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
      ps[r * LP + quad + 4 * i] = to_f(from_f<T>(p));  // p in v's type
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncthreads();

    // this thread's output dimensions quad, quad + 4, ...
#pragma unroll
    for (int j = 0; j < HDP / 4; ++j) acc[j] *= corr;
#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      const float p = ps[r * LP + key];
#pragma unroll
      for (int j = 0; j < HDP / 4; ++j)
        acc[j] = fmaf(p, vs[key * LD + quad + 4 * j], acc[j]);
    }
  }

  if (qrow < s_len) {
    T* ob = o + (static_cast<size_t>(b) * s_len + qrow) * q_step + static_cast<size_t>(h) * hd;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < HDP / 4; ++j) {
      const int d = quad + 4 * j;
      if (d < hd) ob[d] = from_f<T>(acc[j] / denom);
    }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* o, dim3 grid,
           int s_len, int t_len, int n_heads, int n_kv_heads, int hd, int causal,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HDP>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, HDP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_fwd_kernel<T, HDP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s_len, t_len, n_heads, n_kv_heads, hd, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, dim3 grid,
              int s_len, int t_len, int n_heads, int n_kv_heads, int hd, int causal,
              float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, grid, s_len, t_len, n_heads, n_kv_heads, hd,
                         causal, scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, grid, s_len, t_len, n_heads, n_kv_heads, hd,
                         causal, scale, stream);
  return launch<T, 128>(q, k, v, o, grid, s_len, t_len, n_heads, n_kv_heads, hd,
                        causal, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16
extern "C" int flash_forward_launch(const void* q, const void* k, const void* v,
                                    void* o, int b_total, int s_len, int t_len,
                                    int n_heads, int n_kv_heads, int hd, int dtype,
                                    int causal, float scale, void* stream) {
  if (b_total <= 0 || s_len <= 0) return static_cast<int>(cudaSuccess);
  if (hd <= 0 || hd > 128 || t_len <= 0 || n_kv_heads <= 0 || n_heads % n_kv_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b_total * n_heads, (s_len + kBQ - 1) / kBQ);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, o, grid, s_len, t_len, n_heads, n_kv_heads, hd,
                            causal, scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, o, grid, s_len, t_len, n_heads,
                                    n_kv_heads, hd, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
