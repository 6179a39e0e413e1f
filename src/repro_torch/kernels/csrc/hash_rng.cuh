// Counter-based RNG shared by the training kernels: the xxhash-style
// avalanche of repro/kernels/ref.py:hash_u32, in uint32 arithmetic that
// wraps mod 2^32 exactly as the reference's does.  The plain versions
// (kernels/ref.py:hash_u32) reproduce it in masked int64.
#pragma once

#include <cstdint>

namespace tm_rng {

// first multiplier: hash_u32(x, seed) = avalanche(x * kH1 + seed), so the
// draws of x, x + 1, ... start from x * kH1 + seed stepped by kH1
constexpr uint32_t kH1 = 2654435761u;

__device__ __forceinline__ uint32_t avalanche(uint32_t x) {
  x ^= x >> 16;
  x *= 2246822519u;
  x ^= x >> 13;
  x *= 3266489917u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t x, uint32_t seed) {
  return avalanche(x * kH1 + seed);
}

// Feedback-selection stream: hash of the global (sample, clause) pair,
// mixed so that sharded and chunked callers index the same draws.
constexpr uint32_t kSelMix = 0x9E3779B1u;
constexpr uint32_t kSelXor = 0x85EBCA6Bu;

}  // namespace tm_rng
