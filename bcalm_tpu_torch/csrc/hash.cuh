// The lane hash that decides which rank owns a routed entry.
//
// Device counterpart of bcalm_tpu/ops/hashing.py (mix32, hash_lanes) and of
// its plain PyTorch copy, bcalm_tpu_torch/ops/hashing.py: a murmur3-style
// finalizer over u32 lanes, uint32_t arithmetic wrapping as the JAX
// package's uint32 arrays wrap.  `hash_lanes(key) % n_dev` must give the
// JAX package's owner bit for bit, or an entry lands on another rank.
#pragma once

#include <cstdint>

namespace bt {

__device__ __forceinline__ uint32_t hmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// h = seed; for each lane (most significant first): h = mix32(h*GOLD ^ lane)
__device__ __forceinline__ uint32_t hash_step(uint32_t h, uint32_t lane) {
  return hmix32((h * 0x9E3779B1u) ^ lane);
}

constexpr uint32_t kHashSeed = 0x9747B28Cu;

}  // namespace bt
