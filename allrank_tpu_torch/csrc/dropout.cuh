// Counter-based dropout masks, the device half of ops/dropout.py.
//
// Replaces the TPU's on-core generator (pltpu.prng_seed / prng_random_bits
// and _dropout_keep, allrank_tpu/ops/attention_pallas.py:71-75), whose bits
// a GPU cannot reproduce. The keep bit of element i of stream s under seed k
// is a pure function of (k, s, i), with i the element's index in the whole
// logical tensor, so a mask never depends on tiles, block sizes or launch
// order, and the backward replays the forward's mask exactly:
//
//   (k0, k1) = key(seed, stream)                      (host, ops/dropout.py)
//   bits(i)  = fmix32(((fmix32(lo(i) ^ k0) ^ hi(i)) + k1)
//   keep(i)  = bits(i) >= uint32(p * (2^32 - 1))      (the TPU's threshold)
//
// with fmix32 the murmur3 finaliser. Every operation is on uint32, so the
// plain PyTorch version computes the same bits on the CPU and on the card.
#pragma once

namespace allrank {

// One dropout stream as a kernel argument: its key, its keep threshold and
// the two scales of the JAX kernels (the forward divides by fp32(1 - p), the
// backward multiplies by fp32(1 / (1 - p))). `on` is 0 at rate 0, where the
// kernels skip the mask entirely.
struct DropStream {
  unsigned k0, k1, threshold;
  int on;
  float denom, inv;
};

__host__ __device__ __forceinline__ unsigned fmix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool drop_keep(const DropStream& s,
                                          unsigned long long i) {
  const unsigned lo = static_cast<unsigned>(i);
  const unsigned hi = static_cast<unsigned>(i >> 32);
  return fmix32((fmix32(lo ^ s.k0) ^ hi) + s.k1) >= s.threshold;
}

// `keys` is the host array {k0, k1, threshold} that ops/dropout.py builds;
// p is the rate as the caller gave it (a double, as the JAX code's Python
// float).
inline DropStream make_stream(const unsigned* keys, double p) {
  DropStream s;
  s.k0 = keys[0];
  s.k1 = keys[1];
  s.threshold = keys[2];
  s.on = p > 0.0;
  s.denom = static_cast<float>(1.0 - p);
  s.inv = static_cast<float>(1.0 / (1.0 - p));
  return s;
}

}  // namespace allrank
