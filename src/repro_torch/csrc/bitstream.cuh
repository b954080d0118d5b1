// Funnel-shift extraction of a bit field from an Iris-packed u32 stream,
// shared by the port's kernels (the TPU kernels' _extract).
//
// `off` is the field's global bit offset in the flattened u32 word view
// (ExecProgram.buffer_words32).  A field straddles at most one word
// boundary, so two reads suffice; the second read is clamped to the last
// word, where its bits land above `mask` and are dropped.
#pragma once
#include <cstdint>

__device__ __forceinline__ uint32_t extract_bits(
    const uint32_t* __restrict__ words, long long n_words, uint32_t off,
    uint32_t mask) {
  const uint32_t wi = off >> 5;
  const uint32_t sh = off & 31u;
  uint32_t v = __ldg(words + wi) >> sh;
  if (sh != 0u) {
    const long long hi = (long long)wi + 1 < n_words ? (long long)wi + 1
                                                     : n_words - 1;
    v |= __ldg(words + hi) << (32u - sh);
  }
  return v & mask;
}
