// stream_attention for Hopper (sm_90a): single-query decode attention read
// straight out of Iris-packed KV pages.
//
// Replaces the TPU kernel
// src/repro/kvcache/kernels/stream_attention.py:stream_attention
// (_attention_kernel).  Same arithmetic: every K/V code and its bf16 scale
// pattern is fetched by global bit offset (word = off >> 5, shift =
// off & 31, two-word funnel shift), dequantized as (code - 2^(bits-1)) *
// scale and rounded to bf16 (the reference casts K/V to the query dtype);
// scores are f32 dot products of the bf16 query with K, times hd^-1/2;
// positions after `pos` are masked; softmax is f32; the output is the f32
// contraction of the probabilities with V, rounded to bf16.
//
// What bounds it on an H100: bytes.  Per slot it must read, for every
// token up to `pos`, the K and V codes and scales of its KV head (int3:
// 3 bits per element) and one u32 table entry per element (4 B, the same
// tables for every slot and layer, so they stay in L2).  The FLOPs
// (4 * H * hd per token) are negligible.
//
// Design: one block per (slot, KV head).  The block reads the slot's page
// words directly from the cache's `pages` tensor through `slot_ids` (no
// gathered copy) and serves all H/Hkv query heads of its group, so each
// K/V element is extracted once per group, not once per query head.
// Tokens past `pos` are skipped instead of scored at -1e30: exp(-1e30 - m)
// is exactly 0 in f32, so only the order of the sums changes.  Warps take
// tokens for the scores (lanes split head_dim, shuffle reduction); the
// scores live in shared memory for the softmax; threads take head_dim
// columns for the V contraction.  A sequence split with a log-sum-exp
// merge is later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bitstream.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_REP = 8;  // query heads per KV head served by one block

// dequantize, then round to bf16 and back (the reference's K/V cast)
__device__ __forceinline__ float dequant_bf16(uint32_t code, float bias,
                                              float scale) {
  const float f = ((float)code - bias) * scale;
  return __bfloat162float(__float2bfloat16_rn(f));
}

__device__ float block_reduce(float v, bool is_max, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    r = is_max ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(THREADS)
stream_attention_kernel(const uint32_t* __restrict__ pages,
                        long long slot_words, const int32_t* __restrict__ slot_ids,
                        const __nv_bfloat16* __restrict__ q,
                        const int32_t* __restrict__ pos,
                        const int32_t* __restrict__ k_tab,
                        const int32_t* __restrict__ ks_tab,
                        const int32_t* __restrict__ v_tab,
                        const int32_t* __restrict__ vs_tab,
                        __nv_bfloat16* __restrict__ out, int H, int Hkv,
                        int hd, int smax, int bits, float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int rep = H / Hkv;
  float* qs = smem;                    // [rep][hd]
  float* sc = qs + rep * hd;           // [rep][smax] scores, then probs
  float* red = sc + rep * smax;        // [32] reduction scratch
  const uint32_t* w = pages + (long long)slot_ids[b] * slot_words;
  const int n_tok = min(pos[b] + 1, smax);
  const uint32_t mask = (1u << bits) - 1u;
  const float bias = (float)(1u << (bits - 1));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int i = threadIdx.x; i < rep * hd; i += blockDim.x) {
    const int r = i / hd;
    const int d = i % hd;
    qs[i] = __bfloat162float(q[((long long)b * H + g * rep + r) * hd + d]);
  }
  __syncthreads();

  // scores: one warp per token, lanes split head_dim
  for (int t = warp; t < n_tok; t += n_warps) {
    const long long row = (long long)t * Hkv + g;
    const float ks = __uint_as_float(
        extract_bits(w, slot_words, (uint32_t)__ldg(ks_tab + row), 0xFFFFu) << 16);
    float part[MAX_REP];
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) part[r] = 0.f;
    for (int d = lane; d < hd; d += 32) {
      const float kv = dequant_bf16(
          extract_bits(w, slot_words, (uint32_t)__ldg(k_tab + row * hd + d), mask),
          bias, ks);
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r)
        if (r < rep) part[r] = fmaf(qs[r * hd + d], kv, part[r]);
    }
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= rep) break;
      float v = part[r];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) sc[r * smax + t] = v * sm_scale;
    }
  }
  __syncthreads();

  // f32 softmax over the unmasked tokens, per query head of the group
  for (int r = 0; r < rep; ++r) {
    float* s = sc + r * smax;
    float m = __int_as_float(0xff800000);  // -inf
    for (int t = threadIdx.x; t < n_tok; t += blockDim.x) m = fmaxf(m, s[t]);
    m = block_reduce(m, true, red);
    float sum = 0.f;
    for (int t = threadIdx.x; t < n_tok; t += blockDim.x) {
      const float e = expf(s[t] - m);
      s[t] = e;
      sum += e;
    }
    sum = block_reduce(sum, false, red);
    for (int t = threadIdx.x; t < n_tok; t += blockDim.x) s[t] = s[t] / sum;
  }
  __syncthreads();

  // output: threads take head_dim columns, loop over tokens
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float acc[MAX_REP];
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) acc[r] = 0.f;
    for (int t = 0; t < n_tok; ++t) {
      const long long row = (long long)t * Hkv + g;
      const float vs = __uint_as_float(
          extract_bits(w, slot_words, (uint32_t)__ldg(vs_tab + row), 0xFFFFu) << 16);
      const float vv = dequant_bf16(
          extract_bits(w, slot_words, (uint32_t)__ldg(v_tab + row * hd + d), mask),
          bias, vs);
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r)
        if (r < rep) acc[r] = fmaf(sc[r * smax + t], vv, acc[r]);
    }
    for (int r = 0; r < rep; ++r)
      out[((long long)b * H + g * rep + r) * hd + d] = __float2bfloat16_rn(acc[r]);
  }
}

}  // namespace

// Launches on `stream`; allocates nothing.  Returns cudaGetLastError().
extern "C" int stream_attention_bf16(const uint32_t* pages,
                                     long long slot_words,
                                     const int32_t* slot_ids, const void* q,
                                     const int32_t* pos, const int32_t* k_tab,
                                     const int32_t* ks_tab,
                                     const int32_t* v_tab,
                                     const int32_t* vs_tab, void* out, int B,
                                     int H, int Hkv, int hd, int smax,
                                     int bits, float sm_scale, void* stream) {
  const int rep = H / Hkv;
  const size_t smem = sizeof(float) * ((size_t)rep * hd + (size_t)rep * smax + 32);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stream_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, Hkv);
  stream_attention_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      pages, slot_words, slot_ids, (const __nv_bfloat16*)q, pos, k_tab,
      ks_tab, v_tab, vs_tab, (__nv_bfloat16*)out, H, Hkv, hd, smax, bits,
      sm_scale);
  return (int)cudaGetLastError();
}
