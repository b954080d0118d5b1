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
// positions after `pos` contribute nothing; softmax is f32; the output is
// the f32 contraction of the probabilities with V, rounded to bf16.  Only
// the order of the f32 sums differs from the plain version.
//
// What bounds it on an H100: bytes, and in practice the latency of the
// gathers.  Per slot it must read, for every token up to `pos`, the K and
// V codes and scales of its KV head (int3: 3 bits per element) and one u32
// table entry per element (the same tables for every slot and layer, so
// they stay in L2).  The FLOPs (4 * H * hd per token) are negligible.
// Every element is two dependent loads (table entry, then its page
// word(s)), so the kernel is fast only with many gathers in flight.
//
// The first design (one block per (slot, KV head): 12 blocks of 128
// threads at B=4 for smollm-135m on 132 SMs) walked the tokens one by one
// in its V contraction, with only head_dim threads busy, each token a
// chain of dependent loads: its time was L2 latency x tokens.  Its scores
// lived in shared memory sized by smax, which capped the context.
//
// This design:
// - Grid (B, Hkv, S): the S blocks of one (slot, KV head) split its
//   sequence into contiguous ranges of `tpb` tokens and form one thread-
//   block cluster along z.  A block whose range starts after pos[b] loads
//   nothing and contributes l = 0.
// - Inside a block, tiles of TT = 32 tokens: first all 256 threads gather
//   the tile's K and V together (table entries 16 bytes a thread where
//   hd % 4 == 0, then the page words, the second word only for a field
//   that straddles one: up to U x (2 x VEC + 2) independent loads in
//   flight per thread), dequantized and rounded to bf16, into shared
//   memory.  Then warp r scores query head r against the tile (lane t =
//   token t), updates its running max and sum (online softmax), and the
//   threads contract the tile's probabilities with V out of shared memory,
//   each thread owning (head, column) outputs.
// - The S partial results (m, l, o[rep][hd]) of a cluster are merged
//   through distributed shared memory with a log-sum-exp rescale; each
//   block of the cluster writes a share of the outputs.
// - Any number of query heads per KV head (rep): warp r scores heads r,
//   r + 8, r + 16, ... of the KV head against the same gathered tile, so a
//   page is read once whatever rep is (rep 12 for mistral-large-123b and
//   command-r-plus-104b).  The running (m, l) of each head and its partial
//   output o[rep][hd] stay in shared memory across the tiles: each thread
//   reads and writes only its own outputs there, once a tile.
// Shared memory depends on rep and hd, not on smax.  Staging the next
// tile's table rows with cp.async during this tile's arithmetic measured
// slower on the card than gathering through registers, and was dropped.
// At smollm's B=4 the grid is 96 blocks; a longer context runs its tiles
// in sequence inside a block, so its time grows with smax / S.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TT = 32;        // tokens per tile (one per lane)
constexpr int U = 4;          // gather batches in flight per thread

// dequantize, then round to bf16 and back (the reference's K/V cast)
__device__ __forceinline__ float dequant_bf16(uint32_t code, float bias,
                                              float scale) {
  const float f = ((float)code - bias) * scale;
  return __bfloat162float(__float2bfloat16_rn(f));
}

// Gather one tile's K and V: `n_tok` tokens from t0, every column of KV
// head g, into kd[t * (hd + 1) + d] and vd[t * hd + d], VEC consecutive
// columns per table load.  Item i < n_vec is a K quad, the rest V quads;
// each thread issues U items' table loads, then all their word loads.
template <int VEC>
__device__ __forceinline__ void gather_kv(
    const uint32_t* __restrict__ w, long long n_words,
    const int32_t* __restrict__ k_tab, const int32_t* __restrict__ ks_tab,
    const int32_t* __restrict__ v_tab, const int32_t* __restrict__ vs_tab,
    int t0, int n_tok, int Hkv, int g, int hd, uint32_t bits, uint32_t mask,
    float bias, float* kd, float* vd) {
  const int n_vec = n_tok * hd / VEC;
  for (int base = threadIdx.x; base < 2 * n_vec; base += THREADS * U) {
    uint32_t off[U][VEC], soff[U], lo[U][VEC], hi[U][VEC], slo[U], shi[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = min(base + u * THREADS, 2 * n_vec - 1);
      const bool is_v = i >= n_vec;
      const int e = (is_v ? i - n_vec : i) * VEC;
      const long long row = (long long)(t0 + e / hd) * Hkv + g;
      const int32_t* tab = (is_v ? v_tab : k_tab) + row * hd + e % hd;
      if constexpr (VEC == 4) {
        const int4 o4 = __ldg(reinterpret_cast<const int4*>(tab));
        off[u][0] = o4.x; off[u][1] = o4.y; off[u][2] = o4.z; off[u][3] = o4.w;
      } else {
        off[u][0] = (uint32_t)__ldg(tab);
      }
      soff[u] = (uint32_t)__ldg((is_v ? vs_tab : ks_tab) + row);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const long long wi = off[u][v] >> 5;
        lo[u][v] = __ldg(w + wi);
        hi[u][v] = (off[u][v] & 31u) + bits > 32u
                       ? __ldg(w + min(wi + 1, n_words - 1)) : 0u;
      }
      const long long si = soff[u] >> 5;
      slo[u] = __ldg(w + si);
      shi[u] = (soff[u] & 31u) > 16u ? __ldg(w + min(si + 1, n_words - 1))
                                      : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS;
      if (i >= 2 * n_vec) break;
      const bool is_v = i >= n_vec;
      const int e = (is_v ? i - n_vec : i) * VEC;
      const float scale = __uint_as_float(
          (__funnelshift_r(slo[u], shi[u], soff[u] & 31u) & 0xFFFFu) << 16);
      float* out = is_v ? vd + (e / hd) * hd + e % hd
                        : kd + (e / hd) * (hd + 1) + e % hd;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        out[v] = dequant_bf16(
            __funnelshift_r(lo[u][v], hi[u][v], off[u][v] & 31u) & mask,
            bias, scale);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
stream_attention_kernel(const uint32_t* __restrict__ pages,
                        long long slot_words, const void* __restrict__ slot_ids,
                        int ids64, const __nv_bfloat16* __restrict__ q,
                        const void* __restrict__ pos, int pos64,
                        const int32_t* __restrict__ k_tab,
                        const int32_t* __restrict__ ks_tab,
                        const int32_t* __restrict__ v_tab,
                        const int32_t* __restrict__ vs_tab,
                        __nv_bfloat16* __restrict__ out, int H, int Hkv,
                        int hd, int smax, int tpb, int bits, float sm_scale) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int split = blockIdx.z;
  const int S = gridDim.z;
  const int rep = H / Hkv;
  const int n_out = rep * hd;
  // shared memory, in floats (attention_launch in the wrapper mirrors it)
  float* qs = smem;                    // [rep][hd]
  float* ks = qs + n_out;              // [TT][hd + 1]
  float* vs = ks + TT * (hd + 1);      // [TT][hd]
  float* pr = vs + TT * hd;            // [rep][TT] probabilities
  float* al = pr + rep * TT;           // [rep] rescale of this tile
  float* os = al + rep;                // [rep][hd] this block's partial o
  float* ml = os + n_out;              // [2][rep] its running m and l

  const long long slot = ids64 ? ((const long long*)slot_ids)[b]
                               : ((const int32_t*)slot_ids)[b];
  const long long p = pos64 ? ((const long long*)pos)[b]
                            : ((const int32_t*)pos)[b];
  const uint32_t* w = pages + slot * slot_words;
  const int n_tok = (int)min(p + 1, (long long)smax);
  const int t_begin = split * tpb;
  const int t_end = min(n_tok, t_begin + tpb);
  const uint32_t mask = (1u << bits) - 1u;
  const float bias = (float)(1u << (bits - 1));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool vec = (hd & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(k_tab) |
        reinterpret_cast<uintptr_t>(v_tab)) & 15u) == 0;

  for (int i = threadIdx.x; i < n_out; i += THREADS) {
    qs[i] = __bfloat162float(q[((long long)b * H + g * rep) * hd + i]);
    os[i] = 0.f;
  }
  for (int r = threadIdx.x; r < rep; r += THREADS) {
    ml[r] = __int_as_float(0xff800000);  // -inf
    ml[rep + r] = 0.f;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += TT) {
    const int nt = min(TT, t_end - t0);
    __syncthreads();  // the previous tile's readers are done
    if (vec)
      gather_kv<4>(w, slot_words, k_tab, ks_tab, v_tab, vs_tab, t0, nt, Hkv,
                   g, hd, bits, mask, bias, ks, vs);
    else
      gather_kv<1>(w, slot_words, k_tab, ks_tab, v_tab, vs_tab, t0, nt, Hkv,
                   g, hd, bits, mask, bias, ks, vs);
    __syncthreads();
    // scores and the online softmax: warp w takes query heads w, w + 8,
    // ... of the group (lane = token); each head's running m and l live in
    // ml, read and written by its warp only
    for (int r = warp; r < rep; r += WARPS) {
      float s = __int_as_float(0xff800000);
      if (lane < nt) {
        const float* qr = qs + r * hd;
        const float* kt = ks + lane * (hd + 1);
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kt[d], acc);
        s = acc * sm_scale;
      }
      float mt = s;
      for (int o2 = 16; o2 > 0; o2 >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o2));
      const float m_run = ml[r];
      const float m_new = fmaxf(m_run, mt);
      const float p = lane < nt ? expf(s - m_new) : 0.f;
      float ps = p;
      for (int o2 = 16; o2 > 0; o2 >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o2);
      const float alpha = expf(m_run - m_new);
      __syncwarp();  // every lane has read ml[r] before lane 0 rewrites it
      pr[r * TT + lane] = p;
      if (lane == 0) {
        al[r] = alpha;
        ml[r] = m_new;
        ml[rep + r] = ml[rep + r] * alpha + ps;
      }
    }
    __syncthreads();
    // V contraction: each thread owns outputs i = tid + j * THREADS of os
    for (int i = threadIdx.x; i < n_out; i += THREADS) {
      const int r = i / hd;
      const int d = i - r * hd;
      const float* p = pr + r * TT;
      float acc = os[i] * al[r];
      for (int t = 0; t < nt; ++t) acc = fmaf(p[t], vs[t * hd + d], acc);
      os[i] = acc;
    }
  }

  // this block's partial result (os, ml) is in place: merge across the
  // cluster
  cluster.sync();
  const int share = (n_out + S - 1) / S;
  const int i_end = min(n_out, (split + 1) * share);
  for (int i = split * share + threadIdx.x; i < i_end; i += THREADS) {
    const int r = i / hd;
    float mx = __int_as_float(0xff800000);
    for (int s = 0; s < S; ++s) {
      const float* rml = cluster.map_shared_rank(ml, s);
      if (rml[rep + r] > 0.f) mx = fmaxf(mx, rml[r]);
    }
    float num = 0.f, den = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* rml = cluster.map_shared_rank(ml, s);
      const float l = rml[rep + r];
      if (l > 0.f) {
        const float c = expf(rml[r] - mx);
        num = fmaf(c, cluster.map_shared_rank(os, s)[i], num);
        den = fmaf(c, l, den);
      }
    }
    out[((long long)b * H + g * rep) * hd + i] = __float2bfloat16_rn(num / den);
  }
  cluster.sync();  // keep this block's shared memory until all have read it
}

}  // namespace

// Launches on `stream` with a cluster of `splits` blocks along z; `smem`
// is the dynamic shared memory in bytes (attention_launch); slot ids and
// positions are int64 where ids64 / pos64 is set, else int32.  Allocates
// nothing.  Returns cudaGetLastError().
extern "C" int stream_attention_bf16(const uint32_t* pages,
                                     long long slot_words,
                                     const void* slot_ids, int ids64,
                                     const void* q, const void* pos,
                                     int pos64, const int32_t* k_tab,
                                     const int32_t* ks_tab,
                                     const int32_t* v_tab,
                                     const int32_t* vs_tab, void* out, int B,
                                     int H, int Hkv, int hd, int smax,
                                     int splits, int tpb, int smem, int bits,
                                     float sm_scale, void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stream_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, Hkv, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, stream_attention_kernel, pages, slot_words, slot_ids, ids64,
      (const __nv_bfloat16*)q, pos, pos64, k_tab, ks_tab, v_tab, vs_tab,
      (__nv_bfloat16*)out, H, Hkv, hd, smax, tpb, bits, sm_scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
