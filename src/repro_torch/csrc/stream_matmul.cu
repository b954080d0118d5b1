// stream_matmul for Hopper (sm_90a): y = x @ dequant(W), with every weight
// code and bf16 scale pattern gathered straight out of a packed Iris stream.
//
// Replaces the TPU kernel src/repro/kernels/stream_matmul.py:stream_matmul
// (_stream_matmul_kernel, _extract).  Same arithmetic: a code is fetched by
// its global bit offset (word = off >> 5, shift = off & 31, two-word funnel
// shift, mask to `bits`), dequantized as (code - 2^(bits-1)) * scale, and
// accumulated in f32.  Ragged K and N need no masking here: the loops stop
// at the true K and N, so no padded table entry is ever decoded.
//
// What bounds it on an H100: bytes while the tables come from HBM.  Per
// decode step and layer the seven matmuls read one u32 table entry per
// weight (4 B x 3,538,944 = 14.2 MB for smollm-135m) plus 1.33 MB of int3
// codes and the scales: ~4.9 us at 3.35 TB/s.  The tables are the same for
// every layer (all layers share one layout), so across layers they can stay
// in the 50 MB L2; then the 2*M*K*N f32 FMAs (M = 8, no tensor cores here)
// bound the layer at ~0.85 us, above the ~0.56 us its 1.9 MB of codes,
// scales and activations would take.
//
// Design: one block per (BN=32 columns x BM=8 rows) output tile, with the
// K loop inside the block (Hopper blocks share no scratch, so the TPU's
// sequential K grid axis becomes a loop).  Lane j of every warp owns column
// n = tile + j, so each warp reads a 128-byte row segment of w_tab at once
// (coalesced); the block's 8 warps split each staged K chunk between them
// and their partial sums are added in shared memory at the end.  x rows are
// staged in shared memory and read as broadcasts.  Codes are dequantized in
// registers and accumulated with f32 FMA.  This is the simple, correct
// first version; keeping tables or codes in shared memory, TMA and wgmma
// are later work.
#include <cstdint>
#include <cuda_runtime.h>

#include "bitstream.cuh"

namespace {

constexpr int BN = 32;       // output columns per block (one per lane)
constexpr int BM = 8;        // output rows per block (decode M <= 8)
constexpr int WARPS = 8;     // warps per block, splitting K
constexpr int KCHUNK = 256;  // x columns staged in shared memory per pass

__global__ void __launch_bounds__(BN * WARPS)
stream_matmul_kernel(const float* __restrict__ x,
                     const uint32_t* __restrict__ words, long long n_words,
                     const int32_t* __restrict__ w_tab,
                     const int32_t* __restrict__ s_tab,
                     float* __restrict__ out, int M, int K, int N, int bits,
                     int group_size) {
  __shared__ float xs[BM][KCHUNK];
  __shared__ float part[WARPS][BM][BN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * BN + lane;
  const int m0 = blockIdx.y * BM;
  const uint32_t mask = bits < 32 ? (1u << bits) - 1u : 0xFFFFFFFFu;
  const float bias = (float)(1u << (bits - 1));

  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KCHUNK) {
    const int kc = min(KCHUNK, K - k0);
    __syncthreads();  // the previous chunk's readers are done with xs
    for (int i = threadIdx.x; i < BM * KCHUNK; i += blockDim.x) {
      const int r = i / KCHUNK;
      const int c = i % KCHUNK;
      xs[r][c] = (m0 + r < M && c < kc)
                     ? x[(long long)(m0 + r) * K + k0 + c] : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const int per = (kc + WARPS - 1) / WARPS;
      const int kb = warp * per;
      const int ke = min(kc, kb + per);
      int g_cur = -1;
      float scale = 0.f;
      for (int kk = kb; kk < ke; ++kk) {
        const int k = k0 + kk;
        const int g = k / group_size;
        if (g != g_cur) {
          g_cur = g;
          const uint32_t pat = extract_bits(
              words, n_words, (uint32_t)__ldg(s_tab + (long long)g * N + n),
              0xFFFFu);
          scale = __uint_as_float(pat << 16);
        }
        const uint32_t code = extract_bits(
            words, n_words, (uint32_t)__ldg(w_tab + (long long)k * N + n),
            mask);
        const float w = ((float)code - bias) * scale;
#pragma unroll
        for (int r = 0; r < BM; ++r) acc[r] = fmaf(xs[r][kk], w, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < BM; ++r) part[warp][r][lane] = acc[r];
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
    const int r = i / BN;
    const int c = i % BN;
    const int m = m0 + r;
    const int nn = blockIdx.x * BN + c;
    if (m < M && nn < N) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += part[w][r][c];
      out[(long long)m * N + nn] = s;
    }
  }
}

}  // namespace

// Launches on `stream`; allocates nothing.  Returns cudaGetLastError().
extern "C" int stream_matmul_f32(const float* x, const uint32_t* words,
                                 long long n_words, const int32_t* w_tab,
                                 const int32_t* s_tab, float* out, int M,
                                 int K, int N, int bits, int group_size,
                                 void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  stream_matmul_kernel<<<grid, BN * WARPS, 0, (cudaStream_t)stream>>>(
      x, words, n_words, w_tab, s_tab, out, M, K, N, bits, group_size);
  return (int)cudaGetLastError();
}
