// packed_matmul for Hopper (sm_90a): y = x @ dequant(W) over lane-packed
// int-N weight codes, bits in {2, 4, 8}.
//
// Replaces the TPU kernel src/repro/kernels/packed_matmul.py:packed_matmul
// (_packed_matmul_kernel).  Same arithmetic: word (r, n) of w_packed holds
// the 32/bits consecutive K codes r*lanes .. r*lanes+lanes-1 of column n,
// LSB first; a code is dequantized as (code - 2^(bits-1)) * scale with the
// bf16 scale of its (K / group_size, n) group, in f32, and accumulated in
// f32.  The Pallas kernel needs K and N to tile by its blocks; this kernel
// takes any K with K % group_size == 0 and K % lanes == 0, any N and any M.
//
// What bounds it on an H100: bytes at the served batch.  One smollm-135m
// layer at int4 (the 7 matmuls, M = 4) reads 1.77 MB of codes and 0.22 MB
// of bf16 scales, ~0.64 us at 3.35 TB/s with x and the output, and does
// 2*M*K*N = 28.3 M f32 FLOPs, ~0.42 us at 67 TFLOP/s on CUDA cores (no
// tensor cores here); only from M = 7 on do the FLOPs bound it.
//
// Design: stream_matmul.cu's structure, so that the two weight paths of a
// tree sum in the same f32 order and give the same bits: one block per
// (BN=32 columns x BM=8 rows) output tile, the K loop inside the block, x
// staged in shared memory by chunks of KCHUNK columns, and the block's 8
// warps splitting each chunk into equal K ranges whose partial sums are
// added in warp order at the end.  Lane j of a warp owns column tile + j,
// so a warp reads one 128-byte row of w_packed at once (coalesced) and
// keeps the word in a register for its `lanes` codes.  CUDA-core FMAs;
// tensor cores, TMA and a split of K across blocks are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 32;       // output columns per block (one per lane)
constexpr int BM = 8;        // output rows per block (decode M <= 8)
constexpr int WARPS = 8;     // warps per block, splitting K
constexpr int KCHUNK = 256;  // x columns staged in shared memory per pass

__global__ void __launch_bounds__(BN * WARPS)
packed_matmul_kernel(const float* __restrict__ x,
                     const uint32_t* __restrict__ w_packed,
                     const uint16_t* __restrict__ scales,
                     float* __restrict__ out, int M, int K, int N, int bits,
                     int group_size) {
  __shared__ float xs[BM][KCHUNK];
  __shared__ float part[WARPS][BM][BN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * BN + lane;
  const int m0 = blockIdx.y * BM;
  const int lanes = 32 / bits;
  const uint32_t mask = (1u << bits) - 1u;
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
      int r_cur = -1;
      float scale = 0.f;
      uint32_t word = 0u;
      for (int kk = kb; kk < ke; ++kk) {
        const int k = k0 + kk;
        const int g = k / group_size;
        if (g != g_cur) {
          g_cur = g;
          const uint32_t pat = __ldg(scales + (long long)g * N + n);
          scale = __uint_as_float(pat << 16);
        }
        const int r = k / lanes;
        if (r != r_cur) {
          r_cur = r;
          word = __ldg(w_packed + (long long)r * N + n);
        }
        const uint32_t code = (word >> ((k - r * lanes) * bits)) & mask;
        const float w = ((float)code - bias) * scale;
#pragma unroll
        for (int rr = 0; rr < BM; ++rr) acc[rr] = fmaf(xs[rr][kk], w, acc[rr]);
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
extern "C" int packed_matmul_f32(const float* x, const uint32_t* w_packed,
                                 const uint16_t* scales, float* out, int M,
                                 int K, int N, int bits, int group_size,
                                 void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  packed_matmul_kernel<<<grid, BN * WARPS, 0, (cudaStream_t)stream>>>(
      x, w_packed, scales, out, M, K, N, bits, group_size);
  return (int)cudaGetLastError();
}
