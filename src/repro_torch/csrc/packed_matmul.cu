// packed_matmul for Hopper (sm_90a): y = x @ dequant(W) over lane-packed
// int-N weight codes, bits in {2, 4, 8}.
//
// Replaces the TPU kernel src/repro/kernels/packed_matmul.py:packed_matmul
// (_packed_matmul_kernel).  Same arithmetic: word (r, n) of w_packed holds
// the lanes = 32/bits consecutive K codes r*lanes .. r*lanes+lanes-1 of
// column n, LSB first; a code is dequantized as (code - 2^(bits-1)) * scale
// with the bf16 scale of its (K / group_size, n) group, in f32, and
// accumulated in f32, in the order matmul_order.cuh sets down (shared with
// stream_matmul.cu, so the two weight paths of a tree give the same bits).
// The Pallas kernel needs K and N to tile by its blocks; this kernel takes
// any K with K % group_size == 0 and K % lanes == 0, any N and any M.
//
// What bounds it on an H100: bytes at the served batch.  One smollm-135m
// layer at int4 (the 7 matmuls, M = 4) reads 1.77 MB of codes and 0.22 MB
// of bf16 scales, ~0.64 us at 3.35 TB/s with x and the output, and does
// 2*M*K*N = 28.3 M f32 FLOPs, ~0.42 us at 67 TFLOP/s on CUDA cores; only
// from M = 7 on do the FLOPs bound it.  Tensor cores do not apply: the
// summation contract fixes each output to 8 sequential f32 FMA chains, and
// a decode has M <= 8 rows.
//
// The first design (one block per 32-column tile: 18, 6, 6, 18, 48, 48 and
// 18 blocks for smollm's seven matrices on 132 SMs) had each warp walk a K
// range of 72 or 192 steps in sequence, a dependent load and an FMA chain
// per step.
//
// This design is stream_matmul.cu's, without its offset tables: the stage
// loop, the ordered chain and the range-order merge are
// mm::cluster_matmul in matmul_order.cuh, shared by the two, and this file
// brings the gather.
// - One unit of work per (column tile of BN in {8, 16, 32}, K range w),
//   for w = 0..7: a block of 256 threads.  The 8 blocks of a column tile
//   form one thread-block cluster along y (cluster rank = w).  The wrapper
//   picks BN with stream_matmul's matmul_launch, so that the grid covers
//   the 132 SMs: 144, 192, 192, 144, 384, 384 and 144 blocks for smollm at
//   M <= 8.
// - A block first gathers its range's whole (rows x BN) tile of codes, the
//   loads decoupled from the ordered sum: each a 16-byte load of 4
//   columns' words where N % 4 == 0 (neighbouring threads on neighbouring
//   columns, one load level: no table), U batches in flight per thread;
//   the code is shifted out of the word in registers.  Scales are read
//   once per (group, segment) and column, 8 bytes a load.  x's columns of
//   the range are loaded in the same window.  A pass over shared memory
//   then dequantizes each weight once, and only then does thread (r, c)
//   run the ordered FMA chain p_w[r][c] out of shared memory.
// - The 8 partial sums of an output are added in w order through
//   distributed shared memory, after one cluster barrier.
#include <cstdint>
#include <cuda_runtime.h>

#include "matmul_order.cuh"

namespace {

constexpr int U = 4;  // gather batches in flight per thread

// The weights of a tile, read out of the lane-packed words (the `Src` of
// mm::cluster_matmul).
struct PackedSource {
  const uint32_t* w_packed;
  const uint16_t* scales;
  int lanes, bits;
  uint32_t mask;

  // 16-byte word loads and 8-byte scale loads: 4 columns a load
  __device__ bool vec(int bn, int N) const {
    return (bn & 3) == 0 && (N & 3) == 0 &&
           (reinterpret_cast<uintptr_t>(w_packed) & 15u) == 0 &&
           (reinterpret_cast<uintptr_t>(scales) & 7u) == 0;
  }

  // Gather range rows [s0, s0 + rows) of range w, columns [n0, n0 + bn):
  // every code into cs[u * bn + c], and the scale of each row that starts
  // a (group, segment) into ss[u * bn + c], VEC columns per load.
  template <int VEC>
  __device__ void gather(const int* srow, int K, int N, int w, int s0,
                         int rows, int n0, int bn, int group_size,
                         uint32_t* cs, float* ss) const {
    const int n_vec = rows * bn / VEC;
    for (int base = threadIdx.x; base < n_vec; base += mm::THREADS * U) {
      uint32_t wd[U][VEC], sp[U][VEC];
      int sh[U];
      bool lead[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = min(base + u * mm::THREADS, n_vec - 1) * VEC;
        const int row = e / bn;
        const int k = range_k(K, w, s0 + row);
        const int n = min(n0 + e % bn, N - VEC);  // columns past N: unused
        lead[u] = srow[row] == row;
        sh[u] = (k % lanes) * bits;
        const long long wi = (long long)(k / lanes) * N + n;
        const long long si = (long long)(k / group_size) * N + n;
        if constexpr (VEC == 4) {
          const uint4 a =
              __ldg(reinterpret_cast<const uint4*>(w_packed + wi));
          wd[u][0] = a.x; wd[u][1] = a.y; wd[u][2] = a.z; wd[u][3] = a.w;
          if (lead[u]) {
            const uint2 b =
                __ldg(reinterpret_cast<const uint2*>(scales + si));
            sp[u][0] = b.x & 0xFFFFu; sp[u][1] = b.x >> 16;
            sp[u][2] = b.y & 0xFFFFu; sp[u][3] = b.y >> 16;
          }
        } else {
          wd[u][0] = __ldg(w_packed + wi);
          if (lead[u]) sp[u][0] = __ldg(scales + si);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * mm::THREADS;
        if (i >= n_vec) break;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          cs[i * VEC + v] = (wd[u][v] >> sh[u]) & mask;
          if (lead[u]) ss[i * VEC + v] = __uint_as_float(sp[u][v] << 16);
        }
      }
    }
  }
};

__global__ void __cluster_dims__(1, MM_RANGES, 1)
    __launch_bounds__(mm::THREADS, 2)
packed_matmul_kernel(const float* __restrict__ x,
                     const uint32_t* __restrict__ w_packed,
                     const uint16_t* __restrict__ scales,
                     float* __restrict__ out, int M, int K, int N, int bits,
                     int group_size, int bn) {
  mm::cluster_matmul(
      PackedSource{w_packed, scales, 32 / bits, bits, (1u << bits) - 1u}, x,
      out, M, K, N, bits, group_size, bn);
}

}  // namespace

// Launches a (ceil(N / bn), 8, ceil(M / 8)) grid in clusters of 8 along y
// on `stream` (bn from matmul_launch); allocates nothing.  Returns
// cudaGetLastError().
extern "C" int packed_matmul_f32(const float* x, const uint32_t* w_packed,
                                 const uint16_t* scales, float* out, int M,
                                 int K, int N, int bits, int group_size,
                                 int bn, void* stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        packed_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        mm::SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((N + bn - 1) / bn, MM_RANGES, (M + mm::BM - 1) / mm::BM);
  packed_matmul_kernel<<<grid, mm::THREADS, mm::SMEM,
                         (cudaStream_t)stream>>>(
      x, w_packed, scales, out, M, K, N, bits, group_size, bn);
  return (int)cudaGetLastError();
}
