// stream_matmul for Hopper (sm_90a): y = x @ dequant(W), with every weight
// code and bf16 scale pattern gathered straight out of a packed Iris stream.
//
// Replaces the TPU kernel src/repro/kernels/stream_matmul.py:stream_matmul
// (_stream_matmul_kernel, _extract).  Same arithmetic: a code is fetched by
// its global bit offset (word = off >> 5, shift = off & 31, two-word funnel
// shift, mask to `bits`), dequantized as (code - 2^(bits-1)) * scale, and
// accumulated in f32, in the order matmul_order.cuh sets down (shared with
// packed_matmul.cu, so the two weight paths of a tree give the same bits).
// Ragged K and N need no masking: the ranges stop at the true K, and no
// output past N is written, so no padded table entry is ever decoded.
//
// What bounds it on an H100: bytes while the tables come from HBM.  Per
// decode step and layer the seven matmuls read one u32 table entry per
// weight (4 B x 3,538,944 = 14.2 MB for smollm-135m) plus 1.33 MB of int3
// codes and the scales: ~4.9 us at 3.35 TB/s.  The tables are the same for
// every layer (all layers share one layout), so across layers they can stay
// in the 50 MB L2; then ~1.9 MB of codes, scales and activations remain,
// ~0.57 us at M = 4.  In practice the latency of the gathers sets the time:
// every weight is two dependent loads (table entry, then stream word).
//
// The first design (one block per 32-column tile: 18, 6, 6, 18, 48, 48 and
// 18 blocks for smollm's wq, wk, wv, wo, gate, up and down on 132 SMs) had
// each warp walk its K range in sequence, a table load, a dependent word
// load and an FMA per step: 72 steps at K = 576, 192 at K = 1536, each an
// L2 round trip.
//
// At M = 64 (64 served slots, stablelm-3b's conv64 cell) what bounds it is
// the same gather, repeated: with a block for each 8 rows, the eight row
// tiles of a column tile each gathered the tile's table entries, stream
// words and scales and dequantized every weight again, so a step fetched
// and decoded each weight 8 times.  B1 took ~0.90 ms a launch there
// against ~0.12 ms at M = 4 (one row tile), linear in row tiles; the
// ordered FMA chain was not the cost.
//
// This design:
// - One unit of work per (column tile of BN in {8, 16, 32}, K range w,
//   row block), for w = 0..7: a block of 256 threads, at most 128
//   registers a thread so that two blocks share an SM.  A row block is 8
//   rows at M <= 8 and 64 rows (8 row tiles) above: one gather of the
//   weight tile feeds the chains of all 64 rows, so at M <= 64 every
//   weight is gathered and dequantized once a launch.  The 8 blocks of a
//   column tile form one thread-block cluster along y (cluster rank = w).
//   The wrapper picks BN (matmul_launch) so that the grid covers the 132
//   SMs: 144, 192, 192, 144, 384, 384 and 144 blocks for smollm at M <= 8,
//   640 and 1,728 for stablelm's widths at M = 64.
// - A block first gathers its range's whole (rows x BN) tile, the loads
//   decoupled from the ordered sum: table entries 16 bytes a thread where
//   N % 4 == 0, then the code words (the second word only for a field that
//   straddles one), U x VEC codes in flight per thread.  Scales are
//   gathered once per (group, segment) and column, not once per weight.
//   x's columns of the range are loaded in the same window.  A pass over
//   shared memory then dequantizes each weight once, and only then does
//   thread (r, c) run the ordered FMA chain p_w[r + 8t][c] of each row tile
//   t out of shared memory.
// - The 8 partial sums of an output are added in w order through
//   distributed shared memory: each block stores its p_w of output row
//   r + 8t into cluster rank r's shared memory, and after one cluster
//   barrier rank w adds and writes output rows w, w + 8, ... of the
//   block.
// The stage loop, the chain and the merge are mm::cluster_matmul in
// matmul_order.cuh, which packed_matmul.cu shares; this file brings the
// gather.  Staging the table tiles with cp.async (instead of loads into
// registers)
// measured slower on the card, and so did 3 blocks per SM (spills) and
// wider gather batches.  What remains per launch is about two L2 round
// trips for the gathers, the ordered chain (72 to 192 dependent FMAs) and
// the cluster barrier; tensor cores do not apply: the summation contract
// fixes each output to 8 sequential f32 FMA chains.
#include <cstdint>
#include <cuda_runtime.h>

#include "matmul_order.cuh"

namespace {

constexpr int U = 2;  // gather batches in flight per thread

// The weights of a tile, gathered out of the packed stream by the offset
// tables (mm::cluster_matmul's `Src`).
struct StreamSource {
  const uint32_t* words;
  long long n_words;
  const int32_t* w_tab;
  const int32_t* s_tab;
  uint32_t bits, mask;

  // 16-byte table loads: 4 columns a load
  __device__ bool vec(int bn, int N) const {
    return (bn & 3) == 0 && (N & 3) == 0 &&
           ((reinterpret_cast<uintptr_t>(w_tab) |
             reinterpret_cast<uintptr_t>(s_tab)) & 15u) == 0;
  }

  // Gather range rows [s0, s0 + rows) of range w, columns [n0, n0 + bn):
  // every code into cs[u * bn + c], and the scale of each row that starts
  // a (group, segment) into ss[u * bn + c], VEC columns per table load.
  template <int VEC>
  __device__ void gather(const int* srow, int K, int N, int w, int s0,
                         int rows, int n0, int bn, int group_size,
                         uint32_t* cs, float* ss) const {
    const int n_vec = rows * bn / VEC;
    for (int base = threadIdx.x; base < n_vec; base += mm::THREADS * U) {
      uint32_t off[U][VEC], soff[U][VEC], lo[U][VEC], hi[U][VEC],
          slo[U][VEC], shi[U][VEC];
      bool lead[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = min(base + u * mm::THREADS, n_vec - 1) * VEC;
        const int row = e / bn;
        const int k = range_k(K, w, s0 + row);
        const int n = min(n0 + e % bn, N - VEC);  // columns past N: unused
        lead[u] = srow[row] == row;
        const long long wi = (long long)k * N + n;
        const long long si = (long long)(k / group_size) * N + n;
        if constexpr (VEC == 4) {
          const int4 a = __ldg(reinterpret_cast<const int4*>(w_tab + wi));
          off[u][0] = a.x; off[u][1] = a.y; off[u][2] = a.z; off[u][3] = a.w;
          if (lead[u]) {
            const int4 b = __ldg(reinterpret_cast<const int4*>(s_tab + si));
            soff[u][0] = b.x; soff[u][1] = b.y; soff[u][2] = b.z;
            soff[u][3] = b.w;
          }
        } else {
          off[u][0] = (uint32_t)__ldg(w_tab + wi);
          if (lead[u]) soff[u][0] = (uint32_t)__ldg(s_tab + si);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const long long a = off[u][v] >> 5;
          lo[u][v] = __ldg(words + a);
          hi[u][v] = (off[u][v] & 31u) + bits > 32u
                         ? __ldg(words + min(a + 1, n_words - 1)) : 0u;
          if (lead[u]) {
            const long long b = soff[u][v] >> 5;
            slo[u][v] = __ldg(words + b);
            shi[u][v] = (soff[u][v] & 31u) > 16u
                            ? __ldg(words + min(b + 1, n_words - 1)) : 0u;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * mm::THREADS;
        if (i >= n_vec) break;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          cs[i * VEC + v] =
              __funnelshift_r(lo[u][v], hi[u][v], off[u][v] & 31u) & mask;
          if (lead[u])
            ss[i * VEC + v] = __uint_as_float(
                (__funnelshift_r(slo[u][v], shi[u][v], soff[u][v] & 31u) &
                 0xFFFFu) << 16);
        }
      }
    }
  }
};

template <int TILES>
__global__ void __cluster_dims__(1, MM_RANGES, 1)
    __launch_bounds__(mm::THREADS, 2)
stream_matmul_kernel(const float* __restrict__ x,
                     const uint32_t* __restrict__ words, long long n_words,
                     const int32_t* __restrict__ w_tab,
                     const int32_t* __restrict__ s_tab,
                     float* __restrict__ out, int M, int K, int N, int bits,
                     int group_size, int bn) {
  const uint32_t mask = bits < 32 ? (1u << bits) - 1u : 0xFFFFFFFFu;
  mm::cluster_matmul<TILES>(
      StreamSource{words, n_words, w_tab, s_tab, (uint32_t)bits, mask}, x,
      out, M, K, N, bits, group_size, bn);
}

// Opts the kernel of TILES row tiles a block into its shared memory once,
// then launches a (ceil(N / bn), 8, ceil(M / (8 TILES))) grid in clusters
// of 8 along y on `stream`.
template <int TILES>
int launch(const float* x, const uint32_t* words, long long n_words,
           const int32_t* w_tab, const int32_t* s_tab, float* out, int M,
           int K, int N, int bits, int group_size, int bn, void* stream) {
  using B = mm::Block<TILES>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_matmul_kernel<TILES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, B::SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((N + bn - 1) / bn, MM_RANGES, (M + B::BM - 1) / B::BM);
  stream_matmul_kernel<TILES><<<grid, mm::THREADS, B::SMEM,
                                (cudaStream_t)stream>>>(
      x, words, n_words, w_tab, s_tab, out, M, K, N, bits, group_size, bn);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel of one row tile a block at M <= 8, else the one of 8
// (64 rows): a (ceil(N / bn), 8, M <= 8 ? 1 : ceil(M / 64)) grid in
// clusters of 8 along y on `stream` (bn and the grid from matmul_launch);
// allocates nothing.  Returns cudaGetLastError().
extern "C" int stream_matmul_f32(const float* x, const uint32_t* words,
                                 long long n_words, const int32_t* w_tab,
                                 const int32_t* s_tab, float* out, int M,
                                 int K, int N, int bits, int group_size,
                                 int bn, void* stream) {
  return M <= mm::TILE_M
             ? launch<1>(x, words, n_words, w_tab, s_tab, out, M, K, N, bits,
                         group_size, bn, stream)
             : launch<mm::MAX_TILES>(x, words, n_words, w_tab, s_tab, out, M,
                                     K, N, bits, group_size, bn, stream);
}
