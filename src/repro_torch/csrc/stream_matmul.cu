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
// This design:
// - One unit of work per (column tile of BN in {8, 16, 32}, K range w),
//   for w = 0..7: a block of 256 threads, at most 128 registers a thread
//   so that two blocks share an SM.  The 8 blocks of a column tile form
//   one thread-block cluster along y (cluster rank = w).  The wrapper picks
//   BN (matmul_launch) so that the grid covers the 132 SMs: 144, 192, 192,
//   144, 384, 384 and 144 blocks for smollm at M <= 8.
// - A block first gathers its range's whole (rows x BN) tile, the loads
//   decoupled from the ordered sum: table entries 16 bytes a thread where
//   N % 4 == 0, then the code words (the second word only for a field that
//   straddles one), U x VEC codes in flight per thread.  Scales are
//   gathered once per (group, segment) and column, not once per weight.
//   x's columns of the range are loaded in the same window.  A pass over
//   shared memory then dequantizes each weight once, and only then does
//   thread (r, c) run the ordered FMA chain p_w[r][c] out of shared memory.
// - The 8 partial sums of an output are added in w order through
//   distributed shared memory: each block stores its p_w of output row r
//   into cluster rank r's shared memory, and after one cluster barrier
//   rank w adds and writes output row w of the tile.
// Staging the table tiles with cp.async (instead of loads into registers)
// measured slower on the card, and so did 3 blocks per SM (spills) and
// wider gather batches.  What remains per launch is about two L2 round
// trips for the gathers, the ordered chain (72 to 192 dependent FMAs) and
// the cluster barrier; tensor cores do not apply to an 8-row decode.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "matmul_order.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int BM = 8;         // output rows per block (decode M <= 8)
constexpr int MAX_BN = 32;    // output columns per block, at most
constexpr int ROWS = 256;     // range rows staged in shared memory at once
constexpr int U = 2;          // gather batches in flight per thread
constexpr int XV = BM * ROWS / THREADS;  // x values staged per thread

static_assert(BM == MM_RANGES, "cluster rank w writes output row w");

// Row u of range w takes the scale of the group of its k.  Within a stage
// the rows of one segment (one chunk's part of the range) are consecutive
// k, so the scale is gathered once per (group, segment) at the group's
// first row there; `srow[u]` names that row.
__device__ __forceinline__ int scale_row(int K, int w, int s0, int u, int k,
                                         int group_size) {
  const int full = (K - 1) / MM_KCHUNK;
  const int seg = u < full * MM_FULL_ROWS ? (u / MM_FULL_ROWS) * MM_FULL_ROWS
                                          : full * MM_FULL_ROWS;
  return max(max(s0, seg), u - k % group_size);
}

// Gather range rows [s0, s0 + rows) of range w, columns [n0, n0 + bn):
// every code into cs[u * bn + c], and the scale of each row that starts a
// (group, segment) into ss[u * bn + c], VEC columns per table load.
template <int VEC>
__device__ __forceinline__ void gather_codes(
    const uint32_t* __restrict__ words, long long n_words,
    const int32_t* __restrict__ w_tab, const int32_t* __restrict__ s_tab,
    const int* srow, int K, int N, int w, int s0, int rows, int n0, int bn,
    int group_size, uint32_t bits, uint32_t mask, uint32_t* cs, float* ss) {
  const int n_vec = rows * bn / VEC;
  for (int base = threadIdx.x; base < n_vec; base += THREADS * U) {
    uint32_t off[U][VEC], soff[U][VEC], lo[U][VEC], hi[U][VEC], slo[U][VEC],
        shi[U][VEC];
    bool lead[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = min(base + u * THREADS, n_vec - 1) * VEC;
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
      const int i = base + u * THREADS;
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

__global__ void __cluster_dims__(1, MM_RANGES, 1)
    __launch_bounds__(THREADS, 2)
stream_matmul_kernel(const float* __restrict__ x,
                     const uint32_t* __restrict__ words, long long n_words,
                     const int32_t* __restrict__ w_tab,
                     const int32_t* __restrict__ s_tab,
                     float* __restrict__ out, int M, int K, int N, int bits,
                     int group_size, int bn) {
  // dynamic shared memory (MATMUL_SMEM bytes): codes, then f32 weights in
  // place; scales; x; the scale row of each range row; p_w
  extern __shared__ float smem[];
  float* ws = smem;                              // [ROWS][bn]
  uint32_t* cs = reinterpret_cast<uint32_t*>(ws);
  float* ss = ws + ROWS * MAX_BN;                // [ROWS][bn], sparse
  float* xs = ss + ROWS * MAX_BN;                // [BM][ROWS + 1]
  int* srow = reinterpret_cast<int*>(xs + BM * (ROWS + 1));  // [ROWS]
  float* part = reinterpret_cast<float*>(srow + ROWS);  // [8 ranges][bn]
  cg::cluster_group cluster = cg::this_cluster();
  const int w = blockIdx.y;               // K range = cluster rank
  const int n0 = blockIdx.x * bn;
  const int m0 = blockIdx.z * BM;
  const uint32_t mask = bits < 32 ? (1u << bits) - 1u : 0xFFFFFFFFu;
  const float bias = (float)(1u << (bits - 1));
  const int R = range_rows(K, w);
  const bool chain = threadIdx.x < BM * bn;
  const int r = threadIdx.x / bn;
  const int c = threadIdx.x % bn;
  const bool vec = (bn & 3) == 0 && (N & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(w_tab) |
        reinterpret_cast<uintptr_t>(s_tab)) & 15u) == 0;

  // arrive now, wait before the first store into another block's shared
  // memory: every block of the cluster has started by then
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  float acc = 0.f;
  for (int s0 = 0; s0 < R; s0 += ROWS) {
    const int rows = min(ROWS, R - s0);
    __syncthreads();  // the previous stage's chain is done with ws, xs
    // x's columns of the range: issued now, stored after the gathers, so
    // their latency hides behind the table and word loads
    float xv[XV];
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int i = threadIdx.x + j * THREADS;
      xv[j] = i < BM * rows && m0 + i / rows < M
                  ? x[(long long)(m0 + i / rows) * K +
                      range_k(K, w, s0 + i % rows)]
                  : 0.f;
    }
    for (int u = threadIdx.x; u < rows; u += THREADS)
      srow[u] = scale_row(K, w, s0, s0 + u, range_k(K, w, s0 + u),
                          group_size) - s0;
    __syncthreads();
    if (vec)
      gather_codes<4>(words, n_words, w_tab, s_tab, srow, K, N, w, s0, rows,
                      n0, bn, group_size, bits, mask, cs, ss);
    else
      gather_codes<1>(words, n_words, w_tab, s_tab, srow, K, N, w, s0, rows,
                      n0, bn, group_size, bits, mask, cs, ss);
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i < BM * rows) xs[(i / rows) * (ROWS + 1) + i % rows] = xv[j];
    }
    __syncthreads();
    // dequantize in place, each weight once: the f32 weight of the order
    for (int i = threadIdx.x; i < rows * bn; i += THREADS) {
      const float scale = ss[srow[i / bn] * bn + i % bn];
      ws[i] = ((float)cs[i] - bias) * scale;
    }
    __syncthreads();
    if (chain) {
      const float* xr = xs + r * (ROWS + 1);
#pragma unroll 8
      for (int u = 0; u < rows; ++u) acc = fmaf(xr[u], ws[u * bn + c], acc);
    }
  }
  // p_w of output row m0 + r goes straight into cluster rank r's shared
  // memory (part[w][c] there); after one cluster barrier rank w adds the 8
  // partial sums of its row in range order
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (chain) cluster.map_shared_rank(part, r)[w * bn + c] = acc;
  cluster.sync();
  const int m = m0 + w;
  const int n = n0 + threadIdx.x;
  if (threadIdx.x < bn && m < M && n < N) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < MM_RANGES; ++q) s += part[q * bn + threadIdx.x];
    out[(long long)m * N + n] = s;
  }
}

constexpr int MATMUL_SMEM =
    4 * (2 * ROWS * MAX_BN + BM * (ROWS + 1) + ROWS + BM * MAX_BN);

}  // namespace

// Launches a (ceil(N / bn), 8, ceil(M / 8)) grid in clusters of 8 along y
// on `stream` (bn from matmul_launch); allocates nothing.  Returns
// cudaGetLastError().
extern "C" int stream_matmul_f32(const float* x, const uint32_t* words,
                                 long long n_words, const int32_t* w_tab,
                                 const int32_t* s_tab, float* out, int M,
                                 int K, int N, int bits, int group_size,
                                 int bn, void* stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MATMUL_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((N + bn - 1) / bn, MM_RANGES, (M + BM - 1) / BM);
  stream_matmul_kernel<<<grid, THREADS, MATMUL_SMEM, (cudaStream_t)stream>>>(
      x, words, n_words, w_tab, s_tab, out, M, K, N, bits, group_size, bn);
  return (int)cudaGetLastError();
}
