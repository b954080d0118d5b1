// The f32 summation order of the port's weight matmuls (stream_matmul.cu,
// packed_matmul.cu).  Both kernels follow it, so that on one tree the
// lane-packed and the stream-direct weight paths give the same bits.
//
// For every output y[m][n] = sum_k x[m][k] * w[k][n]:
// - K is cut into chunks of MM_KCHUNK = 256 columns, [k0, k0 + kc) with
//   kc = min(256, K - k0), and each chunk into MM_RANGES = 8 ranges:
//   range w of a chunk is [k0 + w*per, k0 + min(kc, (w+1)*per)) with
//   per = ceil(kc / 8) (ranges at the end of a short chunk may be empty).
// - p_w, the partial sum of range w, starts at 0.f and runs over range w
//   of every chunk, chunk after chunk and k increasing within a chunk:
//   p_w = fmaf(x[m][k], (float(code) - 2^(bits-1)) * scale, p_w), the
//   weight rounded to f32 before the fused multiply-add.
// - y[m][n] = ((((0.f + p_0) + p_1) + ...) + p_7), added in w order.
//
// range_rows / range_k enumerate range w's k in that order (its "rows").
#pragma once

#include <cooperative_groups.h>
#include <cstdint>

constexpr int MM_KCHUNK = 256;
constexpr int MM_RANGES = 8;
constexpr int MM_FULL_ROWS = MM_KCHUNK / MM_RANGES;  // rows per full chunk

// number of k in range w over all chunks of K
__device__ __forceinline__ int range_rows(int K, int w) {
  const int full = (K - 1) / MM_KCHUNK;  // chunks before the last
  const int kc = K - full * MM_KCHUNK;
  const int per = (kc + MM_RANGES - 1) / MM_RANGES;
  const int kb = w * per;
  return full * MM_FULL_ROWS + max(0, min(kc, kb + per) - kb);
}

// the u-th k of range w, in summation order
__device__ __forceinline__ int range_k(int K, int w, int u) {
  const int full = (K - 1) / MM_KCHUNK;
  if (u < full * MM_FULL_ROWS)
    return (u / MM_FULL_ROWS) * MM_KCHUNK + w * MM_FULL_ROWS +
           u % MM_FULL_ROWS;
  const int kc = K - full * MM_KCHUNK;
  const int per = (kc + MM_RANGES - 1) / MM_RANGES;
  return full * MM_KCHUNK + w * per + (u - full * MM_FULL_ROWS);
}

// The kernel body both weight matmuls share, which follows this order:
// one 256-thread block per (column tile of bn <= 32, K range w), the 8
// ranges of a tile one thread-block cluster (rank = w), decode M <= 8 rows
// a block.  A stage gathers up to ROWS rows of the range's (rows x bn)
// weight tile through `src` (codes into cs, the scale of each row that
// starts a (group, segment) into ss) and x's columns of the range, then
// dequantizes each weight once in place, then thread (r, c) runs the
// ordered FMA chain p_w[r][c] out of shared memory.  The 8 partial sums of
// an output are added in w order through distributed shared memory: each
// block stores its p_w of output row r into cluster rank r's shared
// memory, and after one cluster barrier rank w adds and writes output row
// w of the tile.  `Src` provides vec(bn, N) (whether 4-column loads may
// be used) and gather<VEC>(srow, K, N, w, s0, rows, n0, bn, group_size,
// cs, ss).
namespace mm {

constexpr int THREADS = 256;
constexpr int BM = 8;         // output rows per block (decode M <= 8)
constexpr int MAX_BN = 32;    // output columns per block, at most
constexpr int ROWS = 256;     // range rows staged in shared memory at once
constexpr int XV = BM * ROWS / THREADS;  // x values staged per thread
constexpr int SMEM =          // dynamic shared memory of a block, bytes
    4 * (2 * ROWS * MAX_BN + BM * (ROWS + 1) + ROWS + BM * MAX_BN);

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

template <class Src>
__device__ __forceinline__ void cluster_matmul(const Src& src,
                                               const float* __restrict__ x,
                                               float* __restrict__ out, int M,
                                               int K, int N, int bits,
                                               int group_size, int bn) {
  // dynamic shared memory (SMEM bytes): codes, then f32 weights in place;
  // scales; x; the scale row of each range row; p_w
  extern __shared__ float smem[];
  float* ws = smem;                              // [ROWS][bn]
  uint32_t* cs = reinterpret_cast<uint32_t*>(ws);
  float* ss = ws + ROWS * MAX_BN;                // [ROWS][bn], sparse
  float* xs = ss + ROWS * MAX_BN;                // [BM][ROWS + 1]
  int* srow = reinterpret_cast<int*>(xs + BM * (ROWS + 1));  // [ROWS]
  float* part = reinterpret_cast<float*>(srow + ROWS);  // [8 ranges][bn]
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int w = blockIdx.y;               // K range = cluster rank
  const int n0 = blockIdx.x * bn;
  const int m0 = blockIdx.z * BM;
  const float bias = (float)(1u << (bits - 1));
  const int R = range_rows(K, w);
  const bool chain = threadIdx.x < BM * bn;
  const int r = threadIdx.x / bn;
  const int c = threadIdx.x % bn;
  const bool vec = src.vec(bn, N);

  // arrive now, wait before the first store into another block's shared
  // memory: every block of the cluster has started by then
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  float acc = 0.f;
  for (int s0 = 0; s0 < R; s0 += ROWS) {
    const int rows = min(ROWS, R - s0);
    __syncthreads();  // the previous stage's chain is done with ws, xs
    // x's columns of the range: issued now, stored after the gathers, so
    // their latency hides behind the weight loads
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
      src.template gather<4>(srow, K, N, w, s0, rows, n0, bn, group_size,
                             cs, ss);
    else
      src.template gather<1>(srow, K, N, w, s0, rows, n0, bn, group_size,
                             cs, ss);
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

}  // namespace mm
