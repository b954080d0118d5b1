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
// one 256-thread block per (column tile of bn <= 32, K range w, row
// block), the 8 ranges of a tile one thread-block cluster (rank = w).  A
// row block is TILES row tiles of 8 rows: one tile at M <= 8 (decode), 8
// tiles (64 rows) above.  A stage gathers up to ROWS rows of the range's
// (rows x bn) weight tile through `src` (codes into cs, the scale of each
// row that starts a (group, segment) into ss) and x's columns of the range
// for every row of the block, then dequantizes each weight once in place,
// then thread (r, c) runs the ordered FMA chain p_w[r + 8t][c] of each row
// tile t out of that one shared tile.  The 8 partial sums of an output are
// added in w order through distributed shared memory: each block stores
// its p_w of output row r + 8t into cluster rank r's shared memory, and
// after one cluster barrier rank w adds and writes output rows w, w + 8,
// ... of the block.  `Src` provides vec(bn, N) (whether 4-column loads may
// be used) and gather<VEC>(srow, K, N, w, s0, rows, n0, bn, group_size,
// cs, ss).
//
// What bounds it at M = 64 (64 served slots): the gather.  A block of one
// row tile re-gathered, for each 8 rows, the offset-table entries, the
// stream words and the scales of its whole weight tile and dequantized it
// again, so a 64-row step fetched and decoded every weight 8 times; the
// time grew linearly in row tiles.  With 8 tiles a block, each weight is
// gathered and decoded once per launch and read out of shared memory by 8
// chains; the FMAs per weight grow 8-fold, but at 8 per gathered weight
// they stay well under the gather's cost.  x is staged for all 64 rows
// with cp.async (no registers held across the gather), in row-major
// [row][ROWS + 4] so that a chain reads 4 k of a row in one 16-byte load,
// each (a broadcast over the warp) shared by its 4 FMAs.  ROWS drops to
// 192 there so that x's 64 rows fit beside the weight tile and two blocks
// still share an SM (106 KB a block); 192 measured 2-3% faster than 128
// (fewer stages, each gathering more at once).  At stablelm-3b's widths a
// layer's 7 launches take 1.21 ms on the device at M = 64 against 6.27 ms
// with a block for each 8 rows, and 0.87 ms at M = 4 (H100, 700 W): the
// 64 chains (12 shared loads a thread for 32 FMAs) cost ~0.35 ms of it.
//
// Why a decode keeps a block of one row tile (Block<1>: ROWS 256, x
// through registers, one scalar chain): the 64-row body run with one row
// tile measured 11-32% slower at M = 1, 4 and 8, a layer's 7 launches on
// the device at M = 4 (H100, 700 W): smollm-135m B1 0.0819 ms against
// 0.0737, B2 0.0738 / 0.0641; stablelm-3b B1 1.0126 / 0.8722, B2 0.8066 /
// 0.6306 (M = 8); qwen2-vl-2b B1 0.6531 / 0.5551, B2 0.5176 / 0.3983.  Its
// 106 KB of shared memory, held for x's 64 rows, and ROWS 192 (more
// stages) cost more there than the float4 chain saves.
namespace mm {

constexpr int THREADS = 256;
constexpr int TILE_M = 8;     // rows of a row tile: one per cluster rank
constexpr int MAX_TILES = 8;  // row tiles a block covers at M > 8
constexpr int MAX_BN = 32;    // output columns per block, at most

static_assert(TILE_M == MM_RANGES,
              "cluster rank w writes output rows w, w + 8, ...");

// The shape of a block of TILES row tiles.
template <int TILES>
struct Block {
  static constexpr int BM = TILE_M * TILES;  // output rows per block
  // range rows staged in shared memory at once
  static constexpr int ROWS = TILES == 1 ? 256 : 192;
  // pitch of xs's rows: padded against bank conflicts (one tile: the
  // chain reads one k of 8 rows), 16-byte aligned (more: 4 k of a row)
  static constexpr int XLD = TILES == 1 ? ROWS + 1 : ROWS + 4;
  static constexpr int XV = BM * ROWS / THREADS;  // x values per thread
  static constexpr int SMEM =  // dynamic shared memory of a block, bytes
      4 * (2 * ROWS * MAX_BN + BM * XLD + ROWS + MM_RANGES * TILES * MAX_BN);
  static_assert(ROWS % 4 == 0 && SMEM <= 113 * 1024,
                "two blocks an SM");
};

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

// 4 bytes global -> shared without a register; with `full` false the
// destination is zero-filled and nothing is read
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

template <int TILES, class Src>
__device__ __forceinline__ void cluster_matmul(const Src& src,
                                               const float* __restrict__ x,
                                               float* __restrict__ out, int M,
                                               int K, int N, int bits,
                                               int group_size, int bn) {
  using B = Block<TILES>;
  constexpr int ROWS = B::ROWS, XLD = B::XLD;
  // dynamic shared memory (B::SMEM bytes): codes, then f32 weights in
  // place; scales; x; the scale row of each range row; p_w
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                              // [ROWS][bn]
  uint32_t* cs = reinterpret_cast<uint32_t*>(ws);
  float* ss = ws + ROWS * MAX_BN;                // [ROWS][bn], sparse
  float* xs = ss + ROWS * MAX_BN;                // [BM][XLD]
  int* srow = reinterpret_cast<int*>(xs + B::BM * XLD);  // [ROWS]
  // [8 ranges][TILES row tiles][bn]
  float* part = reinterpret_cast<float*>(srow + ROWS);
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int w = blockIdx.y;               // K range = cluster rank
  const int n0 = blockIdx.x * bn;
  const int m0 = blockIdx.z * B::BM;
  // row tiles with a row below M: the same for every block of a cluster
  const int nt = TILES == 1 ? 1 : min(TILES, (M - m0 + TILE_M - 1) / TILE_M);
  const float bias = (float)(1u << (bits - 1));
  const int R = range_rows(K, w);
  const bool chain = threadIdx.x < TILE_M * bn;
  const int r = threadIdx.x / bn;
  const int c = threadIdx.x % bn;
  const bool vec = src.vec(bn, N);

  // arrive now, wait before the first store into another block's shared
  // memory: every block of the cluster has started by then
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  float acc[TILES];
#pragma unroll
  for (int t = 0; t < TILES; ++t) acc[t] = 0.f;
  for (int s0 = 0; s0 < R; s0 += ROWS) {
    const int rows = min(ROWS, R - s0);
    __syncthreads();  // the previous stage's chain is done with ws, xs
    // x's columns of the range: issued now, stored after the gathers, so
    // their latency hides behind the weight loads
    float xv[TILES == 1 ? B::XV : 1];
    if constexpr (TILES == 1) {
#pragma unroll
      for (int j = 0; j < B::XV; ++j) {
        const int i = threadIdx.x + j * THREADS;
        xv[j] = i < B::BM * rows && m0 + i / rows < M
                    ? x[(long long)(m0 + i / rows) * K +
                        range_k(K, w, s0 + i % rows)]
                    : 0.f;
      }
    } else {
      // lane -> k (32 consecutive k a full segment: one 128-byte line),
      // warp -> rows of the live tiles; rows past M are zero-filled
      const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
      for (int u = lane; u < rows; u += 32) {
        const int k = range_k(K, w, s0 + u);
        for (int row = warp; row < nt * TILE_M; row += THREADS / 32) {
          const bool in = m0 + row < M;
          cp_async4(xs + row * XLD + u,
                    x + (in ? (long long)(m0 + row) * K + k : 0), in);
        }
      }
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
    if constexpr (TILES == 1) {
#pragma unroll
      for (int j = 0; j < B::XV; ++j) {
        const int i = threadIdx.x + j * THREADS;
        if (i < B::BM * rows) xs[(i / rows) * XLD + i % rows] = xv[j];
      }
    } else {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    __syncthreads();
    // dequantize in place, each weight once: the f32 weight of the order
    for (int i = threadIdx.x; i < rows * bn; i += THREADS) {
      const float scale = ss[srow[i / bn] * bn + i % bn];
      ws[i] = ((float)cs[i] - bias) * scale;
    }
    __syncthreads();
    if (chain && TILES == 1) {
      const float* xr = xs + r * XLD;
#pragma unroll 8
      for (int u = 0; u < rows; ++u)
        acc[0] = fmaf(xr[u], ws[u * bn + c], acc[0]);
    } else if (chain) {
      // rows m0 + r + 8t: each weight read once for every tile's chain
      const float* xr = xs + r * XLD;
      int u = 0;
      for (; u + 4 <= rows; u += 4) {
        const float w0 = ws[u * bn + c], w1 = ws[(u + 1) * bn + c],
                    w2 = ws[(u + 2) * bn + c], w3 = ws[(u + 3) * bn + c];
#pragma unroll
        for (int t = 0; t < TILES; ++t) {
          if (t < nt) {
            const float4 xq = *reinterpret_cast<const float4*>(
                xr + t * TILE_M * XLD + u);
            acc[t] = fmaf(xq.x, w0, acc[t]);
            acc[t] = fmaf(xq.y, w1, acc[t]);
            acc[t] = fmaf(xq.z, w2, acc[t]);
            acc[t] = fmaf(xq.w, w3, acc[t]);
          }
        }
      }
      for (; u < rows; ++u) {
        const float wu = ws[u * bn + c];
#pragma unroll
        for (int t = 0; t < TILES; ++t)
          if (t < nt) acc[t] = fmaf(xr[t * TILE_M * XLD + u], wu, acc[t]);
      }
    }
  }
  // p_w of output row m0 + r + 8t goes straight into cluster rank r's
  // shared memory (part[w][t][c] there); after one cluster barrier rank w
  // adds the 8 partial sums of each of its rows in range order
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (chain) {
    float* dst = cluster.map_shared_rank(part, r);
#pragma unroll
    for (int t = 0; t < TILES; ++t)
      if (t < nt) dst[(w * TILES + t) * bn + c] = acc[t];
  }
  cluster.sync();
  for (int i = threadIdx.x; i < nt * bn; i += THREADS) {
    const int t = i / bn, cc = i % bn;
    const int m = m0 + w + t * TILE_M;
    const int n = n0 + cc;
    if (m < M && n < N) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < MM_RANGES; ++q) s += part[(q * TILES + t) * bn + cc];
      out[(long long)m * N + n] = s;
    }
  }
}

}  // namespace mm
