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
