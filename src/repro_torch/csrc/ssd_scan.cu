// ssd_scan for Hopper (sm_90a): the scalar-decay linear-attention scan of
// the Mamba (SSD) prefill, per (batch, head):
//
//     S_t = a_t S_{t-1} + k_t^T v_t,     o_t = q_t S_t,     a_t = e^{logw_t}
//
// Replaces the TPU kernel src/repro/kernels/linear_scan.py:ssd_scan
// (_ssd_kernel).  Same function, in its chunked closed form: per C-token
// chunk, with L = cumsum(logw) (L_t <= 0, nonincreasing),
//
//     o     = e^{L_t} (q S_in) + tril(q k^T * e^{L_t - L_i}) v
//     S_out = e^{L_C} S_in + (k * e^{L_C - L})^T v
//
// The function does not depend on the chunk length, so the kernel takes
// its own tile C (16, 32 or 64) whatever chunk a caller names.  The TPU
// walks a (B*H, T/C) grid with T innermost and carries S in VMEM scratch
// from one grid step to the next.  Blocks on the GPU run in no order, so
// one block owns one (batch, head, slice of dv columns) and the chunk loop
// runs inside it, with its dv columns of S held across the loop in the
// registers of 8 warps (one 16 x 64 strip each, as mma accumulators).
// Each dv slice of S, and of o, is independent of the others; a slice
// recomputes the chunk's score tile.  The block may start S from
// state0 and write the final S out (the port's Mamba layer returns it, as
// recurrent_scan does).
//
// What bounds it on an H100: bytes, once the products run on tensor cores.
// At jamba's prefill (B=2, T=1024, H=256, dk=dv=64) the function moves
// ~270 MB (bf16 q/k/v in, f32 logw, bf16 out), 0.08 ms at 3.35 TB/s; its
// 12.9 GFLOP (masked triangle skipped, 32-token chunks) take 0.19 ms at
// the 67 TFLOP/s of f32 CUDA cores, where the first design ran them (it
// took 1.34 ms), and 0.013 ms at 989 TFLOP/s bf16 even before the operand
// splits below double or triple them.
//
// Tensor cores: mma.sync.m16n8k16 (bf16 in, f32 sums).  wgmma would need
// 64-row tiles whose B operand sits in swizzled shared memory; here a
// chunk's products are 16-row strips of a masked triangle and of 16 x 64
// state strips, and mma.sync takes its fragments from registers.
//
// What bounds it in practice is latency, not the bytes: a block walks T in
// sequence, T / C chunks of three barrier-separated steps, and at 123
// registers a thread two 8-warp blocks share an SM, so jamba's 512 blocks
// take two waves.  The design shortens the chain: each warp owns 16 x 32
// (output) or 16 x 64 (state) strips with 4-8 independent accumulator
// chains, every fragment is one 32-bit shared load, the output and the
// state update run in one step on different warps (S_in's split copy and
// S_out's are two buffers), and the next chunk's q, k, v and logw are
// copied with cp.async while this chunk computes (two stages).  Splitting
// T across blocks would not help at jamba's shape: its grid already fills
// the card twice over, so shorter blocks only add the segments' extra
// work.  What remains is fewer instructions and registers per chunk
// (PERF.md).
//
// Numerics: no f32 value is rounded to bf16 once.  An f32 operand x is
// split into hi = bf16(x) and lo = bf16(x - hi), which hold x to ~2^-17
// relative; its product with an exact bf16 operand y is hi*y + lo*y (two
// mma), and of two split operands hi*hi + hi*lo + lo*hi (three).  bf16
// q, k and v are exact in bf16 and go in as they are; f32 q, k, v are
// split as their fragments load.  The f32 operands made in the chunk are
// split once, where they are made, into bf16 hi and lo tiles: the score
// tile A, S (whose f32 value stays in its owner's registers) and the
// decayed k.  Sums are f32 in the tensor cores.
//
// A chunk, after its copies land:
//   a. v^T of the slice (an smem transpose) and, in warp 0, L = cumsum(logw)
//      with e^{L_t} and W_i = e^{L_C - L_i};
//   b. scores P[t][i] = q_t . k_i in 16 x 16 units, i <= t only (units above
//      the diagonal are skipped); A = P e^{L_t - L_i}, with i > t zeroed
//      before any exponential is taken (above the diagonal the exponent is
//      positive and could overflow); beside it, (k W)^T split;
//   c. o = e^{L_t} (q S_in) + A v, A's columns only up to the strip's
//      diagonal, written straight to the output in its dtype; and, in the
//      same step on other warps,
//   d. S^T <- e^{L_C} S^T + v^T (k W), each owner warp on its strip, its
//      split copy written for the next chunk.
// S is kept transposed (S^T[c][j]), and v and k W too, so that every
// fragment reads two neighbouring values at once.
//
// Ragged T and odd sizes: rows past T copy as zero q/k/v with logw = 0,
// i.e. decay 1, which leaves S exactly as it was; dk and the dv slice are
// padded with zero columns to a multiple of 16.  q, k, v are read through
// their (b, t, h) strides (the Mamba layer's C/B projections are views
// into one matmul output), with 16-byte cp.async copies where the strides
// allow, else plain loads; the last dimension must be contiguous.  Inputs
// f32 or bf16, logw f32, output in the inputs' dtype (round to nearest
// even).  dk, dv <= 256.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_DIM = 256;
constexpr int MAX_TILE = 64;
constexpr int PAD = 8;  // row pad (elements): spreads the banks
constexpr int MAX_SMEM = 227 * 1024;

struct Strides {
  long long q[3], k[3], v[3], w[3];  // (b, t, h) element strides
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float zero(const float*) { return 0.f; }
__device__ __forceinline__ bf16 zero(const bf16*) {
  return __float2bfloat16_rn(0.f);
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// bytes of dynamic shared memory for tile C, dv slice dvs, width dk and
// element size es (the carve-up in ssd_scan_kernel; scan_smem in
// kernels/linear_scan.py mirrors it)
__host__ __device__ inline long long smem_bytes(int C, int dvs, int dk,
                                                int es) {
  const long long dkp = round16(dk), lq = dkp + PAD, lc = C + PAD,
                  lvn = dvs + PAD;
  return es * (2LL * C * (2 * lq + lvn) + dvs * lc) +
         4LL * (dkp * lc + C * lc + 2 * dvs * lq + 5LL * C);
}

// two f32 values as one bf16x2 register: the first in the low half
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) = hi + lo, each a bf16x2 register
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack2(a - hf.x, b - hf.y);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the pair p[0], p[1] (p even): bf16 as it is, f32 split
__device__ __forceinline__ void pair(const bf16* p, uint32_t& hi,
                                     uint32_t& lo) {
  hi = ld32(p);
  lo = 0u;
}
__device__ __forceinline__ void pair(const float* p, uint32_t& hi,
                                     uint32_t& lo) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  split2(v.x, v.y, hi, lo);
}

// mma.sync fragments: A 16x16 (row-major [m][k]), B 16x8 (stored [n][k])
struct FragA {
  uint32_t h[4], l[4];
};
struct FragB {
  uint32_t h[2], l[2];
};

// A rows [r0, r0 + 16), k [k0, k0 + 16) of a [m][k] array, row stride ld
template <typename E>
__device__ __forceinline__ void load_a(FragA& f, const E* a, int ld, int r0,
                                       int k0, int lane) {
  const E* p = a + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  pair(p, f.h[0], f.l[0]);
  pair(p + 8 * ld, f.h[1], f.l[1]);
  pair(p + 8, f.h[2], f.l[2]);
  pair(p + 8 * ld + 8, f.h[3], f.l[3]);
}
// the same from a split pair of bf16 tiles
__device__ __forceinline__ void load_a2(FragA& f, const bf16* hi,
                                        const bf16* lo, int ld, int r0,
                                        int k0, int lane) {
  const int o = (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  f.h[0] = ld32(hi + o); f.h[1] = ld32(hi + o + 8 * ld);
  f.h[2] = ld32(hi + o + 8); f.h[3] = ld32(hi + o + 8 * ld + 8);
  f.l[0] = ld32(lo + o); f.l[1] = ld32(lo + o + 8 * ld);
  f.l[2] = ld32(lo + o + 8); f.l[3] = ld32(lo + o + 8 * ld + 8);
}

// B columns [n0, n0 + 8), k [k0, k0 + 16) of an array stored [n][k]
template <typename E>
__device__ __forceinline__ void load_b(FragB& f, const E* b, int ld, int n0,
                                       int k0, int lane) {
  const E* p = b + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  pair(p, f.h[0], f.l[0]);
  pair(p + 8, f.h[1], f.l[1]);
}
__device__ __forceinline__ void load_b2(FragB& f, const bf16* hi,
                                        const bf16* lo, int ld, int n0,
                                        int k0, int lane) {
  const int o = (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  f.h[0] = ld32(hi + o); f.h[1] = ld32(hi + o + 8);
  f.l[0] = ld32(lo + o); f.l[1] = ld32(lo + o + 8);
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b, with a split when SA and b split when SB (the lo*lo term,
// ~2^-18 relative, is left out); small terms first
template <bool SA, bool SB>
__device__ __forceinline__ void mma_split(float* d, const FragA& a,
                                          const FragB& b) {
  if (SA) mma(d, a.l, b.h);
  if (SB) mma(d, a.h, b.l);
  mma(d, a.h, b.h);
}

// cp.async of 16 (or 4) bytes into shared memory; with `full` false the
// destination is zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy rows [t0, t0 + C) of a (b, t, h)-strided array of width `width`
// into dst[r][c] (row stride ld) for c < wp; zero past T and past `width`.
// With VEC, 16-byte cp.async copies that land while the previous chunk
// computes; else plain loads and stores.
template <typename E, bool VEC>
__device__ __forceinline__ void copy_tile(E* dst, int ld, const E* src,
                                          long long st_t, int t0, int T_len,
                                          int C, int width, int wp) {
  constexpr int VE = VEC ? 16 / sizeof(E) : 1;
  const int per_row = wp / VE;
  for (int i = threadIdx.x; i < C * per_row; i += THREADS) {
    const int r = i / per_row, c = (i % per_row) * VE, t = t0 + r;
    const bool in = t < T_len && c < width;
    if constexpr (VEC) {
      cp_async16(dst + r * ld + c, in ? src + t * st_t + c : src, in);
    } else {
      dst[r * ld + c] = in ? src[t * st_t + c] : zero(src);
    }
  }
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, bf16 a, bf16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, int o,
                                            float a, float b) {
  uint32_t h, l;
  split2(a, b, h, l);
  *reinterpret_cast<uint32_t*>(hi + o) = h;
  *reinterpret_cast<uint32_t*>(lo + o) = l;
}

// The (n, pair of rows) items of a transpose of an [rows][n] tile into
// [n][rows], item x: 8 n by 4 row pairs a warp, so that both the reads
// (rows r, r + 1 at n) and the 32-bit writes (n, r) miss bank conflicts
__device__ __forceinline__ void transpose_item(int x, int n_cols, int& n,
                                               int& r) {
  const int blk = x >> 5, lane = x & 31, per = n_cols / 8;
  n = (blk % per) * 8 + (lane >> 2);
  r = 2 * ((blk / per) * 4 + (lane & 3));
}

template <typename E, bool VEC>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const E* __restrict__ q, const E* __restrict__ k,
                const E* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ state0, E* __restrict__ out,
                float* __restrict__ state_out, int T_len, int H, int dk,
                int dv, int C, int dvs, Strides st) {
  constexpr bool X = std::is_same<E, float>::value;  // inputs to split
  extern __shared__ __align__(16) unsigned char smem[];
  const int dkp = round16(dk);
  const int lq = dkp + PAD, lc = C + PAD, lvn = dvs + PAD;
  // two stages of the copied inputs (chunk n + 1 lands while chunk n
  // computes), then the chunk's working tiles
  E* qs0 = reinterpret_cast<E*>(smem);    // [2][C][lq]    q
  E* ks0 = qs0 + 2 * C * lq;              // [2][C][lq]    k
  E* vn0 = ks0 + 2 * C * lq;              // [2][C][lvn]   v, this slice
  E* vT = vn0 + 2 * C * lvn;              // [dvs][lc]     v^T
  bf16* kwh = reinterpret_cast<bf16*>(vT + dvs * lc);  // [dkp][lc] (k W)^T
  bf16* kwl = kwh + dkp * lc;             //               hi and lo
  bf16* ah = kwl + dkp * lc;              // [C][lc]       A hi and lo
  bf16* al = ah + C * lc;
  bf16* sh0 = al + C * lc;                // [2][dvs][lq]  S^T hi and lo,
  bf16* sl0 = sh0 + 2 * dvs * lq;         //   one per chunk parity
  float* lw0 = reinterpret_cast<float*>(sl0 + 2 * dvs * lq);  // [2][C] logw
  float* L = lw0 + 2 * C;                 // [C]  cumsum(logw)
  float* eL = L + C;                      // [C]  e^{L_t}
  float* W = eL + C;                      // [C]  e^{L_C - L_i}
  __shared__ float chunk_decay;           // e^{L_C}

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int slices = (dv + dvs - 1) / dvs;
  const int bh = blockIdx.x / slices;
  const int c0 = (blockIdx.x % slices) * dvs;
  const int b = bh / H, h = bh % H;
  const E* qb = q + b * st.q[0] + h * st.q[2];
  const E* kb = k + b * st.k[0] + h * st.k[2];
  const E* vb = v + b * st.v[0] + h * st.v[2] + c0;
  const float* wb = logw + b * st.w[0] + h * st.w[2];
  const int dvw = min(dvs, dv - c0);  // this slice's true columns
  const int nb = C / 16, nk = dkp / 16;
  const int n_chunks = (T_len + C - 1) / C;

  // S^T in f32 lives in registers: warp w < n_strips owns strip w, rows
  // 16 ci.. (c) x columns jb.. (j, up to 64), as mma accumulators; its
  // split copy for step c is in shared memory, one per chunk parity
  const int n3 = (dkp + 63) / 64, n_strips = (dvs / 16) * n3;
  const int ci = warp / n3, jb = (warp % n3) * 64;
  const int ns3 = warp < n_strips ? min(8, (dkp - jb) / 8) : 0;
  float S[8][4];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if (s >= ns3) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 16 * ci + g + 8 * (e >> 1);
      const int j = jb + 8 * s + 2 * tq + (e & 1);
      S[s][e] = (state0 != nullptr && c < dvw && j < dk)
                    ? state0[((long long)bh * dk + j) * dv + c0 + c]
                    : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      store_split(sh0, sl0,
                  (16 * ci + g + 4 * e) * lq + jb + 8 * s + 2 * tq,
                  S[s][e], S[s][e + 1]);
  }

  for (int n = -1; n < n_chunks; ++n) {
    if (n + 1 < n_chunks) {  // issue chunk n + 1's copies into its stage
      const int t1 = (n + 1) * C, sb = (n + 1) & 1;
      copy_tile<E, VEC>(qs0 + sb * C * lq, lq, qb, st.q[1], t1,
                                 T_len, C, dk, dkp);
      copy_tile<E, VEC>(ks0 + sb * C * lq, lq, kb, st.k[1], t1,
                                 T_len, C, dk, dkp);
      copy_tile<E, VEC>(vn0 + sb * C * lvn, lvn, vb, st.v[1], t1,
                                 T_len, C, dvw, dvs);
      for (int r = threadIdx.x; r < C; r += THREADS) {
        const bool in = t1 + r < T_len;
        cp_async4(lw0 + sb * C + r, in ? wb + (t1 + r) * st.w[1] : wb, in);
      }
    }
    cp_async_commit();  // (an empty group after the last chunk)
    if (n < 0) continue;
    const int t0 = n * C;
    const E* qs = qs0 + (n & 1) * C * lq;
    const E* ks = ks0 + (n & 1) * C * lq;
    const E* vn = vn0 + (n & 1) * C * lvn;
    const float* lw = lw0 + (n & 1) * C;
    const bf16* sh = sh0 + (n & 1) * dvs * lq;  // S_in, split
    const bf16* sl = sl0 + (n & 1) * dvs * lq;
    cp_async_wait_one();
    __syncthreads();  // chunk n's copies have landed, every thread's

    // a. v^T of the slice; L, e^L and W in warp 0
    for (int x = threadIdx.x; x < dvs * C / 2; x += THREADS) {
      int c, r;
      transpose_item(x, dvs, c, r);
      store_pair(vT + c * lc + r, vn[r * lvn + c], vn[(r + 1) * lvn + c]);
    }
    if (warp == 0) {  // prefix sum of logw over the chunk, 2 rows a lane
      const float w0 = 2 * lane < C ? lw[2 * lane] : 0.f;
      const float w1 = 2 * lane + 1 < C ? lw[2 * lane + 1] : 0.f;
      float incl = w0 + w1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      const float last = __shfl_sync(0xffffffffu, incl, C / 2 - 1);
      const float l1 = incl, l0 = incl - w1;
      if (2 * lane < C) {
        L[2 * lane] = l0;
        L[2 * lane + 1] = l1;
        eL[2 * lane] = expf(l0);
        eL[2 * lane + 1] = expf(l1);
        W[2 * lane] = expf(last - l0);
        W[2 * lane + 1] = expf(last - l1);
      }
      if (lane == 0) chunk_decay = expf(last);
    }
    __syncthreads();

    // b. scores A in 16 x 16 units (mi, ni), ni <= mi, split into ah / al;
    // then (k W)^T split into kwh / kwl
    for (int u = warp; u < nb * (nb + 1) / 2; u += WARPS) {
      int mi = 0;
      while ((mi + 1) * (mi + 2) / 2 <= u) ++mi;
      const int ni = u - mi * (mi + 1) / 2;
      float d[2][4] = {};
      for (int kk = 0; kk < nk; ++kk) {
        FragA fa;
        load_a(fa, qs, lq, 16 * mi, 16 * kk, lane);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          FragB fb;
          load_b(fb, ks, lq, 16 * ni + 8 * s, 16 * kk, lane);
          mma_split<X, X>(d[s], fa, fb);
        }
      }
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int t = 16 * mi + g + 4 * e;  // e = 2: row g + 8
          const int i = 16 * ni + 8 * s + 2 * tq;
          const float a0 = i <= t ? d[s][e] * expf(L[t] - L[i]) : 0.f;
          const float a1 =
              i + 1 <= t ? d[s][e + 1] * expf(L[t] - L[i + 1]) : 0.f;
          store_split(ah, al, t * lc + i, a0, a1);
        }
    }
    for (int x = threadIdx.x; x < dkp * C / 2; x += THREADS) {
      int j, r;
      transpose_item(x, dkp, j, r);
      store_split(kwh, kwl, j * lc + r, to_f32(ks[r * lq + j]) * W[r],
                  to_f32(ks[(r + 1) * lq + j]) * W[r + 1]);
    }
    __syncthreads();

    // c and d together: c reads S_in's split copy, d writes S_out's into
    // the other parity.  d on warps 0.. (the owners of S), c from the
    // last warp down.
    // c. o = e^{L_t} (q S_in) + A v: strips of 16 rows x up to 32 columns
    const int n2 = (dvs + 31) / 32;
    for (int u = WARPS - 1 - warp; u < nb * n2; u += WARPS) {
      const int mi = u / n2, cb = (u % n2) * 32;
      const int ns = min(4, (dvs - cb) / 8);
      float d[4][4] = {};
      for (int kk = 0; kk < nk; ++kk) {
        FragA fa;
        load_a(fa, qs, lq, 16 * mi, 16 * kk, lane);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (s >= ns) break;
          FragB fb;
          load_b2(fb, sh, sl, lq, cb + 8 * s, 16 * kk, lane);
          mma_split<X, true>(d[s], fa, fb);
        }
      }
      const float e0 = eL[16 * mi + g], e1 = eL[16 * mi + g + 8];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        d[s][0] *= e0; d[s][1] *= e0;
        d[s][2] *= e1; d[s][3] *= e1;
      }
      for (int kk = 0; kk <= mi; ++kk) {
        FragA fa;
        load_a2(fa, ah, al, lc, 16 * mi, 16 * kk, lane);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (s >= ns) break;
          FragB fb;
          load_b(fb, vT, lc, cb + 8 * s, 16 * kk, lane);
          mma_split<true, X>(d[s], fa, fb);
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s >= ns) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 16 * mi + g + 8 * (e >> 1), tt = t0 + t;
          const int c = cb + 8 * s + 2 * tq + (e & 1);
          if (tt < T_len && c < dvw)
            store(out + (((long long)b * T_len + tt) * H + h) * dv + c0 + c,
                  d[s][e]);
        }
      }
    }

    // d. S^T <- e^{L_C} S^T + v^T (k W) on the owner's strip, its split
    // copy to the other parity for chunk n + 1
    if (ns3 > 0) {
      const float dec = chunk_decay;
#pragma unroll
      for (int s = 0; s < 8; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) S[s][e] *= dec;
      for (int kk = 0; kk < nb; ++kk) {
        FragA fa;
        load_a(fa, vT, lc, 16 * ci, 16 * kk, lane);
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          if (s >= ns3) break;
          FragB fb;
          load_b2(fb, kwh, kwl, lc, jb + 8 * s, 16 * kk, lane);
          mma_split<X, true>(S[s], fa, fb);
        }
      }
      bf16* nh = sh0 + ((n + 1) & 1) * dvs * lq;
      bf16* nl = sl0 + ((n + 1) & 1) * dvs * lq;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        if (s >= ns3) break;
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          store_split(nh, nl,
                      (16 * ci + g + 4 * e) * lq + jb + 8 * s + 2 * tq,
                      S[s][e], S[s][e + 1]);
      }
    }
    __syncthreads();  // chunk n is done with its stage, v^T, A and S_in
  }
  if (state_out != nullptr) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      if (s >= ns3) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 16 * ci + g + 8 * (e >> 1);
        const int j = jb + 8 * s + 2 * tq + (e & 1);
        if (c < dvw && j < dk)
          state_out[((long long)bh * dk + j) * dv + c0 + c] = S[s][e];
      }
    }
  }
}

template <typename E, bool VEC>
int launch(const void* q, const void* k, const void* v, const float* logw,
           const float* state0, void* out, float* state_out, int B, int T_len,
           int H, int dk, int dv, int C, int dvs, const Strides& st,
           cudaStream_t stream) {
  const long long bytes = smem_bytes(C, dvs, dk, sizeof(E));
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  static int opted_in = 0;  // the largest size this instance opted in to
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<E, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = (int)bytes;
  }
  const long long blocks = (long long)B * H * ((dv + dvs - 1) / dvs);
  ssd_scan_kernel<E, VEC><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), logw, state0, static_cast<E*>(out),
      state_out, T_len, H, dk, dv, C, dvs, st);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_vec(bool vec, const void* q, const void* k, const void* v,
               const float* logw, const float* state0, void* out,
               float* state_out, int B, int T_len, int H, int dk, int dv,
               int C, int dvs, const Strides& st, cudaStream_t stream) {
  return vec ? launch<E, true>(q, k, v, logw, state0, out, state_out, B,
                               T_len, H, dk, dv, C, dvs, st, stream)
             : launch<E, false>(q, k, v, logw, state0, out, state_out, B,
                                T_len, H, dk, dv, C, dvs, st, stream);
}

}  // namespace

// Launches on `stream`; allocates nothing.  q/k: (B, T, H, dk) and v:
// (B, T, H, dv) of one dtype (is_bf16 ? bf16 : f32) with a contiguous
// last dimension, read through `strides` (12 element strides: (b, t, h)
// of q, k, v and logw); logw (B, T, H) f32; state0 (B, H, dk, dv) f32 or
// null; out (B, T, H, dv) contiguous in the inputs' dtype; state_out
// (B, H, dk, dv) f32 or null.  `tile` (C), `dvs` (the dv slice of a
// block) come from scan_launch.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for sizes the kernel does not take.
extern "C" int ssd_scan(const void* q, const void* k, const void* v,
                        const float* logw, const float* state0, void* out,
                        float* state_out, int B, int T_len, int H, int dk,
                        int dv, int tile, int dvs, const long long* strides,
                        int is_bf16, void* stream) {
  // one warp owns each 16 x 64 strip of the block's slice of S^T
  const int strips = dvs / 16 * ((round16(dk) + 63) / 64);
  if (B < 1 || T_len < 1 || H < 1 || dk < 1 || dk > MAX_DIM || dv < 1 ||
      dv > MAX_DIM || tile < 16 || tile > MAX_TILE || tile % 16 ||
      dvs < 16 || dvs % 16 || dvs > round16(dv) || strips > WARPS)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.w[i] = strides[9 + i];
  }
  // 16-byte copies need every row of q, k, v (and of v's slices) to start
  // on 16 bytes and to hold whole 16-byte pieces
  const int es = is_bf16 ? 2 : 4, ve = 16 / es;
  bool vec = dk % ve == 0 && dv % ve == 0 && dvs % ve == 0 &&
             ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
               reinterpret_cast<uintptr_t>(v)) & 15u) == 0;
  for (int i = 0; i < 9; ++i) vec = vec && strides[i] % ve == 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_vec<bf16>(vec, q, k, v, logw, state0, out,
                                    state_out, B, T_len, H, dk, dv, tile, dvs,
                                    st, s)
                 : launch_vec<float>(vec, q, k, v, logw, state0, out,
                                     state_out, B, T_len, H, dk, dv, tile,
                                     dvs, st, s);
}
