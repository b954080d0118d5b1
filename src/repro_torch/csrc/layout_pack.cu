// pack_layout_fused for Hopper (sm_90a): assemble an Iris bus buffer from
// per-array piece streams.
//
// Replaces the TPU kernel src/repro/kernels/layout_pack.py:pack_layout_fused
// (_fused_pack_fn, _pack_fused_kernel), which ORs every destination u32
// word together from at most K pieces of one flat piece vector, through K
// gather and shift tables a word.  Two kernels:
//
// - pack_runs_kernel, a layer's whole pack in one launch (the wrapper
//   pack_runs; pack_pieces, pack_tree and the front door's cuda pack go
//   through it).  Output-stationary: each thread owns one destination u32
//   word of a bus row and walks that row's runs (a run: `count`
//   consecutive pieces of one array, each `width` bits, side by side from
//   bit `bit` of the row; about two a row for a smollm-135m layer).  It
//   takes the pieces that overlap its word, reads each straight from its
//   array's own tensor (an index past the array's given length reads 0),
//   masks it to its width and ORs it in shifted into place.  A piece of
//   up to 64 bits goes in whole.  The arrays' pointers, lengths and
//   element types travel by value as a kernel argument, so nothing is
//   copied before the launch; every word is written once, with no
//   atomics, no zero fill and no staging.
// - pack_fused_kernel keeps the TPU kernel's literal form (the wrapper
//   pack_words): one u32 word a thread, the OR of its K contributions from
//   the flat u32 piece stream (index 0 a zero sentinel), each shifted left
//   by scode >= 0 or right by -scode, through (K, n_words) tables.
//
// What bounds them on an H100: bytes, at the bound; in practice the
// instructions a piece costs.  For one smollm-135m layer at int4 the
// run-table pack reads 3.99 MB of arrays as stored (uint8 codes, int32
// bf16 patterns) and writes 1.99 MB: ~1.8 us at 3.35 TB/s; its run table
// (7,937 runs of 24 B) is shared by every layer of a stack.
// pack_fused_kernel reads 14.6 MB of u32 pieces that the caller must
// stage first, and 32-37 MB of contribution tables, more than L2 keeps
// across the layers of a stack.
//
// Design: a warp takes 32 neighbouring words of a row (a block a row or
// two), so its stores coalesce, the run entries it reads are one
// broadcast, and the pieces it reads lie side by side in their array.  A
// thread's pieces of one run are loaded eight at a time before any is
// used (the unrolled loop of or_pieces), and pieces of up to 32 bits take
// 32-bit shifts; only the first piece of a run can straddle in from the
// left.  Two words a thread (one u64 accumulator) ran no faster, four
// slower, and a shared-memory tile of rows with atomic ORs slower still
// (PERF.md).
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
pack_fused_kernel(const uint32_t* __restrict__ flat,
                  const int32_t* __restrict__ src,
                  const int32_t* __restrict__ scode,
                  uint32_t* __restrict__ out, long long n_words, int K) {
  const long long w = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (w >= n_words) return;
  uint32_t acc = 0u;
  for (int k = 0; k < K; ++k) {
    const long long t = (long long)k * n_words + w;
    const uint32_t v = __ldg(flat + __ldg(src + t));
    const int c = __ldg(scode + t);
    acc |= c >= 0 ? v << c : v >> -c;
  }
  out[w] = acc;
}

// One run of the run table (the wrapper's PackRuns.runs row).
struct Run {
  int array, first, row, bit, width, count;
};

// Each array's base pointer, given length (pieces) and element type by
// its size: 1 uint8, 2 int16, 4 int32, 8 int64; the signed ones are
// sign-extended to 64 bits, as torch's .to(torch.int64) does.
template <int MAXA>
struct Arrays {
  const void* ptr[MAXA];
  long long len[MAXA];
  int kind[MAXA];
};

template <typename T>
__device__ __forceinline__ unsigned long long widen(T x) {
  if constexpr (std::is_signed<T>::value)
    return (unsigned long long)(long long)x;
  else
    return (unsigned long long)x;
}

// The OR of pieces p[0], ..., p[n - 1] of a run, each masked to `width`
// bits, the first at bit `pos` of the thread's word and each next one
// `width` bits further on.  Only the first can start before the word's bit
// 0 (pos < 0: a piece straddling in from the left); every later one is a
// left shift, its bits past the word dropped (the next thread owns them).
// V is the piece type: u32 for pieces of up to 32 bits, else u64.
template <typename V, typename T>
__device__ __forceinline__ uint32_t or_pieces(const T* __restrict__ p,
                                              int n, int pos, int width) {
  const V mask = width >= (int)(8 * sizeof(V)) ? ~V(0)
                                                : (V(1) << width) - V(1);
  uint32_t acc = 0u;
  int j = 0;
  if (pos < 0) {
    acc = (uint32_t)(((V)widen(__ldg(p)) & mask) >> -pos);
    j = 1;
    pos += width;
  }
#pragma unroll 8
  for (; j < n; ++j, pos += width)
    acc |= (uint32_t)(((V)widen(__ldg(p + j)) & mask) << pos);
  return acc;
}

template <typename T>
__device__ __forceinline__ uint32_t or_run(const T* p, int n, int pos,
                                           int width) {
  return width <= 32 ? or_pieces<uint32_t>(p, n, pos, width)
                     : or_pieces<unsigned long long>(p, n, pos, width);
}

// Thread (x, y) of block b owns word g = b.y * blockDim.x + x of row
// b.x * blockDim.y + y: bits [lo, lo + 32) of the row.  It walks the row's
// runs (sorted by first bit) and ORs in the pieces that overlap its bits,
// each read where its array holds it.
template <int MAXA>
__global__ void __launch_bounds__(THREADS)
pack_runs_kernel(const Arrays<MAXA> arrays, const Run* __restrict__ runs,
                 const int* __restrict__ row_start,
                 uint32_t* __restrict__ out, int n_rows, int row_words) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  if (row >= n_rows || g >= row_words) return;
  const unsigned lo = (unsigned)g * 32u, hi = lo + 32u;
  uint32_t acc = 0u;
  const int r_end = __ldg(row_start + row + 1);
  for (int r = __ldg(row_start + row); r < r_end; ++r) {
    const unsigned bit = (unsigned)__ldg(&runs[r].bit);
    if (bit >= hi) break;
    const unsigned width = (unsigned)__ldg(&runs[r].width);
    const unsigned count = (unsigned)__ldg(&runs[r].count);
    if (bit + width * count <= lo) continue;
    const int a = __ldg(&runs[r].array);
    const long long first = __ldg(&runs[r].first);
    const unsigned k0 = lo > bit ? (lo - bit) / width : 0u;
    long long k1 = min(count, (hi - bit + width - 1u) / width);
    k1 = min(k1, arrays.len[a] - first);       // past the end: zeros
    if (k1 <= (long long)k0) continue;
    const int n = (int)(k1 - k0);
    const int pos = (int)(bit + k0 * width) - (int)lo;
    const void* p = arrays.ptr[a];
    switch (arrays.kind[a]) {
      case 1:
        acc |= or_run(static_cast<const uint8_t*>(p) + first + k0, n, pos,
                      (int)width);
        break;
      case 2:
        acc |= or_run(static_cast<const int16_t*>(p) + first + k0, n, pos,
                      (int)width);
        break;
      case 4:
        acc |= or_run(static_cast<const int32_t*>(p) + first + k0, n, pos,
                      (int)width);
        break;
      default:
        acc |= or_run(static_cast<const long long*>(p) + first + k0, n, pos,
                      (int)width);
    }
  }
  out[(long long)row * row_words + g] = acc;
}

// Blocks of THREADS threads: a row's words along x (a multiple of a warp,
// up to THREADS), as many rows as fit along y.
template <int MAXA>
int launch_runs(const unsigned long long* ptrs, const long long* lens,
                const int* kinds, int n_arrays, const Run* runs,
                const int* row_start, uint32_t* out, int n_rows,
                int row_words, cudaStream_t stream) {
  Arrays<MAXA> arrays;
  for (int i = 0; i < MAXA; ++i) {
    arrays.ptr[i] = i < n_arrays ? (const void*)ptrs[i] : nullptr;
    arrays.len[i] = i < n_arrays ? lens[i] : 0;
    arrays.kind[i] = i < n_arrays ? kinds[i] : 1;
  }
  const int bx = min(THREADS, (row_words + 31) / 32 * 32);
  const int by = THREADS / bx;
  const dim3 grid((unsigned)((n_rows + by - 1) / by),
                  (unsigned)((row_words + bx - 1) / bx));
  pack_runs_kernel<MAXA><<<grid, dim3(bx, by), 0, stream>>>(
      arrays, runs, row_start, out, n_rows, row_words);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs / lens / kinds: n_arrays host entries (Arrays); runs: (R, 6) int32
// rows sorted by row then bit; row_start: n_rows + 1 int32; out:
// n_rows * row_words u32.  Launches on `stream`; allocates
// nothing.  Returns cudaGetLastError().
extern "C" int pack_runs_u32(const unsigned long long* ptrs,
                             const long long* lens, const int* kinds,
                             int n_arrays, const void* runs,
                             const int* row_start, uint32_t* out, int n_rows,
                             int row_words, void* stream) {
  const Run* r = static_cast<const Run*>(runs);
  if (n_arrays <= 32)
    return launch_runs<32>(ptrs, lens, kinds, n_arrays, r, row_start, out,
                           n_rows, row_words, (cudaStream_t)stream);
  if (n_arrays <= 1024)
    return launch_runs<1024>(ptrs, lens, kinds, n_arrays, r, row_start, out,
                             n_rows, row_words, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// Launches on `stream`; allocates nothing.  Returns cudaGetLastError().
extern "C" int pack_layout_fused_u32(const uint32_t* flat,
                                     const int32_t* src,
                                     const int32_t* scode, uint32_t* out,
                                     long long n_words, int K,
                                     void* stream) {
  const long long blocks = (n_words + THREADS - 1) / THREADS;
  pack_fused_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      flat, src, scode, out, n_words, K);
  return (int)cudaGetLastError();
}
