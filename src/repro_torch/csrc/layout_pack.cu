// pack_layout_fused for Hopper (sm_90a): assemble an Iris bus buffer from
// its flat piece stream, one u32 destination word per thread.
//
// Replaces the TPU kernel src/repro/kernels/layout_pack.py:pack_layout_fused
// (_fused_pack_fn, _pack_fused_kernel).  Same arithmetic: every destination
// word is the OR of at most K contributions, each a piece gathered from the
// flat stream (index 0 is a zero sentinel for an empty slot) and shifted
// left by scode >= 0, or right by -scode for the high part of a piece that
// straddles a u32 boundary.  The contribution tables are the reference's
// pack_kernel_tables, transposed once per layout to (K, n_words) so that
// for a fixed k neighbouring threads read neighbouring table entries.
//
// What bounds it on an H100: bytes.  Per smollm-135m layer at int3 the
// tables hold 2 x 389k words x K=12 x 4 B = 37.3 MB, the piece stream
// 14.6 MB and the output 1.56 MB; there is one shift and one OR per
// table entry, so the table reads dominate: ~16 us at 3.35 TB/s when they
// come from HBM.  Every layer of a stack shares one layout and so one set
// of tables; across a whole-stack pack only the pieces and the output are
// new per layer (~4.8 us).
//
// Design: the TPU kernel stages the whole flat piece vector into every
// grid step and splits the shift into three tables; here each thread
// gathers its K pieces through L2 and keeps the one signed shift table.
// Neighbouring threads take neighbouring words of a row and the tables are
// read k-major, so each table read of a warp is one 128-byte line.  The
// gathers of the pieces are scattered (a word's pieces come from up to K
// arrays) and go through L2 and L1.  Simple and correct first; the shift
// and source could be packed into one 32-bit entry later.
#include <cstdint>
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

}  // namespace

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
