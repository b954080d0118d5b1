// The read side of an Iris bus buffer for Hopper (sm_90a): the fused
// whole-buffer decode and the per-(interval, slot) decode unit.
//
// Replaces two TPU kernels of src/repro/kernels/layout_decode.py:
// - decode_layout_fused (_fused_grid_fn, _decode_fused_kernel).  Every
//   (row, lane) entry of the static slot table holds
//   bit_offset | width << 20; the kernel funnel-shifts that field out of
//   two u32 words of its own bus row (the second clamped to the row's last
//   word), masks it to `width` bits (width 0 marks an empty lane and gives
//   0, width 32 keeps every bit) and writes the (rows, lanes) grid.  The
//   per-array gathers that turn the grid into element streams are plain
//   index gathers outside the kernel, as in the reference.
// - decode_slot (_decode_slot_kernel).  One (interval, slot): `lanes`
//   fields of one width at fixed bit offsets, from each of `n_rows` bus
//   rows of a slab, written in stream order (row-major).
//
// What bounds it on an H100: bytes.  For one smollm-135m layer at int3 the
// fused decode reads the 1.56 MB stream and the 3039 x 1408 x 4 B = 17.1 MB
// slot table and writes a grid of the same size: ~10.7 us at 3.35 TB/s with
// the table from HBM.  All layers share one layout, so across a whole-stack
// decode the table is read once and each layer costs its stream and grid
// (~5.6 us).  There is one funnel shift per entry and no arithmetic to
// speak of.  The per-slot unit reads its slab and writes its fields; a
// decode of an element-granularity layer is thousands of tiny launches, so
// launch overhead, not the card, bounds it.
//
// Design: one thread per output entry, neighbouring threads on neighbouring
// lanes of a row, so table reads and grid writes coalesce; the two word
// reads of a thread hit the same row, which the warp's other threads read
// too (L1).  The TPU kernel blocks rows into VMEM tiles; here no staging is
// needed for a first version.  Writing each piece straight to its array
// (no grid in between) is a later redesign.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t OFF_MASK = (1u << 20) - 1u;

__global__ void __launch_bounds__(THREADS)
decode_fused_kernel(const uint32_t* __restrict__ words,
                    const uint32_t* __restrict__ tab,
                    uint32_t* __restrict__ out, long long n_entries,
                    int lanes, int words32) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= n_entries) return;
  const long long row = e / lanes;
  const uint32_t t = __ldg(tab + e);
  const uint32_t off = t & OFF_MASK;
  const uint32_t width = t >> 20;
  const uint32_t w0 = off >> 5;
  const uint32_t sh = off & 31u;
  const uint32_t* r = words + row * words32;
  uint32_t v = __ldg(r + w0) >> sh;
  if (sh != 0u) {
    const uint32_t w1 = w0 + 1u < (uint32_t)words32 ? w0 + 1u
                                                    : (uint32_t)words32 - 1u;
    v |= __ldg(r + w1) << (32u - sh);
  }
  const uint32_t mask = width == 0u ? 0u : 0xFFFFFFFFu >> ((32u - width) & 31u);
  out[e] = v & mask;
}

__global__ void __launch_bounds__(THREADS)
decode_slot_kernel(const uint32_t* __restrict__ rows, long long row_stride,
                   const int32_t* __restrict__ offsets,
                   uint32_t* __restrict__ out, long long n_entries, int lanes,
                   int width) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= n_entries) return;
  const long long row = e / lanes;
  const int lane = (int)(e - row * lanes);
  const uint32_t off = (uint32_t)__ldg(offsets + lane);
  const uint32_t w0 = off >> 5;
  const uint32_t sh = off & 31u;
  const uint32_t* r = rows + row * row_stride;
  uint32_t v = __ldg(r + w0) >> sh;
  if (sh != 0u && sh + (uint32_t)width > 32u) v |= __ldg(r + w0 + 1u) << (32u - sh);
  const uint32_t mask = width < 32 ? (1u << width) - 1u : 0xFFFFFFFFu;
  out[e] = v & mask;
}

}  // namespace

// Both launch on `stream` and allocate nothing.  Return cudaGetLastError().
extern "C" int decode_layout_fused_u32(const uint32_t* words,
                                       const uint32_t* tab, uint32_t* out,
                                       int n_rows, int lanes, int words32,
                                       void* stream) {
  const long long n = (long long)n_rows * lanes;
  const long long blocks = (n + THREADS - 1) / THREADS;
  decode_fused_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      words, tab, out, n, lanes, words32);
  return (int)cudaGetLastError();
}

extern "C" int decode_slot_u32(const uint32_t* rows, long long row_stride,
                               const int32_t* offsets, uint32_t* out,
                               int n_rows, int lanes, int width,
                               void* stream) {
  const long long n = (long long)n_rows * lanes;
  const long long blocks = (n + THREADS - 1) / THREADS;
  decode_slot_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      rows, row_stride, offsets, out, n, lanes, width);
  return (int)cudaGetLastError();
}
