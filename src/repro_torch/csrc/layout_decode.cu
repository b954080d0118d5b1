// The read side of an Iris bus buffer for Hopper (sm_90a): the fused
// whole-buffer decode and the per-(interval, slot) decode.
//
// Replaces two TPU kernels of src/repro/kernels/layout_decode.py:
// - decode_layout_fused (_fused_grid_fn, _decode_fused_kernel).  The TPU
//   kernel decodes a (rows, lanes) grid from the static slot table
//   (bit_offset | width << 20 per entry) and leaves the per-array gathers
//   to index ops outside it.  Here decode_pieces_kernel writes every
//   piece straight into its place in one int64 output that holds all the
//   arrays back to back: four consecutive pieces a thread, each from its
//   descriptor (global bit offset << 6 | width - 1, 32 bits when the
//   buffer allows, else 64).  A piece of up to 64 bits is two funnel
//   shifts of the same row.  No grid is made and no gather, widening or
//   masking pass follows.  decode_grid_kernel keeps the TPU kernel's
//   literal form (the grid), for the wrapper decode_grid.
// - decode_slot (_decode_slot_kernel, one pallas_call per (interval,
//   slot) unit).  decode_units_kernel decodes every unit of a decode plan
//   in one launch, output-stationary: a block walks a contiguous chunk of
//   the plan's fields, one field a thread at a time; a thread finds its
//   unit by binary search over the prefix sums of the units' field counts
//   (read through L1), then its row and bit offset from
//   the unit's start row, lanes, first offset and lane pitch.  A field
//   of at most 32 bits stores its zero-extended int64; a piece wider than
//   32 bits is two units, its low and its high u32 word.
//   decode_slot_kernel is one unit with free lane offsets (the wrapper
//   decode_slot, int32 out).
// All four take their fields with extract_bits (bitstream.cuh), the
// port's one funnel-shift convention.
//
// What bounds it on an H100: bytes.  For one smollm-135m layer at int3
// (3.65 M pieces) the fused decode reads the 1.56 MB stream and 14.6 MB
// of u32 descriptors and writes 29.2 MB of int64 pieces: ~9.3 us at
// 3.35 TB/s with the descriptors, which every layer of a stack shares,
// counted once per stack.  The per-slot decode reads the stream and a
// unit table of a few KB and writes the same 29.2 MB.  There is one or
// two funnel shifts per piece and no arithmetic to speak of.
//
// Design: consecutive threads take consecutive pieces (fields), so the
// descriptor reads and the int64 stores coalesce; the word reads of a warp
// fall on a few neighbouring rows (L1, L2).  The fused decode keeps four
// pieces' loads in flight a thread (16-byte descriptor loads and stores).
// The per-slot decode is bound by the latency of its one field a thread
// at a time: it runs fastest with the card full of threads (16 blocks of
// 256 an SM, tools/sweep_decode_units.py); a variant with four fields in
// flight a thread needed twice the registers, so half the threads, and ran
// no faster.  Staging the prefix sums in shared memory ran no faster at
// that grid either, so they are read through L1 at every plan size.
#include <cstdint>
#include <cuda_runtime.h>

#include "bitstream.cuh"

namespace {

constexpr int THREADS = 256;
constexpr uint32_t OFF_MASK = (1u << 20) - 1u;

__device__ __forceinline__ uint32_t low_mask(uint32_t width) {
  return width == 0u ? 0u : 0xFFFFFFFFu >> ((32u - width) & 31u);
}

__global__ void __launch_bounds__(THREADS)
decode_grid_kernel(const uint32_t* __restrict__ words,
                   const uint32_t* __restrict__ tab,
                   uint32_t* __restrict__ out, long long n_entries,
                   int lanes, int words32) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= n_entries) return;
  const long long row = e / lanes;
  const uint32_t t = __ldg(tab + e);
  out[e] = extract_bits(words + row * words32, words32, t & OFF_MASK,
                        low_mask(t >> 20));
}

// One piece from its descriptor: up to 32 bits, or two fields of the same
// row for a piece of 33-64 bits.
template <typename D>
__device__ __forceinline__ unsigned long long piece_at(
    const uint32_t* __restrict__ words, long long n_words, D d) {
  const uint32_t width = (uint32_t)(d & 63u) + 1u;
  const uint32_t off = (uint32_t)(d >> 6);
  unsigned long long v = extract_bits(words, n_words, off,
                                      low_mask(width < 32u ? width : 32u));
  if (width > 32u)
    v |= (unsigned long long)extract_bits(words, n_words, off + 32u,
                                          low_mask(width - 32u)) << 32;
  return v;
}

__device__ __forceinline__ void load4(const uint32_t* p, uint32_t (&d)[4]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  d[0] = q.x; d[1] = q.y; d[2] = q.z; d[3] = q.w;
}

__device__ __forceinline__ void load4(const unsigned long long* p,
                                      unsigned long long (&d)[4]) {
  const ulonglong2 a = __ldg(reinterpret_cast<const ulonglong2*>(p));
  const ulonglong2 b = __ldg(reinterpret_cast<const ulonglong2*>(p) + 1);
  d[0] = a.x; d[1] = a.y; d[2] = b.x; d[3] = b.y;
}

// PER consecutive pieces a thread: one 16-byte descriptor load (two for
// 64-bit descriptors) and two 16-byte stores, so each thread keeps four
// pieces' loads in flight.  desc and out are 16-byte aligned.
constexpr int PER = 4;

template <typename D>
__global__ void __launch_bounds__(THREADS)
decode_pieces_kernel(const uint32_t* __restrict__ words, long long n_words,
                     const D* __restrict__ desc,
                     unsigned long long* __restrict__ out, long long n) {
  const long long p0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * PER;
  if (p0 + PER <= n) {
    D d[PER];
    load4(desc + p0, d);
    unsigned long long v[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) v[i] = piece_at(words, n_words, d[i]);
    ulonglong2* o = reinterpret_cast<ulonglong2*>(out + p0);
    o[0] = make_ulonglong2(v[0], v[1]);
    o[1] = make_ulonglong2(v[2], v[3]);
  } else {
    for (long long p = p0; p < n; ++p)
      out[p] = piece_at(words, n_words, __ldg(desc + p));
  }
}

// One unit of a decode plan: rows [row0, row0 + n_cycles) of the buffer,
// lane l of a row at bit first + l * pitch, `width` bits; field j (stream
// order) is lane j % lanes of row row0 + j / lanes.  kind 0 stores the
// zero-extended int64 of element base + j; kind 1 / 2 the low / high u32
// word of it.
struct Unit {
  int row0, lanes, first, pitch, width, kind, base, n_cycles;
};

// Block b takes fields [b * chunk, (b + 1) * chunk) (chunk a multiple of
// THREADS), THREADS at a time, so a thread's fields rise by THREADS and
// its unit moves forward: it is found by binary search once, then by one
// comparison a field (a search again only past the next unit).  Within a
// unit the row and lane advance by THREADS without a division.
__global__ void __launch_bounds__(THREADS)
decode_units_kernel(const uint32_t* __restrict__ words, int row_words,
                    const Unit* __restrict__ units,
                    const int32_t* __restrict__ pre, int n_units,
                    uint32_t* __restrict__ out, int n_fields, int chunk) {
  const int begin = blockIdx.x * chunk;
  const int end = min(begin + chunk, n_fields);
  int lo = -1, u_begin = 0, u_end = 0, row = 0, lane = 0, step_rows = 0,
      step_lanes = 0;
  Unit u;
  for (int f = begin + threadIdx.x; f < end; f += THREADS) {
    if (f >= u_end) {
      if (lo >= 0 && f < __ldg(pre + lo + 2)) {
        ++lo;
      } else {                // the last unit whose first field is <= f
        int hi = n_units - 1;
        lo = max(lo, 0);
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (__ldg(pre + mid) <= f) lo = mid; else hi = mid - 1;
        }
      }
      u = units[lo];
      u_begin = __ldg(pre + lo);
      u_end = __ldg(pre + lo + 1);
      const int j = f - u_begin;
      row = j / u.lanes;
      lane = j - row * u.lanes;
      row += u.row0;
      step_rows = THREADS / u.lanes;
      step_lanes = THREADS - step_rows * u.lanes;
    }
    const uint32_t v = extract_bits(
        words + (long long)row * row_words, row_words,
        (uint32_t)u.first + (uint32_t)lane * (uint32_t)u.pitch,
        low_mask((uint32_t)u.width));
    const long long e = (long long)u.base + (f - u_begin);
    if (u.kind == 0)
      reinterpret_cast<unsigned long long*>(out)[e] = v;
    else
      out[2 * e + (u.kind - 1)] = v;
    row += step_rows;
    lane += step_lanes;
    if (lane >= u.lanes) {
      lane -= u.lanes;
      ++row;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
decode_slot_kernel(const uint32_t* __restrict__ rows, long long row_stride,
                   int row_words, const int32_t* __restrict__ offsets,
                   uint32_t* __restrict__ out, long long n_entries, int lanes,
                   int width) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= n_entries) return;
  const long long row = e / lanes;
  const int lane = (int)(e - row * lanes);
  out[e] = extract_bits(rows + row * row_stride, row_words,
                        (uint32_t)__ldg(offsets + lane),
                        low_mask((uint32_t)width));
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

}  // namespace

// All launch on `stream` and allocate nothing.  Return cudaGetLastError().
extern "C" int decode_grid_u32(const uint32_t* words, const uint32_t* tab,
                               uint32_t* out, int n_rows, int lanes,
                               int words32, void* stream) {
  const long long n = (long long)n_rows * lanes;
  decode_grid_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      words, tab, out, n, lanes, words32);
  return (int)cudaGetLastError();
}

// desc: n descriptors of `desc_bytes` (4 or 8) each; desc and out 16-byte
// aligned.
extern "C" int decode_pieces_u64(const uint32_t* words, long long n_words,
                                 const void* desc, int desc_bytes,
                                 unsigned long long* out, long long n,
                                 void* stream) {
  const unsigned blocks = blocks_for((n + PER - 1) / PER);
  if (desc_bytes == 4)
    decode_pieces_kernel<uint32_t><<<blocks, THREADS, 0,
                                     (cudaStream_t)stream>>>(
        words, n_words, (const uint32_t*)desc, out, n);
  else
    decode_pieces_kernel<unsigned long long><<<blocks, THREADS, 0,
                                               (cudaStream_t)stream>>>(
        words, n_words, (const unsigned long long*)desc, out, n);
  return (int)cudaGetLastError();
}

// units: n_units structs of 8 int32 (Unit), none empty; prefix: n_units + 1
// int32.  Blocks of `chunk` fields (a multiple of THREADS) walk the fields.
extern "C" int decode_units_u32(const uint32_t* words, int row_words,
                                const void* units, const int32_t* prefix,
                                int n_units, uint32_t* out, int n_fields,
                                int chunk, void* stream) {
  const unsigned blocks = (unsigned)((n_fields + chunk - 1) / chunk);
  decode_units_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      words, row_words, (const Unit*)units, prefix, n_units, out, n_fields,
      chunk);
  return (int)cudaGetLastError();
}

extern "C" int decode_slot_u32(const uint32_t* rows, long long row_stride,
                               int row_words, const int32_t* offsets,
                               uint32_t* out, int n_rows, int lanes,
                               int width, void* stream) {
  const long long n = (long long)n_rows * lanes;
  decode_slot_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      rows, row_stride, row_words, offsets, out, n, lanes, width);
  return (int)cudaGetLastError();
}
