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
// The TPU walks a (B*H, T/C) grid with T innermost and carries S in VMEM
// scratch from one grid step to the next.  Blocks on the GPU run in no
// order, so here one block owns one (batch, head) and the chunk loop runs
// inside it, with S (dk x dv f32, 16 KB at 64 x 64) held in shared memory
// across the loop.  The block may start S from state0 and write the final
// S out (the port's Mamba layer returns it, as recurrent_scan does).
//
// What bounds it on an H100: arithmetic.  At jamba's prefill (B=2,
// T=1024, H=256, dk=dv=64, C=128) the function moves ~270 MB (bf16
// q/k/v in, f32 logw, bf16 out), 0.08 ms at 3.35 TB/s, and does 19.3
// GFLOP with the masked triangle skipped, 0.29 ms at the 67 TFLOP/s of
// f32 on CUDA cores.  This first kernel uses CUDA cores only: each thread
// owns 4 x 4 output tiles of the three products, reading 16-byte rows of
// shared memory.  Tensor cores (wgmma), TMA and a split of the chunk loop
// across blocks are later work.
//
// Design notes:
// - The masked triangle: the reference computes e^{L_t - L_i} on the whole
//   C x C tile and masks after the product; above the diagonal that
//   exponent is positive and can overflow to inf.  Here tiles wholly
//   above the diagonal are skipped and, on the diagonal, i > t is zeroed
//   before any exponential is taken.
// - Shared memory: q^T and k^T (dk x (C+4)), v (C x dv), the score tile
//   (C x (C+4)), S and L take 184 KB at C=128, dk=dv=64, so the launch
//   opts in to dynamic shared memory above 48 KB (one block per SM).  The
//   +4 row pad keeps 16-byte alignment and breaks bank conflicts.
// - Ragged T and odd sizes: rows past T (and past C up to a multiple of 4)
//   load as zero q/k/v with logw = 0, i.e. decay 1, which leaves S exactly
//   as it was; no padding copy is needed.  dk, dv <= 64, C <= 128.
// - q, k, v are read through their (b, t, h) strides (the Mamba layer's
//   C/B projections are views into one matmul output); the last dimension
//   must be contiguous.  Inputs f32 or bf16, logw f32, sums f32, output in
//   the inputs' dtype (round to nearest even).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CHUNK = 128;
constexpr int MAX_DIM = 64;

struct Strides {
  long long q[3], k[3], v[3], w[3];  // (b, t, h) element strides
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// floats of dynamic shared memory for chunk C and widths dk, dv
__host__ __device__ inline long long smem_floats(int C, int dk, int dv) {
  const int cp = round4(C), ld = cp + 4, dkp = round4(dk), dvp = round4(dv);
  return 2LL * dkp * ld + (long long)cp * dvp + (long long)cp * ld +
         (long long)dkp * dvp + 2LL * cp;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ state0, T* __restrict__ out,
                float* __restrict__ state_out, int T_len, int H, int dk,
                int dv, int C, Strides st) {
  extern __shared__ __align__(16) float smem[];
  const int cp = round4(C), ld = cp + 4, dkp = round4(dk), dvp = round4(dv);
  float* qT = smem;             // [dkp][ld]  q^T of the chunk
  float* kT = qT + dkp * ld;    // [dkp][ld]  k^T of the chunk
  float* vs = kT + dkp * ld;    // [cp][dvp]
  float* A = vs + cp * dvp;     // [cp][ld]   masked, decayed scores
  float* S = A + cp * ld;       // [dkp][dvp] carried state
  float* L = S + dkp * dvp;     // [cp]       cumsum(logw) in the chunk
  float* W = L + cp;            // [cp]       e^{L_C - L_i}
  __shared__ float chunk_decay;  // e^{L_C}

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];
  const float* wb = logw + b * st.w[0] + h * st.w[2];
  const int nt = cp / 4, nj = dkp / 4, nc = dvp / 4;

  for (int i = tid; i < dkp * dvp; i += THREADS) {
    const int j = i / dvp, c = i % dvp;
    S[i] = (state0 != nullptr && j < dk && c < dv)
               ? state0[((long long)bh * dk + j) * dv + c] : 0.f;
  }

  for (int t0 = 0; t0 < T_len; t0 += C) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < cp * dkp; i += THREADS) {
      const int r = i / dkp, j = i % dkp, t = t0 + r;
      const bool ok = r < C && t < T_len && j < dk;
      qT[j * ld + r] = ok ? to_f32(qb[t * st.q[1] + j]) : 0.f;
      kT[j * ld + r] = ok ? to_f32(kb[t * st.k[1] + j]) : 0.f;
    }
    for (int i = tid; i < cp * dvp; i += THREADS) {
      const int r = i / dvp, c = i % dvp, t = t0 + r;
      vs[i] = (r < C && t < T_len && c < dv) ? to_f32(vb[t * st.v[1] + c])
                                             : 0.f;
    }
    if (tid < 32) {  // warp 0: prefix sum of logw over the chunk
      float part[4];
      float run = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = tid * 4 + u, t = t0 + r;
        run += (r < C && t < T_len) ? wb[t * st.w[1]] : 0.f;
        part[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += y;
      }
      const float excl = incl - run;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = tid * 4 + u;
        if (r < cp) L[r] = excl + part[u];
      }
      __syncwarp();
      const float last = L[cp - 1];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = tid * 4 + u;
        if (r < cp) W[r] = expf(last - L[r]);
      }
      if (tid == 0) chunk_decay = expf(last);
    }
    __syncthreads();

    // scores A[t][i] = (q_t . k_i) e^{L_t - L_i} for i <= t; tiles wholly
    // above the diagonal are never read and not computed
    for (int u = tid; u < nt * nt; u += THREADS) {
      const int ti = u / nt, ii = u % nt;
      if (ii > ti) continue;
      float a[4][4] = {};
      for (int j = 0; j < dkp; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(qT + j * ld + 4 * ti);
        const float4 y = *reinterpret_cast<const float4*>(kT + j * ld + 4 * ii);
        const float xr[4] = {x.x, x.y, x.z, x.w};
        const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) a[r][s] = fmaf(xr[r], ys[s], a[r][s]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 4 * ti + r;
        float o[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int i = 4 * ii + s;
          o[s] = i <= t ? a[r][s] * expf(L[t] - L[i]) : 0.f;
        }
        *reinterpret_cast<float4*>(A + t * ld + 4 * ii) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();

    // o = e^{L_t} (q S_in) + A v, over the kept triangle only
    for (int u = tid; u < nt * nc; u += THREADS) {
      const int ti = u / nc, ci = u % nc;
      float o[4][4] = {}, p[4][4] = {};
      for (int i = 0; i < 4 * ti + 4; ++i) {
        const float4 y = *reinterpret_cast<const float4*>(vs + i * dvp + 4 * ci);
        const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = A[(4 * ti + r) * ld + i];
#pragma unroll
          for (int s = 0; s < 4; ++s) o[r][s] = fmaf(x, ys[s], o[r][s]);
        }
      }
      for (int j = 0; j < dkp; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(qT + j * ld + 4 * ti);
        const float4 y = *reinterpret_cast<const float4*>(S + j * dvp + 4 * ci);
        const float xr[4] = {x.x, x.y, x.z, x.w};
        const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) p[r][s] = fmaf(xr[r], ys[s], p[r][s]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 4 * ti + r, tt = t0 + t;
        if (t >= C || tt >= T_len) continue;
        const float e = expf(L[t]);
        T* orow = out + (((long long)b * T_len + tt) * H + h) * dv;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int c = 4 * ci + s;
          if (c < dv) store(orow + c, fmaf(e, p[r][s], o[r][s]));
        }
      }
    }
    __syncthreads();  // S_in is read above and rewritten below

    // S <- e^{L_C} S + (k * e^{L_C - L})^T v
    const float dec = chunk_decay;
    for (int u = tid; u < nj * nc; u += THREADS) {
      const int ji = u / nc, ci = u % nc;
      float acc[4][4] = {};
      for (int i = 0; i < cp; ++i) {
        const float4 y = *reinterpret_cast<const float4*>(vs + i * dvp + 4 * ci);
        const float ys[4] = {y.x, y.y, y.z, y.w};
        const float w = W[i];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = kT[(4 * ji + r) * ld + i] * w;
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(x, ys[s], acc[r][s]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          float* sp = S + (4 * ji + r) * dvp + 4 * ci + s;
          *sp = fmaf(dec, *sp, acc[r][s]);
        }
    }
  }
  if (state_out != nullptr) {
    __syncthreads();
    for (int i = tid; i < dk * dv; i += THREADS) {
      const int j = i / dv, c = i % dv;
      state_out[(long long)bh * dk * dv + i] = S[j * dvp + c];
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* logw,
           const float* state0, void* out, float* state_out, int B, int T_len,
           int H, int dk, int dv, int C, const Strides& st,
           cudaStream_t stream) {
  const size_t bytes = (size_t)smem_floats(C, dk, dv) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<B * H, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, state0, static_cast<T*>(out),
      state_out, T_len, H, dk, dv, C, st);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; allocates nothing.  q/k: (B, T, H, dk) and v:
// (B, T, H, dv) of one dtype (is_bf16 ? bf16 : f32) with a contiguous
// last dimension, read through `strides` (12 element strides: (b, t, h)
// of q, k, v and logw); logw (B, T, H) f32; state0 (B, H, dk, dv) f32 or
// null; out (B, T, H, dv) contiguous in the inputs' dtype; state_out
// (B, H, dk, dv) f32 or null.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for sizes the kernel does not take.
extern "C" int ssd_scan(const void* q, const void* k, const void* v,
                        const float* logw, const float* state0, void* out,
                        float* state_out, int B, int T_len, int H, int dk,
                        int dv, int C, const long long* strides, int is_bf16,
                        void* stream) {
  if (B < 1 || T_len < 1 || H < 1 || dk < 1 || dk > MAX_DIM || dv < 1 ||
      dv > MAX_DIM || C < 1 || C > MAX_CHUNK)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.w[i] = strides[9 + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, logw, state0, out,
                                         state_out, B, T_len, H, dk, dv, C,
                                         st, s)
                 : launch<float>(q, k, v, logw, state0, out, state_out, B,
                                 T_len, H, dk, dv, C, st, s);
}
