// W4A16 decode matmul for Hopper (sm_90a), shared by int4_matmul_row.cu and
// int4_matmul_group.cu: y[M, F] = x[M, D] . W^T with W packed two output rows
// per byte (q4 [F/2, D] int8: row i in the low nibble, row i + F/2 in the
// high nibble, both sign-extended).
//
// Design (a simple tiled product on the CUDA cores):
//  - a block owns 64 packed rows (128 output columns: 64 of the low plane,
//    64 of the high plane) x 64 rows of x, over one split of D; 256 threads,
//    each with a 4 x 8 tile of fp32 sums;
//  - per stage of 32 columns, 128 threads read the block's packed bytes with
//    one 16-byte load each, sign-extend both nibbles in registers (and, for
//    groups, form w = r(nib * r(gs)) there) and store both planes to shared
//    memory as fp32; x's stage is staged beside it, transposed, as fp32; the
//    next stage's loads are issued before the current stage's products, so
//    the global latency hides behind them;
//  - each byte is read once per 64 rows of x (once at the serving M = 48);
//  - D is split across blocks so that the grid fills the card; with more
//    than one split, fp32 partial sums [n_split, M, F] are summed in split
//    order by a second pass, which also rounds (and, per row, scales);
//  - output columns i and i + F/2 are written straight to y[:, i] and
//    y[:, F/2 + i]: no concatenation follows.
// Products of two bf16 values (or of an fp32 x and a small integer) are exact
// in fp32, so the kernel and the plain version differ only in the order of
// the fp32 sums.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace ospo_int4 {

constexpr int THREADS = 256;
constexpr int MT = 64;            // rows of x per block
constexpr int NP = 64;            // packed rows per block (2 * NP output columns)
constexpr int KC = 32;            // columns per shared-memory stage
constexpr int XS_LD = MT + 4;     // padded leading dims of the stage buffers
constexpr int WS_LD = 2 * NP + 4;
constexpr int W_VECS = NP * KC / 16;  // 16-byte weight loads per stage
constexpr int MIN_ALIGN = 16;     // D and the group size: multiples of this

template <typename XT> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <typename XT> __device__ __forceinline__ XT from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes of x → VEC floats
__device__ __forceinline__ void unpack_x(const uint4& u, float* out, const float*) {
  out[0] = __uint_as_float(u.x); out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z); out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack_x(const uint4& u, float* out, const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Output value from an fp32 sum: per row r(r(acc) * r(s[f])), per group r(acc)
template <typename XT, bool GROUP>
__device__ __forceinline__ XT finish(float acc, const float* __restrict__ s, int f) {
  if (GROUP) return from_f<XT>(acc);
  return from_f<XT>(rnd<XT>(acc) * rnd<XT>(s[f]));
}

template <typename XT, bool GROUP>
__global__ void __launch_bounds__(THREADS)
int4_decode_matmul(const XT* __restrict__ x, const int8_t* __restrict__ q4,
                   const float* __restrict__ scale, XT* __restrict__ y,
                   float* __restrict__ part, int m_rows, int f2, int d,
                   int n_groups, int dsplit, int nsplit) {
  constexpr int VEC = 16 / sizeof(XT);            // x elements per 16 bytes
  constexpr int XV = MT * KC / VEC / THREADS;     // x loads per thread
  __shared__ __align__(16) float xs[KC * XS_LD];
  __shared__ __align__(16) float ws[KC * WS_LD];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * NP;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int kbeg = split * dsplit;
  const int kend = min(d, kbeg + dsplit);
  const int f = 2 * f2;
  const int group = GROUP ? d / n_groups : 1;

  uint4 xr[XV], wr;
  float gl = 0.f, gh = 0.f;

  auto load_stage = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int v = tid + i * THREADS;
      const int m = v / (KC / VEC), c = (v % (KC / VEC)) * VEC;
      const int row = m0 + m, col = k0 + c;
      xr[i] = (row < m_rows && col < kend)
                  ? *reinterpret_cast<const uint4*>(x + (size_t)row * d + col)
                  : make_uint4(0, 0, 0, 0);
    }
    if (tid < W_VECS) {
      const int r = tid / (KC / 16), c = (tid % (KC / 16)) * 16;
      const int prow = r0 + r, col = k0 + c;
      const bool ok = prow < f2 && col < kend;
      wr = ok ? *reinterpret_cast<const uint4*>(q4 + (size_t)prow * d + col)
              : make_uint4(0, 0, 0, 0);
      if (GROUP && ok) {
        const int g = col / group;  // the 16 columns lie in one group
        gl = scale[(size_t)prow * n_groups + g];
        gh = scale[(size_t)(prow + f2) * n_groups + g];
      }
    }
  };

  auto store_stage = [&]() {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int v = tid + i * THREADS;
      const int m = v / (KC / VEC), c = (v % (KC / VEC)) * VEC;
      float vals[VEC];
      unpack_x(xr[i], vals, x);
#pragma unroll
      for (int e = 0; e < VEC; ++e) xs[(c + e) * XS_LD + m] = vals[e];
    }
    if (tid < W_VECS) {
      const int r = tid / (KC / 16), c = (tid % (KC / 16)) * 16;
      const uint32_t words[4] = {wr.x, wr.y, wr.z, wr.w};
      const float sl = rnd<XT>(gl), sh = rnd<XT>(gh);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          // sign-extend each nibble with an arithmetic shift of the word
          const int lo = static_cast<int>(words[j] << (28 - 8 * b)) >> 28;
          const int hi = static_cast<int>(words[j] << (24 - 8 * b)) >> 28;
          float wl = (float)lo, wh = (float)hi;
          if (GROUP) {
            wl = rnd<XT>(wl * sl);
            wh = rnd<XT>(wh * sh);
          }
          const int kk = c + 4 * j + b;
          ws[kk * WS_LD + r] = wl;
          ws[kk * WS_LD + NP + r] = wh;
        }
      }
    }
  };

  const int ty = tid / 16, tx = tid % 16;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_stage(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += KC) {
    store_stage();
    __syncthreads();
    if (k0 + KC < kend) load_stage(k0 + KC);
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk * XS_LD + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = ws[kk * WS_LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= m_rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j;               // j < 4: low plane, else high
      const int r = r0 + (n % NP);
      if (r >= f2) continue;
      const int col = n < NP ? r : f2 + r;
      if (nsplit == 1)
        y[(size_t)m * f + col] = finish<XT, GROUP>(acc[i][j], scale, col);
      else
        part[((size_t)split * m_rows + m) * f + col] = acc[i][j];
    }
  }
}

// Second pass: sum the splits' partials in split order, round (and scale)
template <typename XT, bool GROUP>
__global__ void __launch_bounds__(THREADS)
int4_combine(const float* __restrict__ part, const float* __restrict__ scale,
             XT* __restrict__ y, int m_rows, int f, int nsplit) {
  const size_t total = (size_t)m_rows * f;
  for (size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * THREADS) {
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s) acc += part[(size_t)s * total + idx];
    y[idx] = finish<XT, GROUP>(acc, scale, (int)(idx % f));
  }
}

template <typename XT, bool GROUP>
int launch(const void* x, const int8_t* q4, const float* scale, void* y,
           float* part, int m, int f2, int d, int n_groups, int dsplit,
           int nsplit, cudaStream_t st) {
  const dim3 grid((f2 + NP - 1) / NP, nsplit, (m + MT - 1) / MT);
  int4_decode_matmul<XT, GROUP><<<grid, THREADS, 0, st>>>(
      static_cast<const XT*>(x), q4, scale, static_cast<XT*>(y), part, m, f2,
      d, n_groups, dsplit, nsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  const size_t want = ((size_t)m * 2 * f2 + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 1056 ? want : 1056);  // 8 per SM at most
  int4_combine<XT, GROUP><<<blocks, THREADS, 0, st>>>(
      part, scale, static_cast<XT*>(y), m, 2 * f2, nsplit);
  return (int)cudaGetLastError();
}

// x_dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
template <bool GROUP>
int dispatch(const void* x, const int8_t* q4, const float* scale, void* y,
             float* part, int m, int f2, int d, int n_groups, int dsplit,
             int nsplit, int x_dtype, void* stream) {
  if (m < 1 || m > 256 || f2 < 1 || d < 1 || d % MIN_ALIGN || dsplit < 1 ||
      dsplit % KC || nsplit < 1 || (long long)(nsplit - 1) * dsplit >= d ||
      (long long)nsplit * dsplit < d)
    return (int)cudaErrorInvalidValue;
  if (GROUP && (n_groups < 1 || d % n_groups || (d / n_groups) % MIN_ALIGN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch<float, GROUP>(x, q4, scale, y, part, m, f2, d, n_groups,
                                dsplit, nsplit, st);
  if (x_dtype == 1)
    return launch<__nv_bfloat16, GROUP>(x, q4, scale, y, part, m, f2, d,
                                        n_groups, dsplit, nsplit, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ospo_int4
