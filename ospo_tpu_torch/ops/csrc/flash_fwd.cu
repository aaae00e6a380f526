// Flash-attention forward for Hopper (sm_90a), fp32 online softmax.
//
// Replaces: ospo_tpu/ops/flash_attention.py::_fwd_kernel (:45-93, launched by
// _fwd_call :96-129).  Same function: per (batch, head, query tile) an fp32
// online softmax over key tiles, scale D^-0.5 applied to q, key-validity mask
// [B, S] filled with -1e30, row-causal mask j <= i, normaliser clamped at
// 1e-30; emits O, the row normaliser l and the row max m.
//
// One deliberate difference from the TPU kernel, shared with the plain
// version in flash_attention.py: keys outside the causal window or past S
// are excluded outright (probability 0) instead of filled with -1e30.  Rows
// with at least one valid key are unaffected; a query row whose every
// allowed key is masked (a left-pad row) gets the mean of V over its causal
// window, independent of the tile size.
//
// What bounds it on the card: at the prefill shapes (B=48, H=32, D=128,
// T=S=384, causal, left-padded prompts) one call needs ~22 GFLOP against
// ~0.61 GB of q/k/v/o traffic — 36 FLOP per byte, under the ~295 at which
// bf16 tensor cores would be the limit — so its floor is bytes / 3.35 TB/s
// (~0.18 ms).  This first version runs the products on the fp32 CUDA cores
// (no wgmma/TMA), which makes it compute-bound well above that floor: the
// point is the reference's fp32 semantics.  Its design keeps the T x S score
// matrix out of
// device memory (it lives in shared memory one 64 x 32 tile at a time),
// skips key tiles above the diagonal, pads shared-memory rows to avoid bank
// conflicts, and reads GQA key/value heads by index instead of copying them.
// Moving the two products onto wgmma is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int D = 128;         // head dim (the wrapper rejects others)
constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // keys per tile
constexpr int THREADS = 256;   // 16 x 16 threads
constexpr int DP = D + 1;      // padded shared row stride (floats)
constexpr int PP = BK + 1;     // padded probability row stride
constexpr float NEG_FILL = -1e30f;
constexpr size_t SMEM_BYTES =
    sizeof(float) * (BQ * DP + BK * DP + BK * D + BQ * PP);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ mask,
                 T* __restrict__ o, float* __restrict__ l_out,
                 float* __restrict__ m_out, int t_len, int s_len, int n_heads,
                 int n_kv_heads, int causal, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][DP], pre-scaled
  float* ks = qs + BQ * DP;      // [BK][DP]
  float* vs = ks + BK * DP;      // [BK][D]
  float* ps = vs + BK * D;       // [BQ][PP]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv_heads);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;       // rows ty*4 .. ty*4+3
  const int tx = tid & 15;       // score cols tx, tx+16; output cols tx+16c

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D, t = q0 + r;
    float val = 0.f;
    if (t < t_len) val = to_f(q[(((size_t)b * t_len + t) * n_heads + h) * D + d]) * scale;
    qs[r * DP + d] = val;
  }

  float m_i[4], l_i[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_FILL;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  const int s_tiles = (s_len + BK - 1) / BK;
  const int n_tiles = causal ? min(s_tiles, (q0 + BQ + BK - 1) / BK) : s_tiles;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, d = idx % D, s = k0 + r;
      float kval = 0.f, vval = 0.f;
      if (s < s_len) {
        const size_t off = (((size_t)b * s_len + s) * n_kv_heads + kvh) * D + d;
        kval = to_f(k[off]);
        vval = to_f(v[off]);
      }
      ks[r * DP + d] = kval;
      vs[r * D + d] = vval;
    }
    __syncthreads();

    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) bb[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) sc[i][j] = fmaf(a[i], bb[j], sc[i][j]);
    }

#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = k0 + tx + 16 * j;
      const bool in_range = s < s_len;
      const int mv = in_range ? mask[(size_t)b * s_len + s] : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = q0 + ty * 4 + i;
        if (!in_range || (causal && s > t)) sc[i][j] = -INFINITY;
        else if (mv == 0) sc[i][j] = NEG_FILL;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(sc[i][0], sc[i][1]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float p0 = expf(sc[i][0] - m_new);
      const float p1 = expf(sc[i][1] - m_new);
      float rs = p0 + p1;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
      ps[(ty * 4 + i) * PP + tx] = p0;
      ps[(ty * 4 + i) * PP + tx + 16] = p1;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < 8; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= t_len) continue;
    const float l_safe = fmaxf(l_i[i], 1e-30f);
    T* orow = o + (((size_t)b * t_len + t) * n_heads + h) * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / l_safe);
    if (tx == 0) {
      const size_t r = ((size_t)b * n_heads + h) * t_len + t;
      l_out[r] = l_i[i];
      m_out[r] = m_i[i];
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* mask,
           void* o, float* l, float* m, int batch, int t_len, int s_len,
           int n_heads, int n_kv_heads, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + BQ - 1) / BQ, n_heads, batch);
  flash_fwd_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), l, m, t_len, s_len,
      n_heads, n_kv_heads, causal, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
extern "C" int ospo_flash_fwd(const void* q, const void* k, const void* v,
                              const int* mask, void* o, float* l, float* m,
                              int batch, int t_len, int s_len, int n_heads,
                              int n_kv_heads, int head_dim, int causal,
                              int dtype, void* stream) {
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, mask, o, l, m, batch, t_len, s_len, n_heads,
                         n_kv_heads, causal, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, mask, o, l, m, batch, t_len, s_len,
                                 n_heads, n_kv_heads, causal, st);
  return (int)cudaErrorInvalidValue;
}
