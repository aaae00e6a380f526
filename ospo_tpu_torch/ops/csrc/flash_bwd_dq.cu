// Flash-attention backward, dQ, for Hopper (sm_90a), fp32 throughout.
//
// Replaces: ospo_tpu/ops/flash_attention.py::_dq_kernel (:137-178, launched
// by _flash_bwd :297-318).  Same function: per (batch, head, query tile)
// loop over key tiles up to the diagonal, recompute the probabilities from
// the forward's row max m and normaliser l (p = exp(s - m) / max(l, 1e-30)),
// dp = dO . V^T, ds = p * (dp - di) * scale, dQ += ds . K, where di =
// rowsum(O * dO) comes from the caller (computed outside the kernel, as the
// TPU wrapper does at :294).
//
// Semantics shared with flash_dq_plain in flash_attention.py and with the
// forward kernel flash_fwd.cu: scores are (q * D^-0.5) . k in fp32, masked
// keys score -1e30, keys outside the row-causal window (j > i) or past S get
// probability 0.
//
// What bounds it on the card: at the training shape (32 rows, H=32, D=128,
// T=S=704, bf16, causal) one call needs ~6*D FLOP per causal (query, key)
// pair, 195.2 GFLOP (0.197 ms at the bf16 tensor-core peak of 989 TFLOP/s),
// and moves 931.5 MB of q/k/v/dO/dQ and the fp32 row statistics (0.278 ms
// at 3.35 TB/s): the bound chip_smoke.py reports is 0.278 ms, set by bytes.
// This first version runs its three products on the fp32 CUDA cores (no
// wgmma/TMA), as flash_fwd.cu does, which keeps the reference's fp32
// arithmetic and makes it compute-bound far above either floor.  Its
// design keeps the T x S probability matrix out of device memory (one
// 64 x 32 tile of ds at a time in shared memory), stops at the diagonal,
// pads shared rows against bank conflicts, reads GQA key/value heads by
// index, and writes each dQ row once (no atomics, deterministic).  A block
// uses ~105 KB of dynamic shared memory (q, dO, K, V tiles and ds), set with
// cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int D = 128;         // head dim (the wrapper rejects others)
constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // keys per tile
constexpr int THREADS = 256;   // 16 x 16 threads
constexpr int DP = D + 1;      // padded shared row stride (floats)
constexpr int PP = BK + 1;     // padded ds row stride
constexpr float NEG_FILL = -1e30f;
constexpr size_t SMEM_BYTES =
    sizeof(float) * (2 * BQ * DP + 2 * BK * DP + BQ * PP);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ mask,
                    const T* __restrict__ dout, const float* __restrict__ m_in,
                    const float* __restrict__ l_in,
                    const float* __restrict__ di_in, T* __restrict__ dq,
                    int t_len, int s_len, int n_heads, int n_kv_heads,
                    int causal, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][DP], pre-scaled as in the forward
  float* dos = qs + BQ * DP;     // [BQ][DP]
  float* ks = dos + BQ * DP;     // [BK][DP]
  float* vs = ks + BK * DP;      // [BK][DP]
  float* dss = vs + BK * DP;     // [BQ][PP]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv_heads);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;       // rows ty*4 .. ty*4+3
  const int tx = tid & 15;       // score cols tx, tx+16; dQ cols tx+16c

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D, t = q0 + r;
    float qv = 0.f, dv = 0.f;
    if (t < t_len) {
      const size_t off = (((size_t)b * t_len + t) * n_heads + h) * D + d;
      qv = to_f(q[off]) * scale;
      dv = to_f(dout[off]);
    }
    qs[r * DP + d] = qv;
    dos[r * DP + d] = dv;
  }

  float m_r[4], l_r[4], di_r[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    const size_t r = ((size_t)b * n_heads + h) * t_len + t;
    m_r[i] = t < t_len ? m_in[r] : 0.f;
    l_r[i] = t < t_len ? fmaxf(l_in[r], 1e-30f) : 1.f;
    di_r[i] = t < t_len ? di_in[r] : 0.f;
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
      vs[r * DP + d] = vval;
    }
    __syncthreads();

    float sc[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], kb[2], vb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty * 4 + i) * DP + d];
        g[i] = dos[(ty * 4 + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kb[j] = ks[(tx + 16 * j) * DP + d];
        vb[j] = vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sc[i][j] = fmaf(a[i], kb[j], sc[i][j]);
          dp[i][j] = fmaf(g[i], vb[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = k0 + tx + 16 * j;
      const bool in_range = s < s_len;
      const int mv = in_range ? mask[(size_t)b * s_len + s] : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = q0 + ty * 4 + i;
        float p = 0.f;
        if (in_range && t < t_len && !(causal && s > t)) {
          const float sv = mv ? sc[i][j] : NEG_FILL;
          p = expf(sv - m_r[i]) / l_r[i];
        }
        dss[(ty * 4 + i) * PP + tx + 16 * j] = p * (dp[i][j] - di_r[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < 8; ++c) kv[c] = ks[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= t_len) continue;
    T* row = dq + (((size_t)b * t_len + t) * n_heads + h) * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) row[tx + 16 * c] = from_f<T>(acc[i][c]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* mask,
           const void* dout, const float* m, const float* l, const float* di,
           void* dq, int batch, int t_len, int s_len, int n_heads,
           int n_kv_heads, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + BQ - 1) / BQ, n_heads, batch);
  flash_bwd_dq_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<const T*>(dout), m, l, di,
      static_cast<T*>(dq), t_len, s_len, n_heads, n_kv_heads, causal,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout, dq [B, T, H, D]; k, v [B, S, KVH, D]; mask [B, S] int32;
// m, l, di [B, H, T] fp32.  dtype: 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t (0 = success).
extern "C" int ospo_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const int* mask, const void* dout,
                                 const float* m, const float* l,
                                 const float* di, void* dq, int batch,
                                 int t_len, int s_len, int n_heads,
                                 int n_kv_heads, int head_dim, int causal,
                                 int dtype, void* stream) {
  if (head_dim != D || n_kv_heads <= 0 || n_heads % n_kv_heads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, mask, dout, m, l, di, dq, batch, t_len,
                         s_len, n_heads, n_kv_heads, causal, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, mask, dout, m, l, di, dq, batch,
                                 t_len, s_len, n_heads, n_kv_heads, causal, st);
  return (int)cudaErrorInvalidValue;
}
