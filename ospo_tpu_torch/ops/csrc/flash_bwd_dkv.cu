// Flash-attention backward, dK and dV, for Hopper (sm_90a), fp32 throughout.
//
// Replaces: ospo_tpu/ops/flash_attention.py::_dkv_kernel (:181-232, launched
// by _flash_bwd :320-347, which then sums the GQA heads at :352-355).  Same
// function: per key tile, loop over the query tiles from the diagonal,
// recompute p = exp(s - m) / max(l, 1e-30) from the forward's row max and
// normaliser, dV += p^T . dO, dp = dO . V^T, ds = p * (dp - di) * scale,
// dK += ds^T . Q.  Semantics are those of flash_bwd_dq.cu and of
// flash_dkv_plain in flash_attention.py: scores (q * D^-0.5) . k in fp32,
// masked keys -1e30, keys with j > i (causal) or past S get probability 0.
//
// GQA: one block per (batch, key/value head, 64-key tile) also loops over
// the query heads of its group, so dK and dV are summed over the group in
// registers and written once: no atomics, the result is deterministic, and
// no [B, S, H, D] per-query-head gradient is ever stored.
//
// What bounds it on the card: at the training shape (32 rows, H=32, D=128,
// T=S=704, bf16, causal) one call needs ~8*D FLOP per causal pair,
// 260.2 GFLOP (0.263 ms at the bf16 tensor-core peak of 989 TFLOP/s), and
// moves 1116.0 MB of q/k/v/dO/dK/dV and the fp32 row statistics (0.333 ms
// at 3.35 TB/s): the bound chip_smoke.py reports is 0.333 ms, set by bytes.
// Like flash_fwd.cu this first
// version runs its four products on the fp32 CUDA cores, so it is
// compute-bound far above both floors; the design keeps the probability
// and ds tiles in shared memory (never the T x S matrix in device memory),
// starts at the diagonal, pads shared rows against bank conflicts, and
// holds the 64 x 128 dK and dV sums in registers (64 floats a thread).  The
// Q scale is folded into the shared Q tile, so dK = (p * (dp - di))^T . Q*,
// which is ds^T . Q.  A block uses ~113 KB of dynamic shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int D = 128;         // head dim (the wrapper rejects others)
constexpr int BK = 64;         // keys per block
constexpr int BQ = 32;         // query rows per inner tile
constexpr int THREADS = 256;   // 16 x 16 threads
constexpr int DP = D + 1;      // padded shared row stride (floats)
constexpr int PP = BK + 1;     // padded p / ds row stride
constexpr float NEG_FILL = -1e30f;
constexpr size_t SMEM_BYTES =
    sizeof(float) * (2 * BK * DP + 2 * BQ * DP + 2 * BQ * PP + 3 * BQ);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ mask,
                     const T* __restrict__ dout, const float* __restrict__ m_in,
                     const float* __restrict__ l_in,
                     const float* __restrict__ di_in, T* __restrict__ dk,
                     T* __restrict__ dv, int t_len, int s_len, int n_heads,
                     int n_kv_heads, int causal, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;              // [BK][DP]
  float* vs = ks + BK * DP;      // [BK][DP]
  float* qs = vs + BK * DP;      // [BQ][DP], pre-scaled as in the forward
  float* dos = qs + BQ * DP;     // [BQ][DP]
  float* ps = dos + BQ * DP;     // [BQ][PP]  p
  float* dss = ps + BQ * PP;     // [BQ][PP]  p * (dp - di)
  float* m_s = dss + BQ * PP;    // [BQ]
  float* l_s = m_s + BQ;         // [BQ]
  float* di_s = l_s + BQ;        // [BQ]

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = n_heads / n_kv_heads;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;       // score rows ty*2, ty*2+1; key rows ty*4..+3
  const int tx = tid & 15;       // score key cols tx+16j; dK/dV cols tx+16c

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
  bool in_range[4];
  int kmask[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = k0 + tx + 16 * j;
    in_range[j] = s < s_len;
    kmask[j] = in_range[j] ? mask[(size_t)b * s_len + s] : 0;
  }

  float acc_k[4][8], acc_v[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int q_tiles = (t_len + BQ - 1) / BQ;
  const int qt_start = causal ? k0 / BQ : 0;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    for (int qt = qt_start; qt < q_tiles; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's readers are done
      for (int idx = tid; idx < BQ * D; idx += THREADS) {
        const int r = idx / D, d = idx % D, t = q0 + r;
        float qv = 0.f, gv = 0.f;
        if (t < t_len) {
          const size_t off = (((size_t)b * t_len + t) * n_heads + h) * D + d;
          qv = to_f(q[off]) * scale;
          gv = to_f(dout[off]);
        }
        qs[r * DP + d] = qv;
        dos[r * DP + d] = gv;
      }
      if (tid < BQ) {
        const int t = q0 + tid;
        const size_t r = ((size_t)b * n_heads + h) * t_len + t;
        m_s[tid] = t < t_len ? m_in[r] : 0.f;
        l_s[tid] = t < t_len ? fmaxf(l_in[r], 1e-30f) : 1.f;
        di_s[tid] = t < t_len ? di_in[r] : 0.f;
      }
      __syncthreads();

      float sc[2][4], dp[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[a][j] = dp[a][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qa[2], ga[2], kb[4], vb[4];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          qa[a] = qs[(ty * 2 + a) * DP + d];
          ga[a] = dos[(ty * 2 + a) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kb[j] = ks[(tx + 16 * j) * DP + d];
          vb[j] = vs[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[a][j] = fmaf(qa[a], kb[j], sc[a][j]);
            dp[a][j] = fmaf(ga[a], vb[j], dp[a][j]);
          }
      }

#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = ty * 2 + a, t = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = k0 + tx + 16 * j;
          float p = 0.f;
          if (in_range[j] && t < t_len && !(causal && s > t)) {
            const float sv = kmask[j] ? sc[a][j] : NEG_FILL;
            p = expf(sv - m_s[r]) / l_s[r];
          }
          ps[r * PP + tx + 16 * j] = p;
          dss[r * PP + tx + 16 * j] = p * (dp[a][j] - di_s[r]);
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pr[4], dr[4], gv[8], qv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = ps[r * PP + ty * 4 + i];
          dr[i] = dss[r * PP + ty * 4 + i];
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          gv[c] = dos[r * DP + tx + 16 * c];
          qv[c] = qs[r * DP + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            acc_v[i][c] = fmaf(pr[i], gv[c], acc_v[i][c]);
            acc_k[i][c] = fmaf(dr[i], qv[c], acc_k[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty * 4 + i;
    if (s >= s_len) continue;
    const size_t off = (((size_t)b * s_len + s) * n_kv_heads + kvh) * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      dk[off + tx + 16 * c] = from_f<T>(acc_k[i][c]);
      dv[off + tx + 16 * c] = from_f<T>(acc_v[i][c]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* mask,
           const void* dout, const float* m, const float* l, const float* di,
           void* dk, void* dv, int batch, int t_len, int s_len, int n_heads,
           int n_kv_heads, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_len + BK - 1) / BK, n_kv_heads, batch);
  flash_bwd_dkv_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<const T*>(dout), m, l, di,
      static_cast<T*>(dk), static_cast<T*>(dv), t_len, s_len, n_heads,
      n_kv_heads, causal, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout [B, T, H, D]; k, v, dk, dv [B, S, KVH, D]; mask [B, S] int32;
// m, l, di [B, H, T] fp32.  dtype: 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t (0 = success).
extern "C" int ospo_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const int* mask, const void* dout,
                                  const float* m, const float* l,
                                  const float* di, void* dk, void* dv,
                                  int batch, int t_len, int s_len, int n_heads,
                                  int n_kv_heads, int head_dim, int causal,
                                  int dtype, void* stream) {
  if (head_dim != D || n_kv_heads <= 0 || n_heads % n_kv_heads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, mask, dout, m, l, di, dk, dv, batch, t_len,
                         s_len, n_heads, n_kv_heads, causal, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, mask, dout, m, l, di, dk, dv, batch,
                                 t_len, s_len, n_heads, n_kv_heads, causal, st);
  return (int)cudaErrorInvalidValue;
}
