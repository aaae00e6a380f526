// Flash-attention backward, dQ, for Hopper (sm_90a): a bf16 body on the
// tensor cores and an fp32 body on the CUDA cores.
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
// forward kernel flash_fwd.cu: fp32 scores ((q * D^-0.5) . k in the fp32
// body, as in the forward; (q . k) * D^-0.5 in the bf16 body), masked keys
// score -1e30, keys outside the row-causal window (j > i) or past S get
// probability 0.
//
// What bounds it on the card: at the training shape (32 rows, H=32, D=128,
// T=S=704, bf16, causal) one call needs ~6*D FLOP per causal (query, key)
// pair, 195.2 GFLOP (0.197 ms at the bf16 tensor-core peak of 989 TFLOP/s),
// and moves 931.5 MB of q/k/v/dO/dQ and the fp32 row statistics (0.278 ms
// at 3.35 TB/s): the bound chip_smoke.py reports is 0.278 ms, set by bytes.
//
// What held the first version back (kept as the fp32 body, dtype 0): its
// three products ran on the fp32 CUDA cores (67 TFLOP/s at most, and far
// less from shared memory padded by one float a row), the tiles were loaded
// synchronously, and a 32-key tile gave each block little work per barrier:
// 9.7 ms at the training shape, 35x its bound.
//
// The bf16 body (dtype 1) does about it:
//  - all three products on the tensor cores, mma.sync m16n8k16 bf16 with
//    fp32 accumulators: S = Q . K^T and dP = dO . V^T take q, k, v and dO
//    as they are (bf16; their products are exact in fp32), the scale is
//    applied to S after the product; dQ += ds . K takes ds rounded to bf16
//    as the A operand straight from the dP accumulator registers (the
//    FlashAttention-2 scheme), so ds never passes through shared memory;
//  - a block owns 64 query rows (4 warps x 16 rows, 128 threads) and walks
//    64-key tiles, each worked in two halves of 32 keys to bound the live
//    registers; Q and dO stay in shared memory for the whole loop, and
//    the next K/V tile (and its 64 mask words) is copied with cp.async
//    while the current one is used (two stages); the ragged edge is
//    zero-filled by cp.async's src-size operand;
//  - shared tiles are [64][128] bf16 with a 16-byte-chunk XOR swizzle, read
//    by ldmatrix (.trans for K as the B operand of ds . K) without bank
//    conflicts: 6 tiles, 96.5 KB of dynamic shared memory, two blocks an SM;
//  - blocks are numbered so that the longest causal rows (the high query
//    tiles) start first, which keeps the tail of the grid short;
//  - dQ stays in registers (16 x 128 fp32 a warp) and each row is written
//    once: no atomics, deterministic.
// flash_dq_plain keeps p and ds in fp32, as the TPU kernel does; the checks
// hold this body to it within 2^-8 max|ref| + 2^-7 |ref|, and to at most
// twice its RMS error against a float64 backward
// (tests/flash_bwd_reference.py; the rounding costs ~1.2-1.4x).  ptxas (CUDA
// 12.8): 215 registers a thread, no spills; 98,816 bytes of dynamic shared
// memory a block.  At the training shape it took 1.33 ms on an NVIDIA H100
// 80GB HBM3 at 700 W (PERF.md): ~150 TFLOP/s, held by the ldmatrix
// traffic, the per-score exp and select work, and 8 warps an SM to overlap
// them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "mma_bf16.cuh"

namespace {

constexpr int D = 128;         // head dim (the wrapper rejects others)
constexpr float NEG_FILL = -1e30f;

// ---------------------------------------------------------------------------
// fp32 body (dtype 0): the CUDA-core kernel of the first version, unchanged
// ---------------------------------------------------------------------------

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // keys per tile
constexpr int THREADS = 256;   // 16 x 16 threads
constexpr int DP = D + 1;      // padded shared row stride (floats)
constexpr int PP = BK + 1;     // padded ds row stride
constexpr size_t SMEM_BYTES =
    sizeof(float) * (2 * BQ * DP + 2 * BK * DP + BQ * PP);

__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ mask,
                 const float* __restrict__ dout, const float* __restrict__ m_in,
                 const float* __restrict__ l_in,
                 const float* __restrict__ di_in, float* __restrict__ dq,
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
      qv = q[off] * scale;
      dv = dout[off];
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
        kval = k[off];
        vval = v[off];
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
    float* row = dq + (((size_t)b * t_len + t) * n_heads + h) * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) row[tx + 16 * c] = acc[i][c];
  }
}

int launch_f32(const void* q, const void* k, const void* v, const int* mask,
               const void* dout, const float* m, const float* l,
               const float* di, void* dq, int batch, int t_len, int s_len,
               int n_heads, int n_kv_heads, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + BQ - 1) / BQ, n_heads, batch);
  flash_bwd_dq_f32<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<const float*>(dout), m,
      l, di, static_cast<float*>(dq), t_len, s_len, n_heads, n_kv_heads,
      causal, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 body (dtype 1): tensor cores, cp.async, swizzled shared tiles
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace ospo_mma;

constexpr int BQ = 64;                 // query rows per block, 16 per warp
constexpr int BK = 64;                 // keys per tile
constexpr int THREADS = 128;           // 4 warps
constexpr int TILE = 64 * D;           // bf16 elements of one [64][128] tile
// Q, dO, then two stages of K, V; then two stages of the 64 mask words
constexpr size_t SMEM_BYTES = sizeof(bf16) * 6 * TILE + sizeof(int) * 2 * BK;

__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const int* __restrict__ mask,
          const bf16* __restrict__ dout, const float* __restrict__ m_in,
          const float* __restrict__ l_in, const float* __restrict__ di_in,
          bf16* __restrict__ dq, int batch, int t_len, int s_len, int n_heads,
          int n_kv_heads, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t qs = smem_u32(smem_tc);
  const uint32_t dos = qs + TILE * 2;
  const uint32_t ks = dos + TILE * 2;          // stage st at ks + st * TILE * 2
  const uint32_t vs = ks + 2 * TILE * 2;
  int* mks = reinterpret_cast<int*>(smem_tc + 6 * TILE * 2);  // [2][BK]

  // the longest causal rows (high query tiles) first
  const int q_tiles = (t_len + BQ - 1) / BQ;
  const int bh = batch * n_heads;
  const int order = blockIdx.x / bh, rest = blockIdx.x % bh;
  const int qt = causal ? q_tiles - 1 - order : order;
  const int h = rest % n_heads, b = rest / n_heads;
  const int kvh = h / (n_heads / n_kv_heads);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;

  const size_t q_ld = (size_t)n_heads * D, k_ld = (size_t)n_kv_heads * D;
  const size_t q_off = ((size_t)b * t_len + q0) * q_ld + (size_t)h * D;
  load_tile64<THREADS>(qs, q + q_off, q_ld, t_len - q0, tid);
  load_tile64<THREADS>(dos, dout + q_off, q_ld, t_len - q0, tid);

  const int s_tiles = (s_len + BK - 1) / BK;
  const int n_tiles = causal ? min(s_tiles, (q0 + BQ + BK - 1) / BK) : s_tiles;
  const int* mask_row = mask + (size_t)b * s_len;
  auto load_kv = [&](int kt, int st) {
    const int k0 = kt * BK;
    const size_t off = ((size_t)b * s_len + k0) * k_ld + (size_t)kvh * D;
    load_tile64<THREADS>(ks + st * TILE * 2, k + off, k_ld, s_len - k0, tid);
    load_tile64<THREADS>(vs + st * TILE * 2, v + off, k_ld, s_len - k0, tid);
    if (tid < BK) {
      const bool ok = k0 + tid < s_len;
      cp_async4(smem_u32(mks + st * BK + tid), ok ? mask_row + k0 + tid : mask_row,
                ok ? 4 : 0);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // this thread's two query rows: g and g + 8 of the warp's 16
  int t_r[2];
  float m_r[2], il_r[2], di_r[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = q0 + warp * 16 + g + 8 * j;
    const size_t r = ((size_t)b * n_heads + h) * t_len + t;
    t_r[j] = t;
    m_r[j] = t < t_len ? m_in[r] : 0.f;
    il_r[j] = t < t_len ? 1.f / fmaxf(l_in[r], 1e-30f) : 0.f;
    di_r[j] = t < t_len ? di_in[r] : 0.f;
  }

  float acc[16][4];
#pragma unroll
  for (int nb = 0; nb < 16; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {
      load_kv(kt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t kst = ks + st * TILE * 2, vst = vs + st * TILE * 2;
    const int* mst = mks + st * BK;

    const int k0 = kt * BK;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * 32;                // the 32 keys of this half
      // S = Q . K^T and dP = dO . V^T, 16 rows x 32 keys a warp
      float sc[4][4], dp[4][4];
      first_products(sc, dp, qs, dos, warp * 16, kst, vst, c0, lane);
      p_and_ds(sc, dp, scale, [&](int nb, int e) {
        const int c = c0 + nb * 8 + tig * 2 + (e & 1), s = k0 + c, j = e >> 1;
        return ScoreRow{s < s_len && t_r[j] < t_len && !(causal && s > t_r[j]),
                        mst[c] != 0, m_r[j], il_r[j], di_r[j]};
      });
      // dQ += ds . K
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[4];
        a_frag(dp, kk, a);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bk[4];
          ldsm_x4_t(bt_addr(kst, c0 + kk * 16, np * 16, lane), bk);
          mma(acc[2 * np], a, bk[0], bk[1]);
          mma(acc[2 * np + 1], a, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (t_r[j] >= t_len) continue;
    bf16* row = dq + ((size_t)b * t_len + t_r[j]) * q_ld + (size_t)h * D;
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
      *reinterpret_cast<uint32_t*>(row + nb * 8 + tig * 2) =
          pack_bf16(acc[nb][2 * j], acc[nb][2 * j + 1]);
  }
}

int launch(const void* q, const void* k, const void* v, const int* mask,
           const void* dout, const float* m, const float* l, const float* di,
           void* dq, int batch, int t_len, int s_len, int n_heads,
           int n_kv_heads, int causal, cudaStream_t stream) {
  // 16-byte copies and 4-byte stores need aligned rows
  for (const void* p : {q, k, v, dout, (const void*)dq})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (t_len + BQ - 1) / BQ * n_heads * batch;
  flash_bwd_dq_bf16<<<blocks, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<const bf16*>(dout), m, l,
      di, static_cast<bf16*>(dq), batch, t_len, s_len, n_heads, n_kv_heads,
      causal, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q, dout, dq [B, T, H, D]; k, v [B, S, KVH, D]; mask [B, S] int32;
// m, l, di [B, H, T] fp32.  dtype: 0 = float32 (CUDA-core body), 1 =
// bfloat16 (tensor-core body).  Returns a cudaError_t (0 = success).
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
    return launch_f32(q, k, v, mask, dout, m, l, di, dq, batch, t_len, s_len,
                      n_heads, n_kv_heads, causal, st);
  if (dtype == 1)
    return tc::launch(q, k, v, mask, dout, m, l, di, dq, batch, t_len, s_len,
                      n_heads, n_kv_heads, causal, st);
  return (int)cudaErrorInvalidValue;
}
