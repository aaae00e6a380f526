// Flash-attention backward, dK and dV, for Hopper (sm_90a): a bf16 body on
// the tensor cores and an fp32 body on the CUDA cores.
//
// Replaces: ospo_tpu/ops/flash_attention.py::_dkv_kernel (:181-232, launched
// by _flash_bwd :320-347, which then sums the GQA heads at :352-355).  Same
// function: per key tile, loop over the query tiles from the diagonal,
// recompute p = exp(s - m) / max(l, 1e-30) from the forward's row max and
// normaliser, dV += p^T . dO, dp = dO . V^T, ds = p * (dp - di) * scale,
// dK += ds^T . Q.  Semantics are those of flash_bwd_dq.cu and of
// flash_dkv_plain in flash_attention.py: fp32 scores, masked keys -1e30,
// keys with j > i (causal) or past S get probability 0.
//
// GQA: one block per (batch, key/value head, 64-key tile) also loops over
// the query heads of its group, so dK and dV are summed over the group in
// registers, in fp32, and written once: no atomics, the result is
// deterministic, and no [B, S, H, D] per-query-head gradient is ever stored.
//
// What bounds it on the card: at the training shape (32 rows, H=32, D=128,
// T=S=704, bf16, causal) one call needs ~8*D FLOP per causal pair,
// 260.2 GFLOP (0.263 ms at the bf16 tensor-core peak of 989 TFLOP/s), and
// moves 1116.0 MB of q/k/v/dO/dK/dV and the fp32 row statistics (0.333 ms
// at 3.35 TB/s): the bound chip_smoke.py reports is 0.333 ms, set by bytes.
//
// What held the first version back (kept as the fp32 body, dtype 0): its
// four products ran on the fp32 CUDA cores from shared memory padded by one
// float a row, with p and ds staged through shared memory and the Q/dO
// tiles loaded synchronously between barriers: 17.6 ms at the training
// shape, 53x its bound.  It folds the scale into its shared Q tile, so its
// dK = (p * (dp - di))^T . Q*, which is ds^T . Q.
//
// The bf16 body (dtype 1) does about it:
//  - all four products on the tensor cores, mma.sync m16n8k16 bf16 with
//    fp32 accumulators.  The block computes S^T = K . Q^T and dP^T = V . dO^T
//    (keys as rows), so that p^T and ds^T, rounded to bf16, are the A
//    operands of dV += p^T . dO and dK += ds^T . Q straight from the
//    accumulator registers (the FlashAttention-2 scheme): p and ds never
//    pass through shared memory.  q, k, v and dO are taken as they are
//    (bf16; their products are exact in fp32); the scale is applied to S^T
//    after the product, and dK uses the unscaled Q tile (ds holds the scale);
//  - a block owns 64 keys (4 warps x 16 keys, 128 threads); K and V stay in
//    shared memory, dK and dV (2 x 16 x 128 fp32 a warp) in registers; it
//    walks (query head of the group, 64-row Q tile) pairs from the diagonal,
//    each worked in two halves of 32 rows to bound the live registers, and
//    the next pair's Q, dO and m/l/di rows are copied with cp.async while
//    the current one is used (two stages); the ragged edge is zero-filled by
//    cp.async's src-size operand;
//  - shared tiles are [64][128] bf16 with a 16-byte-chunk XOR swizzle, read
//    by ldmatrix (.trans for Q and dO as B operands) without bank conflicts:
//    6 tiles and the statistics, 97.5 KB of dynamic shared memory, two
//    blocks an SM;
//  - blocks are numbered so that the low key tiles (the longest causal
//    loops) start first, which keeps the tail of the grid short.
// flash_dkv_plain keeps p and ds in fp32, as the TPU kernel does; the checks
// hold this body to it within 2^-8 max|ref| + 2^-7 |ref|, and to at most
// twice its RMS error against a float64 backward
// (tests/flash_bwd_reference.py; the rounding costs ~1.2-1.4x).
// ptxas (CUDA 12.8): 255 registers a thread (dK and dV alone take 128), no
// spills; 99,840 bytes of dynamic shared memory a block.  At the training
// shape it took 1.57 ms on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
// ~165 TFLOP/s, held by the ldmatrix traffic (Q and dO are read twice,
// plain and transposed), the per-score exp and select work, and 8 warps an
// SM to overlap them.

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

constexpr int BK = 64;         // keys per block
constexpr int BQ = 32;         // query rows per inner tile
constexpr int THREADS = 256;   // 16 x 16 threads
constexpr int DP = D + 1;      // padded shared row stride (floats)
constexpr int PP = BK + 1;     // padded p / ds row stride
constexpr size_t SMEM_BYTES =
    sizeof(float) * (2 * BK * DP + 2 * BQ * DP + 2 * BQ * PP + 3 * BQ);

__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ mask,
                  const float* __restrict__ dout, const float* __restrict__ m_in,
                  const float* __restrict__ l_in,
                  const float* __restrict__ di_in, float* __restrict__ dk,
                  float* __restrict__ dv, int t_len, int s_len, int n_heads,
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
      kval = k[off];
      vval = v[off];
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
          qv = q[off] * scale;
          gv = dout[off];
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
      dk[off + tx + 16 * c] = acc_k[i][c];
      dv[off + tx + 16 * c] = acc_v[i][c];
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, const int* mask,
               const void* dout, const float* m, const float* l,
               const float* di, void* dk, void* dv, int batch, int t_len,
               int s_len, int n_heads, int n_kv_heads, int causal,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_len + BK - 1) / BK, n_kv_heads, batch);
  flash_bwd_dkv_f32<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<const float*>(dout), m,
      l, di, static_cast<float*>(dk), static_cast<float*>(dv), t_len, s_len,
      n_heads, n_kv_heads, causal, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 body (dtype 1): tensor cores, cp.async, swizzled shared tiles
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace ospo_mma;

constexpr int BK = 64;                 // keys per block, 16 per warp
constexpr int BQ = 64;                 // query rows per inner tile
constexpr int THREADS = 128;           // 4 warps
constexpr int TILE = 64 * D;           // bf16 elements of one [64][128] tile
// K, V, then two stages of Q, dO; then two stages of m, 1/l, di rows
constexpr size_t SMEM_BYTES = sizeof(bf16) * 6 * TILE + sizeof(float) * 2 * 3 * BQ;

__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const int* __restrict__ mask,
           const bf16* __restrict__ dout, const float* __restrict__ m_in,
           const float* __restrict__ l_in, const float* __restrict__ di_in,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int batch, int t_len,
           int s_len, int n_heads, int n_kv_heads, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t ks = smem_u32(smem_tc);
  const uint32_t vs = ks + TILE * 2;
  const uint32_t qs = vs + TILE * 2;           // stage st at qs + st * TILE * 2
  const uint32_t dos = qs + 2 * TILE * 2;
  float* stats = reinterpret_cast<float*>(smem_tc + 6 * TILE * 2);  // [2][3][BQ]

  // the low key tiles (longest causal loops) first
  const int bh = batch * n_kv_heads;
  const int kt = blockIdx.x / bh, rest = blockIdx.x % bh;
  const int kvh = rest % n_kv_heads, b = rest / n_kv_heads;
  const int group = n_heads / n_kv_heads;
  const int k0 = kt * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;

  const size_t q_ld = (size_t)n_heads * D, k_ld = (size_t)n_kv_heads * D;
  const size_t k_off = ((size_t)b * s_len + k0) * k_ld + (size_t)kvh * D;
  load_tile64<THREADS>(ks, k + k_off, k_ld, s_len - k0, tid);
  load_tile64<THREADS>(vs, v + k_off, k_ld, s_len - k0, tid);

  const int q_tiles = (t_len + BQ - 1) / BQ;
  const int qt_start = causal ? min(k0 / BQ, q_tiles) : 0;
  const int n_qt = q_tiles - qt_start;
  const int n_items = group * n_qt;            // (query head, Q tile) pairs
  auto load_item = [&](int it, int st) {
    const int h = kvh * group + it / n_qt;
    const int q0 = (qt_start + it % n_qt) * BQ;
    const size_t off = ((size_t)b * t_len + q0) * q_ld + (size_t)h * D;
    load_tile64<THREADS>(qs + st * TILE * 2, q + off, q_ld, t_len - q0, tid);
    load_tile64<THREADS>(dos + st * TILE * 2, dout + off, q_ld, t_len - q0, tid);
    if (tid < BQ) {
      const size_t r = ((size_t)b * n_heads + h) * t_len + q0 + tid;
      const bool ok = q0 + tid < t_len;
      float* dst = stats + st * 3 * BQ + tid;
      cp_async4(smem_u32(dst), ok ? m_in + r : m_in, ok ? 4 : 0);
      cp_async4(smem_u32(dst + BQ), ok ? l_in + r : l_in, ok ? 4 : 0);
      cp_async4(smem_u32(dst + 2 * BQ), ok ? di_in + r : di_in, ok ? 4 : 0);
    }
  };
  if (n_items > 0) load_item(0, 0);
  cp_async_commit();

  // this thread's two keys: rows g and g + 8 of the warp's 16
  int key_r[2], kmask[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    key_r[j] = k0 + warp * 16 + g + 8 * j;
    kmask[j] = key_r[j] < s_len ? mask[(size_t)b * s_len + key_r[j]] : 0;
  }

  float acc_k[16][4], acc_v[16][4];
#pragma unroll
  for (int nb = 0; nb < 16; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nb][e] = acc_v[nb][e] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    const int st = it & 1;
    if (it + 1 < n_items) {
      load_item(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* m_s = stats + st * 3 * BQ;
    float* il_s = m_s + BQ;
    float* di_s = il_s + BQ;
    if (tid < BQ) il_s[tid] = 1.f / fmaxf(il_s[tid], 1e-30f);  // l -> 1/l
    __syncthreads();
    const int q0 = (qt_start + it % n_qt) * BQ;
    const uint32_t qst = qs + st * TILE * 2, dost = dos + st * TILE * 2;

#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * 32;                // the 32 query rows of this half
      // S^T = K . Q^T and dP^T = V . dO^T, 16 keys x 32 rows a warp
      float sc[4][4], dp[4][4];
      first_products(sc, dp, ks, vs, warp * 16, qst, dost, c0, lane);
      p_and_ds(sc, dp, scale, [&](int nb, int e) {
        const int c = c0 + nb * 8 + tig * 2 + (e & 1), t = q0 + c, j = e >> 1;
        return ScoreRow{key_r[j] < s_len && t < t_len && !(causal && key_r[j] > t),
                        kmask[j] != 0, m_s[c], il_s[c], di_s[c]};
      });
      // dV += p^T . dO and dK += ds^T . Q
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ap[4], as[4];
        a_frag(sc, kk, ap);
        a_frag(dp, kk, as);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bo[4], bq[4];
          ldsm_x4_t(bt_addr(dost, c0 + kk * 16, np * 16, lane), bo);
          ldsm_x4_t(bt_addr(qst, c0 + kk * 16, np * 16, lane), bq);
          mma(acc_v[2 * np], ap, bo[0], bo[1]);
          mma(acc_v[2 * np + 1], ap, bo[2], bo[3]);
          mma(acc_k[2 * np], as, bq[0], bq[1]);
          mma(acc_k[2 * np + 1], as, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (key_r[j] >= s_len) continue;
    const size_t off = ((size_t)b * s_len + key_r[j]) * k_ld + (size_t)kvh * D;
#pragma unroll
    for (int nb = 0; nb < 16; ++nb) {
      *reinterpret_cast<uint32_t*>(dk + off + nb * 8 + tig * 2) =
          pack_bf16(acc_k[nb][2 * j], acc_k[nb][2 * j + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + nb * 8 + tig * 2) =
          pack_bf16(acc_v[nb][2 * j], acc_v[nb][2 * j + 1]);
    }
  }
}

int launch(const void* q, const void* k, const void* v, const int* mask,
           const void* dout, const float* m, const float* l, const float* di,
           void* dk, void* dv, int batch, int t_len, int s_len, int n_heads,
           int n_kv_heads, int causal, cudaStream_t stream) {
  // 16-byte copies and 4-byte stores need aligned rows
  for (const void* p : {q, k, v, dout, (const void*)dk, (const void*)dv})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (s_len + BK - 1) / BK * n_kv_heads * batch;
  flash_bwd_dkv_bf16<<<blocks, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<const bf16*>(dout), m, l,
      di, static_cast<bf16*>(dk), static_cast<bf16*>(dv), batch, t_len, s_len,
      n_heads, n_kv_heads, causal, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q, dout [B, T, H, D]; k, v, dk, dv [B, S, KVH, D]; mask [B, S] int32;
// m, l, di [B, H, T] fp32.  dtype: 0 = float32 (CUDA-core body), 1 =
// bfloat16 (tensor-core body).  Returns a cudaError_t (0 = success).
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
    return launch_f32(q, k, v, mask, dout, m, l, di, dk, dv, batch, t_len,
                      s_len, n_heads, n_kv_heads, causal, st);
  if (dtype == 1)
    return tc::launch(q, k, v, mask, dout, m, l, di, dk, dv, batch, t_len,
                      s_len, n_heads, n_kv_heads, causal, st);
  return (int)cudaErrorInvalidValue;
}
