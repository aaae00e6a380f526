// Flash-attention forward for Hopper (sm_90a): a bf16 body on the tensor
// cores and an fp32 body on the CUDA cores.
//
// Replaces: ospo_tpu/ops/flash_attention.py::_fwd_kernel (:45-93, launched by
// _fwd_call :96-129).  Same function: per (batch, head, query tile) an fp32
// online softmax over key tiles, scale D^-0.5, key-validity mask [B, S]
// filled with -1e30, row-causal mask j <= i, normaliser clamped at 1e-30;
// emits O, the row normaliser l and the row max m.
//
// One deliberate difference from the TPU kernel, shared with the plain
// version in flash_attention.py: keys outside the causal window or past S
// are excluded outright (probability 0) instead of filled with -1e30.  Rows
// with at least one valid key are unaffected; a query row whose every
// allowed key is masked (a left-pad row) gets the mean of V over its causal
// window, independent of the tile size.
//
// What bounds it on the card: at the prefill shape (B=48, H=32, D=128,
// T=S=384, causal, left-padded prompts) one call needs ~22 GFLOP against
// ~0.61 GB of q/k/v/o traffic, 36 FLOP per byte, under the ~295 at which
// the bf16 tensor cores would be the limit: its floor is bytes / 3.35 TB/s
// (~0.18 ms).  At the training shape (32 rows, H=32, T=S=704) it needs
// 130 GFLOP against 0.74 GB, again bounded by bytes (~0.22 ms).
//
// What held the first version back (kept as the fp32 body, dtype 0): both
// products ran as scalar fmaf loops on the fp32 CUDA cores over padded fp32
// shared tiles, and each 32-key tile was loaded synchronously: 6.2 ms at
// the training shape, ~21 TFLOP/s, 17.7x SDPA's forward.
//
// The bf16 body (dtype 1) does about it:
//  - both products on the tensor cores, mma.sync m16n8k16 bf16 with fp32
//    accumulators (mma_bf16.cuh): S = Q . K^T takes q and k as they are
//    (their products are exact in fp32) and the scale is applied after the
//    product, (q . k) * D^-0.5, exactly as the backward kernels recompute
//    the scores, so the m and l emitted here agree with their p;
//  - the online softmax stays in fp32: p = exp2((s - m) * log2 e) with the
//    difference taken first (a pad row's -1e30 - (-1e30) is exactly 0), l
//    sums the fp32 p; p is rounded to bf16 only as the A operand of P . V,
//    straight from the S accumulator registers (FlashAttention-2's scheme;
//    the TPU kernel and the plain version keep p in fp32), and the O
//    accumulator stays in fp32 registers;
//  - a block owns 64 query rows (4 warps x 16 rows, 128 threads); the Q
//    tile is loaded once and its A fragments stay in registers for the
//    whole key loop; K and V stream in 64-key tiles through a cp.async
//    double buffer (Q 16 KB + 2 x 32 KB = 80 KB, two blocks an SM), the
//    ragged edge zero-filled by cp.async's src-size operand;
//  - shared tiles are [64][128] bf16 with the 16-byte-chunk XOR swizzle of
//    mma_bf16.cuh, read by ldmatrix (.trans for V) without bank conflicts;
//  - key tiles above the diagonal are skipped, and the blocks of the
//    longest causal rows (the high query tiles) start first.
// ptxas (CUDA 12.8): 235 registers a thread, no spills; 82,432 bytes of
// dynamic shared memory a block.  On an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md) it took 0.474 ms at the prefill shape and 0.884 ms at the
// training shape (~147 TFLOP/s, 2.5x SDPA's forward there): held by 8
// warps an SM, the dependent softmax between the two products and the
// mask/causal select on every score.  A 128-row variant (32 rows a warp)
// spilled at 255 registers and was no faster.

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
constexpr int PP = BK + 1;     // padded probability row stride
constexpr size_t SMEM_BYTES =
    sizeof(float) * (BQ * DP + BK * DP + BK * D + BQ * PP);

__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ mask,
              float* __restrict__ o, float* __restrict__ l_out,
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
    if (t < t_len) val = q[(((size_t)b * t_len + t) * n_heads + h) * D + d] * scale;
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
        kval = k[off];
        vval = v[off];
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
    float* orow = o + (((size_t)b * t_len + t) * n_heads + h) * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) orow[tx + 16 * c] = acc[i][c] / l_safe;
    if (tx == 0) {
      const size_t r = ((size_t)b * n_heads + h) * t_len + t;
      l_out[r] = l_i[i];
      m_out[r] = m_i[i];
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, const int* mask,
               void* o, float* l, float* m, int batch, int t_len, int s_len,
               int n_heads, int n_kv_heads, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + BQ - 1) / BQ, n_heads, batch);
  flash_fwd_f32<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(o), l, m, t_len,
      s_len, n_heads, n_kv_heads, causal, (float)(1.0 / sqrt((double)D)));
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
// Q, then two stages of K, V; then two stages of the 64 mask words
constexpr size_t SMEM_BYTES = sizeof(bf16) * 5 * TILE + sizeof(int) * 2 * BK;

__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ mask,
               bf16* __restrict__ o, float* __restrict__ l_out,
               float* __restrict__ m_out, int batch, int t_len, int s_len,
               int n_heads, int n_kv_heads, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t qs = smem_u32(smem_tc);
  const uint32_t ks = qs + TILE * 2;           // stage st at ks + st * TILE * 2
  const uint32_t vs = ks + 2 * TILE * 2;
  int* mks = reinterpret_cast<int*>(smem_tc + 5 * TILE * 2);  // [2][BK]

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
  cp_async_commit();

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

  // the warp's 16 Q rows as A fragments, kept in registers for the key loop
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) ldsm_x4(a_addr(qs, warp * 16, kd * 16, lane), qa[kd]);

  // this thread's two query rows: g and g + 8 of the warp's 16; l is this
  // thread's share of the row sum (its 2 of every 8 keys), summed over the
  // quad at the end
  int t_r[2];
  float m_r[2], l_r[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    t_r[j] = q0 + warp * 16 + g + 8 * j;
    m_r[j] = NEG_FILL;
    l_r[j] = 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
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

    // S = Q . K^T, 16 rows x 64 keys a warp: two 16 x 32 halves
    float sc[2][4][4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[hf][nb][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bk[4];
        ldsm_x4(b_addr(kst, np * 16, kd * 16, lane), bk);
        mma(sc[np >> 1][(np & 1) * 2], qa[kd], bk[0], bk[1]);
        mma(sc[np >> 1][(np & 1) * 2 + 1], qa[kd], bk[2], bk[3]);
      }

    // scale, mask, row max over the quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = hf * 32 + nb * 8 + tig * 2 + (e & 1), s = k0 + c;
          const int j = e >> 1;
          float& x = sc[hf][nb][e];
          if (s >= s_len || (causal && s > t_r[j])) x = -INFINITY;
          else x = mst[c] != 0 ? x * scale : NEG_FILL;
          mx[j] = fmaxf(mx[j], x);
        }
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m_r[j], mx[j]);
      alpha[j] = exp2f((m_r[j] - m_new) * LOG2E);
      m_r[j] = m_new;
      l_r[j] *= alpha[j];
    }
    // p = exp(s - m) in fp32, into sc; l takes the fp32 p
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e >> 1;
          const float p = exp2f((sc[hf][nb][e] - m_r[j]) * LOG2E);
          sc[hf][nb][e] = p;
          l_r[j] += p;
        }
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] *= alpha[e >> 1];

    // O += P . V, p rounded to bf16 as the A operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a_frag(sc[kk >> 1], kk & 1, a);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bt_addr(vst, kk * 16, np * 16, lane), bv);
        mma(acc[2 * np], a, bv[0], bv[1]);
        mma(acc[2 * np + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_async_wait<0>();

  float l_row[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l_row[j] = l_r[j] + __shfl_xor_sync(0xffffffffu, l_r[j], 1);
    l_row[j] += __shfl_xor_sync(0xffffffffu, l_row[j], 2);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (t_r[j] >= t_len) continue;
    const float l_safe = fmaxf(l_row[j], 1e-30f);
    bf16* row = o + ((size_t)b * t_len + t_r[j]) * q_ld + (size_t)h * D;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<uint32_t*>(row + nb * 8 + tig * 2) =
          pack_bf16(acc[nb][2 * j] / l_safe, acc[nb][2 * j + 1] / l_safe);
    if (tig == 0) {
      const size_t r = ((size_t)b * n_heads + h) * t_len + t_r[j];
      l_out[r] = l_row[j];
      m_out[r] = m_r[j];
    }
  }
}

int launch(const void* q, const void* k, const void* v, const int* mask,
           void* o, float* l, float* m, int batch, int t_len, int s_len,
           int n_heads, int n_kv_heads, int causal, cudaStream_t stream) {
  // 16-byte copies and 4-byte stores need aligned rows
  for (const void* p : {q, k, v, (const void*)o})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (t_len + BQ - 1) / BQ * n_heads * batch;
  flash_fwd_bf16<<<blocks, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<bf16*>(o), l, m, batch,
      t_len, s_len, n_heads, n_kv_heads, causal, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q, o [B, T, H, D]; k, v [B, S, KVH, D]; mask [B, S] int32; l, m [B, H, T]
// fp32.  dtype: 0 = float32 (CUDA-core body), 1 = bfloat16 (tensor-core
// body).  Returns a cudaError_t (0 = success).
extern "C" int ospo_flash_fwd(const void* q, const void* k, const void* v,
                              const int* mask, void* o, float* l, float* m,
                              int batch, int t_len, int s_len, int n_heads,
                              int n_kv_heads, int head_dim, int causal,
                              int dtype, void* stream) {
  if (head_dim != D || n_kv_heads <= 0 || n_heads % n_kv_heads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k, v, mask, o, l, m, batch, t_len, s_len, n_heads,
                      n_kv_heads, causal, st);
  if (dtype == 1)
    return tc::launch(q, k, v, mask, o, l, m, batch, t_len, s_len, n_heads,
                      n_kv_heads, causal, st);
  return (int)cudaErrorInvalidValue;
}
