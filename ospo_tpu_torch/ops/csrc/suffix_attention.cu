// A cached T > 1 attention step over [batch-shared prefix ++ own cache rows]
// for Hopper (sm_90a): step 4b's question suffixes.
//
// Replaces no TPU kernel: the JAX package reads a cached multi-token step
// with its plain XLA attention (ospo_tpu/ops/attention.py:84-186), and the
// port did the same with the plain _layout_attention over the shbd window
// (ops/attention.py).  Same function as that plain form on this input:
//  - q [B, T, H, D] bf16 at absolute rows [l0, l0 + T), one l0 for every row;
//  - keys and values: the batch-shared prefix [C, H, D] bf16 with its mask
//    (no causal test), then the layer's cache rows [0, l0 + T) of
//    [S_max, H, B, D], int8 with fp32 scales [S_max, H, B] or bf16, with the
//    [B, >= l0 + T] key mask and the causal rule key j <= l0 + t;
//  - scores (q . k) * D^-0.5 * k_scale in fp32, -1e30 for every disallowed
//    key, one fp32 softmax over prefix ++ own, the v scale folded into the
//    probabilities, fp32 sums, a bf16 output.  A query row with no allowed
//    key averages V over every key of prefix ++ window, as the plain form.
//
// What bounds it on the card: at step 4b's 1B slice (B = 8 images, H = 16,
// T = 240 question rows after 640 image rows, a 48-row prefix) one launch
// must read ~46 MB (the int8 window once with its scales, q and the output:
// 13.7 us at 3.35 TB/s) and do 12.6 GFLOP on the tensor cores (12.8 us), so
// bytes and operations are about even; the plain form took 1.46 ms there in
// fp32 passes over [B, H, T, C + S] score tensors.
//
// The design:
//  - one block per (image b, head h, 128 query rows); 8 warps of 16 rows, a
//    warp whose rows all lie past T joins the copies and skips the products
//    (T = 16 costs one warp's tensor work); the blocks of one (b, h) are
//    adjacent, the longest causal rows first, the images of a head next to
//    each other, so they share the window and the scales' sectors in L2;
//  - key tiles of 64 stream through a four-stage cp.async ring, the prefix
//    tiles first, then the own tiles up to the causal limit of the block's
//    last row: a tile past it is all -1e30 for every row of the block, so its
//    probabilities are exactly 0 where a row has an allowed key; where one
//    has none (the block votes after its last causal tile), the rest of the
//    window follows, so that row averages over every key as the plain form;
//  - an int8 tile (a key row is 128 contiguous bytes at stride H * B * D) is
//    converted once a block in shared memory: k to bf16 (exact for
//    |k| <= 127, through an fp32 mantissa), v to fp16 (exact, 0x6400 | byte);
//    its 64 scales and mask words ride in the same ring;
//  - S = Q . K^T on the tensor cores (mma.sync m16n8k16 bf16, fp32
//    accumulators, mma_bf16.cuh), the Q fragments held in registers; the
//    online softmax in fp32 (a running max and sum), the causal and window
//    tests only on the tiles that reach them;
//  - P . V: for an int8 tile p * v_scale / f rounded to fp16 against the fp16
//    v, where f is a power of two at or above the largest v scale seen (the
//    fp16 rounding is then relative to the tile's largest term, and the
//    accumulator's rescale by f is exact); for a bf16 tile (the prefix, a
//    bf16 payload) p split into two bf16 terms (hi + lo, ~16 bits) against the
//    bf16 v.  The fp16 rounding of P is the one rounding the plain fp32 form
//    does not have; nothing else is lowered.
// Shared memory: the Q tile (then the converted K and V tiles), four stages
// of 32 KB and their side words: 166,912 bytes, one block an SM.
// ptxas (CUDA 12.8): 243 registers (int8) and 255 (bf16) a thread, no
// spills.  On an NVIDIA H100 80GB HBM3 at 700 W it took 0.150 ms at the 1B
// slice above (84 TFLOP/s, 9% of the bound), the window cold in L2.  Where
// the time goes, from variants with parts cut out: the loads and barriers
// 0.026 ms, the masks and online softmax 0.051, the two products 0.055, the
// int8 conversion 0.018; the steps run in lock-step between the block's
// barriers with two warps a scheduler, so the softmax's dependent chains
// (shuffles, exponentials, sums) are not hidden behind the tensor cores.
// An earlier shape (64 rows, 4 warps, two blocks an SM, two stages) took
// 0.158 ms.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace ospo_mma;

constexpr int D = 128;                        // head dim (the wrapper rejects others)
constexpr int BQ = 128;                       // query rows a block, 16 a warp
constexpr int BK = 64;                        // keys a tile
constexpr int THREADS = 256;                  // 8 warps
constexpr int STAGES = 4;                     // the key ring's tiles
constexpr int TILE_BYTES = BK * D * 2;        // a [64][128] 16-bit tile
constexpr int STAGE_BYTES = 2 * TILE_BYTES;   // K then V: bf16 tiles, or int8 rows
constexpr int RAW_V = BK * D;                 // the int8 V rows' offset in a stage
constexpr int SIDE = 3 * BK;                  // a stage's words: k scales, v scales, mask
constexpr size_t SMEM_BYTES = 2 * TILE_BYTES + STAGES * (STAGE_BYTES + SIDE * 4);

__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo in bf16 pairs: part 0 is hi, x rounded; part 1 is lo, what hi
// left out, rounded
__device__ __forceinline__ uint32_t bf16_part(float x0, float x1, int part) {
  const uint32_t hi = pack_bf16(x0, x1);
  if (part == 0) return hi;
  return pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xFFFF0000u));
}

// four int8 (a word) -> four bf16, exact: each byte, biased by 128, is the
// low mantissa byte of 2^23 + u; subtracting 2^23 + 128 leaves the integer,
// whose fp32 bits end in 16 zeros, so its upper half is the bf16 value
__device__ __forceinline__ uint2 s8x4_to_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + i)) - 8388736.f;
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// four int8 -> four fp16, exact: 0x6400 | (byte ^ 0x80) is 1024 + 128 + x
__device__ __forceinline__ uint2 s8x4_to_f16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t lo = __byte_perm(u, 0x64646464u, 0x5140);
  uint32_t hi = __byte_perm(u, 0x64646464u, 0x5342);
  const __half2 bias = __halves2half2(__ushort_as_half(0x6480), __ushort_as_half(0x6480));
  __half2 a = __hsub2(*reinterpret_cast<__half2*>(&lo), bias);
  __half2 b = __hsub2(*reinterpret_cast<__half2*>(&hi), bias);
  return make_uint2(*reinterpret_cast<uint32_t*>(&a), *reinterpret_cast<uint32_t*>(&b));
}

// a stage's int8 [64][128] rows (linear) -> a swizzled [64][128] bf16 or fp16
// tile, 16 bytes a thread and step
template <bool TO_F16>
__device__ __forceinline__ void convert_tile(unsigned char* dst,
                                             const unsigned char* raw, int tid) {
#pragma unroll
  for (int it = 0; it < BK * 8 / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i >> 3, c = (i & 7) * 16;
    const uint4 w = *reinterpret_cast<const uint4*>(raw + r * D + c);
    const uint2 e0 = TO_F16 ? s8x4_to_f16(w.x) : s8x4_to_bf16(w.x);
    const uint2 e1 = TO_F16 ? s8x4_to_f16(w.y) : s8x4_to_bf16(w.y);
    const uint2 e2 = TO_F16 ? s8x4_to_f16(w.z) : s8x4_to_bf16(w.z);
    const uint2 e3 = TO_F16 ? s8x4_to_f16(w.w) : s8x4_to_bf16(w.w);
    *reinterpret_cast<uint4*>(dst + swz(r, c)) = make_uint4(e0.x, e0.y, e1.x, e1.y);
    *reinterpret_cast<uint4*>(dst + swz(r, c + 8)) = make_uint4(e2.x, e2.y, e3.x, e3.y);
  }
}

template <bool INT8>
__global__ void __launch_bounds__(THREADS, 1)
suffix_attention(const bf16* __restrict__ q, const void* __restrict__ kc,
                 const void* __restrict__ vc, const float* __restrict__ ksc,
                 const float* __restrict__ vsc, const int* __restrict__ mask,
                 const bf16* __restrict__ pk, const bf16* __restrict__ pv,
                 const int* __restrict__ pmask, bf16* __restrict__ out, int batch,
                 int t_len, int n_heads, int l0, int c_len, int mask_ld,
                 int pmask_ld, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* cvt_k = smem;                    // with cvt_v, the Q tile before the loop
  unsigned char* cvt_v = smem + TILE_BYTES;
  unsigned char* ring = smem + 2 * TILE_BYTES;    // stage st at ring + st * STAGE_BYTES
  float* side = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);  // stage st at + st * SIDE
  const uint32_t s_cvt_k = smem_u32(cvt_k), s_ring = smem_u32(ring);

  // the blocks of one (b, h) adjacent, its longest causal rows first; the
  // images of one head next to each other (their scales share sectors)
  const int q_tiles = (t_len + BQ - 1) / BQ;
  const int group = blockIdx.x / q_tiles;
  const int qt = q_tiles - 1 - blockIdx.x % q_tiles;
  const int b = group % batch, h = group / batch;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const bool active = q0 + warp * 16 < t_len;

  const int s_win = l0 + t_len;
  const int n_pre = (c_len + BK - 1) / BK;
  const int n_all = n_pre + (s_win + BK - 1) / BK;
  // own tiles up to the causal limit of the block's last row
  int n_tiles = n_pre + (l0 + min(q0 + BQ, t_len) + BK - 1) / BK;

  const size_t q_ld = (size_t)n_heads * D;          // q, out, prefix rows
  const size_t kv_ld = (size_t)n_heads * batch * D;  // between cache rows of (h, b)
  const size_t kv_off = ((size_t)h * batch + b) * D;
  const size_t sc_ld = (size_t)n_heads * batch;
  const size_t sc_off = (size_t)h * batch + b;
  const int* mask_row = mask + (size_t)b * mask_ld;
  const int* pmask_row = pmask + (size_t)b * pmask_ld;

  // the Q tile: rows [q0, q0 + 64) over cvt_k, the next 64 over cvt_v
  const bf16* q_src = q + ((size_t)b * t_len + q0) * q_ld + (size_t)h * D;
  load_tile64<THREADS>(s_cvt_k, q_src, q_ld, t_len - q0, tid);
  load_tile64<THREADS>(s_cvt_k + TILE_BYTES, t_len - q0 > 64 ? q_src + 64 * q_ld : q_src,
                       q_ld, t_len - q0 - 64, tid);
  cp_async_commit();

  auto load = [&](int kt) {
    const int st = kt % STAGES;
    const uint32_t dst = s_ring + st * STAGE_BYTES;
    const uint32_t sd = smem_u32(side + st * SIDE);
    if (kt < n_pre) {
      const int c0 = kt * BK;
      const size_t off = (size_t)c0 * q_ld + (size_t)h * D;
      load_tile64<THREADS>(dst, pk + off, q_ld, c_len - c0, tid);
      load_tile64<THREADS>(dst + TILE_BYTES, pv + off, q_ld, c_len - c0, tid);
      if (tid < BK) {
        const bool ok = c0 + tid < c_len;
        cp_async4(sd + (2 * BK + tid) * 4, ok ? pmask_row + c0 + tid : pmask_row, ok ? 4 : 0);
      }
      return;
    }
    const int k0 = (kt - n_pre) * BK;
    if (INT8) {
      const int8_t* kb = static_cast<const int8_t*>(kc) + kv_off;
      const int8_t* vb = static_cast<const int8_t*>(vc) + kv_off;
#pragma unroll
      for (int it = 0; it < BK * 8 / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const int r = i >> 3, c = (i & 7) * 16;
        const bool ok = k0 + r < s_win;
        const size_t src = (size_t)(k0 + r) * kv_ld + c;
        cp_async16(dst + r * D + c, ok ? kb + src : kb, ok ? 16 : 0);
        cp_async16(dst + RAW_V + r * D + c, ok ? vb + src : vb, ok ? 16 : 0);
      }
      const int j = tid & (BK - 1);
      const bool ok = k0 + j < s_win;
      const size_t src = (size_t)(k0 + j) * sc_ld + sc_off;
      if (tid < BK) {
        cp_async4(sd + j * 4, ok ? ksc + src : ksc, ok ? 4 : 0);
      } else if (tid < 2 * BK) {
        cp_async4(sd + (BK + j) * 4, ok ? vsc + src : vsc, ok ? 4 : 0);
      } else if (tid < 3 * BK) {
        cp_async4(sd + (2 * BK + j) * 4, ok ? mask_row + k0 + j : mask_row, ok ? 4 : 0);
      }
    } else {
      const size_t off = (size_t)k0 * kv_ld + kv_off;
      load_tile64<THREADS>(dst, static_cast<const bf16*>(kc) + off, kv_ld, s_win - k0, tid);
      load_tile64<THREADS>(dst + TILE_BYTES, static_cast<const bf16*>(vc) + off, kv_ld,
                           s_win - k0, tid);
      if (tid < BK) {
        const bool ok = k0 + tid < s_win;
        cp_async4(sd + (2 * BK + tid) * 4, ok ? mask_row + k0 + tid : mask_row, ok ? 4 : 0);
      }
    }
  };
  // STAGES - 1 tiles ahead, one commit group a tile (empty past the end)
#pragma unroll
  for (int kt = 0; kt < STAGES - 1; ++kt) {
    if (kt < n_tiles) load(kt);
    cp_async_commit();
  }

  cp_async_wait<STAGES - 1>();
  __syncthreads();
  uint32_t qa[D / 16][4];
  if (active) {
    const uint32_t qs = s_cvt_k + (warp >> 2) * TILE_BYTES;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      ldsm_x4(a_addr(qs, (warp & 3) * 16, kd * 16, lane), qa[kd]);
  }

  // this thread's rows g and g + 8 of the warp's 16; l is its share of the
  // row sum, summed over the quad at the end
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
  // acc holds the output sums in units of f (int8 tiles; 1 before the first)
  float f = 1.f;
  bool f_set = false;

  for (int kt = 0; kt < n_tiles; ++kt) {
    // tile kt has landed and every warp is done with tile kt - 1, whose
    // stage takes tile kt + STAGES - 1
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < n_tiles) load(kt + STAGES - 1);
    cp_async_commit();
    const int st = kt % STAGES;
    const bool pre = kt < n_pre;
    const bool cvt = INT8 && !pre;
    const float* sd = side + st * SIDE;
    const int* mk = reinterpret_cast<const int*>(sd + 2 * BK);
    uint32_t kst = s_ring + st * STAGE_BYTES, vst = kst + TILE_BYTES;
    if (cvt) {
      const unsigned char* raw = ring + st * STAGE_BYTES;
      convert_tile<false>(cvt_k, raw, tid);
      convert_tile<true>(cvt_v, raw + RAW_V, tid);
      __syncthreads();
      kst = s_cvt_k;
      vst = s_cvt_k + TILE_BYTES;
    }
    if (active) {
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

      // scale (and k scale), -1e30 where disallowed, -inf past the segment
      const int key0 = pre ? kt * BK : (kt - n_pre) * BK;
      // an own tile inside the window and below the causal limit of the
      // warp's first row: only the mask decides
      const bool inner = !pre && key0 + BK <= s_win && key0 + BK <= l0 + q0 + warp * 16 + 1;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = hf * 32 + nb * 8 + tig * 2 + (e & 1), key = key0 + c;
            const int j = e >> 1;
            float& x = sc[hf][nb][e];
            if (inner)
              x = mk[c] != 0 ? (INT8 ? (x * scale) * sd[c] : x * scale) : NEG_FILL;
            else if (pre)
              x = key >= c_len ? -INFINITY : (mk[c] != 0 ? x * scale : NEG_FILL);
            else if (key >= s_win)
              x = -INFINITY;
            else if (mk[c] != 0 && key <= l0 + t_r[j])
              x = INT8 ? (x * scale) * sd[c] : x * scale;
            else
              x = NEG_FILL;
            mx[j] = fmaxf(mx[j], x);
          }
      float alpha[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
        const float m_new = fmaxf(m_r[j], mx[j]);
        alpha[j] = ex2((m_r[j] - m_new) * LOG2E);
        m_r[j] = m_new;
        l_r[j] *= alpha[j];
      }
      // p = exp(s - m), the difference first: a row without an allowed key
      // (-1e30 - -1e30) gets exactly 1 for every key
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = e >> 1;
            const float p = ex2((sc[hf][nb][e] - m_r[j]) * LOG2E);
            sc[hf][nb][e] = p;
            l_r[j] += p;
          }

      // an int8 tile: f rises to a power of two at or above its largest v
      // scale (the first such tile sets it), and acc follows exactly
      float ratio = 1.f;
      if (cvt) {
        float vmax = fmaxf(sd[BK + lane], sd[BK + lane + 32]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, off));
        const float bound =
            vmax > 0.f ? __uint_as_float((__float_as_uint(vmax) & 0x7F800000u) + 0x00800000u)
                       : 0.f;
        if (bound > 0.f && (!f_set || bound > f)) {
          ratio = f / bound;
          f = bound;
          f_set = true;
        }
      }
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] *= alpha[e >> 1] * ratio;

      // O += P . V by 16-key steps
      const float inv_f = 1.f / f;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int hf = kk >> 1, n0 = (kk & 1) * 2;
        if (cvt) {
          // p * v_scale / f in fp16 against the fp16 v
          const int c0 = kk * 16 + tig * 2;
          const float2 w0 = *reinterpret_cast<const float2*>(sd + BK + c0);
          const float2 w1 = *reinterpret_cast<const float2*>(sd + BK + c0 + 8);
          const float a0 = w0.x * inv_f, a1 = w0.y * inv_f;
          const float b0 = w1.x * inv_f, b1 = w1.y * inv_f;
          uint32_t a[4];
          a[0] = pack_f16(sc[hf][n0][0] * a0, sc[hf][n0][1] * a1);
          a[1] = pack_f16(sc[hf][n0][2] * a0, sc[hf][n0][3] * a1);
          a[2] = pack_f16(sc[hf][n0 + 1][0] * b0, sc[hf][n0 + 1][1] * b1);
          a[3] = pack_f16(sc[hf][n0 + 1][2] * b0, sc[hf][n0 + 1][3] * b1);
#pragma unroll
          for (int np = 0; np < D / 16; ++np) {
            uint32_t bv[4];
            ldsm_x4_t(bt_addr(vst, kk * 16, np * 16, lane), bv);
            mma_f16(acc[2 * np], a, bv[0], bv[1]);
            mma_f16(acc[2 * np + 1], a, bv[2], bv[3]);
          }
        } else {
          // p (f is 1 here: bf16 tiles precede the int8 ones) as hi + lo,
          // one product each
#pragma unroll
          for (int part = 0; part < 2; ++part) {
            uint32_t a[4];
            a[0] = bf16_part(sc[hf][n0][0], sc[hf][n0][1], part);
            a[1] = bf16_part(sc[hf][n0][2], sc[hf][n0][3], part);
            a[2] = bf16_part(sc[hf][n0 + 1][0], sc[hf][n0 + 1][1], part);
            a[3] = bf16_part(sc[hf][n0 + 1][2], sc[hf][n0 + 1][3], part);
#pragma unroll
            for (int np = 0; np < D / 16; ++np) {
              uint32_t bv[4];
              ldsm_x4_t(bt_addr(vst, kk * 16, np * 16, lane), bv);
              mma(acc[2 * np], a, bv[0], bv[1]);
              mma(acc[2 * np + 1], a, bv[2], bv[3]);
            }
          }
        }
      }
    }

    if (kt + 1 == n_tiles && n_tiles < n_all) {
      // a row with no allowed key so far has none at all: it averages V over
      // the whole window, so the block reads the rest of it (the tiles the
      // ring would hold by now at once, then the ring as before)
      bool none = false;
#pragma unroll
      for (int j = 0; j < 2; ++j) none |= active && t_r[j] < t_len && m_r[j] == NEG_FILL;
      if (__syncthreads_or(none)) {
        n_tiles = n_all;
        for (int k2 = kt + 1; k2 < min(kt + STAGES, n_tiles); ++k2) load(k2);
        cp_async_commit();
        cp_async_wait<0>();
      }
    }
  }
  cp_async_wait<0>();

  if (!active) return;
  float l_row[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l_row[j] = l_r[j] + __shfl_xor_sync(0xffffffffu, l_r[j], 1);
    l_row[j] += __shfl_xor_sync(0xffffffffu, l_row[j], 2);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (t_r[j] >= t_len) continue;
    const float o = f / fmaxf(l_row[j], 1e-30f);
    bf16* row = out + ((size_t)b * t_len + t_r[j]) * q_ld + (size_t)h * D;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<uint32_t*>(row + nb * 8 + tig * 2) =
          pack_bf16(acc[nb][2 * j] * o, acc[nb][2 * j + 1] * o);
  }
}

template <bool INT8>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* mask, const void* pk, const void* pv,
           const int* pmask, void* out, int batch, int t_len, int n_heads, int l0,
           int c_len, int mask_ld, int pmask_ld, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      suffix_attention<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (t_len + BQ - 1) / BQ * n_heads * batch;
  suffix_attention<INT8><<<blocks, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(q), k, v, ks, vs, mask, static_cast<const bf16*>(pk),
      static_cast<const bf16*>(pv), pmask, static_cast<bf16*>(out), batch, t_len,
      n_heads, l0, c_len, mask_ld, pmask_ld, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

// q, out [B, T, H, D] bf16; k, v one layer of the shbd cache [S_max, H, B, D]
// (kv_dtype 0 = bf16, 1 = int8 with fp32 scales ks, vs [S_max, H, B]); mask
// [B, mask_ld] int32 covering rows [0, l0 + T); the prefix pk, pv [C, H, D]
// bf16 with pmask rows pmask_ld apart (0: one row for every image), unread
// when C = 0.  Returns a cudaError_t (0 = success).
extern "C" int ospo_suffix_attention(const void* q, const void* k, const void* v,
                                     const float* ks, const float* vs,
                                     const int* mask, const void* pk, const void* pv,
                                     const int* pmask, void* out, int batch, int t_len,
                                     int n_heads, int l0, int c_len, int mask_ld,
                                     int pmask_ld, int head_dim, int kv_dtype,
                                     void* stream) {
  if (head_dim != D || batch <= 0 || t_len <= 0 || n_heads <= 0 || l0 < 0 || c_len < 0)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies and 4-byte stores need aligned rows
  for (const void* p : {q, k, v, (const void*)out})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  if (c_len > 0)
    for (const void* p : {pk, pv})
      if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 0)
    return launch<false>(q, k, v, ks, vs, mask, pk, pv, pmask, out, batch, t_len,
                         n_heads, l0, c_len, mask_ld, pmask_ld, st);
  if (kv_dtype == 1)
    return launch<true>(q, k, v, ks, vs, mask, pk, pv, pmask, out, batch, t_len,
                        n_heads, l0, c_len, mask_ld, pmask_ld, st);
  return (int)cudaErrorInvalidValue;
}
