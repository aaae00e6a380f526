// Decode attention for Hopper (sm_90a): one new query per (head, row) over
// layer `layer` of the stacked batch-minor KV cache [L, S, H, B, dh].
//
// Replaces: ospo_tpu/ops/decode_attention.py::_kernel (:58-166, wrapper
// decode_attention :169-281).  Same function: fp32 online softmax over the
// populated positions [0, cur_len) only, scale dh^-0.5 applied to q, key mask
// [B, S] filled with -1e30; for an int8 cache the k scale multiplies the
// score and the v scale multiplies the probability after the normaliser l
// has taken it; a row with l == 0 (cur_len == 0) outputs 0.
//
// What bounds it on the card: bytes.  At the 7B serving point (H=32, B=48,
// dh=128, int8, ~670 populated positions) one call reads ~0.27 GB of K/V and
// does ~4 operations per byte, far below the ~600 the tensor cores would
// need, so the floor is bytes / 3.35 TB/s (~0.08 ms).
//
// What held the first version back: it moved few bytes per instruction.
// One warp served one (head, row) pair, so every position cost each lane
// two 4-byte payload loads, two scalar scale loads, a mask load and a
// five-step shuffle reduction: 0.288 ms at the serving point (int8, 0.94
// TB/s), and a bf16 cache, twice the bytes, took nearly the same time.
//
// This design reads the layout as it lies: for a fixed (layer, position,
// head) the B rows' vectors are contiguous, and so are their scales.
//  - A warp serves one head and a group of 4 consecutive rows b; 8 lanes
//    cover one row's 128-element vector with 16-byte loads (int8: one load
//    of 16 elements; bf16: two loads of 8, elements 8s..8s+7 and
//    64+8s..64+8s+7 of lane s, so each load instruction reads four full
//    128-byte lines), so one warp instruction moves 512 contiguous bytes.
//    A ragged last group reads its last row again and writes nothing of it.
//  - The block's [rows, positions] mask and, for an int8 cache, its k and v
//    scales are staged once in shared memory (the 4 rows' scales of one
//    position are 16 contiguous bytes), so the position loop issues only
//    the payload loads and keeps no scales in registers.
//  - The dot product reduces over 8 lanes: 3 shuffle steps.
//  - int8 becomes fp32 without the conversion unit: byte_perm builds
//    2^23 + (x + 128) as a float and one subtraction leaves x, exactly.
//  - Loads run one batch ahead (register double buffering): the next U = 2
//    positions' K and V are in flight while the current 2 are computed;
//    the first batch is issued before the staging barrier.  Batches of 3
//    or 4 int8 positions were slower (fewer warps an SM) or spilled.
//  - Split-K with a deterministic merge: a block of 8 warps takes a chunk
//    of up to 256 positions, each warp a contiguous slice of it; the block
//    merges its warps' (m, l, acc) in shared memory and writes one partial
//    per (head, row); a second pass merges the chunks in order.  No
//    atomics.
//  - cur_len may live in device memory, for a step captured once in a CUDA
//    graph and replayed at every length: the grid is then sized for s_max,
//    each block derives the split of the length it reads (the same split a
//    launch at that host length takes, so the result is the same bit for
//    bit), and the blocks past it write an empty partial and exit.
// ptxas (CUDA 12.8): 110 (int8) and 127 (bf16) registers a thread, no
// spills, two 256-thread blocks an SM.  On an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md), at the serving point above with cur_len 672: int8 0.126
// ms (2.18 TB/s, 65% of its bound), bf16 0.188 ms (2.81 TB/s).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int DH = 128;          // head dim
constexpr int ROWS = 4;          // rows b per warp, 8 lanes each
constexpr int WARPS = 8;         // warps per block of the first pass
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 256;       // most positions a block takes
constexpr int MASK_LD = CHUNK + 1;  // padded row of the staged mask
constexpr int COMBINE_WARPS = 4; // (head, row) pairs per block of the merge
constexpr int U = 2;             // positions per batch of loads
constexpr float NEG_FILL = -1e30f;

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 4 int8 in one word → 4 floats, exactly: 0x4B0000uu is 2^23 + uu
__device__ __forceinline__ void unpack_i8(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;  // x + 128 as unsigned bytes
  f[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// 2 bf16 in one word → 2 floats
__device__ __forceinline__ void unpack_bf16(uint32_t w, float* f) {
  f[0] = __int_as_float(w << 16);
  f[1] = __int_as_float(w & 0xFFFF0000u);
}

// What one lane holds of one position's row vector: 16 elements, and
// which elements of the row they are.
struct Int8Cache {
  using T = int8_t;
  struct Vec { uint4 x; };
  __device__ static int elem(int sub, int i) { return sub * 16 + i; }
  __device__ static void load(Vec& d, const T* row, int sub) {
    d.x = ldg16(row + sub * 16);
  }
  __device__ static void unpack(const Vec& d, float (&f)[16]) {
    unpack_i8(d.x.x, f);
    unpack_i8(d.x.y, f + 4);
    unpack_i8(d.x.z, f + 8);
    unpack_i8(d.x.w, f + 12);
  }
};

struct Bf16Cache {
  using T = __nv_bfloat16;
  struct Vec { uint4 lo, hi; };
  __device__ static int elem(int sub, int i) {
    return (i < 8 ? 0 : 64 - 8) + sub * 8 + i;
  }
  __device__ static void load(Vec& d, const T* row, int sub) {
    d.lo = ldg16(row + sub * 8);
    d.hi = ldg16(row + 64 + sub * 8);
  }
  __device__ static void unpack(const Vec& d, float (&f)[16]) {
    unpack_bf16(d.lo.x, f);
    unpack_bf16(d.lo.y, f + 2);
    unpack_bf16(d.lo.z, f + 4);
    unpack_bf16(d.lo.w, f + 6);
    unpack_bf16(d.hi.x, f + 8);
    unpack_bf16(d.hi.y, f + 10);
    unpack_bf16(d.hi.z, f + 12);
    unpack_bf16(d.hi.w, f + 14);
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// One batch of U positions of one lane: its K and V vectors.
template <typename C>
struct Batch {
  typename C::Vec k[U], v[U];
};

// Pass 1: block (head h, row group, chunk) → one partial (m, l, acc) per
// (head, row) over the chunk's positions.  part_ml: [n_split, H*B, 2];
// part_acc: [n_split, H*B, DH]; row index h * B + b.
template <typename QT, typename C, bool QUANT>
__global__ void __launch_bounds__(THREADS, 2)
decode_partial(const QT* __restrict__ q, const typename C::T* __restrict__ kc,
               const typename C::T* __restrict__ vc,
               const float* __restrict__ ksc, const float* __restrict__ vsc,
               const int* __restrict__ mask,
               const int* __restrict__ cur_len_dev, float* __restrict__ part_ml,
               float* __restrict__ part_acc, int s_max, int n_heads,
               int batch, int layer, int cur_len, int chunk, float scale) {
  __shared__ int mks[ROWS * MASK_LD];            // [row][position]
  __shared__ float kss[QUANT ? ROWS * MASK_LD : 1], vss[QUANT ? ROWS * MASK_LD : 1];
  __shared__ float red_ml[WARPS][ROWS][2];
  __shared__ float red_acc[WARPS][ROWS][DH];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 3, sub = lane & 7;
  const int n_groups = (batch + ROWS - 1) / ROWS;
  const int h = blockIdx.x / n_groups;
  const int b0 = (blockIdx.x % n_groups) * ROWS;
  const int split = blockIdx.y;
  const size_t hb = (size_t)n_heads * batch;
  if (cur_len_dev != nullptr) {
    // cur_len in device memory (a captured step): the grid covers s_max;
    // the split is the one the wrapper's split(cur_len) gives, and the
    // blocks past it write an empty partial that decode_combine skips
    cur_len = min(max(__ldg(cur_len_dev), 0), s_max);
    const int n_split = max(1, (cur_len + CHUNK - 1) / CHUNK);
    chunk = max((cur_len + n_split * WARPS - 1) / (n_split * WARPS) * WARPS, WARPS);
    if (split >= n_split) {
      const int rr = threadIdx.x >> 6;
      if ((threadIdx.x & 63) == 0 && b0 + rr < batch) {
        const size_t out_row = split * hb + (size_t)h * batch + b0 + rr;
        part_ml[out_row * 2] = -INFINITY;
        part_ml[out_row * 2 + 1] = 0.f;
      }
      return;
    }
  }
  const int bl = min(b0 + r, batch - 1);        // a ragged group reads its last row
  const int blk_start = split * chunk;
  const int blk_end = min(cur_len, blk_start + chunk);
  const int per_warp = chunk / WARPS;
  const int start = blk_start + warp * per_warp;
  const int end = min(blk_end, start + per_warp);

  const size_t lbase = (size_t)layer * s_max * hb;
  // stage the mask (threads along positions) and the scales (threads
  // along the 4 rows of a position)
  for (int i = threadIdx.x; i < ROWS * chunk; i += THREADS) {
    const int rr = i / chunk, p = i % chunk, s = blk_start + p, bb = b0 + rr;
    mks[rr * MASK_LD + p] =
        s < blk_end && bb < batch ? mask[(size_t)bb * s_max + s] : 0;
  }
  if (QUANT) {
    for (int i = threadIdx.x; i < ROWS * chunk; i += THREADS) {
      const int rr = i % ROWS, p = i / ROWS, s = blk_start + p, bb = b0 + rr;
      const bool ok = s < blk_end && bb < batch;
      const size_t off = lbase + (size_t)s * hb + (size_t)h * batch + bb;
      kss[rr * MASK_LD + p] = ok ? __ldg(ksc + off) : 0.f;
      vss[rr * MASK_LD + p] = ok ? __ldg(vsc + off) : 0.f;
    }
  }

  float qv[16], acc[16];
  const QT* qrow = q + ((size_t)bl * n_heads + h) * DH;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    qv[i] = to_f(qrow[C::elem(sub, i)]) * scale;
    acc[i] = 0.f;
  }

  const typename C::T* kbase = kc + (lbase + (size_t)h * batch + bl) * DH;
  const typename C::T* vbase = vc + (lbase + (size_t)h * batch + bl) * DH;
  // this lane's row of the staged mask and scales: position s at s - blk_start
  const int* mrow = mks + r * MASK_LD;
  const float* ksrow = kss + (QUANT ? r * MASK_LD : 0);
  const float* vsrow = vss + (QUANT ? r * MASK_LD : 0);

  auto load_batch = [&](Batch<C>& x, int s0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      if (s < end) {
        C::load(x.k[u], kbase + (size_t)s * hb * DH, sub);
        C::load(x.v[u], vbase + (size_t)s * hb * DH, sub);
      }
    }
  };

  float m = start < end ? NEG_FILL : -INFINITY;
  float l = 0.f;
  auto step = [&](const Batch<C>& x, int s0) {
    float sc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float f[16];
      C::unpack(x.k[u], f);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) part = fmaf(qv[i], f[i], part);
      sc[u] = part;
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u) sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off);
    float m_new = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      if (s < end) {
        float val = QUANT ? sc[u] * ksrow[s - blk_start] : sc[u];
        if (mrow[s - blk_start] == 0) val = NEG_FILL;
        sc[u] = val;
      } else {
        sc[u] = -INFINITY;
      }
      m_new = fmaxf(m_new, sc[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      if (s < end) {  // warp-uniform; x holds nothing past the end
        float p = expf(sc[u] - m_new);
        l += p;
        if (QUANT) p *= vsrow[s - blk_start];
        float f[16];
        C::unpack(x.v[u], f);
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = fmaf(p, f[i], acc[i]);
      }
    }
    m = m_new;
  };

  Batch<C> xa, xb;
  load_batch(xa, start);
  __syncthreads();  // the staged mask and scales
  for (int s0 = start; s0 < end; s0 += 2 * U) {
    load_batch(xb, s0 + U);
    step(xa, s0);
    if (s0 + U >= end) break;
    load_batch(xa, s0 + 2 * U);
    step(xb, s0 + U);
  }

  // merge the block's warps, in warp order
  if (sub == 0) {
    red_ml[warp][r][0] = m;
    red_ml[warp][r][1] = l;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) red_acc[warp][r][C::elem(sub, i)] = acc[i];
  __syncthreads();
  const int rr = threadIdx.x >> 6, e0 = (threadIdx.x & 63) * 2;
  float mt = -INFINITY;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, red_ml[w][rr][0]);
  float lt = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const float mw = red_ml[w][rr][0];
    if (mw == -INFINITY) continue;  // a warp with no positions
    const float wt = expf(mw - mt);
    lt = fmaf(wt, red_ml[w][rr][1], lt);
    a0 = fmaf(wt, red_acc[w][rr][e0], a0);
    a1 = fmaf(wt, red_acc[w][rr][e0 + 1], a1);
  }
  if (b0 + rr < batch) {
    const size_t out_row = split * hb + (size_t)h * batch + b0 + rr;
    *reinterpret_cast<float2*>(part_acc + out_row * DH + e0) = make_float2(a0, a1);
    if (e0 == 0) {
      part_ml[out_row * 2] = mt;
      part_ml[out_row * 2 + 1] = lt;
    }
  }
}

// Pass 2: merge the chunks of each pair in order and normalise.
template <typename QT>
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
decode_combine(const float* __restrict__ part_ml,
               const float* __restrict__ part_acc, QT* __restrict__ out,
               int n_split, int n_heads, int batch) {
  const int lane = threadIdx.x & 31;
  const int hb = n_heads * batch;
  const int pair = blockIdx.x * COMBINE_WARPS + (threadIdx.x >> 5);
  if (pair >= hb) return;
  const int h = pair / batch, b = pair % batch;

  float mx = -INFINITY;
  for (int i = 0; i < n_split; ++i)
    mx = fmaxf(mx, part_ml[((size_t)i * hb + pair) * 2]);
  float l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < n_split; ++i) {
    const size_t r = (size_t)i * hb + pair;
    const float mi = part_ml[r * 2];
    if (mi == -INFINITY) continue;  // empty chunk
    const float w = expf(mi - mx);
    l = fmaf(w, part_ml[r * 2 + 1], l);
    float a[4];
    load4(part_acc + r * DH + lane * 4, a);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = fmaf(w, a[e], acc[e]);
  }
  float res[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) res[e] = l > 0.f ? acc[e] / fmaxf(l, 1e-30f) : 0.f;
  store4(out + ((size_t)b * n_heads + h) * DH + lane * 4, res);
}

template <typename QT, typename C, bool QUANT>
int launch(const void* q, const void* kc, const void* vc, const float* ksc,
           const float* vsc, const int* mask, const int* cur_len_dev,
           void* out, float* part_ml, float* part_acc, int s_max, int n_heads,
           int batch, int layer, int cur_len, int chunk, int n_split,
           cudaStream_t stream) {
  const int hb = n_heads * batch;
  const dim3 grid1(n_heads * ((batch + ROWS - 1) / ROWS), n_split);
  decode_partial<QT, C, QUANT><<<grid1, THREADS, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const typename C::T*>(kc),
      static_cast<const typename C::T*>(vc), ksc, vsc, mask, cur_len_dev,
      part_ml, part_acc, s_max, n_heads, batch, layer, cur_len, chunk,
      (float)(1.0 / sqrt((double)DH)));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine<QT><<<(hb + COMBINE_WARPS - 1) / COMBINE_WARPS,
                       COMBINE_WARPS * 32, 0, stream>>>(
      part_ml, part_acc, static_cast<QT*>(out), n_split, n_heads, batch);
  return (int)cudaGetLastError();
}

template <typename QT>
int dispatch_kv(int kv_dtype, const void* q, const void* kc, const void* vc,
                const float* ksc, const float* vsc, const int* mask,
                const int* cur_len_dev, void* out, float* part_ml,
                float* part_acc, int s_max, int n_heads, int batch, int layer,
                int cur_len, int chunk, int n_split, cudaStream_t st) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, Bf16Cache, false>(q, kc, vc, ksc, vsc, mask,
                                          cur_len_dev, out, part_ml, part_acc,
                                          s_max, n_heads, batch, layer,
                                          cur_len, chunk, n_split, st);
    case 1:
      return launch<QT, Int8Cache, true>(q, kc, vc, ksc, vsc, mask,
                                         cur_len_dev, out, part_ml, part_acc,
                                         s_max, n_heads, batch, layer,
                                         cur_len, chunk, n_split, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16.  kv_dtype: 0 = bfloat16, 1 = int8
// (then k_scale / v_scale [L, S, H, B] are read).  chunk: positions per
// block of the first pass, a multiple of 8 up to 256, with n_split * chunk
// >= cur_len.  cur_len_dev: null, or one int32 in device memory that
// replaces cur_len when the kernel runs (the launch then passes the split
// of cur_len = s_max, and the kernel derives the split of the value it
// reads).  part_ml and part_acc are caller-allocated scratch of
// n_split * H * B * 2 and n_split * H * B * head_dim floats; the caches and
// q 16-byte aligned.  Returns a cudaError_t (0 = success).
extern "C" int ospo_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const float* k_scale, const float* v_scale, const int* mask,
    const int* cur_len_dev, void* out, float* part_ml, float* part_acc,
    int s_max, int n_heads, int batch, int head_dim, int layer, int cur_len,
    int chunk, int n_split, int q_dtype, int kv_dtype, void* stream) {
  if (head_dim != DH || batch <= 0 || n_split <= 0 || chunk <= 0 ||
      chunk > CHUNK || chunk % WARPS || (long long)n_split * chunk < cur_len)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k_cache, v_cache})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return dispatch_kv<float>(kv_dtype, q, k_cache, v_cache, k_scale, v_scale,
                              mask, cur_len_dev, out, part_ml, part_acc,
                              s_max, n_heads, batch, layer, cur_len, chunk,
                              n_split, st);
  if (q_dtype == 1)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_cache, v_cache, k_scale,
                                      v_scale, mask, cur_len_dev, out, part_ml,
                                      part_acc, s_max, n_heads, batch, layer,
                                      cur_len, chunk, n_split, st);
  return (int)cudaErrorInvalidValue;
}
