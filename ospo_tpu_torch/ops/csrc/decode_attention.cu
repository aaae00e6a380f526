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
// need, so the floor is bytes / 3.35 TB/s.  The design is built around
// moving those bytes once and at full width:
//  - the cache is read in place (no per-layer slice, no dequantised copy);
//    each (position, head, row) vector is one contiguous 128 B (int8) or
//    256 B (bf16) line, read by one warp with one 4-element load per lane;
//  - only positions below cur_len are read (the grid is sized from it);
//  - flash-decoding split: pass 1 gives every (head, row) pair one warp per
//    chunk of CHUNK positions, so ~10k warps keep enough loads in flight to
//    saturate HBM even though each pair has a single query; each warp keeps
//    UNROLL positions' K and V loads in flight at once; pass 2 merges the
//    chunks' (m, l, acc) partials.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 128;          // head dim: 4 elements per lane
constexpr int WARPS = 4;         // (head, row) pairs per block
constexpr int UNROLL = 8;        // positions in flight per warp
constexpr float NEG_FILL = -1e30f;

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float* out) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  out[0] = (float)c.x; out[1] = (float)c.y; out[2] = (float)c.z; out[3] = (float)c.w;
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

// Pass 1: partial softmax of one (head, row) pair over one position chunk.
// part_ml: [n_split, HB, 2] (m, l); part_acc: [n_split, HB, DH].
template <typename QT, typename KT, bool QUANT>
__global__ void __launch_bounds__(WARPS * 32)
decode_partial(const QT* __restrict__ q, const KT* __restrict__ kc,
               const KT* __restrict__ vc, const float* __restrict__ ksc,
               const float* __restrict__ vsc, const int* __restrict__ mask,
               float* __restrict__ part_ml, float* __restrict__ part_acc,
               int s_max, int n_heads, int batch, int layer, int cur_len,
               int chunk, float scale) {
  const int lane = threadIdx.x & 31;
  const int hb = n_heads * batch;
  const int pair = blockIdx.x * WARPS + (threadIdx.x >> 5);  // h * B + b
  if (pair >= hb) return;
  const int split = blockIdx.y;
  const int h = pair / batch, b = pair % batch;
  const int start = split * chunk;
  const int end = min(cur_len, start + chunk);
  const size_t out_row = (size_t)split * hb + pair;

  float qv[4], acc[4] = {0.f, 0.f, 0.f, 0.f};
  load4(q + ((size_t)b * n_heads + h) * DH + lane * 4, qv);
#pragma unroll
  for (int e = 0; e < 4; ++e) qv[e] *= scale;

  const size_t pos_stride = (size_t)hb * DH;
  const KT* kbase = kc + (size_t)layer * s_max * pos_stride + (size_t)pair * DH + lane * 4;
  const KT* vbase = vc + (size_t)layer * s_max * pos_stride + (size_t)pair * DH + lane * 4;
  const size_t sbase = (size_t)layer * s_max * hb + pair;
  const int* mrow = mask + (size_t)b * s_max;

  float m = start < end ? NEG_FILL : -INFINITY;
  float l = 0.f;
  for (int s0 = start; s0 < end; s0 += UNROLL) {
    // every load of the iteration is issued here, before any use, so one
    // memory round trip serves UNROLL positions
    float kf[UNROLL][4], vf[UNROLL][4], sc[UNROLL], ksv[UNROLL], vsv[UNROLL];
    int mv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u;
      ksv[u] = vsv[u] = 1.f;
      mv[u] = 0;
      if (s < end) {
        load4(kbase + (size_t)s * pos_stride, kf[u]);
        load4(vbase + (size_t)s * pos_stride, vf[u]);
        if (QUANT) {
          ksv[u] = ksc[sbase + (size_t)s * hb];
          vsv[u] = vsc[sbase + (size_t)s * hb];
        }
        mv[u] = mrow[s];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) part = fmaf(qv[e], kf[u][e], part);
      sc[u] = part;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off);

    float m_new = m;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u;
      if (s < end) {
        float val = sc[u];
        if (QUANT) val *= ksv[u];
        if (mv[u] == 0) val = NEG_FILL;
        sc[u] = val;
      } else {
        sc[u] = -INFINITY;
      }
      m_new = fmaxf(m_new, sc[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float p = expf(sc[u] - m_new);
      l += p;
      if (QUANT) p *= vsv[u];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = fmaf(p, vf[u][e], acc[e]);
    }
    m = m_new;
  }

  store4(part_acc + out_row * DH + lane * 4, acc);
  if (lane == 0) {
    part_ml[out_row * 2] = m;
    part_ml[out_row * 2 + 1] = l;
  }
}

// Pass 2: merge the chunks of each pair and normalise.
template <typename QT>
__global__ void __launch_bounds__(WARPS * 32)
decode_combine(const float* __restrict__ part_ml,
               const float* __restrict__ part_acc, QT* __restrict__ out,
               int n_split, int n_heads, int batch) {
  const int lane = threadIdx.x & 31;
  const int hb = n_heads * batch;
  const int pair = blockIdx.x * WARPS + (threadIdx.x >> 5);
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

template <typename QT, typename KT, bool QUANT>
int launch(const void* q, const void* kc, const void* vc, const float* ksc,
           const float* vsc, const int* mask, void* out, float* part_ml,
           float* part_acc, int s_max, int n_heads, int batch, int layer,
           int cur_len, int chunk, int n_split, cudaStream_t stream) {
  const int hb = n_heads * batch;
  const dim3 grid1((hb + WARPS - 1) / WARPS, n_split);
  decode_partial<QT, KT, QUANT><<<grid1, WARPS * 32, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kc),
      static_cast<const KT*>(vc), ksc, vsc, mask, part_ml, part_acc, s_max,
      n_heads, batch, layer, cur_len, chunk, (float)(1.0 / sqrt((double)DH)));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine<QT><<<(hb + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
      part_ml, part_acc, static_cast<QT*>(out), n_split, n_heads, batch);
  return (int)cudaGetLastError();
}

template <typename QT>
int dispatch_kv(int kv_dtype, const void* q, const void* kc, const void* vc,
                const float* ksc, const float* vsc, const int* mask, void* out,
                float* part_ml, float* part_acc, int s_max, int n_heads,
                int batch, int layer, int cur_len, int chunk, int n_split,
                cudaStream_t st) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, __nv_bfloat16, false>(q, kc, vc, ksc, vsc, mask, out,
                                              part_ml, part_acc, s_max, n_heads,
                                              batch, layer, cur_len, chunk,
                                              n_split, st);
    case 1:
      return launch<QT, int8_t, true>(q, kc, vc, ksc, vsc, mask, out, part_ml,
                                      part_acc, s_max, n_heads, batch, layer,
                                      cur_len, chunk, n_split, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16.  kv_dtype: 0 = bfloat16, 1 = int8
// (then k_scale / v_scale [L, S, H, B] are read).  part_ml and
// part_acc are caller-allocated scratch of n_split * H * B * 2 and
// n_split * H * B * head_dim floats.  Returns a cudaError_t (0 = success).
extern "C" int ospo_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const float* k_scale, const float* v_scale, const int* mask, void* out,
    float* part_ml, float* part_acc, int s_max, int n_heads, int batch,
    int head_dim, int layer, int cur_len, int chunk, int n_split, int q_dtype,
    int kv_dtype, void* stream) {
  if (head_dim != DH || chunk <= 0 || n_split <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return dispatch_kv<float>(kv_dtype, q, k_cache, v_cache, k_scale, v_scale,
                              mask, out, part_ml, part_acc, s_max, n_heads,
                              batch, layer, cur_len, chunk, n_split, st);
  if (q_dtype == 1)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_cache, v_cache, k_scale,
                                      v_scale, mask, out, part_ml, part_acc,
                                      s_max, n_heads, batch, layer, cur_len,
                                      chunk, n_split, st);
  return (int)cudaErrorInvalidValue;
}
