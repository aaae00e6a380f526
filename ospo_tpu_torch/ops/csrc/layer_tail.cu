// The elementwise chain between a LLaMA layer's products, for Hopper
// (sm_90a), as ops/layer_tail.py's module docstring defines it: three
// kernels in place of the ~64 one-op PyTorch kernels a cached layer ran.
//  - add_rms_norm: the residual add and RMSNorm of the sum in one pass
//    (the input norm, the post-attention add with the MLP norm, and the
//    down projection's add with the next layer's input norm or the final
//    norm);
//  - rope_kv_write: rope on q and k, and k and v quantized row by row to
//    int8 with fp32 scales (or cast, for a bf16 cache) and written into the
//    shbd cache at the step's position;
//  - silu_mul: silu(gate) * up.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it into the products' neighbours.
//
// What bounds it: bytes, and at decode sizes the launch.  A 7B decode layer
// at 48 rows reads and writes ~5 MB here (x, q/k/v, the cache rows,
// gate/up): ~1.5 us at 3.35 TB/s, so each kernel is one pass with 16-byte
// loads where the rows allow it, and every value is read once and kept in
// registers between its reduction and its use.
//
// Roundings follow the plain chain step by step: the residual add rounds
// the fp32 sum to bf16; the norm's statistics are fp32 (a sum of squares
// times 1/n, in this kernel's order: the only permitted difference), then
// rsqrtf, x * rms rounded to bf16 before the weight multiply, and that
// product rounded again; rope in fp32 without contraction (__fmul_rn,
// __fsub_rn, __fadd_rn), rounded to bf16; the int8 quantization as
// PyTorch computes it on the card: amax, clamp_min(1e-12), times the fp32
// reciprocal of 127 (PyTorch's division by a host scalar), x / s by
// __fdiv_rn, rintf (half to even) and a clamp to +-127; SiLU as
// x / (1 + expf(-x)) in fp32, rounded to bf16 before the multiply by up.
// Nothing allocates or synchronises with the host, so a step that runs
// these can be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int VEC = 8;              // bf16 values a 16-byte load
constexpr int NORM_THREADS = 256;
constexpr int NORM_LOADS = 4;       // 16-byte loads a thread: D <= 8192
constexpr int HEAD = 128;           // the rope kernel's head dim
constexpr int ROPE_WARPS = 4;       // (row, position, head) triples a block
constexpr int SILU_THREADS = 256;
constexpr int SILU_MAX_BLOCKS = 132 * 8;   // eight blocks an SM, then a grid-stride loop

__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one block a row: x (+ y) → x_out, and h = r(r(x * rsqrt(mean(x^2) + eps)) * w)
__global__ void __launch_bounds__(NORM_THREADS)
add_rms_norm(const bf16* __restrict__ x, const bf16* __restrict__ y,
             const bf16* __restrict__ w, bf16* __restrict__ x_out,
             bf16* __restrict__ h, int d, float eps) {
  __shared__ float red[NORM_THREADS / 32];
  const int tid = threadIdx.x, nv = d / VEC;
  const size_t base = (size_t)blockIdx.x * d;
  float v[NORM_LOADS][VEC], wv[NORM_LOADS][VEC];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NORM_LOADS; ++i) {
    const int c = tid + i * NORM_THREADS;
    if (c >= nv) continue;
    load8(x + base + (size_t)c * VEC, v[i]);
    load8(w + (size_t)c * VEC, wv[i]);
    if (y != nullptr) {
      float t[VEC];
      load8(y + base + (size_t)c * VEC, t);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[i][e] = round_bf16(__fadd_rn(v[i][e], t[e]));
      store8(x_out + base + (size_t)c * VEC, v[i]);   // exact: already bf16 values
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss = __fadd_rn(ss, __fmul_rn(v[i][e], v[i][e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((tid & 31) == 0) red[tid >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < NORM_THREADS / 32; ++i) total += red[i];
  const float rms = rsqrtf(__fadd_rn(__fmul_rn(total, 1.f / (float)d), eps));
#pragma unroll
  for (int i = 0; i < NORM_LOADS; ++i) {
    const int c = tid + i * NORM_THREADS;
    if (c >= nv) continue;
    float o[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = __fmul_rn(round_bf16(__fmul_rn(v[i][e], rms)), wv[i][e]);
    store8(h + base + (size_t)c * VEC, o);
  }
}

// rotate-half rope of one 128-wide head row: lane l takes the pairs j = 2l,
// 2l + 1 of the first half and their partners j + 64
__device__ __forceinline__ void rope_row(const bf16* row, float2 c, float2 s, float* lo,
                                         float* hi) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(row + HEAD / 2));
  lo[0] = __fsub_rn(__fmul_rn(a.x, c.x), __fmul_rn(b.x, s.x));
  lo[1] = __fsub_rn(__fmul_rn(a.y, c.y), __fmul_rn(b.y, s.y));
  hi[0] = __fadd_rn(__fmul_rn(b.x, c.x), __fmul_rn(a.x, s.x));
  hi[1] = __fadd_rn(__fmul_rn(b.y, c.y), __fmul_rn(a.y, s.y));
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// one warp a head row (k or v, already rounded to bf16 values) into the
// cache: int8 payload and fp32 scale, or the bf16 values
__device__ __forceinline__ void write_row(const float* lo, const float* hi, void* cache,
                                          float* scales, size_t row, int lane) {
  if (scales == nullptr) {
    bf16* dst = static_cast<bf16*>(cache) + row * HEAD + 2 * lane;
    store2(dst, lo[0], lo[1]);
    store2(dst + HEAD / 2, hi[0], hi[1]);
    return;
  }
  float amax = fmaxf(fmaxf(fabsf(lo[0]), fabsf(lo[1])), fmaxf(fabsf(hi[0]), fabsf(hi[1])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = __fmul_rn(fmaxf(amax, 1e-12f), 1.f / 127.f);
  auto q = [s](float v) {
    return (signed char)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  };
  signed char* dst = static_cast<signed char*>(cache) + row * HEAD + 2 * lane;
  *reinterpret_cast<char2*>(dst) = make_char2(q(lo[0]), q(lo[1]));
  *reinterpret_cast<char2*>(dst + HEAD / 2) = make_char2(q(hi[0]), q(hi[1]));
  if (lane == 0) scales[row] = s;
}

// one warp a (position t, head h, row b), b fastest so neighbouring warps
// write neighbouring cache rows
__global__ void __launch_bounds__(ROPE_WARPS * 32)
rope_kv_write(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ cos_t,
              const float* __restrict__ sin_t, bf16* __restrict__ q_out,
              bf16* __restrict__ k_out, void* __restrict__ kc, void* __restrict__ vc,
              float* __restrict__ ks, float* __restrict__ vs,
              const int64_t* __restrict__ pos_ptr, int pos_host, int B, int T, int H,
              int S, int qsb, int qst, int qsh, int ksb, int kst, int ksh, int vsb,
              int vst, int vsh) {
  const int warp = blockIdx.x * ROPE_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (warp >= B * T * H) return;
  const int b = warp % B, h = (warp / B) % H, t = warp / (B * H);
  const int pos = (pos_ptr != nullptr ? (int)pos_ptr[0] : pos_host) + t;
  const size_t bt = (size_t)b * T + t;
  const float2 c = *reinterpret_cast<const float2*>(cos_t + bt * (HEAD / 2) + 2 * lane);
  const float2 s = *reinterpret_cast<const float2*>(sin_t + bt * (HEAD / 2) + 2 * lane);
  float lo[2], hi[2];

  rope_row(q + (size_t)b * qsb + (size_t)t * qst + (size_t)h * qsh + 2 * lane, c, s, lo, hi);
  bf16* qo = q_out + (bt * H + h) * HEAD + 2 * lane;
  store2(qo, lo[0], lo[1]);
  store2(qo + HEAD / 2, hi[0], hi[1]);

  rope_row(k + (size_t)b * ksb + (size_t)t * kst + (size_t)h * ksh + 2 * lane, c, s, lo, hi);
#pragma unroll
  for (int e = 0; e < 2; ++e) { lo[e] = round_bf16(lo[e]); hi[e] = round_bf16(hi[e]); }
  if (k_out != nullptr) {
    bf16* ko = k_out + (bt * H + h) * HEAD + 2 * lane;
    store2(ko, lo[0], lo[1]);
    store2(ko + HEAD / 2, hi[0], hi[1]);
  }
  if (pos < 0 || pos >= S) return;   // the wrapper checks a host position
  const size_t row = ((size_t)pos * H + h) * B + b;   // [S, H, B] of the layer
  write_row(lo, hi, kc, ks, row, lane);

  const bf16* vr = v + (size_t)b * vsb + (size_t)t * vst + (size_t)h * vsh + 2 * lane;
  const float2 va = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vr));
  const float2 vb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vr + HEAD / 2));
  lo[0] = va.x; lo[1] = va.y; hi[0] = vb.x; hi[1] = vb.y;
  write_row(lo, hi, vc, vs, row, lane);
}

__global__ void __launch_bounds__(SILU_THREADS)
silu_mul(const bf16* __restrict__ gate, const bf16* __restrict__ up, bf16* __restrict__ out,
         int n_vec) {
  for (int i = blockIdx.x * SILU_THREADS + threadIdx.x; i < n_vec;
       i += gridDim.x * SILU_THREADS) {
    float g[VEC], u[VEC];
    load8(gate + (size_t)i * VEC, g);
    load8(up + (size_t)i * VEC, u);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      g[e] = __fmul_rn(round_bf16(__fdiv_rn(g[e], __fadd_rn(1.f, expf(-g[e])))), u[e]);
    store8(out + (size_t)i * VEC, g);
  }
}

}  // namespace

// x, h: [rows, d] bf16; y: [rows, d] bf16 or null (no add: x_out unused);
// w: [d] bf16; x_out: [rows, d] bf16.  d a multiple of 8, at most 8192;
// every pointer 16-byte aligned.  Returns a cudaError_t.
extern "C" int ospo_add_rms_norm(const void* x, const void* y, const void* w, void* x_out,
                                 void* h, int rows, int d, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || d % VEC || d > VEC * NORM_THREADS * NORM_LOADS)
    return cudaErrorInvalidValue;
  add_rms_norm<<<rows, NORM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), static_cast<const bf16*>(w),
      static_cast<bf16*>(x_out), static_cast<bf16*>(h), d, eps);
  return cudaGetLastError();
}

// q, k, v: [B, T, H, 128] bf16 with element strides (row, position, head)
// and unit stride along the head, 4-byte aligned rows; cos, sin: [B, T, 64]
// fp32; q_out, k_out: [B, T, H, 128] bf16 (k_out may be null); kc, vc: one
// layer's [S, H, B, 128] cache, int8 with fp32 scales ks, vs [S, H, B], or
// bf16 with ks = vs = null; the position of t = 0 is *pos_ptr (int64, read
// when the kernel runs) or pos_host.  Returns a cudaError_t.
extern "C" int ospo_rope_kv_write(const void* q, const void* k, const void* v,
                                  const float* cos_t, const float* sin_t, void* q_out,
                                  void* k_out, void* kc, void* vc, float* ks, float* vs,
                                  const int64_t* pos_ptr, int pos_host, int B, int T, int H,
                                  int S, int qsb, int qst, int qsh, int ksb, int kst,
                                  int ksh, int vsb, int vst, int vsh, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || S <= 0) return cudaErrorInvalidValue;
  const long long warps = (long long)B * T * H;
  if (warps > 0x7fffffff) return cudaErrorInvalidValue;
  const int blocks = (int)((warps + ROPE_WARPS - 1) / ROPE_WARPS);
  rope_kv_write<<<blocks, ROPE_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      cos_t, sin_t, static_cast<bf16*>(q_out), static_cast<bf16*>(k_out), kc, vc, ks, vs,
      pos_ptr, pos_host, B, T, H, S, qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh);
  return cudaGetLastError();
}

// gate, up, out: n bf16 values each, n a multiple of 8, 16-byte aligned.
// Returns a cudaError_t.
extern "C" int ospo_silu_mul(const void* gate, const void* up, void* out, int n,
                             void* stream) {
  if (n <= 0 || n % VEC) return cudaErrorInvalidValue;
  const int n_vec = n / VEC;
  const int needed = (n_vec + SILU_THREADS - 1) / SILU_THREADS;
  const int blocks = needed < SILU_MAX_BLOCKS ? needed : SILU_MAX_BLOCKS;
  silu_mul<<<blocks, SILU_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gate), static_cast<const bf16*>(up), static_cast<bf16*>(out),
      n_vec);
  return cudaGetLastError();
}
