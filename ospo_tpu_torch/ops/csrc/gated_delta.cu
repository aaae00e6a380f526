// The T == 1 step of a gated delta-rule layer for Hopper (sm_90a), as
// ops/gated_delta.py's module docstring defines it, in one launch a layer:
//  - gdn_decode, a Gated DeltaNet layer (Qwen3-Next): the causal conv over
//    [q | k | v] with its state, SiLU, the L2 norms of q and k, the gates
//    beta and g (a scalar decay a head), the delta-rule update of the fp32
//    recurrent state in place, o = S^T q, and the gated norm of o with z;
//  - kda_decode, a Kimi Delta Attention layer (Kimi Linear): the same with
//    three separate projections q, k, v (one value head a key head), a decay
//    exp(g) per key row of the state, g formed from its low-rank projection,
//    and the gated norm's gate sigmoid(og) in place of silu(z).
//
// Replaces no TPU kernel: the JAX package runs no linear-attention trunk.
//
// What bounds it: the recurrent state, [Dk, Dv] = [128, 128] fp32 a value
// head and row, read once and written once a step (at 192 rows and 32 value
// heads, 403 MB each way a layer, 0.24 ms at 3.35 TB/s); everything else a
// row reads is ~25 KB.  The design:
//  - a block of 512 threads takes one row and two value heads (gdn_decode:
//    the two of key head h, which read its q and k; kda_decode: heads 2p and
//    2p + 1, each with its own q and k): the conv of the block's channels
//    and their conv state are this block's alone, so the state is read and
//    rewritten with no other block between;
//  - each value head's state is held in registers by 8 warps: lane l owns
//    columns 4l .. 4l + 3 (one float4, so a warp reads one 512-byte row of
//    the state), warp w the rows w, w + 8, ..., w + 120; all 16 loads of a
//    thread are issued before any is used;
//  - S' = Diag(decay) S in registers (one decay for gdn_decode's head, one a
//    key row for kda_decode's); the column sums S'^T k and S'^T q (a
//    thread's 16 rows, then the 8 warps' partial sums in shared memory,
//    added in warp order); u = beta (v - S'^T k); o = S'^T q + (k . q) u,
//    which is (S' + k u^T)^T q; S' + k u^T is stored over the state.  Each
//    kernel writes this loop out over its own shared arrays: one device
//    function for both, reading them through pointers, made gdn_decode 3%
//    slower in the Qwen3-Next cell's traced steps;
//  - the first warp of each value head forms the gated norm of its 128
//    outputs and stores them in bf16.
// The order of every fp32 sum is fixed, so two runs are bit-equal.  It
// allocates nothing and never synchronises with the host, so a decode step
// that runs it can be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int DK = 128, DV = 128;   // key and value head widths
constexpr int RATIO = 2;            // value heads a key head
constexpr int CONV = 4;             // conv width (CONV - 1 inputs kept)
constexpr int THREADS = 512;
constexpr int CH = 2 * DK + RATIO * DV;   // conv channels a key head: 512
constexpr int PER_KH = CH + RATIO * DV;   // qkvz values a key head: 768
constexpr int HEAD_WARPS = 8;             // warps a value head
constexpr int ROWS_PER_WARP = DK / HEAD_WARPS;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float softplus(float v) { return v > 20.f ? v : log1pf(expf(v)); }

__global__ void __launch_bounds__(THREADS, 1)
gdn_decode(const __nv_bfloat16* __restrict__ qkvz, const __nv_bfloat16* __restrict__ ba,
           const __nv_bfloat16* __restrict__ conv_w, __nv_bfloat16* __restrict__ conv_state,
           float* __restrict__ state, const float* __restrict__ a_log,
           const float* __restrict__ dt_bias, const float* __restrict__ norm_w,
           __nv_bfloat16* __restrict__ out, int hk, int qkvz_stride, int ba_stride,
           float l2_eps, float eps) {
  __shared__ float act[CH];                       // q (scaled), k, v after the conv
  __shared__ float red[THREADS / 32];
  __shared__ float part_k[RATIO][HEAD_WARPS][DV];  // warps' partial S'^T k
  __shared__ float part_q[RATIO][HEAD_WARPS][DV];
  __shared__ float gate_s[RATIO][2];              // beta, exp(g)

  const int row = blockIdx.x / hk, kh = blockIdx.x % hk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hv = hk * RATIO, channels = hk * (2 * DK + RATIO * DV);
  float* st = state + ((size_t)row * hv + (size_t)kh * RATIO) * DK * DV;

  // the state's loads first: 16 float4 a thread, in flight while the conv
  // and the norms are formed
  const int j = warp / HEAD_WARPS, w = warp % HEAD_WARPS;
  float4 s[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i)
    s[i] = *reinterpret_cast<const float4*>(
        st + ((size_t)j * DK + w + HEAD_WARPS * i) * DV + 4 * lane);

  // the conv: thread c takes channel c of the key head (q, k, then v)
  {
    const int c = tid;
    const int ch = c < DK ? kh * DK + c
                 : c < 2 * DK ? hk * DK + kh * DK + c - DK
                 : 2 * hk * DK + kh * RATIO * DV + c - 2 * DK;
    const __nv_bfloat16* xr = qkvz + (size_t)row * qkvz_stride + (size_t)kh * PER_KH;
    __nv_bfloat16* cs = conv_state + (size_t)row * (CONV - 1) * channels + ch;
    float prev[CONV - 1];
#pragma unroll
    for (int t = 0; t < CONV - 1; ++t) prev[t] = __bfloat162float(cs[(size_t)t * channels]);
    const __nv_bfloat16 xb = xr[c];
    const float x = __bfloat162float(xb);
    const __nv_bfloat16* wr = conv_w + (size_t)ch * CONV;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < CONV - 1; ++t) acc += __bfloat162float(wr[t]) * prev[t];
    acc += __bfloat162float(wr[CONV - 1]) * x;
#pragma unroll
    for (int t = 0; t < CONV - 2; ++t) cs[(size_t)t * channels] = __float2bfloat16_rn(prev[t + 1]);
    cs[(size_t)(CONV - 2) * channels] = xb;
    act[c] = silu(acc);
  }
  if (tid < RATIO) {
    const int h = kh * RATIO + tid;
    const __nv_bfloat16* br = ba + (size_t)row * ba_stride + (size_t)kh * 2 * RATIO;
    const float b = __bfloat162float(br[tid]), a = __bfloat162float(br[RATIO + tid]);
    const float xa = a + dt_bias[h];
    const float sp = xa > 20.f ? xa : log1pf(expf(xa));
    gate_s[tid][0] = 1.f / (1.f + expf(-b));
    gate_s[tid][1] = expf(-expf(a_log[h]) * sp);
  }
  __syncthreads();
  // the L2 norms: warps 0-3 hold q, 4-7 k
  if (warp < 8) {
    const float v = act[tid];
    const float ss = warp_sum(v * v);
    if (lane == 0) red[warp] = ss;
  }
  __syncthreads();
  if (tid < 2 * DK) {
    const int base = tid < DK ? 0 : 4;
    const float ss = red[base] + red[base + 1] + red[base + 2] + red[base + 3];
    const float scale = rsqrtf(ss + l2_eps) * (tid < DK ? rsqrtf((float)DK) : 1.f);
    act[tid] *= scale;
  }
  __syncthreads();
  // k . q, formed by every warp
  float kq = 0.f;
  {
    float p = 0.f;
#pragma unroll
    for (int i = 0; i < DK / 32; ++i) p += act[lane + 32 * i] * act[DK + lane + 32 * i];
    kq = warp_sum(p);
  }

  // S' = e^g S; this thread's partial column sums of S'^T k and S'^T q
  const float beta = gate_s[j][0], decay = gate_s[j][1];
  float pk[4] = {0.f, 0.f, 0.f, 0.f}, pq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = w + HEAD_WARPS * i;
    const float qv = act[r], kv = act[DK + r];
    s[i].x *= decay; s[i].y *= decay; s[i].z *= decay; s[i].w *= decay;
    pk[0] += s[i].x * kv; pk[1] += s[i].y * kv; pk[2] += s[i].z * kv; pk[3] += s[i].w * kv;
    pq[0] += s[i].x * qv; pq[1] += s[i].y * qv; pq[2] += s[i].z * qv; pq[3] += s[i].w * qv;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    part_k[j][w][4 * lane + e] = pk[e];
    part_q[j][w][4 * lane + e] = pq[e];
  }
  __syncthreads();
  float u[4], o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = 4 * lane + e;
    float sk = 0.f, sq = 0.f;
#pragma unroll
    for (int ww = 0; ww < HEAD_WARPS; ++ww) { sk += part_k[j][ww][c]; sq += part_q[j][ww][c]; }
    u[e] = beta * (act[2 * DK + j * DV + c] - sk);
    o[e] = sq + kq * u[e];
  }
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = w + HEAD_WARPS * i;
    const float kv = act[DK + r];
    float4 v = s[i];
    v.x += kv * u[0]; v.y += kv * u[1]; v.z += kv * u[2]; v.w += kv * u[3];
    *reinterpret_cast<float4*>(st + ((size_t)j * DK + r) * DV + 4 * lane) = v;
  }
  if (w != 0) return;
  // the gated norm of this value head's o, by its first warp
  const float ss = warp_sum(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3]);
  const float rstd = rsqrtf(ss / DV + eps);
  const int h = kh * RATIO + j;
  const __nv_bfloat16* z = qkvz + (size_t)row * qkvz_stride + (size_t)kh * PER_KH + CH + j * DV;
  __nv_bfloat16* dst = out + (size_t)row * hv * DV + (size_t)h * DV;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = 4 * lane + e;
    const float zv = __bfloat162float(z[c]);
    dst[c] = __float2bfloat16_rn(o[e] * rstd * norm_w[c] * silu(zv));
  }
}

constexpr int KDA_CH = 3 * DK;   // conv channels a KDA head: q, k, v

__global__ void __launch_bounds__(THREADS, 1)
kda_decode(const __nv_bfloat16* __restrict__ q_in, const __nv_bfloat16* __restrict__ k_in,
           const __nv_bfloat16* __restrict__ v_in, const __nv_bfloat16* __restrict__ f_in,
           const __nv_bfloat16* __restrict__ b_in, const __nv_bfloat16* __restrict__ og_in,
           const __nv_bfloat16* __restrict__ conv_w, __nv_bfloat16* __restrict__ conv_state,
           float* __restrict__ state, const float* __restrict__ a_log,
           const float* __restrict__ dt_bias, const float* __restrict__ norm_w,
           __nv_bfloat16* __restrict__ out, int heads, int x_stride, int b_stride,
           float l2_eps, float eps) {
  __shared__ float act[RATIO][KDA_CH];             // a head's q (scaled), k, v after the conv
  __shared__ float dec[RATIO][DK];                 // exp(g), a key row
  __shared__ float red[THREADS / 32];
  __shared__ float part_k[RATIO][HEAD_WARPS][DV];
  __shared__ float part_q[RATIO][HEAD_WARPS][DV];
  __shared__ float beta_s[RATIO];

  const int pairs = heads / RATIO;
  const int row = blockIdx.x / pairs, hp = blockIdx.x % pairs;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int width = heads * DK, channels = 3 * width;
  const size_t xrow = (size_t)row * x_stride;
  float* st = state + ((size_t)row * heads + (size_t)hp * RATIO) * DK * DV;

  const int j = warp / HEAD_WARPS, w = warp % HEAD_WARPS;
  float4 s[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i)
    s[i] = *reinterpret_cast<const float4*>(
        st + ((size_t)j * DK + w + HEAD_WARPS * i) * DV + 4 * lane);

  // the conv: the block's 2 x 384 channels (head jj's q, k, v), 1.5 a thread
  for (int c = tid; c < RATIO * KDA_CH; c += THREADS) {
    const int jj = c / KDA_CH, part = (c % KDA_CH) / DK, d = c % DK;
    const int col = (hp * RATIO + jj) * DK + d;
    const int ch = part * width + col;
    const __nv_bfloat16* src = part == 0 ? q_in : part == 1 ? k_in : v_in;
    __nv_bfloat16* cs = conv_state + (size_t)row * (CONV - 1) * channels + ch;
    float prev[CONV - 1];
#pragma unroll
    for (int t = 0; t < CONV - 1; ++t) prev[t] = __bfloat162float(cs[(size_t)t * channels]);
    const __nv_bfloat16 xb = src[xrow + col];
    const __nv_bfloat16* wr = conv_w + (size_t)ch * CONV;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < CONV - 1; ++t) acc += __bfloat162float(wr[t]) * prev[t];
    acc += __bfloat162float(wr[CONV - 1]) * __bfloat162float(xb);
#pragma unroll
    for (int t = 0; t < CONV - 2; ++t) cs[(size_t)t * channels] = __float2bfloat16_rn(prev[t + 1]);
    cs[(size_t)(CONV - 2) * channels] = xb;
    act[jj][part * DK + d] = silu(acc);
  }
  // the gates: g a key row from its low-rank projection f, beta a head
  if (tid < RATIO * DK) {
    const int jj = tid / DK, d = tid % DK, h = hp * RATIO + jj;
    const float xa = __bfloat162float(f_in[xrow + (size_t)h * DK + d]) + dt_bias[h * DK + d];
    dec[jj][d] = expf(-expf(a_log[h]) * softplus(xa));
  }
  if (tid < RATIO)
    beta_s[tid] = sigmoid(__bfloat162float(b_in[(size_t)row * b_stride + hp * RATIO + tid]));
  __syncthreads();
  // the L2 norms of q0, k0, q1, k1: four warps a vector
  float* flat = &act[0][0];
  {
    const int vi = warp >> 2;
    const float v = flat[(vi >> 1) * KDA_CH + (vi & 1) * DK + (warp & 3) * 32 + lane];
    const float ss = warp_sum(v * v);
    if (lane == 0) red[warp] = ss;
  }
  __syncthreads();
  {
    const int vi = tid / DK, d = tid % DK;
    const float ss = red[4 * vi] + red[4 * vi + 1] + red[4 * vi + 2] + red[4 * vi + 3];
    const float scale = rsqrtf(ss + l2_eps) * ((vi & 1) == 0 ? rsqrtf((float)DK) : 1.f);
    flat[(vi >> 1) * KDA_CH + (vi & 1) * DK + d] *= scale;
  }
  __syncthreads();
  // k . q of this warp's head
  float kq = 0.f;
  {
    float p = 0.f;
#pragma unroll
    for (int i = 0; i < DK / 32; ++i) p += act[j][lane + 32 * i] * act[j][DK + lane + 32 * i];
    kq = warp_sum(p);
  }

  // S' = Diag(exp g) S; this thread's partial column sums of S'^T k and S'^T q
  const float beta = beta_s[j];
  float pk[4] = {0.f, 0.f, 0.f, 0.f}, pq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = w + HEAD_WARPS * i;
    const float qv = act[j][r], kv = act[j][DK + r], decay = dec[j][r];
    s[i].x *= decay; s[i].y *= decay; s[i].z *= decay; s[i].w *= decay;
    pk[0] += s[i].x * kv; pk[1] += s[i].y * kv; pk[2] += s[i].z * kv; pk[3] += s[i].w * kv;
    pq[0] += s[i].x * qv; pq[1] += s[i].y * qv; pq[2] += s[i].z * qv; pq[3] += s[i].w * qv;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    part_k[j][w][4 * lane + e] = pk[e];
    part_q[j][w][4 * lane + e] = pq[e];
  }
  __syncthreads();
  float u[4], o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = 4 * lane + e;
    float sk = 0.f, sq = 0.f;
#pragma unroll
    for (int ww = 0; ww < HEAD_WARPS; ++ww) { sk += part_k[j][ww][c]; sq += part_q[j][ww][c]; }
    u[e] = beta * (act[j][2 * DK + c] - sk);
    o[e] = sq + kq * u[e];
  }
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = w + HEAD_WARPS * i;
    const float kv = act[j][DK + r];
    float4 v = s[i];
    v.x += kv * u[0]; v.y += kv * u[1]; v.z += kv * u[2]; v.w += kv * u[3];
    *reinterpret_cast<float4*>(st + ((size_t)j * DK + r) * DV + 4 * lane) = v;
  }
  if (w != 0) return;
  // the gated norm of this head's o, by its first warp
  const float ss = warp_sum(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3]);
  const float rstd = rsqrtf(ss / DV + eps);
  const int h = hp * RATIO + j;
  const __nv_bfloat16* og = og_in + xrow + (size_t)h * DV;
  __nv_bfloat16* dst = out + (size_t)row * heads * DV + (size_t)h * DV;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = 4 * lane + e;
    dst[c] = __float2bfloat16_rn(o[e] * rstd * norm_w[c] * sigmoid(__bfloat162float(og[c])));
  }
}

}  // namespace

// qkvz: [rows, hk * 768] bf16 (row stride qkvz_stride), per key head q 128,
// k 128, v 2 x 128, z 2 x 128; ba: [rows, hk * 4] bf16 (row stride
// ba_stride), per key head b 2, a 2; conv_w: [C, 4] bf16, C = hk * 512 in
// [q | k | v] order; conv_state: [rows, 3, C] bf16; state: [rows, 2 hk, 128,
// 128] fp32; a_log, dt_bias: [2 hk] fp32; norm_w: [128] fp32; out: [rows,
// 2 hk * 128] bf16.  Both states are updated in place.  Returns a
// cudaError_t.
extern "C" int ospo_gdn_decode(const void* qkvz, const void* ba, const void* conv_w,
                               void* conv_state, float* state, const float* a_log,
                               const float* dt_bias, const float* norm_w, void* out,
                               int rows, int hk, int qkvz_stride, int ba_stride,
                               float l2_eps, float eps, void* stream) {
  if (rows <= 0 || hk <= 0) return cudaErrorInvalidValue;
  gdn_decode<<<rows * hk, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkvz), static_cast<const __nv_bfloat16*>(ba),
      static_cast<const __nv_bfloat16*>(conv_w), static_cast<__nv_bfloat16*>(conv_state),
      state, a_log, dt_bias, norm_w, static_cast<__nv_bfloat16*>(out), hk, qkvz_stride,
      ba_stride, l2_eps, eps);
  return cudaGetLastError();
}

// q, k, v, f, og: [rows, heads * 128] bf16 (row stride x_stride): q, k, v
// before the conv, f the decay's low-rank projection before dt_bias, og the
// output gate's; b: [rows, heads] bf16 (row stride b_stride); conv_w: [C, 4]
// bf16, C = 3 heads * 128 in [q | k | v] order; conv_state: [rows, 3, C]
// bf16; state: [rows, heads, 128, 128] fp32; a_log: [heads] fp32; dt_bias:
// [heads * 128] fp32; norm_w: [128] fp32; out: [rows, heads * 128] bf16.
// heads even.  Both states are updated in place.  Returns a cudaError_t.
extern "C" int ospo_kda_decode(const void* q, const void* k, const void* v, const void* f,
                               const void* b, const void* og, const void* conv_w,
                               void* conv_state, float* state, const float* a_log,
                               const float* dt_bias, const float* norm_w, void* out,
                               int rows, int heads, int x_stride, int b_stride,
                               float l2_eps, float eps, void* stream) {
  if (rows <= 0 || heads <= 0 || heads % RATIO) return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  kda_decode<<<rows * (heads / RATIO), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(f), static_cast<const bf*>(b), static_cast<const bf*>(og),
      static_cast<const bf*>(conv_w), static_cast<bf*>(conv_state), state, a_log, dt_bias,
      norm_w, static_cast<bf*>(out), heads, x_stride, b_stride, l2_eps, eps);
  return cudaGetLastError();
}
