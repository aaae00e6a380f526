// The routed experts of a mixture-of-experts FFN for Hopper (sm_90a), as
// ops/moe.py's module docstring defines them: moe_route (router logits,
// softmax, top-k), moe_align (counts, offsets, grouping, tile table) and
// the grouped W8A16 GEMMs moe_gate_up (gate and up with SiLU) and moe_down.
//
// Replaces no TPU kernel: the JAX package runs no MoE trunk.  Added for
// DeepSeek-V2-style layers (models/deepseek_v2.py), whose routed experts
// are most of the bytes a decode step reads: 64 experts of [2F, D] and
// [D, F] int8 rows a layer (D 2048, F 1408: 553.6 MB), nearly all of which
// get a row in a 48-row step.  Nothing here reads a host value and the host
// reads nothing back, so a decode step that runs them can be captured in a
// CUDA graph.
//
// The grouped GEMMs.  At decode (~4.5 rows an expert, 16-row tiles) each
// int8 weight is used by a few rows, ~10 FLOP a byte against the H100's
// ~295 bf16 FLOP a byte of HBM: reading the weights once is the bound (4.3
// ms a step at 3.35 TB/s).  At prefill (hundreds of rows an expert, 64-row
// tiles) the products are.  The design:
//  - a tile of the table (tile_expert, tile_start; E past the last) is
//    blockIdx.x, a slice of 128 weight rows blockIdx.y; a tile past the
//    last returns at once, so the grid is sized for the worst case;
//  - the body is w8a16_mma.cuh's (with the dense T == 1 product): weight
//    rows the A operand of mma.sync, the tile's grouped rows B, a ring of
//    128-column chunks in shared memory (3 stages at decode, 2 at prefill),
//    int8 -> bf16 in registers, k permuted inside 64 columns;
//  - a warp of moe_gate_up owns 16 features of gate and the same 16 of up,
//    so SiLU(g) * u is formed in registers; a warp of moe_down owns 32
//    features of D; both keep 2 A tiles x (tile rows / 8) n-tiles of fp32
//    sums;
//  - the epilogue applies the per-row fp32 scale and rounds as the plain
//    version does: g = r(acc * sg), u = r(acc * su), h = r(r(silu(g)) * u);
//    y = r(acc * sd), stored at the row's (token, slot) index.
// Products of two bf16 values are exact in fp32, so the GEMMs and the
// plain version differ only in the order of the fp32 sums.
//
// Routing.  moe_route: a block of 32 warps takes 8 tokens; each warp
// multiplies 16 router rows by them over a split of D on the tensor cores
// (bf16 products, exact, summed in fp32, the same permuted k over 32-column
// chunks; ceil(E / 16) row tiles x 32 / that many splits, so that enough
// loads are in flight to stream the router from device memory, where the
// experts of the last step have pushed it; past 32 tiles, one split and a
// warp takes several tiles), the splits' sums are added in order, then one
// warp a token forms the fp32 softmax over the E logits and picks the top
// k greedily (ties: the lower expert).  With a correction bias (Kimi's
// sigmoid router) a token's scores are the sigmoids of its logits, the top
// k is taken over score + bias, and the weights are the chosen experts'
// unbiased scores, renormalised over (sum + 1e-20).  The router may carry one more row,
// a shared gate, whose logit weights the shared slots by its sigmoid; an
// expert share [e0, e0 + held) writes each routed id as its place among the
// held experts, or -1 for the others (ops/moe.py).  One instance takes
// up to 512 routed experts: past n_routed a lane's scores read -1 and are
// never chosen, so fewer experts route alike.  moe_align: one
// block counts each expert's rows with shared-memory atomics (a row's rank
// among its expert's; a row of id -1 is no expert's and is left out), scans
// the counts into offsets and tile counts, adds
// the counts to the caller's, writes the tile table and scatters every row
// to offsets[e] + rank.  Rows of one expert may land in any order; each
// output row depends on its own input row alone, so no value changes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "w8a16_mma.cuh"

namespace {

using namespace ospo_w8;

constexpr int GATE_UP_F = 16;     // features of gate (and of up) a warp
constexpr int DOWN_F = 32;        // features of D a warp

constexpr int ROUTE_TOK = 8;      // tokens a routing block
constexpr int ROUTE_THREADS = 1024;
constexpr int MAX_ROUTED = 512;   // routed experts moe_route takes
constexpr int MAX_TOP_K = 16;
constexpr int MAX_EXPERTS = 1024; // experts (routed and shared) moe_align takes
constexpr int ALIGN_THREADS = 1024;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

// The tile's expert, first grouped row and live rows, or false for a tile
// past the last.
__device__ __forceinline__ bool tile_of(const int* __restrict__ tile_expert,
                                        const int* __restrict__ tile_start,
                                        const int* __restrict__ offsets,
                                        int experts, int rows_max, int& ex,
                                        int& start, int& live) {
  ex = tile_expert[blockIdx.x];
  if (ex >= experts) return false;
  start = tile_start[blockIdx.x];
  live = min(offsets[ex + 1] - start, rows_max);
  return true;
}

template <int NT, int STAGES>
__global__ void __launch_bounds__(THREADS)
moe_gate_up(const __nv_bfloat16* __restrict__ x, const int* __restrict__ sorted_src,
            const int* __restrict__ tile_expert, const int* __restrict__ tile_start,
            const int* __restrict__ offsets, const int8_t* __restrict__ q,
            const float* __restrict__ s, __nv_bfloat16* __restrict__ h, int d,
            int f, int experts, int slots) {
  extern __shared__ __align__(16) uint8_t smem[];
  int ex, start, live;
  if (!tile_of(tile_expert, tile_start, offsets, experts, 8 * NT, ex, start, live))
    return;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int fb = blockIdx.y * WARPS * GATE_UP_F;  // the block's first feature
  Sources<NT> src;
  const int8_t* wq = q + (size_t)ex * 2 * f * d;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // block row j: warp j / 32's 16 gate rows, then its 16 up rows
    const int p = tid + THREADS * i, j = p >> 3, jj = j & 31;
    const int fw = fb + (j >> 5) * GATE_UP_F;
    src.w_ok[i] = fw < f;
    const int row = jj < 16 ? fw + jj : f + fw + jj - 16;
    src.w[i] = wq + (size_t)(src.w_ok[i] ? row : 0) * d + (p & 7) * 16;
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int p = tid + THREADS * i, r = p >> 4;
    src.x_ok[i] = r < live;
    const int tok = sorted_src[start + min(r, live - 1)] / slots;
    src.x[i] = x + (size_t)tok * d + (p & 15) * 8;
  }
  const int f0 = fb + (tid >> 5) * GATE_UP_F;
  const int n_live = (live + 7) >> 3;
  float acc[2][NT][4];
  product<NT, STAGES>(acc, Ring<NT, STAGES>(smem), src, d, n_live, f0 < f);
  if (f0 >= f) return;

  const float* sx = s + (size_t)ex * 2 * f;
  const float sg[2] = {sx[f0 + g], sx[f0 + g + 8]};
  const float su[2] = {sx[f + f0 + g], sx[f + f0 + g + 8]};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = nt * 8 + 2 * tig + (e & 1), half = e >> 1;
      if (r < live) {
        const float gv = rnd(acc[0][nt][e] * sg[half]);
        const float uv = rnd(acc[1][nt][e] * su[half]);
        const float act = rnd(gv / (1.f + expf(-gv)));
        h[(size_t)(start + r) * f + f0 + g + 8 * half] = __float2bfloat16_rn(act * uv);
      }
    }
}

template <int NT, int STAGES>
__global__ void __launch_bounds__(THREADS)
moe_down(const __nv_bfloat16* __restrict__ h, const int* __restrict__ sorted_src,
         const int* __restrict__ tile_expert, const int* __restrict__ tile_start,
         const int* __restrict__ offsets, const int8_t* __restrict__ q,
         const float* __restrict__ s, __nv_bfloat16* __restrict__ y, int d, int f,
         int experts) {
  extern __shared__ __align__(16) uint8_t smem[];
  int ex, start, live;
  if (!tile_of(tile_expert, tile_start, offsets, experts, 8 * NT, ex, start, live))
    return;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int db = blockIdx.y * ROWS;  // the block's first feature of D
  Sources<NT> src;
  const int8_t* wq = q + (size_t)ex * d * f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = tid + THREADS * i, row = db + (p >> 3);
    src.w_ok[i] = row < d;
    src.w[i] = wq + (size_t)(src.w_ok[i] ? row : 0) * f + (p & 7) * 16;
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int p = tid + THREADS * i, r = p >> 4;
    src.x_ok[i] = r < live;
    src.x[i] = h + (size_t)(start + min(r, live - 1)) * f + (p & 15) * 8;
  }
  const int d0 = db + (tid >> 5) * DOWN_F;
  const int n_live = (live + 7) >> 3;
  float acc[2][NT][4];
  product<NT, STAGES>(acc, Ring<NT, STAGES>(smem), src, f, n_live, d0 < d);
  if (d0 >= d) return;

  const float* sx = s + (size_t)ex * d;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = nt * 8 + 2 * tig + (e & 1);
      if (r < live) {
        __nv_bfloat16* out = y + (size_t)sorted_src[start + r] * d;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int c = d0 + 16 * t + g + 8 * (e >> 1);
          out[c] = __float2bfloat16_rn(acc[t][nt][e] * sx[c]);
        }
      }
    }
}

// -- routing -------------------------------------------------------------

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// the router holds n_routed + gate rows; bias (nullptr: softmax routing)
// the n_routed fp32 correction biases of sigmoid routing
__global__ void __launch_bounds__(ROUTE_THREADS)
moe_route(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ router,
          const float* __restrict__ bias, int* __restrict__ topi,
          float* __restrict__ topw, int n_tok, int d,
          int n_routed, int top_k, int n_shared, int norm, float scaling, int e0,
          int held, int gate) {
  constexpr int WARPS_R = ROUTE_THREADS / 32;
  constexpr int ITEMS = (MAX_ROUTED + 16) / 16 > WARPS_R ? (MAX_ROUTED + 16) / 16 : WARPS_R;
  __shared__ float part[ITEMS][16 * ROUTE_TOK];
  __shared__ float logits[ROUTE_TOK][MAX_ROUTED + 2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int t0 = blockIdx.x * ROUTE_TOK;
  const int n_rows = n_routed + gate;
  // item i: router rows 16 (i % tiles) .. + 15 over split i / tiles of D;
  // warp w takes items w, w + 32, ...
  const int tiles = (n_rows + 15) / 16;
  const int splits = tiles < WARPS_R ? WARPS_R / tiles : 1;
  const int chunks = d / 32, per = (chunks + splits - 1) / splits;
  for (int item = warp; item < tiles * splits; item += WARPS_R) {
    // logits of rows e0 + g, e0 + g + 8 for tokens t0 + 2 tig, + 1: within
    // a 32-column chunk lane tig holds columns 8 tig .. 8 tig + 7, k-step s
    // of them 4s .. 4s + 3
    const int r0 = 16 * (item % tiles), split = item / tiles;
    const int c0 = split * per, c1 = min(c0 + per, chunks);
    const __nv_bfloat16* pa = router + (size_t)min(r0 + g, n_rows - 1) * d + 8 * tig;
    const __nv_bfloat16* pb = router + (size_t)min(r0 + g + 8, n_rows - 1) * d + 8 * tig;
    const __nv_bfloat16* px = x + (size_t)min(t0 + g, n_tok - 1) * d + 8 * tig;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = c0; c < c1; ++c) {
      const int k0 = 32 * c;
      const uint4 va = ldg16(pa + k0), vb = ldg16(pb + k0), vx = ldg16(px + k0);
      const uint32_t a0[4] = {va.x, vb.x, va.y, vb.y};
      const uint32_t a1[4] = {va.z, vb.z, va.w, vb.w};
      ospo_mma::mma(acc, a0, vx.x, vx.y);
      ospo_mma::mma(acc, a1, vx.z, vx.w);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[item][(g + 8 * (e >> 1)) * ROUTE_TOK + 2 * tig + (e & 1)] = acc[e];
  }
  __syncthreads();
  // the splits' partial sums, added in split order
  for (int i = tid; i < ROUTE_TOK * n_rows; i += blockDim.x) {
    const int e = i % n_rows, t = i / n_rows;
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      v += part[sp * tiles + e / 16][(e % 16) * ROUTE_TOK + t];
    logits[t][e] = v;
  }
  __syncthreads();
  const int slots = top_k + n_shared;
  for (int t = warp; t < ROUTE_TOK; t += blockDim.x >> 5) {
    const int tok = t0 + t;
    if (tok >= n_tok) break;
    // p: what the top k is taken over, the softmax or sigmoid + bias; a
    // chosen expert's weight is its softmax, or its sigmoid formed again
    // from its logit (one register array, as 1024 threads leave 64 a thread)
    float p[MAX_ROUTED / 32];
    if (bias == nullptr) {
      float m = neg_inf();
#pragma unroll
      for (int j = 0; j < MAX_ROUTED / 32; ++j) {
        const int e = lane + 32 * j;
        p[j] = e < n_routed ? logits[t][e] : neg_inf();
        m = fmaxf(m, p[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_ROUTED / 32; ++j) {
        p[j] = lane + 32 * j < n_routed ? expf(p[j] - m) : 0.f;
        sum += p[j];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
      for (int j = 0; j < MAX_ROUTED / 32; ++j)
        p[j] = lane + 32 * j < n_routed ? p[j] / sum : neg_inf();
    } else {
#pragma unroll
      for (int j = 0; j < MAX_ROUTED / 32; ++j) {
        const int e = lane + 32 * j;
        p[j] = e < n_routed ? 1.f / (1.f + expf(-logits[t][e])) + bias[e] : neg_inf();
      }
    }
    float sel_w[MAX_TOP_K];
    int sel_i[MAX_TOP_K];
    float total = 0.f;
    for (int j = 0; j < top_k; ++j) {
      float bv = neg_inf();
      int bi = 1 << 30;
#pragma unroll
      for (int jj = 0; jj < MAX_ROUTED / 32; ++jj)
        if (p[jj] > bv) { bv = p[jj]; bi = lane + 32 * jj; }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
#pragma unroll
      for (int jj = 0; jj < MAX_ROUTED / 32; ++jj)
        if (lane + 32 * jj == bi) p[jj] = neg_inf();
      if (bias != nullptr) bv = 1.f / (1.f + expf(-logits[t][bi]));
      sel_w[j < MAX_TOP_K ? j : 0] = bv;
      sel_i[j < MAX_TOP_K ? j : 0] = bi;
      total += bv;
    }
    const float denom = bias == nullptr ? total : total + 1e-20f;
    if (lane < slots) {
      int id = held + lane - top_k;
      float wt = gate ? 1.f / (1.f + expf(-logits[t][n_routed])) : 1.f;
      for (int j = 0; j < top_k; ++j)
        if (j == lane) {
          const int local = sel_i[j] - e0;
          id = local >= 0 && local < held ? local : -1;
          wt = (norm ? sel_w[j] / denom : sel_w[j]) * scaling;
        }
      topi[(size_t)tok * slots + lane] = id;
      topw[(size_t)tok * slots + lane] = wt;
    }
  }
}

__global__ void __launch_bounds__(ALIGN_THREADS)
moe_align(const int* __restrict__ topi, int* __restrict__ counts,
          int* __restrict__ offsets, int* __restrict__ sorted_src,
          int* __restrict__ tile_expert, int* __restrict__ tile_start,
          int* __restrict__ rank, int rows, int experts, int bm, int n_tiles) {
  __shared__ int cnt[MAX_EXPERTS], off[MAX_EXPERTS + 1], t_incl[MAX_EXPERTS];
  const int tid = threadIdx.x;
  for (int e = tid; e < experts; e += blockDim.x) cnt[e] = 0;
  __syncthreads();
  for (int r = tid; r < rows; r += blockDim.x)
    if (topi[r] >= 0) rank[r] = atomicAdd(&cnt[topi[r]], 1);
  __syncthreads();
  if (tid < 32) {
    // exclusive scans of the counts and of the tiles: lane l owns a run of
    // experts, the runs' totals scanned across the warp
    const int per = (experts + 31) / 32, e0 = min(tid * per, experts),
              e1 = min(e0 + per, experts);
    int rsum = 0, tsum = 0;
    for (int e = e0; e < e1; ++e) { rsum += cnt[e]; tsum += (cnt[e] + bm - 1) / bm; }
    int rpre = rsum, tpre = tsum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int rv = __shfl_up_sync(0xffffffffu, rpre, o);
      const int tv = __shfl_up_sync(0xffffffffu, tpre, o);
      if (tid >= o) { rpre += rv; tpre += tv; }
    }
    rpre -= rsum;
    tpre -= tsum;
    for (int e = e0; e < e1; ++e) {
      off[e] = rpre;
      rpre += cnt[e];
      tpre += (cnt[e] + bm - 1) / bm;
      t_incl[e] = tpre;
    }
    if (tid == 31) off[experts] = rpre;
  }
  __syncthreads();
  for (int e = tid; e <= experts; e += blockDim.x) {
    offsets[e] = off[e];
    if (e < experts) counts[e] += cnt[e];
  }
  for (int t = tid; t < n_tiles; t += blockDim.x) {
    // te: experts whose tiles end at or before t (experts past the last)
    int lo = 0, hi = experts;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (t_incl[mid] <= t) lo = mid + 1; else hi = mid;
    }
    const int e = min(lo, experts - 1);
    const int first = t_incl[e] - (cnt[e] + bm - 1) / bm;
    tile_expert[t] = lo;
    tile_start[t] = off[e] + (t - first) * bm;
  }
  for (int r = tid; r < rows; r += blockDim.x)
    if (topi[r] >= 0) sorted_src[off[topi[r]] + rank[r]] = r;
}

}  // namespace

// x: [N, D] bf16 tokens; router: [E + gate, D] bf16 (E <= 512), the shared
// gate's row last where gate is 1; bias: nullptr (softmax routing) or [E]
// fp32 (sigmoid routing with that correction bias); topi, topw: [N, top_k + n_shared] int32
// and fp32, the routed slots (ids among the held experts [e0, e0 + held),
// -1 for the others) then the shared experts' (ids held .. held + n_shared
// - 1, weight 1 or the gate's sigmoid).  D a multiple of 32, top_k <= 16.
// Returns a cudaError_t.
extern "C" int ospo_moe_route(const void* x, const void* router, const float* bias,
                              int* topi, float* topw,
                              int n_tok, int d, int n_routed, int top_k, int n_shared,
                              int norm, float scaling, int e0, int held, int gate,
                              void* stream) {
  if (n_routed > MAX_ROUTED || top_k > MAX_TOP_K || top_k + n_shared > 32 || d % 32 ||
      e0 < 0 || held <= 0 || e0 + held > n_routed)
    return cudaErrorInvalidValue;
  const dim3 grid((n_tok + ROUTE_TOK - 1) / ROUTE_TOK);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* rb = static_cast<const __nv_bfloat16*>(router);
  moe_route<<<grid, ROUTE_THREADS, 0, st>>>(xb, rb, bias, topi, topw, n_tok, d, n_routed, top_k,
                                            n_shared, norm, scaling, e0, held, gate);
  return cudaGetLastError();
}

// topi: [rows] int32 expert ids (-1: no expert's); counts: [experts] int32, each expert's
// rows added; offsets: [experts + 1]; sorted_src, rank: [rows] (rank is
// scratch); tile_expert, tile_start: [n_tiles], n_tiles = rows / bm +
// experts.  experts <= 1024.  Returns a cudaError_t.
extern "C" int ospo_moe_align(const int* topi, int* counts, int* offsets, int* sorted_src,
                              int* tile_expert, int* tile_start, int* rank, int rows,
                              int experts, int bm, int n_tiles, void* stream) {
  if (experts > MAX_EXPERTS) return cudaErrorInvalidValue;
  moe_align<<<1, ALIGN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      topi, counts, offsets, sorted_src, tile_expert, tile_start, rank, rows, experts,
      bm, n_tiles);
  return cudaGetLastError();
}

namespace {

// Launch a grouped GEMM with its ring in dynamic shared memory (the limit
// raised on its first launch, which comes before any capture: the engine's
// first step runs eagerly).
template <int NT, int STAGES, typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, cudaStream_t stream, Args... args) {
  static bool ready = false;
  constexpr int bytes = Ring<NT, STAGES>::BYTES;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  kernel<<<grid, THREADS, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// stages of the ring: 3 at decode (16-row tiles), 2 at prefill (64)
constexpr int DECODE_STAGES = 3, PREFILL_STAGES = 2;

}  // namespace

// x: [N, D] bf16 tokens; sorted_src: [rows] int32, the (token, slot) index
// of each grouped row; tile_expert, tile_start: [n_tiles] int32; offsets:
// [experts + 1] int32; q: [experts, 2F, D] int8 (gate rows, then up); s:
// [experts, 2F] fp32; h: [rows, F] bf16 in grouped order.  block_m 16 or
// 64 (the table's tile height); D a multiple of 32, F of 16.  Returns a
// cudaError_t.
extern "C" int ospo_moe_gate_up(const void* x, const int* sorted_src,
                                const int* tile_expert, const int* tile_start,
                                const int* offsets, const int8_t* q, const float* s,
                                void* h, int n_tiles, int block_m, int d, int f,
                                int experts, int slots, void* stream) {
  const dim3 grid(n_tiles, (f + WARPS * GATE_UP_F - 1) / (WARPS * GATE_UP_F));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  if (block_m == 16)
    return launch<2, DECODE_STAGES>(moe_gate_up<2, DECODE_STAGES>, grid, st, xb,
                                    sorted_src, tile_expert, tile_start, offsets, q, s,
                                    hb, d, f, experts, slots);
  if (block_m == 64)
    return launch<8, PREFILL_STAGES>(moe_gate_up<8, PREFILL_STAGES>, grid, st, xb,
                                     sorted_src, tile_expert, tile_start, offsets, q, s,
                                     hb, d, f, experts, slots);
  return cudaErrorInvalidValue;
}

// h: [rows, F] bf16 in grouped order; q: [experts, D, F] int8; s: [experts,
// D] fp32; y: [rows, D] bf16 at each row's (token, slot) index.  D a
// multiple of 32, F of 16.  Returns a cudaError_t.
extern "C" int ospo_moe_down(const void* h, const int* sorted_src,
                             const int* tile_expert, const int* tile_start,
                             const int* offsets, const int8_t* q, const float* s,
                             void* y, int n_tiles, int block_m, int d, int f,
                             int experts, void* stream) {
  const dim3 grid(n_tiles, (d + ROWS - 1) / ROWS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* hb = static_cast<const __nv_bfloat16*>(h);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (block_m == 16)
    return launch<2, DECODE_STAGES>(moe_down<2, DECODE_STAGES>, grid, st, hb, sorted_src,
                                    tile_expert, tile_start, offsets, q, s, yb, d, f,
                                    experts);
  if (block_m == 64)
    return launch<8, PREFILL_STAGES>(moe_down<8, PREFILL_STAGES>, grid, st, hb,
                                     sorted_src, tile_expert, tile_start, offsets, q, s,
                                     yb, d, f, experts);
  return cudaErrorInvalidValue;
}
