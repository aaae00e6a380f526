// W4A16 decode matmul for Hopper (sm_90a), shared by int4_matmul_row.cu and
// int4_matmul_group.cu: y[M, F] = x[M, D] . W^T with W packed two output rows
// per byte (q4 [F/2, D] int8: row i in the low nibble, row i + F/2 in the
// high nibble, both sign-extended).
//
// What bounds it: at the serving point (M = 48 rows of x, 24 CFG pairs) the
// product does 2 * 48 = 96 FLOP per weight and ~192 per packed byte, under
// the H100's ~295 bf16 FLOP per byte of HBM: by the data sheet, reading the
// packed weights is the bound (w_gate: 22.5 MB, 7.2 us at 3.35 TB/s).  On the
// card the bf16 body stays well above it (PERF.md): per 128-column chunk a
// warp issues ~8 integer instructions per 32-bit word of q4 for the decode,
// 48 mma.sync and its share of the copies, and with four warps per SM
// sub-partition the integer pipe sets the pace (in trials, halving the
// mma.sync or dropping every read of x from shared memory left the time as
// it was; dropping the copies shortened it).  Two bodies:
//
// bf16 x, on the tensor cores (int4_decode_mma):
//  - operands swapped, y^T = W . x^T: the decoded weight rows are the A
//    operand of mma.sync m16n8k16 (16 output features a tile), x is B (8 rows
//    of x an n8 tile, M = 48 is 6 tiles); one packed row feeds an A tile of
//    the low plane and one of the high plane.  fp32 accumulators stay in
//    registers: a warp owns 16 packed rows, 2 planes x NT n-tiles x 4 floats
//    (NT = 2, 4, 6 or 8, a template parameter from M);
//  - nibbles become bf16 in registers with integer operations, no
//    conversion unit: a byte permute puts bytes (0, 2, 1, 3) of a word in
//    order, lop3 takes two nibbles into the mantissas of 0x4300 (128.0) with
//    bit 3 flipped (x ^ 8 = nibble + 8), and one bf16x2 subtraction of 136
//    leaves the nibble's value, exactly;
//  - groups: w = r(nib * r(gs)) by one bf16x2 multiply of the decoded nibbles
//    by the bf16-rounded scale, before the product, so every w is the plain
//    version's bit for bit;
//  - no repacking of q4 and no ldmatrix: k is permuted inside each chunk, the
//    same for both operands, so that lane (g, tig) takes its A fragments from
//    its own 16 contiguous bytes of rows g and g + 8 (k-step s uses 4s ..
//    4s + 3) and its B fragments from the same 16 columns of x row g, x's
//    natural layout;
//  - bytes in flight: q4 and x stream through a 3-stage ring of 128-column
//    chunks in shared memory with 16-byte cp.async from every thread (8 KB
//    of weights and up to 16 KB of x a stage, x in bf16); each thread copies
//    the same pieces of every chunk from two base pointers and a mask of
//    valid rows, so a chunk's copies cost a few instructions and no branch; a
//    block is 8 warps, 4 row groups (64 packed rows) x the 2 halves of each
//    chunk, over 64 rows of x, so x is read from L2 once per 64 packed rows;
//  - split-K without a second pass: the blocks of one output tile form a
//    thread-block cluster of 1 to 8 blocks along D, as many as the card holds
//    in one wave (the wrapper asks cudaOccupancyMaxActiveClusters: a second
//    wave doubled the time); each block adds its two halves' sums in shared
//    memory and sends each row of x's sums to the block that owns that row
//    (st.async into its shared memory, counted by its mbarrier); the owner
//    sums the ranks in rank order: no device scratch, no atomics, no
//    GPU-scope fence, deterministic;
//  - the sums differ from the plain version only in their order.
//
// fp32 x, on the CUDA cores (int4_decode_matmul, the first design):
//  - a block owns 64 packed rows (128 output columns) x 64 rows of x, over
//    one split of D; 256 threads, each with a 4 x 8 tile of fp32 sums; per
//    stage of 32 columns, 128 threads read the packed bytes with one 16-byte
//    load each, sign-extend both nibbles and store both planes to shared
//    memory as fp32, x's stage beside it, transposed;
//  - D is split across blocks so that the grid fills the card; with more
//    than one split, fp32 partial sums [n_split, M, F] are summed in split
//    order by a second pass, which also rounds (and, per row, scales).
// Both write output columns i and i + F/2 straight to y[:, i] and
// y[:, F/2 + i].  Products of two bf16 values (or of an fp32 x and a small
// integer) are exact in fp32, so the kernels and the plain version differ
// only in the order of the fp32 sums.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace ospo_int4 {

// -- fp32 body (CUDA cores) ---------------------------------------------------

constexpr int THREADS = 256;
constexpr int MT = 64;            // rows of x per block
constexpr int NP = 64;            // packed rows per block (2 * NP output columns)
constexpr int KC = 32;            // columns per shared-memory stage
constexpr int XS_LD = MT + 4;     // padded leading dims of the stage buffers
constexpr int WS_LD = 2 * NP + 4;
constexpr int W_VECS = NP * KC / 16;  // 16-byte weight loads per stage
constexpr int MIN_ALIGN = 16;     // D and the group size: multiples of this

template <typename XT> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <typename XT> __device__ __forceinline__ XT from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes of fp32 x → 4 floats
__device__ __forceinline__ void unpack_x(const uint4& u, float* out, const float*) {
  out[0] = __uint_as_float(u.x); out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z); out[3] = __uint_as_float(u.w);
}

// Output value from an fp32 sum: per row r(r(acc) * r(s[f])), per group r(acc)
template <typename XT, bool GROUP>
__device__ __forceinline__ XT finish(float acc, const float* __restrict__ s, int f) {
  if (GROUP) return from_f<XT>(acc);
  return from_f<XT>(rnd<XT>(acc) * rnd<XT>(s[f]));
}

template <typename XT, bool GROUP>
__global__ void __launch_bounds__(THREADS)
int4_decode_matmul(const XT* __restrict__ x, const int8_t* __restrict__ q4,
                   const float* __restrict__ scale, XT* __restrict__ y,
                   float* __restrict__ part, int m_rows, int f2, int d,
                   int n_groups, int dsplit, int nsplit) {
  constexpr int VEC = 16 / sizeof(XT);            // x elements per 16 bytes
  constexpr int XV = MT * KC / VEC / THREADS;     // x loads per thread
  __shared__ __align__(16) float xs[KC * XS_LD];
  __shared__ __align__(16) float ws[KC * WS_LD];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * NP;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int kbeg = split * dsplit;
  const int kend = min(d, kbeg + dsplit);
  const int f = 2 * f2;
  const int group = GROUP ? d / n_groups : 1;

  uint4 xr[XV], wr;
  float gl = 0.f, gh = 0.f;

  auto load_stage = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int v = tid + i * THREADS;
      const int m = v / (KC / VEC), c = (v % (KC / VEC)) * VEC;
      const int row = m0 + m, col = k0 + c;
      xr[i] = (row < m_rows && col < kend)
                  ? *reinterpret_cast<const uint4*>(x + (size_t)row * d + col)
                  : make_uint4(0, 0, 0, 0);
    }
    if (tid < W_VECS) {
      const int r = tid / (KC / 16), c = (tid % (KC / 16)) * 16;
      const int prow = r0 + r, col = k0 + c;
      const bool ok = prow < f2 && col < kend;
      wr = ok ? *reinterpret_cast<const uint4*>(q4 + (size_t)prow * d + col)
              : make_uint4(0, 0, 0, 0);
      if (GROUP && ok) {
        const int g = col / group;  // the 16 columns lie in one group
        gl = scale[(size_t)prow * n_groups + g];
        gh = scale[(size_t)(prow + f2) * n_groups + g];
      }
    }
  };

  auto store_stage = [&]() {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int v = tid + i * THREADS;
      const int m = v / (KC / VEC), c = (v % (KC / VEC)) * VEC;
      float vals[VEC];
      unpack_x(xr[i], vals, x);
#pragma unroll
      for (int e = 0; e < VEC; ++e) xs[(c + e) * XS_LD + m] = vals[e];
    }
    if (tid < W_VECS) {
      const int r = tid / (KC / 16), c = (tid % (KC / 16)) * 16;
      const uint32_t words[4] = {wr.x, wr.y, wr.z, wr.w};
      const float sl = rnd<XT>(gl), sh = rnd<XT>(gh);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          // sign-extend each nibble with an arithmetic shift of the word
          const int lo = static_cast<int>(words[j] << (28 - 8 * b)) >> 28;
          const int hi = static_cast<int>(words[j] << (24 - 8 * b)) >> 28;
          float wl = (float)lo, wh = (float)hi;
          if (GROUP) {
            wl = rnd<XT>(wl * sl);
            wh = rnd<XT>(wh * sh);
          }
          const int kk = c + 4 * j + b;
          ws[kk * WS_LD + r] = wl;
          ws[kk * WS_LD + NP + r] = wh;
        }
      }
    }
  };

  const int ty = tid / 16, tx = tid % 16;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_stage(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += KC) {
    store_stage();
    __syncthreads();
    if (k0 + KC < kend) load_stage(k0 + KC);
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk * XS_LD + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = ws[kk * WS_LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= m_rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j;               // j < 4: low plane, else high
      const int r = r0 + (n % NP);
      if (r >= f2) continue;
      const int col = n < NP ? r : f2 + r;
      if (nsplit == 1)
        y[(size_t)m * f + col] = finish<XT, GROUP>(acc[i][j], scale, col);
      else
        part[((size_t)split * m_rows + m) * f + col] = acc[i][j];
    }
  }
}

// Second pass: sum the splits' partials in split order, round (and scale)
template <typename XT, bool GROUP>
__global__ void __launch_bounds__(THREADS)
int4_combine(const float* __restrict__ part, const float* __restrict__ scale,
             XT* __restrict__ y, int m_rows, int f, int nsplit) {
  const size_t total = (size_t)m_rows * f;
  for (size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * THREADS) {
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s) acc += part[(size_t)s * total + idx];
    y[idx] = finish<XT, GROUP>(acc, scale, (int)(idx % f));
  }
}

template <typename XT, bool GROUP>
int launch(const void* x, const int8_t* q4, const float* scale, void* y,
           float* part, int m, int f2, int d, int n_groups, int dsplit,
           int nsplit, cudaStream_t st) {
  const dim3 grid((f2 + NP - 1) / NP, nsplit, (m + MT - 1) / MT);
  int4_decode_matmul<XT, GROUP><<<grid, THREADS, 0, st>>>(
      static_cast<const XT*>(x), q4, scale, static_cast<XT*>(y), part, m, f2,
      d, n_groups, dsplit, nsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  const size_t want = ((size_t)m * 2 * f2 + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 1056 ? want : 1056);  // 8 per SM at most
  int4_combine<XT, GROUP><<<blocks, THREADS, 0, st>>>(
      part, scale, static_cast<XT*>(y), m, 2 * f2, nsplit);
  return (int)cudaGetLastError();
}

// -- bf16 body (tensor cores) -------------------------------------------------
// (internal linkage: launch_mma's one-time flag must not be shared, as a
// unique global symbol, with another library built from this header)
namespace {

namespace tc {
constexpr int WARPS = 8;               // 4 row groups x 2 halves of each chunk
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 64;               // packed rows per block, 16 a row group
constexpr int MT = 64;                 // rows of x per block: up to 8 n8 tiles
constexpr int KC = 128;                // columns per stage, 64 a warp: 4 k16 steps
constexpr int STAGES = 3;
constexpr int Q_LD = 192;              // bytes a q4 row: 16-byte reads without bank conflicts
constexpr int X_LD = 136;              // bf16 an x row (272 bytes): likewise
constexpr int Q_BYTES = ROWS * Q_LD;
constexpr int STAGE_BYTES = Q_BYTES + MT * X_LD * 2;
constexpr int RING = STAGES * STAGE_BYTES;
constexpr int P_LD = ROWS + 4;         // fp32 sums [m][plane][row], rows 16-byte aligned
constexpr int PART = MT * 2 * P_LD * 4;
constexpr int MAX_SPLIT = 8;           // blocks of a cluster (portable limit)
// the cluster's sums of this block's rows of x: nsplit slots of
// ceil(MT / nsplit) rows, at most MT + MAX_SPLIT - 1 rows in all
constexpr int RECV = (MT + MAX_SPLIT) * 2 * ROWS * 4;
constexpr int SMEM = RING + 16;        // + the receive buffer's mbarrier
static_assert(PART + RECV <= RING, "the block's sums and the receive buffer reuse the ring");
static_assert(THREADS == 4 * ROWS, "two rows of x, one output column a thread");
}  // namespace tc

// Distributed shared memory (sm_90): a block's sums go to the block of its
// cluster that owns their rows of x with 16-byte st.async, which count down
// the owner's mbarrier; the owner waits for the bytes it expects.  One
// relaxed cluster barrier, armed at the start and awaited before the first
// st.async, makes every block's mbarrier initialisation visible.  No
// GPU-scope fence is needed.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t smem_addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(smem_addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void mbar_init_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               "fence.mbarrier_init.release.cluster;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void st_async16(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
               "[%0], {%1, %2, %3, %4}, [%5];\n"
               :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile("{\n.reg .pred done;\nWAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
               "@!done bra WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

// Two nibbles of w (bits s..s+3 and 16+s..16+s+3) as a bf16x2 of their int4
// values: (w >> s) & 0x000F000F lands them in the mantissa of 128.0 (0x4300)
// with bit 3 flipped, 128 + (n ^ 8) = 136 + n, then 136 is subtracted.
// Every step is exact.
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t w, int s) {
  uint32_t t;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n"   // (a & b) ^ c
      : "=r"(t) : "r"(w >> s), "r"(0x000F000Fu), "r"(0x43084308u));
  const uint32_t k136 = 0x43084308u;        // bf16x2 (136, 136)
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&t),
                             *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, __nv_bfloat162 s) {
  __nv_bfloat162 v = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a), s);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of one k16 step for both planes from the lane's word of
// rows g (wa) and g + 8 (wb), columns 4s .. 4s + 3 of its 8 bytes: a0 (row
// g, k 2tig..+1) <- columns 4s, 4s+1; a2 (k 2tig+8..+9) <- 4s+2, 4s+3; a1,
// a3 the same of row g + 8.  Bytes (0, 2, 1, 3) of each word first, so each
// nibble pair is one column pair.  sc: the group scales of low row g, low
// g + 8, high g, high g + 8.
template <bool GROUP>
__device__ __forceinline__ void a_frags(uint32_t wa, uint32_t wb,
                                        const __nv_bfloat162 (&sc)[4],
                                        uint32_t (&lo)[4], uint32_t (&hi)[4]) {
  const uint32_t pa = __byte_perm(wa, 0, 0x3120);
  const uint32_t pb = __byte_perm(wb, 0, 0x3120);
  lo[0] = nibbles_bf16(pa, 0);
  lo[1] = nibbles_bf16(pb, 0);
  lo[2] = nibbles_bf16(pa, 8);
  lo[3] = nibbles_bf16(pb, 8);
  hi[0] = nibbles_bf16(pa, 4);
  hi[1] = nibbles_bf16(pb, 4);
  hi[2] = nibbles_bf16(pa, 12);
  hi[3] = nibbles_bf16(pb, 12);
  if (GROUP) {  // w = r(nib * r(gs))
    lo[0] = mul_bf16x2(lo[0], sc[0]);
    lo[2] = mul_bf16x2(lo[2], sc[0]);
    lo[1] = mul_bf16x2(lo[1], sc[1]);
    lo[3] = mul_bf16x2(lo[3], sc[1]);
    hi[0] = mul_bf16x2(hi[0], sc[2]);
    hi[2] = mul_bf16x2(hi[2], sc[2]);
    hi[1] = mul_bf16x2(hi[1], sc[3]);
    hi[3] = mul_bf16x2(hi[3], sc[3]);
  }
}

// grid (nsplit, ceil(F/2 / 64), ceil(M / 64)), clusters of (nsplit, 1, 1):
// block (s, i, j) sums chunks [s * C / nsplit, (s + 1) * C / nsplit) of D's
// C 64-column chunks for packed rows [64 i, 64 i + 64) and rows of x
// [64 j, 64 j + 64); warp (h, rg) takes columns 32 h .. 32 h + 31 of each
// chunk for rows 16 rg .. 16 rg + 15.  NT: n8 tiles of x a block holds
// (2, 4, 6 or 8; M = 48 is 6; with 8, 64 accumulators a thread, one block
// an SM, so no register spills).  The two halves' sums are added in shared
// memory, then the cluster sums its blocks' partials in rank order.
template <bool GROUP, int NT>
__global__ void __launch_bounds__(tc::THREADS, NT <= 6 ? 2 : 1)
int4_decode_mma(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q4,
                const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                int m_rows, int f2, int d, int n_groups, int group, int nsplit) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int rg = warp & 3, half = warp >> 2;
  const int split = blockIdx.x;               // the block's rank in its cluster
  const int r0 = blockIdx.y * tc::ROWS, m0 = blockIdx.z * tc::MT;
  const int mt = min(tc::MT, m_rows - m0);    // rows of x in this tile
  const int n_tiles = min(NT, (mt + 7) >> 3);
  const int n_chunks = (d + tc::KC - 1) / tc::KC;
  const int c_beg = (int)((long long)split * n_chunks / nsplit);
  const int c_end = (int)((long long)(split + 1) * n_chunks / nsplit);
  const uint32_t ring = ospo_mma::smem_u32(smem);
  const uint32_t recv = ring + tc::PART, bar = ring + tc::RING;
  // the rows of x this block owns in the cluster: m = split + nsplit * ml,
  // below the n8 tiles every block of the cluster sums; 512 bytes each from
  // every block
  const int per_rank = (tc::MT + nsplit - 1) / nsplit;
  const int owned = (n_tiles * 8 - split + nsplit - 1) / nsplit;
  if (tid == 0) mbar_init_expect(bar, (uint32_t)(nsplit * owned * 2 * tc::ROWS * 4));

  // chunk c into ring slot `slot`: 64 packed rows x 128 bytes, then the
  // tile's rows of x (8 per n-tile) x 128 bf16, in 16-byte pieces; zeros past
  // F/2, M and D.  Thread t copies the piece at column 16 (t % 8) of q4 rows
  // t / 8 and t / 8 + 32, and the piece at column 8 (t % 16) of x rows
  // t / 16 + 16 j: two base pointers and a mask of valid rows, set once, so
  // the copies cost a few instructions a chunk and never branch.
  constexpr int XJ = NT * 8 / 16 + (NT * 8 % 16 ? 1 : 0);
  const int qc = (tid & 7) * 16, qr = tid >> 3, xc = (tid & 15) * 8, xr = tid >> 4;
  unsigned valid = 0;   // bits 0, 1: q4 rows qr, qr + 32; bit 2 + j: x row xr + 16 j
#pragma unroll
  for (int j = 0; j < 2; ++j) valid |= (unsigned)(r0 + qr + 32 * j < f2) << j;
#pragma unroll
  for (int j = 0; j < XJ; ++j) valid |= (unsigned)(xr + 16 * j < mt) << (2 + j);
  const int8_t* q_base = q4 + (size_t)(r0 + qr) * d + qc;
  const __nv_bfloat16* x_base = x + (size_t)(m0 + xr) * d + xc;
  const uint32_t q_dst = qr * tc::Q_LD + qc, x_dst = tc::Q_BYTES + (xr * tc::X_LD + xc) * 2;
  auto load_stage = [&](int c, int slot) {
    const uint32_t base = ring + slot * tc::STAGE_BYTES;
    const int col0 = c * tc::KC;
    const bool q_col = col0 + qc < d, x_col = col0 + xc < d;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool ok = q_col && (valid >> j & 1);
      ospo_mma::cp_async16(base + q_dst + j * 32 * tc::Q_LD,
                           ok ? q_base + (size_t)j * 32 * d + col0 : q4, ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < XJ; ++j) {
      const bool ok = x_col && (valid >> (2 + j) & 1);
      ospo_mma::cp_async16(base + x_dst + j * 16 * tc::X_LD * 2,
                           ok ? x_base + (size_t)j * 16 * d + col0 : x, ok ? 16 : 0);
    }
  };

  // the lane's four group scales (rows g and g + 8 of its row group, low and
  // high plane) of the group that holds its 16 columns of a chunk, read one
  // chunk ahead; the group advances with the columns, without a division
  const int ra = r0 + rg * 16 + g, rb = ra + 8;
  const int lcol = half * 64 + 16 * tig;      // the lane's 16 columns of a chunk
  // one pointer that walks the groups of row g's low plane, and the
  // distances to row g + 8 and to the high plane
  const int ra_ = min(ra, f2 - 1), rb_ = min(rb, f2 - 1);
  const int s_rb = (rb_ - ra_) * n_groups, s_hi = f2 * n_groups;
  const float* s_ptr = scale + (size_t)ra_ * n_groups;
  int s_ofs = 0;                              // the next chunk's column in its group
  if (GROUP) {
    const int col = c_beg * tc::KC + lcol;
    s_ptr += col / group;
    s_ofs = col % group;
  }
  auto load_scales = [&](int c, float (&s)[4]) {
    const bool ok = c * tc::KC + lcol < d;
    s[0] = ok ? __ldg(s_ptr) : 0.f;
    s[1] = ok ? __ldg(s_ptr + s_rb) : 0.f;
    s[2] = ok ? __ldg(s_ptr + s_hi) : 0.f;
    s[3] = ok ? __ldg(s_ptr + s_rb + s_hi) : 0.f;
    for (s_ofs += tc::KC; s_ofs >= group; s_ofs -= group) ++s_ptr;
  };

  float acc[2][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.f;

  float s_cur[4] = {0.f, 0.f, 0.f, 0.f}, s_next[4] = {0.f, 0.f, 0.f, 0.f};
  if (GROUP) load_scales(c_beg, s_cur);
#pragma unroll
  for (int s = 0; s < tc::STAGES - 1; ++s) {
    if (c_beg + s < c_end) load_stage(c_beg + s, s);
    ospo_mma::cp_async_commit();
  }

  for (int c = c_beg; c < c_end; ++c) {
    const int it = c - c_beg;
    ospo_mma::cp_async_wait<tc::STAGES - 2>();
    __syncthreads();   // chunk c has landed; every warp is done with chunk c - 1
    if (c + tc::STAGES - 1 < c_end)
      load_stage(c + tc::STAGES - 1, (it + tc::STAGES - 1) % tc::STAGES);
    ospo_mma::cp_async_commit();
    if (GROUP && c + 1 < c_end) load_scales(c + 1, s_next);

    const unsigned char* qs = smem + (it % tc::STAGES) * tc::STAGE_BYTES;
    const unsigned char* xs = qs + tc::Q_BYTES;
    const uint4 wa = *reinterpret_cast<const uint4*>(qs + (rg * 16 + g) * tc::Q_LD + lcol);
    const uint4 wb = *reinterpret_cast<const uint4*>(qs + (rg * 16 + g + 8) * tc::Q_LD + lcol);
    const uint32_t wav[4] = {wa.x, wa.y, wa.z, wa.w}, wbv[4] = {wb.x, wb.y, wb.z, wb.w};
    __nv_bfloat162 sc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i] = __float2bfloat162_rn(s_cur[i]);
#pragma unroll
    for (int sh = 0; sh < 2; ++sh) {   // columns 8 sh .. 8 sh + 7 of the lane's 16
      uint4 xv[NT];    // B fragments: x row nt * 8 + g, those 8 columns
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)   // rows past M are zeros: no guard
        xv[nt] = *reinterpret_cast<const uint4*>(
            xs + ((nt * 8 + g) * tc::X_LD + lcol + 8 * sh) * 2);
      uint32_t lo[2][4], hi[2][4];
      a_frags<GROUP>(wav[2 * sh], wbv[2 * sh], sc, lo[0], hi[0]);
      a_frags<GROUP>(wav[2 * sh + 1], wbv[2 * sh + 1], sc, lo[1], hi[1]);
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t b0 = s ? xv[nt].z : xv[nt].x, b1 = s ? xv[nt].w : xv[nt].y;
          ospo_mma::mma(acc[0][nt], lo[s], b0, b1);
          ospo_mma::mma(acc[1][nt], hi[s], b0, b1);
        }
    }
    if (GROUP) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s_cur[i] = s_next[i];
    }
  }
  ospo_mma::cp_async_wait<0>();
  __syncthreads();   // the ring is free: the other blocks may write into it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  cluster_arrive_relaxed();

  // C fragment: c0 c1 = (feature g, x rows 2 tig, 2 tig + 1), c2 c3 = feature
  // g + 8.  The second half's sums go to the ring, the first half adds its
  // own: the block's sums [m][plane][feature] for its split of D.
  float* part = reinterpret_cast<float*>(smem);
  for (int h = 1; h >= 0; --h) {
    if (half == h) {
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (nt < n_tiles)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = rg * 16 + g + (e >> 1) * 8;
              const int m = nt * 8 + 2 * tig + (e & 1);
              float* slot = part + (m * 2 + p) * tc::P_LD + row;
              *slot = h ? acc[p][nt][e] : acc[p][nt][e] + *slot;
            }
    }
    __syncthreads();
  }

  // the thread's output feature in the sum below, and its row scale
  const int p = (tid / tc::ROWS) & 1, row = tid % tc::ROWS, r = r0 + row;
  const int col = p ? f2 + r : r;
  const float s_col = !GROUP && r < f2 ? scale[col] : 0.f;

  // each row of x to the block that owns it (m % nsplit), into slot
  // [this rank][m / nsplit][plane][feature] of its receive buffer, once
  // every block of the cluster is done with its ring
  cluster_wait();
  for (int i = tid; i < n_tiles * 8 * 32; i += tc::THREADS) {
    const int m = i >> 5, p = (i >> 4) & 1, q = (i & 15) * 4;
    const float4 v = *reinterpret_cast<const float4*>(part + (m * 2 + p) * tc::P_LD + q);
    const int owner = m % nsplit;
    const int slot = ((split * per_rank + m / nsplit) * 2 + p) * tc::ROWS + q;
    st_async16(cluster_addr(recv + slot * 4, owner), v, cluster_addr(bar, owner));
  }
  mbar_wait(bar, 0);

  // this block's rows of x: thread t takes output feature t % 64 of plane
  // (t / 64) % 2 for every other owned row and sums the ranks' partials in
  // rank order
  const float* got = reinterpret_cast<const float*>(smem + tc::PART);
  if (r < f2) {
    for (int ml = tid >> 7; ml * nsplit + split < mt; ml += 2) {
      float sum = got[(ml * 2 + p) * tc::ROWS + row];
      for (int k = 1; k < nsplit; ++k)
        sum += got[((k * per_rank + ml) * 2 + p) * tc::ROWS + row];
      y[(size_t)(m0 + ml * nsplit + split) * 2 * f2 + col] =
          GROUP ? from_f<__nv_bfloat16>(sum)
                : from_f<__nv_bfloat16>(rnd<__nv_bfloat16>(sum) * rnd<__nv_bfloat16>(s_col));
    }
  }
}

// the launch configuration of the tensor-core body (attrs: one slot)
inline cudaLaunchConfig_t mma_config(int m, int f2, int nsplit, cudaStream_t st,
                                     cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, (f2 + tc::ROWS - 1) / tc::ROWS, (m + tc::MT - 1) / tc::MT);
  cfg.blockDim = dim3(tc::THREADS);
  cfg.dynamicSmemBytes = tc::SMEM;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool GROUP, int NT>
cudaError_t allow_smem() {
  static bool ready = false;
  if (ready) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(int4_decode_mma<GROUP, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         tc::SMEM);
  ready = err == cudaSuccess;
  return err;
}

template <bool GROUP, int NT>
int launch_mma(const void* x, const int8_t* q4, const float* scale, void* y,
               int m, int f2, int d, int n_groups, int nsplit, cudaStream_t st) {
  cudaError_t err = allow_smem<GROUP, NT>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = mma_config(m, f2, nsplit, st, attr);
  err = cudaLaunchKernelEx(
      &cfg, int4_decode_mma<GROUP, NT>, static_cast<const __nv_bfloat16*>(x), q4,
      scale, static_cast<__nv_bfloat16*>(y), m, f2, d, n_groups, d / n_groups, nsplit);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// how many clusters of nsplit blocks the card holds at once
template <bool GROUP, int NT>
int clusters_of(int nsplit) {
  cudaError_t err = allow_smem<GROUP, NT>();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = mma_config(1, 1, nsplit, nullptr, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, int4_decode_mma<GROUP, NT>, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

// the tensor-core body with as many n8 tiles as M's first x tile needs
template <bool GROUP>
int launch_mma_rows(const void* x, const int8_t* q4, const float* scale, void* y,
                    int m, int f2, int d, int n_groups, int nsplit, cudaStream_t st) {
  const int tiles = (min(m, tc::MT) + 7) / 8;
  if (tiles <= 2)
    return launch_mma<GROUP, 2>(x, q4, scale, y, m, f2, d, n_groups, nsplit, st);
  if (tiles <= 4)
    return launch_mma<GROUP, 4>(x, q4, scale, y, m, f2, d, n_groups, nsplit, st);
  if (tiles <= 6)
    return launch_mma<GROUP, 6>(x, q4, scale, y, m, f2, d, n_groups, nsplit, st);
  return launch_mma<GROUP, 8>(x, q4, scale, y, m, f2, d, n_groups, nsplit, st);
}

}  // namespace

// x_dtype 0 = float32: the CUDA-core body over nsplit splits of dsplit
// columns (a multiple of 32), partials in `part` [nsplit, M, F] when
// nsplit > 1.  x_dtype 1 = bfloat16: the tensor-core body over clusters of
// nsplit blocks (1 to 8, at most D's 64-column chunks); dsplit and part are
// not read.  Returns a cudaError_t (0 = success).
template <bool GROUP>
int dispatch(const void* x, const int8_t* q4, const float* scale, void* y,
             float* part, int m, int f2, int d, int n_groups, int dsplit,
             int nsplit, int x_dtype, void* stream) {
  if (m < 1 || m > 256 || f2 < 1 || d < 1 || d % MIN_ALIGN)
    return (int)cudaErrorInvalidValue;
  if (GROUP && (n_groups < 1 || d % n_groups || (d / n_groups) % MIN_ALIGN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    if (dsplit < 1 || dsplit % KC || nsplit < 1 ||
        (long long)(nsplit - 1) * dsplit >= d || (long long)nsplit * dsplit < d)
      return (int)cudaErrorInvalidValue;
    return launch<float, GROUP>(x, q4, scale, y, part, m, f2, d, n_groups,
                                dsplit, nsplit, st);
  }
  if (x_dtype == 1) {
    if (nsplit < 1 || nsplit > tc::MAX_SPLIT || nsplit > (d + tc::KC - 1) / tc::KC)
      return (int)cudaErrorInvalidValue;
    return launch_mma_rows<GROUP>(x, q4, scale, y, m, f2, d, n_groups, nsplit, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The number of clusters of nsplit blocks (1..8) of the tensor-core body
// for m rows of x that the card holds at once (cudaOccupancyMaxActiveClusters),
// or minus a cudaError_t.
template <bool GROUP>
int max_clusters(int m, int nsplit) {
  if (m < 1 || m > 256 || nsplit < 1 || nsplit > tc::MAX_SPLIT)
    return -(int)cudaErrorInvalidValue;
  const int tiles = (min(m, tc::MT) + 7) / 8;
  if (tiles <= 2) return clusters_of<GROUP, 2>(nsplit);
  if (tiles <= 4) return clusters_of<GROUP, 4>(nsplit);
  if (tiles <= 6) return clusters_of<GROUP, 6>(nsplit);
  return clusters_of<GROUP, 8>(nsplit);
}

}  // namespace ospo_int4
