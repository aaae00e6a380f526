// Weight-only int8 product for one position a row (T == 1), for Hopper
// (sm_90a): y[b, f] = r(r(sum_k x[b, k] * q[f, k]) * r(s[f])) for bf16 x
// [M, K], int8 q [F, K] and fp32 row scales s [F], r the rounding to bf16:
// the two roundings of ops/quant.py's plain _w8a16 (the payload in x's
// dtype, an fp32 sum, then the row scale in x's dtype; the JAX package's
// models/llama.py:207-208).  One launch takes up to three matrices that
// share x (q, k and v; gate and up): each output row depends on its own
// weight row alone, so the values are those of separate launches.
//
// Replaces no Pallas kernel: the JAX package leaves this product to XLA.
// On the card it replaces three steps, an int8 -> bf16 copy of the whole
// matrix, a cuBLAS GEMM over the copy and a bf16 scale multiply, which move
// about 5 bytes for every int8 weight.
//
// What bounds it: the int8 weight bytes, read once.  At a decode step's 48
// rows the product does 96 FLOP a weight byte against the H100's ~295 bf16
// FLOP a byte of HBM; one 7B layer's seven matrices are 202 MB, 60 us at
// 3.35 TB/s.  How the design meets it:
//  - the tensor-core step of w8a16_mma.cuh (chunk_mma, shared with the
//    grouped expert GEMMs of moe_experts.cu): a block of 4 warps owns 128
//    weight rows and the block's rows of x (8 NT of them, NT from M: 1, 2,
//    4, 6 or 8 n-tiles); each byte becomes bf16 in registers and is
//    multiplied on mma.sync with the weight rows as A, k permuted inside 64
//    columns so that a lane's A fragments are 16 contiguous bytes;
//  - the weights stream in 128-byte runs of each row through a cp.async
//    ring of 128-column chunks, 3 to 6 deep (what half an SM's shared memory
//    holds beside the chunk's x, so that two blocks share an SM);
//  - K is split across the blocks of a thread-block cluster (the wrapper
//    picks the split), and each block walks its chunks from a place of its
//    own: blocks that run at once read different columns of x, which every
//    block reads from the L2, instead of the same few lines;
//  - the splits' partial sums are added without a second pass and without
//    atomics: each block leaves its fp32 sums [rows of x][128 features] in
//    its shared memory, and after a cluster barrier the block of rank r
//    reads the rows of x r, r + n, ... from every block of the cluster
//    (distributed shared memory, all of a thread's loads in flight at once)
//    and adds them in rank order, then rounds, scales (the row scales read
//    before the loop) and stores; a second barrier keeps the sums alive
//    until all are read.  The order of every fp32 sum is fixed, so two runs
//    are bit-equal;
//  - edges: weight rows past F, rows of x past M and columns past K are
//    zero-filled by the copies (F = 576, K = 10944 = 85.5 chunks).
// On the H100 it reaches about half of the bytes' bound at 48 rows (at one
// row about two thirds): the mma.sync work of 48 rows and the copies of x
// do not hide behind the weights' stream (PERF.md).
// It allocates nothing and never synchronises with the host, so a decode
// step that runs it can be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "w8a16_mma.cuh"

namespace {

using namespace ospo_w8;

constexpr int MAX_MATS = 3;       // matrices one launch takes
constexpr int MAX_SPLIT = 8;      // blocks of a cluster (the portable limit)
constexpr int P_LD = ROWS + 4;    // fp32 sums [row of x][feature]: 528 bytes a row
constexpr int MIN_ALIGN = 16;     // K: a multiple of this (16-byte copies)

// Shared memory for NT n-tiles of x: a ring of SW stages, each a chunk of
// weights (128 rows of 128 bytes; 16-byte piece c of row r at c ^ 4 (r &
// 1)) and the same chunk of x.  SW fills half an SM's 227 KB, so that two
// blocks share an SM.
template <int NT>
struct Layout {
  static constexpr int W_BYTES = ROWS * KC;
  static constexpr int STAGE = W_BYTES + 8 * NT * X_LD * 2;
  static constexpr int SW = (112 * 1024) / STAGE < 6 ? (112 * 1024) / STAGE : 6;
  static constexpr int BYTES = SW * STAGE;
  static_assert(SW >= 3, "two chunks in flight");
  static_assert(8 * NT * P_LD * 4 <= BYTES, "the sums fit in the ring");
};

// the matrices of one launch: matrix i covers blockIdx.y in [end[i - 1],
// end[i]), ceil(f[i] / 128) blocks of rows
struct Mats {
  const int8_t* q[MAX_MATS];
  const float* s[MAX_MATS];
  __nv_bfloat16* y[MAX_MATS];
  int f[MAX_MATS];
  int end[MAX_MATS];
  int n;
};

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 4 floats of the shared memory of the cluster's block `rank` at the
// address p has in this block
__device__ __forceinline__ float4 ld_cluster4(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(remote)
               : "memory");
  return v;
}

// grid (nsplit, the matrices' row blocks, ceil(M / 8 NT)), clusters of
// (nsplit, 1, 1): block (r, i, j) sums chunks [r C / nsplit, (r + 1) C /
// nsplit) of K's C chunks for 128 weight rows of row block i and the rows of
// x [8 NT j, 8 NT (j + 1))
template <int NT>
__global__ void __launch_bounds__(THREADS)
w8a16_matmul(const __nv_bfloat16* __restrict__ x, const Mats mats, int m_rows,
             int k, int nsplit) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int split = blockIdx.x;  // the block's rank in its cluster

  // the block's matrix: the last whose row blocks start at or before it
  const int8_t* q = mats.q[0];
  const float* s = mats.s[0];
  __nv_bfloat16* y = mats.y[0];
  int f = mats.f[0], first = 0;
#pragma unroll
  for (int i = 1; i < MAX_MATS; ++i)
    if (i < mats.n && (int)blockIdx.y >= mats.end[i - 1]) {
      q = mats.q[i];
      s = mats.s[i];
      y = mats.y[i];
      f = mats.f[i];
      first = mats.end[i - 1];
    }
  const int r0 = ((int)blockIdx.y - first) * ROWS;  // the block's first weight row
  const int m0 = blockIdx.z * 8 * NT;
  const int live = min(8 * NT, m_rows - m0);        // rows of x in this tile

  using L = Layout<NT>;
  constexpr int SW = L::SW;
  const uint32_t base = smem_u32(smem);
  const int chunks_all = (k + KC - 1) / KC;
  const int c_beg = (int)((long long)split * chunks_all / nsplit);
  const int chunks = (int)((long long)(split + 1) * chunks_all / nsplit) - c_beg;
  const int n_live = (live + 7) >> 3;

  // each chunk of weights and of x by cp.async: thread t copies the 16-byte
  // pieces t + 128 i of the weights (row p / 8, bytes 16 (p % 8)) and of x
  // (row p / 16, bf16 8 (p % 16)); zeros past F, M and K.  The block takes
  // its chunks from a place of its own (its row block's in its matrix, so
  // that a matrix sums as in a launch of its own), so that the blocks
  // running at once read different columns of x from the L2.
  const int8_t* w_src[8];
  bool w_ok[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + ((tid + THREADS * i) >> 3);
    w_ok[i] = row < f;
    w_src[i] = q + (size_t)(w_ok[i] ? row : 0) * k + (tid & 7) * 16;
  }
  const __nv_bfloat16* x_src[NT];
  bool x_ok[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int r = (tid + THREADS * i) >> 4;
    x_ok[i] = r < live;
    x_src[i] = x + (size_t)(m0 + min(r, live - 1)) * k + (tid & 15) * 8;
  }
  const int rot = chunks > 0 ? ((int)blockIdx.y - first) % chunks : 0;
  auto issue = [&](int c) {
    if (c < chunks) {
      const int cc = c + rot < chunks ? c + rot : c + rot - chunks;
      const int k0 = (c_beg + cc) * KC;
      const uint32_t stage = base + (c % SW) * L::STAGE;
      const bool w_col = k0 + 16 * (tid & 7) < k, x_col = k0 + 8 * (tid & 15) < k;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = tid + THREADS * i, row = p >> 3, piece = p & 7;
        const bool ok = w_ok[i] && w_col;
        cp_async16(stage + row * KC + ((piece ^ ((row & 1) << 2)) << 4),
                   ok ? w_src[i] + k0 : w_src[i], ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int p = tid + THREADS * i;
        const bool ok = x_ok[i] && x_col;
        cp_async16(stage + L::W_BYTES + ((p >> 4) * X_LD + (p & 15) * 8) * 2,
                   ok ? x_src[i] + k0 : x_src[i], ok ? 16 : 0);
      }
    }
    ospo_mma::cp_async_commit();
  };

  // the row scales of the features this thread finishes (the epilogue's)
  const int fc = (tid & 31) * 4;
  float rs[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) rs[e] = r0 + fc + e < f ? rnd(s[r0 + fc + e]) : 0.f;

  float acc[2][NT][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0.f;
  const bool warp_live = r0 + 32 * warp < f;
  for (int c = 0; c < SW - 1; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    ospo_mma::cp_async_wait<SW - 2>();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    issue(c + SW - 1);
    if (!warp_live) continue;
    const uint8_t* ws = smem + (c % SW) * L::STAGE;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(ws + L::W_BYTES);
    chunk_mma<NT>(
        acc,
        [&](int row, int sc, int tig) {
          return ws + row * KC + (((4 * sc + tig) ^ ((row & 1) << 2)) << 4);
        },
        [&](int m, int sc, int tig, int pair) {
          return xs + m * X_LD + 64 * sc + 16 * tig + 8 * pair;
        },
        n_live, 32 * warp);
  }
  ospo_mma::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it holds the sums now

  // C fragment: c0 c1 = (weight row g, x rows 2 tig, 2 tig + 1), c2 c3 =
  // weight row g + 8
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      if (nt < n_live)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[(8 * nt + 2 * tig + (e & 1)) * P_LD + 32 * warp + 16 * t + g + 8 * (e >> 1)] =
              acc[t][nt][e];
  cluster_sync();  // every block's sums are in its shared memory

  // this block's rows of x, m = split + nsplit * ml: thread t takes features
  // c .. c + 3, c = 4 (t % 32), of rows ml = t / 32, + 4, ...; it reads
  // every rank's sums of them (all its rows' loads in flight at once) and
  // adds them in rank order
  constexpr int MAX_ML = (8 * NT + 3) / 4;  // rows of x a thread takes at most
  float4 sum[MAX_ML];
#pragma unroll
  for (int j = 0; j < MAX_ML; ++j) {
    const int m = split + nsplit * ((tid >> 5) + 4 * j);
    if (m < live) sum[j] = ld_cluster4(part + m * P_LD + fc, 0);
  }
  for (int r = 1; r < nsplit; ++r) {
#pragma unroll
    for (int j = 0; j < MAX_ML; ++j) {
      const int m = split + nsplit * ((tid >> 5) + 4 * j);
      if (m < live) {
        const float4 v = ld_cluster4(part + m * P_LD + fc, r);
        sum[j].x += v.x;
        sum[j].y += v.y;
        sum[j].z += v.z;
        sum[j].w += v.w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < MAX_ML; ++j) {
    const int m = split + nsplit * ((tid >> 5) + 4 * j);
    if (m < live) {
      const float v[4] = {sum[j].x, sum[j].y, sum[j].z, sum[j].w};
      __nv_bfloat16* out = y + (size_t)(m0 + m) * f + r0 + fc;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (r0 + fc + e < f) out[e] = __float2bfloat16_rn(rnd(v[e]) * rs[e]);
    }
  }
  cluster_sync();  // no block leaves while another may read its sums
}

// the launch configuration (attr: one slot)
template <int NT>
cudaLaunchConfig_t config(int tiles, int m, int nsplit, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, tiles, (m + 8 * NT - 1) / (8 * NT));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Layout<NT>::BYTES;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the ring's shared memory, allowed on the first call (which comes before
// any capture: a decode step's first launch runs eagerly)
template <int NT>
cudaError_t allow_smem() {
  static bool ready = false;
  if (ready) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      w8a16_matmul<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<NT>::BYTES);
  ready = err == cudaSuccess;
  return err;
}

template <int NT>
int launch(const __nv_bfloat16* x, const Mats& mats, int m, int k, int nsplit,
           cudaStream_t st) {
  cudaError_t err = allow_smem<NT>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<NT>(mats.end[mats.n - 1], m, nsplit, st, attr);
  err = cudaLaunchKernelEx(&cfg, w8a16_matmul<NT>, x, mats, m, k, nsplit);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// n-tiles of x a block holds for M rows: 1, 2, 4, 6 or 8
int n_tiles(int m) {
  const int t = (min(m, 64) + 7) / 8;
  return t <= 1 ? 1 : t <= 2 ? 2 : t <= 4 ? 4 : t <= 6 ? 6 : 8;
}

}  // namespace

// x: [M, K] bf16; for each of the n_mats (1 to 3) matrices i: q_i [F_i, K]
// int8, s_i [F_i] fp32, y_i [M, F_i] bf16.  K a multiple of 16; nsplit the
// cluster's split of K, 1 to 8 and at most K's 128-column chunks.  Every
// pointer 16-byte aligned.  Returns a cudaError_t.
extern "C" int ospo_w8a16_matmul(const void* x, const int8_t* q0, const int8_t* q1,
                                 const int8_t* q2, const float* s0, const float* s1,
                                 const float* s2, void* y0, void* y1, void* y2, int f0,
                                 int f1, int f2, int n_mats, int m, int k, int nsplit,
                                 void* stream) {
  if (n_mats < 1 || n_mats > MAX_MATS || m < 1 || k < MIN_ALIGN || k % MIN_ALIGN ||
      nsplit < 1 || nsplit > MAX_SPLIT || nsplit > (k + KC - 1) / KC)
    return (int)cudaErrorInvalidValue;
  Mats mats = {{q0, q1, q2}, {s0, s1, s2},
               {static_cast<__nv_bfloat16*>(y0), static_cast<__nv_bfloat16*>(y1),
                static_cast<__nv_bfloat16*>(y2)}, {f0, f1, f2}, {0, 0, 0}, n_mats};
  int tiles = 0;
  for (int i = 0; i < n_mats; ++i) {
    if (mats.f[i] < 1) return (int)cudaErrorInvalidValue;
    tiles += (mats.f[i] + ROWS - 1) / ROWS;
    mats.end[i] = tiles;
  }
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_tiles(m)) {
    case 1: return launch<1>(xb, mats, m, k, nsplit, st);
    case 2: return launch<2>(xb, mats, m, k, nsplit, st);
    case 4: return launch<4>(xb, mats, m, k, nsplit, st);
    case 6: return launch<6>(xb, mats, m, k, nsplit, st);
    default: return launch<8>(xb, mats, m, k, nsplit, st);
  }
}
