// The W8A16 tensor-core body that the grouped expert GEMMs
// (moe_experts.cu: moe_gate_up, moe_down) and the dense T == 1 product
// (w8a16_matmul.cu) share: a block of WARPS warps owns ROWS int8 weight rows
// and multiplies them by up to 8 NT rows of bf16 x over a range of K.
//  - operands swapped, out^T = W . x^T: the weight rows are the A operand
//    of mma.sync m16n8k16 (16 output features), x is B (8 rows an n-tile);
//    n-tiles past the live rows are skipped;
//  - bytes in flight: the block's 128 weight rows (16 KB a 128-column
//    chunk: each row is read 128 contiguous bytes at a time, which HBM
//    serves far better than 64) and its rows of x stream through a ring of
//    chunks in dynamic shared memory with 16-byte cp.async from every
//    thread; rows past the tile, weights past the features and columns
//    past K are zero-filled;
//  - no repacking: k is permuted inside each 64 columns, the same for both
//    operands, so that lane (g, tig) takes its A fragments from its own 16
//    contiguous bytes of weight rows g and g + 8 (k-step s: bytes 4s ..
//    4s + 3) and its B fragments from the same 16 columns of its row of x,
//    both read from shared memory without bank conflicts (the two weight
//    rows a quarter-warp reads are XOR-swizzled, staged rows of x padded
//    to 272 bytes);
//  - int8 becomes bf16 in registers: a byte permute puts each byte,
//    offset by 128, into the mantissa of 2^23, one fp32 subtraction leaves
//    its value, exactly, and a second permute packs two upper halves.
// Products of two bf16 values are exact in fp32: a kernel built on this
// body and a plain version differ only in the order of the fp32 sums.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

// (no static state here: a function-local static of a header template
// would become one process-wide symbol shared by the libraries)
namespace ospo_w8 {

using ospo_mma::cp_async16;
using ospo_mma::smem_u32;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 32 * WARPS;  // weight rows a block
constexpr int KC = 128;           // K columns a chunk: 2 sub-chunks of 64
constexpr int X_LD = KC + 8;      // bf16 a staged row of x: 272 bytes

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 4 int8 of one word → bf16x2 of bytes (0, 1) and of bytes (2, 3), exactly:
// 0x4B0000uu is 2^23 + uu, and an integer in [-128, 127] keeps every bit
// in a bf16
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // x + 128 as unsigned bytes
  const float f0 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The ring of chunks in dynamic shared memory: STAGES x the block's 128
// weight rows of KC bytes (16-byte piece c of row r at piece c ^ 4 (r & 1):
// the two rows a quarter-warp reads fall in distinct banks), then STAGES x
// the tile's rows of x, KC bf16 each, padded to X_LD.
template <int NT, int STAGES>
struct Ring {
  static constexpr int W_BYTES = ROWS * KC;
  static constexpr int X_ELEMS = 8 * NT * X_LD;
  static constexpr int BYTES = STAGES * (W_BYTES + 2 * X_ELEMS);
  int8_t* w;
  __nv_bfloat16* x;
  __device__ __forceinline__ explicit Ring(uint8_t* base)
      : w(reinterpret_cast<int8_t*>(base)),
        x(reinterpret_cast<__nv_bfloat16*>(base + STAGES * W_BYTES)) {}
  __device__ __forceinline__ int8_t* w_piece(int slot, int row, int c) const {
    return w + slot * W_BYTES + row * KC + ((c ^ ((row & 1) << 2)) << 4);
  }
};

// Where this thread's 16-byte copies of a chunk come from: 8 of weights
// (piece p = tid + 128 i: row p / 8, bytes 16 (p % 8)) and NT of x (row p
// / 16, bf16 8 (p % 16)), each with the chunk's first column added at the
// copy, and whether the row exists.
template <int NT>
struct Sources {
  const int8_t* w[8];
  bool w_ok[8];
  const __nv_bfloat16* x[NT];
  bool x_ok[NT];
};

// adds one staged chunk to the warp's sums: weight rows row0 + 16 t + g and
// + 8 (t < AT) by n_live n-tiles of staged rows of x, over the chunk's
// 64-column halves sc_first .. sc_first + sc_count - 1.  Lane (g, tig) takes
// 16 columns of each half sc: the 16 bytes of weight row r at w_at(r, sc,
// tig), and the same 16 columns of row m of x as the 8 bf16 at x_at(m, sc,
// tig, 0) and at x_at(m, sc, tig, 1).  k-step s (0..3) of the half takes
// bytes 4s .. 4s + 3 of them.
template <int NT, int AT = 2, typename WAt, typename XAt>
__device__ __forceinline__ void chunk_mma(float (&acc)[AT][NT][4], WAt w_at, XAt x_at,
                                          int n_live, int row0, int sc_first = 0,
                                          int sc_count = KC / 64) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < sc_count; ++i) {
    const int sc = sc_first + i;
    // half sc: columns 64 sc .. 64 sc + 63, lane tig's 16 of them
    uint4 wv[AT][2];
#pragma unroll
    for (int t = 0; t < AT; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        wv[t][hf] = *reinterpret_cast<const uint4*>(w_at(row0 + 16 * t + 8 * hf + g, sc, tig));
#pragma unroll
    for (int pair = 0; pair < 2; ++pair) {
      uint4 xv[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        if (nt < n_live)
          xv[nt] = *reinterpret_cast<const uint4*>(x_at(8 * nt + g, sc, tig, pair));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = 2 * pair + half;
        uint32_t a[AT][4];
#pragma unroll
        for (int t = 0; t < AT; ++t) {
          i8x4_to_bf16(word(wv[t][0], s), a[t][0], a[t][2]);
          i8x4_to_bf16(word(wv[t][1], s), a[t][1], a[t][3]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (nt < n_live) {
            const uint32_t b0 = word(xv[nt], 2 * half), b1 = word(xv[nt], 2 * half + 1);
#pragma unroll
            for (int t = 0; t < AT; ++t) ospo_mma::mma(acc[t][nt], a[t], b0, b1);
          }
      }
    }
  }
}

// sums over K of the warp's 2 A tiles (weight rows 32 warp + 16 t + g and
// + 8 of the block) by the tile's n-tiles: over every chunk of K, or over
// chunks [c_beg, c_end) of it
template <int NT, int STAGES>
__device__ __forceinline__ void product(float (&acc)[2][NT][4], const Ring<NT, STAGES>& ring,
                                        const Sources<NT>& src, int k, int n_live,
                                        bool warp_live, int c_beg = 0, int c_end = -1) {
  const int tid = threadIdx.x, warp = tid >> 5;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0.f;
  const int chunks = (c_end < 0 ? (k + KC - 1) / KC : c_end) - c_beg;
  auto issue = [&](int c) {
    if (c < chunks) {
      const int k0 = (c_beg + c) * KC, slot = c % STAGES;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = tid + THREADS * i, piece = p & 7;
        const bool ok = src.w_ok[i] && k0 + 16 * piece < k;
        cp_async16(smem_u32(ring.w_piece(slot, p >> 3, piece)),
                   ok ? src.w[i] + k0 : src.w[i], ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int p = tid + THREADS * i, col = (p & 15) * 8;
        const bool ok = src.x_ok[i] && k0 + col < k;
        cp_async16(smem_u32(ring.x + slot * Ring<NT, STAGES>::X_ELEMS + (p >> 4) * X_LD + col),
                   ok ? src.x[i] + k0 : src.x[i], ok ? 16 : 0);
      }
    }
    ospo_mma::cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    ospo_mma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(c + STAGES - 1);
    if (!warp_live) continue;
    const int slot = c % STAGES;
    const __nv_bfloat16* xs = ring.x + slot * Ring<NT, STAGES>::X_ELEMS;
    chunk_mma<NT>(
        acc, [&](int row, int sc, int tig) { return ring.w_piece(slot, row, 4 * sc + tig); },
        [&](int m, int sc, int tig, int pair) { return xs + m * X_LD + 64 * sc + 16 * tig + 8 * pair; },
        n_live, 32 * warp);
  }
  ospo_mma::cp_async_wait<0>();
}

}  // namespace ospo_w8
