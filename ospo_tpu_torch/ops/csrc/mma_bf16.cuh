// Tensor-core building blocks for the bf16 flash-attention backward kernels
// (flash_bwd_dq.cu, flash_bwd_dkv.cu), sm_80+ PTX written by hand:
//  - cp.async 16-byte (and 4-byte) copies global -> shared, with the
//    src-size operand zero-filling what lies past the ragged edge;
//  - [rows][128] bf16 tiles in shared memory with an XOR swizzle: the 16-byte
//    chunk c of row r is stored at chunk c ^ (r & 7), so the eight rows an
//    ldmatrix phase reads (one chunk each) fall in eight distinct bank groups;
//  - ldmatrix.x4 (and .trans) fragment loads and
//    mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32;
//  - the warp-level steps both kernels take on a 16 x 32 block: the S and
//    dP products, the p and ds epilogue, and the bf16 A fragments of the
//    second products.
//
// Fragment layouts of m16n8k16 (lane = 4 * g + tig):
//   A 16x16: a0 (row g, k 2tig..+1), a1 (row g+8), a2 (k +8), a3 (row g+8, k +8)
//   B 16x8:  b0 (k 2tig..+1, col g), b1 (k +8)
//   C 16x8:  c0 c1 (row g, cols 2tig..+1), c2 c3 (row g+8)
// so a C fragment pair (n-blocks 2kk, 2kk+1) converted to bf16 is the A
// fragment of k-step kk: the second products take p and ds from registers.
//
// The PTX is inline asm rather than CuTe's MMA atoms: with no CUTLASS
// headers each source still builds in seconds (the six kernel sources in
// 5-9 s, in parallel, with nvcc 12.8; chip_smoke.py phase 1 prints it).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace ospo_mma {

constexpr int TILE_COLS = 128;  // head dim: one tile row is 16 chunks of 16 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element (row, col) of a swizzled [rows][128] bf16 tile; col
// is a multiple of 8 (one 16-byte chunk)
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return (uint32_t)((row * TILE_COLS + (((col >> 3) ^ (row & 7)) << 3)) * 2);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [0, n_valid) of a [64][128] bf16 tile whose rows lie ld elements apart
// in device memory, into a swizzled shared tile; rows past n_valid are zeros
template <int THREADS>
__device__ __forceinline__ void load_tile64(uint32_t dst, const __nv_bfloat16* src,
                                            size_t ld, int n_valid, int tid) {
#pragma unroll
  for (int it = 0; it < 64 * 16 / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i >> 4, c = (i & 15) * 8;
    const bool ok = r < n_valid;
    cp_async16(dst + swz(r, c), ok ? src + r * ld + c : src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a . b (16x16 bf16 by 16x8 bf16, fp32 accumulators)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// lane addresses of the x4 loads, for a 16-row block starting at row0 and a
// 16-column block starting at col0 of a swizzled tile:
//  A operand (rows = M, k contiguous): matrices (r0-7,k0), (r8-15,k0),
//    (r0-7,k8), (r8-15,k8) -> a0..a3
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int row0, int col0,
                                           int lane) {
  return base + swz(row0 + (lane & 15), col0 + (lane >> 4) * 8);
}
//  B operand stored [n][k] (k contiguous), two n-blocks: matrices (n0-7,k0),
//    (n0-7,k8), (n8-15,k0), (n8-15,k8) -> b0 b1 of n-block 0, b0 b1 of 1
__device__ __forceinline__ uint32_t b_addr(uint32_t base, int row0, int col0,
                                           int lane) {
  return base + swz(row0 + (lane & 7) + ((lane >> 4) << 3),
                    col0 + ((lane >> 3) & 1) * 8);
}
//  B operand stored [k][n] (n contiguous), loaded with .trans, two n-blocks:
//    matrices (k0-7,n0), (k8-15,n0), (k0-7,n8), (k8-15,n8)
__device__ __forceinline__ uint32_t bt_addr(uint32_t base, int row0, int col0,
                                            int lane) {
  return base + swz(row0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                    col0 + (lane >> 4) * 8);
}

// -- the warp-level steps the dQ and dK/dV kernels share ---------------------

constexpr float NEG_FILL = -1e30f;             // a masked key's score
constexpr float LOG2E = 1.4426950408889634f;

// The first two products of one warp's 16 x 32 block, over the head dim:
// s = A_s . B_s^T and dp = A_p . B_p^T in fp32 (zeroed here).  The A tiles
// give 16 rows from row a0, the B tiles (stored [n][k]) 32 rows from row
// b0.  dQ: A = Q, dO and B = K, V; dK/dV: A = K, V and B = Q, dO (S^T, dP^T).
__device__ __forceinline__ void first_products(float (&s)[4][4], float (&dp)[4][4],
                                               uint32_t a_s, uint32_t a_p, int a0,
                                               uint32_t b_s, uint32_t b_p, int b0,
                                               int lane) {
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < TILE_COLS / 16; ++kd) {
    uint32_t as[4], ap[4];
    ldsm_x4(a_addr(a_s, a0, kd * 16, lane), as);
    ldsm_x4(a_addr(a_p, a0, kd * 16, lane), ap);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bs[4], bp[4];
      ldsm_x4(b_addr(b_s, b0 + np * 16, kd * 16, lane), bs);
      ldsm_x4(b_addr(b_p, b0 + np * 16, kd * 16, lane), bp);
      mma(s[2 * np], as, bs[0], bs[1]);
      mma(s[2 * np + 1], as, bs[2], bs[3]);
      mma(dp[2 * np], ap, bp[0], bp[1]);
      mma(dp[2 * np + 1], ap, bp[2], bp[3]);
    }
  }
}

// What the epilogue needs of one score: whether its key lies in the query
// row's window (causal, inside S and T), whether the key is valid (mask),
// and the row's max m, 1 / max(l, 1e-30) and di.
struct ScoreRow {
  bool in_window, key_valid;
  float m, inv_l, di;
};

// p = exp(s * scale - m) / l into s (0 outside the window; a masked key
// scores -1e30) and ds = p * (dp - di) * scale into dp, both in fp32;
// at(nb, e) gives the ScoreRow of accumulator element [nb][e].
template <typename At>
__device__ __forceinline__ void p_and_ds(float (&s)[4][4], float (&dp)[4][4],
                                         float scale, At at) {
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const ScoreRow r = at(nb, e);
      float p = 0.f;
      if (r.in_window) {
        const float sv = r.key_valid ? s[nb][e] * scale : NEG_FILL;
        p = exp2f((sv - r.m) * LOG2E) * r.inv_l;
      }
      dp[nb][e] = p * (dp[nb][e] - r.di) * scale;
      s[nb][e] = p;
    }
}

// The A fragment of k-step kk of a second product: accumulator n-blocks 2kk
// and 2kk + 1 of a 16 x 32 block, rounded to bf16 (FlashAttention-2's
// scheme: p and ds go to the tensor cores from registers)
__device__ __forceinline__ void a_frag(const float (&c)[4][4], int kk,
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

}  // namespace ospo_mma
