// W4A16 decode matmul with group scales (g128 along D), for Hopper (sm_90a).
//
// Replaces: ospo_tpu/ops/int4_matmul.py::_group_kernel (:87-99; _call_group
// :126-155).  Same function: for x [M, D], q4 [F/2, D] (output row i in the
// low nibble, row i + F/2 in the high nibble) and gs [F, G] (one [F, G]
// array feeds both planes: row i scales the low plane, row i + F/2 the
// high one), each weight is formed in x's dtype as
// w = r(nib * r(gs[row, d / (D / G)])), then y = r(sum over D of x * w) with
// the sum in fp32 (r: rounding to x's dtype).  The scale sits inside the
// contraction, so it is applied in registers as each packed byte is decoded.
//
// What bounds it on the card: bytes by the data sheet.  At the 7B decode
// (M = 48) one w_gate call reads 22.5 MB of packed weights and 1.4 MB of
// scales for 4.33 GFLOP, ~192 FLOP a byte, under the H100's
// ~295 bf16 FLOP per byte of HBM.  The bf16 body decodes the nibbles to
// bf16 in registers with integer operations, forms w = r(nib * r(gs)) with
// one bf16x2 multiply before the product, multiplies on the tensor cores
// (mma.sync), streams the weights through a 3-stage cp.async ring of
// 128-column chunks and sums split-K partials inside a thread-block cluster
// sized to run in one wave; it ends bound by its integer instructions (the
// decode and the copies), well above the bytes bound.  fp32 x keeps the
// first CUDA-core body.  The design is in int4_matmul.cuh.

#include "int4_matmul.cuh"

// x: [M, D] (x_dtype 0 = float32, 1 = bfloat16); q4: [F/2, D] int8; gs:
// [F, n_groups] float32 with D / n_groups a multiple of 16; y: [M, F] in x's
// dtype.  fp32 x: D is split into nsplit ranges of dsplit columns (a
// multiple of 32), and part is caller-allocated [nsplit, M, F] float32
// scratch (unused when nsplit == 1).  bf16 x: nsplit is the cluster's split
// of D (1 to 8); dsplit and part are not read.  Returns a cudaError_t.
extern "C" int ospo_int4_matmul_group(const void* x, const int8_t* q4,
                                      const float* gs, void* y, float* part,
                                      int m, int f2, int d, int n_groups,
                                      int dsplit, int nsplit, int x_dtype,
                                      void* stream) {
  return ospo_int4::dispatch<true>(x, q4, gs, y, part, m, f2, d, n_groups,
                                   dsplit, nsplit, x_dtype, stream);
}

// How many clusters of nsplit blocks of the bf16 body for m rows of x the
// card holds at once, or minus a cudaError_t (the wrapper sizes the split of
// D so that the grid runs in one wave).
extern "C" int ospo_int4_matmul_group_clusters(int m, int nsplit) {
  return ospo_int4::max_clusters<true>(m, nsplit);
}
