// W4A16 decode matmul with per-row scales, for Hopper (sm_90a).
//
// Replaces: ospo_tpu/ops/int4_matmul.py::_row_kernel (:76-84; _call_row
// :102-123, the scale in int4_matmul_decode :176-178).  Same function: for
// x [M, D] and q4 [F/2, D] (output row i in the low nibble, row i + F/2 in
// the high nibble), acc = sum over D of x * nib in fp32, then
// y = r(r(acc) * r(s[row])) with r the rounding to x's dtype; the scale
// multiply is fused into the kernel's last write and keeps both roundings.
//
// What bounds it on the card: bytes by the data sheet.  At the 7B decode
// (M = 48) one w_gate call reads 22.5 MB of packed weights for 4.33 GFLOP, ~192 FLOP a byte, under the H100's
// ~295 bf16 FLOP per byte of HBM.  The bf16 body decodes the nibbles to
// bf16 in registers with integer operations, multiplies on the tensor cores
// (mma.sync), streams the weights through a 3-stage cp.async ring of
// 128-column chunks and sums split-K partials inside a thread-block cluster
// sized to run in one wave; it ends bound by its integer instructions (the
// decode and the copies), well above the bytes bound.  fp32 x keeps the
// first CUDA-core body.  The design is in int4_matmul.cuh.

#include "int4_matmul.cuh"

// x: [M, D] (x_dtype 0 = float32, 1 = bfloat16); q4: [F/2, D] int8; s: [F]
// float32; y: [M, F] in x's dtype.  fp32 x: D is split into nsplit ranges of
// dsplit columns (a multiple of 32), and part is caller-allocated
// [nsplit, M, F] float32 scratch (unused when nsplit == 1).  bf16 x: nsplit
// is the cluster's split of D (1 to 8); dsplit and part are not read.
// Returns a cudaError_t.
extern "C" int ospo_int4_matmul_row(const void* x, const int8_t* q4,
                                    const float* s, void* y, float* part,
                                    int m, int f2, int d, int dsplit,
                                    int nsplit, int x_dtype, void* stream) {
  return ospo_int4::dispatch<false>(x, q4, s, y, part, m, f2, d, 1, dsplit,
                                    nsplit, x_dtype, stream);
}

// How many clusters of nsplit blocks of the bf16 body for m rows of x the
// card holds at once, or minus a cudaError_t (the wrapper sizes the split of
// D so that the grid runs in one wave).
extern "C" int ospo_int4_matmul_row_clusters(int m, int nsplit) {
  return ospo_int4::max_clusters<false>(m, nsplit);
}
