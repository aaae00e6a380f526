// W4A16 decode matmul with per-row scales, for Hopper (sm_90a).
//
// Replaces: ospo_tpu/ops/int4_matmul.py::_row_kernel (:76-84; _call_row
// :102-123, the scale in int4_matmul_decode :176-178).  Same function: for
// x [M, D] and q4 [F/2, D] (output row i in the low nibble, row i + F/2 in
// the high nibble), acc = sum over D of x * nib in fp32, then
// y = r(r(acc) * r(s[row])) with r the rounding to x's dtype; the scale
// multiply is fused into the kernel's last write and keeps both roundings.
//
// What bounds it on the card: bytes by the data sheet (at the 7B decode, M =
// 48, one w_gate call reads 22.5 MB of packed weights for 4.33 GFLOP; the
// tensor cores would do those in ~4.4 us against ~7.6 us for the bytes), but
// this first kernel runs its products on the fp32 CUDA cores, so operations
// bound it in practice.  The design is in int4_matmul.cuh.

#include "int4_matmul.cuh"

// x: [M, D] (x_dtype 0 = float32, 1 = bfloat16); q4: [F/2, D] int8; s: [F]
// float32; y: [M, F] in x's dtype; part: caller-allocated [nsplit, M, F]
// float32 scratch (unused when nsplit == 1).  D is split into nsplit ranges
// of dsplit columns (a multiple of 32).  Returns a cudaError_t.
extern "C" int ospo_int4_matmul_row(const void* x, const int8_t* q4,
                                    const float* s, void* y, float* part,
                                    int m, int f2, int d, int dsplit,
                                    int nsplit, int x_dtype, void* stream) {
  return ospo_int4::dispatch<false>(x, q4, s, y, part, m, f2, d, 1, dsplit,
                                    nsplit, x_dtype, stream);
}
