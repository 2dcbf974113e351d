// NITRO linear weight gradient for Hopper: grad_W = xᵀ @ relu_bwd(z*, δ),
// x (B, M), δ and z* (B, N) → (M, N), int32 wrapping mod 2^32.
//
// Replaces: src/repro/kernels/nitro_matmul/nitro_matmul.py::nitro_matmul_grad_w
//           (Pallas body _nitro_grad_w_kernel).
//
// Bound on an H100 at VGG8B's linear block (B = 64, M = 2048, N = 1024,
// int32): bytes.  The 8 MiB int32 gradient written once dominates
// (≈2.6 µs at 3.35 TB/s); the 134 M multiply-adds would take 0.14 µs at
// the 1,979 TOP/s int8 peak.
//
// Design: the split-K GEMM of int_gemm.cuh with A(p, m) = x[p, m].
// The batch contraction is short (64), so at this shape every output tile
// is one block with one split; the ReLU derivative masks δ on load.
#include "grad_w_stage.cuh"

using namespace nitro::gemm;

// x (B,M), delta and z_star (B,N) int32 contiguous; out (M,N) int32,
// zeroed by the caller.  sms: the card's SM count (sizes the splits).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int nitro_matmul_grad_w_launch(const void* x, const void* delta,
                                          const void* z_star, void* out,
                                          int B, int M, int N, int alpha_inv,
                                          int sms, void* stream) {
  const DenseColumnsA::Params prm{(const int32_t*)x, M};
  return launch_grad_w<DenseColumnsA>(prm, delta, z_star, out, M, N, B,
                                      alpha_inv, sms, stream);
}
