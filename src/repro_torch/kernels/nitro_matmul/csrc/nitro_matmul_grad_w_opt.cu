// NITRO linear weight update for Hopper: one pass computes
// grad_W = xᵀ @ relu_bwd(z*, δ) and applies IntegerSGD in the flush,
// W′ = W − (⌊grad_W/γ_inv⌋ + ⌊W/η_inv⌋); grad_W is never written.
// x (B, M), δ and z* (B, N), W and W′ (M, N), int32 wrapping mod 2^32.
//
// Replaces: src/repro/kernels/nitro_matmul/nitro_matmul.py::nitro_matmul_grad_w_opt
//           (Pallas body _nitro_grad_w_opt_kernel).
//
// Bound on an H100 at VGG8B's linear block (B = 64, M = 2048, N = 1024,
// int32): bytes.  W read and W′ written (8 MiB each) dominate, ≈5.3 µs at
// 3.35 TB/s with x, δ and z*; the 134 M multiply-adds take 0.14 µs at the
// 1,979 TOP/s int8 peak.
//
// Design: nitro_matmul_grad_w's split-K GEMM (int_gemm.cuh, DenseColumnsA)
// with the IntegerSGD flush (grad_w_opt_kernel).  γ_inv and η_inv are
// read from device memory by each thread that flushes.  At B = 64 the
// contraction makes one split, so the flush applies IntegerSGD straight
// from the accumulator registers; a deeper batch goes through the
// workspace and the last-arriving split.
#include "grad_w_stage.cuh"

using namespace nitro::gemm;

// x (B,M), delta and z_star (B,N), w and w_new (M,N) int32 contiguous;
// gamma_inv and eta_inv 0-d int32 on the device; ws (≥ M·N) and arrivals
// (≥ one per 64×64 tile of M×N) int32, zero, left zero.  sms: the card's
// SM count (sizes the splits).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int nitro_matmul_grad_w_opt_launch(
    const void* x, const void* delta, const void* z_star, const void* w,
    void* w_new, const void* gamma_inv, const void* eta_inv, void* ws,
    void* arrivals, int B, int M, int N, int alpha_inv, int sms,
    void* stream) {
  const DenseColumnsA::Params prm{(const int32_t*)x, M};
  const SgdOut o{(const int32_t*)w,         (int32_t*)w_new,
                 (unsigned*)ws,             (unsigned*)arrivals,
                 (const int32_t*)gamma_inv, (const int32_t*)eta_inv};
  return launch_grad_w_opt<DenseColumnsA>(prm, delta, z_star, o, M, N, B,
                                          alpha_inv, sms, stream);
}
