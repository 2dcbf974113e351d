// NITRO linear weight update for Hopper: one pass computes
// grad_W = xᵀ @ relu_bwd(z*, δ) and applies IntegerSGD to it,
// W′ = W − (⌊grad_W/γ_inv⌋ + ⌊W/η_inv⌋); grad_W is never written.
// x (B, M), δ and z* (B, N), W and W′ (M, N), int32 wrapping mod 2^32.
//
// Replaces: src/repro/kernels/nitro_matmul/nitro_matmul.py::nitro_matmul_grad_w_opt
//           (Pallas body _nitro_grad_w_opt_kernel).
//
// Bound on an H100 at VGG8B's linear block (B = 64, M = 2048, N = 1024,
// int32): bytes.  W read and W′ written (8 MiB each) dominate, ≈5.3 µs at
// 3.35 TB/s with x, δ and z*; at mlp4's 3072 × 3000 layer 74 MB (≈22 µs).
// The 134 M multiply-adds at VGG8B take 0.14 µs at the 1,979 TOP/s int8
// peak.
//
// Design: nitro_matmul_grad_w's shallow digit GEMM (linear_grad_w.cuh)
// with IntegerSGD applied from the accumulator registers: no split-K, so
// no workspace and no arrival counter, whatever the batch depth (the
// total folds every 64 samples).  Each block copies its W tile into
// shared memory with cp.async before its first chunk, so W's read
// overlaps the GEMM; γ_inv and η_inv are read from device memory once a
// block.
#include "linear_grad_w.cuh"

// x (B,M), delta and z_star (B,N), w and w_new (M,N) int32 contiguous;
// gamma_inv and eta_inv 0-d int32 on the device.  sms: the card's SM
// count (sizes the grid).  Launches on `stream`; returns the CUDA error.
extern "C" int nitro_matmul_grad_w_opt_launch(const void* x, const void* delta,
                                              const void* z_star, const void* w,
                                              void* w_new, const void* gamma_inv,
                                              const void* eta_inv, int B, int M, int N,
                                              int alpha_inv, int sms, void* stream) {
  nitro::lgw::Args a;
  a.x = (const int32_t*)x;
  a.delta = (const int32_t*)delta;
  a.z = (const int32_t*)z_star;
  a.w = (const int32_t*)w;
  a.w_new = (int32_t*)w_new;
  a.gamma_inv = (const int32_t*)gamma_inv;
  a.eta_inv = (const int32_t*)eta_inv;
  a.B = B;
  a.M = M;
  a.N = N;
  a.alpha_inv = nitro::FastDiv((unsigned)alpha_inv);
  a.w_vec = N % 4 == 0 && (uintptr_t)w % 16 == 0;
  a.pairs = N % 2 == 0 && (uintptr_t)w_new % 8 == 0;
  return nitro::lgw::launch<true>(a, sms, (cudaStream_t)stream);
}
