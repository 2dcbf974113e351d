// NITRO linear weight gradient for Hopper: grad_W = xᵀ @ relu_bwd(z*, δ),
// x (B, M), δ and z* (B, N) → (M, N), int32 wrapping mod 2^32.
//
// Replaces: src/repro/kernels/nitro_matmul/nitro_matmul.py::nitro_matmul_grad_w
//           (Pallas body _nitro_grad_w_kernel).
//
// Bound on an H100 at VGG8B's linear block (B = 64, M = 2048, N = 1024,
// int32): bytes.  The 8 MiB int32 gradient written once dominates
// (≈2.6 µs at 3.35 TB/s with x, δ and z*); at mlp4's 3072 × 3000 layer
// the gradient is 37 MB (≈11 µs).  The 134 M multiply-adds at VGG8B take
// 0.14 µs at the 1,979 TOP/s int8 peak.
//
// Design: the shallow int8 tensor-core digit GEMM of linear_grad_w.cuh:
// one launch, no pre-pass, scratch, zero-fill or atomics; each block
// splits its slabs of x and masked δ into digits as it stages them, runs
// only the digit pairs its tile needs and stores its tile of the
// gradient once.
#include "linear_grad_w.cuh"

// x (B,M), delta and z_star (B,N) int32 contiguous; out (M,N) int32, any
// contents (every element is written).  sms: the card's SM count (sizes
// the grid).  Launches on `stream`; returns the CUDA error.
extern "C" int nitro_matmul_grad_w_launch(const void* x, const void* delta,
                                          const void* z_star, void* out, int B, int M,
                                          int N, int alpha_inv, int sms, void* stream) {
  nitro::lgw::Args a;
  a.x = (const int32_t*)x;
  a.delta = (const int32_t*)delta;
  a.z = (const int32_t*)z_star;
  a.out = (int32_t*)out;
  a.B = B;
  a.M = M;
  a.N = N;
  a.alpha_inv = nitro::FastDiv((unsigned)alpha_inv);
  a.pairs = N % 2 == 0 && (uintptr_t)out % 8 == 0;
  return nitro::lgw::launch<false>(a, sms, (cudaStream_t)stream);
}
