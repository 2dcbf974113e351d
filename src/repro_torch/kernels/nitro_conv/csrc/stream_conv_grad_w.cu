// Streaming NITRO conv weight gradient for Hopper: for a K×K stride-1
// 'same' NHWC conv, grad_W[(ki·K + kj)·C + c, f] =
//   Σ_{n,h,w} x[n, h+ki−K/2, w+kj−K/2, c] · relu_bwd(z*, δ)[n, h, w, f]
// (plain δ when no z* is given), int32 wrapping mod 2^32, reshaped by the
// caller to (K, K, C, F).
//
// Replaces: src/repro/kernels/nitro_conv/nitro_conv.py::stream_conv_grad_w
//           (Pallas bodies _stream_grad_w_fused_kernel with z*,
//           _stream_grad_w_kernel without).
//
// Bound on an H100 at VGG8B's six convs (batch 64, int32): bytes.  The
// int32 input, δ, z* and gradient are ≈428 MB per step (0.128 ms at
// 3.35 TB/s) against 60.65 G multiply-adds (0.061 ms at the 1,979 TOP/s
// int8 peak).  This kernel multiplies on the CUDA cores, far from either
// floor.
//
// Design: the split-K GEMM of int_gemm.cuh with A the implicit im2col
// patch matrix (transposed): rows m = (ki·K + kj)·C + c, the repo's
// patch layout, contraction p = (n·H + h)·W + w.  Each thread decomposes
// its fixed column m once and gathers x straight from the NHWC input
// with the zero halo masked, so neither the patch matrix nor the padded
// input is formed (the TPU kernel staged row bands in VMEM instead).  The contraction N·H·W is
// long where the output is small (65,536 deep for a 27×128 gradient at
// conv 1), so it is split across blocks and combined with atomicAdd.
#include "grad_w_stage.cuh"

using namespace nitro::gemm;

// x (N,H,W,C), delta and z_star (N,H,W,F) int32 contiguous (z_star may be
// null: plain δ); out (K·K·C, F) int32, zeroed by the caller.  sms: the
// card's SM count (sizes the splits).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int stream_conv_grad_w_launch(const void* x, const void* delta,
                                         const void* z_star, void* out, int N,
                                         int H, int W, int C, int F, int K,
                                         int alpha_inv, int sms, void* stream) {
  const int M = K * K * C;
  const PatchColumnsA::Params prm{(const int32_t*)x, H, W, C, K, M,
                                   nitro::FastDiv((unsigned)W),
                                   nitro::FastDiv((unsigned)H)};
  return launch_grad_w<PatchColumnsA>(prm, delta, z_star, out, M, F,
                                      N * H * W, alpha_inv, sms, stream);
}
