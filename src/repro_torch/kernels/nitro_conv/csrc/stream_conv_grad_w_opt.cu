// Streaming NITRO conv weight update for Hopper: for a K×K stride-1
// 'same' NHWC conv, one pass computes
//   grad_W[(ki·K + kj)·C + c, f] =
//     Σ_{n,h,w} x[n, h+ki−K/2, w+kj−K/2, c] · relu_bwd(z*, δ)[n, h, w, f]
// and applies IntegerSGD in the flush, W′ = W − (⌊grad_W/γ_inv⌋ +
// ⌊W/η_inv⌋), with W and W′ flattened to the (K·K·C, F) layout; grad_W is
// never written.  int32 wrapping mod 2^32.
//
// Replaces: src/repro/kernels/nitro_conv/nitro_conv.py::stream_conv_grad_w_opt
//           (Pallas body _stream_grad_w_opt_kernel).
//
// Bound on an H100 at VGG8B's six convs (batch 64, int32): bytes.  x, δ
// and z* are ≈401 MB per step and W read plus W′ written 54 MB (0.136 ms
// at 3.35 TB/s) against 60.65 G multiply-adds (0.061 ms at the 1,979
// TOP/s int8 peak).  The GEMM multiplies on the CUDA cores, far from
// either floor.
//
// Design: stream_conv_grad_w's split-K implicit-im2col GEMM (int_gemm.cuh,
// PatchColumnsA) with the IntegerSGD flush (grad_w_opt_kernel).  On the
// TPU the (image, band) grid steps ran in order and grad_W stayed in one
// VMEM accumulator until the flush.  Here the contraction N·H·W (65,536
// deep for a 27×128 gradient at conv 1) is split across blocks that run
// in no order, so the splits add into an int32 workspace in L2 (at most
// 4,608×512×4 B = 9.4 MB at VGG8B, within the 50 MB L2) and the last
// split of each output tile to arrive applies IntegerSGD to the whole sum,
// then zeroes its workspace tile and arrival counter for the next launch.
// Per call it reads x, δ, z* and W and writes W′; the workspace traffic
// (one atomic add per split and element, one read and one zeroing store
// per element) stays in L2.
#include "grad_w_stage.cuh"

using namespace nitro::gemm;

// x (N,H,W,C), delta and z_star (N,H,W,F), w and w_new (K·K·C, F) int32
// contiguous; gamma_inv and eta_inv 0-d int32 on the device; ws (≥ K·K·C·F)
// and arrivals (≥ one per 64×64 tile of the (K·K·C, F) output) int32,
// zero, left zero.  sms: the card's SM count (sizes the splits).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int stream_conv_grad_w_opt_launch(
    const void* x, const void* delta, const void* z_star, const void* w,
    void* w_new, const void* gamma_inv, const void* eta_inv, void* ws,
    void* arrivals, int N, int H, int W, int C, int F, int K, int alpha_inv,
    int sms, void* stream) {
  const int M = K * K * C;
  const PatchColumnsA::Params prm{(const int32_t*)x, H, W, C, K, M,
                                   nitro::FastDiv((unsigned)W),
                                   nitro::FastDiv((unsigned)H)};
  const SgdOut o{(const int32_t*)w,         (int32_t*)w_new,
                 (unsigned*)ws,             (unsigned*)arrivals,
                 (const int32_t*)gamma_inv, (const int32_t*)eta_inv};
  return launch_grad_w_opt<PatchColumnsA>(prm, delta, z_star, o, M, F,
                                          N * H * W, alpha_inv, sms, stream);
}
