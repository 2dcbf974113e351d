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
// at 3.35 TB/s) against 60.65 G multiply-adds, 243 G as int8 digit
// products with δ's four digits (0.245 ms at the 1,979 TOP/s int8 peak).
//
// Design: stream_conv_grad_w's exact digit GEMM (digit_gemm.cuh: the
// pre-passes write δ masked and x's patches as p-contiguous int8 digit
// planes; mma.sync s8 over only the digit products the data needs) with
// the IntegerSGD flush.  On the TPU the (image, band) grid steps ran in
// order and grad_W stayed in one VMEM accumulator until the flush.  Here
// the contraction N·H·W is split across blocks that run in no order, so
// the splits add into an int32 workspace in L2 (at most 4,608×512×4 B =
// 9.4 MB at VGG8B, within the 50 MB L2) and the last split of each
// 128×64 output tile to arrive applies IntegerSGD to the whole sum, then
// zeroes its workspace tile and arrival counter for the next launch.
#include "digit_gemm.cuh"

using namespace nitro::digits;

// Bytes of the scratch a launch with these shapes needs.
extern "C" long long stream_conv_grad_w_opt_scratch_bytes(int N, int H, int W, int C,
                                                          int F, int K) {
  return (long long)Layout(N, H, W, C, F, K).bytes;
}

// x (N,H,W,C), delta and z_star (N,H,W,F), w and w_new (K·K·C, F) int32
// contiguous; gamma_inv and eta_inv 0-d int32 on the device; ws (≥ K·K·C·F)
// and arrivals (≥ one per 128×64 tile of the (K·K·C, F) output) int32,
// zero, left zero; scratch of stream_conv_grad_w_opt_scratch_bytes,
// 256-byte aligned, any contents.  sms: the card's SM count (sizes the
// splits).  Launches on `stream`; returns cudaGetLastError().
extern "C" int stream_conv_grad_w_opt_launch(
    const void* x, const void* delta, const void* z_star, const void* w,
    void* w_new, const void* gamma_inv, const void* eta_inv, void* ws,
    void* arrivals, void* scratch, int N, int H, int W, int C, int F, int K,
    int alpha_inv, int sms, void* stream) {
  const Layout L(N, H, W, C, F, K);
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = prepare(L, x, delta, z_star, scratch, alpha_inv, sms, st);
  if (err) return err;
  const nitro::digits::SgdOut o{(const int32_t*)w,         (int32_t*)w_new,
                              (unsigned*)ws,             (unsigned*)arrivals,
                              (const int32_t*)gamma_inv, (const int32_t*)eta_inv};
  return launch_gemm<true>(L, scratch, nullptr, o, sms, st);
}
