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
// 3.35 TB/s) against 60.65 G multiply-adds, which the int8 tensor cores
// run as one product per digit of δ: with δ's four digits 243 G
// multiply-adds (0.245 ms at the 1,979 TOP/s int8 peak).  The CUDA cores
// cannot come near either floor (about 15 T int32 multiply-adds/s).
//
// Design: the exact digit GEMM of digit_gemm.cuh.  A pre-pass masks δ
// once per call and writes it as int8 digit planes laid out p-contiguous,
// another writes x's im2col patch matrix the same way (one plane while x
// fits int8), so the GEMM's stages are plain 16-byte copies and each
// staged δ is not re-masked in every row tile.  The GEMM runs mma.sync
// s8 for only the digit products the data needs (decided on the device),
// and the long contraction N·H·W (65,536 deep for a 27×128 gradient at
// conv 1) is split across blocks and combined with atomicAdd.
#include "digit_gemm.cuh"

using namespace nitro::digits;

// Bytes of the scratch a launch with these shapes needs.
extern "C" long long stream_conv_grad_w_scratch_bytes(int N, int H, int W, int C,
                                                      int F, int K) {
  return (long long)Layout(N, H, W, C, F, K).bytes;
}

// x (N,H,W,C), delta and z_star (N,H,W,F) int32 contiguous (z_star may be
// null: plain δ); out (K·K·C, F) int32, zeroed by the caller; scratch of
// stream_conv_grad_w_scratch_bytes, 256-byte aligned, any contents.  sms:
// the card's SM count (sizes the splits).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int stream_conv_grad_w_launch(const void* x, const void* delta,
                                         const void* z_star, void* out, void* scratch,
                                         int N, int H, int W, int C, int F, int K,
                                         int alpha_inv, int sms, void* stream) {
  const Layout L(N, H, W, C, F, K);
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = prepare(L, x, delta, z_star, scratch, alpha_inv, sms, st);
  if (err) return err;
  return launch_gemm<false>(L, scratch, (unsigned*)out, nitro::digits::SgdOut{}, sms, st);
}
