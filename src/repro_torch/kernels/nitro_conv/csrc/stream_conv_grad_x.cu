// Streaming NITRO conv input gradient for Hopper: for a K×K stride-1
// 'same' NHWC conv,
//
//   grad_x[n, h, w, c] = Σ_{ki, kj, f} relu_bwd(z*, δ)[n, h+ki−K/2, w+kj−K/2, f]
//                                      · w[K−1−ki, K−1−kj, c, f]
//
// the 'full' correlation of the masked δ with rot180_swap(w) (K, K, F, C),
// unit scale and no activation, int32 wrapping mod 2^32: (N, H, W, C).
//
// Replaces: src/repro/kernels/nitro_conv/nitro_conv.py::stream_conv_grad_x
//           (Pallas body _stream_grad_x_kernel).
//
// Bound on an H100 at VGG8B's six convs (batch 64, int32): bytes.  δ, z*,
// the weight and grad_x are ≈428 MB per step (0.128 ms at 3.35 TB/s)
// against 60.65 G multiply-adds (0.061 ms at the 1,979 TOP/s int8 peak),
// the forward's volume.  This kernel multiplies on the CUDA cores, far
// from either floor.
//
// Design: an implicit-im2col GEMM over all N·H·W pixels on int_gemm.cuh.
// A gathers a step's patch values of δ and of z* at the same indices, all
// loads issued before the first is masked, then masks each by the
// NITRO-ReLU derivative (patch_rows.cuh): 0 where z* saturates, ⌊δ/α_inv⌋ (a floor) where z* < 0, δ
// elsewhere — the masked δ is never written, as on the TPU, where each δ
// band was masked in VMEM.  The 'same' halo is 0
// without reading z*: relu_bwd(0, 0) = 0.  B is rot180_swap(w) flattened
// to (K²F, C), laid out by the wrapper on the device (the TPU wrapper did
// the same with jnp outside its pallas_call).  The flush stores the sum.
// C = 3 (conv 1) leaves 61 of a tile's 64 columns empty; its contraction
// of 1,152 stays whole in each block, so nothing is split.
#include "patch_rows.cuh"

namespace {

using namespace nitro::gemm;

__global__ void __launch_bounds__(THREADS)
stream_conv_grad_x_kernel(const int32_t* __restrict__ delta,
                          const int32_t* __restrict__ zstar,
                          const int32_t* __restrict__ w_rot,
                          int32_t* __restrict__ out, int H, int W, int F,
                          int C, int K, int P, nitro::FastDiv alpha_inv) {
  __shared__ Tiles t;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const PatchRowsA a(delta, zstar, alpha_inv, H, W, F, K, P, row0);
  const RowsB<false> b(w_rot, nullptr, C, nitro::FastDiv(1), col0);
  unsigned acc[TM][TN];
  mainloop(a, b, 0, K * K * F, t, acc);

  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = row0 + ty + 16 * i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < C) out[(size_t)p * C + c] = (int)acc[i][j];
    }
  }
}

}  // namespace

// delta and z_star (N,H,W,F), w_rot (K·K·F, C) = rot180_swap(w) flattened,
// all int32 contiguous; out (N,H,W,C) int32.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int stream_conv_grad_x_launch(const void* delta, const void* z_star,
                                         const void* w_rot, void* out, int N,
                                         int H, int W, int F, int C, int K,
                                         int alpha_inv, void* stream) {
  const int P = N * H * W;
  dim3 grid((P + BM - 1) / BM, (C + BN - 1) / BN);
  stream_conv_grad_x_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)delta, (const int32_t*)z_star, (const int32_t*)w_rot,
      (int32_t*)out, H, W, F, C, K, P, nitro::FastDiv((unsigned)alpha_inv));
  return (int)cudaGetLastError();
}
