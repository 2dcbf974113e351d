// Streaming NITRO conv training forward for Hopper: for a K×K stride-1
// 'same' NHWC conv, z* = ⌊conv(x, w) / SF⌋ and a = NITRO-ReLU(z*) − μ,
// both written as int32 (N, H, W, F) from one accumulator.
//
// Replaces: src/repro/kernels/nitro_conv/nitro_conv.py::stream_conv_fwd
//           (Pallas body _stream_conv_fwd_kernel).
//
// Bound on an H100 at VGG8B's six convs (batch 64, int32): bytes.  The
// int32 input, weight and the two int32 outputs are ≈428 MB per step
// (0.128 ms at 3.35 TB/s) against 60.65 G multiply-adds (0.061 ms at the
// 1,979 TOP/s int8 peak).  This kernel multiplies on the CUDA cores, far
// from either floor.
//
// Design: the tile GEMM of int_gemm.cuh with rows = output pixels, all of
// N·H·W as one dimension (so the 8² and 4² layers still fill 64-row
// tiles), contraction = the patch columns m = (ki·K + kj)·C + c, the
// repo's patch layout.  A is gathered straight from the NHWC input
// (implicit im2col: each thread decomposes its four fixed pixels once
// and its patch column once per step, the zero halo masked:
// patch_rows.cuh), so neither the patch matrix nor a padded input is
// formed — the TPU kernel staged row bands in VMEM instead.  B is the
// (K²C, F) weight.  The epilogue applies the NITRO scale and ReLU to the
// accumulator registers.
#include "patch_rows.cuh"

namespace {

using namespace nitro::gemm;

__global__ void __launch_bounds__(THREADS)
stream_conv_fwd_kernel(const int32_t* __restrict__ x,
                       const int32_t* __restrict__ w_flat,
                       int32_t* __restrict__ a_out,
                       int32_t* __restrict__ z_out, int H, int W, int C,
                       int F, int K, int P, nitro::Epilogue ep) {
  __shared__ Tiles t;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const PatchRowsA<false> a(x, nullptr, nitro::FastDiv(1), H, W, C, K, P, row0);
  const RowsB<false> b(w_flat, nullptr, F, nitro::FastDiv(1), col0);
  unsigned acc[TM][TN];
  mainloop(a, b, 0, K * K * C, t, acc);

  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = row0 + ty + 16 * i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = col0 + tx + 16 * j;
      if (f >= F) continue;
      const size_t o = (size_t)p * F + f;
      const int zs = ep.scale((int)acc[i][j]);
      z_out[o] = zs;
      a_out[o] = ep.relu(zs);
    }
  }
}

}  // namespace

// x (N,H,W,C) and w_flat (K·K·C, F) int32; a and z_star (N,H,W,F) int32,
// all contiguous.  Launches on `stream`; returns cudaGetLastError().
extern "C" int stream_conv_fwd_launch(const void* x, const void* w, void* a,
                                      void* z_star, int N, int H, int W,
                                      int C, int F, int K, int shift,
                                      int residual, int alpha_inv, int mu,
                                      void* stream) {
  const int P = N * H * W;
  nitro::Epilogue ep{shift, residual, alpha_inv, mu, 1};
  dim3 grid((P + BM - 1) / BM, (F + BN - 1) / BN);
  stream_conv_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)w, (int32_t*)a, (int32_t*)z_star, H,
      W, C, F, K, P, ep);
  return (int)cudaGetLastError();
}
