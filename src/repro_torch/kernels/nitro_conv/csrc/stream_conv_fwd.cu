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
// 1,979 TOP/s int8 peak as one digit product; conv 1's two x digits add
// 0.9 G).
//
// Design: the exact digit GEMM of conv_digits.cuh on the int8 tensor
// cores.  Rows are all N·H·W output pixels as one dimension (so the 8² and
// 4² layers still fill 128-row tiles), the contraction is the patch
// column m = (ki·K + kj)·C + c.  Pre-passes write x's digit planes (NHWC,
// or the patch matrix at conv 1's C = 3) and w's, transposed once per
// call to (F, K²C), and record how many digits each needs; the GEMM runs
// only those products, gathering its A stages straight from the planes
// with zero-filled 16-byte copies.  The epilogue applies the NITRO scale
// (the pow2 split of SF, then one floor divide by multiply-high) to the
// combined registers, stages z* in shared memory and writes z* and its
// ReLU as whole rows of 16-byte stores.  Per call a memset and three
// device launches.
#include "conv_digits.cuh"

using namespace nitro::conv;

namespace {

struct FwdOut {
  int32_t* a;
  int32_t* z;
  FastEpilogue ep;

  __device__ void operator()(const ConvArgs& g, const unsigned (&tot)[2][4][4], int row0,
                             int col0, int* tile) const {
    stage_tile(tile, tot, [&](int v) { return ep.scale(v); });
    __syncthreads();
    write_tile(tile, BM, row0, g.R, g.F, col0, z, [](int v) { return v; });
    write_tile(tile, BM, row0, g.R, g.F, col0, a, [&](int v) { return ep.relu(v); });
  }
};

}  // namespace

// Bytes of the scratch a launch with these shapes needs.
extern "C" long long stream_conv_fwd_scratch_bytes(int N, int H, int W, int C, int F,
                                                   int K, int x_int8) {
  return (long long)Layout(N, H, W, C, F, K, false, x_int8 != 0).bytes;
}

// x (N,H,W,C) int8 or int32 (x_int8), 16-byte aligned; w_flat (K·K·C, F)
// int8 or int32 (w_int8); a and z_star (N,H,W,F) int32; all contiguous;
// scratch of stream_conv_fwd_scratch_bytes, 256-byte aligned, any
// contents.  sms: the card's SM count (sizes the pre-passes).  Launches on
// `stream`; returns the CUDA error code.
extern "C" int stream_conv_fwd_launch(const void* x, const void* w, void* a, void* z_star,
                                      void* scratch, int N, int H, int W, int C, int F,
                                      int K, int x_int8, int w_int8, int shift,
                                      int residual, int alpha_inv, int mu, int sms,
                                      void* stream) {
  const Layout L(N, H, W, C, F, K, false, x_int8 != 0);
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = prepare(L, x, x_int8 != 0, w, w_int8 != 0, scratch, sms, st);
  if (err) return err;
  const FwdOut out{(int32_t*)a, (int32_t*)z_star,
                   FastEpilogue(shift, residual, alpha_inv, mu, 1)};
  return launch_gemm(L, x, scratch, false, out, st);
}
