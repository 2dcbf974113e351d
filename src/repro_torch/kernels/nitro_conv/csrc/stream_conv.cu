// Streaming implicit-im2col NITRO conv for Hopper: a K×K stride-1 'same'
// NHWC conv, NITRO Scaling, NITRO-ReLU and an optional fused 2×2/stride-2
// max-pool, written as int8 or int32.
//
// Replaces: src/repro/kernels/nitro_conv/nitro_conv.py::stream_conv
//           (Pallas body _stream_conv_kernel).
//
// Bound on an H100 at VGG8B's serving shapes (batch 32): operations.  The
// 3×3 convs do 1.2–9.7 G integer ops per launch against a few MiB of int8
// activations and weights, so at the 1,979 TOP/s int8 tensor-core peak
// the ops, not the 3.35 TB/s of memory, set the floor.
//
// Design: the exact digit GEMM of conv_digits.cuh on the int8 tensor
// cores, rows = output pixels, contraction = the patch column m =
// (ki·K + kj)·C + c.  The serving plan's int8 steps (convs 2–6) are read
// as they are — x is its own digit plane, w one digit — so they run one
// s8 product and no x pre-pass; conv 1 (int32 image, C = 3) and the
// grad_x route without z* (full-range int32 δ at sf = 1) take the digit
// pre-passes and only the products their data needs.  Epilogue: scale,
// ReLU (or neither), then, with the pool, the max over each 2×2 window:
// the GEMM rows are ordered by window (n, h/2, w/2, dy, dx), so a
// window's four rows are the four lanes l, l^4, l^8, l^12 of one warp's
// accumulator layout and two xor-shuffles take their max (a max of values
// has no tie to break).  Pixels the pool crops (odd H or W) are not
// computed.  The floor divides are multiply-highs; the results are staged
// in shared memory and written as whole rows of 16-byte stores.  Per call
// a memset and at most three device launches.
#include "conv_digits.cuh"

using namespace nitro::conv;

namespace {

struct ServeOut {
  void* out;
  FastEpilogue ep;
  int out_int8;

  // Rows [0, rows) of the staged tile to output rows row_base.. (< row_end).
  __device__ __forceinline__ void write(const ConvArgs& g, const int* tile, int rows,
                                        int row_base, int row_end, int col0) const {
    const auto same = [](int v) { return v; };
    if (out_int8)
      write_tile(tile, rows, row_base, row_end, g.F, col0, static_cast<int8_t*>(out), same);
    else
      write_tile(tile, rows, row_base, row_end, g.F, col0, static_cast<int32_t*>(out), same);
  }

  __device__ void operator()(const ConvArgs& g, const unsigned (&tot)[2][4][4], int row0,
                             int col0, int* tile) const {
    if (!g.pool) {
      stage_tile(tile, tot, ep);
      __syncthreads();
      write(g, tile, BM, row0, g.R, col0);
      return;
    }
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int rb = (warp % 4) * 32 + lane / 4, cb = (warp / 4) * 32 + 2 * (lane % 4);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            int v = ep((int)tot[mt][nt][2 * h + e]);
            v = max(v, __shfl_xor_sync(0xffffffffu, v, 4));
            v = max(v, __shfl_xor_sync(0xffffffffu, v, 8));
            if ((lane & 12) == 0) tile[((rb + 16 * mt + 8 * h) >> 2) * TS + cb + 8 * nt + e] = v;
          }
    __syncthreads();
    write(g, tile, BM / 4, row0 / 4, g.R / 4, col0);  // one output row a window
  }
};

}  // namespace

// Bytes of the scratch a launch with these shapes needs.
extern "C" long long stream_conv_scratch_bytes(int N, int H, int W, int C, int F, int K,
                                               int x_int8) {
  return (long long)Layout(N, H, W, C, F, K, false, x_int8 != 0).bytes;
}

// x (N,H,W,C) int8 or int32 (x_int8), 16-byte aligned; w_flat (K·K·C, F)
// int8 or int32 (w_int8); out (N,H,W,F), or (N,H/2,W/2,F) with pool, int8
// or int32 (out_int8); all contiguous; scratch of
// stream_conv_scratch_bytes, 256-byte aligned, any contents.  mu = 0
// without the ReLU.  sms: the card's SM count.  Launches on `stream`;
// returns the CUDA error code.
extern "C" int stream_conv_launch(const void* x, const void* w, void* out, void* scratch,
                                  int N, int H, int W, int C, int F, int K, int x_int8,
                                  int w_int8, int shift, int residual, int alpha_inv,
                                  int mu, int apply_relu, int pool, int out_int8, int sms,
                                  void* stream) {
  const Layout L(N, H, W, C, F, K, pool != 0, x_int8 != 0);
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = prepare(L, x, x_int8 != 0, w, w_int8 != 0, scratch, sms, st);
  if (err) return err;
  const ServeOut o{out, FastEpilogue(shift, residual, alpha_inv, mu, apply_relu),
                   out_int8};
  return launch_gemm(L, x, scratch, pool != 0, o, st);
}
