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
// the weight and grad_x are ≈428 MB per pass of the six (0.128 ms at
// 3.35 TB/s) against 60.65 G multiply-adds (0.061 ms at the 1,979 TOP/s
// int8 peak as one digit product), the forward's volume.
//
// Design: the exact digit GEMM of conv_digits.cuh on the int8 tensor
// cores, as stream_conv runs it at sf = 1 without the ReLU, on the masked
// δ.  Rows are all N·H·W pixels, the contraction is the patch column
// m = (ki·K + kj)·F + f of the rotated weight, the columns are the C input
// channels.  Per call a memset (the digit flags) and three launches, no
// host sync:
//   1. the masked pre-pass (conv_digits.cuh's x pre-pass with MASK): reads
//      δ and z* once, with the same 16-byte loads, masks each value by the
//      NITRO-ReLU derivative (0 where z* saturates, ⌊δ/α_inv⌋ where z* < 0,
//      δ elsewhere) and writes the masked δ's four NHWC digit planes, or
//      for F % 16 != 0 its patch planes with the zero halo (relu_bwd(0, 0)
//      = 0); flags.x_digits = the most digits any masked value needs.  The
//      masked δ is never written as int32, as on the TPU, where each δ band
//      was masked in VMEM;
//   2. w_rot_digits_kernel: the rotation folded into the index, w read as
//      it lies: row c of the (C, K²F padded to 64) digit planes the GEMM
//      reads as B is, segment by segment, the contiguous run w[K²−1−seg,
//      c, :], so no rotated copy of w exists; flags.w_digits;
//   3. conv_digit_gemm_kernel with an epilogue that stores the sum: only
//      the digit pairs i + j ≤ 3 the two counts allow, the fold every
//      16,384 columns (VGG8B's deepest contraction, 4,608, never folds).
// Conv 1 has C = 3 output columns, so 61 of a tile's 64 are empty: its
// GEMM does 21× the useful MMAs (PERF.md records what that costs).
#include "conv_digits.cuh"

using namespace nitro::conv;

namespace {

// One thread per (c, 16 patch columns m): WB[j][c][m] = digit j of
// w[K²−1−m / F, c, m % F] (0 past K²F), 16 bytes to each plane.
__global__ void __launch_bounds__(256)
w_rot_digits_kernel(const int32_t* __restrict__ w, int8_t* __restrict__ wb, int C, int F,
                    int KK, long long Mp, long long plane, int* need_out) {
  const long long chunks = Mp / 16, M = (long long)KK * F;
  unsigned need = 1u;
  for (long long it = blockIdx.x * (long long)blockDim.x + threadIdx.x; it < C * chunks;
       it += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(it / chunks);
    const long long m0 = 16 * (it - c * chunks);
    unsigned words[MAXD][4];
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) words[j][e] = 0u;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const long long m = m0 + e;
      int v = 0;
      if (m < M) {
        const int seg = (int)(m / F), f = (int)(m - (long long)seg * F);
        v = __ldg(w + ((long long)(KK - 1 - seg) * C + c) * F + f);
      }
      const unsigned b = nitro::digits::digit_bytes(v);
      need = max(need, nitro::digits::digits_needed(b));
#pragma unroll
      for (int j = 0; j < MAXD; ++j) words[j][e / 4] |= ((b >> (8 * j)) & 255u) << (8 * (e % 4));
    }
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
      *reinterpret_cast<uint4*>(wb + j * plane + c * Mp + m0) =
          make_uint4(words[j][0], words[j][1], words[j][2], words[j][3]);
  }
  need = __reduce_max_sync(0xffffffffu, need);
  if (threadIdx.x % 32 == 0) atomicMax(need_out, (int)need);
}

// The epilogue: the tile's sums as they are, staged and written as whole
// rows (value by value where C % 4 != 0).
struct GradXOut {
  int32_t* out;

  __device__ void operator()(const ConvArgs& g, const unsigned (&tot)[2][4][4], int row0,
                             int col0, int* tile) const {
    const auto same = [](int v) { return v; };
    stage_tile(tile, tot, same);
    __syncthreads();
    write_tile(tile, BM, row0, g.R, g.F, col0, out, same);
  }
};

}  // namespace

// Bytes of the scratch a launch with these shapes needs: δ (N,H,W,F), the
// output's C channels, K.
extern "C" long long stream_conv_grad_x_scratch_bytes(int N, int H, int W, int F, int C,
                                                      int K) {
  return (long long)Layout(N, H, W, F, C, K, false, false).bytes;
}

// delta and z_star (N,H,W,F) int32, 16-byte aligned; w (K,K,C,F) int32 as
// it lies; out (N,H,W,C) int32; all contiguous; scratch of
// stream_conv_grad_x_scratch_bytes, 256-byte aligned, any contents.  sms:
// the card's SM count (sizes the pre-passes).  Launches on `stream`;
// returns the CUDA error code.
extern "C" int stream_conv_grad_x_launch(const void* delta, const void* z_star, const void* w,
                                         void* out, void* scratch, int N, int H, int W, int F,
                                         int C, int K, int alpha_inv, int sms, void* stream) {
  // The GEMM's x is δ (F channels) and its filters are grad_x's C channels.
  const Layout L(N, H, W, F, C, K, false, false);
  const cudaStream_t st = (cudaStream_t)stream;
  int8_t* s = (int8_t*)scratch;
  Flags* flags = (Flags*)s;
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(Flags), st);
  if (err != cudaSuccess) return (int)err;
  x_planes(L, delta, false, (const int32_t*)z_star, nitro::FastDiv((unsigned)alpha_inv), s,
           sms, st);
  if (L.M > 0 && L.F > 0)
    w_rot_digits_kernel<<<grid_stride_blocks(L.F * (L.Mp / 16), sms), 256, 0, st>>>(
        (const int32_t*)w, s + L.wb_off, C, F, K * K, L.Mp, L.wb_plane, &flags->w_digits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_gemm(L, delta, scratch, false, GradXOut{(int32_t*)out}, st);
}
