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
#include "int_gemm.cuh"

namespace {

using namespace nitro::gemm;

// A(m, p) = x[n, h + ki − K/2, w + kj − K/2, c] with m = (ki·K + kj)·C + c
// and p = (n·H + h)·W + w, 0 outside the image.  Thread t stages patch
// column m = row0 + t % BM (decomposed once) for the pixels
// k0 + t / BM + 4e, each decomposed as it is staged — by multiplying
// with W's and H's FastDiv constants, not by dividing.
struct PatchColumnsA {
  struct Params {
    const int32_t* x;
    int H, W, C, K, M;
    nitro::FastDiv by_w, by_h;
  };
  const int32_t* __restrict__ x;
  int H, W, C;
  nitro::FastDiv by_w, by_h;
  int di, dj, c;
  bool ok;

  __device__ PatchColumnsA(const Params& p, int row0, int)
      : x(p.x), H(p.H), W(p.W), C(p.C), by_w(p.by_w), by_h(p.by_h) {
    int m = row0 + (int)threadIdx.x % BM;
    ok = m < p.M;
    if (!ok) m = 0;
    const int seg = m / C;
    c = m - seg * C;
    di = seg / p.K - p.K / 2;
    dj = seg % p.K - p.K / 2;
  }

  __device__ __forceinline__ void stage(int (&a)[BK][BM + 1], int k0,
                                        int k_end) const {
#pragma unroll
    for (int e = 0; e < BK * BM / THREADS; ++e) {
      const int kk = threadIdx.x / BM + e * (THREADS / BM);
      const int q = k0 + kk;
      int v = 0;
      if (ok && q < k_end) {
        const int t = (int)by_w.div((unsigned)q), w = q - t * W;
        const int n = (int)by_h.div((unsigned)t), h = t - n * H;
        const int hh = h + di, ww = w + dj;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W)
          v = x[(((size_t)n * H + hh) * W + ww) * C + c];
      }
      a[kk][threadIdx.x % BM] = v;
    }
  }
};

}  // namespace

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
