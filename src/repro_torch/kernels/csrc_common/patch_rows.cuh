// The A stager of stream_conv_grad_x's implicit-im2col GEMM over output
// pixels (int_gemm.cuh):
//
//   A(p, m) = relu_bwd(z, x)[n, h + ki − K/2, w + kj − K/2, c]
//
// for pixel p = (n·H + h)·W + w and patch column m = (ki·K + kj)·C + c, the
// repo's patch layout, gathered straight from the NHWC tensors with the
// zero 'same' halo, so neither the patch matrix nor a padded copy exists.
// Each value is masked as it is staged (the grad_x prologue, x = δ and
// z = z*); the halo stays 0 without reading z, which is exact because
// relu_bwd(0, 0) = 0.
#pragma once

#include "int_gemm.cuh"

namespace nitro {
namespace gemm {

// Thread t stages patch column m = k0 + t % BK of the tile's pixels
// t / BK + 16 e (e = 0..3), so consecutive threads read consecutive
// channels of one pixel; each thread decomposes its four pixels once and
// its column once per step.
struct PatchRowsA {
  static constexpr int E = BM * BK / THREADS;
  const int32_t* __restrict__ x;
  const int32_t* __restrict__ z;
  FastDiv alpha_inv;
  int H, W, C, K;
  int n[E], h[E], w[E];
  bool ok[E];

  __device__ PatchRowsA(const int32_t* x_, const int32_t* z_,
                        const FastDiv& alpha_inv_, int H_, int W_, int C_,
                        int K_, int P, int row0)
      : x(x_), z(z_), alpha_inv(alpha_inv_), H(H_), W(W_), C(C_), K(K_) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int p = row0 + (int)threadIdx.x / BK + e * (THREADS / BK);
      ok[e] = p < P;
      const int q = ok[e] ? p : 0;
      const int t = q / W;
      w[e] = q - t * W;
      n[e] = t / H;
      h[e] = t - n[e] * H;
    }
  }

  __device__ __forceinline__ void stage(int (&a)[BK][BM + 1], int k0,
                                        int k_end) const {
    const int kk = threadIdx.x % BK;
    const int m = k0 + kk;
    const bool m_ok = m < k_end;
    const int seg = m_ok ? m / C : 0;
    const int c = m - seg * C;
    const int di = seg / K - K / 2, dj = seg % K - K / 2;
    // Every δ and z* load of the step goes out before the first value is
    // masked: masking each value as it arrived held the loads one by one
    // (1.4–2.3× the unmasked gather's time at the same shapes); the halo
    // loads nothing and masks relu_bwd(0, 0) = 0.
    int xv[E], zv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int hh = h[e] + di, ww = w[e] + dj;
      const bool in = m_ok && ok[e] && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const size_t idx = in ? (((size_t)n[e] * H + hh) * W + ww) * C + c : 0;
      xv[e] = in ? __ldg(&x[idx]) : 0;
      zv[e] = in ? __ldg(&z[idx]) : 0;
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      a[kk][threadIdx.x / BK + e * (THREADS / BK)] = relu_bwd(zv[e], xv[e], alpha_inv);
  }
};

}  // namespace gemm
}  // namespace nitro
