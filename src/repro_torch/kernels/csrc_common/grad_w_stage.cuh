// The A-operand stagers of the grad_W GEMMs (int_gemm.cuh), shared by
// each weight-gradient kernel and its fuse_opt twin:
//
//   * DenseColumnsA — A(m, b) = x[b, m], the linear layer's input
//     transposed (nitro_matmul_grad_w, nitro_matmul_grad_w_opt);
//   * PatchColumnsA — A(m, p) the implicit im2col patch matrix transposed,
//     gathered from the NHWC input (stream_conv_grad_w,
//     stream_conv_grad_w_opt).
#pragma once

#include "int_gemm.cuh"

namespace nitro {
namespace gemm {

// A(m, b) = x[b, m]: thread t stages feature m = row0 + t % BM of the
// samples k0 + t / BM + 4e, so consecutive threads read consecutive m.
struct DenseColumnsA {
  struct Params {
    const int32_t* x;
    int M;
  };
  const int32_t* __restrict__ x;
  int M, m;
  bool ok;

  __device__ DenseColumnsA(const Params& p, int row0, int)
      : x(p.x), M(p.M), m(row0 + (int)threadIdx.x % BM), ok(m < p.M) {}

  __device__ __forceinline__ void stage(int (&a)[BK][BM + 1], int k0,
                                        int k_end) {
#pragma unroll
    for (int e = 0; e < BK * BM / THREADS; ++e) {
      const int kk = threadIdx.x / BM + e * (THREADS / BM);
      const int k = k0 + kk;
      a[kk][threadIdx.x % BM] = (ok && k < k_end) ? x[(size_t)k * M + m] : 0;
    }
  }
};

// A(m, p) = x[n, h + ki − K/2, w + kj − K/2, c] with m = (ki·K + kj)·C + c
// and p = (n·H + h)·W + w, 0 outside the image.  Thread t stages patch
// column m = row0 + t % BM (decomposed once) for the pixels
// k0 + t / BM + 4e, each decomposed as it is staged — by multiplying
// with W's and H's FastDiv constants, not by dividing.
struct PatchColumnsA {
  struct Params {
    const int32_t* x;
    int H, W, C, K, M;
    FastDiv by_w, by_h;
  };
  const int32_t* __restrict__ x;
  int H, W, C;
  FastDiv by_w, by_h;
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

}  // namespace gemm
}  // namespace nitro
