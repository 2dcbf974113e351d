// The A-operand stager of the linear grad_W GEMMs (int_gemm.cuh),
// shared by nitro_matmul_grad_w and its fuse_opt twin
// nitro_matmul_grad_w_opt: DenseColumnsA, A(m, b) = x[b, m], the linear
// layer's input transposed.  (The conv grad_W kernels run the digit GEMM
// of digit_gemm.cuh.)
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

}  // namespace gemm
}  // namespace nitro
