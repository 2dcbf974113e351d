// Fused NITRO matmul for Hopper: out = relu(⌊x @ w / SF⌋) − μ, or the
// scale alone (apply_relu = 0), into int8 or int32; and its training
// variant, which writes both a = relu(z*) − μ and z* = ⌊x @ w / SF⌋ from
// the same accumulator.
//
// Replaces: src/repro/kernels/nitro_matmul/nitro_matmul.py::nitro_matmul
//           (Pallas body _nitro_matmul_kernel), entry nitro_matmul_launch;
//           src/repro/kernels/nitro_matmul/nitro_matmul.py::nitro_matmul_fwd
//           (Pallas body _nitro_matmul_fwd_kernel), entry
//           nitro_matmul_fwd_launch.
//
// Bound on an H100 at the serving shapes (M = batch = 32): bytes.  The
// 2048×1024 int8 weight dominates (2 MiB, ≈0.6 µs at 3.35 TB/s) while the
// 134 M integer ops take ≈0.07 µs at the 1,979 TOP/s int8 peak.  The
// training forward (M = 64, int32 operands) is bound by bytes too: the
// 8 MiB int32 weight, ≈2.6 µs.
//
// Design (simple and exact first; wgmma/TMA are later work):
//   * one block per BM×BN output tile; the K loop runs inside the block,
//     because CUDA blocks run in no order and nothing carries across them
//     (on the TPU, K was the sequential "arbitrary" grid axis);
//   * each K step stages a BK-deep slice of x and w through shared memory
//     as int32 (int8 operands are widened on load), masked at the ragged
//     M/N/K edges — no padding copies;
//   * 256 threads, each a 4×4 micro-tile at stride 16 so shared-memory
//     reads are conflict-free and global stores coalesce;
//   * int32 accumulation in unsigned registers (wraps like XLA);
//   * the NITRO scale + ReLU epilogue runs on the accumulator registers and
//     only the narrowed activation is written (TWO_OUT: z* as well).
#include "nitro_epilogue.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

template <typename TIn, typename TOut, bool TWO_OUT>
__global__ void __launch_bounds__(THREADS)
nitro_matmul_kernel(const TIn* __restrict__ x, const TIn* __restrict__ w,
                    TOut* __restrict__ out, int32_t* __restrict__ zout, int M,
                    int N, int K, nitro::Epilogue ep) {
  __shared__ int xs[BK][BM + 1];
  __shared__ int ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);  // 16 × 16
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  unsigned acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: BM rows × BK cols, consecutive threads walk k (contiguous).
    for (int e = tid; e < BM * BK; e += THREADS) {
      int r = e / BK, kk = e % BK;
      int gr = row0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < M && gk < K) ? (int)x[(size_t)gr * K + gk] : 0;
    }
    // w tile: BK rows × BN cols, consecutive threads walk n (contiguous).
    for (int e = tid; e < BK * BN; e += THREADS) {
      int kk = e / BN, c = e % BN;
      int gk = k0 + kk, gc = col0 + c;
      ws[kk][c] = (gk < K && gc < N) ? (int)w[(size_t)gk * N + gc] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = nitro::mac(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int gr = row0 + ty + 16 * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int gc = col0 + tx + 16 * j;
      if (gc >= N) continue;
      const size_t o = (size_t)gr * N + gc;
      if constexpr (TWO_OUT) {
        const int zs = ep.scale((int)acc[i][j]);
        zout[o] = zs;
        nitro::store(&out[o], ep.relu(zs));
      } else {
        nitro::store(&out[o], ep((int)acc[i][j]));
      }
    }
  }
}

template <typename TIn, typename TOut, bool TWO_OUT = false>
int launch(const void* x, const void* w, void* out, void* zout, int M, int N,
           int K, nitro::Epilogue ep, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  nitro_matmul_kernel<TIn, TOut, TWO_OUT>
      <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          (const TIn*)x, (const TIn*)w, (TOut*)out, (int32_t*)zout, M, N, K, ep);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M,K), w (K,N), out (M,N), all row-major and contiguous.
// in_int8: both operands int8 (else both int32); out_int8: int8 output
// (else int32).  Launches on `stream`; returns cudaGetLastError().
extern "C" int nitro_matmul_launch(const void* x, const void* w, void* out,
                                   int M, int N, int K, int shift,
                                   int residual, int alpha_inv, int mu,
                                   int apply_relu, int in_int8, int out_int8,
                                   void* stream) {
  nitro::Epilogue ep{shift, residual, alpha_inv, mu, apply_relu};
  if (in_int8)
    return out_int8 ? launch<int8_t, int8_t>(x, w, out, nullptr, M, N, K, ep, stream)
                    : launch<int8_t, int32_t>(x, w, out, nullptr, M, N, K, ep, stream);
  return out_int8 ? launch<int32_t, int8_t>(x, w, out, nullptr, M, N, K, ep, stream)
                  : launch<int32_t, int32_t>(x, w, out, nullptr, M, N, K, ep, stream);
}

// Training forward: x (M,K), w (K,N) int32; a and z_star (M,N) int32, all
// row-major and contiguous.  a = relu(z*) − μ, z* = ⌊x @ w / SF⌋.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int nitro_matmul_fwd_launch(const void* x, const void* w, void* a,
                                       void* z_star, int M, int N, int K,
                                       int shift, int residual, int alpha_inv,
                                       int mu, void* stream) {
  nitro::Epilogue ep{shift, residual, alpha_inv, mu, 1};
  return launch<int32_t, int32_t, true>(x, w, a, z_star, M, N, K, ep, stream);
}
