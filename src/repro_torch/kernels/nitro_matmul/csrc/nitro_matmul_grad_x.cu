// NITRO linear input gradient for Hopper: grad_x = relu_bwd(z*, δ) @ wᵀ,
// δ and z* (B, N), w (M, N) in its natural (fan_in, fan_out) layout →
// (B, M), int32 wrapping mod 2^32.
//
// Replaces: src/repro/kernels/nitro_matmul/nitro_matmul.py::nitro_matmul_grad_x
//           (Pallas body _nitro_grad_x_kernel).
//
// Bound on an H100 at VGG8B's linear block (B = 64, N = 1024, M = 2048,
// int32): bytes.  The 8 MiB weight read once dominates (≈2.8 µs at
// 3.35 TB/s with δ, z* and grad_x); the 134 M multiply-adds would take
// 0.14 µs at the 1,979 TOP/s int8 peak.
//
// Design: the split-K GEMM of int_gemm.cuh with rows r = sample,
// contraction k = fan-out n, columns = fan-in m.  A is δ masked by the
// NITRO-ReLU derivative as it is loaded (MaskedRowsA); B(n, m) = w[m, n]
// is read from w as it lies, with no transposed copy (TransposedB: 16
// consecutive threads read 16 consecutive n of one row of w, and the
// padded B tile spreads their shared-memory stores over the banks).  At
// batch 64 the output is one row of tiles, so the fan-out is split across
// blocks to fill the card, each split added into the zeroed output with
// atomicAdd on unsigned (exact in any order).
#include "int_gemm.cuh"

namespace {

using namespace nitro;
using namespace nitro::gemm;

constexpr int E = BM * BK / THREADS;  // values each thread stages per step

// A(r, k) = relu_bwd(z*[r, k], δ[r, k]), (B, N) row-major: thread t stages
// column k0 + t % BK of the tile's rows t / BK + 16 e.
struct MaskedRowsA {
  const int32_t* __restrict__ delta;
  const int32_t* __restrict__ z;
  FastDiv alpha_inv;
  int N;
  size_t row[E];
  bool ok[E];

  __device__ MaskedRowsA(const int32_t* delta_, const int32_t* z_,
                         const FastDiv& alpha_inv_, int B, int N_, int row0)
      : delta(delta_), z(z_), alpha_inv(alpha_inv_), N(N_) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int r = row0 + (int)threadIdx.x / BK + e * (THREADS / BK);
      ok[e] = r < B;
      row[e] = (size_t)(ok[e] ? r : 0) * N_;
    }
  }

  __device__ __forceinline__ void stage(int (&a)[BK][BM + 1], int k0,
                                        int k_end) const {
    const int kk = threadIdx.x % BK;
    const int k = k0 + kk;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      int v = 0;
      if (ok[e] && k < k_end) {
        const size_t idx = row[e] + k;
        v = relu_bwd(z[idx], delta[idx], alpha_inv);
      }
      a[kk][threadIdx.x / BK + e * (THREADS / BK)] = v;
    }
  }
};

// B(k, m) = w[m, k], w (M, N) row-major: thread t stages row k0 + t % BK
// of the tile's columns t / BK + 16 e.
struct TransposedB {
  const int32_t* __restrict__ w;
  int N;
  size_t col[E];
  bool ok[E];

  __device__ TransposedB(const int32_t* w_, int M, int N_, int col0)
      : w(w_), N(N_) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int m = col0 + (int)threadIdx.x / BK + e * (THREADS / BK);
      ok[e] = m < M;
      col[e] = (size_t)(ok[e] ? m : 0) * N_;
    }
  }

  __device__ __forceinline__ void stage(int (&b)[BK][BN + 1], int k0,
                                        int k_end) const {
    const int kk = threadIdx.x % BK;
    const int k = k0 + kk;
#pragma unroll
    for (int e = 0; e < E; ++e)
      b[kk][threadIdx.x / BK + e * (THREADS / BK)] =
          (ok[e] && k < k_end) ? w[col[e] + k] : 0;
  }
};

__global__ void __launch_bounds__(THREADS)
nitro_matmul_grad_x_kernel(const int32_t* __restrict__ delta,
                           const int32_t* __restrict__ zstar,
                           const int32_t* __restrict__ w,
                           unsigned* __restrict__ out, int B, int M, int N,
                           int k_chunk, FastDiv alpha_inv) {
  __shared__ PaddedTiles t;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(N, k_begin + k_chunk);
  const MaskedRowsA a(delta, zstar, alpha_inv, B, N, row0);
  const TransposedB b(w, M, N, col0);
  unsigned acc[TM][TN];
  mainloop(a, b, k_begin, k_end, t, acc);
  flush_add(out, acc, row0, col0, B, M);
}

}  // namespace

// delta and z_star (B,N), w (M,N) int32 contiguous; out (B,M) int32, zeroed
// by the caller.  sms: the card's SM count (sizes the splits).  Launches
// on `stream`; returns cudaGetLastError().
extern "C" int nitro_matmul_grad_x_launch(const void* delta, const void* z_star,
                                          const void* w, void* out, int B,
                                          int M, int N, int alpha_inv, int sms,
                                          void* stream) {
  dim3 grid;
  int k_chunk;
  const int err = plan_grid(nitro_matmul_grad_x_kernel, B, M, N, sms, &grid,
                            &k_chunk);
  if (err) return err;
  nitro_matmul_grad_x_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)delta, (const int32_t*)z_star, (const int32_t*)w,
      (unsigned*)out, B, M, N, k_chunk, FastDiv((unsigned)alpha_inv));
  return (int)cudaGetLastError();
}
