// Integer tile GEMM shared by the hand-written Hopper input-gradient
// kernels:
//
//   acc[r, n] = Σ_k A(r, k) · B(k, n)      (int32 operands, wrapping mod 2^32)
//
// over one BM×BN output tile and a range of the contraction k.  The
// kernels differ only in how they stage A and B and in how they flush:
//
//   * stream_conv_grad_x: r = output pixel (n, h, w), k = patch column
//     (ki, kj, f), A = δ gathered from the NHWC tensor (implicit im2col)
//     and masked by the NITRO-ReLU derivative as it is gathered,
//     B = rot180_swap(w), and a flush that stores the int32 sum as it is;
//   * nitro_matmul_grad_x: r = sample, k = fan-out, A = masked δ, B = wᵀ
//     read from w's natural layout; the contraction is split across
//     blocks and each split's tile is added into the zeroed output with
//     atomicAdd on unsigned (exact: addition mod 2^32 gives the same bits
//     in any order).
//
// (The grad_W kernels run the int8 tensor-core digit GEMMs instead: the
// conv ones, stream_conv_grad_w and stream_conv_grad_w_opt, that of
// digit_gemm.cuh, the linear ones, nitro_matmul_grad_w and
// nitro_matmul_grad_w_opt, that of linear_grad_w.cuh; the forward convs,
// stream_conv and stream_conv_fwd, that of conv_digits.cuh.  SgdOut below
// is digit_gemm.cuh's.)
//
// Design (simple and exact; wgmma/TMA are later work): 256 threads, each
// a 4×4 micro-tile at stride 16 (shared-memory reads are broadcasts or
// conflict-free), BK = 16 contraction values staged per step through
// shared memory, accumulation in unsigned registers.
#pragma once

#include "nitro_epilogue.cuh"

namespace nitro {
namespace gemm {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

struct Tiles {
  int a[BK][BM + 1];  // +1: a warp's A stores spread over the banks
  int b[BK][BN];
};

// The same with B's rows padded too: for a B stager whose consecutive
// threads walk the contraction (a transposed operand), so that their
// stores spread over the banks (nitro_matmul_grad_x).
struct PaddedTiles {
  int a[BK][BM + 1];
  int b[BK][BN + 1];
};

// acc += A[tile rows, k_begin..k_end) · B[k_begin..k_end, tile cols]; the
// thread's micro-tile is rows ty + 16 i, cols tx + 16 j of the tile.
// TileSet is Tiles or PaddedTiles, and the stagers take its arrays.
template <class AStage, class BStage, class TileSet>
__device__ __forceinline__ void mainloop(AStage& a, BStage& b, int k_begin,
                                         int k_end, TileSet& t,
                                         unsigned (&acc)[TM][TN]) {
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    a.stage(t.a, k0, k_end);
    b.stage(t.b, k0, k_end);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      int av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = t.a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = t.b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = mac(acc[i][j], av[i], bv[j]);
    }
    __syncthreads();
  }
}

// B(k, n) = src[k·N + n] (0 past the edges), masked by relu_bwd against
// z[k·N + n] when MASK.  Each thread stages one fixed column; consecutive
// threads read consecutive n.
template <bool MASK>
struct RowsB {
  const int32_t* __restrict__ src;
  const int32_t* __restrict__ z;
  FastDiv alpha_inv;
  int N, n;
  bool ok;

  __device__ RowsB(const int32_t* src_, const int32_t* z_, int N_,
                   const FastDiv& alpha_inv_, int col0)
      : src(src_), z(z_), alpha_inv(alpha_inv_), N(N_),
        n(col0 + (int)threadIdx.x % BN), ok(n < N_) {}

  __device__ __forceinline__ void stage(int (&b)[BK][BN], int k0,
                                        int k_end) const {
#pragma unroll
    for (int e = 0; e < BK * BN / THREADS; ++e) {
      const int kk = threadIdx.x / BN + e * (THREADS / BN);
      const int k = k0 + kk;
      int v = 0;
      if (k < k_end && ok) {
        const size_t idx = (size_t)k * N + n;
        v = src[idx];
        if (MASK) v = relu_bwd(z[idx], v, alpha_inv);
      }
      b[kk][threadIdx.x % BN] = v;
    }
  }
};

// Flush for a split contraction: add the thread's micro-tile into the
// zeroed M×N output with atomicAdd (addition mod 2^32: any order, same bits).
__device__ __forceinline__ void flush_add(unsigned* __restrict__ out,
                                          const unsigned (&acc)[TM][TN],
                                          int row0, int col0, int M, int N) {
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) atomicAdd(&out[(size_t)r * N + c], acc[i][j]);
    }
  }
}

// What digit_gemm.cuh's fuse_opt flush reads and writes besides the GEMM's
// operands.
struct SgdOut {
  const int32_t* w;          // W, M×N
  int32_t* w_new;            // W′, M×N
  unsigned* ws;              // M×N split sums; zero before and after a launch
  unsigned* arrivals;        // one counter per output tile; zero likewise
  const int32_t* gamma_inv;  // 0-d device scalars of the optimiser state
  const int32_t* eta_inv;
};

// Splits of a contraction of depth P for a card with `slots`
// resident blocks: the fewest splits whose grid fills its last wave of
// blocks to 90% (else the best fill found), each split at least
// `min_chunk` deep, a multiple of BK.
inline void plan_splits(int M, int N, int P, int slots, int* splits,
                        int* p_chunk) {
  const int min_chunk = 128;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  long long most = (P + min_chunk - 1) / min_chunk;
  const long long enough = 8 * (long long)slots / tiles + 1;  // 8 waves
  if (most > enough) most = enough;
  if (most > 65535) most = 65535;
  int want = 1;
  double best = 0.0;
  for (long long s = 1; s <= most; ++s) {
    const long long blocks = tiles * s;
    const long long waves = (blocks + slots - 1) / slots;
    const double fill = (double)blocks / (double)(waves * slots);
    if (fill > best) {
      best = fill;
      want = (int)s;
    }
    if (fill >= 0.9) break;
  }
  int chunk = (P + want - 1) / want;
  chunk = (chunk + BK - 1) / BK * BK;
  if (chunk < BK) chunk = BK;  // P = 0: one empty split
  *p_chunk = chunk;
  *splits = P > 0 ? (P + chunk - 1) / chunk : 1;
}

// Grid and split depth of a launch of `kern` over an M×N output, sized from its
// occupancy on a card with `sms` SMs.  Returns a cudaError_t.
template <class Kernel>
int plan_grid(Kernel kern, int M, int N, int P, int sms, dim3* grid,
              int* p_chunk) {
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  int splits;
  plan_splits(M, N, P, sms * (per_sm > 0 ? per_sm : 1), &splits, p_chunk);
  *grid = dim3((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  return 0;
}

}  // namespace gemm
}  // namespace nitro
