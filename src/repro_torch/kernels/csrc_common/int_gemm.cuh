// Integer tile GEMM shared by the hand-written Hopper training kernels:
//
//   acc[r, n] = Σ_k A(r, k) · B(k, n)      (int32 operands, wrapping mod 2^32)
//
// over one BM×BN output tile and a range of the contraction k.  The
// kernels differ only in how they stage A and B and in how they flush:
//
//   * nitro_matmul_grad_w: r = input feature, k = the batch (every
//     sample), B = δ masked by the NITRO-ReLU derivative as it is loaded;
//     the contraction is split across blocks and each split's tile is
//     added into the zeroed output with atomicAdd on unsigned (exact:
//     addition mod 2^32 gives the same bits in any order);
//   * nitro_matmul_grad_w_opt: the same GEMM,
//     whose flush applies IntegerSGD to the whole sum and writes W′
//     (flush_sgd; with more than one split, through a workspace and a
//     per-tile arrival counter — see grad_w_opt_kernel);
//   * stream_conv_grad_x: r = output pixel (n, h, w), k = patch column
//     (ki, kj, f), A = δ gathered from the NHWC tensor (implicit im2col)
//     and masked by the NITRO-ReLU derivative as it is gathered,
//     B = rot180_swap(w), and a flush that stores the int32 sum as it is;
//   * nitro_matmul_grad_x: r = sample, k = fan-out, A = masked δ, B = wᵀ
//     read from w's natural layout; split and flushed like grad_w.
//
// (The conv grad_W kernels, stream_conv_grad_w and stream_conv_grad_w_opt,
// run the int8 tensor-core digit GEMM of digit_gemm.cuh instead, and the
// forward convs, stream_conv and stream_conv_fwd, that of conv_digits.cuh.)
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

// The weight-gradient kernel: out (M×N) += Σ_{k in this block's split}
// A(r, k) · relu_bwd(z, δ)(k, n), δ and z (P×N) row-major.  AStage is
// built from its Params, the tile's first row and the split's first k,
// and stages the A tile of one step per call, in order.
template <class AStage, bool MASK>
__global__ void __launch_bounds__(THREADS)
grad_w_kernel(typename AStage::Params prm, const int32_t* __restrict__ delta,
              const int32_t* __restrict__ zstar, unsigned* __restrict__ out,
              int M, int N, int P, int p_chunk, FastDiv alpha_inv) {
  __shared__ Tiles t;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int p_begin = blockIdx.z * p_chunk;
  const int p_end = min(P, p_begin + p_chunk);
  AStage a(prm, row0, p_begin);
  RowsB<MASK> b(delta, zstar, N, alpha_inv, col0);
  unsigned acc[TM][TN];
  mainloop(a, b, p_begin, p_end, t, acc);
  flush_add(out, acc, row0, col0, M, N);
}

// What the fuse_opt flush reads and writes besides the GEMM's operands.
struct SgdOut {
  const int32_t* w;          // W, M×N
  int32_t* w_new;            // W′, M×N
  unsigned* ws;              // M×N split sums; zero before and after a launch
  unsigned* arrivals;        // one counter per output tile; zero likewise
  const int32_t* gamma_inv;  // 0-d device scalars of the optimiser state
  const int32_t* eta_inv;
};

// IntegerSGD flush over the thread's micro-tile: W′ = integer_sgd(W, g),
// with g the registers (FROM_WS false) or the tile's sum in the split-K
// workspace, which it reads from L2 (__ldcg: the other splits' atomics
// resolve there and this block holds no stale copy in L1) and returns to
// zero.  Row by row, the loads go before the stores: the compiler cannot
// tell W′ from W or the workspace, so it keeps each load behind the
// stores before it, and each store waits for the load whose value it
// writes; load-store pairs would take one memory round trip each.  Per
// row a thread waits once for four loads, and holds four more registers,
// not sixteen.
template <bool FROM_WS>
__device__ __forceinline__ void flush_sgd(const SgdOut& o, const SgdDivisors& sgd,
                                          unsigned (&acc)[TM][TN], int row0,
                                          int col0, int M, int N) {
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const int c0 = col0 + tx;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
    const size_t row = (size_t)r * N + c0;
    int w[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (c0 + 16 * j < N) {
        if (FROM_WS) acc[i][j] = __ldcg(&o.ws[row + 16 * j]);
        w[j] = __ldg(&o.w[row + 16 * j]);
      }
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (c0 + 16 * j < N) {
        if (FROM_WS) o.ws[row + 16 * j] = 0u;
        o.w_new[row + 16 * j] = integer_sgd(w[j], (int)acc[i][j], sgd);
      }
    }
  }
}

// The weight-update kernel: grad_w_kernel's GEMM with IntegerSGD in the
// flush, so W′ is written and grad_W never is.  IntegerSGD floors the
// *whole* sum, so a split tile cannot apply it alone.  With one split the
// registers hold the whole sum and the flush applies it directly.  With
// more, each split adds its tile into the workspace with atomicAdd,
// fences, and counts itself in on the tile's arrival counter; the last to
// arrive reads the summed tile back, applies IntegerSGD against W, writes
// W′, and returns the tile's workspace and counter to zero for the next
// launch.  One launch per call.
//
// Registers decide its speed: the flush needs more of them than the main
// loop, and past 48 only four blocks fit an SM where grad_w_kernel (46–47)
// fits five.  So thread 0 builds the IntegerSGD divisors (a 64-bit
// division each) into shared memory before the main loop, where almost
// nothing is live, and the launch bounds ask for five blocks an SM (48
// registers; ptxas spills 4 bytes, in the flush).
template <class AStage>
__global__ void __launch_bounds__(THREADS, 5)
grad_w_opt_kernel(typename AStage::Params prm, const int32_t* __restrict__ delta,
                  const int32_t* __restrict__ zstar, SgdOut o, int M, int N,
                  int P, int p_chunk, FastDiv alpha_inv) {
  __shared__ Tiles t;
  __shared__ __align__(8) unsigned char sgd_bytes[sizeof(SgdDivisors)];
  __shared__ bool last;
  SgdDivisors& sgd = *reinterpret_cast<SgdDivisors*>(sgd_bytes);
  if (threadIdx.x == 0) sgd = SgdDivisors(o.gamma_inv, o.eta_inv);
  __syncthreads();
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int p_begin = blockIdx.z * p_chunk;
  const int p_end = min(P, p_begin + p_chunk);
  AStage a(prm, row0, p_begin);
  RowsB<true> b(delta, zstar, N, alpha_inv, col0);
  unsigned acc[TM][TN];
  mainloop(a, b, p_begin, p_end, t, acc);
  if (gridDim.z == 1) {
    flush_sgd<false>(o, sgd, acc, row0, col0, M, N);
    return;
  }
  flush_add(o.ws, acc, row0, col0, M, N);
  __threadfence();  // this block's sums are visible before it counts in
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* arrival = &o.arrivals[blockIdx.y * gridDim.x + blockIdx.x];
    last = atomicAdd(arrival, 1u) == gridDim.z - 1;
    if (last) *arrival = 0u;  // every split has counted in: reset
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  flush_sgd<true>(o, sgd, acc, row0, col0, M, N);
}

// Splits of a grad_W contraction of depth P for a card with `slots`
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

// Grid and split depth of a grad_W-shaped launch of `kern`, sized from its
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

// Launch grad_w_kernel on `stream` into `out` (M×N int32, zeroed by the
// caller); z* null means plain δ.  Returns cudaGetLastError().
template <class AStage>
int launch_grad_w(const typename AStage::Params& prm, const void* delta,
                  const void* zstar, void* out, int M, int N, int P,
                  int alpha_inv, int sms, void* stream) {
  auto kern = zstar ? grad_w_kernel<AStage, true> : grad_w_kernel<AStage, false>;
  dim3 grid;
  int p_chunk;
  const int err = plan_grid(kern, M, N, P, sms, &grid, &p_chunk);
  if (err) return err;
  kern<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      prm, (const int32_t*)delta, (const int32_t*)zstar, (unsigned*)out, M, N,
      P, p_chunk, FastDiv((unsigned)alpha_inv));
  return (int)cudaGetLastError();
}

// Launch grad_w_opt_kernel on `stream`: W′ into o.w_new; o.ws (M×N) and
// o.arrivals (one per 64×64 output tile) must be zero, and are left zero.
// Returns cudaGetLastError().
template <class AStage>
int launch_grad_w_opt(const typename AStage::Params& prm, const void* delta,
                      const void* zstar, const SgdOut& o, int M, int N, int P,
                      int alpha_inv, int sms, void* stream) {
  auto kern = grad_w_opt_kernel<AStage>;
  dim3 grid;
  int p_chunk;
  const int err = plan_grid(kern, M, N, P, sms, &grid, &p_chunk);
  if (err) return err;
  kern<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      prm, (const int32_t*)delta, (const int32_t*)zstar, o, M, N, P, p_chunk,
      FastDiv((unsigned)alpha_inv));
  return (int)cudaGetLastError();
}

}  // namespace gemm
}  // namespace nitro
