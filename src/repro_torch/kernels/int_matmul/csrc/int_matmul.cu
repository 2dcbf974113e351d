// Exact integer matmul for Hopper: C = A·B mod 2^32, A (M,K) and B (K,N)
// int8 or int32, C int32: numerics.int_matmul on the card.
//
// Replaces: src/repro/core/numerics.py::int_matmul (an XLA dot_general with
//           preferred_element_type=int32, not a Pallas kernel).  Before
//           this kernel the port ran that product on the card as three
//           float64 GEMMs over 16-bit limbs (numerics.int_matmul_ref),
//           exact but not integer-only.
//
// Its callers: the learning and output layers' forward x·W (M = batch 64,
// N = 10 classes), grad_x δ·Wᵀ (K = 10) and grad_W xᵀ·δ (N = 10), where δ
// is wide and not proven to fit int8, Wᵀ and xᵀ transposed views; the
// materialise convs and the evaluation's im2col convs (wide int32 at
// scale); and the LM's NITRO int8 MLP products (int8 × int8, M = tokens).
//
// Three routes, one call each; the wrapper's pure-Python rule
// (int_matmul.py `plan`) picks one from dtypes, shapes, strides and
// alignment, and raises on anything no route takes:
//
//   T (thin): for int8 operands route W takes, at most 2^25 multiply-adds;
//     for the others, min(M, N) ≤ 16, or min(M, N) ≤ 128 and at most 2^26
//     multiply-adds; any integer dtypes and strides.  Bound: launches.  A
//     VGG8B step makes 23 such calls of about 2.6 M multiply-adds each (0.2
//     µs of arithmetic); on route D each took a memset and three launches,
//     plus a .contiguous() copy of every Wᵀ / xᵀ view.  Design: one launch,
//     no scratch, no memset: a block owns a 64 × 16 output tile and a split
//     of the contraction, stages 32 columns of A and B through shared
//     memory, read through their strides (the unit-stride dimension on
//     consecutive threads), and multiply-adds in unsigned on the CUDA cores
//     (wraps mod 2^32: integer sums are exact in any order).  A short tile
//     list is split over K so that about two blocks an SM run, each at
//     least four stages deep; the splits add their sums with atomicAdd into
//     cuda_lib.split_workspace's persistent zeroed sums, and the last block
//     to arrive on its tile's counter reads them back with atomicExch(·, 0),
//     stores them and zeroes the counter, so the workspace is left zero.
//     The thresholds are the card's (tools_torch/int_matmul_routes.py,
//     [routes-edge], H100 80GB HBM3 at 700 W): int32 at M = 4,096, K =
//     2,048, T 0.034 ms against D's 0.049 at N = 16, D ahead from N = 32
//     (0.050 against 0.055); at a side of 64 to 128 T ahead to 2^26
//     multiply-adds (0.016 against 0.023); with both sides wide D ahead
//     even at K = 16 (0.017 against 0.019); int8, T ahead of W to 2^25
//     (0.011 against 0.012), W ahead from 2^26 even at a side of 16 (0.012
//     against 0.069).
//
//   W (wgmma): int8 A and B, 16 | K, A K-major (row-major), B K-major
//     (the (K, N) view of a row-major (N, K) tensor, as
//     models/common.py's int8 weight is stored) or N-major (transposed
//     into scratch first by one launch of transpose_s8_kernel), bases and
//     row strides 16-byte aligned.  Bound: operations at the LM's shapes
//     (M = 2,048, K = 2,048, N = 8,192: 2·M·K·N = 68.7 G ops at the 1,979
//     TOP/s int8 peak, 34.7 µs, against 88 MB of operands and int32
//     result, 26.3 µs at 3.35 TB/s).  Design: csrc_common/wgmma_s8.cuh, a
//     persistent warp-specialised GEMM, TMA into a 128-byte-swizzled ring,
//     two consumer warpgroups on wgmma m64n256k32 s8, 16,384-column folds
//     of the s32 accumulator into an unsigned total past that depth.
//
//   D (digits): everything else at scale: wide int32 operands, int8 with
//     K % 16 != 0, int8 × int32.  split_matmul.cuh's split-K GEMM over
//     exact signed base-256 digits on the int8 tensor cores (mma.sync
//     m16n8k32 s8), the one #1/#2 run, unchanged: only the digit pairs
//     i + j ≤ 3 the data needs, counted on the card; sums in unsigned; no
//     split deeper than 16,384; the last block to arrive adds the splits.
//     A memset and at most three device launches: B's planes, A's planes
//     (none when A is int8 with 16 | K and 16-byte aligned), the GEMM.
#include "split_matmul.cuh"
#include "wgmma_s8.cuh"

namespace nitro {
namespace imm {

struct Out {
  int32_t* out;        // C (M, N)
  unsigned* parts;     // the splits' slots [tile][split][SLOT], any contents
  unsigned* arrivals;  // one counter per 64×64 tile, zero
};

// No epilogue: the sum mod 2^32, as int32.
__device__ __forceinline__ void emit(const Out& o, size_t idx, unsigned z) {
  o.out[idx] = (int32_t)z;
}

}  // namespace imm

// ---------------------------------------------------------------------------
// Route T: thin products on the CUDA cores
// ---------------------------------------------------------------------------

namespace thin {

constexpr int BM = 64, BN = 16;  // output tile: rows m, columns n
constexpr int KC = 32;           // contraction columns a stage
constexpr int THREADS = 256;     // 4 rows × 1 column of the tile a thread
constexpr int AROW = BM + 4;     // As[k][·]: 16-byte-aligned rows
constexpr int MIN_STAGES = 4;    // a split is at least this deep

struct Args {
  const void* a;
  const void* b;
  int32_t* out;        // C (M, N) row-major
  unsigned* ws;        // ≥ M·N split sums, zero; left zero
  unsigned* arrivals;  // one counter per tile, zero; left zero
  long long sam, sak, sbk, sbn;  // element strides of A (m, k) and B (k, n)
  int M, N, K, m_tiles, chunk;   // chunk: contraction columns a split
};

template <class T>
__device__ __forceinline__ unsigned ld(const T* p, long long i, bool ok) {
  return ok ? (unsigned)(int)p[i] : 0u;
}

// Block (tile % m_tiles, tile / m_tiles) of 64 × 16 outputs over split
// blockIdx.z of the contraction.
template <class TA, class TB>
__global__ void __launch_bounds__(THREADS) thin_kernel(Args g) {
  __shared__ __align__(16) unsigned As[KC][AROW];
  __shared__ unsigned Bs[KC][BN];
  __shared__ bool last;
  const TA* a = static_cast<const TA*>(g.a);
  const TB* b = static_cast<const TB*>(g.b);
  const int tile = blockIdx.x, m0 = tile % g.m_tiles * BM, n0 = tile / g.m_tiles * BN;
  const int k_begin = blockIdx.z * g.chunk, k_end = min(g.K, k_begin + g.chunk);
  // element i of this thread's share of a stage: consecutive threads on
  // the operand's unit-stride dimension
  const bool a_k = g.sak == 1, b_n = g.sbn == 1;
  unsigned ra[BM * KC / THREADS], rb[KC * BN / THREADS];
  auto a_at = [&](int i, int& m, int& k) {
    const int idx = threadIdx.x + THREADS * i;
    m = a_k ? idx / KC : idx % BM;
    k = a_k ? idx % KC : idx / BM;
  };
  auto b_at = [&](int i, int& k, int& n) {
    const int idx = threadIdx.x + THREADS * i;
    n = b_n ? idx % BN : idx / KC;
    k = b_n ? idx / BN : idx % KC;
  };
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < BM * KC / THREADS; ++i) {
      int m, k;
      a_at(i, m, k);
      const int gm = m0 + m, gk = k0 + k;
      ra[i] = ld(a, gm * g.sam + gk * g.sak, gm < g.M && gk < k_end);
    }
#pragma unroll
    for (int i = 0; i < KC * BN / THREADS; ++i) {
      int k, n;
      b_at(i, k, n);
      const int gk = k0 + k, gn = n0 + n;
      rb[i] = ld(b, gk * g.sbk + gn * g.sbn, gk < k_end && gn < g.N);
    }
  };
  const int c = threadIdx.x % BN, r = 4 * (threadIdx.x / BN);
  unsigned acc[4] = {0u, 0u, 0u, 0u};
  fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += KC) {
    __syncthreads();  // the stage before is consumed
#pragma unroll
    for (int i = 0; i < BM * KC / THREADS; ++i) {
      int m, k;
      a_at(i, m, k);
      As[k][m] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < KC * BN / THREADS; ++i) {
      int k, n;
      b_at(i, k, n);
      Bs[k][n] = rb[i];
    }
    __syncthreads();
    if (k0 + KC < k_end) fetch(k0 + KC);  // in flight while this stage computes
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      const uint4 av = *reinterpret_cast<const uint4*>(&As[k][r]);
      const unsigned bv = Bs[k][c];
      acc[0] += av.x * bv;
      acc[1] += av.y * bv;
      acc[2] += av.z * bv;
      acc[3] += av.w * bv;
    }
  }
  const int n = n0 + c;
  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (m0 + r + i < g.M && n < g.N) g.out[(size_t)(m0 + r + i) * g.N + n] = (int)acc[i];
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (m0 + r + i < g.M && n < g.N) atomicAdd(&g.ws[(size_t)(m0 + r + i) * g.N + n], acc[i]);
  __threadfence();  // this split's sums are in before it counts in
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* arrival = &g.arrivals[tile];
    last = atomicAdd(arrival, 1u) == gridDim.z - 1;
    if (last) *arrival = 0u;  // every split has counted in: reset
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (m0 + r + i < g.M && n < g.N) {
      const size_t idx = (size_t)(m0 + r + i) * g.N + n;
      g.out[idx] = (int)atomicExch(&g.ws[idx], 0u);  // the whole sum; the slot zero again
    }
}

}  // namespace thin

// ---------------------------------------------------------------------------
// Route W's transpose pass: an N-major int8 B into the K-major scratch
// ---------------------------------------------------------------------------

// dst (N, K) row-major = src (K, N)ᵀ, int8, src rows `lds` bytes apart;
// 16 | K, dst 16-byte aligned.  A block moves a 64 × 64 tile; `vec`: src,
// lds and N allow 16-byte loads.
__global__ void __launch_bounds__(256) transpose_s8_kernel(const int8_t* src, int8_t* dst, int K,
                                                           int N, long long lds, int vec) {
  __shared__ int8_t tile[64][64 + 4];
  const int n0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  const int r = threadIdx.x / 4, q = 16 * (threadIdx.x % 4);
  const int k = k0 + r;
  if (vec && k < K && n0 + q + 16 <= N) {
    const int4 v = *reinterpret_cast<const int4*>(src + (size_t)k * lds + n0 + q);
    const int8_t* bytes = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 16; ++i) tile[r][q + i] = bytes[i];
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      tile[r][q + i] = k < K && n0 + q + i < N ? src[(size_t)k * lds + n0 + q + i] : (int8_t)0;
  }
  __syncthreads();
  const int n = n0 + r;
  if (n >= N || k0 + q >= K) return;
  int4 v;
  int8_t* bytes = reinterpret_cast<int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) bytes[i] = tile[q + i][r];
  *reinterpret_cast<int4*>(dst + (size_t)n * K + k0 + q) = v;
}

}  // namespace nitro

using nitro::mm::Layout;

// ---------------------------------------------------------------------------
// Route D
// ---------------------------------------------------------------------------

// Bytes of the scratch a launch with these shapes needs (as for
// nitro_matmul_scratch_bytes).
extern "C" long long int_matmul_scratch_bytes(int M, int N, int K, int a_int8, int b_int8,
                                              int a_direct, int sms) {
  return (long long)Layout(M, N, K, a_int8 != 0, b_int8 != 0, a_direct != 0, sms).bytes;
}

// a (M,K), b (K,N), c (M,N) int32, all row-major and contiguous; a and b
// int8 (a_int8 / b_int8) or int32.  scratch: int_matmul_scratch_bytes,
// 256-byte aligned, any contents; arrivals (one per 64×64 output tile)
// zero, left zero.  a_direct: a is int8 with 16 | K and 16-byte aligned,
// read by the GEMM as it is.  sms: the card's SM count.  Launches on
// `stream`; returns the CUDA error.
extern "C" int int_matmul_launch(const void* a, const void* b, void* c, void* scratch,
                                 void* arrivals, int M, int N, int K, int a_int8, int b_int8,
                                 int a_direct, int sms, void* stream) {
  const Layout L(M, N, K, a_int8 != 0, b_int8 != 0, a_direct != 0, sms);
  const nitro::imm::Out o{(int32_t*)c, nullptr, (unsigned*)arrivals};
  return nitro::mm::launch(L, a, a_int8 != 0, b, b_int8 != 0, scratch, o, sms,
                           (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// Route T
// ---------------------------------------------------------------------------

// c (M,N) int32 row-major = a·b; a (M,K) and b (K,N) int8 (a_int8 /
// b_int8) or int32, read through their element strides (sam, sak) and
// (sbk, sbn).  ws (≥ M·N) and arrivals (one per 64 × 16 output tile):
// cuda_lib.split_workspace's, zero, left zero.  One launch on `stream`;
// returns the CUDA error.
extern "C" int int_matmul_thin_launch(const void* a, const void* b, void* c, void* ws,
                                      void* arrivals, int M, int N, int K, int sam, int sak,
                                      int sbk, int sbn, int a_int8, int b_int8, int sms,
                                      void* stream) {
  using namespace nitro::thin;
  Args g;
  g.a = a;
  g.b = b;
  g.out = (int32_t*)c;
  g.ws = (unsigned*)ws;
  g.arrivals = (unsigned*)arrivals;
  g.sam = sam;
  g.sak = sak;
  g.sbk = sbk;
  g.sbn = sbn;
  g.M = M;
  g.N = N;
  g.K = K;
  g.m_tiles = (M + BM - 1) / BM;
  const long long tiles = (long long)g.m_tiles * ((N + BN - 1) / BN);
  const long long stages = (K + KC - 1) / KC;
  long long splits = 1;
  if (tiles < 2LL * sms) {  // too few tiles to fill the card: split K
    const long long want = (2LL * sms + tiles - 1) / tiles;
    const long long most = (stages + MIN_STAGES - 1) / MIN_STAGES;
    splits = want < most ? want : most;
  }
  const long long per = (stages + splits - 1) / splits;  // stages a split
  splits = (stages + per - 1) / per;
  if (splits > 65535) splits = 65535;  // (the wrapper keeps K far below)
  g.chunk = (int)(((stages + splits - 1) / splits) * KC);
  const dim3 grid((unsigned)tiles, 1, (unsigned)splits);
  cudaStream_t st = (cudaStream_t)stream;
  if (a_int8 && b_int8)
    thin_kernel<int8_t, int8_t><<<grid, THREADS, 0, st>>>(g);
  else if (a_int8)
    thin_kernel<int8_t, int32_t><<<grid, THREADS, 0, st>>>(g);
  else if (b_int8)
    thin_kernel<int32_t, int8_t><<<grid, THREADS, 0, st>>>(g);
  else
    thin_kernel<int32_t, int32_t><<<grid, THREADS, 0, st>>>(g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Route W
// ---------------------------------------------------------------------------

// c (M,N) int32 row-major = a·btᵀ mod 2^32; a (M,K) and bt (N,K) int8,
// row-major with row strides lda / ldb bytes; 16 | K, lda, ldb and both
// bases.  One launch on `stream`; returns the CUDA error.
extern "C" int int_matmul_wgmma_launch(const void* a, const void* bt, void* c, int lda, int ldb,
                                       int M, int N, int K, int sms, void* stream) {
  return nitro::wg::launch(a, lda, bt, ldb, (int32_t*)c, M, N, K, sms, (cudaStream_t)stream);
}

// dst (N,K) = src (K,N)ᵀ, int8; src rows lds bytes apart, dst contiguous
// and 16-byte aligned, 16 | K.  One launch on `stream`; returns the CUDA
// error.
extern "C" int int8_transpose_launch(const void* src, void* dst, int K, int N, int lds,
                                     void* stream) {
  const int vec = lds % 16 == 0 && N % 16 == 0 && (uintptr_t)src % 16 == 0;
  const dim3 grid((unsigned)((N + 63) / 64), (unsigned)((K + 63) / 64));
  nitro::transpose_s8_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int8_t*)src, (int8_t*)dst, K, N, lds, vec);
  return (int)cudaGetLastError();
}
