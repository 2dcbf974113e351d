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
// 0.14 µs at the 1,979 TOP/s int8 peak.  mlp4's layers read 37 and 36 MB.
//
// Design: an exact split-K GEMM on the int8 tensor cores, written as
// grad_xᵀ (M, B) = w (M, N) · maskedδ (B, N)ᵀ.
//   * Exact digits (digit_gemm.cuh): every int32 is four signed base-256
//     digits, Σ_n g·w ≡ Σ_{i+j ≤ 3} 2^(8(i+j)) · Σ_n g_i·w_j (mod 2^32),
//     each inner sum an s8×s8→s32 mma.sync m16n8k32.
//   * w's rows on the MMA's 16-row side, the batch on its 8-wide side:
//     both operands' contraction n is contiguous as they lie, so A is w
//     itself.  w is read once, with 16-byte cp.async copies of its int32
//     rows into a shared ring (4-byte copies where N % 4 != 0), and split
//     into digits as the fragments are built: each lane loads its four
//     values of a fragment register with one 16-byte shared load (rows
//     320 bytes apart: conflict-free) and a 4×4 byte transpose gives the
//     register of every plane.  No pre-pass or plane of w exists.  Each
//     warp takes its own digit count of w for every 32-deep step (the OR
//     of its digit words), so only the pairs its values need run: one at
//     the paper's init (w ±4) for each digit of δ.
//   * The masked δ: a pre-pass (digit_gemm.cuh's row_digits_kernel with
//     MASK) reads δ and z* once and writes the masked δ's four
//     n-contiguous digit planes (B, N padded to 64), at most 768 KB at
//     mlp4, and the most digits any masked value needs, on the card; the
//     GEMM branches (block-uniform) to the variant for that count and
//     stages the planes with 16-byte cp.async copies beside w's rows.
//   * Enough blocks: 64 rows of w × 64 samples a block, the contraction
//     split across blocks (digit_gemm.cuh's plan_splits, as the forward
//     matmuls plan it: VGG8B's 32 tiles × 16 stages run as 4 splits,
//     mlp4's 47–48 tiles × 47 stages as 2).  No split is deeper than
//     16,384, so no s32 accumulator overflows (|Σ| ≤ 4·2^14·2^14 = 2^30
//     a set).  The splits' tiles meet in the last block to arrive
//     (digit_gemm.cuh's sum_splits: slots in the call's scratch, the
//     tile's arrival counter): no atomicAdd into the output and no memset
//     of it.  The sums are staged in shared memory and written as whole
//     rows of grad_x.
// Per call a memset (the digit flag) and two device launches.
#include "digit_gemm.cuh"

namespace nitro {
namespace mgx {

using digits::MAXD;

constexpr int TM = 64;           // rows m of w (output columns) a block
constexpr int TB = 64;           // samples a block
constexpr int BK = digits::BK;   // contraction values a stage; Np is a multiple
constexpr int ROW = BK + 16;     // δ plane row in shared memory (bytes)
constexpr int WROW = 4 * BK + 64;  // w's int32 row in shared memory (bytes)
constexpr int THREADS = 256;
constexpr int RING = 163840;     // bytes of stages: one block an SM
constexpr int W_STAGE = TM * WROW;  // 20,480 B

struct Flags {
  int d_digits;  // most digits any masked δ needs
};

// Shapes of one call, its grid and its scratch: the flag, δ's (B, Np)
// planes, then one slot per (output tile, split) when the contraction is
// split.
struct Layout {
  int B, M, N;
  long long Np, d_plane;
  int m_tiles, b_tiles, splits, k_chunk;
  size_t d_off, parts_off, bytes;

  Layout(int B_, int M_, int N_, int sms) : B(B_), M(M_), N(N_) {
    Np = ((long long)N + BK - 1) / BK * BK;
    d_plane = (long long)B * Np;
    m_tiles = (M + TM - 1) / TM;
    b_tiles = (B + TB - 1) / TB;
    digits::plan_splits((long long)m_tiles * b_tiles, Np, sms, 8, &splits, &k_chunk, 1, 1);
    d_off = 256;
    parts_off = (d_off + (size_t)MAXD * d_plane + 255) / 256 * 256;
    bytes = parts_off + (splits > 1 ? (size_t)m_tiles * b_tiles * splits * digits::SPLIT_SLOT *
                                          sizeof(unsigned)
                                    : 0);
  }
};

struct Args {
  const int32_t* w;   // (M, N)
  const int8_t* db;   // δ's planes DB[i][b][n], rows Np apart
  int32_t* out;       // (B, M)
  unsigned* parts;    // the splits' slots, any contents
  unsigned* arrivals; // one counter per 64×64 output tile, zero
  long long d_plane, Np;
  int B, M, N, k_chunk;
  const Flags* flags;
};

// Stage contraction columns [k0, k0 + BK) of the tile's w rows (int32,
// zero past M and N) and of ND δ planes (zero past B) into `st`.
template <int ND, bool VEC>
__device__ __forceinline__ void load_stage(const Args& g, int8_t* st, int m0, int b0,
                                           long long k0) {
  if (VEC) {  // N % 4 == 0 and w 16-byte aligned: a copy is all in or all out
#pragma unroll
    for (int e = 0; e < TM * BK / 4 / THREADS; ++e) {
      const int c = threadIdx.x + THREADS * e, r = c / (BK / 4), k = 4 * (c % (BK / 4));
      const bool ok = m0 + r < g.M && k0 + k < g.N;
      digits::cp16(st + r * WROW + 4 * k, ok ? g.w + (size_t)(m0 + r) * g.N + k0 + k : g.w, ok);
    }
  } else {
#pragma unroll 4
    for (int c = threadIdx.x; c < TM * BK; c += THREADS) {
      const int r = c / BK, k = c % BK;
      const bool ok = m0 + r < g.M && k0 + k < g.N;
      digits::cp4(st + r * WROW + 4 * k, ok ? g.w + (size_t)(m0 + r) * g.N + k0 + k : g.w, ok);
    }
  }
  int8_t* ds = st + W_STAGE;
  const int r = threadIdx.x / 4, c = threadIdx.x % 4;  // TB·4 = THREADS
  const bool ok = b0 + r < g.B;
  const int8_t* src = g.db + (ok ? (size_t)(b0 + r) * g.Np + k0 + 16 * c : 0);
#pragma unroll
  for (int i = 0; i < ND; ++i)
    digits::cp16(ds + (i * TB + r) * ROW + 16 * c, src + i * g.d_plane, ok);
}

// The A fragment register q (rows +8 for q odd, bytes +16 for q ≥ 2) of
// every digit plane, from the four int32 values at `p`; ORs their digit
// words into `any`.
__device__ __forceinline__ void w_fragment(const int8_t* p, unsigned (&a)[MAXD][4], int q,
                                           unsigned& any) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const unsigned d0 = digits::digit_word(v.x), d1 = digits::digit_word(v.y);
  const unsigned d2 = digits::digit_word(v.z), d3 = digits::digit_word(v.w);
  any |= d0 | d1 | d2 | d3;
  unsigned pl[4];
  digits::plane_words(d0, d1, d2, d3, pl);
#pragma unroll
  for (int j = 0; j < MAXD; ++j) a[j][q] = pl[j];
}

// One staged slice.  Warp w owns w rows 16·(w % 4) (one m16 tile) and
// samples 32·(w / 4) (four n8 tiles); per 32-deep step it builds w's
// fragments, takes the warp's digit count nw of them, and runs the pairs
// i + j < MAXD with i < ND (δ) and j < nw (w), into the set of shift i + j.
template <int ND>
__device__ __forceinline__ void stage_mma(const int8_t* st, int a_off, int b_off,
                                          int (&acc)[MAXD][4][4]) {
  const int8_t* ds = st + W_STAGE;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    unsigned a[MAXD][4], any = 0u;
    const int8_t* p = st + a_off + 4 * kk;
    w_fragment(p, a, 0, any);
    w_fragment(p + 8 * WROW, a, 1, any);
    w_fragment(p + 64, a, 2, any);
    w_fragment(p + 8 * WROW + 64, a, 3, any);
    const int nw = (int)digits::digits_needed(__reduce_or_sync(0xffffffffu, any));
    unsigned b[ND][4][2];
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int np = 0; np < 2; ++np)
        digits::ldsm_x4(ds + i * TB * ROW + b_off + np * 16 * ROW + kk, b[i][2 * np][0],
                        b[i][2 * np][1], b[i][2 * np + 1][0], b[i][2 * np + 1][1]);
#pragma unroll
    for (int j = 0; j < MAXD; ++j) {
      if (j >= nw) break;  // warp-uniform: w's higher digits are zero here
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        if (i + j >= MAXD) continue;
#pragma unroll
        for (int t = 0; t < 4; ++t) digits::mma_s8(acc[i + j][t], a[j], b[i][t]);
      }
    }
  }
}

// The split's digit products, combined mod 2^32 into tot[t][e]: w row
// m = m0 + 16·(warp % 4) + lane/4 (+8 for e ≥ 2), sample
// b = b0 + 32·(warp / 4) + 8·t + 2·(lane % 4) + e % 2 (the mma C layout).
template <int ND, bool VEC>
__device__ __forceinline__ void run(const Args& g, int8_t* smem, int m0, int b0,
                                    long long k_begin, int nk, unsigned (&tot)[4][4]) {
  constexpr int STAGE = W_STAGE + ND * TB * ROW;
  constexpr int FIT = RING / STAGE;
  constexpr int S = FIT > 6 ? 6 : FIT;
  int acc[MAXD][4][4];
#pragma unroll
  for (int s = 0; s < MAXD; ++s)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][t][e] = 0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int a_off = (16 * (warp % 4) + lane / 4) * WROW + 16 * (lane % 4);
  const int b_off = (32 * (warp / 4) + lane % 8 + 8 * (lane / 16)) * ROW + 16 * ((lane / 8) % 2);
#pragma unroll 1
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load_stage<ND, VEC>(g, smem + s * STAGE, m0, b0, k_begin + s * BK);
    digits::cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    digits::cp_wait<S - 2>();
    __syncthreads();
    const int nxt = kt + S - 1;
    if (nxt < nk) load_stage<ND, VEC>(g, smem + (nxt % S) * STAGE, m0, b0, k_begin + nxt * BK);
    digits::cp_commit();
    stage_mma<ND>(smem + (kt % S) * STAGE, a_off, b_off, acc);
  }
  digits::cp_wait<0>();
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      unsigned v = 0u;
#pragma unroll
      for (int s = 0; s < MAXD; ++s) v += (unsigned)acc[s][t][e] << (8 * s);
      tot[t][e] = v;
    }
}

// One 64 m × 64 b tile of grad_xᵀ over one split of the contraction, for
// the δ digit count the pre-pass recorded.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1) grad_x_digit_kernel(Args g) {
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ bool last;
  const int m0 = blockIdx.x * TM, b0 = blockIdx.y * TB;
  const long long k_begin = (long long)blockIdx.z * g.k_chunk;
  const long long k_end = min(g.Np, k_begin + g.k_chunk);
  const int nk = k_end > k_begin ? (int)((k_end - k_begin) / BK) : 0;
  unsigned tot[4][4];
  switch (min(max(g.flags->d_digits, 1), MAXD)) {
    case 1: run<1, VEC>(g, smem, m0, b0, k_begin, nk, tot); break;
    case 2: run<2, VEC>(g, smem, m0, b0, k_begin, nk, tot); break;
    case 3: run<3, VEC>(g, smem, m0, b0, k_begin, nk, tot); break;
    default: run<4, VEC>(g, smem, m0, b0, k_begin, nk, tot); break;
  }
  if (gridDim.z > 1 &&
      !digits::sum_splits(g.parts, g.arrivals, (size_t)blockIdx.y * gridDim.x + blockIdx.x, tot,
                          last))
    return;
  // stage the whole sums as [b][m] in the ring, free once every warp is done
  unsigned* staged = reinterpret_cast<unsigned*>(smem);
  __syncthreads();
  {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int mb = 16 * (warp % 4) + lane / 4, bb = 32 * (warp / 4) + 2 * (lane % 4);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        staged[(bb + 8 * t + e % 2) * (TM + 1) + mb + 8 * (e / 2)] = tot[t][e];
  }
  __syncthreads();
#pragma unroll 1
  for (int i = threadIdx.x; i < TB * TM; i += THREADS) {  // consecutive threads, consecutive m
    const int b = b0 + i / TM, m = m0 + i % TM;
    if (b < g.B && m < g.M) g.out[(size_t)b * g.M + m] = (int)staged[(i / TM) * (TM + 1) + i % TM];
  }
}

}  // namespace mgx
}  // namespace nitro

using nitro::mgx::Layout;

// Bytes of the scratch a launch with these shapes needs.  sms: the card's
// SM count (sizes the splits).
extern "C" long long nitro_matmul_grad_x_scratch_bytes(int B, int M, int N, int sms) {
  return (long long)Layout(B, M, N, sms).bytes;
}

// delta and z_star (B,N), w (M,N) int32 contiguous; out (B,M) int32, any
// contents (every element is written); scratch of
// nitro_matmul_grad_x_scratch_bytes, 256-byte aligned, any contents;
// arrivals (one per 64×64 output tile) zero, left zero.  w_vec: N % 4 == 0
// and w 16-byte aligned (16-byte copies).  sms: the card's SM count.
// Launches on `stream`; returns the CUDA error.
extern "C" int nitro_matmul_grad_x_launch(const void* delta, const void* z_star,
                                          const void* w, void* out, void* scratch,
                                          void* arrivals, int B, int M, int N, int alpha_inv,
                                          int w_vec, int sms, void* stream) {
  using namespace nitro;
  const Layout L(B, M, N, sms);
  const cudaStream_t st = (cudaStream_t)stream;
  int8_t* s = (int8_t*)scratch;
  mgx::Flags* flags = (mgx::Flags*)s;
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(mgx::Flags), st);
  if (err != cudaSuccess) return (int)err;
  if (L.Np > 0) {
    const long long items = (long long)B * (L.Np / 4);
    const long long want = (items + 255) / 256;
    const int blocks = (int)(want < 8LL * sms ? (want > 0 ? want : 1) : 8LL * sms);
    digits::row_digits_kernel<true, int32_t><<<blocks, 256, 0, st>>>(
        (const int32_t*)delta, (const int32_t*)z_star, FastDiv((unsigned)alpha_inv),
        s + L.d_off, B, N, L.Np, L.d_plane, &flags->d_digits);
  }
  mgx::Args g;
  g.w = (const int32_t*)w;
  g.db = s + L.d_off;
  g.out = (int32_t*)out;
  g.parts = (unsigned*)(s + L.parts_off);
  g.arrivals = (unsigned*)arrivals;
  g.d_plane = L.d_plane;
  g.Np = L.Np;
  g.B = B;
  g.M = M;
  g.N = N;
  g.k_chunk = L.k_chunk;
  g.flags = flags;
  auto kern = w_vec ? mgx::grad_x_digit_kernel<true> : mgx::grad_x_digit_kernel<false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, mgx::RING);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(L.m_tiles, L.b_tiles, L.splits);
  kern<<<grid, mgx::THREADS, mgx::RING, st>>>(g);
  return (int)cudaGetLastError();
}
