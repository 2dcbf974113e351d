// Exact int32 linear weight gradient on Hopper's int8 tensor cores,
// shared by nitro_matmul_grad_w and its fuse_opt twin
// nitro_matmul_grad_w_opt:
//
//   grad_W[m, n] = Σ_p x[p, m] · relu_bwd(z*, δ)[p, n]   (mod 2^32)
//
// with x (B, M) the layer's input, δ and z* (B, N), grad_W (M, N).  The
// contraction is the batch (64 on the main path) and the output is the
// whole weight, so the kernel is a shallow GEMM that streams a
// weight-sized output: bound by bytes (the int32 gradient written once;
// for the update, W read and W′ written).
//
// Exact digits, as in digit_gemm.cuh: every int32 v is four signed
// base-256 digits d0..d3 in [−128, 127] with v ≡ Σ_i 2^(8i)·d_i
// (mod 2^32), so Σ_p x·g ≡ Σ_{i+j ≤ 3} 2^(8(i+j)) · Σ_p x_i·g_j, each
// inner sum an s8×s8→s32 mma.sync m16n8k32.  The digit bytes of v are
// (v + 0x808080) ^ 0x808080: adding 128 at each of the three low digits
// makes them the unsigned bytes d_i + 128 with no carry, and the top byte
// keeps d3 mod 256 (the same bytes as digit_gemm.cuh's digit_bytes).
//
// Design, for a shallow contraction and a weight-sized output (what each
// choice saves on an H100: PERF.md, from tools_torch/digit_gemm_variants.py):
//   * No pre-pass, no scratch, no memset: one launch per call.  A block
//     owns a 64-column panel of the output and walks its 128-row tiles
//     blockIdx.y · tiles onwards, as many as make the grid one wave of
//     resident blocks (mlp4's 3072 × 3000 layer: 47 panels × 5 tile groups
//     of up to 5 tiles; VGG8B's linear: one tile a block).  Per tile it
//     walks the batch in chunks of 64 samples: it reads its x slab
//     x[p, m0:m0+128] and its δ and z* slabs [p, n0:n0+64] straight from
//     the int32 tensors (a thread takes one column and 16 samples; a
//     warp's loads cover 32 consecutive columns), masks δ with relu_bwd,
//     splits both into digits in registers and stores them to shared
//     memory transposed to sample-contiguous rows, four samples a 32-bit
//     word per digit plane (a 4×4 byte transpose of four digit words),
//     rows padded to 80 bytes for conflict-free stores and ldmatrix reads
//     (digit_gemm.cuh's layout, MMA step and lane offsets).  With one chunk
//     (B ≤ 64, the main path) the panel's δ planes are staged once and
//     serve all its tiles.
//   * The digit count per tile and chunk, on the card: each warp ORs its
//     digit words, the block ORs the warps', and the highest nonzero byte
//     of x's and of δ's OR gives the digits each needs.  Only the pairs
//     i + j ≤ 3 those counts allow run, through block-uniform branches: no
//     host sync, no global flag, no compiled variants.
//   * Pairs in sequence, one s32 set: the pairs of one shift 8s run into
//     one accumulator set (two m16n8k32 steps each per chunk), which is
//     added into the total (mod 2^32) shifted by 8s and freed for the next
//     shift; the first chunk's shift-0 pair runs into the zeroed total
//     itself.  A set holds at most four pairs over one chunk, |Σ| ≤
//     4·64·2^14 = 2^22, so no batch depth can overflow it: the total folds
//     every 64 samples.
//   * No split-K: the tiles fill the card, so nothing is summed across
//     blocks: the gradient is stored once (no zero-fill, no atomics) and
//     the update applies IntegerSGD from the registers (no workspace, no
//     arrival counter), with SgdMagic's 32-bit multiply-high divisors
//     (64-bit ones made the update ALU-bound).
//   * Two blocks an SM (at most 128 registers a thread, 60 KB of planes,
//     96 KB with the update's W tile), so one block's loads and arithmetic
//     overlap the other's stores; each warp store writes eight whole
//     32-byte sectors (two int32 a thread) with the evict-first hint.  The
//     update copies each W tile into shared memory with cp.async before
//     it stages the tile's first chunk, so W's read is in flight under the
//     GEMM (read in the flush instead, it is exposed).  Loading x's next
//     slab while a tile is flushed, and writing only the x planes the count
//     needs, measured no faster and were left out.
#pragma once

#include "digit_gemm.cuh"

namespace nitro {
namespace lgw {

using digits::BK;  // samples a chunk (bytes a digit-plane row holds)
using digits::BM;  // output rows m a block
using digits::BN;  // output columns n a block
using digits::MAXD;
using digits::ROW;
using digits::THREADS;

constexpr int X_PLANES = MAXD * BM * ROW;  // x's digit planes: 40,960 B
constexpr int G_PLANES = MAXD * BN * ROW;  // masked δ's: 20,480 B
constexpr int W_ROW = BN + 8;              // int32 a row of the staged W tile
constexpr int SMEM = X_PLANES + G_PLANES;
constexpr int SMEM_OPT = SMEM + BM * W_ROW * 4;  // + the W tile: 98,304 B
constexpr int RUN = 16;                          // samples a thread stages a row

struct Args {
  const int32_t* x = nullptr;      // (B, M)
  const int32_t* delta = nullptr;  // (B, N)
  const int32_t* z = nullptr;      // (B, N)
  int32_t* out = nullptr;          // #3: grad_W (M, N)
  const int32_t* w = nullptr;      // #4: W (M, N)
  int32_t* w_new = nullptr;        // #4: W′ (M, N)
  const int32_t* gamma_inv = nullptr;  // #4: 0-d device scalars of the optimiser state
  const int32_t* eta_inv = nullptr;
  int B = 0, M = 0, N = 0;
  int m_tiles = 0;  // 128-row tiles of the output
  int tiles = 0;    // of them a block takes, in order
  FastDiv alpha_inv;
  int w_vec = 0;  // #4: W's rows are 16-byte aligned (N % 4 == 0): 16-byte copies
  int pairs = 0;  // N even and the outputs 8-byte aligned: two stored at a time
};

using digits::digit_word;

// The 16 digit words of one row's run of samples → the run's 16 bytes in
// each of the four planes at dst (planes `plane` bytes apart): per four
// samples a 4×4 byte transpose, sample s in byte s % 4.
__device__ __forceinline__ void put_run(int8_t* dst, int plane, const unsigned (&dw)[RUN]) {
  unsigned p[4][MAXD];
#pragma unroll
  for (int w = 0; w < 4; ++w)
    digits::plane_words(dw[4 * w], dw[4 * w + 1], dw[4 * w + 2], dw[4 * w + 3], p[w]);
#pragma unroll
  for (int j = 0; j < MAXD; ++j)
    *reinterpret_cast<uint4*>(dst + j * plane) = make_uint4(p[0][j], p[1][j], p[2][j], p[3][j]);
}

// The update's W tile (BM rows × BN int32, rows W_ROW apart) into shared
// memory: one cp.async group, 16-byte copies when W's rows allow them.
__device__ __forceinline__ void stage_w(const Args& a, int32_t* wt, int m0, int n0) {
  if (a.w_vec) {
#pragma unroll
    for (int e = 0; e < BM * BN / 4 / THREADS; ++e) {
      const int c = threadIdx.x + THREADS * e, r = c / (BN / 4), k = 4 * (c % (BN / 4));
      const bool ok = m0 + r < a.M && n0 + k < a.N;  // N % 4 == 0: a copy is all in or out
      digits::cp16(wt + r * W_ROW + k, ok ? a.w + (size_t)(m0 + r) * a.N + n0 + k : a.w, ok);
    }
  } else {
#pragma unroll 4
    for (int c = threadIdx.x; c < BM * BN; c += THREADS) {
      const int r = c / BN, k = c % BN;
      const bool ok = m0 + r < a.M && n0 + k < a.N;
      digits::cp4(wt + r * W_ROW + k, ok ? a.w + (size_t)(m0 + r) * a.N + n0 + k : a.w, ok);
    }
  }
  digits::cp_commit();
}

// Stage samples [p0, p0 + BK) of the tile's x columns as digit planes
// (0 past M and B); ORs the thread's digit words into or_x.  Thread t
// takes column m0 + t % 128 and the runs of 16 samples t / 128 and
// t / 128 + 2; every load is issued before the first is used.
__device__ __forceinline__ void stage_x(const Args& a, int8_t* xs, int m0, int p0,
                                        unsigned& or_x) {
  const int r = threadIdx.x % BM;
  const bool ok = m0 + r < a.M;
  int v[2][RUN];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = p0 + RUN * (threadIdx.x / BM + 2 * e);  // the run's first sample
    const int32_t* src = a.x + (size_t)q * a.M + m0 + r;
    if (ok && q + RUN <= a.B) {  // the whole run exists (the main path)
#pragma unroll
      for (int s = 0; s < RUN; ++s) v[e][s] = __ldg(src + (size_t)s * a.M);
    } else {
#pragma unroll
      for (int s = 0; s < RUN; ++s) v[e][s] = ok && q + s < a.B ? __ldg(src + (size_t)s * a.M) : 0;
    }
  }
  unsigned dw[RUN];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int s = 0; s < RUN; ++s) {
      dw[s] = digit_word(v[e][s]);
      or_x |= dw[s];
    }
    put_run(xs + r * ROW + RUN * (threadIdx.x / BM + 2 * e), BM * ROW, dw);
  }
}

// The same for the panel's masked δ columns: thread t takes column
// n0 + t % 64 and the run t / 64; ORs into or_g.
__device__ __forceinline__ void stage_g(const Args& a, int8_t* gs, int n0, int p0,
                                        unsigned& or_g) {
  const int r = threadIdx.x % BN, q = threadIdx.x / BN;
  const bool okn = n0 + r < a.N;
  int dv[RUN], zv[RUN];
#pragma unroll
  for (int s = 0; s < RUN; ++s) {
    const int p = p0 + RUN * q + s;
    const bool ok = okn && p < a.B;
    const size_t idx = (size_t)p * a.N + n0 + r;
    dv[s] = ok ? __ldg(a.delta + idx) : 0;
    zv[s] = ok ? __ldg(a.z + idx) : 0;
  }
  unsigned dw[RUN];
#pragma unroll
  for (int s = 0; s < RUN; ++s) {
    dw[s] = digit_word(relu_bwd(zv[s], dv[s], a.alpha_inv));  // relu_bwd(0, 0) = 0 past B
    or_g |= dw[s];
  }
  put_run(gs + r * ROW + RUN * q, BN * ROW, dw);
}

// The tile's sums to the output, in the mma C layout (rows mb + 16 mt +
// 8 h, columns nb + 8 nt + (0, 1)): grad_W, or W′ from the staged W tile.
template <bool OPT>
__device__ __forceinline__ void flush(const Args& a, const int32_t* wt,
                                      const unsigned char* sgd_bytes,
                                      const int (&tot)[2][4][4], int m0, int n0) {
  // a copy in registers: the compiler cannot tell W′'s stores from shared
  // memory, so it would reload the divisors at every store (unused by #3)
  const SgdMagic sgd = *reinterpret_cast<const SgdMagic*>(sgd_bytes);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mb = m0 + 32 * (warp % 4) + lane / 4, nb = n0 + 32 * (warp / 4) + 2 * (lane % 4);
  int32_t* dst = OPT ? a.w_new : a.out;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mb + 16 * mt + 8 * h;
      if (m >= a.M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int f = nb + 8 * nt;
        if (f >= a.N) continue;
        const size_t idx = (size_t)m * a.N + f;
        int v0 = tot[mt][nt][2 * h], v1 = tot[mt][nt][2 * h + 1];
        if (OPT) {
          const int32_t* w = wt + (m - m0) * W_ROW + (f - n0);
          v0 = integer_sgd(w[0], v0, sgd);
          v1 = integer_sgd(w[1], v1, sgd);  // past N: not stored
        }
        if (a.pairs) {  // f even, N even: f + 1 < N
          __stcs(reinterpret_cast<int2*>(dst + idx), make_int2(v0, v1));
        } else {
          __stcs(dst + idx, v0);
          if (f + 1 < a.N) __stcs(dst + idx + 1, v1);
        }
      }
    }
}

// A 64-column panel of the output, its 128-row tiles blockIdx.y · tiles
// up to the next group's, each over the whole batch.  OPT false: grad_W
// into a.out; OPT true: W′ = integer_sgd(W, grad_W) into a.w_new.  With
// one chunk (B ≤ 64) the panel's masked δ planes are staged once and
// serve every tile.
template <bool OPT>
__global__ void __launch_bounds__(THREADS, 2) grad_w_digit_kernel(Args a) {
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ unsigned warp_or[THREADS / 32][2];
  __shared__ __align__(8) unsigned char sgd_bytes[sizeof(SgdMagic)];
  int8_t* xs = smem;
  int8_t* gs = smem + X_PLANES;
  int32_t* wt = reinterpret_cast<int32_t*>(smem + SMEM);
  const int n0 = blockIdx.x * BN;
  const int t_begin = blockIdx.y * a.tiles, t_end = min(a.m_tiles, t_begin + a.tiles);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool keep_g = a.B <= BK;  // one chunk: δ's planes and count serve every tile
  if (OPT && threadIdx.x == 0)  // the divisors (a 64-bit division each) once a block
    *reinterpret_cast<SgdMagic*>(sgd_bytes) = SgdMagic(a.gamma_inv, a.eta_inv);
  int a_off, b_off;
  digits::lane_offsets(a_off, b_off);
  int nd = 1;
  for (int t = t_begin; t < t_end; ++t) {
    const int m0 = t * BM;
    if (OPT) {
      if (t > t_begin) __syncthreads();  // every thread has read the last W tile
      stage_w(a, wt, m0, n0);
    }
    int tot[1][2][4][4];  // the total mod 2^32 (one set's layout, for the first sum)
    digits::zero(tot);
    for (int p0 = 0; p0 < a.B; p0 += BK) {
      const bool new_g = !keep_g || t == t_begin;
      unsigned or_x = 0u, or_g = 0u;
      stage_x(a, xs, m0, p0, or_x);
      if (new_g) stage_g(a, gs, n0, p0, or_g);
      or_x = __reduce_or_sync(0xffffffffu, or_x);
      or_g = __reduce_or_sync(0xffffffffu, or_g);
      if (lane == 0) {
        warp_or[warp][0] = or_x;
        warp_or[warp][1] = or_g;
      }
      __syncthreads();  // the planes and the warps' ORs are in place
#pragma unroll
      for (int i = 0; i < THREADS / 32; ++i) {
        or_x |= warp_or[i][0];
        or_g |= warp_or[i][1];
      }
      const int nx = (int)digits::digits_needed(or_x);
      if (new_g) nd = (int)digits::digits_needed(or_g);
#pragma unroll
      for (int s = 0; s < MAXD; ++s) {
        if (s > nx + nd - 2) break;  // no pair of this chunk has shift s or more
        if (s == 0 && p0 == 0) {  // the total is zero: the first sum lands in it as it is
          digits::stage_mma<1, 1>(xs, gs, a_off, b_off, tot);
          continue;
        }
        int acc[1][2][4][4];
        digits::zero(acc);
#pragma unroll
        for (int i = 0; i <= s; ++i)
          if (i < nx && s - i < nd)
            digits::stage_mma<1, 1>(xs + i * BM * ROW, gs + (s - i) * BN * ROW, a_off, b_off,
                                    acc);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              tot[0][mt][nt][e] =
                  (int)((unsigned)tot[0][mt][nt][e] + ((unsigned)acc[0][mt][nt][e] << (8 * s)));
      }
      __syncthreads();  // every warp is done with the planes before they are restaged
    }
    if (OPT) {
      digits::cp_wait<0>();
      __syncthreads();  // the W tile, copied by every thread, and the divisors
    }
    flush<OPT>(a, wt, sgd_bytes, tot[0], m0, n0);
  }
}

// The whole call on `st`: one launch of a grid (N / 64, M / (128 · tiles))
// rounded up, `tiles` the fewest 128-row tiles a block must take for the
// grid to fit the card's resident blocks (one wave; sms: its SM count).
// Returns a cudaError_t.
template <bool OPT>
int launch(Args a, int sms, cudaStream_t st) {
  auto kern = grad_w_digit_kernel<OPT>;
  const int smem = OPT ? SMEM_OPT : SMEM;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const long long panels = (a.N + BN - 1) / BN, slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  a.m_tiles = (a.M + BM - 1) / BM;
  a.tiles = (int)((panels * a.m_tiles + slots - 1) / slots);
  if (a.tiles < 1) a.tiles = 1;
  const dim3 grid((unsigned)panels, (unsigned)((a.m_tiles + a.tiles - 1) / a.tiles));
  kern<<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace lgw
}  // namespace nitro
