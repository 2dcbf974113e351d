// Exact int32 forward conv GEMM on Hopper's int8 tensor cores, shared by
// stream_conv (the serving step), stream_conv_fwd (the training forward)
// and stream_conv_grad_x (the input gradient: x = the masked δ, w =
// rot180_swap(w), its own pre-passes, stream_conv_grad_x.cu):
//
//   z[r, f] = Σ_m A(r, m) · B(m, f)   (mod 2^32)
//
// with r a GEMM row (an output pixel; with the fused 2×2 pool the pixels
// in pool-window order), m = (ki·K + kj)·C + c the patch column, A the
// implicit im2col of x (zero 'same' halo) and B = w as (K²C, F).  Each
// caller supplies the epilogue that turns z into its outputs.
//
// Exact digits, as in digit_gemm.cuh: every int32 is four signed
// base-256 digits in [−128, 127], Σ_m x·w ≡ Σ_{i+j ≤ 3} 2^(8(i+j)) ·
// Σ_m x_i·w_j (mod 2^32), and each inner sum is an s8×s8→s32 mma.sync.
// Only the digits the data needs run: x and w each record the most digits
// any of their values needs, and the GEMM branches (block-uniform) to one
// of sixteen compiled (x digits, w digits) variants.  An int8 value is its
// own digit 0, so VGG8B's convs 2–6 (x a NITRO-ReLU output or its pool,
// w at the paper's init) run one product, conv 1's normalised image two.
//
// One call, a memset and at most three device launches, no host sync:
//   1. x's digit planes, unless x is an int8 tensor with C % 16 == 0
//      (then the GEMM reads x itself as its one plane):
//        C % 16 == 0: x_digits_kernel writes the four NHWC digit planes
//          (4 × N·H·W·C bytes) — writing all four costs fewer bytes than
//          a second read of int32 x to learn its range first;
//        else (conv 1: C = 3; digits28: C = 1): patch_digits_kernel writes
//          the im2col patch matrix's digit planes, (N·H·W) × K²C padded to
//          a multiple of 64 columns, zero outside the image; the GEMM then
//          reads them as a 1×1 conv over K²C-padded channels;
//      and flags.x_digits = the most digits any x needs (for grad_x both
//      mask each δ by relu_bwd against z* as they read it: x_planes);
//   2. delta_digits_kernel (digit_gemm.cuh, unmasked) writes w's four
//      digit planes transposed to (F, K²C padded to 64) rows, and
//      flags.w_digits;
//   3. conv_digit_gemm_kernel: 128 rows × 64 filters a block, 8 warps of
//      32×32, 64 patch columns a stage.  A row's stage is 16-byte cp.async
//      copies from pixel r shifted by (ki − K/2, kj − K/2): each 16-byte
//      chunk lies inside one (ki, kj) segment because 16 | C, and the
//      zero-fill form of cp.async gives the halo, so no padded copy of x
//      exists.  ldmatrix fragments feed mma.sync m16n8k32 s8, one s32
//      accumulator set per shift 8(i+j), combined as unsigned shifts and
//      adds mod 2^32 before the epilogue.  The ring holds as many stages
//      (2–6) as the variant's planes fit in 184,320 B.
// No split-K: the epilogues (floor, ReLU, max) are not linear, so a block
// owns its whole contraction.  Every 16,384 columns the accumulators fold
// into unsigned sums kept in shared memory (a set holds at most four
// pairs' sums, |Σ| ≤ 4·2^14·2^14 = 2^30 < 2^31), so no depth overflows;
// VGG8B's deepest contraction (4,608) never folds.
#pragma once

#include "digit_gemm.cuh"

namespace nitro {
namespace conv {

using digits::BK;
using digits::BM;
using digits::BN;
using digits::MAXD;
using digits::ROW;
using digits::THREADS;

constexpr int RING = digits::SMEM;             // 184,320 B of stages
constexpr int FOLD = digits::MAX_CHUNK / BK;   // stages between folds
constexpr int SMEM = RING + 32 * THREADS * 4;  // + 32 folded sums a thread

struct Flags {
  int x_digits;  // most digits any x needs
  int w_digits;  // most digits any w needs
};

// Shapes of one call and its scratch: the flags, then x's planes (when
// written), then w's (F, Mp) planes.
struct Layout {
  int N, H, W, C, F, K, M, Ho, Wo;
  long long P, R;  // pixels; GEMM rows (4 per pool window with the pool)
  bool patch;      // C % 16 != 0: the patch matrix is materialised
  bool x_planes;   // x's planes are written (not read from an int8 x)
  int Ca, Ka;      // channels and K of the A gather (Mp and 1 for patches)
  long long Mp;    // K²C padded to BK
  long long xa_plane, wb_plane;
  size_t xa_off, wb_off, bytes;

  Layout(int N_, int H_, int W_, int C_, int F_, int K_, bool pool, bool x_int8)
      : N(N_), H(H_), W(W_), C(C_), F(F_), K(K_), M(K_ * K_ * C_), Ho(H_ / 2),
        Wo(W_ / 2) {
    P = (long long)N * H * W;
    R = pool ? 4LL * N * Ho * Wo : P;
    Mp = ((long long)M + BK - 1) / BK * BK;
    patch = C % 16 != 0;
    x_planes = patch || !x_int8;
    Ca = patch ? (int)Mp : (C > 0 ? C : 16);  // C = 0: no column is read
    Ka = patch ? 1 : K;
    xa_plane = P * Ca;
    wb_plane = (long long)F * Mp;
    xa_off = 256;
    wb_off = xa_off + (x_planes ? (size_t)MAXD * xa_plane : 0);
    wb_off = (wb_off + 255) / 256 * 256;
    bytes = wb_off + (size_t)MAXD * wb_plane;
  }
};

// x int32 with 4 | C: four values a thread (one 16-byte load), their four
// digit bytes each packed into one word per plane.  MASK (the grad_x
// pre-pass, x = δ): each value is relu_bwd(z*, δ) first, z* read with the
// same 16-byte loads, so the masked δ is never written as int32.
template <bool MASK>
__global__ void __launch_bounds__(256)
x_digits_kernel(const int4* __restrict__ x, const int4* __restrict__ z, FastDiv alpha_inv,
                long long n4, unsigned* __restrict__ xa, long long plane_words,
                int* need_out) {
  unsigned need = 1u;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    int4 v = __ldg(x + i);
    if (MASK) {
      const int4 zv = __ldg(z + i);
      v = make_int4(relu_bwd(zv.x, v.x, alpha_inv), relu_bwd(zv.y, v.y, alpha_inv),
                    relu_bwd(zv.z, v.z, alpha_inv), relu_bwd(zv.w, v.w, alpha_inv));
    }
    const unsigned b[4] = {digits::digit_bytes(v.x), digits::digit_bytes(v.y),
                           digits::digit_bytes(v.z), digits::digit_bytes(v.w)};
    need = max(need, digits::digits_needed(b[0] | b[1] | b[2] | b[3]));
#pragma unroll
    for (int j = 0; j < MAXD; ++j) {
      unsigned word = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) word |= ((b[q] >> (8 * j)) & 255u) << (8 * q);
      xa[j * plane_words + i] = word;
    }
  }
  need = __reduce_max_sync(0xffffffffu, need);
  if (threadIdx.x % 32 == 0) atomicMax(need_out, (int)need);
}

// Ragged C: one thread per (pixel, 16 patch columns), gathering from x
// (L2-resident at these widths) and writing 16 bytes to each plane.  MASK
// (the grad_x pre-pass): each value inside the image is relu_bwd(z*, δ),
// z* read at the same index; the halo stays 0 (relu_bwd(0, 0) = 0).
template <bool MASK, typename T>
__global__ void __launch_bounds__(256)
patch_digits_kernel(const T* __restrict__ x, const int32_t* __restrict__ z,
                    FastDiv alpha_inv, int8_t* __restrict__ xa, int H, int W, int C, int K,
                    int M, long long P, int Mp, long long plane, int* need_out) {
  const int chunks = Mp / 16, r = K / 2;
  unsigned need = 1u;
  for (long long it = blockIdx.x * (long long)blockDim.x + threadIdx.x; it < P * chunks;
       it += (long long)gridDim.x * blockDim.x) {
    const long long p = it / chunks;
    const int q = (int)(it - p * chunks);
    const int w = (int)(p % W), h = (int)(p / W % H);
    unsigned words[MAXD][4];
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) words[j][e] = 0u;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int m = 16 * q + e;
      int v = 0;
      if (m < M) {
        const int seg = m / C, c = m - seg * C;
        const int di = seg / K - r, dj = seg % K - r;
        if (h + di >= 0 && h + di < H && w + dj >= 0 && w + dj < W) {
          const long long idx = (p + (long long)di * W + dj) * C + c;
          v = (int)__ldg(x + idx);
          if (MASK) v = relu_bwd(__ldg(z + idx), v, alpha_inv);
        }
      }
      const unsigned b = digits::digit_bytes(v);
      need = max(need, digits::digits_needed(b));
#pragma unroll
      for (int j = 0; j < MAXD; ++j) words[j][e / 4] |= ((b >> (8 * j)) & 255u) << (8 * (e % 4));
    }
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
      *reinterpret_cast<uint4*>(xa + j * plane + p * Mp + 16 * q) =
          make_uint4(words[j][0], words[j][1], words[j][2], words[j][3]);
  }
  need = __reduce_max_sync(0xffffffffu, need);
  if (threadIdx.x % 32 == 0) atomicMax(need_out, (int)need);
}

// ---------------------------------------------------------------- GEMM

struct ConvArgs {
  const int8_t* xa;  // A planes: x's NHWC digit planes, its patch planes, or int8 x
  const int8_t* wb;  // B planes WB[j][f][m]
  long long xa_plane, wb_plane, Mp;
  int H, W, Ca, Ka, F, R, Ho, Wo, nk, pool;
  const Flags* flags;
};

// Flat pixel of GEMM row `row`, and its (h, w): the row itself, or with
// the pool window q = row / 4's pixel (2·ho + dy, 2·wo + dx), d = row % 4 =
// 2·dy + dx — the order of window_view_2x2.
__device__ __forceinline__ int row_pixel(const ConvArgs& g, int row, int& h, int& w) {
  if (!g.pool) {
    w = row % g.W;
    h = row / g.W % g.H;
    return row;
  }
  const int q = row >> 2, d = row & 3;
  const int wo = q % g.Wo, t = q / g.Wo, ho = t % g.Ho, n = t / g.Ho;
  h = 2 * ho + (d >> 1);
  w = 2 * wo + (d & 1);
  return (n * g.H + h) * g.W + w;
}

// This thread's A copies: rows tid/4 and tid/4 + 64 of the tile, 16-byte
// column tid % 4 of each stage.  (ki, kj, ch) is the segment and channel
// of that column in the next stage to be loaded; stages load in order.
struct Gather {
  int pix[2], h[2], w[2];
  int ki, kj, ch;

  __device__ Gather(const ConvArgs& g, int row0) : ki(0), kj(0), ch(0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = row0 + threadIdx.x / 4 + 64 * e;
      pix[e] = 0;
      h[e] = -(1 << 30);  // past R: every copy zero-fills
      w[e] = 0;
      if (row < g.R) pix[e] = row_pixel(g, row, h[e], w[e]);
    }
    advance(g, 16 * (threadIdx.x % 4));
  }

  __device__ __forceinline__ void advance(const ConvArgs& g, int by) {
    ch += by;
    while (ch >= g.Ca) {
      ch -= g.Ca;
      if (++kj == g.Ka) {
        kj = 0;
        ++ki;
      }
    }
  }
};

template <int NX, int ND>
__device__ __forceinline__ void load_stage(const ConvArgs& g, Gather& ga, int8_t* as,
                                           int col0, int kt) {
  int8_t* bs = as + NX * BM * ROW;
  const int r = threadIdx.x / 4, c = threadIdx.x % 4;
  const int di = ga.ki - g.Ka / 2, dj = ga.kj - g.Ka / 2;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int hh = ga.h[e] + di, ww = ga.w[e] + dj;
    const bool ok = ga.ki < g.Ka && hh >= 0 && hh < g.H && ww >= 0 && ww < g.W;
    const size_t off = ok ? (size_t)(ga.pix[e] + di * g.W + dj) * g.Ca + ga.ch : 0;
#pragma unroll
    for (int i = 0; i < NX; ++i)
      digits::cp16(as + (i * BM + r + 64 * e) * ROW + 16 * c, g.xa + i * g.xa_plane + off, ok);
  }
  const bool okb = col0 + r < g.F;
  const size_t boff = (okb ? (size_t)(col0 + r) * g.Mp : 0) + (size_t)kt * BK + 16 * c;
#pragma unroll
  for (int j = 0; j < ND; ++j)
    digits::cp16(bs + (j * BN + r) * ROW + 16 * c, g.wb + j * g.wb_plane + boff, okb);
  ga.advance(g, BK);
}

// The block's digit products combined mod 2^32 into tot (the mma C
// layout of digit_gemm.cuh's run).
template <int NX, int ND>
__device__ __forceinline__ void run(const ConvArgs& g, int8_t* smem, int row0, int col0,
                                    unsigned (&tot)[2][4][4]) {
  constexpr int G = NX + ND - 1 < MAXD ? NX + ND - 1 : MAXD;  // shifts 0..G−1
  constexpr int STAGE = (NX * BM + ND * BN) * ROW;
  constexpr int FIT = RING / STAGE;
  constexpr int S = FIT < 2 ? 2 : (FIT > 6 ? 6 : FIT);
  int acc[G][2][4][4];
  digits::zero(acc);
  int a_off, b_off;
  digits::lane_offsets(a_off, b_off);
  Gather ga(g, row0);
  unsigned* folded = reinterpret_cast<unsigned*>(smem + RING) + threadIdx.x;
  const int nk = g.nk;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load_stage<NX, ND>(g, ga, smem + s * STAGE, col0, s);
    digits::cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    digits::cp_wait<S - 2>();
    __syncthreads();
    const int nxt = kt + S - 1;
    if (nxt < nk) load_stage<NX, ND>(g, ga, smem + (nxt % S) * STAGE, col0, nxt);
    digits::cp_commit();
    const int8_t* as = smem + (kt % S) * STAGE;
    digits::stage_mma<NX, ND>(as, as + NX * BM * ROW, a_off, b_off, acc);
    if ((kt + 1) % FOLD == 0) {  // fold: no s32 sum grows past 2^30
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            unsigned& f = folded[((mt * 4 + nt) * 4 + e) * THREADS];
            f = (kt + 1 == FOLD ? 0u : f) + digits::combined(acc, mt, nt, e);
          }
      digits::zero(acc);
    }
  }
  digits::cp_wait<0>();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tot[mt][nt][e] = digits::combined(acc, mt, nt, e) +
                         (nk >= FOLD ? folded[((mt * 4 + nt) * 4 + e) * THREADS] : 0u);
}

template <int NX>
__device__ __forceinline__ void run_w(int nw, const ConvArgs& g, int8_t* smem, int row0,
                                      int col0, unsigned (&tot)[2][4][4]) {
  switch (nw) {
    case 1: run<NX, 1>(g, smem, row0, col0, tot); break;
    case 2: run<NX, 2>(g, smem, row0, col0, tot); break;
    case 3: run<NX, 3>(g, smem, row0, col0, tot); break;
    default: run<NX, 4>(g, smem, row0, col0, tot); break;
  }
}

// ------------------------------------------------------------ epilogue

using nitro::FastEpilogue;

// The epilogue stages a tile's values in shared memory (the ring's first
// 36,864 B, free after the main loop), 72 ints a row so that the mma
// layout's 8-byte writes take two wavefronts, then writes whole rows with
// 16-byte stores.
constexpr int TS = BN + 8;

// fn(tot) of the thread's 64 values into tile[row][col] (mma C layout).
template <class Fn>
__device__ __forceinline__ void stage_tile(int* tile, const unsigned (&tot)[2][4][4], Fn fn) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rb = (warp % 4) * 32 + lane / 4, cb = (warp / 4) * 32 + 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<int2*>(tile + (rb + 16 * mt + 8 * h) * TS + cb + 8 * nt) =
            make_int2(fn((int)tot[mt][nt][2 * h]), fn((int)tot[mt][nt][2 * h + 1]));
}

// Rows [0, rows) of the staged tile, fn applied, to out rows row_base..
// (those < row_end) and columns col0.. (those < F) of a row-major (·, F)
// output: 16-byte stores where F keeps them aligned, else value by value.
template <typename T, class Fn>
__device__ __forceinline__ void write_tile(const int* tile, int rows, int row_base,
                                           int row_end, int F, int col0, T* out, Fn fn) {
  constexpr int V = 16 / sizeof(T);  // values a store
  constexpr int CH = BN / V;         // stores a row
  const bool vec = F % V == 0;
  for (int id = threadIdx.x; id < rows * CH; id += THREADS) {
    const int r = id / CH, f = col0 + (id % CH) * V, row = row_base + r;
    if (row >= row_end) continue;
    const int* src = tile + r * TS + (id % CH) * V;
    T* dst = out + (size_t)row * F + f;
    if (vec && f + V <= F) {
      unsigned word[4];
      if constexpr (sizeof(T) == 4) {
        const int4 v = *reinterpret_cast<const int4*>(src);
        word[0] = fn(v.x), word[1] = fn(v.y), word[2] = fn(v.z), word[3] = fn(v.w);
      } else {  // int8: four values a word, low byte first (the store's wrap)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int4 v = *reinterpret_cast<const int4*>(src + 4 * q);
          word[q] = ((unsigned)fn(v.x) & 255u) | (((unsigned)fn(v.y) & 255u) << 8) |
                    (((unsigned)fn(v.z) & 255u) << 16) | ((unsigned)fn(v.w) << 24);
        }
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(word[0], word[1], word[2], word[3]);
    } else {
      for (int t = 0; t < V && f + t < F; ++t) store(dst + t, fn(src[t]));
    }
  }
}

// z of a 128×64 tile, handed to epi(g, tot, row0, col0, tile) once every
// warp is done with the ring.
template <class Epi>
__global__ void __launch_bounds__(THREADS, 1)
conv_digit_gemm_kernel(ConvArgs g, Epi epi) {
  extern __shared__ __align__(128) int8_t smem[];
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int nx = min(max(g.flags->x_digits, 1), MAXD);
  const int nw = min(max(g.flags->w_digits, 1), MAXD);
  unsigned tot[2][4][4];
  switch (nx) {
    case 1: run_w<1>(nw, g, smem, row0, col0, tot); break;
    case 2: run_w<2>(nw, g, smem, row0, col0, tot); break;
    case 3: run_w<3>(nw, g, smem, row0, col0, tot); break;
    default: run_w<4>(nw, g, smem, row0, col0, tot); break;
  }
  __syncthreads();
  epi(g, tot, row0, col0, reinterpret_cast<int*>(smem));
}

inline int grid_stride_blocks(long long items, int sms) {
  const long long want = (items + 255) / 256;
  return (int)(want < 8LL * sms ? want : 8LL * sms);
}

// Step 1 on `st`: x's digit planes (its patch planes for C % 16 != 0)
// and flags->x_digits, each value masked by relu_bwd against z when z is
// given (the grad_x pre-pass: x = δ, z = z*, both int32).  Nothing for an
// int8 x read as it is.
inline void x_planes(const Layout& L, const void* x, bool x_int8, const int32_t* z,
                     FastDiv alpha_inv, int8_t* s, int sms, cudaStream_t st) {
  Flags* flags = (Flags*)s;
  if (L.patch && L.P > 0 && L.M > 0) {
    const long long items = L.P * (L.Mp / 16);
    const int blocks = grid_stride_blocks(items, sms);
    if (z)
      patch_digits_kernel<true, int32_t><<<blocks, 256, 0, st>>>(
          (const int32_t*)x, z, alpha_inv, s + L.xa_off, L.H, L.W, L.C, L.K, L.M, L.P,
          (int)L.Mp, L.xa_plane, &flags->x_digits);
    else if (x_int8)
      patch_digits_kernel<false, int8_t><<<blocks, 256, 0, st>>>(
          (const int8_t*)x, nullptr, alpha_inv, s + L.xa_off, L.H, L.W, L.C, L.K, L.M, L.P,
          (int)L.Mp, L.xa_plane, &flags->x_digits);
    else
      patch_digits_kernel<false, int32_t><<<blocks, 256, 0, st>>>(
          (const int32_t*)x, nullptr, alpha_inv, s + L.xa_off, L.H, L.W, L.C, L.K, L.M, L.P,
          (int)L.Mp, L.xa_plane, &flags->x_digits);
  } else if (L.x_planes && L.P * L.C > 0) {
    const long long n4 = L.P * L.C / 4;
    auto kern = z ? x_digits_kernel<true> : x_digits_kernel<false>;
    kern<<<grid_stride_blocks(n4, sms), 256, 0, st>>>(
        (const int4*)x, (const int4*)z, alpha_inv, n4, (unsigned*)(s + L.xa_off),
        L.xa_plane / 4, &flags->x_digits);
  }
}

// Zero the flags, then x's planes (step 1) and w's (step 2) on `st`.
// Returns a cudaError_t.
inline int prepare(const Layout& L, const void* x, bool x_int8, const void* w, bool w_int8,
                   void* scratch, int sms, cudaStream_t st) {
  int8_t* s = (int8_t*)scratch;
  Flags* flags = (Flags*)s;
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(Flags), st);
  if (err != cudaSuccess) return (int)err;
  x_planes(L, x, x_int8, nullptr, FastDiv(1), s, sms, st);
  if (L.M > 0 && L.F > 0) {
    const dim3 grid((unsigned)(L.Mp / digits::PT), (unsigned)((L.F + 63) / 64));
    if (w_int8)
      digits::delta_digits_kernel<false, int8_t><<<grid, 256, 0, st>>>(
          (const int8_t*)w, nullptr, s + L.wb_off, L.M, L.F, L.Mp, L.wb_plane, FastDiv(1),
          &flags->w_digits, nullptr);
    else
      digits::delta_digits_kernel<false, int32_t><<<grid, 256, 0, st>>>(
          (const int32_t*)w, nullptr, s + L.wb_off, L.M, L.F, L.Mp, L.wb_plane, FastDiv(1),
          &flags->w_digits, nullptr);
  }
  return (int)cudaGetLastError();
}

// Step 3 on `st`, after prepare: the GEMM with epilogue `epi`.  x is the
// int8 input the GEMM reads when no planes were written.
template <class Epi>
int launch_gemm(const Layout& L, const void* x, void* scratch, bool pool, Epi epi,
                cudaStream_t st) {
  auto kern = conv_digit_gemm_kernel<Epi>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const int8_t* s = (const int8_t*)scratch;
  ConvArgs g;
  g.xa = L.x_planes ? s + L.xa_off : (const int8_t*)x;
  g.wb = s + L.wb_off;
  g.xa_plane = L.xa_plane;
  g.wb_plane = L.wb_plane;
  g.Mp = L.Mp;
  g.H = L.H;
  g.W = L.W;
  g.Ca = L.Ca;
  g.Ka = L.Ka;
  g.F = L.F;
  g.R = (int)L.R;
  g.Ho = L.Ho;
  g.Wo = L.Wo;
  g.nk = (int)(L.Mp / BK);
  g.pool = pool;
  g.flags = (const Flags*)s;
  const dim3 grid((L.F + BN - 1) / BN, (unsigned)((L.R + BM - 1) / BM));
  kern<<<grid, THREADS, SMEM, st>>>(g, epi);
  return (int)cudaGetLastError();
}

}  // namespace conv
}  // namespace nitro
