// Exact int32 conv weight-gradient GEMM on Hopper's int8 tensor cores,
// shared by stream_conv_grad_w and stream_conv_grad_w_opt.  Its digits,
// digit-plane pre-passes and per-stage MMA step also serve the forward
// convs' GEMM (conv_digits.cuh: stream_conv, stream_conv_fwd and
// stream_conv_grad_x); its tile, MMA step and lane offsets the linear
// grad_W GEMM (linear_grad_w.cuh); its row pre-pass, split plan and
// last-arrival split sum the matmul GEMMs (nitro_matmul.cu,
// nitro_matmul_grad_x.cu):
//
//   grad_W[m, f] = Σ_p A(m, p) · B(p, f)   (mod 2^32)
//
// with m = (ki·K + kj)·C + c the patch column, p = (n·H + h)·W + w the
// pixel, A the implicit im2col of x and B = relu_bwd(z*, δ) (plain δ
// without z*).
//
// Exact digits.  Every int32 v is written as four signed base-256 digits
// d0..d3 in [−128, 127] (balanced: d0 = ((v + 128) mod 256) − 128, then
// v ← (v − d0) / 256, and so on; the top digit wraps mod 256), so
// v ≡ Σ_i 2^(8i)·d_i (mod 2^32).  Then
//
//   Σ_p x·δ ≡ Σ_{i+j ≤ 3} 2^(8(i+j)) · Σ_p x_i·δ_j   (mod 2^32):
//
// products with i + j ≥ 4 vanish mod 2^32, and each inner sum is an
// s8×s8→s32 tensor-core MMA.  A value in [−128, 127] is its own d0 with
// d1 = d2 = d3 = 0, so an int8-range x needs one product per digit of δ
// (VGG8B's convs 2–6 take a NITRO-ReLU output or its max-pool), a
// full-range x the ten pairs i + j ≤ 3.  A split is at most 16,384 pixels
// deep, so no s32 accumulator can overflow, whatever the data: each holds
// at most four pairs' sums, |Σ| ≤ 4·2^14·2^14 = 2^30.
//
// One call, four device launches, no host sync:
//   1. x_range_kernel: flags.x_wide = some x outside [−128, 127];
//   2. delta_digits_kernel: masks δ by z* as it reads it, writes the four
//      digit planes of the masked δ transposed to p-contiguous rows
//      (DB[j][f][p], int8), and flags.delta_digits = the most digits any
//      masked δ needs (1 + its highest nonzero digit);
//   3. patch_digits_kernel: writes the im2col patch matrix of x as
//      p-contiguous digit planes (XA[i][m][p], int8; plane 0, or all
//      four when x is wide), zero outside the image (the 'same' halo)
//      and past P;
//   4. digit_gemm_kernel: reads both flags and runs only the products
//      they need (a block-uniform branch over eight compiled variants),
//      staging plain 16-byte copies (cp.async, zero-filled past M and F)
//      into a three-stage ring and issuing mma.sync m16n8k32 s8 from
//      ldmatrix fragments, one s32 accumulator set per shift 8(i+j),
//      combined as unsigned shifts and adds mod 2^32 before the flush.
// The flags live in the call's scratch, zeroed by a memset first.
//
// Tiles: 128 patch columns × 64 filters per block, 8 warps of 32×32,
// 64 pixels (bytes) per stage, rows padded to 80 bytes so that ldmatrix
// reads are free of bank conflicts.  Four s32 accumulator sets hold 128
// registers a thread, so one block runs per SM.  The long contraction is
// split across blocks (split-K) and the splits are added with atomicAdd
// on unsigned (exact in any order).
#pragma once

#include "nitro_epilogue.cuh"

namespace nitro {
namespace digits {

constexpr int BM = 128, BN = 64, BK = 64;  // tile rows m, cols f, pixels a stage
constexpr int ROW = BK + 16;               // padded shared row (bytes)
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int MAXD = 4;
constexpr int PT = 64;  // pre-pass pixel tile; P is padded to a multiple
constexpr int CG = 16;  // channels per patch_digits block
constexpr int MAX_CHUNK = 16384;  // deepest split: no s32 overflow
constexpr int STAGE_BYTES = MAXD * (BM + BN) * ROW;
constexpr int SMEM = STAGES * STAGE_BYTES;  // 184,320 B

// The four balanced digits of v as bytes, d0 lowest.  Worked mod 2^32 in
// unsigned: each step removes the low digit and shifts; the top digit
// keeps what is left, which wraps it mod 256.
__device__ __forceinline__ unsigned digit_bytes(int v) {
  unsigned u = (unsigned)v, out = 0u;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const unsigned b = (u + 128u) & 255u;  // d + 128
    out |= (b ^ 128u) << (8 * i);          // d as a byte
    u = (u - (b - 128u)) >> 8;             // (u − d) / 256, exact mod 2^32
  }
  return out | (u << 24);
}

// The same bytes in closed form: adding 128 at each of the three low
// digits makes them the unsigned bytes d_i + 128 with no carry, and the
// top byte keeps d3 mod 256.
__device__ __forceinline__ unsigned digit_word(int v) {
  return ((unsigned)v + 0x808080u) ^ 0x808080u;
}

// The digit words of four consecutive values → one word per plane, value
// q in byte q (a 4×4 byte transpose).
__device__ __forceinline__ void plane_words(unsigned a, unsigned b, unsigned c, unsigned d,
                                            unsigned (&p)[4]) {
  const unsigned lo_ab = __byte_perm(a, b, 0x5140), hi_ab = __byte_perm(a, b, 0x7362);
  const unsigned lo_cd = __byte_perm(c, d, 0x5140), hi_cd = __byte_perm(c, d, 0x7362);
  p[0] = __byte_perm(lo_ab, lo_cd, 0x5410);
  p[1] = __byte_perm(lo_ab, lo_cd, 0x7632);
  p[2] = __byte_perm(hi_ab, hi_cd, 0x5410);
  p[3] = __byte_perm(hi_ab, hi_cd, 0x7632);
}

// Digits v needs: 1 + the index of its highest nonzero digit (1 for 0).
__device__ __forceinline__ unsigned digits_needed(unsigned bytes) {
  return bytes >> 24 ? 4u : bytes >> 16 ? 3u : bytes >> 8 ? 2u : 1u;
}

// Scratch of one call: the flags, then XA (4 planes of M×Pp bytes), then
// DB (4 planes of F×Pp bytes).
struct Layout {
  int N, H, W, C, F, K, M, P;
  long long Pp, xa_plane, db_plane;
  size_t xa_off, db_off, bytes;

  Layout(int N_, int H_, int W_, int C_, int F_, int K_)
      : N(N_), H(H_), W(W_), C(C_), F(F_), K(K_), M(K_ * K_ * C_),
        P(N_ * H_ * W_) {
    Pp = ((long long)P + PT - 1) / PT * PT;
    xa_plane = (long long)M * Pp;
    db_plane = (long long)F * Pp;
    xa_off = 256;
    db_off = xa_off + (size_t)MAXD * xa_plane;
    bytes = db_off + (size_t)MAXD * db_plane;
  }
  // Pixels of x one patch_digits block stages: its 64, and K/2 rows and
  // columns of halo on each side in flat pixel order.
  int window() const { return PT + 2 * (K / 2) * (W + 1); }
  size_t window_bytes() const {
    return ((size_t)CG * (window() | 1) + PT) * sizeof(int);
  }
};

struct Flags {
  int x_wide;        // some x outside [−128, 127]
  int delta_digits;  // most digits any masked δ needs
};

__global__ void x_range_kernel(const int32_t* __restrict__ x, long long n,
                               Flags* flags) {
  bool wide = false;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int v = __ldg(x + i);
    wide |= v < -128 || v > 127;
  }
  if (__any_sync(0xffffffffu, wide) && threadIdx.x % 32 == 0)
    flags->x_wide = 1;
}

// One block: 64 pixels × 64 filters.  Each thread masks four consecutive
// pixels of one filter (loads along f are coalesced), packs their digit
// bytes into one word per digit in shared memory, then the block writes
// each (digit, filter) row of 64 bytes as four 16-byte stores.  `need`
// gets the most digits any (masked) value needs.  The forward conv
// kernels run it unmasked on the (K²C, F) weight (P = K²C, T int32 or
// int8), which it writes as the (F, K²C) digit planes their GEMM reads,
// and the matmul kernels on the (K, N) weight, written as (N, K) planes.
// An int8 T writes plane 0 alone: its digits 1–3 are zero, and a reader
// told one digit (the flag) reads no other plane.  With `tile_need` the
// block also records its own 64 × 64 tile's digit count there (entry
// blockIdx.y · gridDim.x + blockIdx.x) and writes only those planes: a
// reader that zero-fills the tile's other planes (the matmul GEMM) saves
// their bytes both ways.  The conv GEMMs pass null and read every plane.
// One atomic on `need_out` a block at most (the block's own count).
template <bool MASK, typename T = int32_t>
__global__ void __launch_bounds__(256)
delta_digits_kernel(const T* __restrict__ delta,
                    const int32_t* __restrict__ z, int8_t* __restrict__ db,
                    int P, int F, long long Pp, long long plane,
                    FastDiv alpha_inv, int* need_out, uint8_t* tile_need) {
  __shared__ unsigned s[MAXD][64][PT / 4 + 1];
  __shared__ unsigned warp_need[8];
  const int p0 = blockIdx.x * PT, f0 = blockIdx.y * 64;
  const int fl = threadIdx.x % 64, f = f0 + fl;
  unsigned need = 1u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int pw = threadIdx.x / 64 + 4 * e;
    int v[4], zv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // every load first, then the mask
      const int p = p0 + 4 * pw + q;
      const bool ok = p < P && f < F;
      const size_t idx = (size_t)p * F + f;
      v[q] = ok ? (int)__ldg(delta + idx) : 0;
      zv[q] = (MASK && ok) ? __ldg(z + idx) : 0;
    }
    unsigned w[MAXD] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned b = digit_bytes(MASK ? relu_bwd(zv[q], v[q], alpha_inv) : v[q]);
      need = max(need, digits_needed(b));
#pragma unroll
      for (int j = 0; j < MAXD; ++j) w[j] |= ((b >> (8 * j)) & 255u) << (8 * q);
    }
#pragma unroll
    for (int j = 0; j < MAXD; ++j) s[j][fl][pw] = w[j];
  }
  need = __reduce_max_sync(0xffffffffu, need);
  if (threadIdx.x % 32 == 0) warp_need[threadIdx.x / 32] = need;
  __syncthreads();
  unsigned tile = 1u;  // the block's own need
#pragma unroll
  for (int i = 0; i < 8; ++i) tile = max(tile, warp_need[i]);
  // one atomic a block at most, none once the flag holds as much: the
  // flag only grows, so a stale read can only cost an atomic
  if (threadIdx.x == 0 && (int)tile > __ldcg(need_out)) atomicMax(need_out, (int)tile);
  constexpr int PLANES = sizeof(T) == 1 ? 1 : MAXD;  // an int8 value is its own d0
  int planes = PLANES;
  if (tile_need) {  // this tile's planes past its own need stay unwritten
    planes = min(planes, (int)tile);
    if (threadIdx.x == 0) tile_need[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = (uint8_t)tile;
  }
#pragma unroll
  for (int e = 0; e < PLANES; ++e) {
    const int item = threadIdx.x + 256 * e;
    const int c = item % 4, r = (item / 4) % 64, j = item / 256;
    if (j < planes && f0 + r < F) {
      const uint4 v = make_uint4(s[j][r][4 * c], s[j][r][4 * c + 1],
                                 s[j][r][4 * c + 2], s[j][r][4 * c + 3]);
      *reinterpret_cast<uint4*>(db + j * plane + (size_t)(f0 + r) * Pp + p0 + 16 * c) = v;
    }
  }
}

// Rows of a (M, K) row-major matrix as K-contiguous digit planes (M, Kp),
// zero past K: one thread a (row, 4 columns), one 16-byte load of an
// int32 row where it is aligned (else four), one word to each plane, so a
// warp's loads and stores are whole 128-byte lines; `need` gets the most
// digits any value needs.  An int8 T writes plane 0 alone (its own
// digits).  The forward matmuls run it on x; with MASK,
// nitro_matmul_grad_x on δ, each value relu_bwd(z*, δ) first (z* int32 at
// the same index), so the masked δ is never written as int32.
template <bool MASK, typename T>
__global__ void __launch_bounds__(256)
row_digits_kernel(const T* __restrict__ x, const int32_t* __restrict__ z, FastDiv alpha_inv,
                  int8_t* __restrict__ xa, int M, int K, long long Kp, long long plane,
                  int* need_out) {
  constexpr int PLANES = sizeof(T) == 1 ? 1 : MAXD;
  const long long words = Kp / 4;
  unsigned need = 1u;
  for (long long it = blockIdx.x * (long long)blockDim.x + threadIdx.x; it < M * words;
       it += (long long)gridDim.x * blockDim.x) {
    const long long m = it / words;
    const int k0 = 4 * (int)(it - m * words);
    const long long at = m * K + k0;
    int v[4];
    if (sizeof(T) == 4 && k0 + 4 <= K && (uintptr_t)(x + at) % 16 == 0 &&
        (!MASK || (uintptr_t)(z + at) % 16 == 0)) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(x + at));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
      if (MASK) {
        const int4 zq = __ldg(reinterpret_cast<const int4*>(z + at));
        v[0] = relu_bwd(zq.x, v[0], alpha_inv), v[1] = relu_bwd(zq.y, v[1], alpha_inv);
        v[2] = relu_bwd(zq.z, v[2], alpha_inv), v[3] = relu_bwd(zq.w, v[3], alpha_inv);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = k0 + e < K ? (int)__ldg(x + at + e) : 0;
        if (MASK && k0 + e < K) v[e] = relu_bwd(__ldg(z + at + e), v[e], alpha_inv);
      }
    }
    unsigned d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = digit_word(v[e]);
    need = max(need, digits_needed(d[0] | d[1] | d[2] | d[3]));
    unsigned pw[4];
    plane_words(d[0], d[1], d[2], d[3], pw);
#pragma unroll
    for (int j = 0; j < PLANES; ++j)
      *reinterpret_cast<unsigned*>(xa + j * plane + m * Kp + k0) = pw[j];
  }
  __shared__ unsigned warp_need[8];
  need = __reduce_max_sync(0xffffffffu, need);
  if (threadIdx.x % 32 == 0) warp_need[threadIdx.x / 32] = need;
  __syncthreads();
  if (threadIdx.x == 0) {  // one atomic a block at most (the flag only grows)
    for (int i = 1; i < 8; ++i) need = max(need, warp_need[i]);
    if ((int)need > __ldcg(need_out)) atomicMax(need_out, (int)need);
  }
}

// The patch bytes of one (ki, kj) segment for the thread's channel and
// four pixels: digit 0 only (x fits int8: the value's low byte) or all
// four, packed one word per digit; 0 outside the image.
template <bool WIDE>
__device__ __forceinline__ void patch_words(const int* row, const int* hw, int pw,
                                            int di, int dj, int H, int W,
                                            unsigned (&w)[MAXD]) {
#pragma unroll
  for (int j = 0; j < MAXD; ++j) w[j] = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int pl = 4 * pw + q, hwv = hw[pl];
    const int hh = (hwv >> 16) + di, ww = (hwv & 0xffff) + dj;
    if (hwv < 0 || hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
    const int v = row[pl + di * W + dj];
    if (!WIDE) {
      w[0] |= ((unsigned)v & 255u) << (8 * q);
    } else {
      const unsigned b = digit_bytes(v);
#pragma unroll
      for (int j = 0; j < MAXD; ++j) w[j] |= ((b >> (8 * j)) & 255u) << (8 * q);
    }
  }
}

// One block: 64 pixels × 16 channels.  It stages the x window those
// pixels' patches reach (flat pixels p0 − r(W+1) .. p0 + 64 + r(W+1),
// coalesced along c) in shared memory, channel-major, then writes for
// every (ki, kj) and channel the 64 patch bytes of each digit plane it
// needs: 16 lanes per 64-byte row.
__global__ void __launch_bounds__(256)
patch_digits_kernel(const int32_t* __restrict__ x, int8_t* __restrict__ xa,
                    int H, int W, int C, int K, int P, long long Pp,
                    long long plane, FastDiv by_w, FastDiv by_h,
                    const Flags* flags) {
  extern __shared__ int xs[];  // [CG][QS] window, then [PT] pixel (h, w)
  const int r = K / 2, QW = PT + 2 * r * (W + 1), QS = QW | 1;
  int* hw = xs + CG * QS;
  const int p0 = blockIdx.x * PT, c0 = blockIdx.y * CG;
  const long long qbase = (long long)p0 - (long long)r * (W + 1);
#pragma unroll 4
  for (int idx = threadIdx.x; idx < QW * CG; idx += 256) {
    const int cl = idx % CG, ql = idx / CG;
    const long long q = qbase + ql;
    const int c = c0 + cl;
    xs[cl * QS + ql] = (c < C && q >= 0 && q < P) ? __ldg(x + q * C + c) : 0;
  }
  if (threadIdx.x < PT) {
    const int p = p0 + threadIdx.x;
    int v = -1;  // past P: every patch value is 0
    if (p < P) {
      const int t = (int)by_w.div((unsigned)p), w = p - t * W;
      const int n = (int)by_h.div((unsigned)t), h = t - n * H;
      v = (h << 16) | w;
    }
    hw[threadIdx.x] = v;
  }
  __syncthreads();
  const bool wide = flags->x_wide != 0;
  const int pw = threadIdx.x % 16, cl = threadIdx.x / 16, c = c0 + cl;
  if (c >= C) return;
  const int* row = xs + cl * QS + r * (W + 1);
  for (int seg = 0; seg < K * K; ++seg) {
    const int di = seg / K - r, dj = seg % K - r;
    unsigned w[MAXD];
    int8_t* dst = xa + (size_t)(seg * C + c) * Pp + p0 + 4 * pw;
    if (!wide) {
      patch_words<false>(row, hw, pw, di, dj, H, W, w);
      *reinterpret_cast<unsigned*>(dst) = w[0];
    } else {
      patch_words<true>(row, hw, pw, di, dj, H, W, w);
#pragma unroll
      for (int i = 0; i < MAXD; ++i) *reinterpret_cast<unsigned*>(dst + i * plane) = w[i];
    }
  }
}

// ---------------------------------------------------------------- GEMM

struct GemmArgs {
  const int8_t* xa;  // XA[i][m][p]
  const int8_t* db;  // DB[j][f][p]
  long long xa_plane, db_plane, Pp;
  int M, F, p_chunk;
  const Flags* flags;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global → shared, asynchronously; zero-filled when !ok.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
// 4 bytes global → shared, asynchronously; zero-filled when !ok (for
// rows that are not 16-byte aligned).
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(const int8_t* p, unsigned& r0, unsigned& r1,
                                        unsigned& r2, unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

// d += a (16×32 s8, row) · b (32×8 s8, col), s32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage pixels [k0, k0 + BK) of NX planes of A rows and ND planes of B
// rows into ring slot `slot`: 16-byte copies, four per 64-byte row.
template <int NX, int ND>
__device__ __forceinline__ void load_stage(const GemmArgs& g, int8_t* smem, int slot,
                                           int row0, int col0, long long k0) {
  int8_t* as = smem + slot * STAGE_BYTES;
  int8_t* bs = as + MAXD * BM * ROW;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int e = 0; e < BM * 4 / THREADS; ++e) {
      const int chunk = threadIdx.x + THREADS * e, r = chunk / 4, c = chunk % 4;
      const bool ok = row0 + r < g.M;
      const int8_t* src = g.xa + i * g.xa_plane + (ok ? (size_t)(row0 + r) * g.Pp : 0) +
                          k0 + 16 * c;
      cp16(as + (i * BM + r) * ROW + 16 * c, src, ok);
    }
  }
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int r = threadIdx.x / 4, c = threadIdx.x % 4;  // BN·4 = THREADS
    const bool ok = col0 + r < g.F;
    const int8_t* src = g.db + j * g.db_plane + (ok ? (size_t)(col0 + r) * g.Pp : 0) +
                        k0 + 16 * c;
    cp16(bs + (j * BN + r) * ROW + 16 * c, src, ok);
  }
}

// ldmatrix offsets (bytes into a plane's tile) of this lane: A takes
// (rows 0–7, bytes 0–15), (8–15, 0–15), (0–7, 16–31), (8–15, 16–31) of a
// 16×32 tile; B takes (cols 0–7, bytes 0–15), (0–7, 16–31), then 8–15
// the same.  Warp w owns rows 32·(w % 4) and cols 32·(w / 4) of the tile.
__device__ __forceinline__ void lane_offsets(int& a_off, int& b_off) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  a_off = ((warp % 4) * 32 + lane % 8 + 8 * ((lane / 8) % 2)) * ROW + 16 * (lane / 16);
  b_off = ((warp / 4) * 32 + lane % 8 + 8 * (lane / 16)) * ROW + 16 * ((lane / 8) % 2);
}

// One staged BK-deep slice: every digit pair i + j < MAXD of the NX A
// planes (BM rows each, from `as`) and ND B planes (BN rows each, from
// `bs`), added into the accumulator set of its shift i + j.
template <int NX, int ND, int G>
__device__ __forceinline__ void stage_mma(const int8_t* as, const int8_t* bs, int a_off,
                                          int b_off, int (&acc)[G][2][4][4]) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    unsigned b[ND][4][2];
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4(bs + j * BN * ROW + b_off + np * 16 * ROW + kk, b[j][2 * np][0],
                b[j][2 * np][1], b[j][2 * np + 1][0], b[j][2 * np + 1][1]);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(as + i * BM * ROW + a_off + mt * 16 * ROW + kk, a[mt][0], a[mt][1],
                a[mt][2], a[mt][3]);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        if (i + j >= MAXD) continue;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_s8(acc[i + j][mt][nt], a[mt], b[j][nt]);
      }
    }
  }
}

template <int G>
__device__ __forceinline__ void zero(int (&acc)[G][2][4][4]) {
#pragma unroll
  for (int s = 0; s < G; ++s)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][mt][nt][e] = 0;
}

// The accumulator sets combined mod 2^32: Σ_s acc[s] · 2^(8s), unsigned.
template <int G>
__device__ __forceinline__ unsigned combined(const int (&acc)[G][2][4][4], int mt, int nt,
                                             int e) {
  unsigned t = 0u;
#pragma unroll
  for (int s = 0; s < G; ++s) t += (unsigned)acc[s][mt][nt][e] << (8 * s);
  return t;
}

// The split's digit products, combined mod 2^32 into tot: rows
// row0 + 32·(warp % 4) + 16·mt + lane/4 (+8), cols
// col0 + 32·(warp / 4) + 8·nt + 2·(lane % 4) (+1), the mma C layout.
template <int NX, int ND>
__device__ __forceinline__ void run(const GemmArgs& g, int8_t* smem, int row0, int col0,
                                    long long k_begin, int nk,
                                    unsigned (&tot)[2][4][4]) {
  constexpr int G = NX + ND - 1 < MAXD ? NX + ND - 1 : MAXD;  // shifts 0..G−1
  int acc[G][2][4][4];
  zero(acc);
  int a_off, b_off;
  lane_offsets(a_off, b_off);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage<NX, ND>(g, smem, s, row0, col0, k_begin + s * BK);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load_stage<NX, ND>(g, smem, nxt % STAGES, row0, col0, k_begin + nxt * BK);
    cp_commit();
    const int8_t* as = smem + (kt % STAGES) * STAGE_BYTES;
    stage_mma<NX, ND>(as, as + MAXD * BM * ROW, a_off, b_off, acc);
  }
  cp_wait<0>();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mt][nt][e] = combined(acc, mt, nt, e);
}

// fn(index into the M×F output, mt, nt, e) for each of the thread's
// in-range outputs tot[mt][nt][e].
template <class Fn>
__device__ __forceinline__ void for_each_out(int row0, int col0, int M, int F, Fn fn) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mb = row0 + (warp % 4) * 32 + lane / 4;
  const int fb = col0 + (warp / 4) * 32 + 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mb + 16 * mt + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = fb + 8 * nt + e;
          if (f < F) fn((size_t)m * F + f, mt, nt, 2 * h + e);
        }
    }
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

// W′ = integer_sgd(W, g) over the thread's outputs, g from tot (FROM_WS
// false) or from the split-K workspace, read from L2 (__ldcg: the other
// splits' atomics resolve there) and returned to zero.  All loads go
// before the stores: the compiler cannot tell W′ from W or the workspace.
// The divisors (SgdMagic's 32-bit multiply-highs) are copied out of shared
// memory first: for the same reason every store would otherwise reload
// them.
template <bool FROM_WS>
__device__ __forceinline__ void flush_sgd(const SgdOut& o, const unsigned char* sgd_bytes,
                                          unsigned (&tot)[2][4][4], int row0, int col0,
                                          int M, int F) {
  const SgdMagic sgd = *reinterpret_cast<const SgdMagic*>(sgd_bytes);
  int wv[2][4][4];
  for_each_out(row0, col0, M, F, [&](size_t idx, int mt, int nt, int e) {
    if (FROM_WS) tot[mt][nt][e] = __ldcg(&o.ws[idx]);
    wv[mt][nt][e] = __ldg(&o.w[idx]);
  });
  for_each_out(row0, col0, M, F, [&](size_t idx, int mt, int nt, int e) {
    if (FROM_WS) o.ws[idx] = 0u;
    o.w_new[idx] = integer_sgd(wv[mt][nt][e], (int)tot[mt][nt][e], sgd);
  });
}

// grad_W (OPT false: added into the zeroed `out` with atomics) or W′
// (OPT true: IntegerSGD in the flush; with more than one split, each
// split adds its tile into the workspace and counts itself in on the
// tile's arrival counter, and the last to arrive applies IntegerSGD to
// the whole sum and re-zeroes both: IntegerSGD floors the whole sum, so a
// split cannot apply it alone).
template <bool OPT>
__global__ void __launch_bounds__(THREADS, 1)
digit_gemm_kernel(GemmArgs g, unsigned* __restrict__ out, SgdOut o) {
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ __align__(8) unsigned char sgd_bytes[sizeof(SgdMagic)];
  __shared__ bool last;
  if (OPT && threadIdx.x == 0)  // the divisors (a 64-bit division each) once a block
    *reinterpret_cast<SgdMagic*>(sgd_bytes) = SgdMagic(o.gamma_inv, o.eta_inv);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const long long k_begin = (long long)blockIdx.z * g.p_chunk;
  const long long k_end = min(g.Pp, k_begin + g.p_chunk);
  const int nk = (int)((k_end - k_begin) / BK);
  const bool wide = g.flags->x_wide != 0;
  const int nd = min(max(g.flags->delta_digits, 1), MAXD);
  unsigned tot[2][4][4];
  if (!wide) {
    switch (nd) {
      case 1: run<1, 1>(g, smem, row0, col0, k_begin, nk, tot); break;
      case 2: run<1, 2>(g, smem, row0, col0, k_begin, nk, tot); break;
      case 3: run<1, 3>(g, smem, row0, col0, k_begin, nk, tot); break;
      default: run<1, 4>(g, smem, row0, col0, k_begin, nk, tot); break;
    }
  } else {
    switch (nd) {
      case 1: run<4, 1>(g, smem, row0, col0, k_begin, nk, tot); break;
      case 2: run<4, 2>(g, smem, row0, col0, k_begin, nk, tot); break;
      case 3: run<4, 3>(g, smem, row0, col0, k_begin, nk, tot); break;
      default: run<4, 4>(g, smem, row0, col0, k_begin, nk, tot); break;
    }
  }
  if (!OPT) {
    for_each_out(row0, col0, g.M, g.F, [&](size_t idx, int mt, int nt, int e) {
      atomicAdd(&out[idx], tot[mt][nt][e]);
    });
    return;
  }
  __syncthreads();  // sgd built
  if (gridDim.z == 1) {
    flush_sgd<false>(o, sgd_bytes, tot, row0, col0, g.M, g.F);
    return;
  }
  for_each_out(row0, col0, g.M, g.F, [&](size_t idx, int mt, int nt, int e) {
    atomicAdd(&o.ws[idx], tot[mt][nt][e]);
  });
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
  flush_sgd<true>(o, sgd_bytes, tot, row0, col0, g.M, g.F);
}

// Split-K for a GEMM whose epilogue is not linear (the forward matmuls,
// nitro_matmul_grad_x): the splits of a 64×64 output tile meet before it.
// Each writes its 16 sums a thread (of 256) to its own slot of `parts`
// with plain 16-byte stores, thread-major, so a slot is written whole and
// needs no zeroing; fences and counts itself in on the tile's arrival
// counter (zero, left zero).  The last to arrive reads the other slots
// back with __ldcg, each thread the same 16 sums it holds, and adds them
// mod 2^32 (exact in any order): it returns true with the whole sum in
// tot, every other split false.  `last` is a __shared__ flag.  (An
// atomicAdd per sum costs more: about 10 µs a call on an H100 in L2
// atomics and the read-back.)
constexpr int SPLIT_SLOT = 64 * 64;

__device__ __forceinline__ uint4* slot_words(unsigned* parts, size_t slot) {
  return reinterpret_cast<uint4*>(parts + slot * SPLIT_SLOT) + 4 * threadIdx.x;
}

__device__ __forceinline__ void add4(unsigned (&tot)[4], uint4 v) {
  tot[0] += v.x;
  tot[1] += v.y;
  tot[2] += v.z;
  tot[3] += v.w;
}

__device__ __forceinline__ bool sum_splits(unsigned* parts, unsigned* arrivals, size_t tile,
                                           unsigned (&tot)[4][4], bool& last) {
  uint4* mine = slot_words(parts, tile * gridDim.z + blockIdx.z);
#pragma unroll
  for (int t = 0; t < 4; ++t) mine[t] = make_uint4(tot[t][0], tot[t][1], tot[t][2], tot[t][3]);
  __threadfence();  // this block's sums are visible before it counts in
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* arrival = &arrivals[tile];
    last = atomicAdd(arrival, 1u) == gridDim.z - 1;
    if (last) *arrival = 0u;  // every split has counted in: reset
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  // the other splits' sums, two slots' loads in flight at a time
#pragma unroll 1
  for (unsigned s = 0; s < gridDim.z; s += 2) {
    const unsigned s1 = s + 1 < gridDim.z ? s + 1 : s;
    const uint4* a = slot_words(parts, tile * gridDim.z + s);
    const uint4* b = slot_words(parts, tile * gridDim.z + s1);
    uint4 va[4], vb[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      va[t] = __ldcg(a + t);
      vb[t] = __ldcg(b + t);
    }
    const bool use_a = s != blockIdx.z, use_b = s1 != s && s1 != blockIdx.z;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (use_a) add4(tot[t], va[t]);
      if (use_b) add4(tot[t], vb[t]);
    }
  }
  return true;
}

// Splits of a contraction Pp deep over `tiles` output tiles for `slots`
// resident blocks, each split a multiple of BK, at most MAX_CHUNK and at
// least `min_per` stages deep: the count with the least estimated time,
// in stages, waves × (stages a split + epi), the fewest on a tie.  `epi`
// is what a split's flush costs beyond its stages when there is more than
// one: the fuse_opt flush waits on the workspace atomics and the arrival
// counter before its block can retire, and with one block an SM the next
// block waits too (about 12 stages); the plain flush's atomics mostly
// retire in the background (3: a split's pipeline fill and atomics).
// The grad_W GEMMs have many tiles and keep splits 8 stages deep or more.
// The matmul digit GEMM (nitro_matmul.cu) has few tiles at a batch of
// 32–64, so it takes splits down to one stage, and its flush, where the
// last split reads every other split's tile back, adds `tail` stages per
// split beyond the first: 32×2048 · 2048×1024 is 16 tiles × 32 stages,
// which at 132 slots (one block an SM: two blocks on one SM share its
// bandwidth), epi 8 and tail 1 plans 4 splits of 8 stages (64 blocks);
// 64×3072 · 3072×3000 is 47 tiles × 48 stages: 2 splits of 24.
inline void plan_splits(long long tiles, long long Pp, int slots, int epi, int* splits,
                        int* p_chunk, int min_per = 8, int tail = 0) {
  const long long stages = Pp / BK;
  if (stages == 0) {  // P = 0: one empty split (the update still applies)
    *p_chunk = BK;
    *splits = 1;
    return;
  }
  const long long least = (Pp + MAX_CHUNK - 1) / MAX_CHUNK;
  long long most = stages / min_per;
  if (most < least) most = least;
  if (most > 65535) most = 65535;
  long long want = least, best = -1;
  for (long long s = least; s <= most; ++s) {
    const long long per = (stages + s - 1) / s;  // stages a split
    const long long n = (stages + per - 1) / per;  // splits that many make
    if (n != s) continue;
    const long long waves = (tiles * s + slots - 1) / slots;
    const long long est = waves * (per + (s > 1 ? epi : 0)) + tail * (s - 1);
    if (best < 0 || est < best) {
      best = est;
      want = s;
    }
  }
  const long long chunk = (stages + want - 1) / want * BK;
  *p_chunk = (int)chunk;
  *splits = (int)((Pp + chunk - 1) / chunk);
}

// Steps 1–3 on `stream`: zero the flags, x's range, δ's digit planes and
// x's patch digit planes into `scratch` (Layout::bytes).  Returns a
// cudaError_t.
inline int prepare(const Layout& L, const void* x, const void* delta, const void* z,
                   void* scratch, int alpha_inv, int sms, cudaStream_t st) {
  int8_t* s = (int8_t*)scratch;
  Flags* flags = (Flags*)s;
  const size_t win = L.window_bytes();
  if (win > 227 * 1024) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(Flags), st);
  if (err != cudaSuccess) return (int)err;
  const long long nx = (long long)L.P * L.C;
  const long long want = (nx + 255) / 256;
  const int blocks = (int)(want < 8LL * sms ? (want > 0 ? want : 1) : 8LL * sms);
  x_range_kernel<<<blocks, 256, 0, st>>>((const int32_t*)x, nx, flags);
  if (L.Pp == 0) return (int)cudaGetLastError();  // no pixels: nothing to stage
  const dim3 dgrid((unsigned)(L.Pp / PT), (unsigned)((L.F + 63) / 64));
  auto dk = z ? delta_digits_kernel<true> : delta_digits_kernel<false>;
  dk<<<dgrid, 256, 0, st>>>((const int32_t*)delta, (const int32_t*)z, s + L.db_off, L.P,
                            L.F, L.Pp, L.db_plane, FastDiv((unsigned)alpha_inv),
                            &flags->delta_digits, nullptr);
  if (win > 48 * 1024) {
    err = cudaFuncSetAttribute(patch_digits_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)win);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 pgrid((unsigned)(L.Pp / PT), (unsigned)((L.C + CG - 1) / CG));
  patch_digits_kernel<<<pgrid, 256, win, st>>>(
      (const int32_t*)x, s + L.xa_off, L.H, L.W, L.C, L.K, L.P, L.Pp, L.xa_plane,
      FastDiv((unsigned)L.W), FastDiv((unsigned)L.H), flags);
  return (int)cudaGetLastError();
}

// Step 4 on `stream`, after prepare: grad_W added into `out` (OPT false,
// M×F int32 zeroed by the caller) or W′ into o.w_new (OPT true; o.ws and
// o.arrivals zero, one counter per BM×BN tile, left zero).
template <bool OPT>
int launch_gemm(const Layout& L, void* scratch, unsigned* out, const SgdOut& o,
                int sms, cudaStream_t st) {
  auto kern = digit_gemm_kernel<OPT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((L.M + BM - 1) / BM) * ((L.F + BN - 1) / BN);
  int splits, p_chunk;
  plan_splits(tiles, L.Pp, sms * (per_sm > 0 ? per_sm : 1), OPT ? 12 : 3, &splits,
              &p_chunk);
  const int8_t* s = (const int8_t*)scratch;
  const GemmArgs g{s + L.xa_off, s + L.db_off, L.xa_plane, L.db_plane, L.Pp,
                   L.M, L.F, p_chunk, (const Flags*)s};
  const dim3 grid((L.F + BN - 1) / BN, (L.M + BM - 1) / BM, splits);
  kern<<<grid, THREADS, SMEM, st>>>(g, out, o);
  return (int)cudaGetLastError();
}

}  // namespace digits
}  // namespace nitro
