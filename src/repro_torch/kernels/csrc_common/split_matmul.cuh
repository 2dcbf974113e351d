// The split-K matmul digit GEMM: C = x·w over exact signed base-256
// digits on the int8 tensor cores, each output through an epilogue that
// the including file supplies.  Shared by nitro_matmul.cu (the NITRO scale
// and ReLU: #1, #2) and int_matmul.cu (no epilogue: the plain int32
// product mod 2^32 of numerics.int_matmul).  The design notes are
// nitro_matmul.cu's.
//
// The including file defines, in its own namespace, an output struct with
// `unsigned* parts` (set by launch) and `unsigned* arrivals` members, and
// `__device__ void emit(const Out&, size_t idx, unsigned z)`, which
// write_tile finds by argument-dependent lookup; then it calls
// nitro::mm::launch(L, x, x_int8, w, w_int8, scratch, out, sms, stream).
#pragma once
#include "digit_gemm.cuh"

namespace nitro {
namespace mm {

using digits::MAXD;

constexpr int TN = 64;          // output columns n a block (w's digit rows)
constexpr int TM = 64;          // batch rows m a block
constexpr int BK = digits::BK;  // contraction bytes a stage; Kp is a multiple
constexpr int ROW = BK + 16;    // padded shared row: conflict-free ldmatrix
constexpr int THREADS = 256;
constexpr int RING = 102400;    // bytes of stages: two blocks an SM fit
constexpr int SLOT = digits::SPLIT_SLOT;  // sums a split's slot holds (TN · TM)
constexpr int MAX_STAGES = digits::MAX_CHUNK / BK;  // stages of the deepest split

struct Flags {
  int x_digits;  // most digits any x needs (0: x read as it is, one)
  int w_digits;  // most digits any w needs
};

// Shapes of one call, its grid and its scratch: the flags, w's tile map
// (one byte per 64 × 64 tile of w) and (N, Kp) planes, x's (M, Kp) planes
// when they are written, then one slot per (output tile, split) when the
// contraction is split.
struct Layout {
  int M, N, K;
  long long Kp, kts, w_plane, x_plane;
  int w_planes, x_planes;  // planes written (x: 0 when read as it is)
  bool wide;               // not both operands int8: the sixteen variants
  int n_tiles, m_tiles, splits, k_chunk;
  size_t map_off, w_off, x_off, parts_off, bytes;

  Layout(int M_, int N_, int K_, bool x_int8, bool w_int8, bool x_direct, int sms)
      : M(M_), N(N_), K(K_), wide(!(x_int8 && w_int8)) {
    Kp = ((long long)K + BK - 1) / BK * BK;
    kts = Kp / BK;
    n_tiles = (N + TN - 1) / TN;
    w_plane = (long long)N * Kp;
    x_plane = (long long)M * Kp;
    w_planes = w_int8 ? 1 : MAXD;
    x_planes = x_direct ? 0 : (x_int8 ? 1 : MAXD);
    m_tiles = (M + TM - 1) / TM;
    // splits planned for one block an SM: an H100 fits two (registers and
    // RING), but two blocks on one SM share its bandwidth
    digits::plan_splits((long long)n_tiles * m_tiles, Kp, sms, 8, &splits, &k_chunk, 1, 1);
    map_off = 256;
    w_off = (map_off + (size_t)kts * n_tiles + 255) / 256 * 256;
    x_off = (w_off + (size_t)w_planes * w_plane + 255) / 256 * 256;
    parts_off = (x_off + (size_t)x_planes * x_plane + 255) / 256 * 256;
    bytes = parts_off +
            (splits > 1 ? (size_t)n_tiles * m_tiles * splits * SLOT * sizeof(unsigned) : 0);
  }
};

struct Args {
  const int8_t* wb;      // w's planes WB[j][n][k], rows Kp apart
  const uint8_t* w_map;  // planes each 64 × 64 tile of w has: [n tile][k tile]
  const int8_t* xb;      // x's planes XB[i][m][k], or int8 x itself
  long long w_plane, x_plane, Kp, kts, x_stride;  // x_stride: Kp, or K for x itself
  long long x_cols;                               // columns of x that exist (Kp or K)
  int M, N, k_chunk;
  const Flags* flags;
};

// Stage contraction bytes [k0, k0 + BK) of NW planes of w rows and NX
// planes of x rows into `as`: one 16-byte copy a thread a plane, zero-filled
// past N, past M, past x's columns and past the `w_has` planes this tile
// of w has.
template <int NX, int NW>
__device__ __forceinline__ void load_stage(const Args& g, int8_t* as, int n0, int m0,
                                           long long k0, int w_has) {
  int8_t* bs = as + NW * TN * ROW;
  const int r = threadIdx.x / 4, c = threadIdx.x % 4;  // TN·4 = TM·4 = THREADS
  const bool okw = n0 + r < g.N;
  const int8_t* wsrc = g.wb + (okw ? (size_t)(n0 + r) * g.Kp : 0) + k0 + 16 * c;
#pragma unroll
  for (int j = 0; j < NW; ++j)
    digits::cp16(as + (j * TN + r) * ROW + 16 * c, wsrc + j * g.w_plane, okw && j < w_has);
  const bool okx = m0 + r < g.M && k0 + 16 * c < g.x_cols;
  const int8_t* xsrc = g.xb + (okx ? (size_t)(m0 + r) * g.x_stride + k0 + 16 * c : 0);
#pragma unroll
  for (int i = 0; i < NX; ++i)
    digits::cp16(bs + (i * TM + r) * ROW + 16 * c, xsrc + i * g.x_plane, okx);
}

// One staged slice: every digit pair i + j < MAXD of the NX x planes and
// NW w planes, into the accumulator set of its shift i + j.  Warp w owns
// w rows 16·(w % 4) (one m16 tile) and x rows 32·(w / 4) (four n8 tiles).
template <int NX, int NW, int G>
__device__ __forceinline__ void stage_mma(const int8_t* as, int a_off, int b_off,
                                          int (&acc)[G][4][4]) {
  const int8_t* bs = as + NW * TN * ROW;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    unsigned b[NX][4][2];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int np = 0; np < 2; ++np)
        digits::ldsm_x4(bs + i * TM * ROW + b_off + np * 16 * ROW + kk, b[i][2 * np][0],
                        b[i][2 * np][1], b[i][2 * np + 1][0], b[i][2 * np + 1][1]);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      unsigned a[4];
      digits::ldsm_x4(as + j * TN * ROW + a_off + kk, a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        if (i + j >= MAXD) continue;
#pragma unroll
        for (int t = 0; t < 4; ++t) digits::mma_s8(acc[i + j][t], a, b[i][t]);
      }
    }
  }
}

// The split's digit products, combined mod 2^32 into tot[t][e]: output
// column n = n0 + 16·(warp % 4) + lane/4 (+8 for e ≥ 2), batch row
// m = m0 + 32·(warp / 4) + 8·t + 2·(lane % 4) + e % 2 (the mma C layout).
template <int NX, int NW>
__device__ __forceinline__ void run(const Args& g, int8_t* smem, const uint8_t* w_has,
                                    int n0, int m0, long long k_begin, int nk,
                                    unsigned (&tot)[4][4]) {
  constexpr int G = NX + NW - 1 < MAXD ? NX + NW - 1 : MAXD;  // shifts 0..G−1
  constexpr int STAGE = (NW * TN + NX * TM) * ROW;
  constexpr int FIT = RING / STAGE;
  constexpr int S = FIT < 2 ? 2 : (FIT > 8 ? 8 : FIT);
  int acc[G][4][4];
#pragma unroll
  for (int s = 0; s < G; ++s)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][t][e] = 0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int a_off = (16 * (warp % 4) + lane % 8 + 8 * ((lane / 8) % 2)) * ROW + 16 * (lane / 16);
  const int b_off = (32 * (warp / 4) + lane % 8 + 8 * (lane / 16)) * ROW + 16 * ((lane / 8) % 2);
#pragma unroll 1
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load_stage<NX, NW>(g, smem + s * STAGE, n0, m0, k_begin + s * BK, w_has[s]);
    digits::cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    digits::cp_wait<S - 2>();
    __syncthreads();
    const int nxt = kt + S - 1;
    if (nxt < nk)
      load_stage<NX, NW>(g, smem + (nxt % S) * STAGE, n0, m0, k_begin + nxt * BK, w_has[nxt]);
    digits::cp_commit();
    stage_mma<NX, NW>(smem + (kt % S) * STAGE, a_off, b_off, acc);
  }
  digits::cp_wait<0>();
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      unsigned v = 0u;
#pragma unroll
      for (int s = 0; s < G; ++s) v += (unsigned)acc[s][t][e] << (8 * s);
      tot[t][e] = v;
    }
}

template <int NX>
__device__ __forceinline__ void run_w(int nw, const Args& g, int8_t* smem, const uint8_t* w_has,
                                      int n0, int m0, long long k_begin, int nk,
                                      unsigned (&tot)[4][4]) {
  switch (nw) {
    case 1: run<NX, 1>(g, smem, w_has, n0, m0, k_begin, nk, tot); break;
    case 2: run<NX, 2>(g, smem, w_has, n0, m0, k_begin, nk, tot); break;
    case 3: run<NX, 3>(g, smem, w_has, n0, m0, k_begin, nk, tot); break;
    default: run<NX, 4>(g, smem, w_has, n0, m0, k_begin, nk, tot); break;
  }
}

// The tile's whole sums, staged in shared memory as [m][n] (TN + 1 apart),
// to the outputs: one rolled loop, consecutive threads on consecutive n.
// Each block runs this code once, so it is kept short: it is fetched cold.
template <class Out>
__device__ void write_tile(const Out& o, const unsigned* tile, int n0, int m0, int M, int N) {
#pragma unroll 1
  for (int i = threadIdx.x; i < TM * TN; i += THREADS) {
    const int m = m0 + i / TN, n = n0 + i % TN;
    if (m < M && n < N) emit(o, (size_t)m * N + n, tile[(i / TN) * (TN + 1) + i % TN]);
  }
}

// One 64 n × 64 m tile over one split of the contraction.  WIDE false:
// both operands int8, the one-product variant alone; WIDE true: the
// variant the flags name.
template <bool WIDE, class Out>
__global__ void __launch_bounds__(THREADS, 2)
matmul_digit_kernel(Args g, Out o) {
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ uint8_t w_has[MAX_STAGES];  // planes w's tile has at each stage
  __shared__ bool last;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const long long k_begin = (long long)blockIdx.z * g.k_chunk;
  const long long k_end = min(g.Kp, k_begin + g.k_chunk);
  const int nk = k_end > k_begin ? (int)((k_end - k_begin) / BK) : 0;
  for (int i = threadIdx.x; i < nk; i += THREADS)
    w_has[i] = g.w_map[blockIdx.x * g.kts + k_begin / BK + i];
  __syncthreads();
  unsigned tot[4][4];
  if (!WIDE) {
    run<1, 1>(g, smem, w_has, n0, m0, k_begin, nk, tot);
  } else {
    const int nx = min(max(g.flags->x_digits, 1), MAXD);
    const int nw = min(max(g.flags->w_digits, 1), MAXD);
    switch (nx) {
      case 1: run_w<1>(nw, g, smem, w_has, n0, m0, k_begin, nk, tot); break;
      case 2: run_w<2>(nw, g, smem, w_has, n0, m0, k_begin, nk, tot); break;
      case 3: run_w<3>(nw, g, smem, w_has, n0, m0, k_begin, nk, tot); break;
      default: run_w<4>(nw, g, smem, w_has, n0, m0, k_begin, nk, tot); break;
    }
  }
  if (gridDim.z > 1 &&
      !digits::sum_splits(o.parts, o.arrivals, (size_t)blockIdx.y * gridDim.x + blockIdx.x, tot,
                          last))
    return;
  // stage the whole sums as [m][n] in the ring, free once every warp is done
  unsigned* staged = reinterpret_cast<unsigned*>(smem);
  __syncthreads();
  {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int nb = 16 * (warp % 4) + lane / 4, mb = 32 * (warp / 4) + 2 * (lane % 4);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        staged[(mb + 8 * t + e % 2) * (TN + 1) + nb + 8 * (e / 2)] = tot[t][e];
  }
  __syncthreads();
  write_tile(o, staged, n0, m0, g.M, g.N);
}

inline int grid_stride_blocks(long long items, int sms) {
  const long long want = (items + 255) / 256;
  return (int)(want < 8LL * sms ? (want > 0 ? want : 1) : 8LL * sms);
}

// The whole call on `st`: zero the flags, w's planes and tile map, x's
// planes (unless read as it is), then the GEMM.  Returns a cudaError_t.
template <class Out>
inline int launch(const Layout& L, const void* x, bool x_int8, const void* w, bool w_int8,
                  void* scratch, Out o, int sms, cudaStream_t st) {
  int8_t* s = (int8_t*)scratch;
  Flags* flags = (Flags*)s;
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(Flags), st);
  if (err != cudaSuccess) return (int)err;
  if (L.Kp > 0) {
    const dim3 grid((unsigned)L.kts, (unsigned)L.n_tiles);
    uint8_t* map = (uint8_t*)(s + L.map_off);
    if (w_int8)
      digits::delta_digits_kernel<false, int8_t><<<grid, 256, 0, st>>>(
          (const int8_t*)w, nullptr, s + L.w_off, L.K, L.N, L.Kp, L.w_plane, FastDiv(1),
          &flags->w_digits, map);
    else
      digits::delta_digits_kernel<false, int32_t><<<grid, 256, 0, st>>>(
          (const int32_t*)w, nullptr, s + L.w_off, L.K, L.N, L.Kp, L.w_plane, FastDiv(1),
          &flags->w_digits, map);
    if (L.x_planes > 0) {
      const int blocks = grid_stride_blocks(L.M * (L.Kp / 4), sms);
      if (x_int8)
        digits::row_digits_kernel<false, int8_t><<<blocks, 256, 0, st>>>(
            (const int8_t*)x, nullptr, FastDiv(1), s + L.x_off, L.M, L.K, L.Kp, L.x_plane,
            &flags->x_digits);
      else
        digits::row_digits_kernel<false, int32_t><<<blocks, 256, 0, st>>>(
            (const int32_t*)x, nullptr, FastDiv(1), s + L.x_off, L.M, L.K, L.Kp, L.x_plane,
            &flags->x_digits);
    }
  }
  Args g;
  g.wb = s + L.w_off;
  g.w_map = (const uint8_t*)(s + L.map_off);
  g.xb = L.x_planes > 0 ? s + L.x_off : (const int8_t*)x;
  g.w_plane = L.w_plane;
  g.x_plane = L.x_plane;
  g.Kp = L.Kp;
  g.kts = L.kts;
  g.x_stride = L.x_planes > 0 ? L.Kp : L.K;
  g.x_cols = L.x_planes > 0 ? L.Kp : L.K;
  g.M = L.M;
  g.N = L.N;
  g.k_chunk = L.k_chunk;
  g.flags = flags;
  o.parts = (unsigned*)(s + L.parts_off);
  auto kern = L.wide ? matmul_digit_kernel<true, Out> : matmul_digit_kernel<false, Out>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, RING);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(L.n_tiles, L.m_tiles, L.splits);
  kern<<<grid, THREADS, RING, st>>>(g, o);
  return (int)cudaGetLastError();
}

}  // namespace mm
}  // namespace nitro
