// The LES blocks' 2×2 stride-2 integer max-pool and its gradient routing
// for Hopper, NHWC int32:
//   maxpool_fwd: a (N,H,W,C) → out (N,H/2,W/2,C) int32 and idx (N,H/2,W/2,C)
//     uint8, idx = di·2 + dj of each window's FIRST max in the window order
//     (0,0), (0,1), (1,0), (1,1) (core/layers.py window_view_2x2), the
//     position jnp.argmax picks; an odd trailing row or column is floored away;
//   maxpool_bwd: g (N,H/2,W/2,C) int32 and idx → δ (N,H,W,C) int32: g at each
//     window's first-max position, 0 at its other three and over a cropped
//     odd edge.
//
// Replaces no Pallas kernel: the JAX package pools with jnp ops
// (src/repro/core/layers.py maxpool_forward / maxpool_backward), which XLA
// fuses.  The port ran them as about ten eager passes a pooled block and kept
// an int32 one-hot of the first max, (N,H/2,W/2,4,C), for the backward; one
// byte a pooled value holds the same position.
//
// Bound on an H100: bytes.  The forward reads 4 bytes of `a` a pre-pool value
// and writes 4 + 1 bytes a pooled value; the backward reads those 5 and writes
// the 4 bytes a pre-pool value.  At VGG8B's (and VGG11B's) four pool inputs at
// batch 512 (512×32×32×256, 512×16×16×512, 512×8×8×512, 512×4×4×512:
// 222,298,112 values) each direction moves 889.2 + 277.9 = 1,167.1 MB,
// 0.348 ms a step at 3.35 TB/s.
//
// Design:
//  * One thread owns V = 4 channels of one output position: four 16-byte
//    loads of `a`, one per window position (neighbouring threads on
//    neighbouring channels, so a warp reads 512 contiguous bytes at each),
//    one 16-byte store of out and a uchar4 of idx; the backward one 16-byte
//    load of g, a uchar4 of idx and four 16-byte stores.  C % 4 ≠ 0, or an
//    operand off its 16-byte (idx: 4-byte) alignment, takes the V = 1 variant
//    of the same code.
//  * Grid-stride loops over (position, channel group), the grid at most
//    BLOCKS_PER_SM blocks of THREADS an SM: 64 bytes of loads in flight a
//    thread, up to 128 KB an SM where the card needs about 18 KB to stream at
//    its rate, and the 4×4×512 input (262,144 groups, 1,024 blocks, 7.8 an
//    SM) still keeps 62 KB an SM in flight.
//  * The first max is a strict > scan in window order, as the one-hot's
//    first-true was.  `a`, g and idx are read once (evict-first loads); out
//    and δ are read by the next kernel.
//  * The backward's grid-stride loop then zeroes the cropped odd edge: the
//    last column of rows 0..2·(H/2)−1 when W is odd, the last row when H is
//    odd, V channels a thread.
//  * Index arithmetic in 32 bits (the wrapper keeps every tensor under 2^31
//    values); element offsets in 64.
#include <stdint.h>

#include "nitro_epilogue.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;  // 2,048 threads: a full SM

template <int V>
struct Lanes;
template <>
struct Lanes<4> {
  static __device__ __forceinline__ void load(const int32_t* p, int (&v)[4]) {
    const int4 t = __ldcs(reinterpret_cast<const int4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  }
  static __device__ __forceinline__ void store(int32_t* p, const int (&v)[4]) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ void load_idx(const uint8_t* p, int (&k)[4]) {
    const uchar4 t = __ldcs(reinterpret_cast<const uchar4*>(p));
    k[0] = t.x, k[1] = t.y, k[2] = t.z, k[3] = t.w;
  }
  static __device__ __forceinline__ void store_idx(uint8_t* p, const int (&k)[4]) {
    *reinterpret_cast<uchar4*>(p) = make_uchar4(k[0], k[1], k[2], k[3]);
  }
};
template <>
struct Lanes<1> {
  static __device__ __forceinline__ void load(const int32_t* p, int (&v)[1]) {
    v[0] = __ldcs(p);
  }
  static __device__ __forceinline__ void store(int32_t* p, const int (&v)[1]) { *p = v[0]; }
  static __device__ __forceinline__ void load_idx(const uint8_t* p, int (&k)[1]) {
    k[0] = __ldcs(p);
  }
  static __device__ __forceinline__ void store_idx(uint8_t* p, const int (&k)[1]) {
    *p = (uint8_t)k[0];
  }
};

// The pre-pool element of window position (0,0) of output group i, and the
// group's pooled element offset (i·V).
struct Window {
  long long src, dst;
};
template <int V>
__device__ __forceinline__ Window window_of(unsigned i, int H, int W, int C, unsigned groups,
                                            unsigned h2, unsigned w2) {
  const unsigned c = (i % groups) * V, p = i / groups;
  const unsigned ow = p % w2, q = p / w2;  // q = n·h2 + oh
  const unsigned oh = q % h2, n = q / h2;
  const long long row = (long long)n * H + 2 * oh;
  return {(row * W + 2 * ow) * C + c, (long long)i * V};
}

template <int V>
__global__ void __launch_bounds__(THREADS)
maxpool_fwd_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                   uint8_t* __restrict__ idx, int H, int W, int C, unsigned groups,
                   unsigned h2, unsigned w2, unsigned total) {
  const long long down = (long long)W * C;
  for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < total; i += gridDim.x * THREADS) {
    const Window win = window_of<V>(i, H, W, C, groups, h2, w2);
    int v[4][V];
    Lanes<V>::load(a + win.src, v[0]);
    Lanes<V>::load(a + win.src + C, v[1]);
    Lanes<V>::load(a + win.src + down, v[2]);
    Lanes<V>::load(a + win.src + down + C, v[3]);
    int m[V], k[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = v[0][j];
      k[j] = 0;
#pragma unroll
      for (int pos = 1; pos < 4; ++pos)
        if (v[pos][j] > m[j]) m[j] = v[pos][j], k[j] = pos;
    }
    Lanes<V>::store(out + win.dst, m);
    Lanes<V>::store_idx(idx + win.dst, k);
  }
}

template <int V>
__global__ void __launch_bounds__(THREADS)
maxpool_bwd_kernel(const int32_t* __restrict__ g, const uint8_t* __restrict__ idx,
                   int32_t* __restrict__ d, int H, int W, int C, unsigned groups,
                   unsigned h2, unsigned w2, unsigned total, unsigned edge_pixels,
                   unsigned edge_total) {
  const long long down = (long long)W * C;
  const unsigned stride = gridDim.x * THREADS;
  const unsigned first = blockIdx.x * THREADS + threadIdx.x;
  for (unsigned i = first; i < total; i += stride) {
    const Window win = window_of<V>(i, H, W, C, groups, h2, w2);
    int gv[V], k[V];
    Lanes<V>::load(g + win.dst, gv);
    Lanes<V>::load_idx(idx + win.dst, k);
    const long long at[4] = {win.src, win.src + C, win.src + down, win.src + down + C};
#pragma unroll
    for (int pos = 0; pos < 4; ++pos) {
      int o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = k[j] == pos ? gv[j] : 0;
      Lanes<V>::store(d + at[pos], o);
    }
  }
  // the cropped edge: pixel e of an image is (e, W−1) for e < col_pixels,
  // else (H−1, e − col_pixels)
  const unsigned col_pixels = (W & 1) ? 2 * h2 : 0;
  const int zero[V] = {};
  for (unsigned e = first; e < edge_total; e += stride) {
    const unsigned c = (e % groups) * V, p = e / groups;
    const unsigned pix = p % edge_pixels, n = p / edge_pixels;
    const unsigned r = pix < col_pixels ? pix : H - 1;
    const unsigned col = pix < col_pixels ? W - 1 : pix - col_pixels;
    Lanes<V>::store(d + (((long long)n * H + r) * W + col) * C + c, zero);
  }
}

unsigned grid_for(unsigned work, int sms) {
  const unsigned blocks = (work + THREADS - 1) / THREADS;
  const unsigned cap = (unsigned)(sms > 0 ? sms : 1) * BLOCKS_PER_SM;
  return blocks < 1 ? 1 : (blocks < cap ? blocks : cap);
}

bool aligned(const void* p, uintptr_t bytes) { return ((uintptr_t)p % bytes) == 0; }

}  // namespace

// a, out, idx: contiguous, on one device; n·h·w·c < 2^31, n·(h/2)·(w/2)·c ≥ 1.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int maxpool_fwd_launch(const void* a, void* out, void* idx, int n, int h, int w,
                                  int c, int sms, void* stream) {
  const unsigned h2 = h / 2, w2 = w / 2;
  const bool vec = c % 4 == 0 && aligned(a, 16) && aligned(out, 16) && aligned(idx, 4);
  const unsigned groups = vec ? c / 4 : c;
  const unsigned total = (unsigned)n * h2 * w2 * groups;
  if (total == 0) return (int)cudaErrorInvalidValue;
  const auto s = (cudaStream_t)stream;
  const auto* ap = static_cast<const int32_t*>(a);
  auto* op = static_cast<int32_t*>(out);
  auto* ip = static_cast<uint8_t*>(idx);
  if (vec)
    maxpool_fwd_kernel<4><<<grid_for(total, sms), THREADS, 0, s>>>(ap, op, ip, h, w, c, groups,
                                                                   h2, w2, total);
  else
    maxpool_fwd_kernel<1><<<grid_for(total, sms), THREADS, 0, s>>>(ap, op, ip, h, w, c, groups,
                                                                   h2, w2, total);
  return (int)cudaGetLastError();
}

// g, idx: (n, h/2, w/2, c); d: (n, h, w, c), n·h·w·c in [1, 2^31); all
// contiguous, on one device.  Launches on `stream`; returns cudaGetLastError().
extern "C" int maxpool_bwd_launch(const void* g, const void* idx, void* d, int n, int h, int w,
                                  int c, int sms, void* stream) {
  const unsigned h2 = h / 2, w2 = w / 2;
  const bool vec = c % 4 == 0 && aligned(g, 16) && aligned(d, 16) && aligned(idx, 4);
  const unsigned groups = vec ? c / 4 : c;
  const unsigned total = (unsigned)n * h2 * w2 * groups;
  const unsigned edge_pixels = ((w & 1) ? 2 * h2 : 0) + ((h & 1) ? (unsigned)w : 0);
  const unsigned edge_total = (unsigned)n * edge_pixels * groups;
  if (total == 0 && edge_total == 0) return (int)cudaErrorInvalidValue;
  const unsigned work = total > edge_total ? total : edge_total;
  const auto s = (cudaStream_t)stream;
  const auto* gp = static_cast<const int32_t*>(g);
  const auto* ip = static_cast<const uint8_t*>(idx);
  auto* dp = static_cast<int32_t*>(d);
  if (vec)
    maxpool_bwd_kernel<4><<<grid_for(work, sms), THREADS, 0, s>>>(
        gp, ip, dp, h, w, c, groups, h2, w2, total, edge_pixels, edge_total);
  else
    maxpool_bwd_kernel<1><<<grid_for(work, sms), THREADS, 0, s>>>(
        gp, ip, dp, h, w, c, groups, h2, w2, total, edge_pixels, edge_total);
  return (int)cudaGetLastError();
}
