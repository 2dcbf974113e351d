// Streaming implicit-im2col NITRO conv for Hopper: a K×K stride-1 'same'
// NHWC conv, NITRO Scaling, NITRO-ReLU and an optional fused 2×2/stride-2
// max-pool, written as int8 or int32.
//
// Replaces: src/repro/kernels/nitro_conv/nitro_conv.py::stream_conv
//           (Pallas body _stream_conv_kernel).
//
// Bound on an H100 at VGG8B's serving shapes (batch 32): operations.  The
// 3×3 convs do 1.2–9.7 G integer ops per launch against a few MiB of int8
// activations and weights, so at the 1,979 TOP/s int8 tensor-core peak
// the ops, not the 3.35 TB/s of memory, set the floor.  This kernel
// multiplies on the CUDA cores (IMAD, or __dp4a for int8), far below that
// floor; the tensor-core version is later work.
//
// Design:
//   * one block per (image, band of bh output rows, pixel tile, 32-filter
//     tile); bh comes from the Python side's conv_geometry (even when the
//     pool is fused, so every window lies inside one band);
//   * the block stages the band's (bh+K−1) × (W+K−1) input rows into a
//     shared-memory ring in their stored dtype, zero-filling the halo and
//     the rows past H with masked loads (no padded copy of the input);
//   * the Pallas kernel's (bh·W, K²C) patch block is never formed — at
//     VGG8B widths it would exceed the 227 KB a block may use; each output
//     (r, w, f) reads rows[r+ki][w+kj][c] · w_flat[(ki·K+kj)·C + c][f]
//     straight from the ring (implicit im2col, the repo's patch layout);
//   * C is staged in chunks that fit the ring budget, so int32 operands at
//     wide C fit too; the accumulators live in registers across chunks;
//   * lane = filter: the weight row read is coalesced and every lane of a
//     warp reads the same ring word (a shared-memory broadcast);
//   * each thread holds NACC accumulators (4, 8 or 16, picked per launch so
//     a band's units fill the slots); a warp left without a unit skips the
//     arithmetic;
//   * int8 operands with 4 | C take 4 channels per __dp4a: one 32-bit ring
//     load against 4 weight bytes packed into one register;
//   * epilogue: scale, ReLU, then the max over each 2×2 window (odd W
//     cropped, as _maxpool_tile does), narrowed and stored; rows past H
//     (band padding) are never written.
#include "nitro_epilogue.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BF = 32;    // filters per block (one per lane)

struct ConvShape {
  int H, W, C, F, K, bh, n_ptiles, cc;  // cc: channels per staged chunk
};

// acc[i][q] += Σ_c ring[pixel (i,q) shifted by (ki,kj)][c] · w[..][c][f],
// one channel at a time.
template <typename T, int UPT, int Q>
__device__ __forceinline__ void accumulate(unsigned (&acc)[UPT][Q],
                                           const int (&base)[UPT],
                                           const int (&qoff)[Q], const T* ring,
                                           const T* __restrict__ w,
                                           const ConvShape& s, int c0, int cn,
                                           int f, int ring_w) {
  for (int c = 0; c < cn; ++c) {
    for (int ki = 0; ki < s.K; ++ki) {
      for (int kj = 0; kj < s.K; ++kj) {
        const size_t wrow = (size_t)((ki * s.K + kj) * s.C + c0 + c);
        const int wv = f < s.F ? (int)__ldg(&w[wrow * s.F + f]) : 0;
        const int shift = ki * ring_w + kj;
#pragma unroll
        for (int i = 0; i < UPT; ++i)
#pragma unroll
          for (int q = 0; q < Q; ++q)
            acc[i][q] = nitro::mac(
                acc[i][q], (int)ring[(base[i] + qoff[q] + shift) * cn + c], wv);
      }
    }
  }
}

// The same for int8 with 4 | cn: four channels per __dp4a.
template <int UPT, int Q>
__device__ __forceinline__ void accumulate_dp4a(unsigned (&acc)[UPT][Q],
                                                const int (&base)[UPT],
                                                const int (&qoff)[Q],
                                                const int8_t* ring,
                                                const int8_t* __restrict__ w,
                                                const ConvShape& s, int c0,
                                                int cn, int f, int ring_w) {
  for (int c = 0; c < cn; c += 4) {
    for (int ki = 0; ki < s.K; ++ki) {
      for (int kj = 0; kj < s.K; ++kj) {
        unsigned packed = 0u;  // weights of channels c..c+3, low byte first
        if (f < s.F) {
          const int8_t* wp = w + (size_t)((ki * s.K + kj) * s.C + c0 + c) * s.F + f;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            packed |= (unsigned)(unsigned char)__ldg(wp + b * s.F) << (8 * b);
        }
        const int wv = (int)packed;
        const int shift = ki * ring_w + kj;
#pragma unroll
        for (int i = 0; i < UPT; ++i)
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int a = *reinterpret_cast<const int*>(
                ring + (base[i] + qoff[q] + shift) * cn + c);
            acc[i][q] = (unsigned)__dp4a(a, wv, (int)acc[i][q]);
          }
      }
    }
  }
}

template <typename T, typename TOut, bool POOL, int NACC>
__global__ void __launch_bounds__(THREADS)
stream_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   TOut* __restrict__ out, ConvShape s, nitro::Epilogue ep) {
  constexpr int Q = POOL ? 4 : 1;      // pixels per unit (a 2×2 window)
  constexpr int UPT = NACC / Q;        // units per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int f = blockIdx.x * BF + lane;
  const int band = blockIdx.y / s.n_ptiles, ptile = blockIdx.y % s.n_ptiles;
  const int n = blockIdx.z;
  const int p = s.K / 2;
  const int ring_w = s.W + s.K - 1, ring_h = s.bh + s.K - 1;
  const int w2 = s.W / 2;
  const int units = POOL ? (s.bh / 2) * w2 : s.bh * s.W;

  // Ring position of each unit's top-left pixel, and of a window's pixels
  // relative to it.  Unit u of slot i grows with i, so the valid slots of
  // a warp come first.
  int base[UPT];
  bool valid[UPT];
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    int u = (ptile * UPT + i) * WARPS + warp;
    valid[i] = u < units;
    if (!valid[i]) u = 0;  // compute a harmless pixel, never stored
    int r = POOL ? 2 * (u / w2) : u / s.W;
    int c = POOL ? 2 * (u % w2) : u % s.W;
    base[i] = r * ring_w + c;
  }
  int qoff[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) qoff[q] = (q / 2) * ring_w + q % 2;

  unsigned acc[UPT][Q];
#pragma unroll
  for (int i = 0; i < UPT; ++i)
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[i][q] = 0u;

  const bool vec4 = sizeof(T) == 1 && s.C % 4 == 0 && s.cc % 4 == 0;
  const size_t img = (size_t)n * s.H * s.W * s.C;
  for (int c0 = 0; c0 < s.C; c0 += s.cc) {
    const int cn = min(s.cc, s.C - c0);
    __syncthreads();  // the previous chunk's readers are done
    for (int e = threadIdx.x; e < ring_h * ring_w * cn; e += THREADS) {
      int c = e % cn, t = e / cn;
      int gh = band * s.bh + t / ring_w - p, gw = t % ring_w - p;
      bool in = gh >= 0 && gh < s.H && gw >= 0 && gw < s.W;
      ring[e] = in ? x[img + ((size_t)gh * s.W + gw) * s.C + c0 + c] : T(0);
    }
    __syncthreads();
    if (!valid[0]) continue;  // this warp has no unit in the tile
    if constexpr (sizeof(T) == 1) {
      if (vec4) {
        accumulate_dp4a<UPT, Q>(acc, base, qoff, ring, w, s, c0, cn, f, ring_w);
        continue;
      }
    }
    accumulate<T, UPT, Q>(acc, base, qoff, ring, w, s, c0, cn, f, ring_w);
  }

  if (f >= s.F) return;
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    if (!valid[i]) continue;
    int u = (ptile * UPT + i) * WARPS + warp;
    if (POOL) {
      int prow = band * (s.bh / 2) + u / w2;
      if (prow >= s.H / 2) continue;
      int v = ep((int)acc[i][0]);
#pragma unroll
      for (int q = 1; q < Q; ++q) v = max(v, ep((int)acc[i][q]));
      nitro::store(&out[(((size_t)n * (s.H / 2) + prow) * w2 + u % w2) * s.F + f], v);
    } else {
      int row = band * s.bh + u / s.W;
      if (row >= s.H) continue;
      nitro::store(&out[(((size_t)n * s.H + row) * s.W + u % s.W) * s.F + f],
                   ep((int)acc[i][0]));
    }
  }
}

// Accumulators per thread for a band of `units` units (pixels, or 2×2
// windows when pooling): the most that still fills every warp's slots.
int pick_nacc(int pool, int units) {
  const int q = pool ? 4 : 1;
  const int choices[3] = {16, 8, 4};
  for (int nacc : choices)
    if (WARPS * (nacc / q) <= units) return nacc;
  return 4;
}

template <typename T, typename TOut, bool POOL, int NACC>
int launch(const void* x, const void* w, void* out, int N, ConvShape s,
           int n_bands, nitro::Epilogue ep, void* stream) {
  auto kern = stream_conv_kernel<T, TOut, POOL, NACC>;
  size_t smem = (size_t)(s.bh + s.K - 1) * (s.W + s.K - 1) * s.cc * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s.F + BF - 1) / BF, n_bands * s.n_ptiles, N);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (TOut*)out, s, ep);
  return (int)cudaGetLastError();
}

template <typename T, typename TOut, bool POOL>
int launch_nacc(const void* x, const void* w, void* out, int N, ConvShape s,
                int n_bands, nitro::Epilogue ep, void* stream) {
  const int units = POOL ? (s.bh / 2) * (s.W / 2) : s.bh * s.W;
  switch (pick_nacc(POOL, units)) {
    case 16: return launch<T, TOut, POOL, 16>(x, w, out, N, s, n_bands, ep, stream);
    case 8: return launch<T, TOut, POOL, 8>(x, w, out, N, s, n_bands, ep, stream);
    default: return launch<T, TOut, POOL, 4>(x, w, out, N, s, n_bands, ep, stream);
  }
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, int N, ConvShape s,
             int n_bands, int pool, int out_int8, nitro::Epilogue ep,
             void* stream) {
  if (pool)
    return out_int8 ? launch_nacc<T, int8_t, true>(x, w, out, N, s, n_bands, ep, stream)
                    : launch_nacc<T, int32_t, true>(x, w, out, N, s, n_bands, ep, stream);
  return out_int8 ? launch_nacc<T, int8_t, false>(x, w, out, N, s, n_bands, ep, stream)
                  : launch_nacc<T, int32_t, false>(x, w, out, N, s, n_bands, ep, stream);
}

}  // namespace

// Units (pixels, or 2×2 windows when pooling) one block covers, for a band
// of `units` units.
extern "C" int stream_conv_units_per_block(int pool, int units) {
  return WARPS * pick_nacc(pool, units) / (pool ? 4 : 1);
}

// x (N,H,W,C) NHWC, w_flat (K·K·C, F), out (N,H,W,F) or (N,H/2,W/2,F) with
// pool, all contiguous.  in_int8: x and w int8 (else both int32).  bh and
// n_bands come from conv_geometry (bh even when pool); n_ptiles =
// ceil(units per band / stream_conv_units_per_block(pool, units)); cc =
// channels per staged chunk (a multiple of 4 lets int8 use __dp4a).
// Launches on `stream`; returns the CUDA error code.
extern "C" int stream_conv_launch(const void* x, const void* w, void* out,
                                  int N, int H, int W, int C, int F, int K,
                                  int bh, int n_bands, int n_ptiles, int cc,
                                  int shift, int residual, int alpha_inv,
                                  int mu, int apply_relu, int pool,
                                  int in_int8, int out_int8, void* stream) {
  ConvShape s{H, W, C, F, K, bh, n_ptiles, cc};
  nitro::Epilogue ep{shift, residual, alpha_inv, mu, apply_relu};
  if (in_int8)
    return dispatch<int8_t>(x, w, out, N, s, n_bands, pool, out_int8, ep, stream);
  return dispatch<int32_t>(x, w, out, N, s, n_bands, pool, out_int8, ep, stream);
}
