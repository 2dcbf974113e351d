// Fused IntegerSGD update for Hopper (paper Algorithm 1), elementwise over
// a tensor of any shape: W′ = W − (⌊g/γ_inv⌋ + ⌊W/η_inv⌋), no decay for
// η_inv = 0, int32 wrapping mod 2^32.
//
// Replaces: src/repro/kernels/integer_sgd/integer_sgd.py::integer_sgd_update
//           (Pallas body _integer_sgd_kernel).
//
// Bound on an H100: bytes.  W and g read and W′ written, 12 bytes per
// weight: a VGG8B step's 15 tensors (9,149,824 weights, 109.8 MB) take
// ≈33 µs at 3.35 TB/s; the two divides per weight are multiply-highs.
//
// Design: a grid-stride loop over the flat tensor, 16-byte loads and
// stores (four weights a thread per step) when all three pointers allow
// it, the ragged tail one weight at a time.  The TPU kernel padded the
// tensor to 128-wide rows; nothing here needs padding.  γ_inv and η_inv
// are read from device memory (the optimiser state's 0-d tensors) and each
// thread builds its divisors once (SgdDivisors); the arithmetic is the
// integer_sgd function that the two grad_W_opt flushes call too.
#include <stdint.h>

#include "nitro_epilogue.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
integer_sgd_kernel(const int32_t* __restrict__ w, const int32_t* __restrict__ g,
                   int32_t* __restrict__ out, const int32_t* gamma_inv,
                   const int32_t* eta_inv, long long n, int vec) {
  const nitro::SgdDivisors sgd(gamma_inv, eta_inv);
  const long long stride = (long long)gridDim.x * THREADS;
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    const int4* w4 = reinterpret_cast<const int4*>(w);
    const int4* g4 = reinterpret_cast<const int4*>(g);
    int4* o4 = reinterpret_cast<int4*>(out);
    for (long long k = i; k < n4; k += stride) {
      const int4 a = w4[k], b = g4[k];
      o4[k] = make_int4(nitro::integer_sgd(a.x, b.x, sgd),
                        nitro::integer_sgd(a.y, b.y, sgd),
                        nitro::integer_sgd(a.z, b.z, sgd),
                        nitro::integer_sgd(a.w, b.w, sgd));
    }
    done = n4 * 4;
  }
  for (long long k = done + i; k < n; k += stride)
    out[k] = nitro::integer_sgd(w[k], g[k], sgd);
}

}  // namespace

// w, g and out int32 contiguous, n elements; gamma_inv and eta_inv 0-d
// int32 on the device (γ_inv ≠ 0).  sms: the card's SM count (sizes the
// grid).  Launches on `stream`; returns cudaGetLastError().
extern "C" int integer_sgd_launch(const void* w, const void* g, void* out,
                                  const void* gamma_inv, const void* eta_inv,
                                  int n, int sms, void* stream) {
  const int vec = (((uintptr_t)w | (uintptr_t)g | (uintptr_t)out) & 15) == 0;
  const long long per_block = (long long)THREADS * (vec ? 4 : 1);
  long long blocks = ((long long)n + per_block - 1) / per_block;
  const long long most = 8LL * sms;  // a few waves; the loop strides the rest
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  integer_sgd_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)w, (const int32_t*)g, (int32_t*)out,
      (const int32_t*)gamma_inv, (const int32_t*)eta_inv, n, vec);
  return (int)cudaGetLastError();
}
