// NITRO epilogue shared by the hand-written Hopper kernels: NITRO Scaling
// (⌊z / (residual · 2^shift)⌋) and NITRO-ReLU, with floor semantics.
//
// CUDA's `/` and `%` truncate toward zero on signed integers; the paper's
// ⌊·⌋ rounds toward −∞.  Every divide here therefore goes through
// floor_div_pos, which corrects the truncated quotient when the remainder
// is nonzero and the dividend negative.  The power-of-two part of SF is an
// arithmetic right shift, which already floors.  ⌊⌊z/a⌋/b⌋ = ⌊z/(ab)⌋ for
// positive a, b, so the two steps compose exactly.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nitro {

// ⌊a / b⌋ for b > 0.
__device__ __forceinline__ int floor_div_pos(int a, int b) {
  int q = a / b;
  int r = a - q * b;
  return (r != 0 && a < 0) ? q - 1 : q;
}

struct Epilogue {
  int shift;      // SF = residual << shift
  int residual;   // odd part of SF (≥ 1)
  int alpha_inv;  // NITRO-ReLU leak divisor (≥ 1)
  int mu;         // μ_int8, subtracted after the ReLU (0 without ReLU)
  int apply_relu;

  __device__ __forceinline__ int operator()(int z) const {
    z >>= shift;  // arithmetic shift on signed int: floor by 2^shift
    if (residual != 1) z = floor_div_pos(z, residual);
    if (apply_relu) {
      z = (z < 0) ? floor_div_pos(max(z, -127), alpha_inv) : min(z, 127);
      z -= mu;
    }
    return z;
  }
};

// Narrow to the output dtype.  int8 stores keep the low byte (the JAX
// package's astype wraps the same way); in range for every α_inv ≥ 2.
__device__ __forceinline__ void store(int8_t* p, int v) { *p = (int8_t)v; }
__device__ __forceinline__ void store(int32_t* p, int v) { *p = v; }

// Wrapping int32 multiply-accumulate: unsigned arithmetic is defined to
// wrap mod 2^32, so the sum matches XLA's int32 dot bit for bit.
__device__ __forceinline__ unsigned mac(unsigned acc, int a, int b) {
  return acc + (unsigned)a * (unsigned)b;
}

}  // namespace nitro

extern "C" const char* nitro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
