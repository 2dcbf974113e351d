// NITRO epilogue shared by the hand-written Hopper kernels: NITRO Scaling
// (⌊z / (residual · 2^shift)⌋) and NITRO-ReLU, with floor semantics, the
// NITRO-ReLU derivative the gradient kernels apply to δ on load, and the
// IntegerSGD update the three update kernels apply.
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

  // NITRO Scaling: z* = ⌊z / SF⌋.
  __device__ __forceinline__ int scale(int z) const {
    z >>= shift;  // arithmetic shift on signed int: floor by 2^shift
    return residual != 1 ? floor_div_pos(z, residual) : z;
  }

  // NITRO-ReLU of z*, minus μ.
  __device__ __forceinline__ int relu(int z) const {
    z = (z < 0) ? floor_div_pos(max(z, -127), alpha_inv) : min(z, 127);
    return z - mu;
  }

  __device__ __forceinline__ int operator()(int z) const {
    z = scale(z);
    return apply_relu ? relu(z) : z;
  }
};

// Division by a divisor fixed for a launch, without a divide instruction
// (Lemire, Kaser and Kurz, "Faster remainder by direct computation",
// 2019): n / d = hi64(n · m) for every 32-bit unsigned n, with
// m = ⌊(2^64 − 1) / d⌋ + 1.  d = 1 keeps m = 0 and returns n.
struct FastDiv {
  unsigned d;
  unsigned long long m;

  __host__ __device__ explicit FastDiv(unsigned d_ = 1)
      : d(d_), m(d_ > 1 ? ~0ull / d_ + 1 : 0ull) {}

  __device__ __forceinline__ unsigned div(unsigned n) const {
    return m ? (unsigned)__umul64hi(m, n) : n;
  }

  // ⌊a / d⌋, rounding toward −∞ (d < 2^31): −⌈|a| / d⌉ for a < 0.
  __device__ __forceinline__ int floor_div(int a) const {
    if (a >= 0) return (int)div((unsigned)a);
    return (int)(0u - div(0u - (unsigned)a + d - 1u));
  }
};

// NITRO Scaling and NITRO-ReLU as Epilogue computes them, with the two
// floor divisions by multiply-high (FastDiv) in place of a divide: an
// integer divide is tens of instructions, and the forward conv epilogues
// scale every one of a tile's 8,192 sums.  Built on the host.  The matmul
// kernels use it too (tools_torch/digit_gemm_variants.py times it there
// against Epilogue's divide instructions).
struct FastEpilogue {
  int shift;
  FastDiv residual, alpha_inv;
  int mu, apply_relu;

  FastEpilogue(int shift_, int residual_, int alpha_inv_, int mu_, int apply_relu_)
      : shift(shift_), residual((unsigned)residual_), alpha_inv((unsigned)alpha_inv_),
        mu(mu_), apply_relu(apply_relu_) {}

  __device__ __forceinline__ int scale(int z) const { return residual.floor_div(z >> shift); }
  __device__ __forceinline__ int relu(int z) const {
    z = z < 0 ? alpha_inv.floor_div(max(z, -127)) : min(z, 127);
    return z - mu;
  }
  __device__ __forceinline__ int operator()(int z) const {
    z = scale(z);
    return apply_relu ? relu(z) : z;
  }
};

// Unsigned n / d for a divisor d in [1, 2^31] and n ≤ 2^31, as a 32-bit
// multiply-high, an add and a shift (Granlund and Montgomery, "Division by
// invariant integers using multiplication", 1994): with l = ⌈log2 d⌉ and
// m = ⌊2^32·(2^l − d)/d⌋ + 1 < 2^32, n / d = (umulhi(m, n) + n) >> l, and
// the sum cannot overflow (umulhi(m, n) < n ≤ 2^31).  FastDiv takes every
// 32-bit n but multiplies in 64 bits, several instructions more (an
// IntegerSGD flush on it was ALU-bound).
struct Div31 {
  int l;
  unsigned m;

  __device__ explicit Div31(unsigned d) : l(0) {
    while ((1ull << l) < d) ++l;
    m = (unsigned)((((1ull << l) - d) << 32) / d + 1ull);
  }

  __device__ __forceinline__ unsigned operator()(unsigned n) const {
    return (__umulhi(m, n) + n) >> l;
  }

  // ⌊a / d⌋ for a in [−2^31, 2^31] (2^31 from a 64-bit −(−2^31)): with s
  // the sign mask of a, a ^ s = −a − 1 ≥ 0 for a < 0, and ⌊a/d⌋ = (n/d) ^ s.
  __device__ __forceinline__ int floor_div(long long a) const {
    const unsigned s = a < 0 ? ~0u : 0u;
    return (int)((*this)((unsigned)a ^ s) ^ s);
  }
};

// IntegerSGD's two divisors as Div31 multipliers, built on the device from
// the values read there: γ_inv and η_inv are the optimiser state's 0-d
// int32 tensors, which the lr schedule changes on the device, so no host
// value exists to build them from (the counterpart of the TPU kernels'
// SMEM scalars).  |γ_inv| ≤ 2^31 and max(η_inv, 1); each build is a 64-bit
// division, so a kernel builds them once a block, in shared memory.
struct SgdMagic {
  Div31 gamma;
  Div31 eta;
  bool gamma_neg;  // γ_inv < 0: ⌊g/γ_inv⌋ = ⌊−g/|γ_inv|⌋, −g in 64 bits
  bool decay;      // η_inv ≠ 0

  __device__ SgdMagic(const int32_t* gamma_inv, const int32_t* eta_inv)
      : gamma(__ldg(gamma_inv) < 0 ? 0u - (unsigned)__ldg(gamma_inv) : (unsigned)__ldg(gamma_inv)),
        eta((unsigned)max(__ldg(eta_inv), 1)),
        gamma_neg(__ldg(gamma_inv) < 0),
        decay(__ldg(eta_inv) != 0) {}
};

// IntegerSGD on one weight (paper Algorithm 1, the counterpart of
// integer_sgd_tile): W − (⌊g/γ_inv⌋ + ⌊W/η_inv⌋), no decay for η_inv = 0.
// Both divides floor (so −η_inv ≤ W < 0 decays by −1, 0 ≤ W < η_inv by 0);
// the sum and difference wrap mod 2³² in unsigned.  integer_sgd_update,
// stream_conv_grad_w_opt and nitro_matmul_grad_w_opt all call it.
__device__ __forceinline__ int integer_sgd(int w, int g, const SgdMagic& s) {
  const unsigned delta = (unsigned)s.gamma.floor_div(s.gamma_neg ? -(long long)g : g);
  const unsigned decay = s.decay ? (unsigned)s.eta.floor_div(w) : 0u;
  return (int)((unsigned)w - (delta + decay));
}

// NITRO-ReLU derivative + the scaling STE (the identity) on one δ value:
// 0 where z* saturates (z* < −127 or z* > 127), ⌊δ/α_inv⌋ where z* < 0,
// δ elsewhere.  relu_bwd(0, 0) = 0, so zero padding stays exact.
__device__ __forceinline__ int relu_bwd(int z, int g, const FastDiv& alpha_inv) {
  if (z < -127 || z > 127) return 0;
  return z < 0 ? alpha_inv.floor_div(g) : g;
}

// Narrow to the output dtype.  int8 stores keep the low byte (the JAX
// package's astype wraps the same way); in range for every α_inv ≥ 2.
__device__ __forceinline__ void store(int8_t* p, int v) { *p = (int8_t)v; }
__device__ __forceinline__ void store(int32_t* p, int v) { *p = v; }

}  // namespace nitro

extern "C" const char* nitro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
