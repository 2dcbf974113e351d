// Exact integer matmul for Hopper: C = A·B mod 2^32, A (M,K) and B (K,N)
// int8 or int32, C int32: numerics.int_matmul on the card.
//
// Replaces: src/repro/core/numerics.py::int_matmul (an XLA dot_general with
//           preferred_element_type=int32, not a Pallas kernel), entry
//           int_matmul_launch.  Until this kernel the port ran that product
//           on the card as three float64 GEMMs over 16-bit limbs
//           (numerics.int_matmul_ref), exact but not integer-only.
//
// Its callers: the learning and output layers' forward x·W (M = batch,
// N = 10 classes) and their weight gradient xᵀ·δ (M = fan-in, K = batch),
// where δ is wide and not proven to fit int8; the materialise convs; and
// the LM's NITRO int8 MLP products (int8 × int8, M = tokens).
//
// Bound on an H100: bytes at the learning layers (each weight byte takes
// part in M ≤ 64 multiply-adds); operations at the LM's int8 products
// (M = 2,048, K = 2,048, N = 8,192: 2·M·K·N = 68.7 G ops at the 1,979
// TOP/s int8 peak, 34.7 µs, against 88 MB of operands and int32 result,
// 26.3 µs at 3.35 TB/s).
//
// Design: split_matmul.cuh's GEMM, nitro_matmul.cu's without the NITRO
// scale and ReLU: exact signed base-256 digits on the int8 tensor cores
// (mma.sync m16n8k32 s8), only the digit pairs i + j ≤ 3 that the data
// needs, their counts read from the pre-passes' flags on the card (no host
// sync): int8 A and B take one product, a wide int32 δ up to ten; the sums
// accumulate in unsigned, so they wrap mod 2^32 as XLA's int32 dot does; a
// split-K plan with no split deeper than 16,384 (no s32 accumulator can
// overflow), the splits' sums added by the last block to arrive on its
// tile's counter (cuda_lib.split_workspace).  The epilogue stores the sum.
// Per call a memset (the digit flags) and at most three device launches:
// B's planes, A's planes (none when A is int8 with 16 | K and 16-byte
// aligned), the GEMM.  A simple kernel that is right; it keeps
// nitro_matmul's 64-row batch tile at M = 2,048 (PERF.md has its time).
#include "split_matmul.cuh"

namespace nitro {
namespace imm {

struct Out {
  int32_t* out;        // C (M, N)
  unsigned* parts;     // the splits' slots [tile][split][SLOT], any contents
  unsigned* arrivals;  // one counter per 64×64 tile, zero
};

// No epilogue: the sum mod 2^32, as int32.
__device__ __forceinline__ void emit(const Out& o, size_t idx, unsigned z) {
  o.out[idx] = (int32_t)z;
}

}  // namespace imm
}  // namespace nitro

using nitro::mm::Layout;

// Bytes of the scratch a launch with these shapes needs (as for
// nitro_matmul_scratch_bytes).
extern "C" long long int_matmul_scratch_bytes(int M, int N, int K, int a_int8, int b_int8,
                                              int a_direct, int sms) {
  return (long long)Layout(M, N, K, a_int8 != 0, b_int8 != 0, a_direct != 0, sms).bytes;
}

// a (M,K), b (K,N), c (M,N) int32, all row-major and contiguous; a and b
// int8 (a_int8 / b_int8) or int32.  scratch: int_matmul_scratch_bytes,
// 256-byte aligned, any contents; arrivals (one per 64×64 output tile)
// zero, left zero.  a_direct: a is int8 with 16 | K and 16-byte aligned,
// read by the GEMM as it is.  sms: the card's SM count.  Launches on
// `stream`; returns the CUDA error.
extern "C" int int_matmul_launch(const void* a, const void* b, void* c, void* scratch,
                                 void* arrivals, int M, int N, int K, int a_int8, int b_int8,
                                 int a_direct, int sms, void* stream) {
  const Layout L(M, N, K, a_int8 != 0, b_int8 != 0, a_direct != 0, sms);
  const nitro::imm::Out o{(int32_t*)c, nullptr, (unsigned*)arrivals};
  return nitro::mm::launch(L, a, a_int8 != 0, b, b_int8 != 0, scratch, o, sms,
                           (cudaStream_t)stream);
}
