// Fused NITRO matmul for Hopper: out = relu(⌊x @ w / SF⌋) − μ, or the
// scale alone (apply_relu = 0), into int8 or int32; and its training
// variant, which writes both a = relu(z*) − μ and z* = ⌊x @ w / SF⌋ from
// the same sum.
//
// Replaces: src/repro/kernels/nitro_matmul/nitro_matmul.py::nitro_matmul
//           (Pallas body _nitro_matmul_kernel), entry nitro_matmul_launch;
//           src/repro/kernels/nitro_matmul/nitro_matmul.py::nitro_matmul_fwd
//           (Pallas body _nitro_matmul_fwd_kernel), entry
//           nitro_matmul_fwd_launch.
//
// Bound on an H100: bytes.  M is the batch (32 served, 64 in training), so
// each weight byte takes part in only M multiply-adds: the served linear's
// 2 MiB int8 weight takes 0.6 µs at 3.35 TB/s against 0.07 µs of its 134 M
// ops at the 1,979 TOP/s int8 peak; VGG8B's training linear reads an
// 8 MiB int32 weight (2.6 µs), mlp4's layers 37 and 36 MB.
//
// Design: an exact split-K GEMM on the int8 tensor cores.
//   * Exact digits (digit_gemm.cuh): every int32 is four signed base-256
//     digits, Σ_k x·w ≡ Σ_{i+j ≤ 3} 2^(8(i+j)) · Σ_k x_i·w_j (mod 2^32),
//     and each inner sum is an s8×s8→s32 mma.sync m16n8k32.  Only the
//     digits the data needs run: the pre-passes record the most digits any
//     x and any w needs, and the GEMM branches (block-uniform) to one of
//     sixteen compiled (x digits, w digits) variants — no host sync, no
//     assumed range.  Both operands int8: one product, a kernel compiled
//     with that variant alone.  At the paper's init (w ±4) and with x a
//     NITRO-ReLU output, training runs one product too.
//   * The tile for a small batch: w's digit rows (the output columns n)
//     on the MMA's 16-row side, the batch m on its 8-wide side.  A block
//     owns 64 n × 64 m: 8 warps, 4 along n (16 rows each) by 2 along m (32
//     columns: four n8 tiles), so a batch of 32 leaves one warp row's MMAs
//     on zero columns but no weight byte read twice; a larger batch takes
//     more 64-row tiles.  Both operands are staged as K-contiguous rows
//     (ldmatrix fragments want them so): x is (M, K) already; w (K, N) is
//     transposed once per call into (N, Kp) digit planes by digit_gemm.cuh's
//     delta_digits_kernel, Kp = K padded to 64, which writes for each
//     64 × 64 tile of w only the planes that tile needs and records that
//     count in a map; the GEMM zero-fills a tile's other planes instead of
//     reading them, so the paper's ±4 weights cost one plane's bytes.
//   * Enough blocks: the contraction is split across blocks (plan_splits
//     with splits down to one 64-deep stage, planned for one block an SM),
//     so the served linear's 16 output tiles run as 64 blocks and mlp4's
//     47 as 94; more splits cost more in the flush than they gain (timed
//     on an H100, PERF.md).  No split is deeper than 16,384, so no s32
//     accumulator overflows (|Σ| ≤ 4·2^14·2^14 = 2^30 a set).
//   * The splits meet before the epilogue, which is not linear: each
//     writes its tile's sums to its own slot of the call's scratch and the
//     last to arrive on the tile's arrival counter (cuda_lib.split_workspace)
//     adds them mod 2^32 (digit_gemm.cuh's sum_splits), applies the NITRO
//     scale (+ ReLU, − μ) and writes out (and z*).  With one split the
//     registers hold the whole sum and the epilogue runs on them directly.
//   * The epilogue runs once per output after the reduction, with its two
//     floor divides as multiply-highs (FastEpilogue): in one call on an
//     H100 that read faster than divide instructions for both kernels
//     (tools_torch/digit_gemm_variants.py, PERF.md), though by little.
// Per call a memset (the digit flags) and at most three device launches:
// w's planes, x's planes (none when x is int8 with 16 | K and 16-byte
// aligned: the GEMM reads x itself), the GEMM.  Scratch: the flags, w's
// tile map and planes, x's planes, the splits' slots.
//
// The GEMM and its launch are csrc_common/split_matmul.cuh's (shared with
// int_matmul.cu); this file holds the NITRO epilogue and the entry points.
#include "split_matmul.cuh"

namespace nitro {
namespace mm {

struct Out {
  void* out;           // #1: int8 or int32 (out_int8); #2: a, int32
  int32_t* zout;       // #2: z*; #1: null
  unsigned* parts;     // the splits' slots [tile][split][SLOT], any contents
  unsigned* arrivals;  // one counter per 64×64 tile, zero
  FastEpilogue ep;
  int out_int8;
};

// The epilogue on one whole sum z: #2 writes z* and a = relu(z*) − μ, #1
// relu(z*) − μ (or z* without the ReLU) as int8 or int32.
__device__ __forceinline__ void emit(const Out& o, size_t idx, unsigned z) {
  const FastEpilogue& ep = o.ep;
  const int zs = ep.scale((int)z);
  if (o.zout) {
    o.zout[idx] = zs;
    static_cast<int32_t*>(o.out)[idx] = ep.relu(zs);
    return;
  }
  const int v = ep.apply_relu ? ep.relu(zs) : zs;
  if (o.out_int8)
    store(static_cast<int8_t*>(o.out) + idx, v);
  else
    store(static_cast<int32_t*>(o.out) + idx, v);
}

}  // namespace mm
}  // namespace nitro

using nitro::mm::Layout;

// Bytes of the scratch a launch with these shapes needs.  x_direct: x is
// int8 with 16 | K and 16-byte aligned, read by the GEMM as it is.  sms:
// the card's SM count.
extern "C" long long nitro_matmul_scratch_bytes(int M, int N, int K, int x_int8, int w_int8,
                                                int x_direct, int sms) {
  return (long long)Layout(M, N, K, x_int8 != 0, w_int8 != 0, x_direct != 0, sms).bytes;
}

// x (M,K), w (K,N), out (M,N), all row-major and contiguous; x and w
// int8 (x_int8 / w_int8) or int32; out int8 (out_int8) or int32.  scratch:
// nitro_matmul_scratch_bytes, 256-byte aligned, any contents; arrivals
// (one per 64×64 output tile) zero, left zero.  mu = 0 without the ReLU.
// sms: the card's SM count.  Launches on `stream`; returns the CUDA error.
extern "C" int nitro_matmul_launch(const void* x, const void* w, void* out, void* scratch,
                                   void* arrivals, int M, int N, int K, int shift,
                                   int residual, int alpha_inv, int mu, int apply_relu,
                                   int out_int8, int x_int8, int w_int8, int x_direct,
                                   int sms, void* stream) {
  const Layout L(M, N, K, x_int8 != 0, w_int8 != 0, x_direct != 0, sms);
  const nitro::mm::Out o{out, nullptr, nullptr, (unsigned*)arrivals,
                         nitro::FastEpilogue(shift, residual, alpha_inv, mu, apply_relu),
                         out_int8};
  return nitro::mm::launch(L, x, x_int8 != 0, w, w_int8 != 0, scratch, o, sms,
                           (cudaStream_t)stream);
}

// Training forward: x (M,K), w (K,N), int8 or int32 each; a and z_star
// (M,N) int32; all row-major and contiguous.  a = relu(z*) − μ,
// z* = ⌊x @ w / SF⌋.  scratch, arrivals and sms as for
// nitro_matmul_launch.  Launches on `stream`; returns the CUDA error.
extern "C" int nitro_matmul_fwd_launch(const void* x, const void* w, void* a, void* z_star,
                                       void* scratch, void* arrivals, int M, int N,
                                       int K, int shift, int residual, int alpha_inv, int mu,
                                       int x_int8, int w_int8, int x_direct, int sms,
                                       void* stream) {
  const Layout L(M, N, K, x_int8 != 0, w_int8 != 0, x_direct != 0, sms);
  const nitro::mm::Out o{a, (int32_t*)z_star, nullptr, (unsigned*)arrivals,
                         nitro::FastEpilogue(shift, residual, alpha_inv, mu, 1), 0};
  return nitro::mm::launch(L, x, x_int8 != 0, w, w_int8 != 0, scratch, o, sms,
                           (cudaStream_t)stream);
}
