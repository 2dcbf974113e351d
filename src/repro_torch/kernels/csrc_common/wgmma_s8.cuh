// Route W of int_matmul: C = A·B mod 2^32 for int8 A (M, K) and B (K, N)
// at scale on Hopper's int8 tensor cores through wgmma, fed by TMA.
// int_matmul.cu notes what bounds it and when the wrapper takes it.
//
// Operands.  8-bit wgmma reads both operands K-major only: A row-major
// (M, K), and B as Bᵀ, row-major (N, K) (the (K, N) view with strides
// (1, ld)).  TMA needs 16 | K, 16-byte-aligned bases and row strides that
// are multiples of 16 bytes; it zero-fills past M, N and K, so the ragged
// edges cost nothing but a masked store.
//
// Design (persistent, warp-specialised):
//   * one block an SM walks the output tiles (BM × BN) in grouped order,
//     GROUP row tiles at a time, so that a group's A rows and the B
//     columns they meet stay in L2;
//   * a ring of STAGES stages in shared memory, each A's BM × BK and Bᵀ's
//     BN × BK bytes, BK = 128 bytes: one 128-byte swizzled row per matrix
//     row, as TMA's SWIZZLE_128B writes it and wgmma's descriptor reads it
//     (leading offset unused for K-major, stride 1,024 bytes = 8 rows);
//   * the producer warpgroup gives its registers up (setmaxnreg 40) and
//     one thread of it keeps the ring full: it waits for a stage's empty
//     barrier, arms its full barrier with the stage's bytes and issues the
//     two cp.async.bulk.tensor copies;
//   * two consumer warpgroups (setmaxnreg 232) each own 64 rows of the
//     tile: per stage four wgmma.mma_async m64nBNk32 s32.s8.s8 from the
//     swizzled stage, one commit group a stage, one group left in flight
//     (the stage before is released once its group completes);
//   * depth: no s32 accumulator sums more than 16,384 columns (|Σ| ≤
//     2^14·2^14 = 2^28).  FOLD variants (the wrapper picks one past
//     16,384) add the accumulator into an unsigned running total every
//     CHUNK stages (tot += (unsigned)acc) and restart it (scale-d 0), so
//     the sum wraps mod 2^32 as XLA's int32 dot does without leaning on the
//     tensor cores' own overflow;
//   * the epilogue stores the int32 sums from registers, two columns a
//     store, masked at the ragged edge; the producer meanwhile fills the
//     ring for the next tile.
// Phase parity: every role counts its own stage index and parity across
// all its tiles; the producer's first pass over the ring waits on the
// empty barriers' phase before the first (parity 1), which has completed.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_runtime.h>
#include <stdint.h>

namespace nitro {
namespace wg {

constexpr int BM = 128;                // tile rows: two consumer warpgroups of 64
constexpr int BK = 128;                // contraction bytes a stage: one swizzle row
constexpr int CHUNK = 16384 / BK;      // stages between folds: 16,384 columns
constexpr int THREADS = 384;           // consumer warpgroups 0 and 1, producer 2
constexpr int GROUP = 8;               // row tiles walked together (L2 reuse)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// Tile width BN: 256 (one m64n256k32 a k-step, 128 accumulators a
// thread) without folds; 128 with them, whose running total needs as many
// registers again.
template <int BN>
struct Cfg {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = BN == 256 ? 4 : 6;  // 192 KB of ring either way
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + 1,024-byte alignment slack
  static constexpr int ACC = BN / 2;                  // accumulators a consumer thread
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b)) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* b, unsigned parity) {
  const uint32_t addr = smem_u32(b);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-D TMA box (c0 along K, c1 along rows) into shared memory,
// completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma descriptor of a K-major SWIZZLE_128B tile whose 8-row groups lie
// 1,024 bytes apart; `saddr` is the row-0 address of the 32 K-bytes read.
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void mma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of the accumulators across the
// asynchronous MMAs.
template <int R>
__device__ __forceinline__ void pin(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma m64n128k32 s8·s8 → s32: d += a·b (d = a·b when scale_d is 0)
__device__ __forceinline__ void mma_n128(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// wgmma m64n256k32 s8·s8 → s32: d += a·b (d = a·b when scale_d is 0)
__device__ __forceinline__ void mma_n256(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void mma(int (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 256)
    mma_n256(d, da, db, scale_d);
  else
    mma_n128(d, da, db, scale_d);
}

// Output tile t of m_tiles × n_tiles in grouped order: GROUP row tiles,
// all their column tiles, then the next GROUP.
__device__ __forceinline__ void tile_of(int t, int m_tiles, int n_tiles, int& tm, int& tn) {
  const int per = GROUP * n_tiles, first = t / per * GROUP;
  const int rows = min(m_tiles - first, GROUP), r = t % per;
  tm = first + r % rows;
  tn = r / rows;
}

template <int BN, bool FOLD>
__global__ void __launch_bounds__(THREADS, 1)
gemm_s8_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
               int32_t* __restrict__ out, int M, int N, int K) {
  using C = Cfg<BN>;
  constexpr int S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles, nk = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(&full[s], 1);      // the producer's arrive, plus the stage's bytes
      bar_init(&empty[s], 8);     // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      int s = 0;
      unsigned ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int tm, tn;
        tile_of(t, m_tiles, n_tiles, tm, tn);
        for (int kt = 0; kt < nk; ++kt) {
          bar_wait(&empty[s], ph ^ 1);
          uint8_t* st = ring + s * C::STAGE;
          bar_expect_tx(&full[s], C::STAGE);
          tma_load(st, &tma, &full[s], kt * BK, tm * BM);
          tma_load(st + C::A_BYTES, &tmb, &full[s], kt * BK, tn * BN);
          if (++s == S) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups: 64 rows of the tile each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    int acc[C::ACC];
    unsigned tot[FOLD ? C::ACC : 1];
    int s = 0;
    unsigned ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int tm, tn;
      tile_of(t, m_tiles, n_tiles, tm, tn);
      if constexpr (FOLD) {
#pragma unroll
        for (int i = 0; i < C::ACC; ++i) tot[i] = 0u;
      }
      int prev = -1;  // the stage whose MMAs may still be in flight
      for (int kt = 0; kt < nk; ++kt) {
        const bool fresh = kt % CHUNK == 0;  // the first stage of a 16,384-column chunk
        if constexpr (FOLD) {
          if (fresh && kt > 0) {  // fold the chunk's s32 sums into the total
            mma_wait<0>();
            pin(acc);
            if (lane == 0) bar_arrive(&empty[prev]);
            prev = -1;
#pragma unroll
            for (int i = 0; i < C::ACC; ++i) tot[i] += (unsigned)acc[i];
          }
        }
        bar_wait(&full[s], ph);
        const uint32_t a0 = smem_u32(ring + s * C::STAGE) + wg * 64 * BK;
        const uint32_t b0 = smem_u32(ring + s * C::STAGE + C::A_BYTES);
        mma_fence();
        pin(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          mma<BN>(acc, desc(a0 + 32 * kk), desc(b0 + 32 * kk), !(fresh && kk == 0));
        mma_commit();
        pin(acc);
        mma_wait<1>();
        if (prev >= 0 && lane == 0) bar_arrive(&empty[prev]);
        prev = s;
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
      mma_wait<0>();
      pin(acc);
      if (lane == 0) bar_arrive(&empty[prev]);
      // epilogue: d[4j + e] is row 16·warp + lane/4 (+8 for e ≥ 2), column
      // 8j + 2·(lane % 4) + e % 2 of this warpgroup's 64 × BN
      const int r0 = tm * BM + wg * 64 + warp * 16 + lane / 4;
      const int c0 = tn * BN + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = c0 + 8 * j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          unsigned v0 = (unsigned)acc[4 * j + 2 * h], v1 = (unsigned)acc[4 * j + 2 * h + 1];
          if constexpr (FOLD) {
            v0 += tot[4 * j + 2 * h];
            v1 += tot[4 * j + 2 * h + 1];
          }
          if (row >= M || col >= N) continue;
          int32_t* p = out + (size_t)row * N + col;
          if ((N & 1) == 0)
            *reinterpret_cast<int2*>(p) = make_int2((int)v0, (int)v1);
          else {
            p[0] = (int)v0;
            if (col + 1 < N) p[1] = (int)v1;
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query: the
// libraries link no libcuda.  Null where it is missing.
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// The TMA map of a row-major int8 (rows, K) matrix with row stride `ld`
// bytes, read in boxes of BK × box_rows, 128-byte swizzled, zero past the
// edges.  Returns a cudaError_t.
inline int make_map(CUtensorMap* map, const void* base, long long rows, long long K,
                    long long ld, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN, bool FOLD>
inline int launch_tiles(const void* a, long long lda, const void* bt, long long ldb, int32_t* c,
                        int M, int N, int K, int sms, cudaStream_t st) {
  CUtensorMap ta, tb;
  int err = make_map(&ta, a, M, K, lda, BM);
  if (err == 0) err = make_map(&tb, bt, N, K, ldb, BN);
  if (err != 0) return err;
  auto kern = gemm_s8_kernel<BN, FOLD>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN>::SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  kern<<<grid, THREADS, Cfg<BN>::SMEM, st>>>(ta, tb, c, M, N, K);
  return (int)cudaGetLastError();
}

// C (M, N) int32 row-major = A (M, K) · Bᵀ(N, K)ᵀ mod 2^32; a and bt int8,
// row strides lda / ldb bytes; 16 | K, lda, ldb and both bases.  Past
// 16,384 columns the FOLD variant at BN = 128.
inline int launch(const void* a, long long lda, const void* bt, long long ldb, int32_t* c, int M,
                  int N, int K, int sms, cudaStream_t st) {
  if (K > CHUNK * BK) return launch_tiles<128, true>(a, lda, bt, ldb, c, M, N, K, sms, st);
  return launch_tiles<256, false>(a, lda, bt, ldb, c, M, N, K, sms, st);
}

}  // namespace wg
}  // namespace nitro
