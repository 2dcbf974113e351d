// Fused IntegerSGD update for Hopper (paper Algorithm 1) over a list of
// int32 tensors in one launch: for each, W′ = W − (⌊g/γ_inv⌋ + ⌊W/η_inv⌋),
// no decay for η_inv = 0, int32 wrapping mod 2^32, floor division.
//
// Replaces: src/repro/kernels/integer_sgd/integer_sgd.py::integer_sgd_update
//           (Pallas body _integer_sgd_kernel), once per tensor there.
//
// Bound on an H100: bytes.  W and g read and W′ written, 12 bytes per
// weight; the two divides per weight are SgdMagic's 32-bit multiply-highs,
// a few integer instructions against 12 bytes.
//   VGG8B's fused apply: 9,079,424 weights in 15 tensors, 108.95 MB,
//   32.5 µs at 3.35 TB/s.
//   mlp4's: 27,336,000 weights in 7 tensors, 328.0 MB, 97.9 µs.
//
// Design:
//  * One launch per table of up to TABLE_TENSORS tensors, passed by value
//    as a __grid_constant__ kernel parameter (2,632 bytes, under the 4 KB
//    limit): nothing is copied to the device and nothing synchronises.  An
//    entry holds W, g and W′, the element count, the slot of the tensor's
//    optimiser state and the first block it owns; the γ_inv / η_inv device
//    pointers of up to TABLE_STATES states go beside the entries.  VGG8B's
//    eight smallest tensors (2.2% of the bytes) cost a few blocks of the
//    one launch, not eight launches of their own.
//  * A block owns CHUNK = 4,096 weights of one tensor and finds its entry
//    by a binary search over the first blocks.
//  * Loads first: each thread issues UNROLL = 4 16-byte loads of W and 4
//    of g (128 bytes in flight a thread, 32 KB a block), then thread 0
//    builds the state's SgdMagic in shared memory while they are in
//    flight (γ_inv and η_inv are read on the device, never on the host),
//    the block syncs, and every thread takes the divisors into registers.
//    At 3.35 TB/s and about 0.7 µs of load latency the card needs about
//    2.3 MB in flight, 18 KB an SM: one resident block an SM already holds
//    more, so the last, partial wave of the grid still streams at the
//    memory rate, and a one-wave grid would too.
//  * 16-byte loads and stores where the tensor's three pointers are all
//    16-byte aligned; a misaligned tensor (a view such as base[1:]) takes
//    the 4-byte path, and a tensor's ragged tail (fewer than four weights)
//    one weight a thread, in the same launch.  W and g are read once and
//    W′ written once: streaming loads and stores (evict-first).
//  * Offsets are 64-bit; each tensor holds fewer than 2^31 weights, and the
//    wrapper gives empty tensors no entry.
#include <stdint.h>

#include "nitro_epilogue.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                      // 16-byte loads of W (and of g) a thread
constexpr int CHUNK = THREADS * UNROLL * 4;    // weights a block owns
constexpr int TABLE_TENSORS = 64;
constexpr int TABLE_STATES = 4;

// One tensor of a launch (integer_sgd.py's _Tensor).
struct SgdTensor {
  const int32_t* w;
  const int32_t* g;
  int32_t* out;
  long long n;  // weights, 0 < n < 2^31
  int block0;   // the first block of the grid that it owns
  int state;    // slot of its optimiser state in SgdTable::gamma_inv / eta_inv
};

// One launch (integer_sgd.py's _Table): the tensors in block order.
struct SgdTable {
  SgdTensor t[TABLE_TENSORS];
  const int32_t* gamma_inv[TABLE_STATES];  // 0-d int32 on the device, ≠ 0
  const int32_t* eta_inv[TABLE_STATES];
  int count;   // entries used
  int blocks;  // the grid: the last entry's block0 plus its blocks
};

static_assert(sizeof(SgdTensor) == 40, "integer_sgd.py's _Tensor pins this layout");
static_assert(sizeof(SgdTable) == 2632, "integer_sgd.py's _Table pins this layout");
static_assert(sizeof(SgdTable) <= 4096, "the table must fit the classic parameter limit");

// The block's divisors: thread 0 builds them (a 64-bit division each) into
// shared memory, and every thread takes a copy once all have arrived.
__device__ __forceinline__ nitro::SgdMagic block_divisors(unsigned char* bytes,
                                                          const int32_t* gamma_inv,
                                                          const int32_t* eta_inv) {
  if (threadIdx.x == 0)
    *reinterpret_cast<nitro::SgdMagic*>(bytes) = nitro::SgdMagic(gamma_inv, eta_inv);
  __syncthreads();
  return *reinterpret_cast<const nitro::SgdMagic*>(bytes);
}

__device__ __forceinline__ int4 sgd4(int4 a, int4 b, const nitro::SgdMagic& s) {
  return make_int4(nitro::integer_sgd(a.x, b.x, s), nitro::integer_sgd(a.y, b.y, s),
                   nitro::integer_sgd(a.z, b.z, s), nitro::integer_sgd(a.w, b.w, s));
}

__global__ void __launch_bounds__(THREADS)
integer_sgd_many_kernel(const __grid_constant__ SgdTable tab) {
  __shared__ __align__(8) unsigned char sgd_bytes[sizeof(nitro::SgdMagic)];
  // the entry that owns this block: the last whose block0 ≤ blockIdx.x
  int lo = 0, hi = tab.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tab.t[mid].block0 <= (int)blockIdx.x) lo = mid;
    else hi = mid - 1;
  }
  const SgdTensor& e = tab.t[lo];
  const long long start = (long long)((int)blockIdx.x - e.block0) * CHUNK;
  const int len = (int)min((long long)CHUNK, e.n - start);
  const int32_t* w = e.w + start;
  const int32_t* g = e.g + start;
  int32_t* out = e.out + start;
  const int32_t* gamma_inv = tab.gamma_inv[e.state];
  const int32_t* eta_inv = tab.eta_inv[e.state];

  // start is a multiple of CHUNK: the chunk is aligned as the tensor is
  if ((((uintptr_t)w | (uintptr_t)g | (uintptr_t)out) & 15) == 0) {
    const int4* w4 = reinterpret_cast<const int4*>(w);
    const int4* g4 = reinterpret_cast<const int4*>(g);
    int4* o4 = reinterpret_cast<int4*>(out);
    const int q = len / 4;  // whole int4s
    int4 a[UNROLL], b[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int k = threadIdx.x + j * THREADS;
      if (k < q) {
        a[j] = __ldcs(w4 + k);
        b[j] = __ldcs(g4 + k);
      }
    }
    const int tail = 4 * q + threadIdx.x;  // the last len % 4 weights, one a thread
    int ta = 0, tb = 0;
    if (tail < len) {
      ta = __ldcs(w + tail);
      tb = __ldcs(g + tail);
    }
    const nitro::SgdMagic sgd = block_divisors(sgd_bytes, gamma_inv, eta_inv);
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int k = threadIdx.x + j * THREADS;
      if (k < q) __stcs(o4 + k, sgd4(a[j], b[j], sgd));
    }
    if (tail < len) __stcs(out + tail, nitro::integer_sgd(ta, tb, sgd));
  } else {
    constexpr int PER = CHUNK / THREADS;
    int a[PER], b[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int k = threadIdx.x + j * THREADS;
      if (k < len) {
        a[j] = __ldcs(w + k);
        b[j] = __ldcs(g + k);
      }
    }
    const nitro::SgdMagic sgd = block_divisors(sgd_bytes, gamma_inv, eta_inv);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int k = threadIdx.x + j * THREADS;
      if (k < len) __stcs(out + k, nitro::integer_sgd(a[j], b[j], sgd));
    }
  }
}

}  // namespace

// sizeof(SgdTable), for the wrapper to check its ctypes layout against.
extern "C" int integer_sgd_table_bytes() { return (int)sizeof(SgdTable); }

// `table` points at one SgdTable on the host (count ≥ 1, every entry's
// tensors int32, contiguous, on one device).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int integer_sgd_many_launch(const void* table, void* stream) {
  const SgdTable& tab = *static_cast<const SgdTable*>(table);
  if (tab.count < 1 || tab.count > TABLE_TENSORS || tab.blocks < 1)
    return (int)cudaErrorInvalidValue;
  integer_sgd_many_kernel<<<(unsigned)tab.blocks, THREADS, 0, (cudaStream_t)stream>>>(tab);
  return (int)cudaGetLastError();
}
