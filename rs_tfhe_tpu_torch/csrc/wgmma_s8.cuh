// The 8-bit integer matrix product on Hopper's asynchronous tensor-core path,
// as __device__ and host code shared by the kernels that multiply 8-bit
// matrices. One block computes one 128 x 128 tile of
//
//   out[r, c] = sum_k a[r, k] * bt[c, k]      (s32, wrapping mod 2^32)
//
// from a [m, k] and bt [n, k], both K-major (k innermost), the only layout an
// 8-bit wgmma takes for either operand.
//
// Bound: 2 m k n operations against m k + k n + 4 m n bytes, so at any shape
// worth a tensor core the operations: 989.5 T s8 multiply-adds/s on an H100
// SXM, about 3,790 a clock and SM at 1980 MHz. The earlier mma.sync tile
// (64 x 64, operands staged through registers) reached a fifth of that; only
// wgmma, fed from shared memory by the copy engine, can reach the rest. So:
//
//   - Copies. TMA (cp.async.bulk.tensor.2d) brings a stage of 128 rows x 128
//     k-bytes of a and of bt into shared memory with the 128-byte swizzle the
//     wgmma descriptors name (it also keeps the tensor cores' 16-byte reads
//     free of bank conflicts), into a ring of kStages stages, each with a full
//     and an empty mbarrier. The copy zero-fills rows and k past the matrix,
//     so ragged m, n and k (k below one stage too) need no code: only the
//     stores are masked. The tensor maps are encoded on the host
//     (encode_kmajor) through the driver's entry point, so the library links
//     against the CUDA runtime alone.
//   - Roles. A block is one producer warpgroup, whose first thread issues every
//     copy, and kConsumers = 2 consumer warpgroups, each owning 64 rows of the
//     tile: per stage each issues four wgmma.mma_async m64n128k32 (32 k-bytes
//     each) on descriptors into the stage, commits them as a group, waits for
//     its previous group and releases that group's stage, so one group is
//     always in flight. setmaxnreg moves registers from the producer (40 a
//     thread) to the consumers (232: the 64 accumulator words and addressing).
//   - Shared memory: kStages x 32 KB, one block an SM; a kernel sets
//     cudaFuncAttributeMaxDynamicSharedMemorySize to kSmemBytes before any
//     launch or occupancy query.
//
// No .satfinite: the sums wrap mod 2^32, as the plain versions do. The operand
// types are template parameters, s8 or u8 each: s8 x s8 for the s8 dots,
// every pair of the four for the byte-limb products of the s16 and s32 dots
// (probes.cu), which also accumulate into a d they did not zero
// (mma_accumulate), shift it between limb weights (shift_acc) and add a
// partial into out by integer reductions (add_tile).

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_runtime.h>

namespace wgmma_s8 {

constexpr int kTileM = 128;  // output rows a block
constexpr int kTileN = 128;  // output columns a block
constexpr int kTileK = 128;  // k-bytes a stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kConsumers = 2;  // warpgroups of 64 output rows
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = 128 + kConsumerThreads;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kTileBytes = kTileM * kTileK;  // one operand's tile of a stage
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kAtom = 1024;  // a 128-byte swizzle atom: 8 rows, the alignment of every tile
// Dynamic shared memory a block: the ring, its barriers, and the slack that
// aligns the ring to an atom.
constexpr size_t kSmemBytes = kStages * kStageBytes + 2 * kStages * sizeof(uint64_t) + kAtom;
// Named barriers (0 is __syncthreads).
constexpr int kBarConsumers = 1;  // the consumer warpgroups
constexpr int kBarLoad = 2;       // the consumers and the producer warp

static_assert(kTileM == kTileN, "one tensor-map box serves both operands");
static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumerThreads <= (65536 / kThreads) / 8 * 8 * kThreads,
              "setmaxnreg can only move the registers the block was launched with");

// ---------------------------------------------------------------------------
// Barriers and copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// One arrival that also announces `bytes` of copies to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// A wait that outlasts this many cycles (seconds at the card's clock) traps:
// a broken ring fails its launch instead of hanging the card.
constexpr long long kWaitLimit = 1LL << 34;

// Wait until the phase of `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > kWaitLimit) __trap();
}

// Orders this thread's ordinary global stores before later TMA reads of that
// memory (and, in the reading thread, what it has observed of others').
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The box at (x = k offset, y = row) of `map` into shared memory at dst; its
// bytes count toward the transaction bar expects.
__device__ __forceinline__ void tma_load_2d(const CUtensorMap* map, uint64_t* bar, void* dst, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
      :
      : "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x), "r"(y)
      : "memory");
}

// Barrier steps for code between asynchronous wgmma groups, where a branch
// on the thread would make ptxas serialise the products (C7518): the wait
// loops inside one asm statement, and a step meant for one thread is
// predicated inside its asm.

// Wait until the phase of `parity` has completed.
__device__ __forceinline__ void mbar_wait_uniform(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One arrival on bar from each thread with `pred` set.
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(static_cast<int>(pred))
      : "memory");
}

// From the thread with `pred` set: one arrival on bar that announces `bytes`,
// and the copy of `bytes` contiguous bytes (a multiple of 16, both ends
// 16-byte aligned) from global memory at src into this block's shared memory
// at dst, which completes them.
__device__ __forceinline__ void bulk_load_if(void* dst, const void* src, uint32_t bytes, uint64_t* bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %4, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      "}\n"
      :
      : "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar)),
        "r"(static_cast<int>(pred))
      : "memory");
}

// ---------------------------------------------------------------------------
// The product
// ---------------------------------------------------------------------------

// Descriptor of a K-major operand in 128-byte swizzle at p (an atom
// boundary plus a multiple of 32 bytes along k): 8-row atoms 1024 bytes
// apart (stride byte offset), leading byte offset unused (1), layout 1.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(kAtom >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Tells the compiler the accumulator may change here (the asynchronous
// products write it between their issue and the wait).
template <int R>
__device__ __forceinline__ void fence_acc(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define WGMMA_S8_D_REGS                                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                                                             \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                                       \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                                                     \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                                                     \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                                                     \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                                                     \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                                                     \
  "%56, %57, %58, %59, %60, %61, %62, %63"

#define WGMMA_S8_D_OPERANDS(d)                                                                       \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),    \
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),       \
      "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),     \
      "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),     \
      "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),     \
      "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),     \
      "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),     \
      "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),     \
      "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])

// One wgmma.mma_async m64n128k32 with s32 sums of `types` operands (the
// PTX type pair, e.g. "u8.s8": A unsigned, B signed), accumulating into d.
#define WGMMA_8BIT(types)                                                                          \
  asm volatile(                                                                                    \
      "{\n"                                                                                        \
      ".reg .pred p;\n"                                                                            \
      "setp.ne.b32 p, %66, 0;\n"                                                                   \
      "wgmma.mma_async.sync.aligned.m64n128k32.s32." types " {" WGMMA_S8_D_REGS "}, %64, %65, p;\n" \
      "}\n"                                                                                        \
      : WGMMA_S8_D_OPERANDS(d)                                                                     \
      : "l"(desc_a), "l"(desc_b), "r"(1))

template <typename T>
constexpr bool kIsByte = std::is_same_v<T, int8_t> || std::is_same_v<T, uint8_t>;

// d[64 x 128] += A[64 x 32] . B[128 x 32]^T from shared memory, s32 sums of
// TA x TB products, each of TA and TB int8_t or uint8_t. d is the
// warpgroup's accumulator fragment: thread t holds rows 16 (t / 32) +
// (t % 32) / 4 (+ 8) and columns 8j + 2 (t % 4) (+ 1) in d[4j ..  4j + 3].
template <typename TA, typename TB>
__device__ __forceinline__ void wgmma_m64n128k32(uint32_t (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  static_assert(kIsByte<TA> && kIsByte<TB>, "operands: s8 or u8 each");
  constexpr bool sa = std::is_same_v<TA, int8_t>, sb = std::is_same_v<TB, int8_t>;
  if constexpr (sa && sb) {
    WGMMA_8BIT("s8.s8");
  } else if constexpr (sa) {
    WGMMA_8BIT("s8.u8");
  } else if constexpr (sb) {
    WGMMA_8BIT("u8.s8");
  } else {
    WGMMA_8BIT("u8.u8");
  }
}

#undef WGMMA_8BIT

// ---------------------------------------------------------------------------
// The ring and the two roles
// ---------------------------------------------------------------------------

struct Ring {
  uint8_t* tiles;   // kStages x (a tile [kTileM][kTileK], bt tile [kTileN][kTileK]), swizzled
  uint64_t* full;   // a stage's copies have landed
  uint64_t* empty;  // every consumer is done with a stage
  __device__ uint8_t* a(int s) const { return tiles + s * kStageBytes; }
  __device__ uint8_t* b(int s) const { return tiles + s * kStageBytes + kTileBytes; }
};

// The ring in the block's dynamic shared memory (kSmemBytes at smem); thread
// 0 initialises its barriers. The block syncs before any other use.
__device__ __forceinline__ Ring make_ring(unsigned char* smem) {
  Ring r;
  r.tiles = smem + ((kAtom - (smem_addr(smem) & (kAtom - 1))) & (kAtom - 1));
  r.full = reinterpret_cast<uint64_t*>(r.tiles + kStages * kStageBytes);
  r.empty = r.full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the copy engine sees them too
  }
  return r;
}

// Where a role is in the ring; producer and consumers step through the same
// sequence of stages.
struct Pipe {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void next() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

template <int R>
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// Producer, one thread: the copies of the tile at (row0, col0), k-blocks
// from k0 up to k1 (bytes; the last block may pass k1, where the copy
// zero-fills past the matrix).
__device__ __forceinline__ void load_span(const CUtensorMap* map_a, const CUtensorMap* map_bt, const Ring& ring,
                                          Pipe& p, int row0, int col0, int k0, int k1) {
  for (int k = k0; k < k1; k += kTileK) {
    mbar_wait(&ring.empty[p.stage], p.phase ^ 1);  // a fresh barrier's preceding phase counts as done
    mbar_expect_tx(&ring.full[p.stage], kStageBytes);
    tma_load_2d(map_a, &ring.full[p.stage], ring.a(p.stage), k, row0);
    tma_load_2d(map_bt, &ring.full[p.stage], ring.b(p.stage), k, col0);
    p.next();
  }
}

// Consumer warpgroup `wg` (of kConsumers): adds its 64 rows of the product
// of the k-blocks load_span brought for `span` k-bytes into d, and waits for
// its products before it returns (d is then plain registers again). Called
// by all 128 threads together.
template <typename TA, typename TB>
__device__ __forceinline__ void mma_accumulate(const Ring& ring, Pipe& p, int span, int wg, uint32_t (&d)[64]) {
  const bool signals = threadIdx.x % 128 == 0;
  int held = -1;  // the stage the group in flight reads
  for (int k0 = 0; k0 < span; k0 += kTileK) {
    mbar_wait(&ring.full[p.stage], p.phase);
    const uint8_t* a = ring.a(p.stage) + wg * 64 * kTileK;
    const uint8_t* b = ring.b(p.stage);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 32) wgmma_m64n128k32<TA, TB>(d, kmajor_desc(a + kk), kmajor_desc(b + kk));
    wgmma_commit();
    wgmma_wait<1>();  // the previous group is done: its stage can be refilled
    if (held >= 0 && signals) mbar_arrive(&ring.empty[held]);
    held = p.stage;
    p.next();
  }
  wgmma_wait<0>();
  fence_acc(d);
  if (held >= 0 && signals) mbar_arrive(&ring.empty[held]);
}

// The same into a zeroed d: its 64 rows of one tile.
template <typename TA, typename TB>
__device__ __forceinline__ void mma_tile(const Ring& ring, Pipe& p, int k, int wg, uint32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0u;
  fence_acc(d);
  mma_accumulate<TA, TB>(ring, p, k, wg, d);
}

// d <<= bits, word by word (mod 2^32), between two fences: no product is in
// flight (mma_accumulate has waited), and the next one issues after.
__device__ __forceinline__ void shift_acc(uint32_t (&d)[64], int bits) {
  fence_acc(d);
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] <<= bits;
  fence_acc(d);
}

// Stores consumer warpgroup wg's rows of the tile at (row0, col0) of the
// int32 [m, n] out; rows and columns past m and n are dropped.
__device__ __forceinline__ void store_tile(const uint32_t (&d)[64], int32_t* out, int m, int n, int row0, int col0,
                                           int wg) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
  const bool pairs = n % 2 == 0;  // then two neighbouring words are 8-byte aligned
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wg * 64 + 16 * w + l / 4 + 8 * h;
      const int c = col0 + 8 * j + 2 * (l % 4);
      if (r >= m || c >= n) continue;
      int32_t* dst = out + static_cast<size_t>(r) * n + c;
      const int32_t v0 = static_cast<int32_t>(d[4 * j + 2 * h]), v1 = static_cast<int32_t>(d[4 * j + 2 * h + 1]);
      if (pairs) {
        *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
      } else {
        dst[0] = v0;
        if (c + 1 < n) dst[1] = v1;
      }
    }
}

// Adds consumer warpgroup wg's rows of the tile at (row0, col0) into the
// int32 [m, n] out with integer reductions (red.global.add, mod 2^32: the
// sum is the same in any order); rows and columns past m and n are dropped.
__device__ __forceinline__ void add_tile(const uint32_t (&d)[64], int32_t* out, int m, int n, int row0, int col0,
                                         int wg) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
  unsigned* o = reinterpret_cast<unsigned*>(out);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wg * 64 + 16 * w + l / 4 + 8 * h;
      const int c = col0 + 8 * j + 2 * (l % 4);
      if (r >= m || c >= n) continue;
      unsigned* dst = o + static_cast<size_t>(r) * n + c;
      atomicAdd(dst, d[4 * j + 2 * h]);
      if (c + 1 < n) atomicAdd(dst + 1, d[4 * j + 2 * h + 1]);
    }
}

// ---------------------------------------------------------------------------
// Host: the tensor maps
// ---------------------------------------------------------------------------

// The tensor map of a K-major 8-bit matrix [rows, k] at base, for the tile's
// copies: boxes of kTileK bytes x kTileM rows, 128-byte swizzle, zero fill
// past the matrix. TMA takes a 16-byte aligned base and rows of a multiple of
// 16 bytes. Returns a CUDA error code.
inline cudaError_t encode_kmajor(CUtensorMap* map, const void* base, int rows, int k) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                              CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<Encode>(nullptr);
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (rows < 1 || k < 16 || k % 16 || reinterpret_cast<uintptr_t>(base) % 16) return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {kTileK, kTileM};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
                            steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wgmma_s8
