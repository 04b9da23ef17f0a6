// Capability probes and primitive-rate kernels for Hopper.
//
// Replaces the seven TPU probe kernels of scripts/probe_mosaic.py (probe_dot,
// probe_roll, probe_bitcast_i32_to_i8, probe_unpack_s16,
// probe_dot_correct_s16) and scripts/bench_kernel_prims.py (bench_dot,
// bench_roll_add). Those measured what the TPU's compiler and matrix unit take
// before the rotation kernels were designed: which integer dots run on the
// matrix unit, whether narrow types can be rotated, and what a chain of
// dependent s8 dots and of roll+add steps sustains. The kernels here ask the
// same questions of an H100:
//
//   - integer dot -> int32 (probe_dot, probe_dot_correct_s16): on the tensor
//     cores through wgmma fed by TMA (wgmma_s8.cuh: 128 x 128 tiles, a
//     producer warpgroup and two consumer warpgroups, a 4-stage ring); s8
//     operands directly, s16 and s32 as products of their byte limbs (4 and
//     10 8-bit products, recombined by shifts mod 2^32: Hopper's tensor
//     cores have no 16- or 32-bit integer type);
//   - roll (probe_roll): a rotation of each row's bytes, for 1-, 2- and 4-byte
//     elements alike (the TPU could only rotate 32-bit lanes, which is why
//     its kernels pack limbs into words), and the bitcast
//     (probe_bitcast_i32_to_i8), whose lanes are the words' bytes in memory
//     order: both streaming copies of 16-byte vectors at any base and width;
//   - the two-s16 unpack (probe_unpack_s16): a streaming split of 16-byte
//     vectors into the low and the high halves;
//   - chained s8 dots (bench_dot): reps dependent products in one launch, each
//     lhs rebuilt from the previous accumulator, on the tensor cores (the same
//     wgmma tile, each resident block walking its tiles) or, the same chain,
//     on the CUDA cores, with the cycles spent inside the tile loop reported
//     beside the result;
//   - chained roll+add (bench_roll_add): x += roll(x, 1 + i), each row in one
//     warp's registers, the shifts unrolled into fixed shuffles (the widths of
//     32 E words, E = 1, 2, 4, ..., 64), else in shared memory.
//
// Bounds: the dots are bound by operations (2 M K N integer operations against
// M K + K N + 4 M N bytes, an s16 multiply-add 4 and an s32 one 10 s8
// products on the tensor cores), the roll+add chain by its 32-bit adds (one a
// word a step, at the SM's issue rate of 128 lanes a clock, which adds reach
// on two pipes; for narrow or few rows by a warp's issue rate and the latency
// of a step), the other element-wise kernels by bytes. The
// tensor-core dots are designed for that bound (wgmma_s8.cuh says how), and so
// are the roll, the bitcast and the unpack (16-byte vectors, several in flight
// a thread) and the roll+add (no memory traffic between its steps); the
// CUDA-core unit of the chained dot is not tuned: 64 x 64 tiles, two warps a
// block, operands staged through shared memory without a pipeline, occupancy
// hiding the latency.

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <utility>

#include <cuda_runtime.h>

#include "wgmma_s8.cuh"

namespace {

constexpr int kTile = 64;      // output tile edge of the CUDA-core dot
constexpr int kDotThreads = 64;
constexpr int kDotBlocksPerSm = 6;  // caps the CUDA-core dots at 170 registers: 12 warps an SM
constexpr int kChunkImad = 16; // k-values per staged chunk
constexpr int kAStride = kChunkImad + 1;  // padded: no bank conflicts on the row reads
constexpr int kMaxDepK = 4096; // k of the column-parity table of the chained dot
constexpr int kTensorK = 16;   // the tensor-core dot's k: a multiple of this (TMA's row stride)

// The dot on the CUDA cores, one 64 x 64 output tile, for 1-, 2- and 4-byte
// signed operands: sign-extended int32 multiply-adds that wrap mod 2^32. It
// stages a chunk of k through registers: the next chunk's global loads are
// issued before the current chunk's arithmetic and stored to shared memory
// after it, so their latency hides behind the multiply-adds. Thread (ty, tx) of
// the 8 x 8 thread grid owns rows 8ty..8ty+7 and the columns 4tx..4tx+3 and
// 32+4tx..32+4tx+3 (two 128-bit shared-memory reads without bank conflicts).
// b is [k, n] as given. smem: (64 * 17 + 16 * 64) words.
template <typename T>
__device__ __forceinline__ void imad_tile(const T* a, const T* b, int32_t* out, int m, int k, int n,
                                          int row0, int col0, uint32_t* smem) {
  uint32_t* as = smem;                     // [64 rows][17]
  uint32_t* bs = smem + kTile * kAStride;  // [16][64 cols]
  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;

  uint32_t acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0u;

  // a chunk: thread tid brings k-column tid % 16 of rows 4i + tid / 16 of A,
  // and column tid of k-row i of B
  T ra[kChunkImad], rb[kChunkImad];
  const int a_r = tid / kChunkImad, a_k = tid % kChunkImad;
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kChunkImad; ++i) {
      const int r = row0 + 4 * i + a_r;
      ra[i] = r < m && k0 + a_k < k ? a[static_cast<size_t>(r) * k + k0 + a_k] : T(0);
      rb[i] = k0 + i < k && col0 + tid < n ? b[static_cast<size_t>(k0 + i) * n + col0 + tid] : T(0);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < k; k0 += kChunkImad) {
#pragma unroll
    for (int i = 0; i < kChunkImad; ++i) {
      as[(4 * i + a_r) * kAStride + a_k] = static_cast<uint32_t>(static_cast<int32_t>(ra[i]));
      bs[i * kTile + tid] = static_cast<uint32_t>(static_cast<int32_t>(rb[i]));
    }
    __syncthreads();
    if (k0 + kChunkImad < k) fetch(k0 + kChunkImad);
#pragma unroll
    for (int kk = 0; kk < kChunkImad; ++kk) {
      uint32_t av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = as[(ty * 8 + i) * kAStride + kk];
      const uint4 b0 = *reinterpret_cast<const uint4*>(bs + kk * kTile + tx * 4);
      const uint4 b1 = *reinterpret_cast<const uint4*>(bs + kk * kTile + 32 + tx * 4);
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = row0 + ty * 8 + i, c = col0 + (j / 4) * 32 + tx * 4 + j % 4;
      if (r < m && c < n) out[static_cast<size_t>(r) * n + c] = static_cast<int32_t>(acc[i][j]);
    }
}

constexpr size_t kDotSmemWords = kTile * kAStride + kChunkImad * kTile;

// bt[c, r] = b[r, c] for int8 [k, n] -> [n, k].
__global__ void transpose_s8_kernel(const int8_t* __restrict__ b, int8_t* __restrict__ bt, int k,
                                    int n) {
  __shared__ int8_t tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y)
    if (r0 + i < k && c0 + threadIdx.x < n)
      tile[i][threadIdx.x] = b[static_cast<size_t>(r0 + i) * n + c0 + threadIdx.x];
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y)
    if (c0 + i < n && r0 + threadIdx.x < k)
      bt[static_cast<size_t>(c0 + i) * k + r0 + threadIdx.x] = tile[threadIdx.x][i];
}

// out[m, n] = a[m, k] . bt[n, k]^T on the tensor cores: one 128 x 128 tile a
// block (wgmma_s8.cuh), kSmemBytes of dynamic shared memory.
__global__ void __launch_bounds__(wgmma_s8::kThreads, 1)
dot_wgmma_s8_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_bt,
                    int32_t* out, int m, int k, int n) {
  using namespace wgmma_s8;
  extern __shared__ __align__(16) unsigned char dot_smem[];
  const Ring ring = make_ring(dot_smem);
  __syncthreads();
  const int row0 = blockIdx.y * kTileM, col0 = blockIdx.x * kTileN;
  Pipe pipe;
  if (threadIdx.x < 128) {
    producer_registers<kProducerRegs>();
    if (threadIdx.x == 0) load_span(&map_a, &map_bt, ring, pipe, row0, col0, 0, k);
  } else {
    consumer_registers<kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1;
    uint32_t d[64];
    mma_tile<int8_t, int8_t>(ring, pipe, k, wg, d);
    store_tile(d, out, m, n, row0, col0, wg);
  }
}

// ---------------------------------------------------------------------------
// P1 and P5 at s16 and s32: the dot on the tensor cores as byte-limb products
// ---------------------------------------------------------------------------
//
// An operand of L bytes (L = 2: s16, L = 4: s32) is the sum of its bytes
// times 2^(8 i): for s16 byte 1 as s8 (a >> 8) and byte 0 as u8, for s32 the
// four bytes of the two's-complement word as u8 (the word mod 2^32). So
//
//   a . b = sum over (i, j) of (a_i . b_j) 2^(8 (i + j))   mod 2^32,
//
// where only the pairs with i + j <= 3 survive mod 2^32: for s16 all four
// (hi.hi at 2^16, hi.lo and lo.hi at 2^8, lo.lo at 1), for s32 ten, all
// u8 x u8. Each a_i . b_j is an 8-bit product on the wgmma tile of
// wgmma_s8.cuh (the .s8/.u8 forms), summed in s32 without .satfinite, so
// every step wraps and the result is exact mod 2^32 at any K.
//
// Bound: 4 (s16) or 10 (s32) s8 products per multiply-add at 989.5 T/s,
// against 16.75 T/s int32 multiply-adds on the CUDA cores: the operations,
// at every shape worth a tensor core. The design:
//
//   - A split pass (split_limbs_kernel, one launch for both operands) writes
//     the limb planes K-major, the only layout an 8-bit wgmma takes: a
//     [L, M, Kp] and b transposed through shared memory to [L, N, Kp], Kp
//     being K rounded up to 16 (TMA's row stride) and zero-filled, so any K
//     is taken. Each operand's planes are one 2-D tensor map [L rows, Kp]: a
//     tile's rows may spill into the next plane only past m or n, where the
//     stores are masked, and k zero-fills at the matrix's end.
//   - Where the 128 x 128 output tiles fill the card, each block runs the
//     whole sum for its tile (dot_limbs_tile_kernel), Horner's way in one
//     64-word accumulator: the group of the largest weight first, then,
//     between groups, the accumulator shifted left by 8 in registers (after
//     the products have landed), the next group added into it. The producer
//     walks the same (pair, k-block) sequence.
//   - Where they are fewer than the SMs, each block takes one (tile, pair,
//     k-range) (dot_limbs_split_kernel), scales its partial by its weight in
//     registers and adds it into out (zeroed by the split pass) by
//     red.global.add: integer addition mod 2^32, so the result is bit-exact
//     whatever order the blocks land in.
//
// ptxas reports the in-tile kernel's wgmma as serialized (C7515: the Horner
// shift writes the accumulator between products); a variant that kept a
// second accumulator for the shifted sum, without that report, measured no
// consistent gain on the card, so the one accumulator stays.

constexpr int kLimbTop = 3;  // the largest weight i + j that survives mod 2^32

// Limb pair p of the product of L-byte operands, in the order every kernel
// walks them: weight w = i + j from kLimbTop down, i upwards within a weight.
struct LimbPair {
  int i, j, w;
};

__host__ __device__ constexpr LimbPair limb_pair(int L, int p) {
  for (int w = kLimbTop; w >= 0; --w)
    for (int i = w - L + 1 > 0 ? w - L + 1 : 0; i <= w && i < L; ++i)
      if (p-- == 0) return {i, w - i, w};
  return {-1, -1, -1};
}

__host__ __device__ constexpr int limb_pairs(int L) {
  int p = 0;
  while (limb_pair(L, p).w >= 0) ++p;
  return p;
}

static_assert(limb_pairs(2) == 4 && limb_pairs(4) == 10, "s16: 4 limb products, s32: 10");

constexpr int kSplitEdge = 64;  // elements a tile edge of the split pass
constexpr int kSplitThreads = 256;

// The limb planes of both operands in one launch: pa [L, m, kp] with
// pa[i, r, c] = byte i of a[r, c], and pb [L, n, kp] with pb[i, c, r] = byte
// i of b[r, c], both 0 for k <= c < kp. Blocks below tiles_a take 64 x 64
// tiles of a; the others 64 x 64 tiles of b, staged through shared memory
// (rows of b read, rows of the planes written, contiguously). A thread packs
// four neighbouring k of one row into one 32-bit store a plane. The grid
// also zeroes zero_words words at `zero` (the split instance's out, which
// its blocks add into: one launch fewer than a memset).
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
split_limbs_kernel(const T* __restrict__ a, const T* __restrict__ b, uint8_t* __restrict__ pa,
                   uint8_t* __restrict__ pb, int m, int k, int n, int kp, int tiles_a, int32_t* __restrict__ zero,
                   long long zero_words) {
  constexpr int L = sizeof(T), E = kSplitEdge, Q = E / 4;  // Q: 4-k groups a tile row
  using U = std::make_unsigned_t<T>;
  for (long long i = static_cast<long long>(blockIdx.x) * kSplitThreads + threadIdx.x; i < zero_words;
       i += static_cast<long long>(gridDim.x) * kSplitThreads)
    zero[i] = 0;
  __shared__ uint32_t stage[E][E + 1];  // padded by a word: column reads conflict at most 2-way
  const int tiles_k = (kp + E - 1) / E;
  const auto put = [](uint8_t* planes, size_t plane, size_t at, const uint32_t (&v)[4]) {
#pragma unroll
    for (int i = 0; i < L; ++i) {
      uint32_t word = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) word |= ((v[j] >> (8 * i)) & 0xFFu) << (8 * j);
      *reinterpret_cast<uint32_t*>(planes + i * plane + at) = word;
    }
  };
  if (static_cast<int>(blockIdx.x) < tiles_a) {
    const int r0 = blockIdx.x / tiles_k * E, c0 = blockIdx.x % tiles_k * E;
    for (int g = threadIdx.x; g < E * Q; g += kSplitThreads) {
      const int r = r0 + g / Q, c = c0 + 4 * (g % Q);
      if (r >= m || c >= kp) continue;
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = c + j < k ? static_cast<U>(a[static_cast<size_t>(r) * k + c + j]) : 0u;
      put(pa, static_cast<size_t>(m) * kp, static_cast<size_t>(r) * kp + c, v);
    }
    return;
  }
  const int tile = blockIdx.x - tiles_a, tiles_n = (n + E - 1) / E;
  const int r0 = tile / tiles_n * E, c0 = tile % tiles_n * E;  // r: k of b, c: its column
  for (int e = threadIdx.x; e < E * E; e += kSplitThreads) {
    const int r = e / E, c = e % E;
    stage[r][c] = r0 + r < k && c0 + c < n ? static_cast<U>(b[static_cast<size_t>(r0 + r) * n + c0 + c]) : 0u;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < E * Q; g += kSplitThreads) {
    const int c = g / Q, r = 4 * (g % Q);
    if (c0 + c >= n || r0 + r >= kp) continue;
    const uint32_t v[4] = {stage[r][c], stage[r + 1][c], stage[r + 2][c], stage[r + 3][c]};
    put(pb, static_cast<size_t>(n) * kp, static_cast<size_t>(c0 + c) * kp + r0 + r, v);
  }
}

// Consumer: adds the product of limb pair q's k-blocks into d (the s16 high
// limb is plane 1, signed; every other plane is unsigned).
template <int L>
__device__ __forceinline__ void mma_pair(const wgmma_s8::Ring& ring, wgmma_s8::Pipe& p, int span, int wg,
                                         uint32_t (&d)[64], LimbPair q) {
  using wgmma_s8::mma_accumulate;
  if constexpr (L == 4) {
    mma_accumulate<uint8_t, uint8_t>(ring, p, span, wg, d);
  } else if (q.i) {
    if (q.j)
      mma_accumulate<int8_t, int8_t>(ring, p, span, wg, d);
    else
      mma_accumulate<int8_t, uint8_t>(ring, p, span, wg, d);
  } else {
    if (q.j)
      mma_accumulate<uint8_t, int8_t>(ring, p, span, wg, d);
    else
      mma_accumulate<uint8_t, uint8_t>(ring, p, span, wg, d);
  }
}

// out[m, n] = a . b mod 2^32 from the limb planes (maps over [L m, kp] and
// [L n, kp]): one 128 x 128 tile a block, every limb pair, Horner's way.
template <int L>
__global__ void __launch_bounds__(wgmma_s8::kThreads, 1)
dot_limbs_tile_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_bt,
                      int32_t* out, int m, int kp, int n) {
  using namespace wgmma_s8;
  extern __shared__ __align__(16) unsigned char limbs_smem[];
  const Ring ring = make_ring(limbs_smem);
  __syncthreads();
  const int row0 = blockIdx.y * kTileM, col0 = blockIdx.x * kTileN;
  constexpr int P = limb_pairs(L);
  Pipe pipe;
  if (threadIdx.x < 128) {
    producer_registers<kProducerRegs>();
    if (threadIdx.x == 0)
      for (int p = 0; p < P; ++p) {
        const LimbPair q = limb_pair(L, p);
        load_span(&map_a, &map_bt, ring, pipe, q.i * m + row0, q.j * n + col0, 0, kp);
      }
  } else {
    consumer_registers<kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1;
    uint32_t d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0u;
    fence_acc(d);
    int w = limb_pair(L, 0).w;
    for (int p = 0; p < P; ++p) {
      const LimbPair q = limb_pair(L, p);
      if (q.w != w) {
        shift_acc(d, 8 * (w - q.w));
        w = q.w;
      }
      mma_pair<L>(ring, pipe, kp, wg, d, q);
    }
    store_tile(d, out, m, n, row0, col0, wg);
  }
}

// The same sum split over blocks: block x takes output tile x / (P ksplit),
// limb pair (x / ksplit) % P and k-bytes [part kchunk, (part + 1) kchunk) of
// kp (part = x % ksplit), and adds its partial times 2^(8 w) into out.
template <int L>
__global__ void __launch_bounds__(wgmma_s8::kThreads, 1)
dot_limbs_split_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_bt,
                       int32_t* out, int m, int kp, int n, int ksplit, int kchunk) {
  using namespace wgmma_s8;
  extern __shared__ __align__(16) unsigned char limbs_smem[];
  const Ring ring = make_ring(limbs_smem);
  __syncthreads();
  constexpr int P = limb_pairs(L);
  const int part = blockIdx.x % ksplit, tile = blockIdx.x / ksplit / P, tiles_n = (n + kTileN - 1) / kTileN;
  const LimbPair q = limb_pair(L, blockIdx.x / ksplit % P);
  const int row0 = tile / tiles_n * kTileM, col0 = tile % tiles_n * kTileN;
  const int k0 = part * kchunk, k1 = min(kp, k0 + kchunk);
  Pipe pipe;
  if (threadIdx.x < 128) {
    producer_registers<kProducerRegs>();
    if (threadIdx.x == 0) load_span(&map_a, &map_bt, ring, pipe, q.i * m + row0, q.j * n + col0, k0, k1);
  } else {
    consumer_registers<kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1;
    uint32_t d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0u;
    fence_acc(d);
    mma_pair<L>(ring, pipe, k1 - k0, wg, d, q);
    if (q.w) shift_acc(d, 8 * q.w);
    add_tile(d, out, m, n, row0, col0, wg);
  }
}

// P2 and P3 move bytes and compute nothing else, so they are bound by bytes:
// each input byte read once, each output byte written once, at 3.35 TB/s.
// Both are streaming copies built from the same pieces: every output byte
// that lies in an aligned 16-byte vector of the output is written by a
// 16-byte store, and the 16 input bytes behind it come from aligned 16-byte
// loads (two, funnel-shifted into place, where the input window is not
// aligned), kCopyVectors vectors a thread in flight before the first store.
// The few bytes before the output's first aligned vector and after its last
// one take a scalar path, so any base and any length are taken. Where every
// input window is aligned (kAligned: both bases, and for the roll the row
// length and the shift, multiples of 16 bytes), a vector is one load and no
// realignment; the launchers pick that instance from the pointers and sizes.
constexpr int kCopyThreads = 256;  // the most threads a copy block has
constexpr int kCopyVectors = 4;    // 16-byte vectors a thread has in flight

// The aligned 16-byte input granules that cover the 16 bytes at some address,
// and that address's offset d into the first. Both granules hold a byte of
// the window, so neither load reaches a page the window does not touch.
struct Window {
  uint4 lo, hi;
  unsigned d;
};

template <bool kAligned>
__device__ __forceinline__ Window load_window(const unsigned char* p) {
  Window w;
  if constexpr (kAligned) {
    w.lo = w.hi = __ldg(reinterpret_cast<const uint4*>(p));
    w.d = 0;
  } else {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const uint4* g = reinterpret_cast<const uint4*>(a & ~static_cast<uintptr_t>(15));
    w.d = static_cast<unsigned>(a & 15);
    w.lo = __ldg(g);
    w.hi = w.d ? __ldg(g + 1) : w.lo;
  }
  return w;
}

// The window's 16 bytes: bytes d..d+15 of lo:hi, little-endian, so result
// word k is words q+k and q+k+1 shifted right by the remaining 8 (d mod 4)
// bits. The word offset q selects among registers with fixed indices (a
// runtime index would put the eight words in local memory).
template <bool kAligned>
__device__ __forceinline__ uint4 realign(const Window& w) {
  if constexpr (kAligned) {
    return w.lo;
  } else {
    const unsigned q = w.d >> 2, sh = (w.d & 3) * 8;
    const uint32_t v[8] = {w.lo.x, w.lo.y, w.lo.z, w.lo.w, w.hi.x, w.hi.y, w.hi.z, w.hi.w};
    uint32_t s[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) s[k] = q == 0 ? v[k] : q == 1 ? v[k + 1] : q == 2 ? v[k + 2] : v[k + 3];
    return make_uint4(__funnelshift_r(s[0], s[1], sh), __funnelshift_r(s[1], s[2], sh),
                      __funnelshift_r(s[2], s[3], sh), __funnelshift_r(s[3], s[4], sh));
  }
}

// out[r, c] = in[r, (c - shift) mod cols]: with elements of e bytes, each
// row's bytes rotated by shift_bytes = shift * e, so one kernel serves every
// element size. Thread (x, y) of a block takes row blockIdx.y * blockDim.y + y
// (then every gridDim.y * blockDim.y-th row) and, of its aligned output
// vectors, those of chunk blockIdx.x: x, x + blockDim.x, ... kCopyVectors of
// them. An output vector's input window is contiguous unless it wraps past
// the row's end; a wrapping vector (at most one a row, none where kAligned)
// gathers its bytes one by one. Block x = 0 also writes the row's unaligned
// head and tail bytes.
template <bool kAligned>
__global__ void __launch_bounds__(kCopyThreads)
roll_kernel(const unsigned char* __restrict__ in, unsigned char* __restrict__ out, int rows, int row_bytes,
            int shift_bytes) {
  for (long long r = static_cast<long long>(blockIdx.y) * blockDim.y + threadIdx.y; r < rows;
       r += static_cast<long long>(gridDim.y) * blockDim.y) {
    const unsigned char* src = in + r * row_bytes;
    unsigned char* dst = out + r * row_bytes;
    const int head =
        kAligned ? 0 : min(static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15), row_bytes);
    const int vectors = (row_bytes - head) >> 4;
    const int tail0 = head + (vectors << 4);
    if (blockIdx.x == 0) {
      for (int i = threadIdx.x; i < head + row_bytes - tail0; i += blockDim.x) {
        const int e = i < head ? i : tail0 + i - head;
        const int s = e >= shift_bytes ? e - shift_bytes : e - shift_bytes + row_bytes;
        dst[e] = src[s];
      }
    }
    const int v0 = blockIdx.x * blockDim.x * kCopyVectors + threadIdx.x;
    Window w[kCopyVectors];
#pragma unroll
    for (int u = 0; u < kCopyVectors; ++u) {
      const int v = v0 + u * blockDim.x;
      if (v >= vectors) break;
      const int b = head + 16 * v;
      const int s = b >= shift_bytes ? b - shift_bytes : b - shift_bytes + row_bytes;
      if (kAligned || s <= row_bytes - 16) {
        w[u] = load_window<kAligned>(src + s);
      } else {  // the wrap: row_bytes >= 16 here, so one subtraction brings an index back into the row
        uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int t = s + j < row_bytes ? s + j : s + j - row_bytes;
          word[j >> 2] |= static_cast<uint32_t>(src[t]) << (8 * (j & 3));
        }
        w[u].lo = w[u].hi = make_uint4(word[0], word[1], word[2], word[3]);
        w[u].d = 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kCopyVectors; ++u) {
      const int v = v0 + u * blockDim.x;
      if (v >= vectors) break;
      reinterpret_cast<uint4*>(dst + head)[v] = realign<kAligned>(w[u]);
    }
  }
}

// Each int32 word as its four bytes, least significant first. The card's
// memory is little-endian, so a word's bytes in lane order are the word as it
// is stored: the output is the input's bytes, in order, and the kernel is a
// streaming copy of nbytes = 4 * count bytes. A grid sized to the blocks the
// card holds at once walks the output's aligned vectors: thread t of T takes
// vectors t, t + T, t + 2T, ..., kCopyVectors an iteration, so every thread
// has the same number of vectors to within one (a block-sized chunk a turn
// would leave the last turn's blocks alone on the card). Block 0 writes the
// bytes before the first aligned vector and after the last one.
template <bool kAligned>
__global__ void __launch_bounds__(kCopyThreads)
bitcast_i32_to_i8_kernel(const unsigned char* __restrict__ in, unsigned char* __restrict__ out, long long nbytes) {
  const long long align = kAligned ? 0 : static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15);
  const long long head = align < nbytes ? align : nbytes;
  const long long vectors = (nbytes - head) >> 4;
  const long long tail0 = head + (vectors << 4);
  if (blockIdx.x == 0 && threadIdx.x < head + nbytes - tail0) {
    const long long e = threadIdx.x < head ? threadIdx.x : tail0 + threadIdx.x - head;
    out[e] = in[e];
  }
  const unsigned char* src = in + head;
  uint4* dst = reinterpret_cast<uint4*>(out + head);
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; v0 < vectors;
       v0 += threads * kCopyVectors) {
    Window w[kCopyVectors];
#pragma unroll
    for (int u = 0; u < kCopyVectors; ++u) {
      const long long v = v0 + u * threads;
      if (v < vectors) w[u] = load_window<kAligned>(src + 16 * v);
    }
#pragma unroll
    for (int u = 0; u < kCopyVectors; ++u) {
      const long long v = v0 + u * threads;
      if (v < vectors) dst[v] = realign<kAligned>(w[u]);
    }
  }
}

// P4: the two sign-extended 16-bit halves of each word, a streaming split
// bound by bytes (4 read and 4 written a word). Thread t of T takes the
// 8-word vectors t, t + T, ... (two aligned 16-byte loads each),
// kCopyVectors of them in flight, and writes each vector's eight low halves
// as one 16-byte store to lo and its eight high halves as one to hi
// (__byte_perm picks the halves of two words; the halves of a little-endian
// word are its int16 values). Block 0 takes the last count mod 8 words one
// by one. in, lo and hi are 16-byte aligned.
__global__ void __launch_bounds__(kCopyThreads)
unpack_s16_kernel(const uint4* __restrict__ in, uint4* __restrict__ lo, uint4* __restrict__ hi, long long count) {
  const long long vectors = count >> 3, threads = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; v0 < vectors;
       v0 += threads * kCopyVectors) {
    uint4 x[kCopyVectors], y[kCopyVectors];
#pragma unroll
    for (int u = 0; u < kCopyVectors; ++u) {
      const long long v = v0 + u * threads;
      if (v < vectors) {
        x[u] = __ldg(in + 2 * v);
        y[u] = __ldg(in + 2 * v + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < kCopyVectors; ++u) {
      const long long v = v0 + u * threads;
      if (v >= vectors) continue;
      lo[v] = make_uint4(__byte_perm(x[u].x, x[u].y, 0x5410), __byte_perm(x[u].z, x[u].w, 0x5410),
                         __byte_perm(y[u].x, y[u].y, 0x5410), __byte_perm(y[u].z, y[u].w, 0x5410));
      hi[v] = make_uint4(__byte_perm(x[u].x, x[u].y, 0x7632), __byte_perm(x[u].z, x[u].w, 0x7632),
                         __byte_perm(y[u].x, y[u].y, 0x7632), __byte_perm(y[u].z, y[u].w, 0x7632));
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < (count & 7)) {
    const long long e = (vectors << 3) + threadIdx.x;
    const uint32_t w = reinterpret_cast<const uint32_t*>(in)[e];
    reinterpret_cast<uint16_t*>(lo)[e] = static_cast<uint16_t>(w);
    reinterpret_cast<uint16_t*>(hi)[e] = static_cast<uint16_t>(w >> 16);
  }
}

// All blocks of a cooperative launch meet here. `counter` only grows:
// the n-th barrier waits for n * gridDim.x arrivals. sync() joins the
// block's threads that take part, of which `leader` is one.
template <class Sync>
__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned& target, bool leader, Sync sync) {
  target += gridDim.x;
  sync();
  if (leader) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (*reinterpret_cast<volatile unsigned*>(counter) < target) {
    }
    __threadfence();
  }
  sync();
}

// The feedback term of bench_dot: the first k columns of acc plus the parity
// of its last column where n >= k, else acc repeated k / n times.
__device__ __forceinline__ int32_t feedback(const int32_t* acc, int i, int c, int k, int n) {
  const int32_t* row = acc + static_cast<size_t>(i) * n;
  if (n < k) return row[c % n];
  return static_cast<int32_t>(static_cast<uint32_t>(row[c]) + static_cast<uint32_t>(row[n - 1] & 1));
}

// Where `big`, the parity of the column sums of the feedback's fm rows, for
// every column, by `threads` threads of the block from thread t.
__device__ __forceinline__ void column_parities(int8_t* dep_s, const int32_t* acc, int fm, int k, int n, int t,
                                                int threads) {
  for (int c = t; c < k; c += threads) {
    uint32_t sum = 0u;
    for (int i = 0; i < fm; ++i) sum += static_cast<uint32_t>(feedback(acc, i, c, k, n));
    dep_s[c] = static_cast<int8_t>(sum & 1);
  }
}

// Step s's lhs, a_cur = int8(a0 + (dep & 1)), W bytes of a row at a time (W
// divides k): dep is 0 at the first step, then row i of the previous step's
// feedback or, where `big`, the column parities in dep_s. Thread t of
// `threads` across the grid, kBatch pieces a turn, whose loads are all
// issued before the first store: one load in flight a thread would leave
// the copy bound by latency.
constexpr int kBatch = 4;
template <int W>
__device__ __forceinline__ void rebuild_lhs(const int8_t* __restrict__ a0, int8_t* __restrict__ a_cur,
                                            const int32_t* __restrict__ acc, const int8_t* dep_s, int s, int big,
                                            int m, int k, int n, long long t, long long threads) {
  static_assert(W == 1 || W == 16, "a byte or a 16-byte vector");
  const long long pieces = static_cast<long long>(m) * k / W;
  for (long long x0 = t; x0 < pieces; x0 += threads * kBatch) {
    alignas(16) int8_t v[kBatch][W];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long e = (x0 + u * threads) * W;
      if (x0 + u * threads >= pieces) break;
      if constexpr (W == 16)
        *reinterpret_cast<uint4*>(v[u]) = *reinterpret_cast<const uint4*>(a0 + e);
      else
        v[u][0] = a0[e];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long e = (x0 + u * threads) * W;
      if (x0 + u * threads >= pieces) break;
      const int i = static_cast<int>(e / k), c = static_cast<int>(e % k);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        int32_t dep = 0;
        if (s > 0) dep = big ? dep_s[c + j] : feedback(acc, i, c + j, k, n) & 1;
        v[u][j] = static_cast<int8_t>(v[u][j] + dep);
      }
      if constexpr (W == 16)
        *reinterpret_cast<uint4*>(a_cur + e) = *reinterpret_cast<const uint4*>(v[u]);
      else
        a_cur[e] = v[u][0];
    }
  }
}

// bt = b^T for int8 b [k, n], by the whole grid in kTransposeTile-square
// tiles staged through `stage` (rows kTransposeStride bytes apart: 33 words,
// so a column read hits 32 banks): rows of b read and rows of bt written
// contiguously, with all of a block's threads, each with kTransposeBatch
// loads in flight (one byte at a time, latency would bound the copy).
constexpr int kTransposeTile = 128;
constexpr int kTransposeStride = kTransposeTile + 4;
constexpr int kTransposeBatch = 16;
__device__ __forceinline__ void transpose_in_grid(const int8_t* __restrict__ b, int8_t* __restrict__ bt, int k,
                                                  int n, int8_t* stage) {
  constexpr int T = kTransposeTile;
  const int tiles_n = (n + T - 1) / T, tiles = tiles_n * ((k + T - 1) / T);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = (tile / tiles_n) * T, c0 = (tile % tiles_n) * T;
    for (int e0 = threadIdx.x; e0 < T * T; e0 += blockDim.x * kTransposeBatch) {
      int8_t v[kTransposeBatch];
#pragma unroll
      for (int u = 0; u < kTransposeBatch; ++u) {
        const int e = e0 + u * blockDim.x, r = e / T, c = e % T;
        v[u] = e < T * T && r0 + r < k && c0 + c < n ? b[static_cast<size_t>(r0 + r) * n + c0 + c] : int8_t(0);
      }
#pragma unroll
      for (int u = 0; u < kTransposeBatch; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < T * T) stage[(e / T) * kTransposeStride + e % T] = v[u];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < T * T; e += blockDim.x) {
      const int c = e / T, r = e % T;
      if (r0 + r < k && c0 + c < n) bt[static_cast<size_t>(c0 + c) * k + r0 + r] = stage[r * kTransposeStride + c];
    }
    __syncthreads();
  }
}

// After the last step: fb = feedback(acc)[0:fm] (0 without steps), and the
// statistics of one block, by its thread `leader`.
__device__ __forceinline__ void finish_chain(const int32_t* acc, int32_t* fb, int fm, int k, int n, int steps,
                                             int tiles, unsigned long long busy, bool leader, long long t,
                                             long long threads, unsigned long long* stats) {
  for (long long x = t; x < static_cast<long long>(fm) * k; x += threads)
    fb[x] = steps > 0 ? feedback(acc, static_cast<int>(x / k), static_cast<int>(x % k), k, n) : 0;
  if (leader) {
    atomicMax(stats, busy);
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    const unsigned long long mine =
        blockIdx.x < tiles ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
    atomicAdd(stats + 1 + smid, mine * static_cast<unsigned long long>(steps));
  }
}

// A chain of `steps` dependent s8 dots. Step s:
//   a_cur = int8(a0 + (dep & 1)),  dep = the feedback of step s-1 (0 at s = 0):
//           row i of the feedback, or, where `big`, the sum of its 8 rows;
//   acc   = a_cur . b
// and after the last step fb = feedback(acc)[0:fm]. All blocks are resident
// (cooperative launch) and meet at a barrier after each phase. stats[0]
// takes the largest per-block sum of cycles spent in the tile loop and
// stats[1 + smid] counts the tiles each SM ran, over all steps.
//
// This kernel is the CUDA-core unit: int32 multiply-adds on 64 x 64 tiles.
__global__ void __launch_bounds__(kDotThreads, kDotBlocksPerSm)
chain_dot_imad_kernel(const int8_t* __restrict__ a0, const int8_t* __restrict__ b, int8_t* a_cur, int32_t* acc,
                      int32_t* fb, int m, int k, int n, int fm, int big, int steps, unsigned* barrier,
                      unsigned long long* stats) {
  __shared__ __align__(16) uint32_t smem[kDotSmemWords];
  __shared__ int8_t dep_s[kMaxDepK];
  const int tid = threadIdx.x;
  const long long gtid = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  const long long gthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  const int tiles_n = (n + kTile - 1) / kTile;
  const int tiles = tiles_n * ((m + kTile - 1) / kTile);
  const auto sync = [] { __syncthreads(); };
  unsigned target = 0;
  unsigned long long busy = 0;

  for (int s = 0; s < steps; ++s) {
    if (big && s > 0) {
      column_parities(dep_s, acc, fm, k, n, tid, blockDim.x);
      __syncthreads();
    }
    rebuild_lhs<1>(a0, a_cur, acc, dep_s, s, big, m, k, n, gtid, gthreads);
    grid_barrier(barrier, target, tid == 0, sync);
    const long long t0 = clock64();
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      imad_tile<int8_t>(a_cur, b, acc, m, k, n, (tile / tiles_n) * kTile, (tile % tiles_n) * kTile, smem);
    busy += static_cast<unsigned long long>(clock64() - t0);
    grid_barrier(barrier, target, tid == 0, sync);
  }
  finish_chain(acc, fb, fm, k, n, steps, tiles, busy, tid == 0, gtid, gthreads, stats);
}

// The same chain on the tensor cores: the wgmma tile of dot_wgmma_s8_kernel,
// each resident block walking its 128 x 128 tiles. The transpose bt = b^T is
// made once, by the whole grid, staged in the ring before its first use. Then the producer warp waits, each step, for
// the consumers to have rebuilt the lhs (grid barrier among the consumer
// warpgroups, then named barrier kBarLoad) and issues the copies of all the
// block's tiles into the ring; the consumers run them and store acc. a_cur and
// bt are written by ordinary stores and read by TMA in a later phase: each
// writer fences the async proxy after its stores and the producer after the
// barrier, or a copy could read a stale lhs from step 2 on.
__global__ void __launch_bounds__(wgmma_s8::kThreads, 1)
chain_dot_wgmma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_bt,
                       const int8_t* __restrict__ a0, const int8_t* __restrict__ b, int8_t* bt, int8_t* a_cur,
                       int32_t* acc, int32_t* fb, int m, int k, int n, int fm, int big, int steps,
                       unsigned* barrier, unsigned long long* stats) {
  using namespace wgmma_s8;
  extern __shared__ __align__(16) unsigned char chain_dot_smem[];
  __shared__ int8_t dep_s[kMaxDepK];
  const Ring ring = make_ring(chain_dot_smem);
  const int tiles_n = (n + kTileN - 1) / kTileN;
  const int tiles = tiles_n * ((m + kTileM - 1) / kTileM);
  // the ring's first stage stages the transpose; the copies write it later
  static_assert(kTransposeTile * kTransposeStride <= kStageBytes, "a transpose tile fits a stage");
  transpose_in_grid(b, bt, k, n, reinterpret_cast<int8_t*>(ring.a(0)));
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  fence_proxy_async_global();
  __syncthreads();
  Pipe pipe;

  if (threadIdx.x < 128) {  // the producer warpgroup; its first warp stays
    producer_registers<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    for (int s = 0; s < steps; ++s) {
      named_sync(kBarLoad, 32 + kConsumerThreads);
      if (threadIdx.x == 0) {
        fence_proxy_async_global();
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
          load_span(&map_a, &map_bt, ring, pipe, (tile / tiles_n) * kTileM, (tile % tiles_n) * kTileN, 0, k);
      }
      __syncwarp();
    }
    return;
  }

  consumer_registers<kConsumerRegs>();
  const int ct = threadIdx.x - 128, wg = ct / 128;
  const long long gtid = static_cast<long long>(blockIdx.x) * kConsumerThreads + ct;
  const long long gthreads = static_cast<long long>(gridDim.x) * kConsumerThreads;
  const auto sync = [] { named_sync(kBarConsumers, kConsumerThreads); };
  unsigned target = 0;
  unsigned long long busy = 0;
  uint32_t d[64];
  for (int s = 0; s < steps; ++s) {
    if (big && s > 0) {
      column_parities(dep_s, acc, fm, k, n, ct, kConsumerThreads);
      sync();
    }
    rebuild_lhs<kTensorK>(a0, a_cur, acc, dep_s, s, big, m, k, n, gtid, gthreads);
    fence_proxy_async_global();
    grid_barrier(barrier, target, ct == 0, sync);
    named_arrive(kBarLoad, 32 + kConsumerThreads);
    const long long t0 = clock64();
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      mma_tile<int8_t, int8_t>(ring, pipe, k, wg, d);
      store_tile(d, acc, m, n, (tile / tiles_n) * kTileM, (tile % tiles_n) * kTileN, wg);
    }
    busy += static_cast<unsigned long long>(clock64() - t0);
    grid_barrier(barrier, target, ct == 0, sync);
  }
  finish_chain(acc, fb, fm, k, n, steps, tiles, busy, ct == 0, gtid, gthreads, stats);
}

// The chained roll+add, replacing the TPU kernel of bench_roll_add (scripts/bench_kernel_prims.py:120):
// x += roll(x, 1 + i) for i < 16, `reps` times, on int32 rows, each row alone. What bounds it: one 32-bit
// add a word a step. ptxas issues adds to two pipes, IADD3 to the integer ALUs and IMAD to the FMA units,
// 64 lanes an SM a clock each, so an SM adds at most at its four schedulers' issue rate, 128 lanes a
// clock (PEAK_INT32_ADDS in chip_smoke.py). A step cannot start before the one before it has finished,
// so for narrow or few rows a warp's issue rate (one instruction a clock) and the latency of a step (a
// shuffle's round trip and an add, about 35 clocks) bind instead.
//
// The register instance (cols = 32 E) takes that away from memory: one warp a row, lane l holding words
// l E .. l E + E - 1 in registers, the 16 shifts unrolled, so each source is fixed at compile time:
// register j - s of the same lane for j >= s, else register (j - s) mod E of lane l - ceil((s - j) / E)
// mod 32, fetched with a shuffle (the lane index wraps mod 32, which is the roll's wrap within the row).
// A step is E adds and min(s, E) shuffles, the shuffles issued first so that the in-lane adds hide their
// latency; no shared memory and no barrier. The row is loaded and stored once, 16 bytes a lane at a time
// where E allows. One row (warp) a block, so the rows spread over the SMs and their schedulers; a
// row's step is at least its E + min(16, E) instructions on one scheduler, so rows that leave schedulers
// idle (fewer than 4 a SM) stay above the bound by that much.
template <int E, int S>
__device__ __forceinline__ void roll_add_step(uint32_t (&x)[E], int lane) {
  constexpr int kFar = S < E ? S : E;  // registers fetched from other lanes
  uint32_t far[kFar];
#pragma unroll
  for (int j = 0; j < kFar; ++j) {
    const int q = (S - j + E - 1) / E;  // lanes back
    far[j] = __shfl_sync(0xffffffffu, x[j - S + q * E], (lane - q) & 31);
  }
#pragma unroll
  for (int j = E - 1; j >= kFar; --j) x[j] += x[j - S];  // downwards: x[j - S] is still the old word
#pragma unroll
  for (int j = 0; j < kFar; ++j) x[j] += far[j];
}

template <int E, int... S>
__device__ __forceinline__ void roll_add_steps(uint32_t (&x)[E], int lane, std::integer_sequence<int, S...>) {
  (roll_add_step<E, S + 1>(x, lane), ...);
}

template <int E>
__global__ void __launch_bounds__(32) roll_add_regs_kernel(const int32_t* __restrict__ in,
                                                           int32_t* __restrict__ out, int reps) {
  static_assert(E == 1 || E == 2 || E % 4 == 0, "a lane's words load as 4-, 8- or 16-byte vectors");
  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * (32 * E) + static_cast<size_t>(lane) * E;
  uint32_t x[E];
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int v = 0; v < E / 4; ++v) {
      const uint4 w = reinterpret_cast<const uint4*>(in + base)[v];
      x[4 * v] = w.x, x[4 * v + 1] = w.y, x[4 * v + 2] = w.z, x[4 * v + 3] = w.w;
    }
  } else if constexpr (E == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(in + base);
    x[0] = w.x, x[1] = w.y;
  } else {
    x[0] = static_cast<uint32_t>(in[base]);
  }
  for (int r = 0; r < reps; ++r) roll_add_steps(x, lane, std::make_integer_sequence<int, 16>{});
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int v = 0; v < E / 4; ++v)
      reinterpret_cast<uint4*>(out + base)[v] = make_uint4(x[4 * v], x[4 * v + 1], x[4 * v + 2], x[4 * v + 3]);
  } else if constexpr (E == 2) {
    *reinterpret_cast<uint2*>(out + base) = make_uint2(x[0], x[1]);
  } else {
    out[base] = static_cast<int32_t>(x[0]);
  }
}

// The shared-memory instance, for the widths the register instance does not take: cols not 32 E for an
// instantiated E (a row of 32 E words unrolls into E registers a lane and 16 E adds, so each E is an
// instance of its own), up to 6144, a row and its double buffer in 48 KB. One block a row; each step two
// shared loads, a store and an add a word, then a barrier: bound by shared-memory traffic and barriers.
__global__ void roll_add_chain_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                                      int cols, int reps) {
  extern __shared__ __align__(16) unsigned char chain_smem[];
  uint32_t* x = reinterpret_cast<uint32_t*>(chain_smem);
  uint32_t* y = x + cols;
  const size_t base = static_cast<size_t>(blockIdx.x) * cols;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) x[c] = static_cast<uint32_t>(in[base + c]);
  __syncthreads();
  for (int r = 0; r < reps; ++r)
    for (int i = 0; i < 16; ++i) {
      const int shift = (1 + i) % cols;
      for (int c = threadIdx.x; c < cols; c += blockDim.x) {
        int s = c - shift;
        if (s < 0) s += cols;
        y[c] = x[c] + x[s];
      }
      __syncthreads();
      uint32_t* tmp = x;
      x = y;
      y = tmp;
    }
  for (int c = threadIdx.x; c < cols; c += blockDim.x) out[base + c] = static_cast<int32_t>(x[c]);
}

int row_threads(int cols) {
  const int t = (cols + 31) / 32 * 32;
  return t > 1024 ? 1024 : t;
}

// Blocks of `kern` (kCopyThreads threads) the current device holds at once:
// its SMs times the resident blocks, read once per device index below 64
// into `by_device` (the probes' host path is most of their time).
cudaError_t resident_blocks(const void* kern, std::atomic<int> (&by_device)[64], int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (*blocks = by_device[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kCopyThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) by_device[dev].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

// A grid-stride launch of `kern` over `units` pieces of per_block a block,
// no more blocks than the card holds at once (cache: resident_blocks').
template <typename... Params, typename... Args>
int launch_streaming(void (*kern)(Params...), std::atomic<int> (&cache)[64], long long units, long long per_block,
                     cudaStream_t s, Args... args) {
  int cap = 0;
  const cudaError_t err = resident_blocks(reinterpret_cast<const void*>(kern), cache, &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = std::max((units + per_block - 1) / per_block, 1LL);
  kern<<<static_cast<unsigned>(blocks < cap ? blocks : cap), kCopyThreads, 0, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAligned>
int launch_bitcast(const void* in, void* out, long long nbytes, cudaStream_t s) {
  static std::atomic<int> cache[64];
  return launch_streaming(bitcast_i32_to_i8_kernel<kAligned>, cache, nbytes,
                          static_cast<long long>(kCopyThreads) * kCopyVectors * 16, s,
                          static_cast<const unsigned char*>(in), static_cast<unsigned char*>(out), nbytes);
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

// Launches a chain kernel cooperatively: every SM gets a block (the lhs is
// rebuilt by all of them), more only for more tiles, no more than are
// resident at once. *grid_out receives the number of blocks.
int launch_chain(const void* kern, int threads, size_t smem, int tiles, void** args, int* grid_out,
                 cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  int grid = tiles > sms ? tiles : sms;
  if (grid > per_sm * sms) grid = per_sm * sms;
  *grid_out = grid;
  err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(threads), args, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The two tensor maps of the wgmma tile, a [m, k] and bt [n, k], and the
// kernel's shared-memory size, set once per device (`set` holds a bit per
// device index below 64; the probes' host path is most of their time).
cudaError_t prepare_wgmma(const void* kern, std::atomic<unsigned long long>& set, CUtensorMap* map_a,
                          const void* a, CUtensorMap* map_bt, const void* bt, int m, int k, int n) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (err == cudaSuccess && !(set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(wgmma_s8::kSmemBytes));
    if (err == cudaSuccess) set.fetch_or(bit, std::memory_order_release);
  }
  if (err == cudaSuccess) err = wgmma_s8::encode_kmajor(map_a, a, m, k);
  if (err == cudaSuccess) err = wgmma_s8::encode_kmajor(map_bt, bt, n, k);
  return err;
}

std::atomic<unsigned long long> dot_smem_set{0}, chain_smem_set{0};
std::atomic<unsigned long long> limbs_smem_set[2][2];  // [L == 4][in-tile]

// SMs of the current device, read once per device index below 64.
cudaError_t sm_count(int* sms) {
  static std::atomic<int> by_device[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (*sms = by_device[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) by_device[dev].store(*sms, std::memory_order_relaxed);
  return err;
}

// The s16 (L = 2) or s32 (L = 4) dot: the split pass into `planes` (L (m +
// n) kp bytes), then the in-tile instance where the output tiles fill the
// card, else the split instance on out zeroed by the split pass, its
// k-range sized so that tiles x pairs x k-ranges spread over the SMs.
template <int L>
int launch_dot_limbs(const void* a, const void* b, void* planes, void* out, int m, int k, int n, cudaStream_t s) {
  using namespace wgmma_s8;
  using T = std::conditional_t<L == 2, int16_t, int32_t>;
  constexpr int P = limb_pairs(L);
  const int kp = (k + kTensorK - 1) / kTensorK * kTensorK;
  uint8_t* pa = static_cast<uint8_t*>(planes);
  uint8_t* pb = pa + static_cast<size_t>(L) * m * kp;
  const int tiles_m = (m + kTileM - 1) / kTileM, tiles_n = (n + kTileN - 1) / kTileN, tiles = tiles_m * tiles_n;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool in_tile = tiles >= sms;
  const void* kern = in_tile ? reinterpret_cast<const void*>(dot_limbs_tile_kernel<L>)
                             : reinterpret_cast<const void*>(dot_limbs_split_kernel<L>);
  CUtensorMap map_a, map_bt;
  err = prepare_wgmma(kern, limbs_smem_set[L == 4][in_tile], &map_a, pa, &map_bt, pb, L * m, kp, L * n);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* o = static_cast<int32_t*>(out);
  const int split_k = (kp + kSplitEdge - 1) / kSplitEdge;
  const int tiles_a = (m + kSplitEdge - 1) / kSplitEdge * split_k;
  split_limbs_kernel<T><<<tiles_a + split_k * ((n + kSplitEdge - 1) / kSplitEdge), kSplitThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), pa, pb, m, k, n, kp, tiles_a, o,
      in_tile ? 0LL : static_cast<long long>(m) * n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (in_tile) {
    dot_limbs_tile_kernel<L><<<dim3(tiles_n, tiles_m), kThreads, kSmemBytes, s>>>(map_a, map_bt, o, m, kp, n);
    return static_cast<int>(cudaGetLastError());
  }
  const int kblocks = (kp + kTileK - 1) / kTileK;
  const int parts = std::min((sms + tiles * P - 1) / (tiles * P), kblocks);
  const int per = (kblocks + parts - 1) / parts;  // k-blocks a block
  const int ksplit = (kblocks + per - 1) / per;
  dot_limbs_split_kernel<L><<<tiles * P * ksplit, kThreads, kSmemBytes, s>>>(map_a, map_bt, o, m, kp, n, ksplit,
                                                                            per * kTileK);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every function launches on `stream`, returns cudaGetLastError() after the
// launch (0 on success) or cudaErrorInvalidValue for an argument it does not
// take, does not synchronise and allocates nothing.

// out int32 [m, n] = a int8 [m, k] . b int8 [k, n] on the tensor cores;
// bt is scratch, int8 [n, k]. k must be a multiple of 16, a and bt 16-byte
// aligned (TMA).
int tfhe_probe_dot_s8(const void* a, const void* b, void* bt, void* out, int m, int k, int n,
                      void* stream) {
  if (m < 1 || n < 1 || k < kTensorK || k % kTensorK) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  CUtensorMap map_a, map_bt;
  cudaError_t err =
      prepare_wgmma(reinterpret_cast<const void*>(dot_wgmma_s8_kernel), dot_smem_set, &map_a, a, &map_bt, bt, m,
                    k, n);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 tgrid((n + 31) / 32, (k + 31) / 32);
  transpose_s8_kernel<<<tgrid, dim3(32, 8), 0, s>>>(static_cast<const int8_t*>(b),
                                                    static_cast<int8_t*>(bt), k, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + wgmma_s8::kTileN - 1) / wgmma_s8::kTileN,
                  (m + wgmma_s8::kTileM - 1) / wgmma_s8::kTileM);
  dot_wgmma_s8_kernel<<<grid, wgmma_s8::kThreads, wgmma_s8::kSmemBytes, s>>>(
      map_a, map_bt, static_cast<int32_t*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

// out int32 [m, n] = a [m, k] . b [k, n] mod 2^32 on the tensor cores, as
// byte-limb products, for int16 (elem_bytes 2) or int32 (4) operands, any
// k >= 1; planes is scratch of elem_bytes (m + n) kp bytes, kp = k rounded
// up to 16, 16-byte aligned (TMA).
int tfhe_probe_dot_limbs(const void* a, const void* b, void* planes, void* out, int m, int k, int n, int elem_bytes,
                         void* stream) {
  if (m < 1 || n < 1 || k < 1 || k > (1 << 30) || reinterpret_cast<uintptr_t>(planes) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 2: return launch_dot_limbs<2>(a, b, planes, out, m, k, n, s);
    case 4: return launch_dot_limbs<4>(a, b, planes, out, m, k, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[r, c] = in[r, (c - shift) mod cols], 0 <= shift < cols, elements of 1, 2
// or 4 bytes, rows of at most 2^30 bytes; any base. Blocks of 8 to 256 threads
// in x, a power of two (enough for kCopyVectors vectors each to cover a row),
// rows in y up to 128 threads a block, 65535 blocks in y at most (then each
// thread walks further rows).
int tfhe_probe_roll(const void* in, void* out, int rows, int cols, int shift, int elem_bytes, void* stream) {
  if (rows < 1 || cols < 1 || shift < 0 || shift >= cols || (elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4) ||
      static_cast<long long>(cols) * elem_bytes > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_bytes = cols * elem_bytes, shift_bytes = shift * elem_bytes, vectors = row_bytes / 16;
  const int per_thread = (vectors + kCopyVectors - 1) / kCopyVectors;
  int tx = 8;
  while (tx < per_thread && tx < kCopyThreads) tx *= 2;
  const int ty = std::max(128 / tx, 1);
  const dim3 grid(std::max((vectors + tx * kCopyVectors - 1) / (tx * kCopyVectors), 1),
                  std::min((rows + ty - 1) / ty, 65535));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto src = static_cast<const unsigned char*>(in);
  const auto dst = static_cast<unsigned char*>(out);
  if (aligned16(in, out) && row_bytes % 16 == 0 && shift_bytes % 16 == 0)
    roll_kernel<true><<<grid, dim3(tx, ty), 0, s>>>(src, dst, rows, row_bytes, shift_bytes);
  else
    roll_kernel<false><<<grid, dim3(tx, ty), 0, s>>>(src, dst, rows, row_bytes, shift_bytes);
  return static_cast<int>(cudaGetLastError());
}

// out int8 [4 * count]: the bytes of in int32 [count], least significant
// first; any base.
int tfhe_probe_bitcast_i32_to_i8(const void* in, void* out, long long count, void* stream) {
  if (count < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return aligned16(in, out) ? launch_bitcast<true>(in, out, 4 * count, s)
                            : launch_bitcast<false>(in, out, 4 * count, s);
}

// lo, hi int16 [count]: the sign-extended halves of in int32 [count]; in, lo
// and hi 16-byte aligned.
int tfhe_probe_unpack_s16(const void* in, void* lo, void* hi, long long count, void* stream) {
  if (count < 1 || !aligned16(in, lo) || !aligned16(hi, hi)) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<int> cache[64];
  return launch_streaming(unpack_s16_kernel, cache, count >> 3, static_cast<long long>(kCopyThreads) * kCopyVectors,
                          static_cast<cudaStream_t>(stream), static_cast<const uint4*>(in), static_cast<uint4*>(lo),
                          static_cast<uint4*>(hi), count);
}

// The chained dot. a0 int8 [m, k], b int8 [k, n]; scratch bt int8 [n, k]
// (tensor cores only) and a_cur int8 [m, k]; outputs acc int32 [m, n] and fb
// int32 [fm, k]; barrier: one zeroed uint32; stats: 1 + 1024 zeroed uint64.
// tensor != 0 takes the tensor cores (chain_dot_wgmma_kernel: k a multiple
// of 16; a0, bt and a_cur 16-byte aligned), else the CUDA cores
// (chain_dot_imad_kernel). *grid_out receives the number of blocks launched.
int tfhe_probe_chain_dot(const void* a0, const void* b, void* bt, void* a_cur, void* acc, void* fb,
                         int m, int k, int n, int fm, int big, int steps, int tensor,
                         void* barrier, void* stats, int* grid_out, void* stream) {
  const bool folds = n >= k || k % n == 0;
  if (m < 1 || n < 1 || k < 1 || fm < 1 || fm > m || steps < 0 || !folds ||
      (big && k > kMaxDepK) || (tensor && (k < kTensorK || k % kTensorK)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (!tensor) {
    void* args[] = {&a0, &b, &a_cur, &acc, &fb, &m, &k, &n, &fm, &big, &steps, &barrier, &stats};
    const int tiles = ((n + kTile - 1) / kTile) * ((m + kTile - 1) / kTile);
    return launch_chain(reinterpret_cast<const void*>(chain_dot_imad_kernel), kDotThreads, 0, tiles, args,
                        grid_out, s);
  }
  const void* kern = reinterpret_cast<const void*>(chain_dot_wgmma_kernel);
  CUtensorMap map_a, map_bt;
  const cudaError_t err = prepare_wgmma(kern, chain_smem_set, &map_a, a_cur, &map_bt, bt, m, k, n);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&map_a, &map_bt, &a0, &b, &bt, &a_cur, &acc, &fb, &m, &k, &n, &fm, &big, &steps,
                  &barrier, &stats};
  const int tiles = ((n + wgmma_s8::kTileN - 1) / wgmma_s8::kTileN) *
                    ((m + wgmma_s8::kTileM - 1) / wgmma_s8::kTileM);
  return launch_chain(kern, wgmma_s8::kThreads, wgmma_s8::kSmemBytes, tiles, args, grid_out, s);
}

// out int32 [rows, cols] = in after reps * 16 steps of x += roll(x, 1 + i). words = E > 0 takes the
// register instance (cols = 32 E, E one of 1, 2, 4, ..., 64; in and out 16-byte aligned), one row a
// block; words = 0 the shared-memory instance (cols up to 6144), one row a block.
int tfhe_probe_roll_add(const void* in, void* out, int rows, int cols, int reps, int words, void* stream) {
  if (rows < 1 || cols < 1 || reps < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const int32_t*>(in);
  auto y = static_cast<int32_t*>(out);
  if (words == 0) {
    if (static_cast<size_t>(cols) * 8 > 49152) return static_cast<int>(cudaErrorInvalidValue);
    roll_add_chain_kernel<<<rows, row_threads(cols), static_cast<size_t>(cols) * 8, s>>>(x, y, cols, reps);
    return static_cast<int>(cudaGetLastError());
  }
  if (cols != 32 * words || !aligned16(in, out)) return static_cast<int>(cudaErrorInvalidValue);
  switch (words) {
    case 1: roll_add_regs_kernel<1><<<rows, 32, 0, s>>>(x, y, reps); break;
    case 2: roll_add_regs_kernel<2><<<rows, 32, 0, s>>>(x, y, reps); break;
    case 4: roll_add_regs_kernel<4><<<rows, 32, 0, s>>>(x, y, reps); break;
    case 8: roll_add_regs_kernel<8><<<rows, 32, 0, s>>>(x, y, reps); break;
    case 16: roll_add_regs_kernel<16><<<rows, 32, 0, s>>>(x, y, reps); break;
    case 32: roll_add_regs_kernel<32><<<rows, 32, 0, s>>>(x, y, reps); break;
    case 64: roll_add_regs_kernel<64><<<rows, 32, 0, s>>>(x, y, reps); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
