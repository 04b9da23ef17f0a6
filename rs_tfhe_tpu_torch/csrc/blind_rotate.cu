// Blind rotation: all n0 CMUX steps of the TFHE gate bootstrap in one launch.
//
// Replaces the three TPU kernels that compute this one function in
// rs_tfhe_tpu/ops/pallas_blind_rotate.py:
//   fused_blind_rotate       (_kernel,       the per-batch-tile kernel),
//   fused_blind_rotate_wide  (_kernel_wide,  the step-major kernel),
//   fused_blind_rotate_small (_kernel_small, the commuted small-batch kernel).
// They differ only in TPU schedule; this kernel computes their function, the
// blind rotation of rs_tfhe_tpu/ops/blind_rotate.py (the XLA scan), for any
// batch size, bit for bit:
//
//   acc = X^{b~} * testvec
//   for i in 0..n0:  acc += Dec(X^{a~_i} * acc - acc) (x) BSK_i      (mod 2^32)
//
// Three instances, chosen by the wrapper from the batch and the parameter set
// (tile T, cluster CL, unit):
//
// Tensor-core instance (N = 1024 and 2048, single-limb digits, from a few
// dozen ciphertexts up): a cluster with T = 16 or 32, CL = 2N / 256, the product as s8
// limb products through mma.sync (csrc/negacyclic_mma.cuh), the decomposition
// shared out by rows; described at blind_rotate_mma_kernel.
//
// Cluster instance (CL >= 2; small batches, and batches up to a few hundred of
// the sets the tensor-core instance does not serve). A thread-block
// cluster owns a tile of T ciphertexts for all n0 steps, and each block of the
// cluster owns a slice of W = 2N / CL output columns, so one ciphertext runs
// on CL SMs instead of one. Every block keeps a full copy of the tile's
// accumulator in its own shared memory. Per step each block
//   1. rotates and decomposes locally (X^{a~} * acc - acc + offset, then the
//      gadget digits), one gadget row J at a time: 2N * T element operations,
//      redundant in every block, against N^2 per column of product;
//   2. multiplies the digit plane by its slice of BSK_i[J]: thread (cg, ks)
//      owns 8 consecutive columns and the digits m' in [ks * N/CL + delta,
//      (ks + 1) * N/CL + delta) and slides a register window over the
//      extended key row (csrc/blind_rotate_mb.cu's loop): one key word and T
//      digit words from shared memory per 8 T multiply-adds, where the
//      earlier loop at T = 1 loaded 33 words per 32. delta = cg mod 32 staggers
//      the lanes 7 words apart (no bank conflicts while a warp holds one digit
//      slice; two-way at CL = 16, N = 1024); the digit plane is extended by
//      32 negated digits and the key window by 32 words (X^N = -1), so no
//      slice wraps around. The key window of the next gadget row is fetched
//      into registers before the current row's product;
//   3. adds its partial sums into its slice of its accumulator copy (shared
//      memory atomics: the CL digit slices of a column meet there), and pushes
//      the slice into its peers' copies through distributed shared memory with
//      16-byte stores.
// One exchange a step: a split cluster barrier. A block arrives when it has
// read its copy for the last time in the step, waits before it pushes (the
// wait hides behind the product), and a full arrive-and-wait after the push
// makes the new accumulator visible. The last step's barrier also keeps every
// block's memory alive until its peers' pushes have landed. The slicing, the
// window loop, the barrier and the push are csrc/cluster_rotation.cuh's,
// shared with the multi-bit rotation's cluster instance.
// Shared memory per block: (3T + 1) * N + 2N / CL + 32 (T + 1) words, 102 KB
// at N = 1024, T = 8, CL = 8.
//
// Single-block instance (CL = 1; batches that fill the card with tiles of 8).
// One thread block owns a tile of T ciphertexts for the whole
// rotation; the TPU's sequential grid axis over the n0 steps becomes a loop
// inside the block. Thread `tid` owns output polynomial o = tid / (N/8) and
// the R = 8 coefficients c = c0 + r*(N/8), for all T ciphertexts, and keeps
// that slice of the accumulator in registers across all steps. Per step:
//   1. the accumulator goes to shared memory, each thread reads its rotated
//      coefficients X^{a~} * acc (an index computation with a sign) and
//      forms rot - acc + (decomposition offset + rounding half-step);
//   2. for each of the 2L gadget rows J: the block stages the BSK row
//      BSK_i[J] (both output polys, negacyclically extended as [-p, p]) and
//      the J-th digit plane of all T ciphertexts in shared memory;
//   3. each thread accumulates out[c] += sum_m d_J[m] * ext[c - m + N].
// All arithmetic is uint32_t, which wraps mod 2^32 exactly as the torus does:
// a signed digit times a torus word in uint32 is the signed product mod 2^32,
// so no limb split is needed on the CUDA cores; a reduced-modulus (24-bit)
// BSK is simply data here. Multi-limb digit sets (bgbit > 8) need nothing
// extra: digits are int32.
//
// Bound. Integer multiply-adds: 2 * 2L * N^2 per step per ciphertext, i.e.
// 8.4 M per step and 5.9 G per gate at SECURITY_128_BIT_FAST (L=2, N=1024,
// n0=700), 12.6 M and 8.8 G at SECURITY_128_BIT (L=3). The card's 32-bit
// IMAD rate, not memory, bounds both instances: the BSK (22.9 MB at FAST,
// 34.4 MB at strict) fits in the 50 MB L2. At small batch the cluster instance
// is bound by how many SMs one ciphertext can use (16) and by the exchange.
// The tensor-core instance is bound by s8 multiply-adds (3 or 4 limbs per
// word): 2 * 2L * N^2 * limbs per step and ciphertext against the tensor
// cores' rate; what it sustains, and what its two exchanges a step cost, is
// in PERF.md.
//
// Shared memory per block (single-block instance): (3T + 4) * N words, 112 KB
// at N=1024, T=8.
// Tiles: T <= 8 up to N=1024, T <= 4 at N=2048, T <= 2 at N=4096 (max_tile).

#include <cstddef>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_rotation.cuh"
#include "negacyclic_mma.cuh"

namespace {

namespace cg = cooperative_groups;
namespace cr = cluster_rotation;

using cr::cluster_arrive;
using cr::cluster_wait;
using cr::kExclusiveSmem;
using cr::kLanes;
using cr::kR;  // output coefficients per thread
using cr::max_cluster;

constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

constexpr size_t smem_bytes(int n, int tile) {
  return static_cast<size_t>(3 * tile + 4) * n * sizeof(uint32_t);
}

// Largest tile per ring size: the block's 2N/8 threads share the SM's 64K
// registers, and each holds T x 8 accumulators (8 up to N=1024, 4 at 2048,
// 2 at 4096; larger tiles would spill or overflow shared memory).
constexpr int max_tile(int n) { return n <= 1024 ? 8 : 8192 / n; }

template <int LOG_N, int T>
__global__ void __launch_bounds__((1 << LOG_N) / 4)
blind_rotate_kernel(const int32_t* __restrict__ b_til,     // [B]
                    const int32_t* __restrict__ a_til,     // [B, n0]
                    const uint32_t* __restrict__ testvec,  // [2, N] or [B, 2, N]
                    long long tv_stride,                   // 0 (shared) or 2N
                    const uint32_t* __restrict__ bsk,      // [n0, 2L, 2, N]
                    uint32_t* __restrict__ out,            // [B, 2, N]
                    int batch, int n0, int l, int bgbit, uint32_t dec_offset) {
  constexpr int N = 1 << LOG_N;
  constexpr int TWO_N_MASK = 2 * N - 1;
  constexpr int THREADS = 2 * N / kR;
  constexpr int H = N / kR;  // threads per output polynomial

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* acc_s = smem;               // [T][2][N] accumulator, then rot - acc
  uint32_t* dig_s = acc_s + T * 2 * N;  // [T][N]    one digit plane
  uint32_t* ext_s = dig_s + T * N;      // [2][2N]   one BSK row as [-p, p]

  const int tid = threadIdx.x;
  const int o = tid / H;
  const int c0 = tid % H;
  const int b0 = blockIdx.x * T;
  const uint32_t digit_mask = (1u << bgbit) - 1u;
  const int32_t half_bg = 1 << (bgbit - 1);

  uint32_t acc[T][kR];

  // acc = X^{b~} * testvec
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int b = b0 + t;
    const int bt = b < batch ? (b_til[b] & TWO_N_MASK) : 0;
    const uint32_t* tv = testvec + (b < batch ? b : 0) * tv_stride + o * N;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int k = (c0 + r * H - bt + 2 * N) & TWO_N_MASK;
      const uint32_t v = tv[k & (N - 1)];
      acc[t][r] = b < batch ? (k >= N ? 0u - v : v) : 0u;
    }
  }

  for (int i = 0; i < n0; ++i) {
    // 1. publish the accumulator, then rot - acc + offset
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int r = 0; r < kR; ++r) acc_s[(t * 2 + o) * N + c0 + r * H] = acc[t][r];
    __syncthreads();
    uint32_t tmp[T][kR];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int b = b0 + t;
      const int a = b < batch ? (a_til[static_cast<size_t>(b) * n0 + i] & TWO_N_MASK) : 0;
      const uint32_t* src = acc_s + (t * 2 + o) * N;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int k = (c0 + r * H - a + 2 * N) & TWO_N_MASK;
        const uint32_t v = src[k & (N - 1)];
        const uint32_t rot = k >= N ? 0u - v : v;
        tmp[t][r] = rot - acc[t][r] + dec_offset;
      }
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int r = 0; r < kR; ++r) acc_s[(t * 2 + o) * N + c0 + r * H] = tmp[t][r];

    // 2.-3. one gadget row at a time
    for (int j = 0; j < 2 * l; ++j) {
      const int poly = j / l;
      const int shift = 32 - (j % l + 1) * bgbit;
      __syncthreads();  // rot - acc published; previous row's readers done
      const uint32_t* row = bsk + (static_cast<size_t>(i) * 2 * l + j) * 2 * N;
      for (int x = tid; x < 2 * N; x += THREADS) {
        const int oo = x / N;
        const int c = x % N;
        const uint32_t v = row[x];
        ext_s[oo * 2 * N + c] = 0u - v;
        ext_s[oo * 2 * N + N + c] = v;
      }
      for (int x = tid; x < T * N; x += THREADS) {
        const int t = x / N;
        const int m = x % N;
        const uint32_t v = acc_s[(t * 2 + poly) * N + m];
        dig_s[x] = static_cast<uint32_t>(static_cast<int32_t>((v >> shift) & digit_mask) - half_bg);
      }
      __syncthreads();

      // ext[c - m + N] for c = c0 + r*H: the negacyclic BSK coefficient at c - m
      const uint32_t* e = ext_s + o * 2 * N + N + c0;
#pragma unroll 2
      for (int m = 0; m < N; m += 4) {
        uint4 d4[T];
#pragma unroll
        for (int t = 0; t < T; ++t) d4[t] = *reinterpret_cast<const uint4*>(dig_s + t * N + m);
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          uint32_t v[kR];
#pragma unroll
          for (int r = 0; r < kR; ++r) v[r] = e[r * H - m - mm];
#pragma unroll
          for (int t = 0; t < T; ++t) {
            const uint32_t d = mm == 0 ? d4[t].x : mm == 1 ? d4[t].y : mm == 2 ? d4[t].z : d4[t].w;
#pragma unroll
            for (int r = 0; r < kR; ++r) acc[t][r] += d * v[r];
          }
        }
      }
    }
    __syncthreads();  // all rows consumed before acc_s is rewritten
  }

#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int b = b0 + t;
    if (b < batch) {
      uint32_t* dst = out + (static_cast<size_t>(b) * 2 + o) * N;
#pragma unroll
      for (int r = 0; r < kR; ++r) dst[c0 + r * H] = acc[t][r];
    }
  }
}

// ---------------------------------------------------------------------------
// The cluster instance
// ---------------------------------------------------------------------------

// The (T, CL) pairs the wrapper's plan can pick: any tile up to the largest
// at any cluster up to the largest (cluster_rotation.cuh's max_cluster).
constexpr bool cluster_instance(int n, int tile, int cl) {
  return tile <= max_tile(n) && cl <= max_cluster(n);
}

constexpr size_t cluster_smem_bytes(int n, int tile, int cl) {
  return static_cast<size_t>(tile * 2 * n + tile * (n + kLanes) + 2 * n / cl + n + kLanes) *
             sizeof(uint32_t) +
         2 * tile * sizeof(int);
}

template <int LOG_N, int T, int CL>
__global__ void __launch_bounds__((1 << LOG_N) / 4)
blind_rotate_cluster_kernel(const int32_t* __restrict__ b_til,     // [B]
                            const int32_t* __restrict__ a_til,     // [B, n0]
                            const uint32_t* __restrict__ testvec,  // [2, N] or [B, 2, N]
                            long long tv_stride,                   // 0 (shared) or 2N
                            const uint32_t* __restrict__ bsk,      // [n0, 2L, 2, N]
                            uint32_t* __restrict__ out,            // [B, 2, N]
                            int batch, int n0, int l, int bgbit, uint32_t dec_offset) {
  using SL = cr::Slicing<LOG_N, CL>;
  constexpr int N = SL::N;
  constexpr int TWO_N_MASK = 2 * N - 1;
  constexpr int THREADS = SL::THREADS;
  constexpr int W = SL::W;
  constexpr int DIG = SL::DIG;
  constexpr int EXT = SL::EXT;
  constexpr int PF = (EXT + THREADS - 1) / THREADS;  // key words a thread prefetches

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* acc_s = smem;                // [T][2][N] the tile's accumulator (this block's copy)
  uint32_t* dig_s = acc_s + T * 2 * N;   // [T][DIG]  one digit plane, extended
  uint32_t* ext_s = dig_s + T * DIG;     // [EXT]     one gadget row's key window
  int* a_s = reinterpret_cast<int*>(ext_s + EXT);  // [2][T] this and the next step's exponents

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const SL sl(static_cast<int>(cluster.block_rank()), tid);
  const int o = sl.o;
  const int b0 = (blockIdx.x / CL) * T;
  const uint32_t digit_mask = (1u << bgbit) - 1u;
  const int32_t half_bg = 1 << (bgbit - 1);

  // acc = X^{b~} * testvec, the whole tile in every block
  for (int x = tid; x < T * 2 * N; x += THREADS) {
    const int t = x / (2 * N);
    const int c = x & (N - 1);
    const int b = b0 + t;
    uint32_t v = 0u;
    if (b < batch) {
      const int k = (c - (b_til[b] & TWO_N_MASK) + 2 * N) & TWO_N_MASK;
      const uint32_t w = testvec[b * tv_stride + ((x / N) & 1) * N + (k & (N - 1))];
      v = k >= N ? 0u - w : w;
    }
    acc_s[x] = v;
  }
  if (tid < T) a_s[tid] = b0 + tid < batch ? (a_til[static_cast<size_t>(b0 + tid) * n0] & TWO_N_MASK) : 0;

  // E(k) = p[k] (k >= 0), -p[k + N] (-N <= k < 0), p[k + 2N] (k < -N)
  uint32_t pf[PF];
  auto prefetch = [&](int i, int j) {
    const uint32_t* row = bsk + ((static_cast<size_t>(i) * 2 * l + j) * 2 + o) * N;
#pragma unroll
    for (int q = 0; q < PF; ++q) {
      const int x = q * THREADS + tid;
      const int kk = sl.window_k2n(x);
      uint32_t v = 0u;
      if (x < EXT) {
        v = row[kk & (N - 1)];
        if ((kk >> LOG_N) == 1) v = 0u - v;
      }
      pf[q] = v;
    }
  };
  prefetch(0, 0);

  uint32_t part[T][kR];
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int r = 0; r < kR; ++r) part[t][r] = 0u;

  for (int i = 0; i < n0; ++i) {
    int a_next = 0;
    if (tid < T && i + 1 < n0 && b0 + tid < batch)
      a_next = a_til[static_cast<size_t>(b0 + tid) * n0 + i + 1] & TWO_N_MASK;
    const int* a_now = a_s + (i & 1) * T;

    for (int j = 0; j < 2 * l; ++j) {
      const int poly = j / l;
      const int shift = 32 - (j % l + 1) * bgbit;
      __syncthreads();  // the accumulator copy is whole; previous row's readers done
#pragma unroll
      for (int q = 0; q < PF; ++q) {
        const int x = q * THREADS + tid;
        if (x < EXT) ext_s[x] = pf[q];
      }
      for (int x = tid; x < T * N; x += THREADS) {
        const int t = x / N;
        const int m = x & (N - 1);
        const uint32_t* src = acc_s + (t * 2 + poly) * N;
        const int k = (m - a_now[t] + 2 * N) & TWO_N_MASK;
        const uint32_t w = src[k & (N - 1)];
        const uint32_t v = (k >= N ? 0u - w : w) - src[m] + dec_offset;
        const uint32_t d =
            static_cast<uint32_t>(static_cast<int32_t>((v >> shift) & digit_mask) - half_bg);
        dig_s[t * DIG + m] = d;
        if (m < kLanes) dig_s[t * DIG + N + m] = 0u - d;  // X^N = -1
      }
      __syncthreads();
      if (j == 2 * l - 1) cluster_arrive();  // this block no longer reads its copy in this step
      if (j + 1 < 2 * l) {
        prefetch(i, j + 1);
      } else if (i + 1 < n0) {
        prefetch(i + 1, 0);
      }
      cr::window_product<T, SL::S, DIG, 0>(part, sl.window(ext_s), sl.digits(dig_s));
    }

    if (tid < T) a_s[((i + 1) & 1) * T + tid] = a_next;
    cr::add_partial_sums<T, N>(part, acc_s, o, sl.s0 + kR * sl.cgi);
    __syncthreads();
    cluster_wait();  // every peer has read its copy for the last time in this step
    cr::push_slice<T, N, W, CL, THREADS>(cluster, acc_s, sl.rank, o, sl.s0, tid);
    cluster_arrive();
    cluster_wait();  // every slice has landed in every copy
  }

  for (int x = tid; x < T * W; x += THREADS) {
    const int t = x / W;
    const int c = sl.s0 + x % W;
    if (b0 + t < batch) out[(static_cast<size_t>(b0 + t) * 2 + o) * N + c] = acc_s[(t * 2 + o) * N + c];
  }
}

// ---------------------------------------------------------------------------
// The tensor-core instance (N = 1024 and 2048, single-limb digits, 16 or 32 ciphertexts a cluster)
// ---------------------------------------------------------------------------

namespace nm = negacyclic;

// The ring sizes that have this instance: all 2L digit planes of 16 rows
// must fit in shared memory (196 KB of 227 at N = 2048, L = 3; not at 4096).
constexpr bool has_mma_instance(int log_n) { return log_n == 10 || log_n == 11; }
constexpr int kMmaThreads = 256;  // 8 warps
constexpr int kMmaNS = 4;         // n8 sub-tiles a warp, 64 columns apart
constexpr int kMmaCols = 8 * 8 * kMmaNS;  // output columns a block: 256

__host__ __device__ constexpr int mma_rev_words(int n) { return (n + kMmaCols + nm::kRevPad) / 4; }

constexpr size_t mma_smem_bytes(int n, int limbs, int tile, int l) {
  return static_cast<size_t>(tile / (2 * n / kMmaCols)) * 2 * n * sizeof(uint32_t)  // own rows
         + 2 * static_cast<size_t>(limbs) * mma_rev_words(n) * sizeof(uint32_t)     // two key windows
         + 16 * sizeof(int)                                                         // exponents
         + static_cast<size_t>(2 * l) * tile * n;                                   // s8 digits
}

// The cluster instance with the product on the tensor cores: 16 * MS
// ciphertexts on a cluster of 2N / 256 blocks. No block keeps a copy of the
// whole accumulator. Block r owns
//   - the output columns [256 r, 256 r + 256) of all rows, as the 32-bit sums
//     of its mma accumulators, in registers for the whole rotation;
//   - the rows [r * T/CL, (r + 1) * T/CL) in full (every column, shared
//     memory), to rotate and decompose them: the decomposition is shared out by
//     rows, not repeated in every block.
// Per step: the product of all 2L digit planes (all rows' s8 digits are in
// every block's shared memory) by the block's key windows; the limb sums fold
// into the column slice; each row of the slice goes to the row's owner
// (8-byte distributed-shared-memory stores), a cluster barrier, every owner
// decomposes its rows for the next step and pushes their s8 digits, a quarter
// of the accumulator's bytes, to all blocks (16-byte stores), a second barrier.
// The product is csrc/negacyclic_mma.cuh's limb product: a gadget row's key
// window is LIMBS reversed byte planes (3 for a key on the 2^8 grid, whose
// lowest byte is 0 in every extended word; 4 otherwise), double-buffered and
// fetched a row ahead. Warp w owns the rows by the four n8 sub-tiles at
// columns 8w + 64s: a B fragment depends only on the diagonal c - m, so at
// each 64-digit chunk the warp loads ONE new fragment per limb and reuses the
// last three for its other sub-tiles (a ring of four in registers), and with
// MS = 2 every fragment serves two m16 row tiles. The limb sums stay in s32
// registers for the whole step (2L * N * 128 * 255 < 2^31, checked by the
// wrapper). Shared memory: T/CL * 2N words + 2L * T * N digit bytes + the key
// windows: 168 KB at N = 1024, L = 2, MS = 2; 122 KB at L = 3, MS = 1 (L = 3
// with MS = 2 does not fit, and 4 limbs with MS = 2 exceed the registers);
// 226 KB of the 227 a block may have at N = 2048, L = 3, MS = 1, a cluster
// of 16 with one row a block.
template <int LOG_N, int LIMBS, int MS>
__global__ void __launch_bounds__(kMmaThreads, 1)
blind_rotate_mma_kernel(const int32_t* __restrict__ b_til,     // [B]
                        const int32_t* __restrict__ a_til,     // [B, n0]
                        const uint32_t* __restrict__ testvec,  // [2, N] or [B, 2, N]
                        long long tv_stride,                   // 0 (shared) or 2N
                        const uint32_t* __restrict__ bsk,      // [n0, 2L, 2, N]
                        uint32_t* __restrict__ out,            // [B, 2, N]
                        int batch, int n0, int l, int bgbit, uint32_t dec_offset) {
  constexpr int N = 1 << LOG_N;
  constexpr int TWO_N_MASK = 2 * N - 1;
  constexpr int T = 16 * MS;
  constexpr int THREADS = kMmaThreads;
  constexpr int W = kMmaCols;
  constexpr int CL = 2 * N / W;
  constexpr int RPB = T / CL;  // rows whose accumulator this block owns in full
  constexpr int CHUNKS = N / nm::kChunk;
  constexpr int REV_WORDS = mma_rev_words(N);
  constexpr int PF = (REV_WORDS + THREADS - 1) / THREADS;
  constexpr int PLANE_QUADS = CHUNKS * T * (nm::kChunk / 16);
  static_assert(T % CL == 0 && CHUNKS % 4 == 0 && W <= N, "tensor-core instance shape");

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* rowacc_s = smem;                              // [RPB][2][N] own rows, every column
  uint32_t* rev_s = rowacc_s + RPB * 2 * N;               // [2][LIMBS][REV_WORDS]
  int* a_s = reinterpret_cast<int*>(rev_s + 2 * LIMBS * REV_WORDS);  // [16] own rows' exponents
  uint32_t* dig_s = reinterpret_cast<uint32_t*>(a_s + 16);  // [2L][CHUNKS][T][16] words: s8 digits

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int cb = 8 * warp;
  const int o = rank * W / N;
  const int s0 = rank * W % N;
  const int b0 = (blockIdx.x / CL) * T;
  const int row0 = rank * RPB;
  const uint32_t digit_mask = (1u << bgbit) - 1u;
  const int32_t half_bg = 1 << (bgbit - 1);

  auto rotated_testvec = [&](int b, int poly, int c) -> uint32_t {
    if (b >= batch) return 0u;
    const int k = (c - (b_til[b] & TWO_N_MASK) + 2 * N) & TWO_N_MASK;
    const uint32_t w = testvec[b * tv_stride + poly * N + (k & (N - 1))];
    return k >= N ? 0u - w : w;
  };
  for (int x = tid; x < RPB * 2 * N; x += THREADS)
    rowacc_s[x] = rotated_testvec(b0 + row0 + x / (2 * N), (x / N) & 1, x & (N - 1));
  uint32_t slice[MS][kMmaNS][4];
#pragma unroll
  for (int ms = 0; ms < MS; ++ms)
#pragma unroll
    for (int s = 0; s < kMmaNS; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        slice[ms][s][e] = rotated_testvec(b0 + 16 * ms + g + 8 * (e / 2), o, s0 + cb + 64 * s + 2 * t4 + (e & 1));
  auto exponent = [&](int i) -> int {
    const int b = b0 + row0 + tid;
    return tid < RPB && b < batch && i < n0 ? (a_til[static_cast<size_t>(b) * n0 + i] & TWO_N_MASK) : 0;
  };
  if (tid < RPB) a_s[tid] = exponent(0);

  uint32_t pf[PF][4];
  auto prefetch = [&](int i, int j) {
    const uint32_t* row = bsk + ((static_cast<size_t>(i) * 2 * l + j) * 2 + o) * N;
#pragma unroll
    for (int q = 0; q < PF; ++q) {
      const int x = q * THREADS + tid;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int xx = s0 + W - 1 + N - (4 * x + e);
        uint32_t v = 0u;
        if (x < REV_WORDS && xx >= 0) {
          v = row[xx & (N - 1)];
          if (xx < N) v = 0u - v;
        }
        pf[q][e] = v;
      }
    }
  };
  auto store_rev = [&](int buf) {
#pragma unroll
    for (int q = 0; q < PF; ++q) {
      const int x = q * THREADS + tid;
      if (x < REV_WORDS) {
#pragma unroll
        for (int k = 0; k < LIMBS; ++k)
          rev_s[(buf * LIMBS + k) * REV_WORDS + x] = nm::limb_word(pf[q], k + nm::kLimbs - LIMBS);
      }
    }
  };
  // all 2L digit planes of this block's rows, into its own digit buffer and its peers'
  auto decompose_and_share = [&]() {
    uint8_t* bytes = reinterpret_cast<uint8_t*>(dig_s);
    for (int x = tid; x < RPB * 2 * N; x += THREADS) {
      const int lr = x / (2 * N);
      const int poly = (x / N) & 1;
      const int m = x & (N - 1);
      const uint32_t* src = rowacc_s + (lr * 2 + poly) * N;
      const int k = (m - a_s[lr] + 2 * N) & TWO_N_MASK;
      const uint32_t w = src[k & (N - 1)];
      const uint32_t v = (k >= N ? 0u - w : w) - src[m] + dec_offset;
      for (int lvl = 0; lvl < l; ++lvl) {
        const int32_t d = static_cast<int32_t>((v >> (32 - (lvl + 1) * bgbit)) & digit_mask) - half_bg;
        const int plane = poly * l + lvl;
        bytes[((plane * CHUNKS + m / nm::kChunk) * T + row0 + lr) * nm::kChunk + m % nm::kChunk] =
            static_cast<uint8_t>(d);
      }
    }
    __syncthreads();
    uint4* dig4 = reinterpret_cast<uint4*>(dig_s);
    for (int x = tid; x < 2 * l * CHUNKS * RPB * 4; x += THREADS) {
      const int idx = ((x / (RPB * 4)) * T + row0) * 4 + x % (RPB * 4);
      const uint4 v = dig4[idx];
#pragma unroll
      for (int p = 0; p < CL; ++p)
        if (p != rank) cluster.map_shared_rank(dig4, p)[idx] = v;
    }
    cluster_arrive();
    cluster_wait();  // every block has every row's digits
  };

  prefetch(0, 0);
  __syncthreads();
  decompose_and_share();

  int acc[LIMBS][MS][kMmaNS][4];
  const int y_base = W - 1 - cb - g + 16 * t4;
  for (int i = 0; i < n0; ++i) {
    const int a_next = exponent(i + 1);
#pragma unroll
    for (int k = 0; k < LIMBS; ++k)
#pragma unroll
      for (int ms = 0; ms < MS; ++ms)
#pragma unroll
        for (int s = 0; s < kMmaNS; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[k][ms][s][e] = 0;
    store_rev(0);
    prefetch(i, 1);
    for (int j = 0; j < 2 * l; ++j) {
      __syncthreads();  // key window j is whole; window j - 1 is consumed
      if (j + 1 < 2 * l) {
        store_rev((j + 1) & 1);
        if (j + 2 < 2 * l) {
          prefetch(i, j + 2);
        } else if (i + 1 < n0) {
          prefetch(i + 1, 0);
        }
      }
      const uint32_t* planes = rev_s + (j & 1) * LIMBS * REV_WORDS;
      const uint4* dig = reinterpret_cast<const uint4*>(dig_s) + j * PLANE_QUADS;
      // A ring of four fragments per limb: chunk q loads fragment q + 3 for sub-tile 0 and
      // reuses the three before it for sub-tiles 1..3.
      uint4 fr[4][LIMBS];
#pragma unroll
      for (int f = 0; f < 3; ++f)
#pragma unroll
        for (int k = 0; k < LIMBS; ++k)
          fr[f][k] = nm::toeplitz_fragment(planes + k * REV_WORDS, y_base - 192 + 64 * f);
      for (int q0 = 0; q0 < CHUNKS; q0 += 4) {
#pragma unroll
        for (int qi = 0; qi < 4; ++qi) {
          const int q = q0 + qi;
#pragma unroll
          for (int k = 0; k < LIMBS; ++k)
            fr[(qi + 3) % 4][k] = nm::toeplitz_fragment(planes + k * REV_WORDS, y_base + 64 * q);
          uint4 a0[MS], a1[MS];
#pragma unroll
          for (int ms = 0; ms < MS; ++ms) {
            a0[ms] = dig[(q * T + 16 * ms + g) * 4 + t4];
            a1[ms] = dig[(q * T + 16 * ms + g + 8) * 4 + t4];
          }
#pragma unroll
          for (int s = 0; s < kMmaNS; ++s)
#pragma unroll
            for (int k = 0; k < LIMBS; ++k) {
              const uint4 b = fr[(qi + 3 - s) % 4][k];
#pragma unroll
              for (int ms = 0; ms < MS; ++ms) {
                nm::mma_s8_u8(acc[k][ms][s], a0[ms].x, a1[ms].x, a0[ms].y, a1[ms].y, b.x, b.y);
                nm::mma_s8_u8(acc[k][ms][s], a0[ms].z, a1[ms].z, a0[ms].w, a1[ms].w, b.z, b.w);
              }
            }
        }
      }
    }
#pragma unroll
    for (int ms = 0; ms < MS; ++ms)
#pragma unroll
      for (int s = 0; s < kMmaNS; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int k = 0; k < LIMBS; ++k)
            slice[ms][s][e] += static_cast<uint32_t>(acc[k][ms][s][e]) << (8 * (k + nm::kLimbs - LIMBS));
    if (i + 1 == n0) break;
    // each row of the slice goes to the block that owns the row
#pragma unroll
    for (int ms = 0; ms < MS; ++ms)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * ms + g + 8 * h;
        uint32_t* dst = cluster.map_shared_rank(rowacc_s, row / RPB) + ((row % RPB) * 2 + o) * N + s0 + cb + 2 * t4;
#pragma unroll
        for (int s = 0; s < kMmaNS; ++s)
          *reinterpret_cast<uint2*>(dst + 64 * s) = make_uint2(slice[ms][s][2 * h], slice[ms][s][2 * h + 1]);
      }
    if (tid < RPB) a_s[tid] = a_next;
    cluster_arrive();
    cluster_wait();  // every owner has its rows' new accumulator
    decompose_and_share();
  }

#pragma unroll
  for (int ms = 0; ms < MS; ++ms)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = b0 + 16 * ms + g + 8 * h;
      if (b < batch) {
        uint32_t* dst = out + (static_cast<size_t>(b) * 2 + o) * N + s0 + cb + 2 * t4;
#pragma unroll
        for (int s = 0; s < kMmaNS; ++s)
          *reinterpret_cast<uint2*>(dst + 64 * s) = make_uint2(slice[ms][s][2 * h], slice[ms][s][2 * h + 1]);
      }
    }
}

struct Args {
  const int32_t* b_til;
  const int32_t* a_til;
  const uint32_t* testvec;
  long long tv_stride;
  const uint32_t* bsk;
  uint32_t* out;
  int batch, n0, l, bgbit;
  uint32_t dec_offset;
  cudaStream_t stream;
};

template <int LOG_N, int T>
int launch(const Args& a) {
  constexpr int N = 1 << LOG_N;
  constexpr size_t smem = smem_bytes(N, T);
  if constexpr (T > max_tile(N) || (T & (T - 1)) != 0) {  // single blocks: powers of two
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    static_assert(smem <= kMaxSmem, "tile does not fit in shared memory");
    auto kern = blind_rotate_kernel<LOG_N, T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.batch + T - 1) / T);
    kern<<<grid, 2 * N / kR, smem, a.stream>>>(a.b_til, a.a_til, a.testvec, a.tv_stride,
                                               a.bsk, a.out, a.batch, a.n0, a.l, a.bgbit,
                                               a.dec_offset);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int LOG_N, int T, int CL>
cudaError_t cluster_config(cudaLaunchConfig_t* config, cudaLaunchAttribute* attr, int batch,
                           cudaStream_t stream) {
  constexpr int N = 1 << LOG_N;
  constexpr size_t smem = cluster_smem_bytes(N, T, CL);
  static_assert(smem <= kMaxSmem, "tile does not fit in shared memory");
  auto kern = blind_rotate_cluster_kernel<LOG_N, T, CL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (CL > 8) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(((batch + T - 1) / T) * CL);
  config->blockDim = dim3(2 * N / kR);
  config->dynamicSmemBytes = smem;
  config->stream = stream;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaSuccess;
}

// Launch the cluster instance, or (query) only ask how many of its clusters
// the device can hold at once: the count goes to *active.
template <int LOG_N, int T, int CL>
int launch_cluster(const Args& a, int* active) {
  constexpr int N = 1 << LOG_N;
  if constexpr (!cluster_instance(N, T, CL)) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    cudaLaunchConfig_t config;
    cudaLaunchAttribute attr;
    cudaError_t err = cluster_config<LOG_N, T, CL>(&config, &attr, a.batch, a.stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    auto kern = blind_rotate_cluster_kernel<LOG_N, T, CL>;
    if (active != nullptr) {
      if (config.dynamicSmemBytes < kExclusiveSmem) {
        config.dynamicSmemBytes = kExclusiveSmem;
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(kExclusiveSmem));
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      return static_cast<int>(cudaOccupancyMaxActiveClusters(active, kern, &config));
    }
    err = cudaLaunchKernelEx(&config, kern, a.b_til, a.a_til, a.testvec, a.tv_stride, a.bsk, a.out,
                             a.batch, a.n0, a.l, a.bgbit, a.dec_offset);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int LOG_N, int T>
int launch_instance(const Args& a, int cluster, int* active) {
  switch (cluster) {
    case 1: return active != nullptr ? static_cast<int>(cudaErrorInvalidValue) : launch<LOG_N, T>(a);
    case 2: return launch_cluster<LOG_N, T, 2>(a, active);
    case 4: return launch_cluster<LOG_N, T, 4>(a, active);
    case 8: return launch_cluster<LOG_N, T, 8>(a, active);
    case 16: return launch_cluster<LOG_N, T, 16>(a, active);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int LOG_N>
int launch_tile(const Args& a, int tile, int cluster, int* active) {
  switch (tile) {
    case 1: return launch_instance<LOG_N, 1>(a, cluster, active);
    case 2: return launch_instance<LOG_N, 2>(a, cluster, active);
    case 3: return launch_instance<LOG_N, 3>(a, cluster, active);
    case 4: return launch_instance<LOG_N, 4>(a, cluster, active);
    case 5: return launch_instance<LOG_N, 5>(a, cluster, active);
    case 6: return launch_instance<LOG_N, 6>(a, cluster, active);
    case 7: return launch_instance<LOG_N, 7>(a, cluster, active);
    case 8: return launch_instance<LOG_N, 8>(a, cluster, active);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launch the tensor-core instance (or, with `active`, count the clusters the
// device holds of it).
template <int LOG_N, int LIMBS, int MS>
int launch_mma(const Args& a, int* active) {
  constexpr int N = 1 << LOG_N;
  constexpr int CL = 2 * N / kMmaCols;
  constexpr int T = 16 * MS;
  const size_t smem = mma_smem_bytes(N, LIMBS, T, a.l);
  if (smem > kMaxSmem) {  // this gadget length's digit planes do not fit a block
    if (active != nullptr) *active = 0;
    return static_cast<int>(active != nullptr ? cudaSuccess : cudaErrorInvalidValue);
  }
  auto kern = blind_rotate_mma_kernel<LOG_N, LIMBS, MS>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  if (CL > 8) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t config{};
  config.gridDim = dim3(((a.batch + T - 1) / T) * CL);
  config.blockDim = dim3(kMmaThreads);
  config.dynamicSmemBytes = smem;
  config.stream = a.stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  if (active != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveClusters(active, kern, &config));
  err = cudaLaunchKernelEx(&config, kern, a.b_til, a.a_til, a.testvec, a.tv_stride, a.bsk, a.out,
                           a.batch, a.n0, a.l, a.bgbit, a.dec_offset);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// limbs 0: the CUDA-core instances; 3 or 4: the tensor-core instance with
// that many key limbs (N = 1024 and 2048, cluster 2N / 256): 16 ciphertexts a
// cluster, or 32 with 3 limbs at N = 1024.
template <int LOG_N>
int launch_unit(const Args& a, int tile, int cluster, int limbs, int* active) {
  if (limbs == 0) return launch_tile<LOG_N>(a, tile, cluster, active);
  if constexpr (has_mma_instance(LOG_N)) {
    if (cluster != 2 * (1 << LOG_N) / kMmaCols) return static_cast<int>(cudaErrorInvalidValue);
    if (tile == 16 && limbs == 3) return launch_mma<LOG_N, 3, 1>(a, active);
    if (tile == 16 && limbs == 4) return launch_mma<LOG_N, 4, 1>(a, active);
    if constexpr (LOG_N == 10) {
      if (tile == 32 && limbs == 3) return launch_mma<LOG_N, 3, 2>(a, active);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// One translation unit per ring size (-DTFHE_LOG_N=6..12): the instances of a
// ring size compile in their own nvcc process, all started together. The unit
// compiled with -DTFHE_MAIN also holds the C interface and dispatches to the
// others by ring size.
#ifndef TFHE_LOG_N
#error "compile with -DTFHE_LOG_N=<6..12> (one unit per ring size) and -DTFHE_MAIN for one of them"
#endif
#define TFHE_CAT2(a, b) a##b
#define TFHE_CAT(a, b) TFHE_CAT2(a, b)
#define TFHE_RING_FN(log_n) TFHE_CAT(tfhe_blind_rotate_ring_, log_n)

extern "C" int TFHE_RING_FN(TFHE_LOG_N)(const void* args, int tile, int cluster, int limbs,
                                        int* active) {
  return launch_unit<TFHE_LOG_N>(*static_cast<const Args*>(args), tile, cluster, limbs, active);
}

#ifdef TFHE_MAIN

extern "C" {
int tfhe_blind_rotate_ring_6(const void*, int, int, int, int*);
int tfhe_blind_rotate_ring_7(const void*, int, int, int, int*);
int tfhe_blind_rotate_ring_8(const void*, int, int, int, int*);
int tfhe_blind_rotate_ring_9(const void*, int, int, int, int*);
int tfhe_blind_rotate_ring_10(const void*, int, int, int, int*);
int tfhe_blind_rotate_ring_11(const void*, int, int, int, int*);
int tfhe_blind_rotate_ring_12(const void*, int, int, int, int*);
}

namespace {

int dispatch(const Args& a, int log_n, int tile, int cluster, int limbs, int* active) {
  switch (log_n) {
    case 6: return tfhe_blind_rotate_ring_6(&a, tile, cluster, limbs, active);
    case 7: return tfhe_blind_rotate_ring_7(&a, tile, cluster, limbs, active);
    case 8: return tfhe_blind_rotate_ring_8(&a, tile, cluster, limbs, active);
    case 9: return tfhe_blind_rotate_ring_9(&a, tile, cluster, limbs, active);
    case 10: return tfhe_blind_rotate_ring_10(&a, tile, cluster, limbs, active);
    case 11: return tfhe_blind_rotate_ring_11(&a, tile, cluster, limbs, active);
    case 12: return tfhe_blind_rotate_ring_12(&a, tile, cluster, limbs, active);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the blind rotation on `stream`: `tile` ciphertexts a cluster of
// `cluster` blocks (1: the single-block instance); `limbs` 0 for the CUDA
// cores, 3 or 4 for the tensor-core instance with that many key limbs (the
// caller has checked the accumulator bound, and for 3 that the key is on the
// 2^8 grid). Returns cudaGetLastError()
// after the launch (0 on success) or cudaErrorInvalidValue for a shape it
// does not take. Does not synchronise and allocates nothing.
int tfhe_blind_rotate(const void* b_til, const void* a_til, const void* testvec,
                      long long tv_stride, const void* bsk, void* out, int batch, int n0,
                      int log_n, int l, int bgbit, unsigned int dec_offset, int tile, int cluster,
                      int limbs, void* stream) {
  const Args a{static_cast<const int32_t*>(b_til), static_cast<const int32_t*>(a_til),
               static_cast<const uint32_t*>(testvec), tv_stride,
               static_cast<const uint32_t*>(bsk), static_cast<uint32_t*>(out),
               batch, n0, l, bgbit, dec_offset, static_cast<cudaStream_t>(stream)};
  return dispatch(a, log_n, tile, cluster, limbs, nullptr);
}

// How many clusters of the (tile, cluster >= 2) instance the current device
// can hold at once at one block an SM, or -(error code). Blocks that share
// an SM share its multiply-add rate, so this is the count that fills the
// card in one wave. The CUDA-core instances (limbs 0) are asked with more than
// half an SM's shared memory; the tensor-core instance with the shared memory
// it is launched with, which grows with the gadget length `l` (its 2l digit
// planes), and its registers, which hold it to one block an SM.
int tfhe_blind_rotate_max_active_clusters(int log_n, int tile, int cluster, int limbs, int l) {
  Args a{};
  a.batch = tile;
  a.l = l;
  int active = 0;
  const int err = dispatch(a, log_n, tile, cluster, limbs, &active);
  return err != 0 ? -err : active;
}

// The largest batch tile the launcher takes at ring size 2^log_n; the
// wrapper picks its tile up to this.
int tfhe_blind_rotate_max_tile(int log_n) { return max_tile(1 << log_n); }

// The largest cluster the launcher takes at ring size 2^log_n.
int tfhe_blind_rotate_max_cluster(int log_n) { return max_cluster(1 << log_n); }

const char* tfhe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // TFHE_MAIN
