// Multi-bit blind rotation: all n0/2 grouped steps of a bootstrap with a
// multi-bit key in one launch.
//
// Replaces the TPU kernel fused_blind_rotate_small_mb (_kernel_small_mb) of
// rs_tfhe_tpu/ops/pallas_blind_rotate.py. It computes the function of the JAX
// package's exact path, blind_rotate_mb in rs_tfhe_tpu/ops/blind_rotate.py
// (the XLA scan), bit for bit, for any batch size:
//
//   acc = X^{b~} * testvec
//   for g in 0..n0/2:   (a1, a2) = (a~[2g], a~[2g+1])
//     comb = G_00 + X^{a1} G_10 + X^{a2} G_01 + X^{(a1+a2) mod 2N} G_11
//     acc  = Dec(acc) (x) comb                                   (mod 2^32)
//
// G_v = bsk_mb[g][v], the TRGSW of the v-th pair indicator
// (key.gen_bootstrapping_key_mb). This is the replacement form: the digits
// come from the whole accumulator and nothing is added back.
//
// Design. The TPU kernel commutes the four monomials past one int8 dot of
// all four patterns (4 products per group) because it cannot rotate the key
// per ciphertext cheaply; that is twice the multiply-adds of the CMUX chain.
// Here the combination is built in the word domain, per ciphertext, per
// gadget row: comb_j = sum_v X^{k_v} G_v[j] (4 reads per coefficient), and
// then ONE product per group: 2 * 2L * N^2 multiply-adds per group per
// ciphertext, n0/2 groups, i.e. 2.9 G per rotation at SECURITY_128_BIT_FAST,
// half of csrc/blind_rotate.cu's 5.9 G. All arithmetic is uint32_t and wraps
// mod 2^32 as the torus does; a 24-bit key (bsk_round_bits) is simply data and
// digits of any width are int32. Unlike csrc/blind_rotate.cu, whose
// ciphertexts share one key row, every ciphertext here has its own
// combination, so the key window is per ciphertext and a tile's ciphertexts
// share only the digits' loop.
//
// Two instances, chosen by the wrapper (ops/cuda_blind_rotate_mb.py) from
// the batch and the clusters the card holds:
//
// Cluster instance (CL >= 2; the batches `auto` sends here: at most 2 or 4
// ciphertexts). One ciphertext tile over a thread-block cluster, as the CMUX
// rotation's cluster instance does it (csrc/cluster_rotation.cuh: every block
// keeps a full copy of the tile's accumulator and owns W = 2N / CL output
// columns; slices of S = N / CL digits a thread; the sliding register window;
// shared-memory atomics; a 16-byte push to the peers; one split cluster
// barrier a group). Per group and gadget row j each block
//   1. builds, for its output polynomial o and each ciphertext t of the tile,
//      the extended window of the combination over the key window's range:
//      E_t(k) = sum_v (-1)^floor((k - k_v) / N) G_v[j][o][(k - k_v) mod N],
//      k in [s0 - N - 31, s0 + W) (EXT words per ciphertext: the monomial's
//      sign and the negacyclic extension's sign are one parity). The four
//      pattern rows G_v[j][o] come from shared memory, where the previous
//      row's product had them copied with cp.async (16-byte copies of 4N
//      contiguous words): the key's reads from L2 overlap the product without
//      holding registers, where T x 4 prefetched words a window position
//      would not fit at T = 4 from N = 2048 (128 registers a thread);
//   2. decomposes Dec(acc + offset) of the digit plane's polynomial, with no
//      rotation and no subtraction. In the last gadget level of its own
//      polynomial o it zeroes its own slice of its own copy right after its
//      last read of each word (replacement: the group's product is the new
//      accumulator), so the atomics of step 4 start from 0. Peers write
//      their slices of this copy only after the cluster barrier that this
//      block passes after its last read;
//   3. multiplies: part[t] += digits (x) E_t, the window loop with a window
//      per ciphertext (2 shared-memory words per 8 multiply-adds);
//   4. after the last row: atomics into its slice, push, barrier.
// A tile of one ciphertext with single-limb digits from N = 1024 up (the
// batches `auto` sends: each ciphertext a cluster of 16) runs step 3 as the
// fold (cluster_rotation.cuh: s8 digits in 16 rows shifted by 8 against the
// LIMBS byte planes of E, on mma.sync), builds E into those planes, and
// stages the pattern rows by the copy engine (four bulk copies a row,
// fold_stages(N) rows ahead, completing on an mbarrier a slot); its gadget
// rows are a two-stage pipeline, as in csrc/blind_rotate.cu's fold.
// Shared memory per block: 4N + T (2N + N + 32 + W + N + 32) words
// (cluster_smem_bytes): 83 KiB at N = 1024, T = 4, CL = 16; 193 KiB at
// N = 2048, T = 4, CL = 2; 144 KiB at N = 4096, T = 1, CL = 2. Tiles 1, 2
// and 4 up to N = 2048, 1 at N = 4096 (cluster_max_tile), clusters 2-16 at
// the ring sizes 64 and 1024 up.
//
// Single-block instance (CL = 1; batches that fill the card with single
// blocks, under step_impl="fused_small_mb"). One block owns a tile of T
// ciphertexts for the whole rotation (the TPU's sequential grid axis is a
// loop inside the block). Thread `tid` owns output polynomial
// o = tid / (N/8) and the R = 8 consecutive coefficients c = 8*c0 + r
// (c0 = tid % (N/8)) of all T ciphertexts, and keeps them in registers across
// the groups. Per group:
//   1. the accumulator goes to shared memory; the registers restart at 0;
//   2. per gadget row j: the block builds comb_j of every ciphertext of the
//      tile (from L2) and the j-th digit plane of Dec(acc) in shared memory;
//   3. each thread accumulates out[c] += sum_m d_j[m] * comb_j[c - m] with a
//      register window over its R consecutive outputs: from digit m to m+1
//      the needed words ext[c - m] shift by one, so each digit costs one new
//      combination word and one digit word for R multiply-adds. Each thread
//      starts its digit loop at its own offset delta = c0 mod 32 (7 words
//      apart across a warp, conflict-free), over m' = delta + u in
//      [delta, delta + N); for m' >= N the digit plane is stored extended by
//      32 negated digits (X^N = -1), so the loop needs no wrap-around.
// Shared memory per block: 7 * T * N + 32 * T words (accumulator 2TN, digit
// plane T(N+32), extended combinations 4TN), 112 KB at N=1024, T=4. Tiles:
// T <= 4 up to N=1024, T <= 2 at N=2048, T = 1 at N=4096 (max_tile).
//
// Bound: the 32-bit multiply-adds, 2 * 2L * N^2 a group and ciphertext, on
// the CUDA cores (their int32 rate); at small batch, how many SMs one
// ciphertext can use (16) and the exchange a group. The key (45.9 MB at
// FAST) is read once a group per cluster, from L2 after the first. Times in
// PERF.md.

#include <cstddef>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_rotation.cuh"
#include "negacyclic_mma.cuh"
#include "wgmma_s8.cuh"

namespace {

namespace cg = cooperative_groups;
namespace cr = cluster_rotation;
namespace nm = negacyclic;
namespace wg8 = wgmma_s8;

using cr::cluster_arrive;
using cr::cluster_wait;
using cr::kExclusiveSmem;
using cr::kLanes;
using cr::kR;  // output coefficients per thread
using cr::max_cluster;

constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

constexpr size_t smem_bytes(int n, int tile) {
  return static_cast<size_t>(7 * tile * n + kLanes * tile) * sizeof(uint32_t) +
         4 * tile * sizeof(int);
}

// Largest tile of the single-block instance per ring size.
constexpr int max_tile(int n) { return n <= 1024 ? 4 : 4096 / n; }

// Largest tile of the cluster instance: its registers hold T x 8 partial sums
// and T register windows of 8 words, in 128 registers a thread at N = 2048
// and 64 at 4096, where a tile of 2 spills.
constexpr int cluster_max_tile(int n) { return n <= 2048 ? 4 : 1; }

// LIMBS 0: on the CUDA cores; 3 or 4: the fold (cluster_rotation.cuh), a tile
// of one ciphertext with that many key limbs.
constexpr bool cluster_instance(int n, int tile, int cl, int limbs) {
  return limbs == 0 ? (tile == 1 || tile == 2 || tile == 4) && tile <= cluster_max_tile(n) && cl >= 2 &&
                          cl <= max_cluster(n)
                    : tile == 1 && cr::has_fold(n, cl);
}

// The fold's gadget rows of the four patterns come by the copy engine into
// fold_stages(N) slots, up to that many rows ahead (its product is too short
// to hide a row's copy from L2, and cp.async's issue would hold every
// thread); its digit planes and key windows are double-buffered (a two-stage
// pipeline of rows). At N = 4096 one slot of 64 KB leaves room for a
// cluster of 2's key windows.
__host__ __device__ constexpr int fold_stages(int n) { return n >= 4096 ? 1 : 3; }

constexpr size_t cluster_smem_bytes(int n, int tile, int cl, int limbs) {
  if (limbs != 0)  // staged rows, accumulator, two s8 digit planes, two key windows, exponents, barriers
    return static_cast<size_t>(fold_stages(n) * 4 * n + 2 * n + 2 * (n + 2 * cr::kFoldPad) / 4 +
                               2 * limbs * (n + 2 * n / cl - 120) / 4) *
               sizeof(uint32_t) +
           4 * sizeof(int) + fold_stages(n) * sizeof(uint64_t);
  return static_cast<size_t>(4 * n + tile * (2 * n + (n + kLanes) + (2 * n / cl + n + kLanes))) *
             sizeof(uint32_t) +
         4 * tile * sizeof(int);
}

template <int LOG_N, int T>
__global__ void __launch_bounds__((1 << LOG_N) / 4)
blind_rotate_mb_kernel(const int32_t* __restrict__ b_til,     // [B]
                       const int32_t* __restrict__ a_til,     // [B, n0]
                       const uint32_t* __restrict__ testvec,  // [2, N] or [B, 2, N]
                       long long tv_stride,                   // 0 (shared) or 2N
                       const uint32_t* __restrict__ bsk_mb,   // [n0/2, 4, 2L, 2, N]
                       uint32_t* __restrict__ out,            // [B, 2, N]
                       int batch, int n0, int l, int bgbit, uint32_t dec_offset) {
  constexpr int N = 1 << LOG_N;
  constexpr int TWO_N_MASK = 2 * N - 1;
  constexpr int THREADS = 2 * N / kR;
  constexpr int H = N / kR;  // threads per output polynomial

  constexpr int DIG = N + kLanes;  // digit plane, extended by kLanes negated digits

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* acc_s = smem;                // [T][2][N]   accumulator at the group's start
  uint32_t* dig_s = acc_s + T * 2 * N;   // [T][DIG]    one digit plane, extended
  uint32_t* comb_s = dig_s + T * DIG;    // [T][2][2N]  comb_j per ciphertext, as [-p, p]
  int* k_s = reinterpret_cast<int*>(comb_s + T * 4 * N);  // [T][4] monomial exponents

  const int tid = threadIdx.x;
  const int o = tid / H;
  const int c0 = tid % H;
  const int cb = c0 * kR;           // first of this thread's R consecutive outputs
  const int delta = c0 % kLanes;    // this thread's digit-loop offset
  const int b0 = blockIdx.x * T;
  const int groups = n0 / 2;
  const uint32_t digit_mask = (1u << bgbit) - 1u;
  const int32_t half_bg = 1 << (bgbit - 1);
  const size_t row_words = static_cast<size_t>(2) * N;  // one gadget row of one pattern
  const size_t pattern_words = static_cast<size_t>(2 * l) * row_words;

  uint32_t acc[T][kR];

  // acc = X^{b~} * testvec
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int b = b0 + t;
    const int bt = b < batch ? (b_til[b] & TWO_N_MASK) : 0;
    const uint32_t* tv = testvec + (b < batch ? b : 0) * tv_stride + o * N;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int k = (cb + r - bt + 2 * N) & TWO_N_MASK;
      const uint32_t v = tv[k & (N - 1)];
      acc[t][r] = b < batch ? (k >= N ? 0u - v : v) : 0u;
    }
  }

  for (int grp = 0; grp < groups; ++grp) {
    // 1. publish the accumulator and this group's exponents; restart at 0.
    //    (The previous group's readers of acc_s and k_s passed the barrier
    //    that ends their last gadget row.)
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        acc_s[(t * 2 + o) * N + cb + r] = acc[t][r];
        acc[t][r] = 0u;
      }
    if (tid < T) {
      const int b = b0 + tid;
      const size_t at = static_cast<size_t>(b < batch ? b : 0) * n0 + 2 * grp;
      const int a1 = b < batch ? (a_til[at] & TWO_N_MASK) : 0;
      const int a2 = b < batch ? (a_til[at + 1] & TWO_N_MASK) : 0;
      k_s[tid * 4 + 0] = 0;
      k_s[tid * 4 + 1] = a1;
      k_s[tid * 4 + 2] = a2;
      k_s[tid * 4 + 3] = (a1 + a2) & TWO_N_MASK;
    }
    const uint32_t* key = bsk_mb + static_cast<size_t>(grp) * 4 * pattern_words;

    for (int j = 0; j < 2 * l; ++j) {
      const int poly = j / l;
      const int shift = 32 - (j % l + 1) * bgbit;
      __syncthreads();  // acc_s / k_s published; previous row's readers done

      // 2. comb_j of every ciphertext of the tile, both output polynomials
      for (int x = tid; x < T * 2 * N; x += THREADS) {
        const int t = x / (2 * N);
        const int oo = (x / N) & 1;
        const int c = x & (N - 1);
        const uint32_t* row = key + j * row_words + oo * N;
        uint32_t sum = 0u;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int k = (c - k_s[t * 4 + v] + 2 * N) & TWO_N_MASK;
          const uint32_t w = row[v * pattern_words + (k & (N - 1))];
          sum += k >= N ? 0u - w : w;
        }
        uint32_t* ext = comb_s + (t * 2 + oo) * 2 * N;
        ext[N + c] = sum;
        ext[c] = 0u - sum;
      }
      for (int x = tid; x < T * N; x += THREADS) {
        const int t = x / N;
        const int m = x % N;
        const uint32_t v = acc_s[(t * 2 + poly) * N + m] + dec_offset;
        const uint32_t d =
            static_cast<uint32_t>(static_cast<int32_t>((v >> shift) & digit_mask) - half_bg);
        dig_s[t * DIG + m] = d;
        if (m < kLanes) dig_s[t * DIG + N + m] = 0u - d;  // X^N = -1
      }
      __syncthreads();

      // 3. acc[t][r] += sum_{u < N} d_t[delta + u] * ext_t[N + cb + r - delta - u]
      //    with the window win[t][(r - u) mod R] = ext_t[N + cb - delta + r - u]
      const uint32_t* e[T];
      const uint32_t* d[T];
      uint32_t win[T][kR];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        e[t] = comb_s + (t * 2 + o) * 2 * N + N + cb - delta;
        d[t] = dig_s + t * DIG + delta;
#pragma unroll
        for (int r = 1; r < kR; ++r) win[t][r] = e[t][r];
      }
      for (int u0 = 0; u0 < N; u0 += kR) {
#pragma unroll
        for (int k = 0; k < kR; ++k) {
          const int u = u0 + k;
#pragma unroll
          for (int t = 0; t < T; ++t) {
            win[t][(kR - k) % kR] = e[t][-u];
            const uint32_t dv = d[t][u];
#pragma unroll
            for (int r = 0; r < kR; ++r) acc[t][r] += dv * win[t][(r - k + kR) % kR];
          }
        }
      }
    }
    __syncthreads();  // all rows consumed before acc_s and k_s are rewritten
  }

#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int b = b0 + t;
    if (b < batch) {
      uint32_t* dst = out + (static_cast<size_t>(b) * 2 + o) * N;
#pragma unroll
      for (int r = 0; r < kR; ++r) dst[cb + r] = acc[t][r];
    }
  }
}

template <int LOG_N, int T, int CL, int LIMBS>
__global__ void __launch_bounds__((1 << LOG_N) / 4, 1)
blind_rotate_mb_cluster_kernel(const int32_t* __restrict__ b_til,     // [B]
                               const int32_t* __restrict__ a_til,     // [B, n0]
                               const uint32_t* __restrict__ testvec,  // [2, N] or [B, 2, N]
                               long long tv_stride,                   // 0 (shared) or 2N
                               const uint32_t* __restrict__ bsk_mb,   // [n0/2, 4, 2L, 2, N]
                               uint32_t* __restrict__ out,            // [B, 2, N]
                               int batch, int n0, int l, int bgbit, uint32_t dec_offset) {
  using SL = cr::Slicing<LOG_N, CL>;
  constexpr int N = SL::N;
  constexpr int TWO_N_MASK = 2 * N - 1;
  constexpr int THREADS = SL::THREADS;
  constexpr int W = SL::W;
  constexpr int DIG = SL::DIG;
  constexpr int EXT = SL::EXT;
  constexpr bool FOLD = LIMBS != 0;
  using FD = cr::Fold<FOLD ? LOG_N : 10, FOLD ? CL : 16, FOLD ? LIMBS : 4>;  // read only where FOLD
  static_assert(!FOLD || T == 1, "the fold takes a tile of one ciphertext");
  constexpr int STAGES = FOLD ? fold_stages(N) : 1;  // gadget rows staged
  constexpr int BUFS = FOLD ? 2 : 1;                  // digit planes and key windows
  constexpr int DIG_WORDS = FOLD ? FD::DIG_WORDS : T * DIG;
  constexpr int KEY_WORDS = FOLD ? LIMBS * FD::REV_WORDS : T * EXT;

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* stage_s = smem;                    // [STAGES][4][N] gadget rows of the four patterns, polynomial o
  uint32_t* acc_s = stage_s + STAGES * 4 * N;  // [T][2][N]  the tile's accumulator (this block's copy)
  uint32_t* dig_s = acc_s + T * 2 * N;         // [T][DIG]   one digit plane, extended; the fold: [2] s8, padded
  uint32_t* ext_s = dig_s + BUFS * DIG_WORDS;  // [T][EXT]   comb_j's key window; the fold: [2][LIMBS][REV_WORDS]
  int* a_s = reinterpret_cast<int*>(ext_s + BUFS * KEY_WORDS);  // [2][T][2] this and the next group's a~
  uint64_t* staged = reinterpret_cast<uint64_t*>(a_s + 4 * T);  // the fold: [STAGES] a slot's copies landed

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const SL sl(static_cast<int>(cluster.block_rank()), tid);
  const FD fd(tid);
  const int o = sl.o;
  const int b0 = (blockIdx.x / CL) * T;
  const int groups = n0 / 2;
  const uint32_t digit_mask = (1u << bgbit) - 1u;
  const int32_t half_bg = 1 << (bgbit - 1);
  const size_t row_words = static_cast<size_t>(2) * N;  // one gadget row of one pattern
  const size_t pattern_words = static_cast<size_t>(2 * l) * row_words;

  // gadget row j of group g's four patterns, polynomial o, into stage slot u (async): the
  // fold's by four bulk copies, one from the first lane of each of four warps, which complete
  // on staged[u]; else by cp.async
  auto stage = [&](int g, int j, int u) {
    const uint32_t* row = bsk_mb + static_cast<size_t>(g) * 4 * pattern_words + j * row_words + o * N;
    uint32_t* dst = stage_s + u * 4 * N;
    if constexpr (FOLD) {
      const int v = tid / 32;
      wg8::bulk_load_if(dst + (v & 3) * N, row + (v & 3) * pattern_words, N * sizeof(uint32_t), staged + u,
                        tid % 32 == 0 && v < 4);
    } else {
      for (int x = tid; x < N; x += THREADS) {  // N copies of 4 words
        const int v = x / (N / 4);
        const int c = (x % (N / 4)) * 4;
        nm::cp_async_16(dst + v * N + c, row + v * pattern_words + c, true);
      }
      nm::cp_async_commit();
    }
  };
  auto exponent = [&](int g, int h) -> int {  // a~[2g + h] of this thread's ciphertext
    const int b = b0 + tid;
    return b < batch && g < groups ? (a_til[static_cast<size_t>(b) * n0 + 2 * g + h] & TWO_N_MASK) : 0;
  };

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
  if (tid < T) {
    a_s[2 * tid] = exponent(0, 0);
    a_s[2 * tid + 1] = exponent(0, 1);
  }
  if constexpr (FOLD) {
    if (tid == 0) {
      for (int u = 0; u < STAGES; ++u) wg8::mbar_init(staged + u, 4);  // four copies a row
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    for (int r = 0; r < STAGES && r < groups * 2 * l; ++r) stage(r / (2 * l), r % (2 * l), r);
    for (int x = tid; x < 4 * cr::kFoldPad / 4; x += THREADS)  // the planes' zero pads, never written again
      dig_s[x / 64 * DIG_WORDS + (x % 64 < 32 ? x % 64 : x % 64 + N / 4)] = 0u;
    __syncthreads();  // the accumulator, the exponents and the pads are written
  } else {
    stage(0, 0, 0);
  }

  uint32_t part[T][kR];
  int pos[FOLD ? LIMBS : 1][4], neg[FOLD ? LIMBS : 1][4];
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int r = 0; r < kR; ++r) part[t][r] = 0u;
#pragma unroll
  for (int k = 0; k < (FOLD ? LIMBS : 1); ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) pos[k][i] = neg[k][i] = 0;

  for (int g = 0; g < groups; ++g) {
    int a_next[2] = {0, 0};
    if (tid < T) {
      a_next[0] = exponent(g + 1, 0);
      a_next[1] = exponent(g + 1, 1);
    }
    const int* a_now = a_s + (g & 1) * 2 * T;

    if constexpr (FOLD) {
      // Row j's key window and digit plane, into buffer j & 1: its four pattern rows landed in
      // slot R % STAGES (R = g 2L + j counts the rows of the rotation), the slot's (R / STAGES)-th use.
      auto prepare = [&](int j) {
        const int rr = g * 2 * l + j;
        wg8::mbar_wait(staged + rr % STAGES, (rr / STAGES) & 1);
        const uint32_t* st = stage_s + rr % STAGES * 4 * N;
        // 1. the key window, a byte of every limb plane a word: byte y holds
        //    E(k) = sum_v (-1)^floor((k - k_v) / N) G_v[(k - k_v) mod N], k = s0 + CW - 1 - y
        //    (consecutive words on distinct banks; a warp's bytes of a plane are eight words)
        const int k1 = a_now[0], k2 = a_now[1];
        const int k3 = (k1 + k2) & TWO_N_MASK;
        uint8_t* rev = reinterpret_cast<uint8_t*>(ext_s + (j & 1) * KEY_WORDS);
#pragma unroll
        for (int q = 0; q < (4 * FD::REV_WORDS + THREADS - 1) / THREADS; ++q) {
          const int y = q * THREADS + tid;
          if (y < 4 * FD::REV_WORDS) {
            const int yk = sl.s0 + FD::CW - 1 - y + 4 * N;  // k + 4N > 0
            uint32_t sum = 0u;
            auto term = [&](int v, int yv) {
              const uint32_t w = st[v * N + (yv & (N - 1))];
              sum += (yv >> LOG_N) & 1 ? 0u - w : w;
            };
            term(0, yk);
            term(1, yk - k1);
            term(2, yk - k2);
            term(3, yk - k3);
#pragma unroll
            for (int k = 0; k < LIMBS; ++k)
              rev[k * 4 * FD::REV_WORDS + y] = static_cast<uint8_t>(sum >> (8 * (k + nm::kLimbs - LIMBS)));
          }
        }
        // 2. four consecutive digits a thread; the last level of polynomial o zeroes this block's slice
        const int poly = j / l;
        uint32_t* src = acc_s + poly * N;
        const int m = 4 * tid;
        const uint4 own = *reinterpret_cast<const uint4*>(src + m);
        const uint32_t v[4] = {own.x + dec_offset, own.y + dec_offset, own.z + dec_offset, own.w + dec_offset};
        dig_s[(j & 1) * DIG_WORDS + cr::kFoldPad / 4 + tid] =
            cr::digit_bytes(v, 32 - (j % l + 1) * bgbit, digit_mask, half_bg);
        if (poly == o && j % l == l - 1 && static_cast<unsigned>(m - sl.s0) < static_cast<unsigned>(W))
          *reinterpret_cast<uint4*>(src + m) = make_uint4(0u, 0u, 0u, 0u);
      };
      // The rows as a two-stage pipeline, as in the CMUX rotation's fold: row j + 1 is
      // prepared while row j multiplies, one block barrier a row. Once a row is prepared its
      // slot takes the row STAGES further on.
      prepare(0);
      for (int j = 0; j < 2 * l; ++j) {
        __syncthreads();  // row j is prepared; row j - 1's product is done with the buffers of row j + 1
        if (j == 2 * l - 1) cluster_arrive();  // this block no longer reads its copy in this group
        const int ahead = g * 2 * l + j + STAGES;  // into the slot row g 2L + j has left
        if (ahead < groups * 2 * l) stage(ahead / (2 * l), ahead % (2 * l), ahead % STAGES);
        if (j + 1 < 2 * l) prepare(j + 1);
        // 3. pos/neg += digits (x) E
        cr::fold_product<FD, LIMBS>(pos, neg, reinterpret_cast<const uint8_t*>(dig_s + (j & 1) * DIG_WORDS),
                                    ext_s + (j & 1) * KEY_WORDS, fd);
      }
    } else {
      for (int j = 0; j < 2 * l; ++j) {
        const int poly = j / l;
        const int shift = 32 - (j % l + 1) * bgbit;
        const bool last_read_of_slice = poly == o && j % l == l - 1;
        nm::cp_async_wait<0>();
        __syncthreads();  // row j is staged; the accumulator copy is whole; previous row's readers done

        // 1. E_t(k) for k = x + s0 - N - 31: with y = k + 4N - k_v > 0, the sign is
        //    bit LOG_N of y (X^N = -1 and X^{2N} = 1) and the word G_v[y mod N]
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const int k1 = a_now[2 * t], k2 = a_now[2 * t + 1];
          const int k3 = (k1 + k2) & TWO_N_MASK;
          for (int x = tid; x < EXT; x += THREADS) {
            const int y = sl.window_k2n(x) + 2 * N;
            uint32_t sum = 0u;
            auto term = [&](int v, int yv) {
              const uint32_t w = stage_s[v * N + (yv & (N - 1))];
              sum += (yv >> LOG_N) & 1 ? 0u - w : w;
            };
            term(0, y);
            term(1, y - k1);
            term(2, y - k2);
            term(3, y - k3);
            ext_s[t * EXT + x] = sum;
          }
        }

        // 2. digit plane j of Dec(acc); the last level of polynomial o zeroes this block's slice
        for (int x = tid; x < T * N; x += THREADS) {
          const int t = x / N;
          const int m = x & (N - 1);
          uint32_t* src = acc_s + (t * 2 + poly) * N;
          const uint32_t v = src[m] + dec_offset;
          const uint32_t d =
              static_cast<uint32_t>(static_cast<int32_t>((v >> shift) & digit_mask) - half_bg);
          dig_s[t * DIG + m] = d;
          if (m < kLanes) dig_s[t * DIG + N + m] = 0u - d;  // X^N = -1
          if (last_read_of_slice && static_cast<unsigned>(m - sl.s0) < static_cast<unsigned>(W)) src[m] = 0u;
        }
        __syncthreads();
        if (j == 2 * l - 1) cluster_arrive();  // this block no longer reads its copy in this group
        if (j + 1 < 2 * l) {
          stage(g, j + 1, 0);
        } else if (g + 1 < groups) {
          stage(g + 1, 0, 0);
        }

        // 3. part[t] += digits (x) E_t
        cr::window_product<T, SL::S, DIG, EXT>(part, sl.window(ext_s), sl.digits(dig_s));
      }
    }

    // 4. the group's product replaces the accumulator
    if (tid < T) {
      a_s[((g + 1) & 1) * 2 * T + 2 * tid] = a_next[0];
      a_s[((g + 1) & 1) * 2 * T + 2 * tid + 1] = a_next[1];
    }
    if constexpr (FOLD) {
      cr::add_fold_sums<FD, LIMBS>(pos, neg, acc_s + o * N + sl.s0, fd);
    } else {
      cr::add_partial_sums<T, N>(part, acc_s, o, sl.s0 + kR * sl.cgi);
    }
    __syncthreads();
    cluster_wait();  // every peer has read its copy for the last time in this group
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

struct Args {
  const int32_t* b_til;
  const int32_t* a_til;
  const uint32_t* testvec;
  long long tv_stride;
  const uint32_t* bsk_mb;
  uint32_t* out;
  int batch, n0, l, bgbit;
  uint32_t dec_offset;
  cudaStream_t stream;
};

template <int LOG_N, int T>
int launch(const Args& a) {
  constexpr int N = 1 << LOG_N;
  constexpr size_t smem = smem_bytes(N, T);
  if constexpr (T > max_tile(N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    static_assert(smem <= kMaxSmem, "tile does not fit in shared memory");
    auto kern = blind_rotate_mb_kernel<LOG_N, T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.batch + T - 1) / T);
    kern<<<grid, 2 * N / kR, smem, a.stream>>>(a.b_til, a.a_til, a.testvec, a.tv_stride,
                                               a.bsk_mb, a.out, a.batch, a.n0, a.l, a.bgbit,
                                               a.dec_offset);
    return static_cast<int>(cudaGetLastError());
  }
}

// Launch the cluster instance (LIMBS 0: on the CUDA cores; 3 or 4: the fold),
// or (query) only ask how many of its clusters the device can hold at once at
// one block an SM: the count goes to *active.
template <int LOG_N, int T, int CL, int LIMBS = 0>
int launch_cluster(const Args& a, int* active) {
  constexpr int N = 1 << LOG_N;
  if constexpr (!cluster_instance(N, T, CL, LIMBS)) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    constexpr size_t smem = cluster_smem_bytes(N, T, CL, LIMBS);
    static_assert(smem <= kMaxSmem, "tile does not fit in shared memory");
    auto kern = blind_rotate_mb_cluster_kernel<LOG_N, T, CL, LIMBS>;
    const size_t asked = active != nullptr && smem < kExclusiveSmem ? kExclusiveSmem : smem;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(asked));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (CL > 8) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = CL;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t config{};
    config.gridDim = dim3(((a.batch + T - 1) / T) * CL);
    config.blockDim = dim3(2 * N / kR);
    config.dynamicSmemBytes = asked;
    config.stream = a.stream;
    config.attrs = &attr;
    config.numAttrs = 1;
    if (active != nullptr) return static_cast<int>(cudaOccupancyMaxActiveClusters(active, kern, &config));
    err = cudaLaunchKernelEx(&config, kern, a.b_til, a.a_til, a.testvec, a.tv_stride, a.bsk_mb, a.out,
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

// The fold: a tile of one ciphertext on the tensor cores, LIMBS key limbs.
template <int LOG_N, int LIMBS>
int launch_fold(const Args& a, int cluster, int* active) {
  switch (cluster) {
    case 2: return launch_cluster<LOG_N, 1, 2, LIMBS>(a, active);
    case 4: return launch_cluster<LOG_N, 1, 4, LIMBS>(a, active);
    case 8: return launch_cluster<LOG_N, 1, 8, LIMBS>(a, active);
    case 16: return launch_cluster<LOG_N, 1, 16, LIMBS>(a, active);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// limbs 0: the CUDA-core instances; 3 or 4: the fold with that many key limbs.
template <int LOG_N>
int launch_tile(const Args& a, int tile, int cluster, int limbs, int* active) {
  if (limbs != 0) {
    if (tile != 1) return static_cast<int>(cudaErrorInvalidValue);
    return limbs == 3 ? launch_fold<LOG_N, 3>(a, cluster, active) : launch_fold<LOG_N, 4>(a, cluster, active);
  }
  switch (tile) {
    case 1: return launch_instance<LOG_N, 1>(a, cluster, active);
    case 2: return launch_instance<LOG_N, 2>(a, cluster, active);
    case 4: return launch_instance<LOG_N, 4>(a, cluster, active);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One translation unit per ring size (-DTFHE_LOG_N=6..12), as for
// csrc/blind_rotate.cu; the unit compiled with -DTFHE_MAIN also holds the C
// interface and dispatches to the others by ring size.
#ifndef TFHE_LOG_N
#error "compile with -DTFHE_LOG_N=<6..12> (one unit per ring size) and -DTFHE_MAIN for one of them"
#endif
#define TFHE_MB_CAT2(a, b) a##b
#define TFHE_MB_CAT(a, b) TFHE_MB_CAT2(a, b)
#define TFHE_MB_RING_FN(log_n) TFHE_MB_CAT(tfhe_blind_rotate_mb_ring_, log_n)

extern "C" int TFHE_MB_RING_FN(TFHE_LOG_N)(const void* args, int tile, int cluster, int limbs, int* active) {
  return launch_tile<TFHE_LOG_N>(*static_cast<const Args*>(args), tile, cluster, limbs, active);
}

#ifdef TFHE_MAIN

extern "C" {
int tfhe_blind_rotate_mb_ring_6(const void*, int, int, int, int*);
int tfhe_blind_rotate_mb_ring_7(const void*, int, int, int, int*);
int tfhe_blind_rotate_mb_ring_8(const void*, int, int, int, int*);
int tfhe_blind_rotate_mb_ring_9(const void*, int, int, int, int*);
int tfhe_blind_rotate_mb_ring_10(const void*, int, int, int, int*);
int tfhe_blind_rotate_mb_ring_11(const void*, int, int, int, int*);
int tfhe_blind_rotate_mb_ring_12(const void*, int, int, int, int*);
}

namespace {

int dispatch(const Args& a, int log_n, int tile, int cluster, int limbs, int* active) {
  switch (log_n) {
    case 6: return tfhe_blind_rotate_mb_ring_6(&a, tile, cluster, limbs, active);
    case 7: return tfhe_blind_rotate_mb_ring_7(&a, tile, cluster, limbs, active);
    case 8: return tfhe_blind_rotate_mb_ring_8(&a, tile, cluster, limbs, active);
    case 9: return tfhe_blind_rotate_mb_ring_9(&a, tile, cluster, limbs, active);
    case 10: return tfhe_blind_rotate_mb_ring_10(&a, tile, cluster, limbs, active);
    case 11: return tfhe_blind_rotate_mb_ring_11(&a, tile, cluster, limbs, active);
    case 12: return tfhe_blind_rotate_mb_ring_12(&a, tile, cluster, limbs, active);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the multi-bit blind rotation on `stream`: `tile` ciphertexts a
// cluster of `cluster` blocks (1: the single-block instance); `limbs` 0 for
// the CUDA cores, 3 or 4 for the fold with that many key limbs (tile 1; the
// caller has checked the accumulator bound, and for 3 that the key is on the
// 2^8 grid). Returns cudaGetLastError() after the launch (0 on success) or
// cudaErrorInvalidValue for a shape it does not take. Does not synchronise
// and allocates nothing.
int tfhe_blind_rotate_mb(const void* b_til, const void* a_til, const void* testvec,
                         long long tv_stride, const void* bsk_mb, void* out, int batch, int n0,
                         int log_n, int l, int bgbit, unsigned int dec_offset, int tile,
                         int cluster, int limbs, void* stream) {
  if (n0 % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int32_t*>(b_til), static_cast<const int32_t*>(a_til),
               static_cast<const uint32_t*>(testvec), tv_stride,
               static_cast<const uint32_t*>(bsk_mb), static_cast<uint32_t*>(out),
               batch, n0, l, bgbit, dec_offset, static_cast<cudaStream_t>(stream)};
  return dispatch(a, log_n, tile, cluster, limbs, nullptr);
}

// How many clusters of the (tile, cluster >= 2, limbs) instance the current
// device can hold at once at one block an SM (asked with the instance's own
// shared memory, or more than half an SM's where it has less), or -(error code).
int tfhe_blind_rotate_mb_max_active_clusters(int log_n, int tile, int cluster, int limbs) {
  Args a{};
  a.batch = tile;
  int active = 0;
  const int err = dispatch(a, log_n, tile, cluster, limbs, &active);
  return err != 0 ? -err : active;
}

// The largest batch tile of the single-block instance at ring size 2^log_n.
int tfhe_blind_rotate_mb_max_tile(int log_n) { return max_tile(1 << log_n); }

// The largest batch tile of the cluster instance at ring size 2^log_n (its
// tiles are 1, 2 and 4 up to that; its clusters those of
// tfhe_blind_rotate_max_cluster).
int tfhe_blind_rotate_mb_max_cluster_tile(int log_n) {
  return max_cluster(1 << log_n) > 1 ? cluster_max_tile(1 << log_n) : 0;
}

}  // extern "C"

#endif  // TFHE_MAIN
