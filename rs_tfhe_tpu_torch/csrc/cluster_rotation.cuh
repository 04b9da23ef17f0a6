// One ciphertext tile's rotation split over a thread-block cluster: the
// __device__ pieces that the cluster instances of csrc/blind_rotate.cu (the
// CMUX rotation) and csrc/blind_rotate_mb.cu (the multi-bit rotation) share.
//
// A cluster of CL blocks owns a tile of T ciphertexts for the whole rotation.
// Every block keeps a full copy of the tile's accumulator [T][2][N] in its
// own shared memory and owns W = 2N / CL output columns of one polynomial:
// block `rank` owns columns [s0, s0 + W) of polynomial o. Per step (a CMUX
// step, or a group of the multi-bit rotation) each block
//   1. decomposes the whole accumulator locally (redundant in every block: 2N
//      element operations against N^2 multiply-adds per column of product)
//      into one digit plane at a time, extended by kLanes negated digits
//      (X^N = -1) so that no digit slice wraps around;
//   2. multiplies the digit plane by its key window: the extended key row
//      E(k), k in [s0 - N - 31, s0 + W), as EXT words of shared memory.
//      Thread (cgi, ks) owns the kR = 8 consecutive columns s0 + 8 cgi + r
//      and the digits m' in [ks * S + delta, (ks + 1) * S + delta) (S = N / CL;
//      delta = cgi mod 32 staggers the lanes 7 words apart), and slides a
//      register window over the key row: one key word and one digit word from
//      shared memory per kR multiply-adds and ciphertext (`window_product`);
//   3. adds its partial sums into its slice of its own copy (shared-memory
//      atomics: the CL digit slices of a column meet there) and pushes the
//      slice into its peers' copies through distributed shared memory with
//      16-byte stores (`push_slice`).
// One exchange a step: a split cluster barrier. A block arrives when it has
// read its copy for the last time in the step, waits before it pushes (the
// wait hides behind the product), and a full arrive-and-wait after the push
// makes the new accumulator visible everywhere.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cooperative_groups.h>

namespace cluster_rotation {

namespace cg = cooperative_groups;

constexpr int kR = 8;            // output columns per thread (the register window)
constexpr int kLanes = 32;       // digit-loop offsets: one per lane of a warp
constexpr int kMaxCluster = 16;  // blocks a cluster (above 8: non-portable size)

// Dynamic shared memory above half an SM's: an occupancy query with this much
// counts the clusters the card holds at one block an SM.
constexpr size_t kExclusiveSmem = 120 * 1024;

// Largest cluster per ring size: a thread's digit slice N / CL is a multiple
// of the 8-word window. Only the ring sizes of the package's parameter sets
// (64, and 1024 up) have cluster instances: every (T, CL) pair is a kernel
// to compile.
constexpr int max_cluster(int n) {
  return n != 64 && n < 1024 ? 1 : n / kR < kMaxCluster ? n / kR : kMaxCluster;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Who does what in a block of the cluster: 2N / kR threads, CG column groups
// of kR columns times CL digit slices.
template <int LOG_N, int CL>
struct Slicing {
  static constexpr int N = 1 << LOG_N;
  static constexpr int THREADS = 2 * N / kR;
  static constexpr int W = 2 * N / CL;        // output columns of a block (one polynomial's)
  static constexpr int CG = W / kR;           // threads along the columns; CL digit slices each
  static constexpr int S = N / CL;            // digits of one slice per digit plane
  static constexpr int DIG = N + kLanes;      // digit plane, extended by kLanes negated digits
  static constexpr int EXT = W + N + kLanes;  // key window: E(k), k in [s0 - N - 31, s0 + W)
  static_assert(S % kR == 0 && CG * CL == THREADS && W <= N, "cluster shape");

  int rank, cgi, ks, delta, o, s0;

  __device__ Slicing(int block_rank, int tid)
      : rank(block_rank),
        cgi(tid % CG),
        ks(tid / CG),
        delta(cgi % kLanes),  // one offset per column group: its CL slices tile [delta, N + delta)
        o(block_rank * W / N),
        s0(block_rank * W % N) {}

  // Window word x holds E(k) for k = x + s0 - N - 31; this is k + 2N (>= 0).
  __device__ int window_k2n(int x) const { return x + s0 + N - (kLanes - 1); }

  // This thread's origin in a key window: e[r - u] = E(s0 + 8 cgi + r - m0 - u),
  // m0 = ks * S + delta its first digit.
  __device__ const uint32_t* window(const uint32_t* ext) const {
    return ext + (N + kLanes - 1) + kR * cgi - (ks * S + delta);
  }

  // This thread's first digit in a digit plane.
  __device__ const uint32_t* digits(const uint32_t* dig) const { return dig + ks * S + delta; }
};

// part[t][r] += sum_{u < S} d[t * DIG + u] * e[t * E_STRIDE + r - u]: the
// sliding register window, win[(r - u) mod kR] = e[r - u], one new key word
// per digit. E_STRIDE 0: one key window for the whole tile (the CMUX rotation,
// whose ciphertexts share a key row); EXT: a window per ciphertext (the
// multi-bit rotation, whose key combination is per ciphertext).
template <int T, int S, int DIG, int E_STRIDE>
__device__ __forceinline__ void window_product(uint32_t (&part)[T][kR], const uint32_t* e,
                                               const uint32_t* d) {
  constexpr int NW = E_STRIDE == 0 ? 1 : T;  // register windows
  uint32_t win[NW][kR];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int r = 1; r < kR; ++r) win[w][r] = e[w * E_STRIDE + r];
  for (int u0 = 0; u0 < S; u0 += kR) {
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int u = u0 + k;
#pragma unroll
      for (int w = 0; w < NW; ++w) win[w][(kR - k) % kR] = e[w * E_STRIDE - u];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const uint32_t dv = d[t * DIG + u];
#pragma unroll
        for (int r = 0; r < kR; ++r) part[t][r] += dv * win[E_STRIDE == 0 ? 0 : t][(r - k + kR) % kR];
      }
    }
  }
}

// The CL digit slices of a column meet in this block's copy: part goes into
// the thread's 8 columns of each ciphertext (shared-memory atomics) and
// restarts at 0.
template <int T, int N>
__device__ __forceinline__ void add_partial_sums(uint32_t (&part)[T][kR], uint32_t* acc_s, int o,
                                                 int col) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      atomicAdd(acc_s + (t * 2 + o) * N + col + r, part[t][r]);
      part[t][r] = 0u;
    }
}

// This block's slice [s0, s0 + W) of polynomial o of every ciphertext of the
// tile, from its own copy into every peer's, as 16-byte stores.
template <int T, int N, int W, int CL, int THREADS>
__device__ __forceinline__ void push_slice(cg::cluster_group& cluster, uint32_t* acc_s, int rank,
                                           int o, int s0, int tid) {
  for (int x = tid; x < T * (W / 4); x += THREADS) {
    const int t = x / (W / 4);
    const int idx = ((t * 2 + o) * N + s0) / 4 + x % (W / 4);
    const uint4 v = reinterpret_cast<const uint4*>(acc_s)[idx];
#pragma unroll
    for (int p = 0; p < CL; ++p)
      if (p != rank) reinterpret_cast<uint4*>(cluster.map_shared_rank(acc_s, p))[idx] = v;
  }
}

}  // namespace cluster_rotation
