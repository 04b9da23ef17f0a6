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
//
// Step 2 has two units. On the CUDA cores (`window_product`: 32-bit
// multiply-adds, any tile, any digit width) or, for a tile of one ciphertext
// with digits of at most 8 bits from N = 1024 up, on the tensor cores
// (`fold_product`, the fold below): the digit plane is then s8 and the key
// window LIMBS reversed byte planes. Steps 1 and 3 and the exchange are the
// same for both.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cooperative_groups.h>

#include "negacyclic_mma.cuh"

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

// ---------------------------------------------------------------------------
// The fold: a tile of one ciphertext multiplied on the tensor cores
// ---------------------------------------------------------------------------
//
// A tile of one ciphertext has no rows for an mma tile to fill, but a block's
// own product has: write its columns c = 128 h + 8 f + e (f < 16, e < 8) and
// the digits m = 8 f + r, and
//
//   out[s0 + 128 h + 8 f + e] = sum_{r < N} A[f][r] * B_h[r][e],
//   A[f][r] = d~[8 f + r],   B_h[r][e] = E(s0 + 128 h + e - r),
//
// with d~ the digit plane extended negacyclically (d~[m + N] = -d[m]). The 16
// rows of an m16n8k32 tile are the digit plane shifted by 8 digits a row; the
// key window is a Toeplitz B operand per n8 tile h, cut as
// csrc/negacyclic_mma.cuh cuts it from per-limb reversed byte planes,
//
//   rev_k[y] = byte_k(E(s0 + CW - 1 - y)),  y < N + CW,  CW = 128 (NT - 1) + 8,
//
// so that B_h[r][e] = rev[CW - 1 - 128 h - e + r]; K stays N, and no
// multiply-add is spent on padding. A digit of -128 has no s8 negation, so
// d~ is never stored: the s8 plane holds d[0 .. N) between kFoldPad zeros on
// each side, A reads it as d~ with the wrapped entries (8 f + r >= N, only in
// the last 128 digits of a row) zero into `pos`, and those last 128 digits
// are multiplied once more with only the wrapped entries, d[8 f + r - N],
// into `neg`; the step adds pos - neg. Each limb sum stays in s32 while
// 2L * N * max|d| * 255 < 2^31 (the wrappers' check), and
// sum_k (pos_k - neg_k) << 8k wraps mod 2^32 as the torus does.
//
// Warps: NT = W / 128 n8 tiles, CL / 2 warps a tile, each owning a slice of
// W digits of every gadget row, so a warp's 16 x 8 sums are s32 registers
// for the whole step and meet their tile's other slices in the shared-memory
// atomics of step 3. A lane's A fragment of rows g and g + 8 at a 64-digit
// chunk is 16 digits at 8 g + 16 t and 64 digits further on: the second is
// the first of the next chunk, so a chunk loads one new fragment, which
// every limb shares.

constexpr int kFoldCols = 128;  // columns of an n8 tile's 16 shifted rows
constexpr int kFoldPad = 128;   // zero digits on each side of the s8 plane

// The shapes the fold takes: W = 2N / CL holds whole 16 x 8 tiles (N >= 1024
// at CL = 16) and a warp's digit slice holds the last 128 digits of a row.
constexpr bool has_fold(int n, int cl) {
  return n >= 1024 && cl >= 2 && cl <= max_cluster(n) && 2 * n / cl >= kFoldCols;
}

template <int LOG_N, int CL, int LIMBS>
struct Fold {
  static constexpr int N = 1 << LOG_N;
  static constexpr int THREADS = 2 * N / kR;
  static constexpr int W = 2 * N / CL;
  static constexpr int NT = W / kFoldCols;            // n8 tiles of 16 shifted rows
  static constexpr int WPT = THREADS / 32 / NT;       // warps a tile (CL / 2)
  static constexpr int KS = N / WPT;                  // digits of a warp's slice (W)
  static constexpr int CW = kFoldCols * (NT - 1) + 8;
  static constexpr int REV_WORDS = (N + CW) / 4;      // words of a limb plane
  static constexpr int QR = (REV_WORDS + THREADS - 1) / THREADS;  // window words a thread stages
  static constexpr int DIG_WORDS = (N + 2 * kFoldPad) / 4;
  static_assert((LIMBS == 3 || LIMBS == 4) && has_fold(N, CL), "fold shape");
  static_assert(NT * WPT * 32 == THREADS && KS % 64 == 0 && KS >= 128 && THREADS * 4 == N, "fold warps");

  int h, ks, g, t;

  __device__ explicit Fold(int tid)
      : h(tid / 32 / WPT), ks(tid / 32 % WPT), g(tid % 32 / 4), t(tid % 4) {}

  // Window word q holds E(lo .. lo + 3) reversed: lo = s0 + CW - 4 - 4q, a
  // multiple of 4 in [-N, N), so the four words share a sign.
  static __device__ int window_lo(int s0, int q) { return s0 + CW - 4 - 4 * q; }
};

// Limb k of a window word from its four key words w = E(lo .. lo + 3):
// bytes k of E(lo + 3), E(lo + 2), E(lo + 1), E(lo), in this order.
__device__ __forceinline__ uint32_t rev_limb_word(const uint4& w, int k) {
  const uint32_t sel = static_cast<uint32_t>(k | ((k + 4) << 4));
  return __byte_perm(__byte_perm(w.w, w.z, sel), __byte_perm(w.y, w.x, sel), 0x5410);
}

// Window word q of every limb plane: the key's low byte is dropped at 3 limbs.
template <int LIMBS, int REV_WORDS>
__device__ __forceinline__ void store_window_word(uint32_t* rev, int q, const uint4& w) {
#pragma unroll
  for (int k = 0; k < LIMBS; ++k) rev[k * REV_WORDS + q] = rev_limb_word(w, k + negacyclic::kLimbs - LIMBS);
}

// 16 s8 digits at an 8-byte aligned byte address of shared memory.
__device__ __forceinline__ uint4 digits16(const uint8_t* p) {
  const uint2 a = *reinterpret_cast<const uint2*>(p), b = *reinterpret_cast<const uint2*>(p + 8);
  return make_uint4(a.x, a.y, b.x, b.y);
}

// One gadget row's product for this warp's tile and digit slice:
// pos[k] += A . B_h over the slice, neg[k] += (wrapped digits) . B_h over the
// row's last 128 digits. dig: the s8 plane (kFoldPad zeros, d, kFoldPad
// zeros); rev: LIMBS planes of REV_WORDS words.
template <class F, int LIMBS>
__device__ __forceinline__ void fold_product(int (&pos)[LIMBS][4], int (&neg)[LIMBS][4], const uint8_t* dig,
                                             const uint32_t* rev, const F& f) {
  constexpr int N = F::N;
  const uint8_t* a = dig + kFoldPad + 8 * f.g + 16 * f.t;  // row g's digit r0 + 16 t at a + r0
  const int y = F::CW - 1 - kFoldCols * f.h - f.g + 16 * f.t;
  const int r_begin = f.ks * F::KS;
  uint4 lo = digits16(a + r_begin);
#pragma unroll 4
  for (int c = 0; c < F::KS / 64; ++c) {
    const int r0 = r_begin + 64 * c;
    const uint4 hi = digits16(a + r0 + 64);  // rows g + 8 here; rows g at the next chunk
    const bool wraps = r0 >= N - 128;        // the last 128 digits of the row: one warp a tile
    uint4 wlo = lo, whi = hi;
    if (wraps) {
      wlo = digits16(a + r0 - N);
      whi = digits16(a + r0 - N + 64);
    }
#pragma unroll
    for (int k = 0; k < LIMBS; ++k) {
      const uint4 b = negacyclic::toeplitz_fragment(rev + k * F::REV_WORDS, y + r0);
      negacyclic::mma_s8_u8(pos[k], lo.x, hi.x, lo.y, hi.y, b.x, b.y);
      negacyclic::mma_s8_u8(pos[k], lo.z, hi.z, lo.w, hi.w, b.z, b.w);
      if (wraps) {
        negacyclic::mma_s8_u8(neg[k], wlo.x, whi.x, wlo.y, whi.y, b.x, b.y);
        negacyclic::mma_s8_u8(neg[k], wlo.z, whi.z, wlo.w, whi.w, b.z, b.w);
      }
    }
    lo = hi;
  }
}

// The fold's counterpart of add_partial_sums: sum_k (pos_k - neg_k) << 8k of
// this warp's 16 x 8 sums into the block's columns of its own copy (`slice`
// = its column s0 of polynomial o), by shared-memory atomics; restart at 0.
template <class F, int LIMBS>
__device__ __forceinline__ void add_fold_sums(int (&pos)[LIMBS][4], int (&neg)[LIMBS][4], uint32_t* slice,
                                              const F& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t v = 0u;
#pragma unroll
    for (int k = 0; k < LIMBS; ++k) {
      v += (static_cast<uint32_t>(pos[k][i]) - static_cast<uint32_t>(neg[k][i]))
           << (8 * (k + negacyclic::kLimbs - LIMBS));
      pos[k][i] = neg[k][i] = 0;
    }
    atomicAdd(slice + kFoldCols * f.h + 8 * (f.g + 8 * (i / 2)) + 2 * f.t + (i & 1), v);
  }
}

// One gadget level's digits of four consecutive coefficients, packed as s8.
__device__ __forceinline__ uint32_t digit_bytes(const uint32_t (&v)[4], int shift, uint32_t mask,
                                                int32_t half_bg) {
  uint32_t word = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    word |= (static_cast<uint32_t>(static_cast<int32_t>((v[e] >> shift) & mask) - half_bg) & 0xFFu) << (8 * e);
  return word;
}

}  // namespace cluster_rotation
