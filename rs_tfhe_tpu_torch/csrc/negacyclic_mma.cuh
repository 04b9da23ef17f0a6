// The negacyclic limb product on the tensor cores, as __device__ code shared
// by the kernels that multiply gadget digits by torus polynomials.
//
//   out[f, c] = sum_{j, m} d[f, j, m] * ext_j[c - m + N]        (mod 2^32)
//
// is a GEMM with M = rows f, K = (j, m), N = columns c, whose right operand is
// a negacyclic Toeplitz matrix: entry (m, c) of gadget row j is ext_j[c - m + N]
// of the 2N-word extension ext_j = [-p_j, p_j]. Hopper's tensor cores take no
// 32-bit integers, so each *extended* word is split into its four bytes
// (-p is split as the word -p mod 2^32: the sign never touches a limb), the
// bytes stay unsigned, and
//
//   out = sum_k (S_k << 8k),   S_k = sum_{j, m} d * byte_k(ext)   in s32,
//
// with S_k from mma.sync.aligned.m16n8k32 (s8 digits against u8 limbs) and the
// shifted sum wrapping as the torus does. S_k never overflows while
// 2L * N * max|d| * 255 < 2^31; the wrappers check that from the parameters.
//
// The key operand never leaves shared memory. A block that owns the columns
// [c0, c0 + kColsPerBlock) of one polynomial stages, per gadget row and limb,
// the byte window it needs, REVERSED:
//
//   rev[y] = byte_k(ext_j[c0 + kColsPerBlock - 1 + N - y]),   0 <= y < N + 63,
//
// so that for column c0 + cl and digits m, m + 1, ... the Toeplitz column is
// the ascending bytes rev[63 - cl + m], rev[63 - cl + m + 1], ... A lane's
// B fragment is then 16 contiguous bytes at a byte offset whose alignment
// depends only on cl mod 4: five aligned word loads and four funnel shifts.
// A fragment depends only on the diagonal c - m: a warp whose n8 sub-tiles
// lie 64 columns apart reuses, at digit chunk q, the fragments it loaded at
// chunks q - 1, q - 2, ... for its other sub-tiles, and loads one new
// fragment a chunk and limb (the whole-rotation kernel's tile does).
// As in csrc/probes.cu a dot product does not care in which order k is summed
// if both operands agree, so lane t of a quad takes the 16 contiguous digits
// 16t .. 16t+15 of a 64-digit chunk (one 128-bit load per row) and feeds two
// mma instructions.

#pragma once

#include <cstdint>

namespace negacyclic {

constexpr int kLimbs = 4;           // bytes of a torus word
constexpr int kChunk = 64;          // digits (k-values) per staged chunk
constexpr int kColsPerBlock = 64;   // output columns a block's key window serves
constexpr int kRevPad = 16;         // bytes past the window the word loads may touch

// Bytes of one (gadget row, limb) plane of the reversed key window.
__host__ __device__ constexpr int rev_bytes(int n) { return n + kColsPerBlock + kRevPad; }

__device__ __forceinline__ void mma_s8_u8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* gmem_src, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  const int src_bytes = valid ? 16 : 0;  // 0: the 16 bytes are filled with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Byte k of four words, packed into one word (byte i from w[i]).
__device__ __forceinline__ uint32_t limb_word(const uint32_t (&w)[4], int k) {
  const int s = 8 * k;
  return ((w[0] >> s) & 0xFFu) | (((w[1] >> s) & 0xFFu) << 8) | (((w[2] >> s) & 0xFFu) << 16) |
         (((w[3] >> s) & 0xFFu) << 24);
}

// The 16 bytes at byte offset y0 of a limb plane (4-byte aligned, readable up
// to kRevPad bytes past its window): five aligned word loads, four funnel
// shifts. x, y feed one mma as b0, b1; z, w the next.
__device__ __forceinline__ uint4 toeplitz_fragment(const uint32_t* plane, int y0) {
  const uint32_t* src = plane + (y0 >> 2);
  const int sh = (y0 & 3) * 8;
  const uint32_t q0 = src[0], q1 = src[1], q2 = src[2], q3 = src[3], q4 = src[4];
  return make_uint4(__funnelshift_r(q0, q1, sh), __funnelshift_r(q1, q2, sh),
                    __funnelshift_r(q2, q3, sh), __funnelshift_r(q3, q4, sh));
}

// Stage the reversed byte window of one gadget row of one output polynomial.
// `poly` points at the row's N torus words; `rev` at kLimbs planes of
// rev_bytes(N) bytes (4-byte aligned). Called by all `threads` threads of the
// block with their index `tid`; the caller synchronises afterwards.
template <int N>
__device__ __forceinline__ void stage_rev_window(const uint32_t* __restrict__ poly, int c0,
                                                 uint32_t* rev, int tid, int threads) {
  constexpr int WORDS = rev_bytes(N) / 4;
  for (int q = tid; q < WORDS; q += threads) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int x = c0 + kColsPerBlock - 1 + N - (4 * q + i);  // index into ext = [-p, p]
      uint32_t v = 0u;
      if (x >= 0) {
        const uint32_t p = poly[x & (N - 1)];
        v = x >= N ? p : 0u - p;
      }
      w[i] = v;
    }
#pragma unroll
    for (int k = 0; k < kLimbs; ++k) rev[k * WORDS + q] = limb_word(w, k);
  }
}

// One 64-digit chunk of the limb product for a warp tile of 16*MS rows by
// 8*NS columns, all LIMBS limbs: acc[k][ms][ns] += A(ms) . B_k(ns).
//
//   dig:  the chunk's digits in shared memory, [rows][kChunk] s8, 64 bytes a
//         row; `row0` is the warp's first row;
//   rev:  the gadget row's reversed key window, kLimbs planes of rev_bytes(N);
//   m0:   the chunk's first digit index within the gadget row (multiple of 64);
//   cl0:  the warp's first column within the block's window (multiple of 8).
template <int N, int MS, int NS, int LIMBS>
__device__ __forceinline__ void mma_chunk(int (&acc)[LIMBS][MS][NS][4], const uint4* dig, int row0,
                                          const uint32_t* rev, int m0, int cl0, int lane) {
  constexpr int WORDS = rev_bytes(N) / 4;
  const int g = lane / 4, t = lane % 4;
  uint4 af[MS][2];
#pragma unroll
  for (int ms = 0; ms < MS; ++ms) {
    af[ms][0] = dig[(row0 + 16 * ms + g) * (kChunk / 16) + t];
    af[ms][1] = dig[(row0 + 16 * ms + g + 8) * (kChunk / 16) + t];
  }
#pragma unroll
  for (int ns = 0; ns < NS; ++ns) {
    const int y0 = kColsPerBlock - 1 - (cl0 + 8 * ns + g) + m0 + 16 * t;
#pragma unroll
    for (int k = 0; k < LIMBS; ++k) {
      const uint4 b = toeplitz_fragment(rev + k * WORDS, y0);
#pragma unroll
      for (int ms = 0; ms < MS; ++ms) {
        mma_s8_u8(acc[k][ms][ns], af[ms][0].x, af[ms][1].x, af[ms][0].y, af[ms][1].y, b.x, b.y);
        mma_s8_u8(acc[k][ms][ns], af[ms][0].z, af[ms][1].z, af[ms][0].w, af[ms][1].w, b.z, b.w);
      }
    }
  }
}

// sum_k acc[k] << 8k for one accumulator element: wraps mod 2^32.
template <int LIMBS, int MS, int NS>
__device__ __forceinline__ uint32_t fold_limbs(const int (&acc)[LIMBS][MS][NS][4], int ms, int ns,
                                               int i) {
  uint32_t v = 0u;
#pragma unroll
  for (int k = 0; k < LIMBS; ++k) v += static_cast<uint32_t>(acc[k][ms][ns][i]) << (8 * k);
  return v;
}

}  // namespace negacyclic
