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
// gadget row: comb_j = sum_v X^{k_v} G_v[j] (4 reads of bsk_mb per
// coefficient, from L2), stored negacyclically extended as [-p, p] in shared
// memory, and then ONE product per group: 2 * 2L * N^2 multiply-adds per
// group per ciphertext, n0/2 groups, i.e. 2.9 G per rotation at
// SECURITY_128_BIT_FAST, half of csrc/blind_rotate.cu's 5.9 G.
//
// One block owns a tile of T ciphertexts for the whole rotation (the TPU's
// sequential grid axis is a loop inside the block). Thread `tid` owns output
// polynomial o = tid / (N/8) and the R = 8 consecutive coefficients
// c = 8*c0 + r (c0 = tid % (N/8)) of all T ciphertexts, and keeps them in
// registers across the groups. Per group:
//   1. the accumulator goes to shared memory; the registers restart at 0;
//   2. per gadget row j: the block builds comb_j of every ciphertext of the
//      tile and the j-th digit plane of Dec(acc) in shared memory;
//   3. each thread accumulates out[c] += sum_m d_j[m] * comb_j[c - m].
// All arithmetic is uint32_t and wraps mod 2^32 as the torus does. A 24-bit
// key (bsk_round_bits) is simply data; digits of any width are int32.
//
// Bound and inner loop. Unlike csrc/blind_rotate.cu, whose ciphertexts share
// one BSK row, every ciphertext here has its own combination, so a loop that
// reads R strided combination words per digit makes one shared-memory load
// per multiply-add and is bound by shared-memory bandwidth (32 words per
// clock per SM, half the IMAD rate). Instead each thread slides a register
// window over its R consecutive outputs: from digit m to m+1 the needed
// words ext[c - m] shift by one, so each digit costs one new combination
// word and one digit word for R multiply-adds. Lane-adjacent threads would
// read words 8 apart (8-way bank conflicts), so each thread starts its digit
// loop at its own offset delta = c0 mod 32: thread c0 reads ext[8*c0 - delta
// - u] at step u, 7 words apart across a warp, conflict-free. Its digits run
// over m' = delta + u in [delta, delta + N); for m' >= N the term
// d[m'-N] * comb[c - m' + N] equals -d[m'-N] * comb[c - m'] (X^N = -1), so
// the digit plane is stored extended by 32 negated digits and the loop needs
// no wrap-around. Splitting one ciphertext over a cluster of blocks for
// batch-1 latency is later work.
//
// Shared memory per block: 7 * T * N + 32 * T words (accumulator 2TN, digit
// plane T(N+32), extended combinations 4TN) — 112 KB at N=1024, T=4. Tiles:
// T <= 4 up to N=1024, T <= 2 at N=2048, T = 1 at N=4096 (max_tile).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kR = 8;  // output coefficients per thread
constexpr int kLanes = 32;  // digit-loop offsets: one per lane of a warp
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

constexpr size_t smem_bytes(int n, int tile) {
  return static_cast<size_t>(7 * tile * n + kLanes * tile) * sizeof(uint32_t) +
         4 * tile * sizeof(int);
}

constexpr int max_tile(int n) { return n <= 1024 ? 4 : 4096 / n; }

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

template <int LOG_N>
int launch_tile(const Args& a, int tile) {
  switch (tile) {
    case 1: return launch<LOG_N, 1>(a);
    case 2: return launch<LOG_N, 2>(a);
    case 4: return launch<LOG_N, 4>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the multi-bit blind rotation on `stream`; returns
// cudaGetLastError() after the launch (0 on success) or
// cudaErrorInvalidValue for a shape it does not take. Does not synchronise
// and allocates nothing.
int tfhe_blind_rotate_mb(const void* b_til, const void* a_til, const void* testvec,
                         long long tv_stride, const void* bsk_mb, void* out, int batch, int n0,
                         int log_n, int l, int bgbit, unsigned int dec_offset, int tile,
                         void* stream) {
  if (n0 % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int32_t*>(b_til), static_cast<const int32_t*>(a_til),
               static_cast<const uint32_t*>(testvec), tv_stride,
               static_cast<const uint32_t*>(bsk_mb), static_cast<uint32_t*>(out),
               batch, n0, l, bgbit, dec_offset, static_cast<cudaStream_t>(stream)};
  switch (log_n) {
    case 6: return launch_tile<6>(a, tile);
    case 7: return launch_tile<7>(a, tile);
    case 8: return launch_tile<8>(a, tile);
    case 9: return launch_tile<9>(a, tile);
    case 10: return launch_tile<10>(a, tile);
    case 11: return launch_tile<11>(a, tile);
    case 12: return launch_tile<12>(a, tile);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The largest batch tile the launcher takes at ring size 2^log_n; the
// wrapper picks its tile up to this.
int tfhe_blind_rotate_mb_max_tile(int log_n) { return max_tile(1 << log_n); }

}  // extern "C"
