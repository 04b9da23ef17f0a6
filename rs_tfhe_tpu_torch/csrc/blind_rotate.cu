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
// Design. One thread block owns a tile of T ciphertexts for the whole
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
// so no limb split is needed. The int8 limb split, drop_limbs, byte packing
// and roll chains of the TPU kernels exist for the TPU's int8 matrix unit
// and its vector layout; a reduced-modulus (24-bit) BSK is simply data here.
// Multi-limb digit sets (bgbit > 8) need nothing extra: digits are int32.
//
// Bound. Integer multiply-adds: 2 * 2L * N^2 per step per ciphertext, i.e.
// 8.4 M per step and 5.9 G per gate at SECURITY_128_BIT_FAST (L=2, N=1024,
// n0=700), 12.6 M and 8.8 G at SECURITY_128_BIT (L=3). The card's 32-bit
// IMAD rate, not memory, bounds it: the BSK (22.9 MB at FAST, 34.4 MB at
// strict) fits in the 50 MB L2, and each block reads it once per rotation.
// Per 4 digits the inner loop issues T 16-byte broadcast loads and 4R word
// loads from shared memory for 4*T*R multiply-adds, so at T = 8 the IMAD
// pipe, not shared memory, is the limit. Using the tensor cores (int8 limb
// products, wgmma) and splitting one ciphertext over several blocks for
// batch-1 latency are later work.
//
// Shared memory per block: (3T + 4) * N words — 112 KB at N=1024, T=8.
// Tiles: T <= 8 up to N=1024, T <= 4 at N=2048, T <= 2 at N=4096 (max_tile).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kR = 8;  // output coefficients per thread
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
  if constexpr (T > max_tile(N)) {
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

template <int LOG_N>
int launch_tile(const Args& a, int tile) {
  switch (tile) {
    case 1: return launch<LOG_N, 1>(a);
    case 2: return launch<LOG_N, 2>(a);
    case 4: return launch<LOG_N, 4>(a);
    case 8: return launch<LOG_N, 8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the blind rotation on `stream`; returns cudaGetLastError() after
// the launch (0 on success) or cudaErrorInvalidValue for a shape it does not
// take. Does not synchronise and allocates nothing.
int tfhe_blind_rotate(const void* b_til, const void* a_til, const void* testvec,
                      long long tv_stride, const void* bsk, void* out, int batch, int n0,
                      int log_n, int l, int bgbit, unsigned int dec_offset, int tile,
                      void* stream) {
  const Args a{static_cast<const int32_t*>(b_til), static_cast<const int32_t*>(a_til),
               static_cast<const uint32_t*>(testvec), tv_stride,
               static_cast<const uint32_t*>(bsk), static_cast<uint32_t*>(out),
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
int tfhe_blind_rotate_max_tile(int log_n) { return max_tile(1 << log_n); }

const char* tfhe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
