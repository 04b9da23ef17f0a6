// One external-product step: out[f, o] = sum_j d[f, j] (x) t[j, o]  (mod 2^32).
//
// Replaces the TPU kernel fused_external_product (_step_kernel) of
// rs_tfhe_tpu/ops/pallas_step.py, the per-step product behind
// step_impl="pallas" and the tensor-parallel rotation. Inputs are J gadget
// rows of digits int32 [F, J, N] (already decomposed) and the matching rows of
// one step's TRGSW as raw torus words int32 [J, 2, N]; the output is int32
// [F, 2, N]. J is any count from 1 to 2L, as the TPU kernel takes: 2L for the
// per-step rotation, 2L/tp for a shard of the tensor-parallel one.
//
// Two instances, chosen by the wrapper from the parameters:
//
// 1. Tensor cores (single-limb digits, bgbit <= 8). The product is
//    2 * 2L * N^2 multiply-adds of 32-bit words per row; on the CUDA cores the
//    card's int32 rate bounds it 15x above what the tensor cores allow, so the
//    words are split into s8/u8 limbs (csrc/negacyclic_mma.cuh): four u8 limbs
//    of the negacyclically extended key against the s8 digits, always four
//    (the step takes any 32-bit TRGSW, also one that is not on a coarser grid).
//    A pre-pass packs the int32 digits to s8 once (they are then read 2N/64
//    times from L2 at a quarter of the bytes). A block of 8 warps owns 128
//    rows by 64 output columns of one polynomial: the grid splits the 2N
//    columns 2N/64 ways, so a handful of rows still starts 2N/64 blocks. The
//    key never leaves shared memory: the block stages the reversed byte
//    window of its 64 columns for all J gadget rows once ((N + 80) bytes per
//    row and limb, 17 KB at SECURITY_128_BIT_FAST), and only the digits
//    stream, in 64-digit chunks through a four-stage cp.async ring. Warp
//    (wr, wc) owns rows 64 wr .. 64 wr + 63 and columns 16 wc .. 16 wc + 15
//    with all four limb accumulators in registers (128 a thread), so an A
//    fragment serves 8 mma and a B fragment 4, and the limbs fold into the
//    32-bit result in registers.
//    Bound: 4 * 2 * J * N^2 s8 multiply-adds per row against the tensor
//    cores' rate; measured times are in PERF.md.
//
// 2. CUDA cores (digits wider than 8 bits, the SECURITY_UINT sets): whole
//    uint32 words multiplied with wrapping IMADs, step 3 of the earlier
//    csrc/blind_rotate.cu as a kernel of its own. One block owns a tile of T
//    rows; thread `tid` owns output polynomial o = tid / (N/8) and R of the 8
//    coefficients c0 + r*(N/8) of all T rows: the grid's y dimension splits
//    those 8 coefficients CS ways (R = 8 / CS), so few rows fill the card.
//    Per gadget row j the block stages t[j] (both output polynomials,
//    negacyclically extended as [-p, p]) and the j-th digit plane of the T
//    rows in shared memory, and each thread accumulates
//    out[c] += sum_m d_j[m] * ext[c - m + N]. Bound: the IMAD rate.
//    Shared memory per block: (T + 4) * N words. Tiles: T <= 8 up to N=1024,
//    T <= 4 at N=2048, T <= 2 at N=4096 (max_tile).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "negacyclic_mma.cuh"

namespace {

constexpr int kR = 8;  // output coefficients per thread
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

constexpr size_t smem_bytes(int n, int tile) {
  return static_cast<size_t>(tile + 4) * n * sizeof(uint32_t);
}

constexpr int max_tile(int n) { return n <= 1024 ? 8 : 8192 / n; }

template <int LOG_N, int T, int CS>
__global__ void __launch_bounds__((1 << LOG_N) / 4)
external_product_kernel(const uint32_t* __restrict__ digits,  // [F, J, N]
                        const uint32_t* __restrict__ trgsw,   // [J, 2, N]
                        uint32_t* __restrict__ out,           // [F, 2, N]
                        int rows, int j_rows) {
  constexpr int N = 1 << LOG_N;
  constexpr int THREADS = 2 * N / kR;
  constexpr int H = N / kR;   // threads per output polynomial
  constexpr int R = kR / CS;  // coefficients per thread in this block

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* dig_s = smem;          // [T][N]   one digit plane
  uint32_t* ext_s = dig_s + T * N; // [2][2N]  one TRGSW row as [-p, p]

  const int tid = threadIdx.x;
  const int o = tid / H;
  const int c0 = tid % H + blockIdx.y * R * H;  // first of this block's R coefficients
  const int f0 = blockIdx.x * T;

  uint32_t acc[T][R];
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[t][r] = 0u;

  for (int j = 0; j < j_rows; ++j) {
    if (j > 0) __syncthreads();  // previous row's readers done
    const uint32_t* row = trgsw + static_cast<size_t>(j) * 2 * N;
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
      const int f = f0 + t;
      dig_s[x] = f < rows ? digits[(static_cast<size_t>(f) * j_rows + j) * N + m] : 0u;
    }
    __syncthreads();

    // ext[c - m + N] for c = c0 + r*H: the negacyclic TRGSW coefficient at c - m
    const uint32_t* e = ext_s + o * 2 * N + N + c0;
#pragma unroll 2
    for (int m = 0; m < N; m += 4) {
      uint4 d4[T];
#pragma unroll
      for (int t = 0; t < T; ++t) d4[t] = *reinterpret_cast<const uint4*>(dig_s + t * N + m);
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        uint32_t v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = e[r * H - m - mm];
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const uint32_t d = mm == 0 ? d4[t].x : mm == 1 ? d4[t].y : mm == 2 ? d4[t].z : d4[t].w;
#pragma unroll
          for (int r = 0; r < R; ++r) acc[t][r] += d * v[r];
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int f = f0 + t;
    if (f < rows) {
      uint32_t* dst = out + (static_cast<size_t>(f) * 2 + o) * N;
#pragma unroll
      for (int r = 0; r < R; ++r) dst[c0 + r * H] = acc[t][r];
    }
  }
}

template <int LOG_N, int T, int CS>
int launch(const uint32_t* digits, const uint32_t* trgsw, uint32_t* out, int rows, int j_rows,
           cudaStream_t stream) {
  constexpr int N = 1 << LOG_N;
  constexpr size_t smem = smem_bytes(N, T);
  if constexpr (T > max_tile(N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    static_assert(smem <= kMaxSmem, "tile does not fit in shared memory");
    auto kern = external_product_kernel<LOG_N, T, CS>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((rows + T - 1) / T, CS);
    kern<<<grid, 2 * N / kR, smem, stream>>>(digits, trgsw, out, rows, j_rows);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int LOG_N, int CS>
int launch_tile(const uint32_t* digits, const uint32_t* trgsw, uint32_t* out, int rows, int j_rows,
                int tile, cudaStream_t stream) {
  switch (tile) {
    case 1: return launch<LOG_N, 1, CS>(digits, trgsw, out, rows, j_rows, stream);
    case 2: return launch<LOG_N, 2, CS>(digits, trgsw, out, rows, j_rows, stream);
    case 4: return launch<LOG_N, 4, CS>(digits, trgsw, out, rows, j_rows, stream);
    case 8: return launch<LOG_N, 8, CS>(digits, trgsw, out, rows, j_rows, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int LOG_N>
int launch_split(const uint32_t* digits, const uint32_t* trgsw, uint32_t* out, int rows, int j_rows,
                 int tile, int split, cudaStream_t stream) {
  switch (split) {
    case 1: return launch_tile<LOG_N, 1>(digits, trgsw, out, rows, j_rows, tile, stream);
    case kR: return launch_tile<LOG_N, kR>(digits, trgsw, out, rows, j_rows, tile, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core instance
// ---------------------------------------------------------------------------

namespace nm = negacyclic;

constexpr int kMmaThreads = 256;  // 8 warps: 2 (rows) x 4 (columns)
constexpr int kMmaRows = 128;     // rows a block
constexpr int kMmaStages = 4;     // digit chunks in flight
constexpr int kMS = 4;            // m16 sub-tiles a warp (64 rows)
constexpr int kNS = 2;            // n8 sub-tiles a warp (16 columns)

constexpr size_t mma_smem_bytes(int n, int j_rows) {
  return static_cast<size_t>(j_rows) * nm::kLimbs * nm::rev_bytes(n) +
         static_cast<size_t>(kMmaStages) * kMmaRows * nm::kChunk;
}

// digits int32 -> s8, four a thread (single-limb digits fit a byte).
__global__ void pack_digits_s8_kernel(const int4* __restrict__ digits, uint32_t* __restrict__ packed,
                                      long long quads) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  const int4 v = digits[i];
  packed[i] = (static_cast<uint32_t>(v.x) & 0xFFu) | ((static_cast<uint32_t>(v.y) & 0xFFu) << 8) |
              ((static_cast<uint32_t>(v.z) & 0xFFu) << 16) | (static_cast<uint32_t>(v.w) << 24);
}

template <int LOG_N>
__global__ void __launch_bounds__(kMmaThreads, 1)
external_product_mma_kernel(const int8_t* __restrict__ dig8,     // [F, J * N]
                            const uint32_t* __restrict__ trgsw,  // [J, 2, N]
                            uint32_t* __restrict__ out,          // [F, 2, N]
                            int rows, int j_rows) {
  constexpr int N = 1 << LOG_N;
  constexpr int REV_WORDS = nm::rev_bytes(N) / 4;
  constexpr int CHUNKS_PER_ROW = N / nm::kChunk;
  constexpr int STAGE_QUADS = kMmaRows * nm::kChunk / 16;  // 16-byte pieces a stage

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* rev_s = smem;  // [J][4][REV_WORDS]
  uint4* dig_s = reinterpret_cast<uint4*>(rev_s + j_rows * nm::kLimbs * REV_WORDS);  // [stages][128][4]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * nm::kColsPerBlock;  // in [0, 2N)
  const int o = col0 / N;
  const int c0 = col0 % N;
  const int f0 = blockIdx.y * kMmaRows;
  const int k_total = j_rows * N;
  const int chunks = j_rows * CHUNKS_PER_ROW;

  auto fetch = [&](int chunk) {
    if (chunk < chunks) {
      uint4* stage = dig_s + (chunk % kMmaStages) * STAGE_QUADS;
#pragma unroll
      for (int i = 0; i < STAGE_QUADS / kMmaThreads; ++i) {
        const int x = i * kMmaThreads + tid;
        const int r = x / 4, q = x % 4;
        const bool valid = f0 + r < rows;
        const int8_t* src = dig8 + static_cast<size_t>(valid ? f0 + r : 0) * k_total +
                            chunk * nm::kChunk + 16 * q;
        nm::cp_async_16(stage + x, src, valid);
      }
    }
    nm::cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) fetch(s);

  for (int j = 0; j < j_rows; ++j)
    nm::stage_rev_window<N>(trgsw + (static_cast<size_t>(j) * 2 + o) * N, c0,
                            rev_s + j * nm::kLimbs * REV_WORDS, tid, kMmaThreads);

  int acc[nm::kLimbs][kMS][kNS][4];
#pragma unroll
  for (int k = 0; k < nm::kLimbs; ++k)
#pragma unroll
    for (int ms = 0; ms < kMS; ++ms)
#pragma unroll
      for (int ns = 0; ns < kNS; ++ns)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[k][ms][ns][i] = 0;

  const int row0 = (warp / 4) * 16 * kMS;
  const int cl0 = (warp % 4) * 8 * kNS;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    nm::cp_async_wait<kMmaStages - 2>();  // this thread's pieces of `chunk` have landed
    __syncthreads();  // everyone's have (and the key window, first time); chunk - 1 is consumed
    fetch(chunk + kMmaStages - 1);
    const int j = chunk / CHUNKS_PER_ROW;
    const int m0 = (chunk % CHUNKS_PER_ROW) * nm::kChunk;
    nm::mma_chunk<N, kMS, kNS, nm::kLimbs>(acc, dig_s + (chunk % kMmaStages) * STAGE_QUADS, row0,
                                           rev_s + j * nm::kLimbs * REV_WORDS, m0, cl0, lane);
  }

  // c0, c1: row g, columns 2t, 2t+1; c2, c3: row g + 8
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int ms = 0; ms < kMS; ++ms)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + row0 + 16 * ms + g + 8 * h;
      if (f < rows) {
#pragma unroll
        for (int ns = 0; ns < kNS; ++ns) {
          uint2 v;
          v.x = nm::fold_limbs(acc, ms, ns, 2 * h);
          v.y = nm::fold_limbs(acc, ms, ns, 2 * h + 1);
          uint32_t* dst = out + (static_cast<size_t>(f) * 2 + o) * N + c0 + cl0 + 8 * ns + 2 * t;
          *reinterpret_cast<uint2*>(dst) = v;
        }
      }
    }
}

template <int LOG_N>
int launch_mma(const uint32_t* digits, const uint32_t* trgsw, uint32_t* out, int8_t* scratch,
               int rows, int j_rows, cudaStream_t stream) {
  constexpr int N = 1 << LOG_N;
  const size_t smem = mma_smem_bytes(N, j_rows);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long quads = static_cast<long long>(rows) * j_rows * N / 4;
  pack_digits_s8_kernel<<<static_cast<unsigned>((quads + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const int4*>(digits), reinterpret_cast<uint32_t*>(scratch), quads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = external_product_mma_kernel<LOG_N>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(2 * N / nm::kColsPerBlock, (rows + kMmaRows - 1) / kMmaRows);
  kern<<<grid, kMmaThreads, smem, stream>>>(scratch, trgsw, out, rows, j_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches one external-product step on `stream`; returns cudaGetLastError()
// after the launch (0 on success) or cudaErrorInvalidValue for a shape it
// does not take. Does not synchronise and allocates nothing.
//   unit 0: the CUDA-core instance, `tile` rows a block, the thread's 8
//           coefficients split `split` ways (1 or 8) over the grid;
//   unit 1: the tensor-core instance (single-limb digits only; the caller
//           has checked the accumulator bound), 128 rows by 64 columns a
//           block; `scratch` holds rows * J * N bytes for the packed digits.
// `j_rows` is J, the gadget rows of digits and TRGSW (1 <= J <= 2L).
int tfhe_external_product(const void* digits, const void* trgsw, void* out, void* scratch,
                          int rows, int log_n, int j_rows, int unit, int tile, int split,
                          void* stream) {
  if (rows < 1 || j_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* d = static_cast<const uint32_t*>(digits);
  const auto* t = static_cast<const uint32_t*>(trgsw);
  auto* o = static_cast<uint32_t*>(out);
  auto* sc = static_cast<int8_t*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
#define TFHE_STEP_CASE(LOG_N)                                                  \
  case LOG_N:                                                                  \
    return unit == 1 ? launch_mma<LOG_N>(d, t, o, sc, rows, j_rows, s)         \
                     : launch_split<LOG_N>(d, t, o, rows, j_rows, tile, split, s);
  switch (log_n) {
    TFHE_STEP_CASE(6)
    TFHE_STEP_CASE(7)
    TFHE_STEP_CASE(8)
    TFHE_STEP_CASE(9)
    TFHE_STEP_CASE(10)
    TFHE_STEP_CASE(11)
    TFHE_STEP_CASE(12)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TFHE_STEP_CASE
}

// The largest row tile the CUDA-core instance takes at ring size 2^log_n; the
// wrapper picks its tile up to this.
int tfhe_external_product_max_tile(int log_n) { return max_tile(1 << log_n); }

}  // extern "C"
