// One external-product step: out[f, o] = sum_j d[f, j] (x) t[j, o]  (mod 2^32).
//
// Replaces the TPU kernel fused_external_product (_step_kernel) of
// rs_tfhe_tpu/ops/pallas_step.py, the per-step product behind
// step_impl="pallas" and the tensor-parallel rotation. Inputs are the gadget
// digits int32 [F, 2L, N] (already decomposed, any width) and one step's
// TRGSW as raw torus words int32 [2L, 2, N]; the output is int32 [F, 2, N].
// The TPU kernel takes int8 digits and a limb-split, lane-padded TRGSW for
// its int8 matrix unit; here whole uint32 words are multiplied on the CUDA
// cores and wrap mod 2^32 as the torus does, so neither is needed.
//
// Design: step 3 of csrc/blind_rotate.cu as a kernel of its own. One block
// owns a tile of T rows; thread `tid` owns output polynomial o = tid / (N/8)
// and the R = 8 coefficients c0 + r*(N/8) of all T rows. Per gadget row j the
// block stages t[j] (both output polynomials, negacyclically extended as
// [-p, p]) and the j-th digit plane of the T rows in shared memory, and each
// thread accumulates out[c] += sum_m d_j[m] * ext[c - m + N].
//
// Bound: 2 * 2L * N^2 int32 multiply-adds per row (8.4 M at
// SECURITY_128_BIT_FAST), so the IMAD rate, as in csrc/blind_rotate.cu; a
// rotation through this route adds n0 launches and PyTorch's rotation and
// decomposition between them, each a round trip through device memory.
//
// Shared memory per block: (T + 4) * N words — 48 KB at N=1024, T=8.
// Tiles: T <= 8 up to N=1024, T <= 4 at N=2048, T <= 2 at N=4096 (max_tile).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kR = 8;  // output coefficients per thread
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

constexpr size_t smem_bytes(int n, int tile) {
  return static_cast<size_t>(tile + 4) * n * sizeof(uint32_t);
}

constexpr int max_tile(int n) { return n <= 1024 ? 8 : 8192 / n; }

template <int LOG_N, int T>
__global__ void __launch_bounds__((1 << LOG_N) / 4)
external_product_kernel(const uint32_t* __restrict__ digits,  // [F, 2L, N]
                        const uint32_t* __restrict__ trgsw,   // [2L, 2, N]
                        uint32_t* __restrict__ out,           // [F, 2, N]
                        int rows, int l) {
  constexpr int N = 1 << LOG_N;
  constexpr int THREADS = 2 * N / kR;
  constexpr int H = N / kR;  // threads per output polynomial

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* dig_s = smem;          // [T][N]   one digit plane
  uint32_t* ext_s = dig_s + T * N; // [2][2N]  one TRGSW row as [-p, p]

  const int tid = threadIdx.x;
  const int o = tid / H;
  const int c0 = tid % H;
  const int f0 = blockIdx.x * T;
  const int j_rows = 2 * l;

  uint32_t acc[T][kR];
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[t][r] = 0u;

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

#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int f = f0 + t;
    if (f < rows) {
      uint32_t* dst = out + (static_cast<size_t>(f) * 2 + o) * N;
#pragma unroll
      for (int r = 0; r < kR; ++r) dst[c0 + r * H] = acc[t][r];
    }
  }
}

template <int LOG_N, int T>
int launch(const uint32_t* digits, const uint32_t* trgsw, uint32_t* out, int rows, int l,
           cudaStream_t stream) {
  constexpr int N = 1 << LOG_N;
  constexpr size_t smem = smem_bytes(N, T);
  if constexpr (T > max_tile(N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    static_assert(smem <= kMaxSmem, "tile does not fit in shared memory");
    auto kern = external_product_kernel<LOG_N, T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((rows + T - 1) / T);
    kern<<<grid, 2 * N / kR, smem, stream>>>(digits, trgsw, out, rows, l);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int LOG_N>
int launch_tile(const uint32_t* digits, const uint32_t* trgsw, uint32_t* out, int rows, int l,
                int tile, cudaStream_t stream) {
  switch (tile) {
    case 1: return launch<LOG_N, 1>(digits, trgsw, out, rows, l, stream);
    case 2: return launch<LOG_N, 2>(digits, trgsw, out, rows, l, stream);
    case 4: return launch<LOG_N, 4>(digits, trgsw, out, rows, l, stream);
    case 8: return launch<LOG_N, 8>(digits, trgsw, out, rows, l, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches one external-product step on `stream`; returns cudaGetLastError()
// after the launch (0 on success) or cudaErrorInvalidValue for a shape it
// does not take. Does not synchronise and allocates nothing.
int tfhe_external_product(const void* digits, const void* trgsw, void* out, int rows,
                          int log_n, int l, int tile, void* stream) {
  const auto* d = static_cast<const uint32_t*>(digits);
  const auto* t = static_cast<const uint32_t*>(trgsw);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (log_n) {
    case 6: return launch_tile<6>(d, t, o, rows, l, tile, s);
    case 7: return launch_tile<7>(d, t, o, rows, l, tile, s);
    case 8: return launch_tile<8>(d, t, o, rows, l, tile, s);
    case 9: return launch_tile<9>(d, t, o, rows, l, tile, s);
    case 10: return launch_tile<10>(d, t, o, rows, l, tile, s);
    case 11: return launch_tile<11>(d, t, o, rows, l, tile, s);
    case 12: return launch_tile<12>(d, t, o, rows, l, tile, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The largest row tile the launcher takes at ring size 2^log_n; the
// wrapper picks its tile up to this.
int tfhe_external_product_max_tile(int log_n) { return max_tile(1 << log_n); }

}  // extern "C"
