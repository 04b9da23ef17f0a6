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
//   - integer dot -> int32 (probe_dot, probe_dot_correct_s16): s8 operands go
//     to the tensor cores through mma.sync.aligned.m16n8k32 (the limb product
//     the TPU kernels are built on); Hopper's tensor cores have no s16 or s32
//     integer type, so those run as int32 multiply-adds on the CUDA cores and
//     wrap mod 2^32;
//   - roll (probe_roll): an indexed shared-memory read, for 1-, 2- and 4-byte
//     elements alike (the TPU could only rotate 32-bit lanes, which is why
//     its kernels pack limbs into words);
//   - bitcast and the two-s16 unpack (probe_bitcast_i32_to_i8,
//     probe_unpack_s16): shifts on registers;
//   - chained s8 dots (bench_dot): reps dependent products in one launch, each
//     lhs rebuilt from the previous accumulator, on the tensor cores or (the
//     same chain) on the CUDA cores, with the cycles spent inside the tile
//     loop reported beside the result;
//   - chained roll+add (bench_roll_add): x += roll(x, 1 + i) in shared memory.
//
// Bounds: the dots are bound by operations (2 M K N integer operations against
// M K + K N + 4 M N bytes), the element-wise kernels by bytes. Nothing here is
// tuned: 64 x 64 tiles, two warps a block, operands staged through shared
// memory without a pipeline; occupancy hides the latency.
//
// s8 tensor-core tile. A block of 64 threads owns a 64 x 64 tile of the
// output; warp w owns rows 32w .. 32w+31 (two m16 sub-tiles) and all eight n8
// sub-tiles. A and B^T are staged in chunks of 64 k-values, 64 bytes a row.
// The fragment layout of mma.m16n8k32 gives lane (g = lane / 4, t = lane % 4)
// the k-columns 4t..4t+3 and 16+4t..16+4t+3 of rows g and g+8 of A, and the
// same k-rows of column g of B. A dot product does not care in which order k
// is summed, as long as A and B agree, so lane t instead takes the 16
// contiguous bytes 16t..16t+15 of its rows (one 128-bit load each): words 0, 1
// feed one mma, words 2, 3 the next.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output tile edge of both dot kernels
constexpr int kDotThreads = 64;
constexpr int kDotBlocksPerSm = 6;  // caps the dot kernels at 170 registers: 12 warps an SM
constexpr int kChunkS8 = 64;   // k-values per staged chunk, tensor-core tile
constexpr int kChunkImad = 16; // k-values per staged chunk, CUDA-core tile
constexpr int kAStride = kChunkImad + 1;  // padded: no bank conflicts on the row reads
constexpr int kMaxDepK = 4096; // k of the column-parity table of the chained dot

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t a0, const uint32_t a1,
                                       const uint32_t a2, const uint32_t a3, const uint32_t b0,
                                       const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Both tiles stage a chunk of k through registers: the next chunk's global
// loads are issued before the current chunk's arithmetic and stored to
// shared memory after it, so their latency hides behind the multiply-adds.

// out[row0.., col0..] = a[m, k] . bt[n, k]^T on the tensor cores, one 64 x 64
// tile. k is a multiple of 16 (the staging moves 16 bytes at a time); rows
// and columns past m and n read as 0 and are not stored. smem: 2 * 64 * 64
// bytes, 16-byte aligned.
__device__ __forceinline__ void mma_tile_s8(const int8_t* a, const int8_t* bt, int32_t* out, int m,
                                            int k, int n, int row0, int col0, uint4* smem) {
  uint4* as = smem;                          // [64 rows][4 x 16 bytes]
  uint4* bs = smem + kTile * kChunkS8 / 16;  // [64 cols][4 x 16 bytes]
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  int acc[2][8][4];
#pragma unroll
  for (int ms = 0; ms < 2; ++ms)
#pragma unroll
    for (int ns = 0; ns < 8; ++ns)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[ms][ns][i] = 0;

  // 64 rows x 4 quads of A and of B^T a chunk: 512 16-byte moves, 8 a thread
  uint4 ra[4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int x = i * kDotThreads + tid;
      const int r = x / 4, kk = k0 + (x % 4) * 16;
      ra[i] = rb[i] = make_uint4(0u, 0u, 0u, 0u);
      if (kk < k && row0 + r < m)
        ra[i] = *reinterpret_cast<const uint4*>(a + static_cast<size_t>(row0 + r) * k + kk);
      if (kk < k && col0 + r < n)
        rb[i] = *reinterpret_cast<const uint4*>(bt + static_cast<size_t>(col0 + r) * k + kk);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < k; k0 += kChunkS8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      as[i * kDotThreads + tid] = ra[i];
      bs[i * kDotThreads + tid] = rb[i];
    }
    __syncthreads();
    if (k0 + kChunkS8 < k) fetch(k0 + kChunkS8);
    uint4 af[2][2];
#pragma unroll
    for (int ms = 0; ms < 2; ++ms) {
      af[ms][0] = as[(warp * 32 + ms * 16 + g) * 4 + t];
      af[ms][1] = as[(warp * 32 + ms * 16 + g + 8) * 4 + t];
    }
#pragma unroll
    for (int ns = 0; ns < 8; ++ns) {
      const uint4 bf = bs[(ns * 8 + g) * 4 + t];
#pragma unroll
      for (int ms = 0; ms < 2; ++ms) {
        mma_s8(acc[ms][ns], af[ms][0].x, af[ms][1].x, af[ms][0].y, af[ms][1].y, bf.x, bf.y);
        mma_s8(acc[ms][ns], af[ms][0].z, af[ms][1].z, af[ms][0].w, af[ms][1].w, bf.z, bf.w);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int ms = 0; ms < 2; ++ms)
#pragma unroll
    for (int ns = 0; ns < 8; ++ns)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + warp * 32 + ms * 16 + g + (i / 2) * 8;
        const int c = col0 + ns * 8 + t * 2 + (i % 2);
        if (r < m && c < n) out[static_cast<size_t>(r) * n + c] = acc[ms][ns][i];
      }
}

// The same tile on the CUDA cores, for 1-, 2- and 4-byte signed operands:
// sign-extended int32 multiply-adds that wrap mod 2^32. Thread (ty, tx) of
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

constexpr size_t kDotSmemWords = kTile * kAStride + kChunkImad * kTile;  // 2112 words >= 2 * 4096 bytes
static_assert(kDotSmemWords * 4 >= 2 * kTile * kChunkS8, "one buffer serves both tiles");

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

__global__ void __launch_bounds__(kDotThreads, kDotBlocksPerSm)
dot_mma_s8_kernel(const int8_t* a, const int8_t* bt, int32_t* out, int m, int k, int n) {
  __shared__ __align__(16) uint32_t smem[kDotSmemWords];
  mma_tile_s8(a, bt, out, m, k, n, blockIdx.y * kTile, blockIdx.x * kTile,
              reinterpret_cast<uint4*>(smem));
}

template <typename T>
__global__ void __launch_bounds__(kDotThreads, kDotBlocksPerSm)
dot_imad_kernel(const T* a, const T* b, int32_t* out, int m, int k, int n) {
  __shared__ __align__(16) uint32_t smem[kDotSmemWords];
  imad_tile<T>(a, b, out, m, k, n, blockIdx.y * kTile, blockIdx.x * kTile, smem);
}

// out[r, c] = in[r, (c - shift) mod cols]: each row through shared memory.
template <typename T>
__global__ void roll_kernel(const T* __restrict__ in, T* __restrict__ out, int cols, int shift) {
  extern __shared__ __align__(16) unsigned char roll_smem[];
  T* row = reinterpret_cast<T*>(roll_smem);
  const T* src = in + static_cast<size_t>(blockIdx.x) * cols;
  T* dst = out + static_cast<size_t>(blockIdx.x) * cols;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) row[c] = src[c];
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    int s = c - shift;
    if (s < 0) s += cols;
    dst[c] = row[s];
  }
}

// Each int32 word as its four bytes, least significant first.
__global__ void bitcast_i32_to_i8_kernel(const uint32_t* __restrict__ in, char4* __restrict__ out,
                                         long long count) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const uint32_t w = in[i];
  out[i] = make_char4(static_cast<signed char>(w), static_cast<signed char>(w >> 8),
                      static_cast<signed char>(w >> 16), static_cast<signed char>(w >> 24));
}

// The two sign-extended 16-bit halves of each word, by shifts.
__global__ void unpack_s16_kernel(const int32_t* __restrict__ in, int16_t* __restrict__ lo,
                                  int16_t* __restrict__ hi, long long count) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int32_t w = in[i];
  lo[i] = static_cast<int16_t>(static_cast<int32_t>(static_cast<uint32_t>(w) << 16) >> 16);
  hi[i] = static_cast<int16_t>(w >> 16);
}

// All blocks of a cooperative launch meet here. `counter` only grows:
// the n-th barrier waits for n * gridDim.x arrivals.
__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (*reinterpret_cast<volatile unsigned*>(counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The feedback term of bench_dot: the first k columns of acc plus the parity
// of its last column where n >= k, else acc repeated k / n times.
__device__ __forceinline__ int32_t feedback(const int32_t* acc, int i, int c, int k, int n) {
  const int32_t* row = acc + static_cast<size_t>(i) * n;
  if (n < k) return row[c % n];
  return static_cast<int32_t>(static_cast<uint32_t>(row[c]) + static_cast<uint32_t>(row[n - 1] & 1));
}

// A chain of `steps` dependent s8 dots. Step s:
//   a_cur = int8(a0 + (dep & 1)),  dep = the feedback of step s-1 (0 at s = 0):
//           row i of the feedback, or, where `big`, the sum of its 8 rows;
//   acc   = a_cur . b              (TENSOR: mma.sync s8; else int32 multiply-adds)
// and after the last step fb = feedback(acc)[0:fm]. All blocks are resident
// (cooperative launch) and meet at a barrier after each phase. stats[0]
// takes the largest per-block sum of cycles spent in the tile loop and
// stats[1 + smid] counts the tiles each SM ran, over all steps.
template <bool TENSOR>
__global__ void __launch_bounds__(kDotThreads, kDotBlocksPerSm)
chain_dot_kernel(const int8_t* __restrict__ a0, const int8_t* __restrict__ b, int8_t* bt,
                 int8_t* a_cur, int32_t* acc, int32_t* fb, int m, int k, int n, int fm, int big,
                 int steps, unsigned* barrier, unsigned long long* stats) {
  __shared__ __align__(16) uint32_t smem[kDotSmemWords];
  __shared__ int8_t dep_s[kMaxDepK];
  const int tid = threadIdx.x;
  const long long gtid = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  const long long gthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  const int tiles_n = (n + kTile - 1) / kTile;
  const int tiles = tiles_n * ((m + kTile - 1) / kTile);
  unsigned target = 0;
  unsigned long long busy = 0;

  if (TENSOR) {
    for (long long x = gtid; x < static_cast<long long>(k) * n; x += gthreads)
      bt[(x % n) * k + x / n] = b[x];
  }
  for (int s = 0; s < steps; ++s) {
    if (big && s > 0) {
      for (int c = tid; c < k; c += blockDim.x) {
        uint32_t sum = 0u;
        for (int i = 0; i < fm; ++i) sum += static_cast<uint32_t>(feedback(acc, i, c, k, n));
        dep_s[c] = static_cast<int8_t>(sum & 1);
      }
      __syncthreads();
    }
    for (long long x = gtid; x < static_cast<long long>(m) * k; x += gthreads) {
      const int i = static_cast<int>(x / k), c = static_cast<int>(x % k);
      int32_t dep = 0;
      if (s > 0) dep = big ? dep_s[c] : feedback(acc, i, c, k, n) & 1;
      a_cur[x] = static_cast<int8_t>(a0[x] + dep);
    }
    grid_barrier(barrier, target);
    const long long t0 = clock64();
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = (tile / tiles_n) * kTile, col0 = (tile % tiles_n) * kTile;
      if (TENSOR)
        mma_tile_s8(a_cur, bt, acc, m, k, n, row0, col0, reinterpret_cast<uint4*>(smem));
      else
        imad_tile<int8_t>(a_cur, b, acc, m, k, n, row0, col0, smem);
    }
    busy += static_cast<unsigned long long>(clock64() - t0);
    grid_barrier(barrier, target);
  }
  for (long long x = gtid; x < static_cast<long long>(fm) * k; x += gthreads)
    fb[x] = steps > 0 ? feedback(acc, static_cast<int>(x / k), static_cast<int>(x % k), k, n) : 0;
  if (tid == 0) {
    atomicMax(stats, busy);
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    const unsigned long long mine =
        blockIdx.x < tiles ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
    atomicAdd(stats + 1 + smid, mine * static_cast<unsigned long long>(steps));
  }
}

// x += roll(x, 1 + i) for i < 16, `reps` times, each row in shared memory.
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

template <typename T>
int launch_dot_imad(const void* a, const void* b, void* out, int m, int k, int n, cudaStream_t s) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  dot_imad_kernel<T><<<grid, kDotThreads, 0, s>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                                   static_cast<int32_t*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_roll(const void* in, void* out, int rows, int cols, int shift, cudaStream_t s) {
  roll_kernel<T><<<rows, row_threads(cols), static_cast<size_t>(cols) * sizeof(T), s>>>(
      static_cast<const T*>(in), static_cast<T*>(out), cols, shift);
  return static_cast<int>(cudaGetLastError());
}

template <bool TENSOR>
int launch_chain(const void* a0, const void* b, void* bt, void* a_cur, void* acc, void* fb, int m,
                 int k, int n, int fm, int big, int steps, void* barrier, void* stats, int* grid_out,
                 cudaStream_t s) {
  auto kern = chain_dot_kernel<TENSOR>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kDotThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  // every SM gets a block (the lhs is rebuilt by all of them); more only for more tiles
  const int tiles = ((n + kTile - 1) / kTile) * ((m + kTile - 1) / kTile);
  int grid = tiles > sms ? tiles : sms;
  if (grid > per_sm * sms) grid = per_sm * sms;
  *grid_out = grid;
  void* args[] = {&a0, &b, &bt, &a_cur, &acc, &fb, &m, &k, &n, &fm, &big, &steps, &barrier, &stats};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(grid), dim3(kDotThreads),
                                    args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every function launches on `stream`, returns cudaGetLastError() after the
// launch (0 on success) or cudaErrorInvalidValue for an argument it does not
// take, does not synchronise and allocates nothing.

// out int32 [m, n] = a int8 [m, k] . b int8 [k, n] on the tensor cores;
// bt is scratch, int8 [n, k]. k must be a multiple of 16.
int tfhe_probe_dot_s8(const void* a, const void* b, void* bt, void* out, int m, int k, int n,
                      void* stream) {
  if (m < 1 || n < 1 || k < 16 || k % 16) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 tgrid((n + 31) / 32, (k + 31) / 32);
  transpose_s8_kernel<<<tgrid, dim3(32, 8), 0, s>>>(static_cast<const int8_t*>(b),
                                                    static_cast<int8_t*>(bt), k, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  dot_mma_s8_kernel<<<grid, kDotThreads, 0, s>>>(static_cast<const int8_t*>(a),
                                                 static_cast<const int8_t*>(bt),
                                                 static_cast<int32_t*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

// The same product by int32 multiply-adds, for operands of 1, 2 or 4 bytes.
int tfhe_probe_dot_imad(const void* a, const void* b, void* out, int m, int k, int n,
                        int elem_bytes, void* stream) {
  if (m < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_dot_imad<int8_t>(a, b, out, m, k, n, s);
    case 2: return launch_dot_imad<int16_t>(a, b, out, m, k, n, s);
    case 4: return launch_dot_imad<int32_t>(a, b, out, m, k, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[r, c] = in[r, (c - shift) mod cols], 0 <= shift < cols, elements of 1, 2
// or 4 bytes; a row must fit the 48 KB of static-limit shared memory.
int tfhe_probe_roll(const void* in, void* out, int rows, int cols, int shift, int elem_bytes,
                    void* stream) {
  if (rows < 1 || cols < 1 || shift < 0 || shift >= cols ||
      static_cast<size_t>(cols) * elem_bytes > 49152)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_roll<int8_t>(in, out, rows, cols, shift, s);
    case 2: return launch_roll<int16_t>(in, out, rows, cols, shift, s);
    case 4: return launch_roll<int32_t>(in, out, rows, cols, shift, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out int8 [4 * count]: the bytes of in int32 [count], least significant first.
int tfhe_probe_bitcast_i32_to_i8(const void* in, void* out, long long count, void* stream) {
  if (count < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((count + 255) / 256);
  bitcast_i32_to_i8_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<char4*>(out), count);
  return static_cast<int>(cudaGetLastError());
}

// lo, hi int16 [count]: the sign-extended halves of in int32 [count].
int tfhe_probe_unpack_s16(const void* in, void* lo, void* hi, long long count, void* stream) {
  if (count < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((count + 255) / 256);
  unpack_s16_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(in), static_cast<int16_t*>(lo), static_cast<int16_t*>(hi), count);
  return static_cast<int>(cudaGetLastError());
}

// The chained dot (chain_dot_kernel). a0 int8 [m, k], b int8 [k, n]; scratch
// bt int8 [n, k] and a_cur int8 [m, k]; outputs acc int32 [m, n] and fb int32
// [fm, k]; barrier: one zeroed uint32; stats: 1 + 1024 zeroed uint64.
// tensor != 0 takes the tensor cores (k a multiple of 16), else the CUDA
// cores. *grid_out receives the number of blocks launched.
int tfhe_probe_chain_dot(const void* a0, const void* b, void* bt, void* a_cur, void* acc, void* fb,
                         int m, int k, int n, int fm, int big, int steps, int tensor,
                         void* barrier, void* stats, int* grid_out, void* stream) {
  const bool folds = n >= k || k % n == 0;
  if (m < 1 || n < 1 || k < 1 || fm < 1 || fm > m || steps < 0 || !folds ||
      (big && k > kMaxDepK) || (tensor && k % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return tensor ? launch_chain<true>(a0, b, bt, a_cur, acc, fb, m, k, n, fm, big, steps, barrier,
                                     stats, grid_out, s)
                : launch_chain<false>(a0, b, bt, a_cur, acc, fb, m, k, n, fm, big, steps, barrier,
                                      stats, grid_out, s);
}

// out int32 [rows, cols] = in after reps * 16 steps of x += roll(x, 1 + i).
int tfhe_probe_roll_add(const void* in, void* out, int rows, int cols, int reps, void* stream) {
  if (rows < 1 || cols < 1 || reps < 0 || static_cast<size_t>(cols) * 8 > 49152)
    return static_cast<int>(cudaErrorInvalidValue);
  roll_add_chain_kernel<<<rows, row_threads(cols), static_cast<size_t>(cols) * 8,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(in), static_cast<int32_t*>(out), cols, reps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
