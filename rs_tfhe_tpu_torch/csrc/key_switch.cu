// Key switching for small batches: the key-switching rows the digits select,
// read and summed, and no other row.
//
//   out[b] = (0, ..., 0, body[b]) - sum_{i < n_in, j < t} T[(i*t + j)*base + d_ij(a[b, i])]   (mod 2^32)
//
// or + the sum without a body (a column shard of the tensor-parallel
// rotation adds its shards' sums before it subtracts), with the reference's
// digits d_ij(x) = ((x + 2^(31 - basebit*t)) >> (32 - basebit*(j+1))) & (base-1)
// (trgsw.rs:332-360), logical shifts of the uint32 word. T is the planar limb
// table int8 [n_in*t*base, 4W] exactly as the cloud key holds it
// (key.ksk_limbs_from_rows): column q*W + c holds the balanced limb l_q of
// coefficient c, and the row's word is sum_q l_q 2^(8q) mod 2^32. The digit-0
// rows are read like any other (a proxy re-key table need not zero them).
//
// Replaces no TPU kernel: the JAX package's key switch
// (rs_tfhe_tpu/ops/keyswitch.py:25 digit_select_sum) is a plain XLA product of
// the one-hot digit matrix and the table, and the port keeps that product
// (torch._int_mm, ops/keyswitch.py) as the plain version and as the route above
// KS_SELECT_MAX_BATCH ciphertexts. At a small batch the product reads all
// n_in*t*base rows (103.8 MB at SECURITY_128_BIT_FAST) on a few output tiles;
// a ciphertext selects n_in*t of them (26 MB there, 7.7 us at 3.35 TB/s), and
// a batch at most the whole table once.
//
// Bound: the bytes of the distinct rows the batch selects, read once, over the
// card's memory bandwidth. The design keeps the card's memory busy with them:
//   - A block owns a slice of the n_in*t row groups (i, j) and up to BC = 16
//     ciphertexts. It first works out the digits of its slice and, per group,
//     one task for each distinct digit: the row, and the mask of the block's
//     ciphertexts that selected it. A row is read once however many of the
//     block's ciphertexts select it. Batches above 16 take more blocks on the
//     grid's fastest dimension, so the blocks that share a slice run together
//     and share its rows through L2.
//   - A block is W/4 threads: a thread owns 4 neighbouring columns of every
//     limb plane (four coalesced 4-byte loads a row, streamed with the
//     evict-first hint, so the rows do not push the bootstrapping key out of
//     L2) and walks the block's tasks four rows in flight. The blocks are
//     small so that many fit a SM: the grid's slices make a wave of them (as
//     many as the card holds at once, measured on an H100 within a few per
//     cent of the best split of a block's tasks over more threads).
//   - A 4 x 4 byte transpose (8 PRMT) turns the four planes' bytes into four
//     words of unsigned limbs; word - 2 * (word & 0x00808080) sign-extends the
//     low three limbs mod 2^32 (the top one needs nothing). Wrapping uint32
//     sums of those words equal recombine_planar of the exact limb sums, in any
//     order of the sum.
//   - Each block writes its partial sums; a second small kernel adds them up
//     over the slices and applies the body and the sign. Two kernels a call,
//     no atomics, the same result on every run.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBc = 16;           // ciphertexts a block
constexpr int kInFlight = 4;         // rows a thread has in flight
constexpr int kReduceCols = 32;      // the reduction's columns a block
constexpr int kReduceLanes = 32;     // and its lanes over the slices
constexpr int kMaxThreads = 512;     // threads a block (W/4) at most
constexpr size_t kMaxSmem = 48 * 1024;
constexpr uint32_t kNoDigit = 0xFFFFFFFFu;

// Limbs of columns 4c..4c+3 in the four planes (byte m of p_q: plane q,
// column 4c+m) -> the four columns' words mod 2^32.
__device__ __forceinline__ void planes_to_words(const uint32_t p[4], uint32_t w[4]) {
  const uint32_t t0 = __byte_perm(p[0], p[1], 0x5140);  // p0.b0 p1.b0 p0.b1 p1.b1
  const uint32_t t1 = __byte_perm(p[0], p[1], 0x7362);  // p0.b2 p1.b2 p0.b3 p1.b3
  const uint32_t t2 = __byte_perm(p[2], p[3], 0x5140);
  const uint32_t t3 = __byte_perm(p[2], p[3], 0x7362);
  w[0] = __byte_perm(t0, t2, 0x5410);  // p0.b0 p1.b0 p2.b0 p3.b0
  w[1] = __byte_perm(t0, t2, 0x7632);
  w[2] = __byte_perm(t1, t3, 0x5410);
  w[3] = __byte_perm(t1, t3, 0x7632);
#pragma unroll
  for (int m = 0; m < 4; ++m) w[m] -= (w[m] & 0x00808080u) << 1;
}

// grid (ciphertext chunks of BC, slices of `groups_per_block` groups);
// block W/4 threads. partial: uint32 [slices, batch, W].
template <int BC>
__global__ void __launch_bounds__(kMaxThreads)
key_switch_select_kernel(const uint32_t* __restrict__ a, long long a_stride, int batch, int n_in,
                         const uint32_t* __restrict__ table, int w, int t, int basebit, uint32_t offset,
                         int groups_per_block, uint32_t* __restrict__ partial) {
  extern __shared__ uint32_t smem[];
  const int n_groups = n_in * t;
  const int b0 = blockIdx.x * BC;
  const int g0 = blockIdx.y * groups_per_block;
  const int tasks_a_group = min(BC, 1 << basebit);
  const int slots = tasks_a_group * groups_per_block;
  uint32_t* slot_row = smem;  // [tasks_a_group][groups_per_block]
  uint32_t* slot_mask = slot_row + slots;

  // 1. The block's tasks: per group, its distinct digits in order of first
  //    use, each with the mask of the ciphertexts that chose it.
  for (int gl = threadIdx.x; gl < groups_per_block; gl += blockDim.x) {
    const int g = g0 + gl;
    uint32_t dig[BC];
#pragma unroll
    for (int bl = 0; bl < BC; ++bl) dig[bl] = kNoDigit;
    if (g < n_groups) {
      const int i = g / t;
      const int shift = 32 - basebit * (g - i * t + 1);
#pragma unroll
      for (int bl = 0; bl < BC; ++bl)
        if (b0 + bl < batch)
          dig[bl] = ((a[static_cast<size_t>(b0 + bl) * a_stride + i] + offset) >> shift) & ((1u << basebit) - 1);
    }
    int d = 0;
#pragma unroll
    for (int bl = 0; bl < BC; ++bl) {
      bool first = dig[bl] != kNoDigit;
      uint32_t mask = 0;
#pragma unroll
      for (int b2 = 0; b2 < BC; ++b2) {
        if (b2 < bl) first = first && dig[b2] != dig[bl];
        else if (dig[b2] == dig[bl]) mask |= 1u << b2;
      }
      if (first) {
        slot_row[d * groups_per_block + gl] = (static_cast<uint32_t>(g) << basebit) + dig[bl];
        slot_mask[d * groups_per_block + gl] = mask;
        ++d;
      }
    }
    for (; d < tasks_a_group; ++d) slot_mask[d * groups_per_block + gl] = 0;
  }
  __syncthreads();

  // 2. Each thread sums the tasks' rows into the ciphertexts that chose them.
  const int plane = w >> 2;  // words a limb plane
  const uint32_t* col = table + threadIdx.x;
  uint32_t acc[BC][4];
#pragma unroll
  for (int bl = 0; bl < BC; ++bl)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[bl][m] = 0;
  for (int s0 = 0; s0 < slots; s0 += kInFlight) {
    uint32_t p[kInFlight][4];
    uint32_t mk[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int s = s0 + u;
      mk[u] = s < slots ? slot_mask[s] : 0u;
      const uint32_t* row = col + static_cast<size_t>(mk[u] ? slot_row[s] : 0u) * w;
#pragma unroll
      for (int q = 0; q < 4; ++q) p[u][q] = mk[u] ? __ldcs(row + q * plane) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      uint32_t v[4];
      planes_to_words(p[u], v);
#pragma unroll
      for (int bl = 0; bl < BC; ++bl)
        if ((mk[u] >> bl) & 1u)
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[bl][m] += v[m];
    }
  }

  // 3. This slice's sums, one row of `partial` a ciphertext.
#pragma unroll
  for (int bl = 0; bl < BC; ++bl)
    if (b0 + bl < batch)
      reinterpret_cast<uint4*>(partial + (static_cast<size_t>(blockIdx.y) * batch + b0 + bl) * w)[threadIdx.x] =
          make_uint4(acc[bl][0], acc[bl][1], acc[bl][2], acc[bl][3]);
}

// grid (ceil(out_width / 32), batch); block (32, 32). Sums the slices'
// partial rows; with a body, out = (0, ..., 0, body) - sum, else out = sum.
__global__ void __launch_bounds__(kReduceCols * kReduceLanes)
key_switch_reduce_kernel(const uint32_t* __restrict__ partial, int slices, int batch, int w, int out_width,
                         const uint32_t* __restrict__ body, long long body_stride, uint32_t* __restrict__ out) {
  __shared__ uint32_t red[kReduceLanes][kReduceCols + 1];
  const int c = blockIdx.x * kReduceCols + threadIdx.x;
  const int b = blockIdx.y;
  uint32_t s = 0;
  if (c < out_width) {
#pragma unroll 8
    for (int k = threadIdx.y; k < slices; k += kReduceLanes) s += partial[(static_cast<size_t>(k) * batch + b) * w + c];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || c >= out_width) return;
  for (int r = 1; r < kReduceLanes; ++r) s += red[r][threadIdx.x];
  if (body != nullptr) {
    s = 0u - s;
    if (c == out_width - 1) s += body[static_cast<size_t>(b) * body_stride];
  }
  out[static_cast<size_t>(b) * out_width + c] = s;
}

size_t select_smem_bytes(int bc, int basebit, int groups_per_block) {
  const int tasks_a_group = bc < (1 << basebit) ? bc : (1 << basebit);
  return 2 * static_cast<size_t>(tasks_a_group) * groups_per_block * sizeof(uint32_t);
}

using SelectKernel = void (*)(const uint32_t*, long long, int, int, const uint32_t*, int, int, int, uint32_t, int,
                              uint32_t*);

// The instance of `bc` ciphertexts a block, or null.
SelectKernel select_kernel(int bc) {
  switch (bc) {
    case 1: return key_switch_select_kernel<1>;
    case 2: return key_switch_select_kernel<2>;
    case 4: return key_switch_select_kernel<4>;
    case 8: return key_switch_select_kernel<8>;
    case kMaxBc: return key_switch_select_kernel<kMaxBc>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launches one key switch on `stream` (two kernels); returns
// cudaGetLastError() after the launches (0 on success) or
// cudaErrorInvalidValue for a shape or plan it does not take. Does not
// synchronise and allocates nothing.
//   a: uint32 rows [batch] of n_in mask words, `a_stride` words apart;
//   body: uint32 [batch], `body_stride` words apart, or null for the plain sum;
//   table: the planar limb table int8 [n_in*t*2^basebit, 4w] (4-byte aligned);
//   partial: uint32 scratch [slices, batch, w]; out: uint32 [batch, out_width];
//   offset: 2^(31 - basebit*t), the digits' centring;
//   the plan (ops/cuda_keyswitch.select_plan): bc ciphertexts a block (1, 2, 4,
//   8 or 16), `groups_per_block` row groups a block, `slices` =
//   ceil(n_in*t / groups_per_block).
int tfhe_key_switch(const void* a, long long a_stride, const void* body, long long body_stride, const void* table,
                    void* partial, void* out, int batch, int n_in, int t, int basebit, unsigned offset, int w,
                    int out_width, int bc, int groups_per_block, int slices, void* stream) {
  const long long n_groups = static_cast<long long>(n_in) * t;
  const SelectKernel kern = select_kernel(bc);
  if (kern == nullptr || batch < 1 || batch > 65535 || n_in < 1 || t < 1 || basebit < 1 || basebit * t >= 32 ||
      w < 4 || w % 4 || w / 4 > kMaxThreads || out_width < 1 || out_width > w || groups_per_block < 1 ||
      slices < 1 || slices > 65535 || static_cast<long long>(groups_per_block) * slices < n_groups ||
      (n_groups << basebit) > 0xFFFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = select_smem_bytes(bc, basebit, groups_per_block);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<uint32_t*>(partial);
  kern<<<dim3((batch + bc - 1) / bc, slices), w / 4, smem, s>>>(
      static_cast<const uint32_t*>(a), a_stride, batch, n_in, static_cast<const uint32_t*>(table), w, t, basebit,
      offset, groups_per_block, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  key_switch_reduce_kernel<<<dim3((out_width + kReduceCols - 1) / kReduceCols, batch),
                             dim3(kReduceCols, kReduceLanes), 0, s>>>(
      part, slices, batch, w, out_width, static_cast<const uint32_t*>(body), body_stride,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the selection kernel's instance (bc ciphertexts a block) one SM
// holds at w/4 threads and `smem` bytes of shared memory; the wrapper cuts
// the row groups into a wave of them. Negative: the CUDA error.
int tfhe_key_switch_blocks_per_sm(int bc, int w, int smem) {
  const SelectKernel kern = select_kernel(bc);
  if (kern == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, w / 4, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // extern "C"
