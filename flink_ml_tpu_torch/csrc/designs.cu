// Other designs of the sparse row dot and gradient, for comparison with
// csrc/sparse_kernels.cu on the card. They are built and run by
// scripts/torch_kernel_designs.py only; nothing in the package loads them.
//
//   fmt_first_row_dots: the port's first row dot, kept as it was: a warp
//     per row whose lanes take one slot at a time (the gather waits for its
//     idx load, the next load for the gather).
//   fmt_lanes_row_dots: the row dot with `lanes` lanes a row (1 to 32, a
//     power of two, so 32 / lanes rows a warp), each lane `k` slots a pass
//     (2, 4 or 8) with all of their loads and gathers in flight, and an
//     optional grid-stride walk over fewer blocks. lanes = 32, k = 2 and a
//     grid that covers the rows is the layout of sparse_kernels.cu.
//   fmt_table_grad: a gradient for skewed indices. A block of 256 threads
//     takes a chunk of 1024 consecutive slots, 4 a thread, and keeps a
//     table of 1024 columns in shared memory: a column claims its hashed
//     entry the first time it lands there, later adds to it stay in the
//     block, and the block flushes each claimed entry with one atomic. Hot
//     columns then reach device memory about once a block instead of once
//     a slot. It launches with 8 KB of dynamic shared memory a block.
//
// Same batch layout and index convention as sparse_kernels.cu; each plain C
// entry launches on the given stream and returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;

__global__ void first_row_dots_kernel(const int32_t* __restrict__ idx,
                                      const float* __restrict__ vals,
                                      const float* __restrict__ coeff, float* __restrict__ out,
                                      int64_t rows, int nnz, int64_t d) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x / kWarp);
  if (row >= rows) return;
  const int32_t* row_idx = idx + row * nnz;
  const float* row_vals = vals + row * nnz;
  float acc = 0.0f;
  for (int j = lane; j < nnz; j += kWarp) {
    const int32_t c = row_idx[j];
    if (c >= 0) {
      const int64_t safe = c < d ? static_cast<int64_t>(c) : d - 1;
      acc += row_vals[j] * __ldg(coeff + safe);
    }
  }
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset /= 2) {
    acc += __shfl_down_sync(0xffffffffu, acc, offset);
  }
  if (lane == 0) out[row] = acc;
}

template <int K>
__global__ void lanes_row_dots_kernel(const int32_t* __restrict__ idx,
                                      const float* __restrict__ vals,
                                      const float* __restrict__ coeff, float* __restrict__ out,
                                      int64_t rows, int nnz, int64_t d, int lanes_log2) {
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x % kWarp;
  const int sub = lane & (lanes - 1);
  const int rows_per_warp = kWarp >> lanes_log2;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int64_t step = static_cast<int64_t>(gridDim.x) * (blockDim.x / kWarp) * rows_per_warp;
  // `base` is uniform across a warp, so every lane reaches the shuffles
  for (int64_t base = warp * rows_per_warp; base < rows; base += step) {
    const int64_t row = base + (lane >> lanes_log2);
    const bool live = row < rows;
    const int32_t* ri = idx + row * nnz;
    const float* rv = vals + row * nnz;
    float acc = 0.0f;
    for (int j0 = sub; j0 < nnz; j0 += K * lanes) {
      int32_t c[K];
      float v[K], g[K];
#pragma unroll
      for (int u = 0; u < K; ++u) {
        const int j = j0 + u * lanes;
        const bool in = live && j < nnz;
        c[u] = in ? ri[j] : -1;
        v[u] = in ? rv[j] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < K; ++u) {
        g[u] = c[u] >= 0 ? __ldg(coeff + (c[u] < d ? static_cast<int64_t>(c[u]) : d - 1)) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < K; ++u) {
        if (c[u] >= 0) acc += v[u] * g[u];
      }
    }
    for (int offset = lanes / 2; offset > 0; offset /= 2) {
      acc += __shfl_down_sync(0xffffffffu, acc, offset, lanes);
    }
    if (live && sub == 0) out[row] = acc;
  }
}

constexpr int kSlotThreads = 256;
constexpr int kSlotsPerThread = 4;
constexpr int kChunk = kSlotThreads * kSlotsPerThread;
constexpr int kTableBits = 10;
constexpr int kTableSize = 1 << kTableBits;
constexpr int32_t kEmpty = -1;

// One probe at a hashed entry; a claimed entry keeps its column's adds in
// shared memory, any other column goes straight to device memory.
__device__ __forceinline__ void add_to_grad(int32_t* keys, float* sums, float* __restrict__ grad,
                                            int32_t c, float x) {
  const uint32_t h = (static_cast<uint32_t>(c) * 2654435761u) >> (32 - kTableBits);
  int32_t k = reinterpret_cast<volatile int32_t*>(keys)[h];
  if (k == kEmpty) {
    k = atomicCAS(keys + h, kEmpty, c);
    if (k == kEmpty) k = c;
  }
  if (k == c) {
    atomicAdd(sums + h, x);
    return;
  }
  atomicAdd(grad + c, x);
}

// Block b takes slots [b * kChunk, (b + 1) * kChunk), thread t the slots
// t, t + kSlotThreads, .... Its loads are issued first and are in flight
// while the block resets its table.
__global__ void table_grad_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
                                  const float* __restrict__ mult, float* __restrict__ grad,
                                  int64_t rows, int nnz, int64_t d) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* keys = smem;
  float* sums = reinterpret_cast<float*>(smem + kTableSize);
  const int64_t slots = rows * nnz;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t row0 = first / nnz;  // once a block: no 64-bit division per slot
  const uint32_t rem0 = static_cast<uint32_t>(first - row0 * nnz);
  int32_t c[kSlotsPerThread];
  float v[kSlotsPerThread];
  float m[kSlotsPerThread];
#pragma unroll
  for (int u = 0; u < kSlotsPerThread; ++u) {
    const uint32_t off = u * kSlotThreads + threadIdx.x;
    const bool in = first + off < slots;
    c[u] = in ? idx[first + off] : kEmpty;
    v[u] = in ? vals[first + off] : 0.0f;
    m[u] = in ? __ldg(mult + row0 + (rem0 + off) / static_cast<uint32_t>(nnz)) : 0.0f;
  }
  for (int e = threadIdx.x; e < kTableSize; e += blockDim.x) {
    keys[e] = kEmpty;
    sums[e] = 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kSlotsPerThread; ++u) {
    if (c[u] >= 0 && c[u] < d) add_to_grad(keys, sums, grad, c[u], v[u] * m[u]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTableSize; e += blockDim.x) {
    if (keys[e] != kEmpty) atomicAdd(grad + keys[e], sums[e]);
  }
}

}  // namespace

extern "C" int fmt_first_row_dots(const void* idx, const void* vals, const void* coeff,
                                  void* out, long long rows, int nnz, long long d, void* stream) {
  if (rows <= 0) return 0;
  first_row_dots_kernel<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kWarp * kRowsPerBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(vals),
      static_cast<const float*>(coeff), static_cast<float*>(out), rows, nnz, d);
  return static_cast<int>(cudaGetLastError());
}

// `grid` blocks of 256 threads; fewer than cover the rows walk them.
extern "C" int fmt_lanes_row_dots(const void* idx, const void* vals, const void* coeff,
                                  void* out, long long rows, int nnz, long long d, int k,
                                  int lanes_log2, int grid, void* stream) {
  if (rows <= 0 || nnz <= 0) return 0;
  if (lanes_log2 < 0 || lanes_log2 > 5 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* v = static_cast<const float*>(vals);
  const auto* c = static_cast<const float*>(coeff);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 2: lanes_row_dots_kernel<2><<<grid, 256, 0, s>>>(i, v, c, o, rows, nnz, d, lanes_log2); break;
    case 4: lanes_row_dots_kernel<4><<<grid, 256, 0, s>>>(i, v, c, o, rows, nnz, d, lanes_log2); break;
    case 8: lanes_row_dots_kernel<8><<<grid, 256, 0, s>>>(i, v, c, o, rows, nnz, d, lanes_log2); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fmt_table_grad(const void* idx, const void* vals, const void* mult, void* grad,
                              long long rows, int nnz, long long d, void* stream) {
  const long long slots = rows * nnz;
  if (slots <= 0) return 0;
  table_grad_kernel<<<(slots + kChunk - 1) / kChunk, kSlotThreads, 8 * kTableSize,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(vals),
      static_cast<const float*>(mult), static_cast<float*>(grad), rows, nnz, d);
  return static_cast<int>(cudaGetLastError());
}
