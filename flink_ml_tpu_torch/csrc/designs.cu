// Other designs of the sparse kernels, for comparison with
// csrc/sparse_kernels.cu on the card: the designs that the shipped kernels
// replaced, and other layouts of the row dot. They are built and run by
// chip_smoke.py (phase 2 times each replaced design beside its successor)
// and scripts/torch_kernel_designs.py only; nothing in the package loads
// them.
//
//   fmt_first_row_dots: the port's first row dot, kept as it was: a warp
//     per row whose lanes take one slot at a time (the gather waits for its
//     idx load, the next load for the gather).
//   fmt_lanes_row_dots: the row dot with `lanes` lanes a row (1 to 32, a
//     power of two, so 32 / lanes rows a warp), each lane `k` slots a pass
//     (2, 4 or 8) with all of their loads and gathers in flight, and an
//     optional grid-stride walk over fewer blocks. lanes = 32, k = 2 and a
//     grid that covers the rows is the layout of sparse_kernels.cu.
//   fmt_red_grad: the port's first gradient, replaced in
//     sparse_kernels.cu by the shared-memory column table: a thread per
//     slot, one atomic add into the zeroed gradient, whose unused result
//     compiles to RED. It runs at the RED probe's floor on uniform indices,
//     and its REDs to a hot column serialise in the L2 on skewed ones.
//     Its plan is the thread-per-slot one (ops/sparsekernels.py
//     `_launch_plan(rows, nnz, grad=True)`).
//   fmt_scalar_fleet_row_dots: the first member-batched row dot, replaced in
//     sparse_kernels.cu by the one that loads member-minor coefficients as
//     float4s: the same layout and arithmetic, with a slot's members always
//     loaded by N scalar __ldg's (a warp-wide gather over 32 sectors each).
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

__global__ void red_grad_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
                                const float* __restrict__ mult, float* __restrict__ grad,
                                int64_t slots, int nnz, int64_t d) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= slots) return;
  const int32_t c = idx[t];
  if (c < 0 || c >= d) return;
  atomicAdd(grad + c, vals[t] * mult[t / nnz]);  // result unused: compiles to RED
}

constexpr int kSlotsPerLane = 2;
constexpr int kMemberTile = 8;

__global__ void scalar_fleet_row_dots_kernel(const int32_t* __restrict__ idx,
                                             const float* __restrict__ vals,
                                             const float* __restrict__ coeff,
                                             float* __restrict__ out, int64_t rows, int nnz,
                                             int64_t d, int members, int64_t ms, int64_t cs) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (row >= rows) return;
  const int32_t* ri = idx + row * nnz;
  const float* rv = vals + row * nnz;
  for (int m0 = 0; m0 < members; m0 += kMemberTile) {
    const int tile = members - m0 < kMemberTile ? members - m0 : kMemberTile;
    const float* tile_coeff = coeff + static_cast<int64_t>(m0) * ms;
    float acc[kMemberTile];
#pragma unroll
    for (int m = 0; m < kMemberTile; ++m) acc[m] = 0.0f;
    for (int j0 = lane; j0 < nnz; j0 += kWarp * kSlotsPerLane) {
      int32_t c[kSlotsPerLane];
      float v[kSlotsPerLane];
      float g[kSlotsPerLane][kMemberTile];
#pragma unroll
      for (int u = 0; u < kSlotsPerLane; ++u) {
        const int j = j0 + u * kWarp;
        c[u] = j < nnz ? ri[j] : -1;
        v[u] = j < nnz ? rv[j] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kSlotsPerLane; ++u) {
        const float* col = tile_coeff + (c[u] < d ? static_cast<int64_t>(c[u]) : d - 1) * cs;
#pragma unroll
        for (int m = 0; m < kMemberTile; ++m) {
          g[u][m] = (c[u] >= 0 && m < tile) ? __ldg(col + m * ms) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kSlotsPerLane; ++u) {
        if (c[u] >= 0) {
#pragma unroll
          for (int m = 0; m < kMemberTile; ++m) acc[m] += v[u] * g[u][m];
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMemberTile; ++m) {
      if (m < tile) {
        float a = acc[m];
#pragma unroll
        for (int offset = kWarp / 2; offset > 0; offset /= 2) {
          a += __shfl_down_sync(0xffffffffu, a, offset);
        }
        if (lane == 0) out[static_cast<int64_t>(m0 + m) * rows + row] = a;
      }
    }
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

// The first gradient: a thread a slot, `grid` blocks of `threads` covering
// the slots.
extern "C" int fmt_red_grad(const void* idx, const void* vals, const void* mult, void* grad,
                            long long rows, int nnz, long long d, int threads, int grid,
                            void* stream) {
  if (rows <= 0 || nnz <= 0) return 0;
  if (d <= 0 || threads <= 0 || threads % kWarp != 0 || grid <= 0 ||
      static_cast<long long>(grid) * threads < rows * nnz) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  red_grad_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(vals),
      static_cast<const float*>(mult), static_cast<float*>(grad), rows * nnz, nnz, d);
  return static_cast<int>(cudaGetLastError());
}

// The first fleet row dot: the row dot's plan (a warp a row) and the (N, d)
// coeff's member and column strides.
extern "C" int fmt_scalar_fleet_row_dots(const void* idx, const void* vals, const void* coeff,
                                         void* out, long long rows, int nnz, long long d,
                                         int members, long long ms, long long cs, int threads,
                                         int grid, void* stream) {
  if (rows <= 0 || nnz <= 0) return 0;
  if (d <= 0 || members <= 0 || ms <= 0 || cs <= 0 || threads <= 0 || threads % kWarp != 0 ||
      grid <= 0 || static_cast<long long>(grid) * (threads / kWarp) < rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  scalar_fleet_row_dots_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(vals),
      static_cast<const float*>(coeff), static_cast<float*>(out), rows, nnz, d, members, ms, cs);
  return static_cast<int>(cudaGetLastError());
}
