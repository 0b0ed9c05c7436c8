// Hand-written Hopper (sm_90a) kernels for the sparse padded-CSR path of
// LogisticRegression and the other SGD-trained linear models.
//
// Layout: a batch is `idx` (rows, nnz) int32 with -1 padding and `vals`
// (rows, nnz) float32, both row-major and contiguous, so the batch is one
// run of rows * nnz slots. `d` is the model width. Both kernels keep the
// JAX package's index convention:
//   - padding (idx < 0) contributes nothing;
//   - an index >= d is CLAMPED to d-1 in the row dot (a clamping gather)
//     and DROPPED in the gradient (a scatter with mode="drop").
//
// sparse_row_dots replaces flink_ml_tpu/ops/sparsekernels.py:sparse_row_dots
// (Pallas body _dot_kernel):
//     out[i] = sum_j [idx[i,j] >= 0] * vals[i,j] * coeff[min(idx[i,j], d-1)]
// sparse_grad replaces flink_ml_tpu/ops/sparsekernels.py:sparse_grad
// (Pallas body _grad_kernel):
//     g[c] = sum over (i, j) with idx[i,j] = c, 0 <= c < d, of vals[i,j] * mult[i]
//
// What bounds them. Each slot streams 8 bytes of idx+vals from device
// memory once (31 MB, 9.3 us at 3.35 TB/s, at the fit batch of
// 100,000 x 39). Each slot also makes one random 4-byte access to a (d,)
// vector: a gather of coeff in the dot, an atomic add into g in the
// gradient. At d = 1e6 that vector (4 MB) stays in the 50 MB L2, but each
// access moves a whole 32-byte sector between L2 and an SM, and the L2's
// rate of such accesses, not HBM, is the floor: the probes in
// csrc/probes.cu (a gather per slot; an atomic add per slot) take 3 to 5
// times the HBM bound on the H100. So each design keeps the random
// accesses flowing and adds as little else to the L2 as it can.
//
// sparse_row_dots: a warp per row, lanes on neighbouring slots, so a warp's
// loads of idx and vals are contiguous, and a shuffle tree over the lanes.
// A lane takes kSlotsPerLane slots a pass (j = lane, lane + 32, ...) and
// issues all of their idx and vals loads before any gather, then all of
// their gathers (__ldg, through L1, which keeps hot coefficients of skewed
// indices) before it adds: at nnz = 39 a row is one pass with both of a
// lane's gathers in flight, where a loop of one slot at a time waits for
// each. The lanes add in slot order and the tree has a fixed shape, so the
// result is deterministic. The grid covers the batch, a warp per row
// (rows per block from the launch plan). scripts/torch_kernel_designs.py
// times this layout against fewer lanes a row, more slots a lane and a
// grid-stride walk, and against the port's first kernels (PERF.md).
//
// sparse_grad: one thread per slot, an atomic add into g, which the caller
// zeroes. Neighbouring threads read neighbouring slots, so loads coalesce.
// The add's result is unused, so it compiles to RED, which returns nothing:
// many are in flight at once, and a uniform batch runs at the floor of the
// atomic probe. Under skewed (Zipf-like) indices the hottest column takes
// about 12% of all slots and its atomics serialise in the L2; a block-wide
// table of columns in shared memory removes that (designs.cu,
// fmt_table_grad) but costs uniform batches a little, so this kernel stays
// until a skewed workload is measured (PERF.md, ROADMAP B.3).
//
// The launch plan (threads and grid) comes from
// ops/sparsekernels.py (_launch_plan), which the CPU tests check. The
// gradient's additions land in an order that changes from run to run, so
// it agrees with the row-major reference only to a tolerance (exactly,
// when every partial sum is representable); the ordered sort-and-segment
// variant is a ROADMAP item.
//
// Interface: plain C, for ctypes. Each entry launches on the given stream,
// does not synchronise, allocates nothing, and returns a cudaError_t
// (0 on success). The caller zeroes the gradient. Empty batches launch
// nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
// The row dot: slots a lane takes a pass, all in flight at once.
constexpr int kSlotsPerLane = 2;

// ---- sparse_row_dots -------------------------------------------------

__global__ void row_dots_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
                                const float* __restrict__ coeff, float* __restrict__ out,
                                int64_t rows, int nnz, int64_t d) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  // `row` is uniform across a warp, so whole warps leave together and the
  // full-mask shuffles below see all 32 lanes.
  if (row >= rows) return;
  const int32_t* ri = idx + row * nnz;
  const float* rv = vals + row * nnz;
  float acc = 0.0f;
  for (int j0 = lane; j0 < nnz; j0 += kWarp * kSlotsPerLane) {
    int32_t c[kSlotsPerLane];
    float v[kSlotsPerLane];
    float g[kSlotsPerLane];
#pragma unroll
    for (int u = 0; u < kSlotsPerLane; ++u) {
      const int j = j0 + u * kWarp;
      c[u] = j < nnz ? ri[j] : -1;
      v[u] = j < nnz ? rv[j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kSlotsPerLane; ++u) {
      g[u] = c[u] >= 0 ? __ldg(coeff + (c[u] < d ? static_cast<int64_t>(c[u]) : d - 1)) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kSlotsPerLane; ++u) {
      if (c[u] >= 0) acc += v[u] * g[u];
    }
  }
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset /= 2) {
    acc += __shfl_down_sync(0xffffffffu, acc, offset);
  }
  if (lane == 0) out[row] = acc;
}

// ---- sparse_grad -----------------------------------------------------

__global__ void grad_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
                            const float* __restrict__ mult, float* __restrict__ grad,
                            int64_t slots, int nnz, int64_t d) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= slots) return;
  const int32_t c = idx[t];
  if (c < 0 || c >= d) return;
  atomicAdd(grad + c, vals[t] * mult[t / nnz]);  // result unused: compiles to RED
}

// A plan the kernels cannot run: no model, threads not whole warps, or a
// batch whose slots overflow 64 bits.
bool bad_plan(long long rows, int nnz, long long d, int threads, int grid) {
  return d <= 0 || threads <= 0 || threads % kWarp != 0 || threads > 1024 || grid <= 0 ||
         rows > (1LL << 62) / nnz;
}

}  // namespace

// The row dot's plan: `threads` / 32 rows a block, `grid` blocks, which
// must cover the rows.
extern "C" int fmt_sparse_row_dots(const void* idx, const void* vals, const void* coeff,
                                   void* out, long long rows, int nnz, long long d, int threads,
                                   int grid, void* stream) {
  if (rows <= 0 || nnz <= 0) return 0;
  if (bad_plan(rows, nnz, d, threads, grid) ||
      static_cast<long long>(grid) * (threads / kWarp) < rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  row_dots_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(vals),
      static_cast<const float*>(coeff), static_cast<float*>(out), rows, nnz, d);
  return static_cast<int>(cudaGetLastError());
}

// The gradient's plan: a thread a slot, `threads` a block, `grid` blocks,
// which must cover the slots.
extern "C" int fmt_sparse_grad(const void* idx, const void* vals, const void* mult, void* out,
                               long long rows, int nnz, long long d, int threads, int grid,
                               void* stream) {
  if (rows <= 0 || nnz <= 0) return 0;
  if (bad_plan(rows, nnz, d, threads, grid) ||
      static_cast<long long>(grid) * threads < rows * nnz) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  grad_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(vals),
      static_cast<const float*>(mult), static_cast<float*>(out), rows * nnz, nnz, d);
  return static_cast<int>(cudaGetLastError());
}
