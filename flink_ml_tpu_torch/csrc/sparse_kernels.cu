// Hand-written Hopper (sm_90a) kernels for the sparse padded-CSR path of
// LogisticRegression and the other SGD-trained linear models.
//
// Layout: a batch is `idx` (rows, nnz) int32 with -1 padding and `vals`
// (rows, nnz) float32, both row-major and contiguous. `d` is the model
// width. Both kernels keep the JAX package's index convention:
//   - padding (idx < 0) contributes nothing;
//   - an index >= d is CLAMPED to d-1 in the row dot (a clamping gather)
//     and DROPPED in the gradient (a scatter with mode="drop").
//
// sparse_row_dots replaces flink_ml_tpu/ops/sparsekernels.py:sparse_row_dots
// (Pallas body _dot_kernel):
//     out[i] = sum_j [idx[i,j] >= 0] * vals[i,j] * coeff[min(idx[i,j], d-1)]
//   Bound: bytes. Each of the rows*nnz slots reads 8 bytes of idx+vals from
//   device memory once and gathers 4 bytes of coeff; at d = 1e6 the 4 MB
//   coefficient stays resident in the 50 MB L2, so the streamed idx/vals
//   bytes set the floor (about 31 MB, 9 us, at rows = 100,000 and nnz = 39).
//   Design: one warp per row. Lanes walk the row's slots in stride 32, so a
//   warp's idx/vals loads are contiguous, and each lane gathers its own
//   coefficient; a shuffle tree sums the lanes. nnz = 39 is under two warp
//   widths, so a lane does one or two slots. The TPU kernel's single-block
//   VMEM layout is not carried over: a block here holds 8 rows and the grid
//   covers the batch, so every SM has work.
//
// sparse_grad replaces flink_ml_tpu/ops/sparsekernels.py:sparse_grad
// (Pallas body _grad_kernel):
//     g[c] = sum over (i, j) with idx[i,j] = c, 0 <= c < d, of vals[i,j] * mult[i]
//   Bound: bytes. rows*nnz*8 bytes of idx+vals and rows*4 of mult read once,
//   d*4 bytes of g written once (about 35 MB, 11 us, at the fit's shapes).
//   Design: one thread per (i, j) slot, an atomicAdd into g, which the caller
//   zeroes. Neighbouring threads read neighbouring slots, so loads coalesce;
//   the atomics land in L2 and spread over d = 1e6 addresses, so contention
//   is low. The order of the additions changes from run to run, so results
//   agree with the row-major reference only to a tolerance. A deterministic
//   variant (stable sort by column, then an ordered segment sum) is a later
//   ROADMAP item.
//
// Interface: plain C, for ctypes. Each entry launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// (0 on success). Empty batches launch nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kGradThreads = 256;
constexpr long long kMaxBlocks = 2147483647LL;  // gridDim.x limit

__global__ void row_dots_kernel(const int32_t* __restrict__ idx,
                                const float* __restrict__ vals,
                                const float* __restrict__ coeff,
                                float* __restrict__ out,
                                int64_t rows, int nnz, int64_t d) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x / kWarp);
  // `row` is uniform across a warp, so whole warps leave together and the
  // full-mask shuffles below see all 32 lanes.
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

__global__ void grad_kernel(const int32_t* __restrict__ idx,
                            const float* __restrict__ vals,
                            const float* __restrict__ mult,
                            float* __restrict__ grad,
                            int64_t slots, int nnz, int64_t d) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= slots) return;
  const int32_t c = idx[t];
  if (c < 0 || c >= d) return;
  atomicAdd(grad + c, vals[t] * mult[t / nnz]);
}

}  // namespace

extern "C" int fmt_sparse_row_dots(const void* idx, const void* vals,
                                   const void* coeff, void* out,
                                   long long rows, int nnz, long long d,
                                   void* stream) {
  if (rows <= 0) return 0;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > kMaxBlocks) return static_cast<int>(cudaErrorInvalidConfiguration);
  row_dots_kernel<<<static_cast<unsigned int>(blocks), kWarp * kRowsPerBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(vals),
      static_cast<const float*>(coeff), static_cast<float*>(out), rows, nnz, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fmt_sparse_grad(const void* idx, const void* vals,
                               const void* mult, void* grad,
                               long long rows, int nnz, long long d,
                               void* stream) {
  const long long slots = rows * nnz;
  if (slots <= 0) return 0;
  const long long blocks = (slots + kGradThreads - 1) / kGradThreads;
  if (blocks > kMaxBlocks) return static_cast<int>(cudaErrorInvalidConfiguration);
  grad_kernel<<<static_cast<unsigned int>(blocks), kGradThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(vals),
      static_cast<const float*>(mult), static_cast<float*>(grad), slots, nnz, d);
  return static_cast<int>(cudaGetLastError());
}
