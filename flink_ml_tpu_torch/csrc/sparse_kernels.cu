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
// fleet_row_dots and fleet_grad are the member-batched forms of the two,
// for a fleet fit (fleet.py): N models trained on one shared batch. The
// JAX package reaches them by vmapping the Pallas calls over a member axis
// (flink_ml_tpu/ops/optimizer.py, _sgd_fleet_whole_fit_impl over
// losses.sparse_variant), so they replace sparse_row_dots and sparse_grad
// of flink_ml_tpu/ops/sparsekernels.py under jax.vmap:
//     out[m, i] = sum_j [idx[i,j] >= 0] * vals[i,j] * coeff[m, min(idx[i,j], d-1)]
//     g[m, c]   = sum over (i, j) with idx[i,j] = c, 0 <= c < d, of vals[i,j] * mult[m, i]
// The (N, d) operand (coeff, g) is addressed as base[m * ms + c * cs]: the
// caller passes member-major (ms = d, cs = 1) or member-minor (ms = 1,
// cs = N) strides. A fleet's point is to read its input once for N
// models, so each kernel reads a slot's idx and vals once and loops over
// the members in registers:
//   - fleet_row_dots has the row dot's layout (a warp per row, a lane's
//     slots loaded, then gathered, then added) with kMemberTile
//     accumulators a lane; each slot gathers its column for every member
//     of the tile. Per member it adds in the solo kernel's order and
//     reduces with the same shuffle tree, so row m equals sparse_row_dots
//     on coeff[m] bit for bit. A fleet of more than kMemberTile members
//     walks the row's slots once per tile of members; the repeats hit L1.
//   - fleet_grad has the gradient's layout (a thread per slot) and adds
//     the slot's N products with RED atomics: N scalar ones, or, where
//     the gradient is member-minor with N a multiple of 4 (the fit's
//     case), N / 4 REDs of a float4 each (RED.128, sm_90 from CUDA 12.1).
// What bounds them: the batch's 8 bytes a slot stream once, as in the
// solo kernels; the random accesses to the (N, d) operand are N a slot.
// Member-major, they fall on N different 32-byte sectors; member-minor,
// on the N neighbouring floats of one column (one sector at N = 8), read
// by one warp's gathers together and added by two float4 REDs. That is
// why the sparse fleet fit keeps its coefficients member-minor
// (ops/optimizer.py `fleet_init_state`). PERF.md has the times of both
// layouts.
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

// ---- fleet_row_dots ---------------------------------------------------

constexpr int kMemberTile = 8;

__global__ void fleet_row_dots_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
                                      const float* __restrict__ coeff, float* __restrict__ out,
                                      int64_t rows, int nnz, int64_t d, int members, int64_t ms,
                                      int64_t cs) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (row >= rows) return;  // uniform across a warp, as in row_dots_kernel
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
      if (m < tile) {  // uniform across the warp
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

// ---- fleet_grad ------------------------------------------------------

// float4 atomicAdd (RED.128) exists for global memory on compute
// capability 9.x from CUDA 12.1.
#if defined(__CUDACC_VER_MAJOR__) && (__CUDACC_VER_MAJOR__ * 100 + __CUDACC_VER_MINOR__ >= 1201)
#define FMT_VECTOR_RED 1
#else
#define FMT_VECTOR_RED 0
#endif

__global__ void fleet_grad_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
                                  const float* __restrict__ mult, float* __restrict__ grad,
                                  int64_t rows, int nnz, int64_t d, int members, int64_t ms,
                                  int64_t cs, bool vec4) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows * nnz) return;
  const int32_t c = idx[t];
  if (c < 0 || c >= d) return;
  const float v = vals[t];
  const float* row_mult = mult + t / nnz;
  float* col = grad + static_cast<int64_t>(c) * cs;
#if FMT_VECTOR_RED
  if (vec4) {  // member-minor, members % 4 == 0, columns 16-byte aligned
    for (int m = 0; m < members; m += 4) {
      const float4 add = make_float4(v * row_mult[static_cast<int64_t>(m) * rows],
                                     v * row_mult[static_cast<int64_t>(m + 1) * rows],
                                     v * row_mult[static_cast<int64_t>(m + 2) * rows],
                                     v * row_mult[static_cast<int64_t>(m + 3) * rows]);
      atomicAdd(reinterpret_cast<float4*>(col + m), add);  // one RED of 16 bytes
    }
    return;
  }
#endif
  for (int m = 0; m < members; ++m) {
    atomicAdd(col + m * ms, v * row_mult[static_cast<int64_t>(m) * rows]);  // RED
  }
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

// The fleet kernels: the plans of the solo kernels; `members` >= 1 and the
// strides of the (N, d) operand (coeff for the row dot, the zeroed output
// for the gradient); mult is (members, rows), contiguous.
static bool bad_fleet(int members, long long ms, long long cs) {
  return members <= 0 || ms <= 0 || cs <= 0;
}

extern "C" int fmt_fleet_row_dots(const void* idx, const void* vals, const void* coeff, void* out,
                                  long long rows, int nnz, long long d, int members,
                                  long long ms, long long cs, int threads, int grid,
                                  void* stream) {
  if (rows <= 0 || nnz <= 0) return 0;
  if (bad_plan(rows, nnz, d, threads, grid) || bad_fleet(members, ms, cs) ||
      static_cast<long long>(grid) * (threads / kWarp) < rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fleet_row_dots_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(vals),
      static_cast<const float*>(coeff), static_cast<float*>(out), rows, nnz, d, members, ms, cs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fmt_fleet_grad(const void* idx, const void* vals, const void* mult, void* out,
                              long long rows, int nnz, long long d, int members, long long ms,
                              long long cs, int threads, int grid, void* stream) {
  if (rows <= 0 || nnz <= 0) return 0;
  if (bad_plan(rows, nnz, d, threads, grid) || bad_fleet(members, ms, cs) ||
      static_cast<long long>(grid) * threads < rows * nnz) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // member-minor with whole float4s of members: each slot adds 4 members a RED
  const bool vec4 = FMT_VECTOR_RED && ms == 1 && cs == members && members % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  fleet_grad_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(vals),
      static_cast<const float*>(mult), static_cast<float*>(out), rows, nnz, d, members, ms, cs,
      vec4);
  return static_cast<int>(cudaGetLastError());
}
