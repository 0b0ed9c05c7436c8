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
// sparse_grad: a persistent grid, two blocks an SM, each walking fixed
// chunks of the row-major slot run (block b takes chunks b, b + grid, ...).
// A chunk's idx and vals are contiguous, and so are the multipliers of its
// rows; while a block aggregates one chunk, the next one's idx, vals and
// mult are already in flight into the other stage of a shared-memory ring
// (cp.async: 16-byte pieces where both ends are aligned, 4-byte ones for
// the ragged head and tail, so a batch sliced at any row offset works; a
// stage keeps each word at its global address mod 16). The random side
// goes to a table of columns in the block's shared memory: open addressing
// with int32 keys and f32 sums, a power of two of entries, linear probing
// from a multiplicative hash. A column's first slot claims an entry and
// adds its own value straight to device memory with a RED; the entry sums
// the column's later slots. The table lives across the block's chunks: the
// block flushes it (one RED per entry with a sum, then a reset) when the
// entries claimed pass a quarter of it, and at the end, so a hot column
// reaches device memory about twice a block per fill instead of once a
// slot, and a column seen once costs one RED, as it would without a table.
// A column that finds neither its entry nor a free one within kProbes
// entries adds with its own RED: the table is a cache of the block's
// hottest sums, not a store that must hold them all.
//   Near-distinct columns (a uniform batch over d = 1e6) make the table
// pure overhead: a shared CAS per slot beside the RED that a thread-per-
// slot kernel issues anyway. So each block counts, per chunk, the valid
// slots whose column the table did not hold yet; where that is more than
// 7/8 of them, the block adds its next chunks straight with REDs, and
// measures again every kResample-th chunk. Skewed batches (Zipf, the text
// path's hashed features) stay on the table.
//   Costs on this card: a shared float add is a CAS loop (ATOMS.CAST.SPIN;
// sm_90 has no shared float atomic add), and shared atomics set the text
// batch's time. Lanes of a warp that hold the same column could combine
// first (__match_any_sync); measured, that saved 12% on Zipf and cost
// 6-39% on the text batch, whose warps hold mostly distinct columns, so
// the kernel does not combine (PERF.md). A slot's row comes from the
// chunk's first row (one 64-bit division a block, then a running row and
// remainder) and a float reciprocal of nnz with one correction each way,
// not a division per slot. The first design, a thread per slot with a RED
// each, serialises in the L2 on hot columns (77 times its bound on
// Zipf(1.1), slower than index_add_); csrc/designs.cu keeps it as
// fmt_red_grad.
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
//     Where coeff is member-minor, N a multiple of 4 and its base 16-byte
//     aligned (the fit's case; the caller decides, ops/sparsekernels.py
//     `_float4_members`), a slot's members load as float4s through the
//     read-only path: two 16-byte loads at N = 8 where 8 scalar loads
//     (each a warp-wide gather over 32 sectors) were issued before. The
//     values, their FMA order and the tree stay, so the bits do too.
//     The members' shuffle trees run side by side.
//     Member-major coeff and other N keep the scalar loads (designs.cu
//     keeps the kernel that always took them as
//     fmt_scalar_fleet_row_dots).
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
// The launch plans come from ops/sparsekernels.py (`_launch_plan`; for
// sparse_grad `_grad_plan`: grid, chunk, table size, flush threshold and
// the multipliers a stage holds, from the batch's shape and the SM count),
// which the CPU tests check; sparse_grad's entry computes its shared
// memory from them. The gradients are not bitwise deterministic:
// their additions (shared and global atomics, flushes) land in an order
// that changes from run to run, so they agree with the row-major
// reference to a tolerance (exactly, when every partial sum is
// representable). A deterministic gradient would need a column-sorted
// plan of each batch; a fit trains each batch only maxIter / num_batches
// times (ops/optimizer.py), so the sort would cost more than the gradient
// it orders (ROADMAP B.3).
//
// Interface: plain C, for ctypes. Each entry launches on the given stream,
// does not synchronise, allocates nothing, and returns a cudaError_t
// (0 on success). The caller zeroes the gradient. Empty batches launch
// nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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

constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kEmpty = -1;
// table entries a column tries, from its hashed one on, before it adds with a RED
constexpr int kProbes = 8;

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The word offset of p within its 16 bytes.
__device__ __forceinline__ int word_offset(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// The block copies `count` 4-byte words from `src` to dst[off, off + count),
// off = word_offset(src), so the 16-byte pieces of the body land on 16-byte
// shared addresses; the ragged head and tail (at most 3 words each) go by
// 4-byte copies. Asynchronous: the caller commits and waits.
__device__ __forceinline__ void copy_async(uint32_t* dst, const void* src_v, int count) {
  const uint32_t* src = static_cast<const uint32_t*>(src_v);
  const int off = word_offset(src);
  const int head = min((4 - off) & 3, count);
  const int body = (count - head) >> 2;
  const int tail = head + 4 * body;
  const int t = threadIdx.x;
  int w = -1;
  if (t < head) {
    w = t;
  } else if (t >= 4 && t - 4 < count - tail) {
    w = tail + t - 4;
  }
  if (w >= 0) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_address(dst + off + w)),
                 "l"(src + w)
                 : "memory");
  }
  for (int g = t; g < body; g += blockDim.x) {
    const int x = head + 4 * g;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(shared_address(dst + off + x)),
                 "l"(src + x)
                 : "memory");
  }
}

// floor(n / d) for d >= 1 and n < d + 2^16, without a division: a float
// estimate off by less than 0.25 while n < 2^21, then one correction each
// way; above d = 2^20 the quotient can only be 0 or 1.
__device__ __forceinline__ unsigned div_rows(unsigned n, unsigned d, float inv_d) {
  if (d > (1u << 20)) return n >= d ? 1u : 0u;
  const unsigned q = __float2uint_rz(__uint2float_rn(n) * inv_d);
  const int r = static_cast<int>(n - q * d);
  if (r < 0) return q - 1;
  return r >= static_cast<int>(d) ? q + 1 : q;
}

// The row and the slot within it of a chunk's first slot; a block's next
// chunk lies grid * chunk slots on, step_rows rows and step_rem slots.
struct RowCursor {
  int64_t row, rem;
  __device__ __forceinline__ void advance(int64_t step_rows, int64_t step_rem, int nnz) {
    row += step_rows;
    rem += step_rem;
    if (rem >= nnz) {
      rem -= nnz;
      ++row;
    }
  }
};

// Adds x at column c: to the column's table entry; or, where the column
// has none, it claims a free one and adds x straight to grad with a RED
// (the entry sums only the column's later adds, so a column seen once
// costs one RED and no flush); or, with no entry in reach, it adds x with a
// RED. Counts the claims and the misses (slots whose column the table did
// not hold yet).
__device__ __forceinline__ void add_to_table(int32_t* keys, float* sums, float* __restrict__ grad,
                                             unsigned mask, int bits, int32_t c, float x,
                                             int& claims, int& misses) {
  unsigned h = (static_cast<unsigned>(c) * 2654435761u) >> (32 - bits);
  for (int p = 0; p < kProbes; ++p, h = (h + 1u) & mask) {
    int32_t k = reinterpret_cast<volatile int32_t*>(keys)[h];
    if (k == kEmpty) {
      k = atomicCAS(keys + h, kEmpty, c);
      if (k == kEmpty) {  // claimed: the entry sums the column's later adds
        atomicAdd(grad + c, x);  // result unused: RED
        ++claims;
        ++misses;
        return;
      }
    }
    if (k == c) {
      atomicAdd(sums + h, x);  // a CAS loop on shared memory (ATOMS.CAST.SPIN on sm_90)
      return;
    }
  }
  atomicAdd(grad + c, x);  // result unused: RED
  ++misses;
}

// Every claimed entry with a sum goes to grad with one RED; the table is
// left empty.
// Thread t owns the entries 4t + 4 * blockDim.x * j, here and at the start.
__device__ __forceinline__ void flush_table(int32_t* keys, float* sums, float* __restrict__ grad,
                                            int table) {
  for (int e = 4 * threadIdx.x; e < table; e += 4 * blockDim.x) {
    const int4 k = *reinterpret_cast<const int4*>(keys + e);
    const float4 s = *reinterpret_cast<const float4*>(sums + e);
    if (k.x != kEmpty && s.x != 0.0f) atomicAdd(grad + k.x, s.x);
    if (k.y != kEmpty && s.y != 0.0f) atomicAdd(grad + k.y, s.y);
    if (k.z != kEmpty && s.z != 0.0f) atomicAdd(grad + k.z, s.z);
    if (k.w != kEmpty && s.w != 0.0f) atomicAdd(grad + k.w, s.w);
    *reinterpret_cast<int4*>(keys + e) = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
    *reinterpret_cast<float4*>(sums + e) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Stages of the ring: one chunk aggregates while the next is copied.
constexpr int kRing = 2;
static_assert(kRing == 2, "sparse_grad_kernel's walk (load, wait_group 1) is written for two stages");

// 32-bit words of one ring stage: idx and vals, chunk + 4 each, then the
// rows' multipliers, row_cap + 4 rounded up to whole 16 bytes.
__host__ __device__ __forceinline__ int stage_words(int chunk, int row_cap) {
  return 2 * (chunk + 4) + ((row_cap + 7) & ~3);
}

// Shared memory: keys and sums, the ring's stages, then 8 counters: the
// entries claimed since the last flush, and by chunk parity the valid
// slots of a chunk and its misses. The launch computes it from the plan.
inline long long grad_smem_bytes(int table, int chunk, int row_cap) {
  return 4LL * (2LL * table + static_cast<long long>(kRing) * stage_words(chunk, row_cap) + 8);
}

// The most dynamic shared memory a block of an H100 may have (227 KB).
constexpr int kBlockSharedBytes = 232448;

// What a walk may count (ops/sparsekernels.py `WALK_STATS`), for the checks
// of the kernel's paths: table flushes with chunks still to come, slots
// that found no entry within kProbes, and chunks added with direct REDs.
enum WalkStat { kMidWalkFlushes, kOverflows, kDirectChunks };

// A block whose chunk found fewer than 1 / kRepeatShare of its valid slots'
// columns already in the table adds its next chunks straight with REDs,
// measuring again with the table every kResample-th chunk.
constexpr int kRepeatShare = 8;
constexpr int kResample = 32;

__global__ void sparse_grad_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
                                   const float* __restrict__ mult, float* __restrict__ grad,
                                   int* __restrict__ stats, int64_t slots, int nnz, int64_t d,
                                   int chunk, int table, int flush_at, int row_cap) {
  extern __shared__ __align__(16) uint32_t smem[];
  int32_t* keys = reinterpret_cast<int32_t*>(smem);
  float* sums = reinterpret_cast<float*>(smem + table);
  const int words = stage_words(chunk, row_cap);
  uint32_t* ring = smem + 2 * table;
  int* claimed = reinterpret_cast<int*>(ring + kRing * words);
  int* counts = claimed + 4;  // [parity][valid, misses]
  const int lane = threadIdx.x % kWarp;
  const int bits = 31 - __clz(table);
  const float inv_nnz = 1.0f / static_cast<float>(nnz);
  const int64_t chunks = (slots + chunk - 1) / chunk;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * chunk;
  const int64_t step_rows = stride / nnz, step_rem = stride % nnz;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * chunk;
  RowCursor at_load{first / nnz, 0};  // the chunk to copy next
  at_load.rem = first - at_load.row * nnz;
  RowCursor at_use = at_load;  // the chunk to aggregate next
  int64_t load_k = blockIdx.x;

  // copy chunk load_k (if any) into stage `stage`; one commit group either way
  auto load = [&](int stage) {
    if (load_k < chunks) {
      uint32_t* st = ring + stage * words;
      const int64_t s0 = load_k * chunk;
      const int n = slots - s0 < chunk ? static_cast<int>(slots - s0) : chunk;
      const int rows =
          static_cast<int>(div_rows(static_cast<unsigned>(at_load.rem + n - 1), nnz, inv_nnz)) + 1;
      copy_async(st, idx + s0, n);
      copy_async(st + chunk + 4, vals + s0, n);
      copy_async(st + 2 * (chunk + 4), mult + at_load.row, rows);
      load_k += gridDim.x;
      at_load.advance(step_rows, step_rem, nnz);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  load(0);
  for (int e = 4 * threadIdx.x; e < table; e += 4 * blockDim.x) {  // while the copies fly
    *reinterpret_cast<int4*>(keys + e) = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
    *reinterpret_cast<float4*>(sums + e) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (threadIdx.x < 8) claimed[threadIdx.x] = 0;

  bool direct = false;  // the last measured chunk repeated too few columns
  int it = 0;
  for (int64_t k = blockIdx.x; k < chunks; k += gridDim.x, ++it) {
    load((it + 1) % kRing);  // into the stage aggregated last time round
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // this chunk has landed, from every thread's copies
    const int parity = it & 1;
    // the next chunk's counts, last read before this chunk's barrier
    if (threadIdx.x < 2) counts[2 * (parity ^ 1) + threadIdx.x] = 0;
    const bool measure = !direct || it % kResample == 0;
    const uint32_t* st = ring + (it % kRing) * words;
    const int64_t s0 = k * chunk;
    const int n = slots - s0 < chunk ? static_cast<int>(slots - s0) : chunk;
    const int32_t* si = reinterpret_cast<const int32_t*>(st) + word_offset(idx + s0);
    const float* sv = reinterpret_cast<const float*>(st + chunk + 4) + word_offset(vals + s0);
    const float* sm =
        reinterpret_cast<const float*>(st + 2 * (chunk + 4)) + word_offset(mult + at_use.row);
    const unsigned rem = static_cast<unsigned>(at_use.rem);
    int valid = 0, claims = 0, misses = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int32_t c = si[i];
      if (c < 0 || c >= d) continue;
      const float x = sv[i] * sm[div_rows(rem + i, nnz, inv_nnz)];
      if (measure) {
        ++valid;
        add_to_table(keys, sums, grad, table - 1, bits, c, x, claims, misses);
      } else {
        atomicAdd(grad + c, x);  // result unused: RED
      }
    }
    if (measure) {  // whole warps: every lane reaches the sums
      valid = __reduce_add_sync(kFull, valid);
      claims = __reduce_add_sync(kFull, claims);
      misses = __reduce_add_sync(kFull, misses);
      if (lane == 0) {
        if (claims != 0) atomicAdd(claimed, claims);
        atomicAdd(counts + 2 * parity, valid);
        atomicAdd(counts + 2 * parity + 1, misses);
        if (stats != nullptr && misses != claims) atomicAdd(stats + kOverflows, misses - claims);
      }
    } else if (stats != nullptr && threadIdx.x == 0) {
      atomicAdd(stats + kDirectChunks, 1);
    }
    __syncthreads();  // the stage is read and the chunk's adds are in the table
    if (measure) {
      direct = kRepeatShare * (counts[2 * parity] - counts[2 * parity + 1]) < counts[2 * parity];
    }
    if (*claimed >= flush_at) {
      flush_table(keys, sums, grad, table);
      __syncthreads();
      if (threadIdx.x == 0) {
        *claimed = 0;
        if (stats != nullptr && k + gridDim.x < chunks) atomicAdd(stats + kMidWalkFlushes, 1);
      }
    }
    at_use.advance(step_rows, step_rem, nnz);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  flush_table(keys, sums, grad, table);
}

// ---- fleet_row_dots ---------------------------------------------------

constexpr int kMemberTile = 8;

// Six blocks of kFleetThreads an SM: at most 40 registers, where 56 left
// room for four (PERF.md §6: 9% faster at the fleet's batch).
constexpr int kFleetThreads = 256;

__global__ void __launch_bounds__(kFleetThreads, 6) fleet_row_dots_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
                                      const float* __restrict__ coeff, float* __restrict__ out,
                                      int64_t rows, int nnz, int64_t d, int members, int64_t ms,
                                      int64_t cs, bool vec4) {
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
        if (vec4) {  // ms == 1; tile is 4 or 8; col is 16-byte aligned
          const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const float4 lo = c[u] >= 0 ? __ldg(reinterpret_cast<const float4*>(col)) : zero;
          const float4 hi = c[u] >= 0 && tile > 4 ? __ldg(reinterpret_cast<const float4*>(col + 4)) : zero;
          g[u][0] = lo.x, g[u][1] = lo.y, g[u][2] = lo.z, g[u][3] = lo.w;
          g[u][4] = hi.x, g[u][5] = hi.y, g[u][6] = hi.z, g[u][7] = hi.w;
        } else {
#pragma unroll
          for (int m = 0; m < kMemberTile; ++m) {
            g[u][m] = (c[u] >= 0 && m < tile) ? __ldg(col + m * ms) : 0.0f;
          }
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
    // the members' trees side by side, each as in row_dots_kernel; the
    // accumulators of members past the tile hold 0 and are not written
#pragma unroll
    for (int offset = kWarp / 2; offset > 0; offset /= 2) {
#pragma unroll
      for (int m = 0; m < kMemberTile; ++m) acc[m] += __shfl_down_sync(0xffffffffu, acc[m], offset);
    }
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < kMemberTile; ++m) {
        if (m < tile) out[static_cast<int64_t>(m0 + m) * rows + row] = acc[m];
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

// Above 48 KB a block's dynamic shared memory must be asked for: asked
// once a device, for the most a block may have, with the largest carveout,
// which lets two blocks of the plan share an SM.
static cudaError_t allow_grad_shared_memory() {
  static std::atomic<uint64_t> ready{0};  // a bit a device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ULL << (device & 63);
  if (ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(sparse_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBlockSharedBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(sparse_grad_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

// The gradient's plan (ops/sparsekernels.py `_grad_plan`): `grid` blocks of
// `threads`, each walking chunks of `chunk` slots (a multiple of 4, at most
// 2^16) through the ring, with a table of `table` entries (a power of two)
// flushed once `flush_at` entries are claimed; `row_cap` words hold a
// chunk's multipliers, at least the rows a chunk can span. Refused where
// their shared memory passes a block's. `stats`, if not null, is 3 zeroed
// ints the walk adds its WalkStat counts to.
extern "C" int fmt_sparse_grad(const void* idx, const void* vals, const void* mult, void* out,
                               long long rows, int nnz, long long d, void* stats, int threads,
                               int grid, int chunk, int table, int flush_at, int row_cap,
                               void* stream) {
  if (rows <= 0 || nnz <= 0) return 0;
  if (bad_plan(rows, nnz, d, threads, grid) || chunk <= 0 || chunk % 4 != 0 || chunk > (1 << 16) ||
      table < 32 || table > (1 << 16) || (table & (table - 1)) != 0 ||
      row_cap < (nnz - 1LL + chunk - 1) / nnz + 1 ||
      grad_smem_bytes(table, chunk, row_cap) > kBlockSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = allow_grad_shared_memory();
  if (err != cudaSuccess) return static_cast<int>(err);
  sparse_grad_kernel<<<grid, threads, grad_smem_bytes(table, chunk, row_cap),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(vals),
      static_cast<const float*>(mult), static_cast<float*>(out), static_cast<int*>(stats),
      rows * nnz, nnz, d, chunk, table, flush_at, row_cap);
  return static_cast<int>(cudaGetLastError());
}

// The fleet kernels: the plans of the solo kernels; `members` >= 1 and the
// strides of the (N, d) operand (coeff for the row dot, the zeroed output
// for the gradient); mult is (members, rows), contiguous.
static bool bad_fleet(int members, long long ms, long long cs) {
  return members <= 0 || ms <= 0 || cs <= 0;
}

// `vec4`: load a slot's members as float4s (ops/sparsekernels.py
// `_float4_members`); refused unless coeff is member-minor, members a
// multiple of 4 and its base 16-byte aligned.
extern "C" int fmt_fleet_row_dots(const void* idx, const void* vals, const void* coeff, void* out,
                                  long long rows, int nnz, long long d, int members,
                                  long long ms, long long cs, int vec4, int threads, int grid,
                                  void* stream) {
  if (rows <= 0 || nnz <= 0) return 0;
  if (bad_plan(rows, nnz, d, threads, grid) || bad_fleet(members, ms, cs) || threads > kFleetThreads ||
      static_cast<long long>(grid) * (threads / kWarp) < rows ||
      (vec4 && (ms != 1 || cs != members || members % 4 != 0 ||
                reinterpret_cast<uintptr_t>(coeff) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fleet_row_dots_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(vals),
      static_cast<const float*>(coeff), static_cast<float*>(out), rows, nnz, d, members, ms, cs,
      vec4 != 0);
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
