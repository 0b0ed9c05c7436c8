// Other designs of the sparse kernels, for comparison with
// csrc/sparse_kernels.cu on the card: the designs that the shipped kernels
// replaced, other layouts of the row dot and a candidate design of the
// fleet gradient. They are built and run by
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
//   fmt_red_fleet_grad: the first member-batched gradient, replaced in
//     sparse_kernels.cu by one bulk reduction a slot: a
//     thread per slot that adds its N products into the zeroed (N, d)
//     gradient with REDs, N / 4 of a float4 each where the gradient is
//     member-minor with N a multiple of 4 and 16-byte aligned, else N
//     scalar ones. Two RED.128 a slot at
//     N = 8: it runs at the L2's rate of atomic requests, and its REDs to a
//     hot column serialise. Its plan is the thread-per-slot one.
//   fmt_bucketed_fleet_grad: the column-bucketed candidate for the
//     member-batched gradient (each member row a bucket touched reaches
//     device memory once), measured against the one-pass kernel that
//     sparse_kernels.cu ships and not shipped: faster on skewed columns,
//     slower on the fleet fit's uniform batch (its section below says how
//     it works; PERF.md has the sweep). Kept as the reference for a
//     skewed fleet (ROADMAP B.4): a kernel that chooses between the two
//     designs is measured against it.
//
// Same batch layout and index convention as sparse_kernels.cu; each plain C
// entry launches on the given stream and returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

// float4 atomicAdd (RED.128) exists for global memory on compute
// capability 9.x from CUDA 12.1.
#if defined(__CUDACC_VER_MAJOR__) && (__CUDACC_VER_MAJOR__ * 100 + __CUDACC_VER_MINOR__ >= 1201)
#define FMT_VECTOR_RED 1
#else
#define FMT_VECTOR_RED 0
#endif

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

__global__ void red_fleet_grad_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
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

// The first fleet gradient: the thread-per-slot plan and the zeroed (N, d)
// gradient's member and column strides.
extern "C" int fmt_red_fleet_grad(const void* idx, const void* vals, const void* mult, void* out,
                                  long long rows, int nnz, long long d, int members, long long ms,
                                  long long cs, int threads, int grid, void* stream) {
  if (rows <= 0 || nnz <= 0) return 0;
  if (d <= 0 || members <= 0 || ms <= 0 || cs <= 0 || threads <= 0 || threads % kWarp != 0 ||
      grid <= 0 || static_cast<long long>(grid) * threads < rows * nnz) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // member-minor with whole float4s of members: each slot adds 4 members a RED
  const bool vec4 = FMT_VECTOR_RED && ms == 1 && cs == members && members % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  red_fleet_grad_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(vals),
      static_cast<const float*>(mult), static_cast<float*>(out), rows, nnz, d, members, ms, cs,
      vec4);
  return static_cast<int>(cudaGetLastError());
}

// ---- the column-bucketed fleet gradient ----------------------------------
//
// fmt_bucketed_fleet_grad: the member-batched gradient as four steps over
// buckets of W columns, so that each member row a bucket touched reaches
// device memory once (a plain store where the bucket is one piece, a RED
// where it is split over several), with no float atomic in device memory
// on a uniform batch: (1) count: each block's run of slots by bucket in a
// shared histogram, added to the buckets' counts; the multipliers
// transposed to (rows, N); (2) scan, one block: each bucket's first entry
// and its pieces of at most P entries; (3) scatter: each block counts its
// run again, reserves each bucket's share with one atomic, stages its
// entries in shared memory by bucket and writes each bucket's segment in
// one run of neighbouring words; an entry is (row << log2 W | column, value),
// 8 bytes; (4) accumulate, a block per piece: each entry's products into a
// (W, 4-member-padded tile) slab with 128-bit shared CAS adds, a warp's lanes
// that share a column summed first where the bucket holds `hot` entries a
// column, then flushed. Packed entries only (rows << log2 W fits 32 bits),
// at most 2^15 buckets, slots < 2^31.

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoColumn = 0xffffffffu;
constexpr int kMaxBuckets = 1 << 15;
constexpr int kScanThreads = 1024;
constexpr int kCountThreads = 512;
constexpr int kAccThreads = 256;
constexpr int kMaxTile = 16;
constexpr int kEntriesAPass = 2;  // entries a thread of the accumulate step takes a pass
constexpr int kBlockSharedBytes = 232448;
constexpr int kScatterStaticBytes = 4 * (32 + 1);

// The word offset of p within its 16 bytes.
__device__ __forceinline__ int word_offset(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
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

struct BucketScratch {
  int* counts;        // [buckets] valid slots a bucket; zeroed by the entry
  int* cursor;        // [buckets] the next unreserved entry of each bucket
  int* starts;        // [buckets + 1] each bucket's first entry
  int* piece_first;   // [buckets + 1] each bucket's first piece
  int* piece_bucket;  // [pieces] each piece's bucket
  float* mult_t;      // [rows * members] the multipliers transposed
  uint2* entries;     // [slots] (key, value bits) of each valid slot, by bucket
};

inline long long round4(long long x) { return (x + 3) & ~3LL; }

inline long long bucket_scratch_words(long long buckets, long long pieces, long long rows,
                                      int members, long long slots) {
  return 2 * round4(buckets) + 2 * round4(buckets + 1) + round4(pieces) + round4(rows * members) +
         2 * round4(slots);
}

inline BucketScratch carve(int* words, long long buckets, long long pieces, long long rows,
                           int members) {
  BucketScratch s;
  s.counts = words;
  s.cursor = s.counts + round4(buckets);
  s.starts = s.cursor + round4(buckets);
  s.piece_first = s.starts + round4(buckets + 1);
  s.piece_bucket = s.piece_first + round4(buckets + 1);
  s.mult_t = reinterpret_cast<float*>(s.piece_bucket + round4(pieces));
  s.entries = reinterpret_cast<uint2*>(s.piece_bucket + round4(pieces) + round4(rows * members));
  return s;
}

// f(s, idx[s], vals[s]) for each slot of [s0, s1), neighbouring threads on
// neighbouring slots, 16-byte streaming loads on the aligned body.
template <typename F>
__device__ __forceinline__ void for_slots(const int32_t* __restrict__ idx,
                                          const float* __restrict__ vals, int64_t s0, int64_t s1,
                                          F&& f) {
  const int64_t align = (4 - word_offset(idx + s0)) & 3;
  const int64_t head = align < s1 - s0 ? align : s1 - s0;
  if (threadIdx.x < head) {
    const int64_t s = s0 + threadIdx.x;
    f(s, idx[s], vals != nullptr ? vals[s] : 0.0f);
  }
  const int64_t b0 = s0 + head;
  const int64_t body = (s1 - b0) >> 2;
  const int4* idx4 = reinterpret_cast<const int4*>(idx + b0);
  const bool vals4 = vals != nullptr && word_offset(vals + b0) == 0;
  for (int64_t q = threadIdx.x; q < body; q += blockDim.x) {
    const int4 c = __ldcs(idx4 + q);
    const int64_t s = b0 + 4 * q;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (vals4) {
      v = __ldcs(reinterpret_cast<const float4*>(vals + b0) + q);
    } else if (vals != nullptr) {
      v = make_float4(vals[s], vals[s + 1], vals[s + 2], vals[s + 3]);
    }
    f(s, c.x, v.x);
    f(s + 1, c.y, v.y);
    f(s + 2, c.z, v.z);
    f(s + 3, c.w, v.w);
  }
  const int64_t t0 = b0 + 4 * body;
  if (threadIdx.x < s1 - t0) {
    const int64_t s = t0 + threadIdx.x;
    f(s, idx[s], vals != nullptr ? vals[s] : 0.0f);
  }
}

__device__ __forceinline__ void count_run(int* hist, const int32_t* __restrict__ idx, int64_t s0,
                                          int64_t s1, int64_t d, int wbits, int buckets) {
  for (int k = threadIdx.x; k < buckets; k += blockDim.x) hist[k] = 0;
  __syncthreads();
  if (s0 < s1) {
    for_slots(idx, nullptr, s0, s1, [&](int64_t, int32_t c, float) {
      if (c >= 0 && c < d) atomicAdd(hist + (c >> wbits), 1);
    });
  }
  __syncthreads();
}

__global__ void bucket_count_kernel(const int32_t* __restrict__ idx, const float* __restrict__ mult,
                                    BucketScratch scr, int64_t slots, int rows, int64_t d,
                                    int members, int wbits, int buckets, int run) {
  extern __shared__ int hist[];
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * run;
  count_run(hist, idx, s0, s0 + run < slots ? s0 + run : slots, d, wbits, buckets);
  for (int k = threadIdx.x; k < buckets; k += blockDim.x) {
    if (hist[k] != 0) atomicAdd(scr.counts + k, hist[k]);
  }
  const int64_t total = static_cast<int64_t>(rows) * members;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = t / members;
    scr.mult_t[t] = mult[(t - r * members) * rows + r];
  }
}

__global__ void __launch_bounds__(kScanThreads) bucket_scan_kernel(BucketScratch scr, int buckets,
                                                                   int piece) {
  __shared__ int sums[2][kScanThreads / kWarp];
  __shared__ int carry[2];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (threadIdx.x < 2) carry[threadIdx.x] = 0;
  for (int base = 0; base < buckets; base += blockDim.x) {
    const int k = base + threadIdx.x;
    const int count = k < buckets ? scr.counts[k] : 0;
    const int np = k < buckets ? max(1, (count + piece - 1) / piece) : 0;
    int a = count, b = np;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int x = __shfl_up_sync(kFull, a, o), y = __shfl_up_sync(kFull, b, o);
      if (lane >= o) a += x, b += y;
    }
    if (lane == kWarp - 1) sums[0][warp] = a, sums[1][warp] = b;
    __syncthreads();
    if (warp == 0) {
      const int warps = blockDim.x / kWarp;
      const int x = lane < warps ? sums[0][lane] : 0, y = lane < warps ? sums[1][lane] : 0;
      int ax = x, by = y;
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const int u = __shfl_up_sync(kFull, ax, o), v = __shfl_up_sync(kFull, by, o);
        if (lane >= o) ax += u, by += v;
      }
      if (lane < warps) sums[0][lane] = ax - x + carry[0], sums[1][lane] = by - y + carry[1];
    }
    __syncthreads();
    const int start = a - count + sums[0][warp], first = b - np + sums[1][warp];
    if (k < buckets) {
      scr.starts[k] = start;
      scr.cursor[k] = start;
      scr.piece_first[k] = first;
      for (int j = 0; j < np; ++j) scr.piece_bucket[first + j] = k;
    }
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry[0] = start + count, carry[1] = first + np;
    __syncthreads();
  }
  if (threadIdx.x == 0) scr.starts[buckets] = carry[0], scr.piece_first[buckets] = carry[1];
}

// An exclusive prefix sum of a[0, n) in shared memory, in place; `sums`
// holds a word a warp and the carry, which ends as the total.
__device__ void block_exclusive_scan(int* a, int n, int* sums) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp, warps = blockDim.x / kWarp;
  int* carry = sums + kWarp;
  if (threadIdx.x == 0) *carry = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int k = base + threadIdx.x;
    const int x = k < n ? a[k] : 0;
    int inc = x;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == kWarp - 1) sums[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const int w = lane < warps ? sums[lane] : 0;
      int wi = w;
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const int y = __shfl_up_sync(kFull, wi, o);
        if (lane >= o) wi += y;
      }
      if (lane < warps) sums[lane] = wi - w + *carry;
    }
    __syncthreads();
    const int exclusive = inc - x + sums[warp];
    if (k < n) a[k] = exclusive;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) *carry = exclusive + x;
  }
  __syncthreads();
}

__device__ __forceinline__ float* region_element(float* grad, int e, int64_t b0, int ncols, int mt,
                                                 int64_t ms, int64_t cs) {
  int col, m;
  if (ms == 1) {
    col = e / mt, m = e - col * mt;
  } else {
    m = e / ncols, col = e - m * ncols;
  }
  return grad + (b0 + col) * cs + static_cast<int64_t>(m) * ms;
}

__global__ void bucket_scatter_kernel(const int32_t* __restrict__ idx,
                                      const float* __restrict__ vals, float* __restrict__ grad,
                                      BucketScratch scr, int64_t slots, int nnz, int64_t d,
                                      int members, int64_t ms, int64_t cs, int wbits, int buckets,
                                      int run) {
  extern __shared__ __align__(16) int hist[];
  __shared__ int sums[kScatterStaticBytes / 4];
  int* local = hist + buckets;
  uint2* stage = reinterpret_cast<uint2*>(hist + ((2 * buckets + 3) & ~3));
  uint16_t* stage_bucket = reinterpret_cast<uint16_t*>(stage + run);
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * run;
  const int64_t s1 = s0 + run < slots ? s0 + run : slots;
  count_run(hist, idx, s0, s1, d, wbits, buckets);
  for (int k = threadIdx.x; k < buckets; k += blockDim.x) {
    const int n = hist[k];
    local[k] = n;
    if (n != 0) hist[k] = atomicAdd(scr.cursor + k, n);  // ATOMG: the reservation
  }
  __syncthreads();
  block_exclusive_scan(local, buckets, sums);
  const int staged = sums[kWarp];
  if (s0 < s1) {
    const int64_t row0 = s0 / nnz;
    const unsigned rem0 = static_cast<unsigned>(s0 - row0 * nnz);
    const float inv_nnz = 1.0f / static_cast<float>(nnz);
    const unsigned in_bucket = (1u << wbits) - 1;
    for_slots(idx, vals, s0, s1, [&](int64_t s, int32_t c, float v) {
      if (c < 0 || c >= d) return;
      const int k = c >> wbits;
      const unsigned row = static_cast<unsigned>(row0) +
                           div_rows(rem0 + static_cast<unsigned>(s - s0), nnz, inv_nnz);
      const int at = atomicAdd(local + k, 1);
      stage[at] = make_uint2((row << wbits) | (static_cast<unsigned>(c) & in_bucket), __float_as_uint(v));
      stage_bucket[at] = static_cast<uint16_t>(k);
    });
  }
  __syncthreads();  // local[k] now ends bucket k's segment, where bucket k + 1's starts
  for (int i = threadIdx.x; i < staged; i += blockDim.x) {
    const int k = stage_bucket[i];
    scr.entries[hist[k] + i - (k == 0 ? 0 : local[k - 1])] = stage[i];
  }
  for (int k = blockIdx.x; k < buckets; k += gridDim.x) {  // zero the split buckets
    if (scr.piece_first[k + 1] - scr.piece_first[k] > 1) {
      const int64_t b0 = static_cast<int64_t>(k) << wbits;
      const int ncols = static_cast<int>(d - b0 < (1 << wbits) ? d - b0 : (1 << wbits));
      for (int e = threadIdx.x; e < ncols * members; e += blockDim.x) {
        *region_element(grad, e, b0, ncols, members, ms, cs) = 0.0f;
      }
    }
  }
}

// The group's sums (a __match_any_sync mask) in its lowest lane.
__device__ __forceinline__ void reduce_peers(unsigned peers, float (&x)[8]) {
  const int lane = threadIdx.x % kWarp;
  unsigned rank = __popc(peers & ((1u << lane) - 1));
  unsigned above = peers & ~((2u << lane) - 1);
  while (__any_sync(kFull, above != 0)) {
    const int next = __ffs(above);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float t = __shfl_sync(kFull, x[m], (next - 1) & (kWarp - 1));
      if (next != 0) x[m] += t;
    }
    above &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
  }
}

// (a, b, c, e) added to the 16 bytes at p in shared memory by a 128-bit CAS loop.
__device__ __forceinline__ void cas128_add(float* p, float a, float b, float c, float e) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  float4 old = *reinterpret_cast<const float4*>(p);
  for (;;) {
    const unsigned long long olo =
        (static_cast<unsigned long long>(__float_as_uint(old.y)) << 32) | __float_as_uint(old.x);
    const unsigned long long ohi =
        (static_cast<unsigned long long>(__float_as_uint(old.w)) << 32) | __float_as_uint(old.z);
    const unsigned long long nlo =
        (static_cast<unsigned long long>(__float_as_uint(old.y + b)) << 32) | __float_as_uint(old.x + a);
    const unsigned long long nhi =
        (static_cast<unsigned long long>(__float_as_uint(old.w + e)) << 32) | __float_as_uint(old.z + c);
    unsigned long long rlo, rhi;
    asm volatile(
        "{\n\t.reg .b128 fmt_cmp, fmt_new, fmt_old;\n\t"
        "mov.b128 fmt_cmp, {%2, %3};\n\t"
        "mov.b128 fmt_new, {%4, %5};\n\t"
        "atom.shared.cas.b128 fmt_old, [%6], fmt_cmp, fmt_new;\n\t"
        "mov.b128 {%0, %1}, fmt_old;\n\t}"
        : "=l"(rlo), "=l"(rhi)
        : "l"(olo), "l"(ohi), "l"(nlo), "l"(nhi), "r"(addr)
        : "memory");
    if (rlo == olo && rhi == ohi) return;
    old = make_float4(__uint_as_float(static_cast<unsigned>(rlo)),
                      __uint_as_float(static_cast<unsigned>(rlo >> 32)),
                      __uint_as_float(static_cast<unsigned>(rhi)),
                      __uint_as_float(static_cast<unsigned>(rhi >> 32)));
  }
}

__global__ void __launch_bounds__(kAccThreads) bucket_accumulate_kernel(
    float* __restrict__ grad, BucketScratch scr, int64_t d, int members, int64_t ms, int64_t cs,
    int wbits, int buckets, int tile, int hot) {
  extern __shared__ __align__(16) float slab[];  // [width][tp]
  const int p = blockIdx.x;
  if (p >= scr.piece_first[buckets]) return;
  const int k = scr.piece_bucket[p];
  const int first = scr.piece_first[k], np = scr.piece_first[k + 1] - first, i = p - first;
  const int start = scr.starts[k], count = scr.starts[k + 1] - start;
  const int e0 = start + static_cast<int>(static_cast<int64_t>(i) * count / np);
  const int e1 = start + static_cast<int>(static_cast<int64_t>(i + 1) * count / np);
  const int width = 1 << wbits;
  const int64_t b0 = static_cast<int64_t>(k) << wbits;
  const int ncols = static_cast<int>(d - b0 < width ? d - b0 : width);
  const int m0 = blockIdx.y * tile, mt = min(tile, members - m0);
  const int tp = (tile + 3) & ~3;
  const bool combine = static_cast<int64_t>(count) >= static_cast<int64_t>(hot) * ncols;
  for (int e = threadIdx.x; e < tp * width; e += blockDim.x) slab[e] = 0.0f;
  __syncthreads();
  const unsigned lanes_below = (1u << (threadIdx.x % kWarp)) - 1;
  for (int base = e0; base < e1; base += kEntriesAPass * blockDim.x) {
    unsigned col[kEntriesAPass], row[kEntriesAPass], peers[kEntriesAPass];
    float v[kEntriesAPass];
    bool adds[kEntriesAPass];
#pragma unroll
    for (int u = 0; u < kEntriesAPass; ++u) {
      const int e = base + u * blockDim.x + threadIdx.x;
      const bool valid = e < e1;
      const uint2 entry = valid ? scr.entries[e] : make_uint2(kNoColumn, 0u);
      col[u] = entry.x & (width - 1);
      row[u] = valid ? entry.x >> wbits : 0u;
      v[u] = __uint_as_float(entry.y);
      peers[u] = combine ? __match_any_sync(kFull, valid ? col[u] : kNoColumn) : 0u;
      adds[u] = valid && (peers[u] & lanes_below) == 0;
    }
    for (int mc = 0; mc < mt; mc += 8) {
      const int n = min(8, mt - mc);
      float x[kEntriesAPass][8];
#pragma unroll
      for (int u = 0; u < kEntriesAPass; ++u) {
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          x[u][m] = m < n ? v[u] * __ldg(scr.mult_t + row[u] * static_cast<int64_t>(members) + m0 + mc + m)
                          : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kEntriesAPass; ++u) {
        if (combine) reduce_peers(peers[u], x[u]);
        if (adds[u]) {
          float* at = slab + col[u] * tp + mc;
          cas128_add(at, x[u][0], x[u][1], x[u][2], x[u][3]);
          if (n > 4) cas128_add(at + 4, x[u][4], x[u][5], x[u][6], x[u][7]);
        }
      }
    }
  }
  __syncthreads();
  const bool split = np > 1;
  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    float* g = grad + (b0 + c) * cs + static_cast<int64_t>(m0) * ms;
    const float* s = slab + c * tp;
    for (int m = 0; m < mt; ++m) {
      if (!split) {
        g[m * ms] = s[m];
      } else if (s[m] != 0.0f) {
        atomicAdd(g + m * ms, s[m]);  // result unused: RED
      }
    }
  }
}

inline long long bucket_scatter_bytes(long long buckets, long long run) {
  return 4LL * ((2 * buckets + 3) & ~3LL) + 10LL * run;
}

}  // namespace

// The bucketed candidate's scratch, in int32 words, for its arguments;
// -1 where it cannot run them.
extern "C" long long fmt_bucketed_fleet_grad_scratch(long long rows, int nnz, long long d,
                                                     int members, int width, int piece, int run) {
  const long long slots = rows * nnz;
  if (rows <= 0 || nnz <= 0 || width <= 0 || (width & (width - 1)) != 0 || piece <= 0 ||
      run <= 0 || run > (1 << 16) || slots >= (1LL << 31) || members <= 0) {
    return -1;
  }
  const int wbits = 31 - __builtin_clz(static_cast<unsigned>(width));
  const long long buckets = (d + width - 1) / width;
  const int tile = members < kMaxTile ? members : kMaxTile;
  if (buckets > kMaxBuckets || rows > (1LL << (32 - wbits)) ||
      4LL * width * ((tile + 3) & ~3) > kBlockSharedBytes ||
      bucket_scatter_bytes(buckets, run) > kBlockSharedBytes - kScatterStaticBytes) {
    return -1;
  }
  return bucket_scratch_words(buckets, buckets + (slots + piece - 1) / piece, rows, members, slots);
}

// Buckets of `width` columns, pieces of at most `piece` entries, count and
// scatter runs of `run` slots, lanes combined where a bucket holds `hot`
// entries a column; `scratch` as fmt_bucketed_fleet_grad_scratch says,
// 16-byte aligned. `out` (N, d) at member stride ms and column stride cs
// need not be zeroed: every bucket's gradient is written.
extern "C" int fmt_bucketed_fleet_grad(const void* idx, const void* vals, const void* mult, void* out,
                                       long long rows, int nnz, long long d, int members,
                                       long long ms, long long cs, void* scratch, int width,
                                       int piece, int run, int hot, void* stream) {
  if (rows <= 0 || nnz <= 0) return 0;
  const long long words = fmt_bucketed_fleet_grad_scratch(rows, nnz, d, members, width, piece, run);
  if (words < 0 || hot < 0 || ms <= 0 || cs <= 0 || reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const void* kernels[] = {reinterpret_cast<const void*>(bucket_scatter_kernel),
                                  reinterpret_cast<const void*>(bucket_accumulate_kernel),
                                  reinterpret_cast<const void*>(bucket_count_kernel)};
  for (const void* kernel : kernels) {
    cudaFuncAttributes attrs;
    cudaError_t err = cudaFuncGetAttributes(&attrs, kernel);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kBlockSharedBytes - static_cast<int>(attrs.sharedSizeBytes));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long slots = rows * nnz;
  const int wbits = 31 - __builtin_clz(static_cast<unsigned>(width));
  const int buckets = static_cast<int>((d + width - 1) / width);
  const long long pieces = buckets + (slots + piece - 1) / piece;
  const int tile = members < kMaxTile ? members : kMaxTile;
  const int grid = static_cast<int>((slots + run - 1) / run);
  const auto s = static_cast<cudaStream_t>(stream);
  const BucketScratch scr = carve(static_cast<int*>(scratch), buckets, pieces, rows, members);
  cudaError_t err = cudaMemsetAsync(scr.counts, 0, 4LL * buckets, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* i = static_cast<const int32_t*>(idx);
  auto* g = static_cast<float*>(out);
  bucket_count_kernel<<<grid, kCountThreads, 4LL * buckets, s>>>(
      i, static_cast<const float*>(mult), scr, slots, static_cast<int>(rows), d, members, wbits,
      buckets, run);
  bucket_scan_kernel<<<1, kScanThreads, 0, s>>>(scr, buckets, piece);
  bucket_scatter_kernel<<<grid, kCountThreads, bucket_scatter_bytes(buckets, run), s>>>(
      i, static_cast<const float*>(vals), g, scr, slots, nnz, d, members, ms, cs, wbits, buckets,
      run);
  bucket_accumulate_kernel<<<dim3(static_cast<unsigned>(pieces), (members + tile - 1) / tile),
                             kAccThreads, 4LL * width * ((tile + 3) & ~3), s>>>(
      g, scr, d, members, ms, cs, wbits, buckets, tile, hot);
  return static_cast<int>(cudaGetLastError());
}
