// Floor probes for the sparse kernels of csrc/sparse_kernels.cu. They are
// built and run by chip_smoke.py only; nothing in the package loads them.
//
// Each probe does the least a kernel of the sparse path must do with the
// random side of its work, over the same (rows * nnz) slots of int32
// indices, so its time is the floor that the L2's rate of random 32-byte
// sectors sets for that kernel:
//
//   fmt_probe_gather: 16-byte loads of idx, a clamped gather of coeff per
//     valid slot (idx >= 0), and one sum written per 32 slots. It streams
//     4 bytes a slot from device memory (half of the dot's 8: no vals) and
//     gathers like sparse_row_dots.
//   fmt_probe_red: 16-byte loads of idx and one red.global.add.f32 of 1.0
//     per valid slot (0 <= idx < d) into a (d,) array the caller zeroed:
//     the atomic traffic of sparse_grad without its vals and multipliers.
//   fmt_probe_gather8: 16-byte loads of idx and, per valid slot, two
//     16-byte loads of the clamped row of a (d, 8) table through the
//     read-only path (both in one 32-byte sector), summed: the gathers of
//     fleet_row_dots at N = 8 with member-minor coefficients.
//   fmt_probe_red8: 16-byte loads of idx and, per valid slot (0 <= idx < d),
//     the adds of one member row of a (d, 8) table the caller zeroed, in one
//     of three forms (`form`): 0, two RED.128 of (1, 1, 1, 1), the adds of
//     fleet_grad's first design at N = 8 member-minor; 1, one RED.128 (to
//     members 0-3 only), to tell whether the L2 prices REDs by count or by
//     bytes; 2, one 32-byte bulk asynchronous reduction
//     (cp.reduce.async.bulk .add.f32) of eight 1.0s staged in shared memory,
//     Hopper's one request for the whole row.
//
// A warp takes 1024 consecutive slots: eight 16-byte loads a lane, lanes
// on neighbouring addresses, so all of a lane's 32 accesses are in flight
// at once. Every entry needs idx 16-byte aligned and slots a multiple of
// 4, launches on the given stream and returns a cudaError_t.

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
constexpr int kThreads = 256;
constexpr int kLoads = 8;                            // 16-byte loads per lane
constexpr int kSlotsPerWarp = kWarp * kLoads * 4;    // 1024

enum Probe { kGather, kRed, kGather8, kRed128x2, kRed128, kBulk32 };

template <Probe kProbe>
__global__ void probe_kernel(const int4* __restrict__ idx4, const float* __restrict__ coeff,
                             float* __restrict__ out, int64_t slots, int64_t d) {
  const int lane = threadIdx.x % kWarp;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const int64_t first4 = warp * (kSlotsPerWarp / 4);  // in units of int4
  const int64_t n4 = slots / 4;
  int4 c[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int64_t q = first4 + k * kWarp + lane;
    c[k] = q < n4 ? idx4[q] : make_int4(-1, -1, -1, -1);
  }
  if (kProbe == kRed128x2 || kProbe == kRed128 || kProbe == kBulk32) {
    __shared__ __align__(16) float ones[kThreads / kWarp][8];
    if (kProbe == kBulk32) {
      if (lane < 8) ones[threadIdx.x / kWarp][lane] = 1.0f;
      // the generic stores above, seen by the async proxy that reads them
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
    }
    const unsigned src = static_cast<unsigned>(__cvta_generic_to_shared(ones[threadIdx.x / kWarp]));
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int v[4] = {c[k].x, c[k].y, c[k].z, c[k].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (v[e] < 0 || v[e] >= d) continue;
        float* row = out + 8 * static_cast<int64_t>(v[e]);
        if (kProbe == kBulk32) {
          asm volatile(
              "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], 32;\n" ::"l"(
                  row),
              "r"(src)
              : "memory");
        } else {
#if FMT_VECTOR_RED
          const float4 one = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
          atomicAdd(reinterpret_cast<float4*>(row), one);  // RED.128
          if (kProbe == kRed128x2) atomicAdd(reinterpret_cast<float4*>(row + 4), one);
#else
          for (int m = 0; m < (kProbe == kRed128x2 ? 8 : 4); ++m) atomicAdd(row + m, 1.0f);
#endif
        }
      }
    }
    if (kProbe == kBulk32) {
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // `ones` is read
    }
  } else if (kProbe == kRed) {
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int v[4] = {c[k].x, c[k].y, c[k].z, c[k].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (v[e] >= 0 && v[e] < d) atomicAdd(out + v[e], 1.0f);
      }
    }
  } else if (kProbe == kGather8) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int v[4] = {c[k].x, c[k].y, c[k].z, c[k].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (v[e] >= 0) {
          const float4* row = reinterpret_cast<const float4*>(
              coeff + 8 * (v[e] < d ? static_cast<int64_t>(v[e]) : d - 1));
          const float4 lo = __ldg(row), hi = __ldg(row + 1);
          acc += ((lo.x + lo.y) + (lo.z + lo.w)) + ((hi.x + hi.y) + (hi.z + hi.w));
        }
      }
    }
    out[warp * kWarp + lane] = acc;
  } else {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int v[4] = {c[k].x, c[k].y, c[k].z, c[k].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (v[e] >= 0) acc += __ldg(coeff + (v[e] < d ? static_cast<int64_t>(v[e]) : d - 1));
      }
    }
    out[warp * kWarp + lane] = acc;
  }
}

template <Probe kProbe>
int launch(const void* idx, const void* coeff, void* out, long long slots, long long d,
           void* stream) {
  if (slots <= 0) return 0;
  if (slots % 4 != 0 || reinterpret_cast<uintptr_t>(idx) % 16 != 0 || d <= 0 ||
      (kProbe == kGather8 && reinterpret_cast<uintptr_t>(coeff) % 16 != 0) ||
      ((kProbe == kRed128x2 || kProbe == kRed128 || kProbe == kBulk32) &&
       reinterpret_cast<uintptr_t>(out) % 32 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long warps = (slots + kSlotsPerWarp - 1) / kSlotsPerWarp;
  const long long blocks = (warps * kWarp + kThreads - 1) / kThreads;
  probe_kernel<kProbe><<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(idx), static_cast<const float*>(coeff), static_cast<float*>(out),
      slots, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `out` holds one float per 32 slots, rounded up to whole warps:
// ceil(slots / 1024) * 32 floats.
extern "C" int fmt_probe_gather(const void* idx, const void* coeff, void* out, long long slots,
                                long long d, void* stream) {
  return launch<kGather>(idx, coeff, out, slots, d, stream);
}

// `grad` is (d,) float32, zeroed by the caller.
extern "C" int fmt_probe_red(const void* idx, void* grad, long long slots, long long d,
                             void* stream) {
  return launch<kRed>(idx, nullptr, grad, slots, d, stream);
}

// `table` is (d, 8) float32, contiguous and 16-byte aligned; `out` as for
// fmt_probe_gather.
extern "C" int fmt_probe_gather8(const void* idx, const void* table, void* out, long long slots,
                                 long long d, void* stream) {
  return launch<kGather8>(idx, table, out, slots, d, stream);
}

// `table` is (d, 8) float32, contiguous, 32-byte aligned and zeroed by the
// caller; `form` 0: two RED.128 a slot, 1: one RED.128, 2: one 32-byte bulk
// reduction.
extern "C" int fmt_probe_red8(const void* idx, void* table, long long slots, long long d, int form,
                              void* stream) {
  switch (form) {
    case 0: return launch<kRed128x2>(idx, nullptr, table, slots, d, stream);
    case 1: return launch<kRed128>(idx, nullptr, table, slots, d, stream);
    case 2: return launch<kBulk32>(idx, nullptr, table, slots, d, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
