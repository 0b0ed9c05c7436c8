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
//
// A warp takes 1024 consecutive slots: eight 16-byte loads a lane, lanes
// on neighbouring addresses, so all of a lane's 32 accesses are in flight
// at once. Both entries need idx 16-byte aligned and slots a multiple of
// 4, launch on the given stream and return a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kLoads = 8;                            // 16-byte loads per lane
constexpr int kSlotsPerWarp = kWarp * kLoads * 4;    // 1024

enum Probe { kGather, kRed, kGather8 };

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
  if (kProbe == kRed) {
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
      (kProbe == kGather8 && reinterpret_cast<uintptr_t>(coeff) % 16 != 0)) {
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
