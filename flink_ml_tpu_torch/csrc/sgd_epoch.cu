// Hand-written Hopper (sm_90a) kernels for the SGD engine's epoch: the
// elementwise work of one epoch of the linear models' mini-batch SGD
// (ops/optimizer.py `_update_model`, `_masked_epoch`; ops/losses.py
// `_dense`, `_sparse`), bound by ops/sgdkernels.py.
//
// They replace no TPU kernel. The JAX package leaves this work to XLA,
// which fuses an epoch's elementwise ops into the contractions around
// them. PyTorch runs each op as a kernel of its own: about 40 launches an
// epoch, most of them on a handful of scalars or on the batch's rows, each
// bound by its launch, not by the bytes it moves. Two kernels take their
// place:
//
// sgd_update_kernel, one pass over the model's d coefficients:
//     u   = coeff - (1 / max(wsum, 1e-30) * lr) * grad
//     u  -= lr * (l1 * sign(u) + l2 * u)          where reg > 0
//     out = u where (wsum > 0 and the epoch is live), else coeff
// with lr, reg, l1 = elasticNet * reg, l2 = (1 - elasticNet) * reg and tol
// read from the fit's hyperparameter vector (ops/optimizer.py
// `sgd_hyper`), wsum from device memory, and the epoch live where the
// criteria passed in are above tol (no criteria: always live). A dead
// epoch writes the old coefficient, so the body selects nothing after.
//
// sgd_pointwise_kernel, one pass over the batch's rows: the per-row loss
// and multiplier of one of the three pointwise forms (a template
// argument: the logistic, hinge and least-squares losses of
// ops/losses.py), from the row dot, the label and the weight; it writes
// the multiplier and sums the loss and the weight. Given the body's state
// it also writes the epoch's tail under the tol mask: live = criteria >
// tol, and where live the new weight sum, epoch + 1 and criteria =
// lsum / max(wsum, 1e-30) (float32), else the old ones.
//
// The bits. Each op of the replaced sequence rounds once, and the kernels
// round where it does: the arithmetic goes through __fadd_rn, __fsub_rn,
// __fmul_rn and __fdiv_rn (their double forms for float64 fits), because
// nvcc would otherwise contract a * b + c into one FMA, which ATen's
// one-op kernels never form. sign is ATen's (0 at +-0 and NaN), clamp
// keeps NaN, max is fmax, and exp, log1p are the math library's, as
// ATen's kernels call them, so the update equals the op sequence bit for
// bit and the multiplier within the math library's rounding.
//
// The sums are taken in a fixed order, so they repeat from run to run: a
// thread adds its rows (row = thread + k * grid threads) in turn, each
// block reduces its threads with a shuffle tree (lanes, then warps), and
// the last block to finish, found by a ticket counter, reduces the
// blocks' partials with the same tree. No float atomics. The ticket
// counters are static device memory, zero at load; a launch takes the
// slot of its stream (ops/sgdkernels.py), and its last block resets it,
// so launches in turn on one stream, replays of a graph included, reuse
// it. ops/sgdkernels.py `_point_plan` gives the grid: at most kThreads
// blocks, so one thread of the last block holds each partial.
//
// What bounds them: bytes. The update reads 2 d values and writes d
// (12 MB at d = 1e6 in float32, 3.6 us at 3.35 TB/s; the model and its
// gradient were just touched and sit in the 50 MB L2). The pointwise
// pass reads 3 values a row and writes one (1.6 MB at the fit batch of
// 100,000 rows, 0.5 us); at that size its time is its launch and the
// last block's tree. The update streams 16-byte packs, a thread reading
// the scalars once for all of its packs; the pointwise pass coalesced 4-
// or 8-byte loads. The work a value is a few flops.
//
// Interface: plain C, for ctypes. Each entry launches on the given stream,
// does not synchronise, allocates nothing and returns a cudaError_t (0 on
// success). `dtype` is 0 for float32, 1 for float64.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

// The rows of the hyperparameter vector (ops/optimizer.py HYPER_*).
constexpr int kLr = 0, kReg = 1, kTol = 3, kL1 = 4, kL2 = 5;
// The pointwise pass: threads a block (ops/sgdkernels.py POINT_THREADS).
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Ticket counters, one a stream slot (ops/sgdkernels.py TICKET_SLOTS).
constexpr int kSlots = 1024;
// The pointwise forms (ops/sgdkernels.py FORMS).
constexpr int kLogistic = 0, kHinge = 1, kLeastSquare = 2;

__device__ unsigned int g_tickets[kSlots];

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }
__device__ __forceinline__ float log1p_(float a) { return log1pf(a); }
__device__ __forceinline__ double log1p_(double a) { return log1p(a); }
__device__ __forceinline__ float fmax_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float fabs_(float a) { return fabsf(a); }
__device__ __forceinline__ double fabs_(double a) { return fabs(a); }

// torch.clamp(v, min=lo): NaN stays NaN.
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return v != v ? v : fmax_(v, lo);
}

// One coefficient's update, op for op.
template <typename T>
__device__ __forceinline__ T updated(T c, T g, T scale, T lr, T reg, T l1, T l2) {
  T u = sub_rn(c, mul_rn(scale, g));
  if (reg > T(0)) {
    const T sg = static_cast<T>((T(0) < u) - (u < T(0)));
    u = sub_rn(u, mul_rn(lr, add_rn(mul_rn(l1, sg), mul_rn(l2, u))));
  }
  return u;
}

// 16 bytes of T: the update's loads and stores where its vectors are
// 16-byte aligned.
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  using type = float4;
};
template <>
struct Pack<double> {
  using type = double2;
};

// A thread takes 16-byte packs j = thread, thread + grid threads, ... of
// the d coefficients where `packed` (coeff, grad and out 16-byte aligned),
// then the tail past the last whole pack one coefficient at a time. The
// hyperparameters, wsum and the mask are read once a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sgd_update_kernel(const T* __restrict__ coeff, const T* __restrict__ grad,
                      const T* __restrict__ wsum, const T* __restrict__ hyper,
                      const float* __restrict__ criteria, T* __restrict__ out, int64_t d,
                      int packed) {
  using P = typename Pack<T>::type;
  constexpr int kPer = sizeof(P) / sizeof(T);
  const T ws = *wsum;
  const T lr = hyper[kLr], reg = hyper[kReg], l1 = hyper[kL1], l2 = hyper[kL2];
  const bool live = criteria == nullptr || static_cast<T>(*criteria) > hyper[kTol];
  const bool apply = live && ws > T(0);
  // (reciprocal(clamp(wsum, 1e-30)) * lr): 1 / x is ATen's reciprocal
  const T scale = mul_rn(div_rn(T(1), clamp_min(ws, static_cast<T>(1e-30))), lr);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t thread = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t whole = packed ? d / kPer : 0;
  for (int64_t j = thread; j < whole; j += stride) {
    P c = reinterpret_cast<const P*>(coeff)[j];
    if (apply) {
      const P g = reinterpret_cast<const P*>(grad)[j];
      T* cv = reinterpret_cast<T*>(&c);
      const T* gv = reinterpret_cast<const T*>(&g);
#pragma unroll
      for (int u = 0; u < kPer; ++u) cv[u] = updated(cv[u], gv[u], scale, lr, reg, l1, l2);
    }
    reinterpret_cast<P*>(out)[j] = c;
  }
  for (int64_t i = whole * kPer + thread; i < d; i += stride) {
    const T c = coeff[i];
    out[i] = apply ? updated(c, grad[i], scale, lr, reg, l1, l2) : c;
  }
}

// (per-row loss, multiplier) of one row, op for op as ops/losses.py's
// pointwise forms compute them.
template <typename T, int Form>
__device__ __forceinline__ void pointwise(T dot, T y, T w, T& loss, T& mult) {
  if (Form == kLeastSquare) {
    const T diff = sub_rn(dot, y);
    loss = mul_rn(mul_rn(mul_rn(w, T(0.5)), diff), diff);
    mult = mul_rn(w, diff);
    return;
  }
  const T ls = sub_rn(mul_rn(T(2), y), T(1));
  if (Form == kLogistic) {
    const T margin = mul_rn(dot, ls);
    // logaddexp(0, -margin): max(a, b) + log1p(exp(-|a - b|))
    const T b = -margin;
    const T m = fmax_(T(0), b);
    loss = mul_rn(w, add_rn(m, log1p_(exp_(-fabs_(sub_rn(T(0), b))))));
    mult = mul_rn(w, div_rn(-ls, add_rn(exp_(margin), T(1))));
  } else {
    const T margin = sub_rn(T(1), mul_rn(ls, dot));
    loss = mul_rn(w, clamp_min(margin, T(0)));
    mult = margin > T(0) ? mul_rn(-ls, w) : T(0);
  }
}

// The sum of a block's values in thread 0: lanes, then warps, each a
// shuffle tree adding lane t + h to lane t.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* stage) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int h = 16; h > 0; h /= 2) v = add_rn(v, __shfl_down_sync(0xffffffffu, v, h));
  if (lane == 0) stage[warp] = v;
  __syncthreads();
  T r = T(0);
  if (warp == 0) {
    r = lane < kWarps ? stage[lane] : T(0);
#pragma unroll
    for (int h = kWarps / 2; h > 0; h /= 2) r = add_rn(r, __shfl_down_sync(0xffffffffu, r, h));
  }
  __syncthreads();
  return r;
}

// The state the single-card body hands the pointwise pass, and where the
// pass writes the epoch's tail; all null where the caller takes the sums.
template <typename T>
struct Tail {
  const T* hyper;
  const T* wsum_old;
  const int32_t* epoch_old;
  const float* criteria_old;
  T* wsum_out;
  int32_t* epoch_out;
  float* criteria_out;
  bool* live_out;
};

template <typename T, int Form>
__global__ void __launch_bounds__(kThreads)
    sgd_pointwise_kernel(const T* __restrict__ dot, const T* __restrict__ y,
                         const T* __restrict__ w, int64_t rows, int passes,
                         T* __restrict__ mult, T* partials, unsigned int* ticket,
                         T* __restrict__ sums, Tail<T> tail) {
  __shared__ T stage[kWarps];
  __shared__ bool last;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  T lacc = T(0), wacc = T(0);
  for (int k = 0; k < passes; ++k, i += stride) {
    T loss = T(0), wv = T(0);
    if (i < rows) {
      wv = w[i];
      T m;
      pointwise<T, Form>(dot[i], y[i], wv, loss, m);
      mult[i] = m;
    }
    lacc = add_rn(lacc, loss);
    wacc = add_rn(wacc, wv);
  }
  lacc = block_sum(lacc, stage);
  wacc = block_sum(wacc, stage);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = lacc;
    partials[gridDim.x + blockIdx.x] = wacc;
    __threadfence();
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;  // the last resets it to 0
  }
  __syncthreads();
  if (!last) return;
  const int g = gridDim.x;
  T lp = threadIdx.x < g ? __ldcg(partials + threadIdx.x) : T(0);
  T wp = threadIdx.x < g ? __ldcg(partials + g + threadIdx.x) : T(0);
  lp = block_sum(lp, stage);
  wp = block_sum(wp, stage);
  if (threadIdx.x != 0) return;
  sums[0] = lp;
  sums[1] = wp;
  if (tail.criteria_old == nullptr) return;
  const bool live = static_cast<T>(*tail.criteria_old) > tail.hyper[kTol];
  const float criteria = static_cast<float>(div_rn(lp, clamp_min(wp, static_cast<T>(1e-30))));
  *tail.wsum_out = live ? wp : *tail.wsum_old;
  *tail.epoch_out = live ? *tail.epoch_old + 1 : *tail.epoch_old;
  *tail.criteria_out = live ? criteria : *tail.criteria_old;
  *tail.live_out = live;
}

template <typename T>
cudaError_t launch_update(const void* coeff, const void* grad, const void* wsum,
                          const void* hyper, const void* criteria, void* out, long long d,
                          int packed, int grid, cudaStream_t stream) {
  sgd_update_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(coeff), static_cast<const T*>(grad), static_cast<const T*>(wsum),
      static_cast<const T*>(hyper), static_cast<const float*>(criteria), static_cast<T*>(out), d,
      packed);
  return cudaGetLastError();
}

template <typename T, int Form>
void launch_form(const void* dot, const void* y, const void* w, long long rows, int grid,
                 int passes, void* mult, void* partials, unsigned int* ticket, void* sums,
                 const Tail<T>& tail, cudaStream_t stream) {
  sgd_pointwise_kernel<T, Form><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dot), static_cast<const T*>(y), static_cast<const T*>(w), rows, passes,
      static_cast<T*>(mult), static_cast<T*>(partials), ticket, static_cast<T*>(sums), tail);
}

template <typename T>
cudaError_t launch_pointwise(int form, const void* dot, const void* y, const void* w,
                             long long rows, int grid, int passes, void* mult, void* partials,
                             unsigned int* ticket, void* sums,
                             const void* hyper, const void* wsum_old, const void* epoch_old,
                             const void* criteria_old, void* wsum_out, void* epoch_out,
                             void* criteria_out, void* live_out, cudaStream_t stream) {
  const Tail<T> tail{static_cast<const T*>(hyper), static_cast<const T*>(wsum_old),
                     static_cast<const int32_t*>(epoch_old),
                     static_cast<const float*>(criteria_old), static_cast<T*>(wsum_out),
                     static_cast<int32_t*>(epoch_out), static_cast<float*>(criteria_out),
                     static_cast<bool*>(live_out)};
  switch (form) {
    case kLogistic:
      launch_form<T, kLogistic>(dot, y, w, rows, grid, passes, mult, partials, ticket, sums,
                                tail, stream);
      break;
    case kHinge:
      launch_form<T, kHinge>(dot, y, w, rows, grid, passes, mult, partials, ticket, sums, tail,
                             stream);
      break;
    default:
      launch_form<T, kLeastSquare>(dot, y, w, rows, grid, passes, mult, partials, ticket, sums,
                                   tail, stream);
  }
  return cudaGetLastError();
}

// The ticket counters' address on the current device, looked up once a
// device, so a launch under stream capture makes no lookup.
cudaError_t ticket_base(unsigned int** out) {
  static std::atomic<unsigned int*> found[64];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  unsigned int* base = found[device].load();
  if (base == nullptr) {
    err = cudaGetSymbolAddress(reinterpret_cast<void**>(&base), g_tickets);
    if (err != cudaSuccess) return err;
    found[device].store(base);
  }
  *out = base;
  return cudaSuccess;
}

}  // namespace

// The update over d coefficients on `grid` blocks of kThreads, in 16-byte
// packs where `packed` (refused unless coeff, grad and out are 16-byte
// aligned); `criteria` null: every epoch live.
extern "C" int fmt_sgd_update(int dtype, const void* coeff, const void* grad, const void* wsum,
                              const void* hyper, const void* criteria, void* out, long long d,
                              int packed, int grid, void* stream) {
  if (d <= 0) return 0;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (grid <= 0 || (dtype != 0 && dtype != 1) ||
      (packed && !(aligned(coeff) && aligned(grad) && aligned(out)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch_update<float>(coeff, grad, wsum, hyper, criteria, out, d, packed, grid, s)
          : launch_update<double>(coeff, grad, wsum, hyper, criteria, out, d, packed, grid, s);
  return static_cast<int>(err);
}

// The pointwise pass over `rows` rows on `grid` blocks (1 to kThreads) of
// kThreads, `passes` rows a thread; `partials` holds 2 * grid values; the
// tail's pointers all null or all set (criteria_old decides).
extern "C" int fmt_sgd_pointwise(int dtype, int form, const void* dot, const void* y,
                                 const void* w, long long rows, int grid, int passes, void* mult,
                                 void* partials, int slot, void* sums, const void* hyper,
                                 const void* wsum_old,
                                 const void* epoch_old, const void* criteria_old, void* wsum_out,
                                 void* epoch_out, void* criteria_out, void* live_out,
                                 void* stream) {
  if (rows < 0 || grid <= 0 || grid > kThreads || passes < 0 ||
      static_cast<long long>(grid) * kThreads * passes < rows || slot < 0 || slot >= kSlots ||
      form < kLogistic || form > kLeastSquare || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned int* tickets = nullptr;
  const cudaError_t found = ticket_base(&tickets);
  if (found != cudaSuccess) return static_cast<int>(found);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch_pointwise<float>(form, dot, y, w, rows, grid, passes, mult, partials,
                                    tickets + slot, sums, hyper, wsum_old, epoch_old,
                                    criteria_old, wsum_out, epoch_out, criteria_out, live_out, s)
          : launch_pointwise<double>(form, dot, y, w, rows, grid, passes, mult, partials,
                                     tickets + slot, sums, hyper, wsum_old, epoch_old,
                                     criteria_old, wsum_out, epoch_out, criteria_out, live_out,
                                     s);
  return static_cast<int>(err);
}
