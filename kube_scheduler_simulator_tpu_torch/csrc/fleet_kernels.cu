// K12: the fleet observatory's cluster-quality reductions, for Hopper
// (sm_90a). It replaces the reference package's `fleet.quality` program,
// kube_scheduler_simulator_tpu/utils/fleetstats.py:258 `_quality` (jitted
// by `_quality_program`, :299, and called once a sampled pass by
// `sample_pass`, :425). Over one pass's encoded cluster and final state:
//
//   has[n, r]  = alloc[n, r] > 0 && node_mask[n]
//   ratio      = has ? used / max(alloc, 1) : 0          (float32)
//   util[n]    = clip(max_r ratio[n, r], 0, 1)
//   hist[b]    = #{n : node_mask[n], clip(int(util * 10), 0, 9) == b}
//   mean       = sum_{node_mask} util / max(#node_mask, 1)
//   max        = max_{node_mask} util (0 when none)
//   free[n, r] = has ? max(alloc - used, 0) : 0
//   frag[r]    = total > 0 ? 1 - largest / total : 0, over free[:, r]
//   pending    = #{p : pod_mask[p], assignment[p] < 0}
//
// in float32 whatever the plane's integer type (the int32 and int64
// instantiations). The arithmetic is the reference's bit for bit: integers
// convert to float32 rounding to nearest, the quotient is IEEE division
// (no --use_fast_math), `util * 10` is a float32 product truncated toward
// zero, and no step may contract to a fused multiply-add. The sums (mean,
// total free) run in another order than XLA's, so the mean and the
// fragmentation agree to about 1e-7 relative; the histogram, pending, max
// and largest free are exact.
//
// One launch of one block of kThreads threads a sample: the threads stride
// over the N nodes (then over P pods), count the bins and pending with
// shared-memory atomics, reduce their partial sums and maxima in a
// shared-memory tree, and thread 0 writes every output into one int32
// buffer (engine/cuda.py FLEET_HEAD + R words: the 10 bins, pending, the
// mean's and max's float bits, then the R fragmentation lanes' float
// bits), so a sample reads back once.
//
// Bound on the card: bytes. A sample reads node_alloc and requested (2 N R
// elements), the node mask (N B), assignment and the pod mask (5 P B) once
// and writes (13 + R) x 4 B: 113 KiB at phase 4d's serving state, 0.03 us
// at 3.35 TB/s, far below a launch. One block is enough at these sizes:
// the launch and the block's few passes over the planes set the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // a power of two: the trees halve it
constexpr int kBins = 10;
constexpr float kLowest = -3.402823466e+38f;  // below every finite ratio

__device__ __forceinline__ float to_f(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_f(long long v) { return __ll2float_rn(v); }

// The block's sum (kMax false) or max (kMax true) of `v`, through `sh`
// (blockDim.x floats); every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float v, float* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int s = (int)blockDim.x / 2; s > 0; s /= 2) {
    if (t < s) sh[t] = kMax ? fmaxf(sh[t], sh[t + s]) : __fadd_rn(sh[t], sh[t + s]);
    __syncthreads();
  }
  const float r = sh[0];
  __syncthreads();  // sh is free again
  return r;
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
fleet_quality_kernel(const I* __restrict__ alloc, const uint8_t* __restrict__ node_mask,
                     const I* __restrict__ used, const int32_t* __restrict__ assignment,
                     const uint8_t* __restrict__ pod_mask, int N, int R, int P,
                     int32_t* __restrict__ out) {
  __shared__ float sh[kThreads];
  __shared__ int counts[kBins + 2];  // the bins, the real nodes, pending
  const int t = threadIdx.x;
  const int step = (int)blockDim.x;
  for (int i = t; i < kBins + 2; i += step) counts[i] = 0;
  __syncthreads();

  // per node: the dominant utilization, its bin and the masked sum and max
  int real = 0;
  float sum = 0.0f, mx = 0.0f;
  for (int n = t; n < N; n += step) {
    const bool m = node_mask[n] != 0;
    float u = kLowest;
    for (int r = 0; r < R; ++r) {
      const float a = to_f(alloc[(long long)n * R + r]);
      const float ratio = (a > 0.0f && m)
          ? __fdiv_rn(to_f(used[(long long)n * R + r]), fmaxf(a, 1.0f)) : 0.0f;
      u = fmaxf(u, ratio);
    }
    u = fminf(fmaxf(u, 0.0f), 1.0f);
    if (m) {
      int b = (int)__fmul_rn(u, 10.0f);  // truncates toward zero
      b = b < 0 ? 0 : (b > kBins - 1 ? kBins - 1 : b);
      atomicAdd(&counts[b], 1);
      ++real;
      sum = __fadd_rn(sum, u);
      mx = fmaxf(mx, u);
    }
  }
  if (real) atomicAdd(&counts[kBins], real);

  // pending: real pods with no node
  int pending = 0;
  for (int p = t; p < P; p += step) pending += (pod_mask[p] != 0 && assignment[p] < 0);
  if (pending) atomicAdd(&counts[kBins + 1], pending);

  sum = block_reduce<false>(sum, sh);
  mx = block_reduce<true>(mx, sh);  // its barriers also publish `counts`
  float* outf = reinterpret_cast<float*>(out + kBins + 1);
  if (t == 0) {
    for (int b = 0; b < kBins; ++b) out[b] = counts[b];
    out[kBins] = counts[kBins + 1];
    const int nr = counts[kBins] > 1 ? counts[kBins] : 1;
    outf[0] = __fdiv_rn(sum, to_f(nr));
    outf[1] = mx;
  }

  // per resource: the largest free block and the total free
  for (int r = 0; r < R; ++r) {
    float big = 0.0f, total = 0.0f;
    for (int n = t; n < N; n += step) {
      const float a = to_f(alloc[(long long)n * R + r]);
      if (a > 0.0f && node_mask[n] != 0) {
        const float f = fmaxf(__fsub_rn(a, to_f(used[(long long)n * R + r])), 0.0f);
        big = fmaxf(big, f);
        total = __fadd_rn(total, f);
      }
    }
    big = block_reduce<true>(big, sh);
    total = block_reduce<false>(total, sh);
    if (t == 0) outf[2 + r] = total > 0.0f ? __fsub_rn(1.0f, __fdiv_rn(big, total)) : 0.0f;
  }
}

template <typename I>
int launch(const void* alloc, const void* node_mask, const void* used, const void* assignment,
           const void* pod_mask, int N, int R, int P, void* out, void* stream) {
  fleet_quality_kernel<I><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const I*>(alloc), static_cast<const uint8_t*>(node_mask),
      static_cast<const I*>(used), static_cast<const int32_t*>(assignment),
      static_cast<const uint8_t*>(pod_mask), N, R, P, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface (bound with ctypes): contiguous node_alloc and requested
// [N, R] of the instantiation's type, bool node_mask [N], int32 assignment
// and bool pod_mask [P], and the int32 output buffer [13 + R]. Returns the
// launch's cudaError.
extern "C" int fleet_quality_i32(const void* alloc, const void* node_mask, const void* used,
                                 const void* assignment, const void* pod_mask, int N, int R,
                                 int P, void* out, void* stream) {
  return launch<int>(alloc, node_mask, used, assignment, pod_mask, N, R, P, out, stream);
}

extern "C" int fleet_quality_i64(const void* alloc, const void* node_mask, const void* used,
                                 const void* assignment, const void* pod_mask, int N, int R,
                                 int P, void* out, void* stream) {
  return launch<long long>(alloc, node_mask, used, assignment, pod_mask, N, R, P, out, stream);
}
