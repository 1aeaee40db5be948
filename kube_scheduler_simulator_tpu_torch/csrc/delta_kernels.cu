// K10: the delta encoder's row scatters into the retained encoding, for
// Hopper (sm_90a). They replace the reference package's three device
// programs in engine/delta.py `_scatter_fns` (delta.py:183 `delta.scatter_set`,
// :188 `delta.scatter_add`, :193 `delta.vec_add`):
//
//   delta_scatter_set  arr[idx[j]] = rows[j]      (rows of 1-, 4- or 8-byte elements)
//   delta_scatter_add  arr[idx[j]] += rows[j]     (int32 or int64; repeated indices sum)
//   delta_vec_add      arr += vec                 (int32 or int64)
//
// Each updates the retained tensor in place (the reference donates the
// stale buffer to XLA for the same effect) and takes the live row count k:
// nothing here compiles per shape, so no padding is needed. One thread per
// (row, element), in a grid-stride loop. The add uses integer atomics
// (atomicAdd on int for int32, on unsigned long long for int64: the same
// two's-complement sum), so int32 wraps mod 2^32 as XLA's scatter-add does.
// The wrapper (engine/scatter.py) refuses a repeated index for set, where
// the winner would be unspecified, and skips empty updates: a grid of 0
// blocks is an invalid launch.
//
// Bound on the card: bytes. Each call moves k rows (read, then written;
// an add reads the target row too) and k 4-byte indices, a few kilobytes
// to a few megabytes a delta pass, so at 3.35 TB/s the bound is well under
// a microsecond and the launch itself (a few microseconds) dominates. The
// design does nothing about that yet; fusing one pass's field scatters into
// one launch through a table of (pointer, width, count) descriptors is the
// lever (ROADMAP).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

long long blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

template <typename T>
__global__ void scatter_set_kernel(T* __restrict__ arr, const int* __restrict__ idx,
                                   const T* __restrict__ rows, long long k, long long w) {
  const long long n = k * w;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n; t += stride) {
    const long long j = t / w;
    arr[(long long)idx[j] * w + (t - j * w)] = rows[t];
  }
}

__device__ __forceinline__ void atomic_add(int32_t* p, int32_t v) {
  atomicAdd(reinterpret_cast<int*>(p), static_cast<int>(v));
}

__device__ __forceinline__ void atomic_add(int64_t* p, int64_t v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p), static_cast<unsigned long long>(v));
}

template <typename T>
__global__ void scatter_add_kernel(T* __restrict__ arr, const int* __restrict__ idx,
                                   const T* __restrict__ rows, long long k, long long w) {
  const long long n = k * w;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n; t += stride) {
    const long long j = t / w;
    atomic_add(arr + (long long)idx[j] * w + (t - j * w), rows[t]);
  }
}

template <typename T, typename U>
__global__ void vec_add_kernel(T* __restrict__ arr, const T* __restrict__ vec, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n; t += stride) {
    // unsigned arithmetic: the two's-complement wrap, without signed overflow
    arr[t] = static_cast<T>(static_cast<U>(arr[t]) + static_cast<U>(vec[t]));
  }
}

template <typename T>
int launch_set(void* arr, const void* idx, const void* rows, long long k, long long w,
               cudaStream_t stream) {
  scatter_set_kernel<T><<<(unsigned)blocks_for(k * w), kThreads, 0, stream>>>(
      static_cast<T*>(arr), static_cast<const int*>(idx), static_cast<const T*>(rows), k, w);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_add(void* arr, const void* idx, const void* rows, long long k, long long w,
               cudaStream_t stream) {
  scatter_add_kernel<T><<<(unsigned)blocks_for(k * w), kThreads, 0, stream>>>(
      static_cast<T*>(arr), static_cast<const int*>(idx), static_cast<const T*>(rows), k, w);
  return (int)cudaGetLastError();
}

template <typename T, typename U>
int launch_vec(void* arr, const void* vec, long long n, cudaStream_t stream) {
  vec_add_kernel<T, U><<<(unsigned)blocks_for(n), kThreads, 0, stream>>>(
      static_cast<T*>(arr), static_cast<const T*>(vec), n);
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface (bound with ctypes). `k` rows of `w` elements of `elem`
// bytes; each returns the launch's cudaError, or -1 for an element size it
// does not take. The caller guarantees k * w > 0 (n > 0 for vec_add).

extern "C" int delta_scatter_set(void* arr, const void* idx, const void* rows, long long k,
                                 long long w, int elem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem) {
    case 1: return launch_set<uint8_t>(arr, idx, rows, k, w, s);
    case 4: return launch_set<uint32_t>(arr, idx, rows, k, w, s);
    case 8: return launch_set<uint64_t>(arr, idx, rows, k, w, s);
    default: return -1;
  }
}

extern "C" int delta_scatter_add(void* arr, const void* idx, const void* rows, long long k,
                                 long long w, int elem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem) {
    case 4: return launch_add<int32_t>(arr, idx, rows, k, w, s);
    case 8: return launch_add<int64_t>(arr, idx, rows, k, w, s);
    default: return -1;
  }
}

extern "C" int delta_vec_add(void* arr, const void* vec, long long n, int elem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem) {
    case 4: return launch_vec<int32_t, uint32_t>(arr, vec, n, s);
    case 8: return launch_vec<int64_t, uint64_t>(arr, vec, n, s);
    default: return -1;
  }
}
