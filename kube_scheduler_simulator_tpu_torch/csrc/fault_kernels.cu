// Hand-written Hopper (sm_90a) kernels for the Monte-Carlo node-failure
// sweep, K11 `faultsweep.one`/`vrun` of
// kube_scheduler_simulator_tpu/lifecycle/faultsweep.py (`one_scenario`,
// :79-98). A sweep is S failure scenarios of one cluster, each a stacked
// state slice (`variant_state`, the byte strides of `StateStride`):
//
//   fault_evict  the scenario prologue (:81-90): every pod bound in scenario
//                s whose node failed in fail[s] leaves scenario s's state
//                (`evict_pod`, the engine's evict_all for one pod), its
//                assignment and bind order become -1; writes the evict mask
//                [S, P], the evicted count [S] and each scenario's node mask
//                row node_mask & ~fail[s] [S, N].
//   fault_tally  the counters (:92-98): rescheduled[s] = the evicted pods of
//                scenario s bound again at the end, stranded[s] = evicted[s]
//                - rescheduled[s], in int32.
//
// Between them the round fixpoint of every scenario runs through the K9
// kernels' tenant forms (gang_kernels.cu), one launch of each a round: a
// scenario is a tenant whose Planes entry differs from the cluster's only in
// its node mask row (engine/cuda.py `scenario_table`), so every read of
// node_mask — the filters, the relational prologue's topology domains, the
// spread keys — sees the scenario's own mask.
//
// This unit takes seq_kernels.cu's device functions (`evict_pod`,
// `variant_state`, `atomic_add`) and none of its entry points: the build
// compiles it apart, once for both integer types, beside the units of
// seq_kernels.cu, whose instantiations it leaves as they are.
//
// Bound on the card. fault_evict reads each scenario's assignment row and
// the failed flag of each bound pod's node (S x P x 5 B), and for each
// evicted pod moves its rows out of the scenario's node planes; it writes
// the masks (S x (P + N) B). fault_tally reads S x P x 5 B and writes 8 B a
// scenario. Both are memory-bound: a grid of 256-thread blocks strides over
// the (scenario, pod) pairs, the integer atomics commute, and nothing
// waits on another element.

#undef SEQ_TENANT
#define SEQ_TENANT 2  // seq_kernels.cu's entry points are in its own units
#include "seq_kernels.cu"

namespace {

constexpr int FAULT_THREADS = 256;
constexpr long long FAULT_MAX_BLOCKS = 4096;

int fault_blocks(long long work) {
  const long long b = (work + FAULT_THREADS - 1) / FAULT_THREADS;
  return (int)(b < 1 ? 1 : (b > FAULT_MAX_BLOCKS ? FAULT_MAX_BLOCKS : b));
}

// The element this thread starts at, and the grid's stride.
__device__ __forceinline__ long long grid_start() {
  return (long long)blockIdx.x * (long long)(unsigned)blockDim.x + (long long)threadIdx.x;
}
__device__ __forceinline__ long long grid_stride() {
  return (long long)gridDim.x * (long long)(unsigned)blockDim.x;
}

// Scenario s evicts bound pod p when fail[s, assignment[s, p]]; `evicted`
// holds zeros on entry.
template <typename I>
__global__ void __launch_bounds__(FAULT_THREADS)
    fault_evict_kernel(Planes a, State s0, StateStride ss, int S, const unsigned char* fail,
                       unsigned char* evict, int* evicted, unsigned char* node_mask_out) {
  const long long P = a.P, N = a.N;
  for (long long i = grid_start(); i < (long long)S * P; i += grid_stride()) {
    const int sc = (int)(i / P), p = (int)(i % P);
    const State s = variant_state(s0, ss, sc);
    const int n = s.assignment[p];
    const bool hit = n >= 0 && fail[(size_t)sc * N + n];
    evict[i] = hit;
    if (hit) {
      evict_pod<I>(a, s, p, n);
      atomicAdd(&evicted[sc], 1);
    }
  }
  for (long long i = grid_start(); i < (long long)S * N; i += grid_stride())
    node_mask_out[i] = a.node_mask[i % N] && !fail[i];
}

// One block a scenario at a time: its evicted pods bound at the end.
__global__ void __launch_bounds__(FAULT_THREADS)
    fault_tally_kernel(const int* assignment, const unsigned char* evict, const int* evicted,
                       int S, int P, int* rescheduled, int* stranded) {
  __shared__ int total;
  for (int sc = blockIdx.x; sc < S; sc += gridDim.x) {
    if (threadIdx.x == 0) total = 0;
    __syncthreads();
    const size_t row = (size_t)sc * P;
    int c = 0;
    for (int p = threadIdx.x; p < P; p += blockDim.x)
      c += assignment[row + p] >= 0 && evict[row + p];
    if (c) atomicAdd(&total, c);
    __syncthreads();
    if (threadIdx.x == 0) {
      rescheduled[sc] = total;
      stranded[sc] = evicted[sc] - total;
    }
    __syncthreads();  // `total` is cleared for the next scenario
  }
}

}  // namespace

extern "C" {

#define FAULT_ENTRY_POINTS(T, I)                                                              \
  int fault_evict_##T(const Planes* a, const State* s, const StateStride* ss, int S,          \
                      const unsigned char* fail, unsigned char* evict, int* evicted,          \
                      unsigned char* node_mask_out, void* stream) {                           \
    const long long work = (long long)S * (a->P > a->N ? a->P : a->N);                        \
    fault_evict_kernel<I><<<fault_blocks(work), FAULT_THREADS, 0, (cudaStream_t)stream>>>(    \
        *a, *s, *ss, S, fail, evict, evicted, node_mask_out);                                 \
    return (int)cudaGetLastError();                                                           \
  }

FAULT_ENTRY_POINTS(i32, int)
FAULT_ENTRY_POINTS(i64, long long)

int fault_tally(const int* assignment, const unsigned char* evict, const int* evicted, int S,
                int P, int* rescheduled, int* stranded, void* stream) {
  const int blocks = S < 1 ? 1 : (S > FAULT_MAX_BLOCKS ? (int)FAULT_MAX_BLOCKS : S);
  fault_tally_kernel<<<blocks, FAULT_THREADS, 0, (cudaStream_t)stream>>>(
      assignment, evict, evicted, S, P, rescheduled, stranded);
  return (int)cudaGetLastError();
}

}  // extern "C"
