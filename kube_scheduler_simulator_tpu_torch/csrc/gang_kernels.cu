// Hand-written Hopper (sm_90a) kernels for the gang (fixpoint) engine: K9.
//
// This file is compiled as part of csrc/seq_kernels.cu (included at its
// end, once per integer type), so the gang kernels share the sequential
// pass's device functions — `attempt_body`, the workspace layout, the block
// reductions — rather than copying them. Four kernels replace the parts of
// kube_scheduler_simulator_tpu/engine/gang.py GangScheduler._build_run:
//
//   gang_eval   pod_score_row / eval_all / eval_rows (gang.py:520-639): for
//               each pod of a device list, the whole attempt against the
//               round-start state, written as one row [N] of masked totals
//               (NEG where infeasible). With trace pointers it writes the
//               pod's prefilter, filter and score rows instead — the record
//               path's _eval_rec / replay_round (gang.py:1535-1587).
//   gang_topk   lax.top_k(scores, match_width) per row (gang.py:858-862):
//               value descending, ties to the lower node index.
//   gang_match  one round's inner matching, make_match_step / match
//               (gang.py:740-942): argmax over untaken candidates, the
//               earliest queue position wins each node (atomicMin), then
//               each ReadWriteOncePod claim (atomicMin), commit; under
//               rel_serialize the carrier prefix and the carrier's exclusive
//               pick.
//   gang_bind   bind_all (gang.py:641-667): every committed pod's rows
//               scattered into node state with integer atomics.
//
// Every kernel reads its live row count from device memory (`live`), so a
// round's pending list is built on the card and the host reads back one
// pair of integers a round (what gang_match committed, and the pending
// count).
//
// Bound on the card. gang_eval is K1's work once per pending pod: the node
// planes and the pod's row are read (from L2 after the first pod), the
// relational prologue walks every bound pod. Its blocks are independent, so
// a grid of blocks strides over the list: each block owns its own workspace
// slice (the prologue's counters and status words, `ws_layout`) and its own
// codes/raw scratch, so no two blocks share a word. gang_topk ranks each
// row's values against the row held in shared memory tiles (N² compares a
// row, no sort and no scratch). gang_match is latency-bound: one block
// walks the round's rows per iteration, as seq_run walks its queue, with
// the per-node and per-claim winners as atomicMin into [N+1] and [C].
// gang_bind moves a few hundred bytes a committed pod.
//
// Arithmetic follows the reference bit for bit, as the sequential kernels
// do: integer sums wrap in the policy's type (int32 atomics wrap as XLA's
// scatter-adds do) and uncommitted rows are exact no-ops.

namespace {

// queue position of a pod that is not queued: it never wins a scatter-min
constexpr int NO_ORDER = INT_MAX;
constexpr int TOPK_TILE = 1024;

// threads of a gang_eval block: one node a thread up to 256, so several
// blocks (pods) share an SM
__host__ __device__ inline int gang_eval_threads(int n) {
  const int t = ((n + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 256 ? 256 : t);
}

__device__ __forceinline__ int live_rows(const int* live, int K) {
  if (!live) return K;
  const int l = *live;
  return l < K ? (l > 0 ? l : 0) : K;
}

// Pod p is pending: not bound, queued and a real pod (gang.py:977).
__device__ __forceinline__ bool gang_pending(const Planes& a, const State& s, const int* order,
                                             int p) {
  return s.assignment[p] < 0 && order[p] != NO_ORDER && a.pod_mask[p];
}

// K9 eval. Rows [0, live) of `rows` (pod ids, -1 = none). Without trace
// pointers (slot == null) row i of scores [K, N] gets pod rows[i]'s masked
// totals, NEG for a pod that is not pending (with check_pending) or -1;
// with them, the pod's prefilter code, filter codes, raw and final scores
// go to trace row slot[i]. Block b uses scratch slice b of feas_s [G, N],
// codes_s [G, N*F], raw_s [G, N*S] and wsp [G, ws_bytes].
template <typename I>
__global__ void __launch_bounds__(1024)
    gang_eval_kernel(Cfg c, Planes a, State s, const I* w, const int* rows, int K,
                     const int* live, const int* order, int check_pending, I* scores,
                     const int* slot, int* tr_pf, int* tr_codes, I* tr_raw, I* tr_fin,
                     unsigned char* feas_s, int* codes_s, I* raw_s, char* wsp,
                     long long ws_bytes) {
  __shared__ Smem<I> sm;
  Ws ws;
  ws_layout(a, sizeof(I), 0, wsp + (size_t)blockIdx.x * ws_bytes, &ws);
  const Need nd = need_of(c);
  const int N = a.N, F = c.n_filters, S = c.n_scores;
  const I NEG = Lim<I>::lo / 2;
  unsigned char* feas = feas_s + (size_t)blockIdx.x * N;
  const int n_live = live_rows(live, K);
  for (int i = blockIdx.x; i < n_live; i += gridDim.x) {
    const int p = rows[i];
    const bool go = p >= 0 && (!check_pending || gang_pending(a, s, order, p));
    if (!go) {
      if (!slot)
        for (int n = threadIdx.x; n < N; n += blockDim.x) scores[(size_t)i * N + n] = NEG;
      continue;
    }
    if (slot) {
      const size_t q = (size_t)slot[i];
      attempt_body<I>(c, nd, a, s, w, p, tr_codes + q * N * F, tr_raw + q * N * S,
                      tr_fin + q * N * S, feas, ws, sm);
      if (threadIdx.x == 0 && c.pf_vb) tr_pf[q] = prefilter_code(c, a, p);
    } else {
      attempt_body<I>(c, nd, a, s, w, p, codes_s + (size_t)blockIdx.x * N * F,
                      raw_s + (size_t)blockIdx.x * N * S, nullptr, feas, ws, sm,
                      scores + (size_t)i * N);
    }
    __syncthreads();  // the next pod's prologue reuses the workspace
  }
}

// K9 top-k: rows [0, live) of scores [K, N] → vals, idx [K, MW], each row's
// MW largest values in descending order, ties to the lower node index
// (lax.top_k). Each value's rank is the count of values that beat it
// (larger, or equal at a lower index): a total order, so the ranks below
// MW are distinct output slots.
template <typename I>
__global__ void __launch_bounds__(1024)
    gang_topk_kernel(const I* scores, int N, int K, const int* live, int MW, I* vals, int* idx) {
  __shared__ I tile[TOPK_TILE];
  const int n_live = live_rows(live, K);
  for (int i = blockIdx.x; i < n_live; i += gridDim.x) {
    const I* row = scores + (size_t)i * N;
    for (int base = 0; base < N; base += blockDim.x) {
      const int n = base + threadIdx.x;
      const I v = n < N ? row[n] : (I)0;
      int rank = 0;
      for (int t0 = 0; t0 < N; t0 += TOPK_TILE) {
        const int tn = imin<int>(TOPK_TILE, N - t0);
        __syncthreads();
        for (int m = threadIdx.x; m < tn; m += blockDim.x) tile[m] = row[t0 + m];
        __syncthreads();
        if (n < N)
          for (int m = 0; m < tn; ++m) {
            const I u = tile[m];
            rank += (u > v) || (u == v && t0 + m < n);
          }
      }
      if (n < N && rank < MW) {
        vals[(size_t)i * MW + rank] = v;
        idx[(size_t)i * MW + rank] = n;
      }
    }
  }
}

// Row i has a value above NEG (the reference's row_ok: pending with a
// feasible candidate).
template <typename I>
__device__ __forceinline__ bool row_ok(const I* vals, int W, int i, I NEG) {
  const I* vr = vals + (size_t)i * W;
  for (int j = 0; j < W; ++j)
    if (vr[j] > NEG) return true;
  return false;
}

// K9 match: one round's inner matching over rows [0, live) in one block.
// vals [K, W] are each row's candidate scores, idx [K, W] their nodes (null:
// column j is node j, the full-width form). claims [P, MC]: each pod's
// ReadWriteOncePod claims, -1 padded. carrier [P] (null without
// rel_serialize): the pod carries a required anti-affinity term. Writes
// sel [K] (the committed node or -1) and stat = {rows committed, live}.
// Scratch: cand [K], taken [N], winner [N+1], cmin [C], ctaken [C].
template <typename I>
__global__ void __launch_bounds__(1024)
    gang_match_kernel(const I* vals, const int* idx, int W, int K, const int* live,
                      const int* rows, const int* order, const int* claims, int MC,
                      const unsigned char* carrier, int N, int C, int iters, int* sel, int* cand,
                      int* taken, int* winner, int* cmin, int* ctaken, int* stat) {
  __shared__ Smem<int> smi;
  const I NEG = Lim<I>::lo / 2;
  const int n_live = live_rows(live, K);
  for (int i = threadIdx.x; i < K; i += blockDim.x) sel[i] = -1;
  for (int n = threadIdx.x; n < N; n += blockDim.x) taken[n] = 0;
  for (int n = threadIdx.x; n <= N; n += blockDim.x) winner[n] = NO_ORDER;
  for (int k = threadIdx.x; k < C; k += blockDim.x) {
    cmin[k] = NO_ORDER;
    ctaken[k] = 0;
  }
  if (threadIdx.x == 0) {
    stat[0] = 0;
    stat[1] = n_live;
  }
  __syncthreads();
  // the first placeable carrier in queue order (gang.py:863-879)
  int c_min = NO_ORDER;
  if (carrier) {
    int m = NO_ORDER;
    for (int i = threadIdx.x; i < n_live; i += blockDim.x) {
      const int p = rows[i];
      if (carrier[p] && row_ok<I>(vals, W, i, NEG)) m = imin<int>(m, order[p]);
    }
    c_min = block_min<int>(m, smi);
    bool before = false;
    for (int i = threadIdx.x; i < n_live; i += blockDim.x)
      before = before || (order[rows[i]] < c_min && row_ok<I>(vals, W, i, NEG));
    const bool prefix_exists = __syncthreads_or(before) != 0;
    if (!prefix_exists && c_min != NO_ORDER) {
      // the carrier's exclusive round at its argmax (unmasked, first column)
      for (int i = threadIdx.x; i < n_live; i += blockDim.x) {
        const int p = rows[i];
        if (!carrier[p] || order[p] != c_min || !row_ok<I>(vals, W, i, NEG)) continue;
        const I* vr = vals + (size_t)i * W;
        int col = 0;
        for (int j = 1; j < W; ++j)
          if (vr[j] > vr[col]) col = j;
        sel[i] = idx ? idx[(size_t)i * W + col] : col;
        stat[0] = 1;
      }
      return;
    }
  }
  int committed = 0;
  for (int it = 0; it < iters; ++it) {
    // 1. each open row's best untaken candidate; the earliest queue
    //    position wins each node
    for (int i = threadIdx.x; i < n_live; i += blockDim.x) {
      int cd = -1;
      if (sel[i] < 0) {
        const int p = rows[i], o = order[p];
        bool skip = carrier && o >= c_min;
        for (int j = 0; j < MC && !skip; ++j) {
          const int k = claims[(size_t)p * MC + j];
          skip = k >= 0 && ctaken[k];
        }
        if (!skip) {
          const I* vr = vals + (size_t)i * W;
          const int* ir = idx ? idx + (size_t)i * W : nullptr;
          I best = NEG;
          for (int j = 0; j < W; ++j) {
            const int n = ir ? ir[j] : j;
            const I v = vr[j];
            if (v > best && !taken[n]) {
              best = v;
              cd = n;
            }
          }
          if (cd >= 0) atomicMin(&winner[cd], o);
        }
      }
      cand[i] = cd;
    }
    __syncthreads();
    // 2. node winners take part in their claims' scatter-min
    for (int i = threadIdx.x; i < n_live; i += blockDim.x) {
      const int cd = cand[i];
      if (cd < 0) continue;
      const int p = rows[i], o = order[p];
      if (winner[cd] != o) {
        cand[i] = -1;
        continue;
      }
      for (int j = 0; j < MC; ++j) {
        const int k = claims[(size_t)p * MC + j];
        if (k >= 0) atomicMin(&cmin[k], o);
      }
    }
    __syncthreads();
    // 3. commit where the row also won every claim it uses
    bool any = false;
    for (int i = threadIdx.x; i < n_live; i += blockDim.x) {
      const int cd = cand[i];
      if (cd < 0) continue;
      const int p = rows[i], o = order[p];
      bool ok = true;
      for (int j = 0; j < MC; ++j) {
        const int k = claims[(size_t)p * MC + j];
        ok = ok && (k < 0 || cmin[k] == o);
      }
      if (!ok) continue;
      sel[i] = cd;
      taken[cd] = 1;
      for (int j = 0; j < MC; ++j) {
        const int k = claims[(size_t)p * MC + j];
        if (k >= 0) ctaken[k] = 1;
      }
      any = true;
      ++committed;
    }
    __syncthreads();
    for (int n = threadIdx.x; n <= N; n += blockDim.x) winner[n] = NO_ORDER;
    for (int k = threadIdx.x; k < C; k += blockDim.x) cmin[k] = NO_ORDER;
    if (__syncthreads_or(any) == 0) break;
  }
  if (committed) atomicAdd(&stat[0], committed);
}

// K9 bind: rows [0, live) with sel[i] >= 0 bind pod rows[i] to node sel[i]
// at bind order P + order[pod]. Integer atomics throughout, so rows that
// share a node or a claim add in any order with the same (wrapping) sum.
template <typename I>
__global__ void __launch_bounds__(1024)
    gang_bind_kernel(Planes a, State s, const int* rows, int K, const int* live, const int* sel,
                     const int* order) {
  const int n_live = live_rows(live, K), R = a.R;
  for (int i = blockIdx.x; i < n_live; i += gridDim.x) {
    const int n = sel[i];
    if (n < 0) continue;
    const int p = rows[i];
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      atomic_add((I*)s.requested + (size_t)n * R + r, ((const I*)a.pod_req)[(size_t)p * R + r]);
      atomic_add((I*)s.s_requested + (size_t)n * R + r,
                 ((const I*)a.pod_sreq)[(size_t)p * R + r]);
    }
    for (int q = threadIdx.x; q < a.Q; q += blockDim.x) {
      const int x = a.want_pair[(size_t)p * a.Q + q], y = a.want_wild[(size_t)p * a.Q + q];
      if (x) atomicAdd(&s.used_pair[(size_t)n * a.Q + q], x);
      if (y) atomicAdd(&s.used_wild[(size_t)n * a.Q + q], y);
    }
    for (int v = threadIdx.x; v < a.V2; v += blockDim.x) {
      const int x = a.want_trip[(size_t)p * a.V2 + v];
      if (x) atomicAdd(&s.used_trip[(size_t)n * a.V2 + v], x);
    }
    for (int k = threadIdx.x; k < a.CL; k += blockDim.x)
      if (a.pod_claim[(size_t)p * a.CL + k]) atomicAdd(&s.used_claims[k], 1);
    for (int d = threadIdx.x; d < a.D; d += blockDim.x) {
      const int x = a.pod_disk_any[(size_t)p * a.D + d], y = a.pod_disk_rw[(size_t)p * a.D + d];
      if (x) atomicAdd(&s.node_disk_any[(size_t)n * a.D + d], x);
      if (y) atomicAdd(&s.node_disk_rw[(size_t)n * a.D + d], y);
    }
    for (int j = threadIdx.x; j < N_VOL3; j += blockDim.x) {
      const int x = a.pod_vol3[(size_t)p * N_VOL3 + j];
      if (x) atomicAdd(&s.node_vol3[(size_t)n * N_VOL3 + j], x);
    }
    if (threadIdx.x == 0) {
      atomicAdd(&s.n_pods[n], 1);
      s.assignment[p] = n;
      s.bound_seq[p] = wadd<int>(a.P, order[p]);
    }
  }
}

// blocks of gang_eval that are resident at once on the card (the grid the
// launcher uses, and the number of scratch slices the caller allocates)
template <typename I>
int gang_eval_grid(int n_nodes) {
#ifdef __CUDACC__
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gang_eval_kernel<I>,
                                                    gang_eval_threads(n_nodes), 0) != cudaSuccess)
    return -1;
  return per_sm * sms;
#else
  return 1;  // the host build runs one block
#endif
}

int gang_rows_grid(int K) { return K < 1 ? 1 : (K > 8192 ? 8192 : K); }

}  // namespace

// ---------------------------------------------------------------------------
// plain C interface (engine/cuda.py binds it with ctypes), as seq_kernels.cu's
// ---------------------------------------------------------------------------

extern "C" {

#define GANG_ENTRY_POINTS(T, I)                                                               \
  int gang_eval_grid_##T(int n_nodes) { return gang_eval_grid<I>(n_nodes); }                  \
  int gang_eval_##T(const Cfg* c, const Planes* a, const State* s, const void* w,             \
                    const int* rows, int K, const int* live, const int* order,                \
                    int check_pending, void* scores, const int* slot, int* tr_pf,             \
                    int* tr_codes, void* tr_raw, void* tr_fin, int grid,                      \
                    unsigned char* feas_s, int* codes_s, void* raw_s, void* ws,               \
                    long long ws_bytes, void* stream) {                                       \
    gang_eval_kernel<I><<<grid, gang_eval_threads(a->N), 0, (cudaStream_t)stream>>>(          \
        *c, *a, *s, (const I*)w, rows, K, live, order, check_pending, (I*)scores, slot,       \
        tr_pf, tr_codes, (I*)tr_raw, (I*)tr_fin, feas_s, codes_s, (I*)raw_s, (char*)ws,       \
        ws_bytes);                                                                            \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  int gang_topk_##T(const void* scores, int N, int K, const int* live, int MW, void* vals,     \
                    int* idx, void* stream) {                                                 \
    gang_topk_kernel<I><<<gang_rows_grid(K), block_threads(N < 256 ? N : 256), 0,             \
                          (cudaStream_t)stream>>>((const I*)scores, N, K, live, MW, (I*)vals, \
                                                  idx);                                       \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  int gang_match_##T(const void* vals, const int* idx, int W, int K, const int* live,         \
                     const int* rows, const int* order, const int* claims, int MC,            \
                     const unsigned char* carrier, int N, int C, int iters, int* sel,         \
                     int* cand, int* taken, int* winner, int* cmin, int* ctaken, int* stat,   \
                     void* stream) {                                                          \
    gang_match_kernel<I><<<1, block_threads(K), 0, (cudaStream_t)stream>>>(                   \
        (const I*)vals, idx, W, K, live, rows, order, claims, MC, carrier, N, C, iters, sel,  \
        cand, taken, winner, cmin, ctaken, stat);                                             \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  int gang_bind_##T(const Planes* a, const State* s, const int* rows, int K, const int* live, \
                    const int* sel, const int* order, void* stream) {                         \
    gang_bind_kernel<I><<<gang_rows_grid(K), 64, 0, (cudaStream_t)stream>>>(                  \
        *a, *s, rows, K, live, sel, order);                                                   \
    return (int)cudaGetLastError();                                                           \
  }

#if !defined(SEQ_ONLY) || SEQ_ONLY == 32
GANG_ENTRY_POINTS(i32, int)
#endif
#if !defined(SEQ_ONLY) || SEQ_ONLY == 64
GANG_ENTRY_POINTS(i64, long long)
#endif

}  // extern "C"
