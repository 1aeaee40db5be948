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
// Every kernel takes a leading variant axis (the reference's GangSweep,
// parallel/sweep.py `gangsweep.vrun`/`vrun_resume`: V weight variants of one
// round in one launch of each kernel). Variant v has its own state slice
// (`variant_state` with the `StateStride` byte strides `sweep_run` uses), its
// weights row w + v*S and its own rows [V, K], live count live[v], scores
// [V, K, N], candidates [V, K, W], selections sel [V, K] and stat [V, 2];
// `order`, `claims` and `carrier` are shared. GangScheduler calls them with
// V = 1.
//
// The tenant form (TEN = true; K11 `batch.gang.run`, server/batchplane.py):
// variant v is tenant v of a batch window, with its own cluster (the Planes
// table of seq_kernels.cu's tenant forms), and its own order [V, P], claims
// [V, P, MC] and carrier [V, P] rows.
//
// Every kernel reads its live row counts from device memory (`live`), so a
// round's pending lists are built on the card and the host reads back one
// [V, 2] array a round (what gang_match committed, and the pending count,
// per variant).
//
// Bound on the card. gang_eval is K1's work once per pending pod: the node
// planes and the pod's row are read (from L2 after the first pod), the
// relational prologue walks every bound pod. Its blocks are independent, so
// a grid of blocks strides over the (row, variant) pairs, row-major up to
// the largest live count: each block owns its own workspace slice (the
// prologue's counters and status words, `ws_layout`) and its own codes/raw
// scratch, so no two blocks share a word. gang_topk ranks each row's values
// against the row held in shared memory tiles (N² compares a row, no sort
// and no scratch). gang_match is latency-bound: one block a variant walks
// that variant's rows per iteration, as seq_run walks its queue, with the
// per-node and per-claim winners as atomicMin into the variant's [N+1] and
// [C]. gang_bind moves a few hundred bytes a committed pod.
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

// Variant v's live rows: live[v] clamped to [0, K] (every row without `live`).
__device__ __forceinline__ int live_rows(const int* live, int v, int K) {
  if (!live) return K;
  const int l = live[v];
  return l < K ? (l > 0 ? l : 0) : K;
}

// The most live rows of any variant (the same value in every thread).
__device__ __forceinline__ int most_live(const int* live, int V, int K, Smem<int>& smi) {
  if (!live) return K;
  int m = 0;
  for (int v = threadIdx.x; v < V; v += blockDim.x) m = imax<int>(m, live_rows(live, v, K));
  return block_max<int>(m, smi);
}

// Pod p is pending: not bound, queued and a real pod (gang.py:977).
__device__ __forceinline__ bool gang_pending(const Planes& a, const State& s, const int* order,
                                             int p) {
  return s.assignment[p] < 0 && order[p] != NO_ORDER && a.pod_mask[p];
}

// The (row, variant) pairs a row kernel walks, row-major so that every
// variant's first rows come first: pair j is row j / V of variant j % V.
// STACK = false (one variant, V = 1, GangScheduler's launches) walks rows
// [0, live) as a single-variant kernel does, with no reduction.
template <bool STACK>
__device__ __forceinline__ long long row_pairs(const int* live, int V, int K, Smem<int>& smi) {
  if (STACK) return (long long)most_live(live, V, K, smi) * V;
  return live_rows(live, 0, K);
}

// One pair's (row, variant), or false where the row is past the variant's
// live count.
template <bool STACK>
__device__ __forceinline__ bool pair_row(long long j, int V, int K, const int* live, int& i,
                                         int& v) {
  i = STACK ? (int)(j / V) : (int)j;
  v = STACK ? (int)(j % V) : 0;
  return !STACK || i < live_rows(live, v, K);
}

// gang_eval's work for row `row` (pod rows[row]) at state s, weights w.
template <typename I>
__device__ __forceinline__ void eval_row(const Cfg& c, const Need& nd, const Planes& a,
                                         const State& s, const I* w, size_t row,
                                         const int* rows, const int* order, int check_pending,
                                         I* scores, const int* slot, int* tr_pf, int* tr_codes,
                                         I* tr_raw, I* tr_fin, unsigned char* feas,
                                         int* codes, I* raw, const Ws& ws, Smem<I>& sm) {
  const int N = a.N, F = c.n_filters, S = c.n_scores;
  const int p = rows[row];
  const bool go = p >= 0 && (!check_pending || gang_pending(a, s, order, p));
  if (!go) {
    if (!slot)
      for (int n = threadIdx.x; n < N; n += blockDim.x) scores[row * N + n] = Lim<I>::lo / 2;
    return;
  }
  if (slot) {
    const size_t q = (size_t)slot[row];
    attempt_body<I>(c, nd, a, s, w, p, tr_codes + q * N * F, tr_raw + q * N * S,
                    tr_fin + q * N * S, feas, ws, sm);
    if (threadIdx.x == 0 && c.pf_vb) tr_pf[q] = prefilter_code(c, a, p);
  } else {
    attempt_body<I>(c, nd, a, s, w, p, codes, raw, nullptr, feas, ws, sm, scores + row * N);
  }
  __syncthreads();  // the next pod's prologue reuses the workspace
}

// K9 eval. For each variant v, rows [0, live[v]) of its row list rows + v*K
// (pod ids, -1 = none) at its state and weights. Without trace pointers
// (slot == null) row i of variant v's scores [K, N] gets pod p's masked
// totals, NEG for a pod that is not pending (with check_pending) or -1;
// with them (V = 1), the pod's prefilter code, filter codes, raw and final
// scores go to trace row slot[i]. Block b uses scratch slice b of feas_s
// [G, N], codes_s [G, N*F], raw_s [G, N*S] and wsp [G, ws_bytes]. STACK =
// false reads the one state straight from the kernel's parameters, as
// before the variant axis; STACK = true each variant's slice. TEN (with
// STACK): tenant v's planes (the table `ap`) and order row order + v*P.
template <typename I, bool STACK, bool TEN = false>
__global__ void __launch_bounds__(1024)
    gang_eval_kernel(Cfg c, typename PlanesArg<TEN>::T ap, State s0, StateStride ss,
                     const I* w, int V, const int* rows, int K, const int* live,
                     const int* order, int check_pending, I* scores, const int* slot,
                     int* tr_pf, int* tr_codes, I* tr_raw, I* tr_fin, unsigned char* feas_s,
                     int* codes_s, I* raw_s, char* wsp, long long ws_bytes) {
  __shared__ Smem<I> sm;
  __shared__ Smem<int> smi;
  __shared__ typename PlanesCopy<TEN>::T sp;
  Ws ws;
  const Planes& a = planes_of(ap, 0, sp);
  ws_layout(a, sizeof(I), 0, wsp + (size_t)blockIdx.x * ws_bytes, &ws);
  const Need nd = need_of(c);
  const size_t N = a.N;
  unsigned char* feas = feas_s + blockIdx.x * N;
  int* codes = codes_s + blockIdx.x * N * c.n_filters;
  I* raw = raw_s + blockIdx.x * N * c.n_scores;
  const long long pairs = row_pairs<STACK>(live, V, K, smi);
  for (long long j = blockIdx.x; j < pairs; j += gridDim.x) {
    int i, v;
    if (!pair_row<STACK>(j, V, K, live, i, v)) continue;
    const size_t row = (size_t)v * K + i;
    if constexpr (TEN) {
      const Planes& at = planes_of(ap, v, sp);
      eval_row<I>(c, nd, at, variant_state(s0, ss, v), w + (size_t)v * c.n_scores, row, rows,
                  order + (size_t)v * at.P, check_pending, scores, slot, tr_pf, tr_codes,
                  tr_raw, tr_fin, feas, codes, raw, ws, sm);
    } else if constexpr (STACK)
      eval_row<I>(c, nd, a, variant_state(s0, ss, v), w + (size_t)v * c.n_scores, row, rows,
                  order, check_pending, scores, slot, tr_pf, tr_codes, tr_raw, tr_fin, feas,
                  codes, raw, ws, sm);
    else
      eval_row<I>(c, nd, a, s0, w, row, rows, order, check_pending, scores, slot, tr_pf,
                  tr_codes, tr_raw, tr_fin, feas, codes, raw, ws, sm);
  }
}

// K9 top-k: for each variant v, rows [0, live[v]) of its scores [K, N] →
// vals, idx [K, MW], each row's MW largest values in descending order, ties
// to the lower node index (lax.top_k). Each value's rank is the count of
// values that beat it (larger, or equal at a lower index): a total order, so
// the ranks below MW are distinct output slots.
template <typename I, bool STACK>
__global__ void __launch_bounds__(1024)
    gang_topk_kernel(const I* scores, int N, int V, int K, const int* live, int MW, I* vals,
                     int* idx) {
  __shared__ I tile[TOPK_TILE];
  __shared__ Smem<int> smi;
  const long long pairs = row_pairs<STACK>(live, V, K, smi);
  for (long long j = blockIdx.x; j < pairs; j += gridDim.x) {
    int i, var;
    if (!pair_row<STACK>(j, V, K, live, i, var)) continue;
    const size_t r = (size_t)var * K + i;
    const I* row = scores + r * N;
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
        vals[r * MW + rank] = v;
        idx[r * MW + rank] = n;
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

// One variant's matching (gang_match_kernel): rows [0, n_live). COUNTED (the
// reference's inner_loop="static", gang.py:884-901 `m_scan`): exactly `iters`
// iterations, each after the matching settles a no-op, in place of the exit
// at the first iteration that commits nothing; the sel is the same.
template <typename I, bool COUNTED = false>
__device__ void match_one(const I* vals, const int* idx, int W, int K, int n_live,
                          const int* rows, const int* order, const int* claims, int MC,
                          const unsigned char* carrier, int N, int C, int iters, int* sel,
                          int* cand, int* taken, int* winner, int* cmin, int* ctaken, int* stat,
                          Smem<int>& smi) {
  const I NEG = Lim<I>::lo / 2;
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
    if constexpr (COUNTED)
      __syncthreads();
    else if (__syncthreads_or(any) == 0)
      break;
  }
  if (committed) atomicAdd(&stat[0], committed);
}


// K9 match: one round's inner matching, one block a variant (a grid-stride
// walk over the variants). For variant v, over its rows [0, live[v]): vals
// [K, W] are each row's candidate scores, idx [K, W] their nodes (null:
// column j is node j, the full-width form). claims [P, MC]: each pod's
// ReadWriteOncePod claims, -1 padded. carrier [P] (null without
// rel_serialize): the pod carries a required anti-affinity term. Writes sel
// [K] (the committed node or -1) and stat = {rows committed, live}; each of
// these, and the scratch cand [K], taken [N], winner [N+1], cmin [C] and
// ctaken [C], is the variant's own slice of a [V, ...] buffer. TEN: order
// [V, P], claims [V, P, MC] and carrier [V, P] are the tenants' own rows
// (P pods a tenant); without it they are shared and P is not read.
template <typename I, bool TEN = false>
__global__ void __launch_bounds__(1024)
    gang_match_kernel(const I* vals0, const int* idx0, int W, int V, int K, const int* live,
                      const int* rows0, const int* order0, const int* claims0, int MC,
                      const unsigned char* carrier0, int N, int C, int iters, int* sel0,
                      int* cand0, int* taken0, int* winner0, int* cmin0, int* ctaken0,
                      int* stat0, int P) {
  __shared__ Smem<int> smi;
  for (int v = blockIdx.x; v < V; v += gridDim.x) {
    const size_t vp = TEN ? (size_t)v * P : 0;
    const int* order = order0 + vp;
    const int* claims = claims0 + vp * MC;
    const unsigned char* carrier = carrier0 ? carrier0 + vp : nullptr;
    const size_t vk = (size_t)v * K;
    const I* vals = vals0 + vk * W;
    const int* idx = idx0 ? idx0 + vk * W : nullptr;
    const int* rows = rows0 + vk;
    int* sel = sel0 + vk;
    int* cand = cand0 + vk;
    int* taken = taken0 + (size_t)v * N;
    int* winner = winner0 + (size_t)v * (N + 1);
    int* cmin = cmin0 + (size_t)v * C;
    int* ctaken = ctaken0 + (size_t)v * C;
    int* stat = stat0 + 2 * (size_t)v;
    match_one<I>(vals, idx, W, K, live_rows(live, v, K), rows, order, claims, MC, carrier, N,
                 C, iters, sel, cand, taken, winner, cmin, ctaken, stat, smi);
    __syncthreads();  // the next variant reuses the shared reduction words
  }
}

// K9 match's counted form (inner_loop="static"): gang_match_kernel with
// match_one<I, true>, the same arguments, slices and TEN rows. A kernel of its
// own, so that gang_match_kernel's instantiations keep their code.
template <typename I, bool TEN = false>
__global__ void __launch_bounds__(1024)
    gang_match_counted_kernel(const I* vals0, const int* idx0, int W, int V, int K,
                              const int* live, const int* rows0, const int* order0,
                              const int* claims0, int MC, const unsigned char* carrier0, int N,
                              int C, int iters, int* sel0, int* cand0, int* taken0,
                              int* winner0, int* cmin0, int* ctaken0, int* stat0, int P) {
  __shared__ Smem<int> smi;
  for (int v = blockIdx.x; v < V; v += gridDim.x) {
    const size_t vp = TEN ? (size_t)v * P : 0, vk = (size_t)v * K;
    match_one<I, true>(vals0 + vk * W, idx0 ? idx0 + vk * W : nullptr, W, K,
                       live_rows(live, v, K), rows0 + vk, order0 + vp, claims0 + vp * MC, MC,
                       carrier0 ? carrier0 + vp : nullptr, N, C, iters, sel0 + vk, cand0 + vk,
                       taken0 + (size_t)v * N, winner0 + (size_t)v * (N + 1),
                       cmin0 + (size_t)v * C, ctaken0 + (size_t)v * C, stat0 + 2 * (size_t)v,
                       smi);
    __syncthreads();  // the next variant reuses the shared reduction words
  }
}

// gang_bind's work for row `row`: pod rows[row] to node sel[row] in state s.
template <typename I>
__device__ __forceinline__ void bind_row(const Planes& a, const State& s, size_t row,
                                         const int* rows, const int* sel, const int* order) {
  const int n = sel[row];
  if (n < 0) return;
  const int p = rows[row], R = a.R;
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

// K9 bind: for each variant v, its rows [0, live[v]) with sel >= 0 bind pod
// rows[v, i] to node sel[v, i] in the variant's state at bind order P +
// order[pod]. Integer atomics throughout, so rows that share a node or a
// claim add in any order with the same (wrapping) sum. STACK and TEN as
// gang_eval's.
template <typename I, bool STACK, bool TEN = false>
__global__ void __launch_bounds__(1024)
    gang_bind_kernel(typename PlanesArg<TEN>::T ap, State s0, StateStride ss, int V,
                     const int* rows, int K, const int* live, const int* sel,
                     const int* order) {
  __shared__ Smem<int> smi;
  __shared__ typename PlanesCopy<TEN>::T sp;
  const Planes& a = planes_of(ap, 0, sp);
  const long long pairs = row_pairs<STACK>(live, V, K, smi);
  for (long long j = blockIdx.x; j < pairs; j += gridDim.x) {
    int i, v;
    if (!pair_row<STACK>(j, V, K, live, i, v)) continue;
    if constexpr (TEN) {
      const Planes& at = planes_of(ap, v, sp);
      bind_row<I>(at, variant_state(s0, ss, v), (size_t)v * K + i, rows, sel,
                  order + (size_t)v * at.P);
    } else if constexpr (STACK)
      bind_row<I>(a, variant_state(s0, ss, v), (size_t)v * K + i, rows, sel, order);
    else
      bind_row<I>(a, s0, i, rows, sel, order);
  }
}

// blocks of gang_eval that are resident at once on the card (the grid the
// launcher uses, and the number of scratch slices the caller allocates), for
// the one-variant (stacked = 0) or the stacked form
template <typename I>
int gang_eval_grid(int n_nodes, int stacked) {
  const int t = gang_eval_threads(n_nodes);
  return stacked ? resident_blocks(gang_eval_kernel<I, true>, t)
                 : resident_blocks(gang_eval_kernel<I, false>, t);
}

// blocks of gang_topk and gang_bind: one a (row, variant) pair, at most 8,192
int gang_rows_grid(int V, int K) {
  const long long n = (long long)V * K;
  return n < 1 ? 1 : (n > 8192 ? 8192 : (int)n);
}

}  // namespace

// gang_advance is defined once in the library: in the unit of the one-variant
// int32 entry points.
#if (!defined(SEQ_TENANT) || SEQ_TENANT == 0) && (!defined(SEQ_ONLY) || SEQ_ONLY == 32)
namespace {

// -(-a // b) for b > 0, as jnp's floor division gives it
__device__ __forceinline__ int ceil_div(int a, int b) {
  return a >= 0 ? (a + b - 1) / b : -(-a / b);
}

// K9's counted round accounting (gang.py:995-1037 `round_once`'s sweep
// state, :1055-1081 `r_scan`/`rw_scan`): after round slot s's match and
// bind, each variant's (tenant's, scenario's) counters for slot s + 1, on the
// card, so that a counted pass enqueues all its slots with no readback
// between them. acc is [6, V] int32: rounds progressed, window index w_idx,
// done, pending count, the next slot's window start lo and live row count.
// stat [V, 2] is gang_match's (rows committed, live). WP = 0: no window,
// progressed = a commit; else w_next = committed ? 0 : w_idx + 1, w_max =
// max(1, ceil(pending / WP)), done = no commit and k + 1 >= w_max (k = w_idx
// clamped to the last window), progressed = not done, lo = min(k' WP, P - WP)
// at the next k'. A variant that is done stays as it is: its later slots
// commit nothing (a round without a commit leaves the state unchanged), so
// gating it off (live 0) is exact. One thread a variant; it moves 32 bytes a
// variant (a few µs for any V the card holds), bound by its launch.
__global__ void gang_advance_kernel(const int* stat, int* acc, int V, int WP, int P) {
  int *rounds = acc, *w_idx = acc + V, *done = acc + 2 * (size_t)V, *pend = acc + 3 * (size_t)V;
  int *lo = acc + 4 * (size_t)V, *live = acc + 5 * (size_t)V;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < V; v += gridDim.x * blockDim.x) {
    if (done[v]) continue;
    const int committed = stat[2 * (size_t)v], n = pend[v], left = n - committed;
    int w = w_idx[v];
    bool fin = committed == 0;
    if (WP > 0) {
      const int last = ceil_div(P, WP) - 1;
      const int w_max = imax<int>(1, ceil_div(n, WP));
      fin = fin && imin<int>(w, last) + 1 >= w_max;
      w = committed ? 0 : w + 1;
      lo[v] = imin<int>(imin<int>(w, last) * WP, P - WP);
      live[v] = fin ? 0 : imax<int>(0, imin<int>(left - lo[v], WP));
    } else {
      live[v] = fin ? 0 : left;
    }
    rounds[v] += !fin;
    done[v] = fin;
    pend[v] = left;
    w_idx[v] = w;
  }
}

}  // namespace
#endif

// ---------------------------------------------------------------------------
// plain C interface (engine/cuda.py binds it with ctypes), as seq_kernels.cu's
// ---------------------------------------------------------------------------

extern "C" {

// Each launcher takes the stacked instantiation (STACK = true) for V > 1
// and the one-variant one for V = 1.
#define GANG_LAUNCH(kernel, I, grid, threads, stream, ...)                                     \
  if (V > 1)                                                                                  \
    kernel<I, true><<<grid, threads, 0, (cudaStream_t)stream>>>(__VA_ARGS__);                 \
  else                                                                                        \
    kernel<I, false><<<grid, threads, 0, (cudaStream_t)stream>>>(__VA_ARGS__);

#define GANG_ENTRY_POINTS(T, I)                                                               \
  int gang_eval_grid_##T(int n_nodes, int stacked) {                                          \
    return gang_eval_grid<I>(n_nodes, stacked);                                               \
  }                                                                                           \
  int gang_eval_##T(const Cfg* c, const Planes* a, const State* s, const StateStride* ss,     \
                    const void* w, int V, const int* rows, int K, const int* live,            \
                    const int* order, int check_pending, void* scores, const int* slot,       \
                    int* tr_pf, int* tr_codes, void* tr_raw, void* tr_fin, int grid,          \
                    unsigned char* feas_s, int* codes_s, void* raw_s, void* ws,               \
                    long long ws_bytes, void* stream) {                                       \
    GANG_LAUNCH(gang_eval_kernel, I, grid, gang_eval_threads(a->N), stream, *c, *a, *s, *ss,  \
                (const I*)w, V, rows, K, live, order, check_pending, (I*)scores, slot, tr_pf, \
                tr_codes, (I*)tr_raw, (I*)tr_fin, feas_s, codes_s, (I*)raw_s, (char*)ws,      \
                ws_bytes)                                                                     \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  int gang_topk_##T(const void* scores, int N, int V, int K, const int* live, int MW,         \
                    void* vals, int* idx, void* stream) {                                     \
    GANG_LAUNCH(gang_topk_kernel, I, gang_rows_grid(V, K), block_threads(N < 256 ? N : 256),  \
                stream, (const I*)scores, N, V, K, live, MW, (I*)vals, idx)                   \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  int gang_match_##T(const void* vals, const int* idx, int W, int V, int K, const int* live,  \
                     const int* rows, const int* order, const int* claims, int MC,            \
                     const unsigned char* carrier, int N, int C, int iters, int* sel,         \
                     int* cand, int* taken, int* winner, int* cmin, int* ctaken, int* stat,   \
                     void* stream) {                                                          \
    gang_match_kernel<I><<<V, block_threads(K), 0, (cudaStream_t)stream>>>(                   \
        (const I*)vals, idx, W, V, K, live, rows, order, claims, MC, carrier, N, C, iters,    \
        sel, cand, taken, winner, cmin, ctaken, stat, 0);                                     \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  int gang_match_counted_##T(const void* vals, const int* idx, int W, int V, int K,          \
                             const int* live, const int* rows, const int* order,              \
                             const int* claims, int MC, const unsigned char* carrier, int N,  \
                             int C, int iters, int* sel, int* cand, int* taken, int* winner,  \
                             int* cmin, int* ctaken, int* stat, void* stream) {               \
    gang_match_counted_kernel<I><<<V, block_threads(K), 0, (cudaStream_t)stream>>>(           \
        (const I*)vals, idx, W, V, K, live, rows, order, claims, MC, carrier, N, C, iters,    \
        sel, cand, taken, winner, cmin, ctaken, stat, 0);                                     \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  int gang_bind_##T(const Planes* a, const State* s, const StateStride* ss, int V,            \
                    const int* rows, int K, const int* live, const int* sel,                  \
                    const int* order, void* stream) {                                         \
    GANG_LAUNCH(gang_bind_kernel, I, gang_rows_grid(V, K), 64, stream, *a, *s, *ss, V, rows,  \
                K, live, sel, order)                                                          \
    return (int)cudaGetLastError();                                                           \
  }

// the tenant forms (any V >= 1): `tab` is the device table of the tenants'
// Planes, order [V, P] (and claims [V, P, MC], carrier [V, P]) their own rows
#define GANG_TENANT_ENTRY_POINTS(T, I)                                                        \
  int batch_eval_grid_##T(int n_nodes) {                                                      \
    return resident_blocks(gang_eval_kernel<I, true, true>, gang_eval_threads(n_nodes));      \
  }                                                                                           \
  int batch_eval_##T(const Cfg* c, const Planes* tab, int n_nodes, const State* s,           \
                     const StateStride* ss, const void* w, int V, const int* rows, int K,     \
                     const int* live, const int* order, void* scores, int grid,              \
                     unsigned char* feas_s, int* codes_s, void* raw_s, void* ws,              \
                     long long ws_bytes, void* stream) {                                      \
    gang_eval_kernel<I, true, true><<<grid, gang_eval_threads(n_nodes), 0,                    \
                                      (cudaStream_t)stream>>>(                                \
        *c, tab, *s, *ss, (const I*)w, V, rows, K, live, order, 1, (I*)scores, nullptr,       \
        nullptr, nullptr, nullptr, nullptr, feas_s, codes_s, (I*)raw_s, (char*)ws, ws_bytes); \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  int batch_match_##T(const void* vals, const int* idx, int W, int V, int K, const int* live, \
                      const int* rows, const int* order, const int* claims, int MC,           \
                      const unsigned char* carrier, int N, int C, int iters, int* sel,        \
                      int* cand, int* taken, int* winner, int* cmin, int* ctaken, int* stat,  \
                      int P, void* stream) {                                                  \
    gang_match_kernel<I, true><<<V, block_threads(K), 0, (cudaStream_t)stream>>>(             \
        (const I*)vals, idx, W, V, K, live, rows, order, claims, MC, carrier, N, C, iters,    \
        sel, cand, taken, winner, cmin, ctaken, stat, P);                                     \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  int batch_match_counted_##T(const void* vals, const int* idx, int W, int V, int K,         \
                              const int* live, const int* rows, const int* order,             \
                              const int* claims, int MC, const unsigned char* carrier, int N, \
                              int C, int iters, int* sel, int* cand, int* taken, int* winner, \
                              int* cmin, int* ctaken, int* stat, int P, void* stream) {       \
    gang_match_counted_kernel<I, true><<<V, block_threads(K), 0, (cudaStream_t)stream>>>(     \
        (const I*)vals, idx, W, V, K, live, rows, order, claims, MC, carrier, N, C, iters,    \
        sel, cand, taken, winner, cmin, ctaken, stat, P);                                     \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  int batch_bind_##T(const Planes* tab, const State* s, const StateStride* ss, int V,         \
                     const int* rows, int K, const int* live, const int* sel,                 \
                     const int* order, void* stream) {                                        \
    gang_bind_kernel<I, true, true><<<gang_rows_grid(V, K), 64, 0, (cudaStream_t)stream>>>(   \
        tab, *s, *ss, V, rows, K, live, sel, order);                                          \
    return (int)cudaGetLastError();                                                           \
  }

#if !defined(SEQ_TENANT) || SEQ_TENANT == 0
#if !defined(SEQ_ONLY) || SEQ_ONLY == 32
GANG_ENTRY_POINTS(i32, int)
#endif
#if !defined(SEQ_ONLY) || SEQ_ONLY == 64
GANG_ENTRY_POINTS(i64, long long)
#endif
#endif
#if !defined(SEQ_TENANT) || SEQ_TENANT == 1
#if !defined(SEQ_ONLY) || SEQ_ONLY == 32
GANG_TENANT_ENTRY_POINTS(i32, int)
#endif
#if !defined(SEQ_ONLY) || SEQ_ONLY == 64
GANG_TENANT_ENTRY_POINTS(i64, long long)
#endif
#endif
#if (!defined(SEQ_TENANT) || SEQ_TENANT == 0) && (!defined(SEQ_ONLY) || SEQ_ONLY == 32)
// gang_advance: the counted round's accounting of V variants, in place
int gang_advance(const int* stat, int* acc, int V, int WP, int P, void* stream) {
  gang_advance_kernel<<<(V + 127) / 128, 128, 0, (cudaStream_t)stream>>>(stat, acc, V, WP, P);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
