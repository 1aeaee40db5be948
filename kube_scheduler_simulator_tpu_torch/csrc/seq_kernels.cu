// Hand-written Hopper (sm_90a) kernels for the sequential scheduling pass.
//
// Three kernels share the plugin bodies below (`filter_code`, `score_raw`):
//
//   seq_attempt  replaces kube_scheduler_simulator_tpu/engine/engine.py
//                BatchedScheduler._build_run.attempt (`seq.attempt`): for one
//                pod, every enabled filter and score plugin over all N
//                nodes, the normalize step, the weights and the masked
//                argmax with lowest-index tie-break.
//   seq_bind     replaces _build_run.bind (`seq.bind`): the scatter of the
//                chosen pod's rows into per-node state, in place.
//   seq_run      replaces _build_run.step / run_segment / run (`seq.run`,
//                the lax.scan over the queue): one persistent block walks
//                the bucket-padded queue, attempt then bind per step, and
//                writes each step's trace row.
//
// Bound on the card. A step reads the node planes ([N,R] allocatable,
// requested and scoring-requested, [N] pod counts and masks, [N,T] taints)
// and one pod row, and writes one trace row ([N,F] codes, [N,S] raw and
// final scores). At 1,024 nodes that is about 60 KB read (from L2 after the
// first step) and 40 KB written, some 30 ns at 3.35 TB/s. Each step is
// bound instead by latency: pod i+1 must see pod i's bind, and between
// them sit two dependent block reductions (the default_reverse max over
// feasible nodes, then the argmax) and a scatter.
//
// What the design does about it. One block of up to 1,024 threads owns the
// whole pass, so a step's dependency costs __syncthreads() barriers and no
// kernel launches; reductions are warp shuffles plus one shared-memory
// round. A step's per-node values stay with the thread that computed them
// (it rereads its own writes), so only the reductions synchronise. One
// block uses one of the 132 SMs: spreading a step over many blocks
// (cooperative grid sync, or a cluster) and keeping node state in shared
// memory is later work.
//
// Arithmetic follows the reference bit for bit. Integer `//` floors (C++
// `/` truncates), every intermediate stays in the policy's type (int32 for
// TPU32, int64 for EXACT) and wraps as XLA's does, through unsigned
// arithmetic. Float steps use the round-to-nearest intrinsics, so no
// fused multiply-add changes a rounding; the build does not use
// --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int MAX_F = 8;
constexpr int MAX_S = 8;
constexpr int MAX_SPEC = 16;
constexpr int MAX_PTS = 16;
constexpr int MAX_BAL = 16;
constexpr int PODS_RES = 3;
constexpr int MAX_NODE_SCORE = 100;
constexpr long long BALANCED_SCALE = 1LL << 16;

// plugin ids, as engine/kernels.py's registries name them
enum { F_UNSCHED = 0, F_NODENAME = 1, F_TAINT = 2, F_FIT = 3 };
enum { S_FIT = 0, S_BALANCED = 1, S_TAINT = 2 };
enum { NORM_NONE = 0, NORM_DEFAULT = 1, NORM_REVERSE = 2 };
enum { FIT_LEAST = 0, FIT_MOST = 1, FIT_RTCR = 2 };

}  // namespace

// The enabled plugins, their order, weights and static arguments: plain
// ints, packed by engine/cuda.py `pack_config` in this field order.
struct Cfg {
  int n_filters;
  int filter[MAX_F];
  int n_scores;
  int score[MAX_S];
  int mode[MAX_S];
  int fit_type;
  int fit_wsum;
  int fit_n;
  int fit_r[MAX_SPEC];
  int fit_w[MAX_SPEC];
  int rtcr_n;
  int rtcr_x[MAX_PTS];
  int rtcr_y[MAX_PTS];
  int bal_n;
  int bal_r[MAX_BAL];
};

// Device pointers of the cluster planes (engine/encode.py ClusterArrays).
// Resource planes hold the policy's integer type; bools are one byte.
struct Planes {
  const void* node_alloc;
  const unsigned char* node_unsched;
  const unsigned char* node_mask;
  const void* pod_req;
  const void* pod_sreq;
  const int* pod_req_rank;
  const int* pod_node_name;
  const unsigned char* pod_tol_unsched;
  const int* taint_key;
  const int* taint_val;
  const int* taint_effect;
  const int* tol_key;
  const int* tol_val;
  const int* tol_effect;
  const int* tol_op;
  int N, P, R, T, L;
};

// Device pointers of the state (engine/encode.py SchedState), updated in place.
struct State {
  void* requested;
  void* s_requested;
  int* n_pods;
  int* assignment;
  int* bound_seq;
};

namespace {

template <typename I> struct Lim;
template <> struct Lim<int> {
  static constexpr int lo = INT_MIN;
  static constexpr int hi = INT_MAX;
};
template <> struct Lim<long long> {
  static constexpr long long lo = LLONG_MIN;
  static constexpr long long hi = LLONG_MAX;
};

// Wrapping add, subtract and multiply in I (signed overflow is undefined in
// C++; XLA wraps).
template <typename I> __device__ __forceinline__ I wadd(I a, I b) {
  using U = typename std::make_unsigned<I>::type;
  return (I)((U)a + (U)b);
}
template <typename I> __device__ __forceinline__ I wsub(I a, I b) {
  using U = typename std::make_unsigned<I>::type;
  return (I)((U)a - (U)b);
}
template <typename I> __device__ __forceinline__ I wmul(I a, I b) {
  using U = typename std::make_unsigned<I>::type;
  return (I)((U)a * (U)b);
}
// Floor division and modulo, as jnp's `//` and `%` (b > 0 at every call).
template <typename I> __device__ __forceinline__ I fdiv(I a, I b) {
  I q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}
template <typename I> __device__ __forceinline__ I fmod_(I a, I b) {
  I r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}
template <typename I> __device__ __forceinline__ I imax(I a, I b) { return a > b ? a : b; }
template <typename I> __device__ __forceinline__ I imin(I a, I b) { return a < b ? a : b; }

template <typename I> struct Smem {
  I red_v[32];
  int red_i[32];
};

// ---------------------------------------------------------------------------
// plugin bodies (engine/kernels.py)
// ---------------------------------------------------------------------------

// _tolerated: is taint slot t of node n tolerated by pod ps?
__device__ bool tolerated(const Planes& a, int ps, int n, int t) {
  const int ne = a.taint_effect[n * a.T + t];
  const int nk = a.taint_key[n * a.T + t];
  const int nv = a.taint_val[n * a.T + t];
  for (int l = 0; l < a.L; ++l) {
    const int op = a.tol_op[ps * a.L + l];
    if (op < 0) continue;
    const int te = a.tol_effect[ps * a.L + l];
    const int tk = a.tol_key[ps * a.L + l];
    const int tv = a.tol_val[ps * a.L + l];
    const bool eff_ok = (te == -1) || (te == ne);
    const bool key_ok = (tk == -1) || (tk == nk);
    // Exists always matches; Equal needs the value; unknown ops never
    const bool val_ok = (op == 1) || (op == 0 && tv == nv);
    if (eff_ok && key_ok && val_ok) return true;
  }
  return false;
}

template <typename I>
__device__ int filter_code(int fid, const Planes& a, const State& s, int ps, int n) {
  switch (fid) {
    case F_UNSCHED:
      return (a.node_unsched[n] && !a.pod_tol_unsched[ps]) ? 1 : 0;
    case F_NODENAME: {
      const int want = a.pod_node_name[ps];
      return (want != -1 && n != want) ? 1 : 0;
    }
    case F_TAINT:
      for (int t = 0; t < a.T; ++t) {
        const int e = a.taint_effect[n * a.T + t];
        // NoSchedule | NoExecute, untolerated: the first such slot
        if ((e == 0 || e == 2) && !tolerated(a, ps, n, t)) return t + 1;
      }
      return 0;
    case F_FIT: {
      const int R = a.R;
      const I* alloc = (const I*)a.node_alloc + (size_t)n * R;
      const I* used = (const I*)s.requested + (size_t)n * R;
      const I* req = (const I*)a.pod_req + (size_t)ps * R;
      // "Too many pods" beats insufficient resources
      if ((I)wadd<int>(s.n_pods[n], 1) > alloc[PODS_RES]) return 1;
      int best_rank = R + 1, first_r = -1;
      for (int r = 0; r < R; ++r) {
        const I free_r = wsub<I>(alloc[r], used[r]);
        if (req[r] > 0 && req[r] > free_r) {
          // first violating resource in the pod's request-dict order
          const int rk = a.pod_req_rank[(size_t)ps * R + r];
          if (rk < best_rank) {
            best_rank = rk;
            first_r = r;
          }
        }
      }
      return first_r >= 0 ? 2 + first_r : 0;
    }
  }
  return 0;
}

// helper.BuildBrokenLinearFunction with Go's truncating division, as the
// reference's broken_linear_vec writes it (sign fixup over floor division).
template <typename I> __device__ I broken_linear(const Cfg& c, I u) {
  I y = (I)c.rtcr_y[0];
  for (int i = 0; i + 1 < c.rtcr_n; ++i) {
    const I x1 = (I)c.rtcr_x[i], y1 = (I)c.rtcr_y[i];
    const I x2 = (I)c.rtcr_x[i + 1], y2 = (I)c.rtcr_y[i + 1];
    const I prod = wmul<I>(wsub<I>(u, x1), (I)(y2 - y1));
    const I dx = imax<I>(x2 - x1, 1);
    const I sign = prod > 0 ? 1 : (prod < 0 ? -1 : 0);
    const I absprod = prod < 0 ? wsub<I>(0, prod) : prod;
    const I seg = wadd<I>(wmul<I>(sign, fdiv<I>(absprod, dx)), y1);
    if (u >= x1) y = seg;
  }
  if (u >= (I)c.rtcr_x[c.rtcr_n - 1]) y = (I)c.rtcr_y[c.rtcr_n - 1];
  return y;
}

template <typename I>
__device__ I fit_score(const Cfg& c, const Planes& a, const State& s, int ps, int n) {
  const int R = a.R;
  I total = 0;
  for (int k = 0; k < c.fit_n; ++k) {
    const int r = c.fit_r[k];
    const I cap = ((const I*)a.node_alloc)[(size_t)n * R + r];
    const I req = wadd<I>(((const I*)s.s_requested)[(size_t)n * R + r],
                          ((const I*)a.pod_sreq)[(size_t)ps * R + r]);
    const bool over = (cap == 0) || (req > cap);
    const I cap1 = imax<I>(cap, 1);
    I rs;
    if (c.fit_type == FIT_RTCR) {
      // over-capacity / zero-capacity evaluates the shape at max utilization
      const I u = over ? (I)100 : fdiv<I>(wmul<I>(req, 100), cap1);
      rs = broken_linear<I>(c, u);
    } else if (c.fit_type == FIT_MOST) {
      rs = over ? (I)0 : fdiv<I>(wmul<I>(req, MAX_NODE_SCORE), cap1);
    } else {
      rs = over ? (I)0 : fdiv<I>(wmul<I>(wsub<I>(cap, req), MAX_NODE_SCORE), cap1);
    }
    total = wadd<I>(total, wmul<I>(rs, (I)c.fit_w[k]));
  }
  return c.fit_wsum == 0 ? total : fdiv<I>(total, (I)c.fit_wsum);
}

// floor(num * 2^16 / den), base-256 long division in I (_div_scale_exact)
template <typename I> __device__ I div_scale_exact(I num, I den) {
  den = imax<I>(den, 1);
  I acc = fdiv<I>(num, den);
  I rem = fmod_<I>(num, den);
  for (int shift = 0; shift < 16; shift += 8) {
    acc = wadd<I>(wmul<I>(acc, 256), fdiv<I>(wmul<I>(rem, 256), den));
    rem = fmod_<I>(wmul<I>(rem, 256), den);
  }
  return acc;
}

// floor(sqrt(x)) for int64 x < 2^52 (_exact_isqrt64)
__device__ long long exact_isqrt64(long long x) {
  long long s = (long long)floor(__dsqrt_rn((double)x));
  if (s * s > x) s -= 1;
  if ((s + 1) * (s + 1) <= x) s += 1;
  return s;
}

template <typename I>
__device__ I balanced_score(const Cfg& c, const Planes& a, const State& s, int ps, int n) {
  const int K = c.bal_n;
  if (K == 0) return (I)MAX_NODE_SCORE;
  const int R = a.R;
  I q[MAX_BAL];
  bool incl[MAX_BAL];
  I nf = 0;
  I qmax = Lim<I>::lo, qmin = Lim<I>::hi;
  for (int k = 0; k < K; ++k) {
    const int r = c.bal_r[k];
    const I cap = ((const I*)a.node_alloc)[(size_t)n * R + r];
    const I req = wadd<I>(((const I*)s.s_requested)[(size_t)n * R + r],
                          ((const I*)a.pod_sreq)[(size_t)ps * R + r]);
    incl[k] = cap > 0;
    q[k] = div_scale_exact<I>(imin<I>(req, cap), cap);
    if (incl[k]) {
      nf += 1;
      qmax = imax<I>(qmax, q[k]);
      qmin = imin<I>(qmin, q[k]);
    }
  }
  const I S = (I)BALANCED_SCALE;
  const I d = wsub<I>(qmax, qmin);
  const I score2 = fdiv<I>(wsub<I>(200 * S, wmul<I>(100, d)), 2 * S);
  I score_n;
  if constexpr (sizeof(I) == 8) {
    // EXACT: A = nf*Σq² - (Σq)², score = 100 - ceil(100*sqrt(A)/(nf*S))
    I sum_q = 0, sum_q2 = 0;
    for (int k = 0; k < K; ++k) {
      if (!incl[k]) continue;
      sum_q = wadd<I>(sum_q, q[k]);
      sum_q2 = wadd<I>(sum_q2, wmul<I>(q[k], q[k]));
    }
    const I A = wsub<I>(wmul<I>(nf, sum_q2), wmul<I>(sum_q, sum_q));
    const I x2 = wmul<I>(10000, A);
    const I D = imax<I>(nf, 1) * S;
    const I k = x2 == 0 ? (I)0 : fdiv<I>(exact_isqrt64(imax<I>(x2 - 1, 0)), D) + 1;
    score_n = (I)MAX_NODE_SCORE - k;
  } else {
    // TPU32: float32 mean / variance / sqrt, resources summed left to right
    float f[MAX_BAL];
    const float nff = (float)imax<I>(nf, 1);
    float mean = 0.0f;
    for (int k = 0; k < K; ++k) {
      f[k] = __fdiv_rn((float)q[k], 65536.0f);
      const float fz = incl[k] ? f[k] : 0.0f;
      mean = k == 0 ? fz : __fadd_rn(mean, fz);
    }
    mean = __fdiv_rn(mean, nff);
    float var = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float dv = __fsub_rn(f[k], mean);
      const float sq = incl[k] ? __fmul_rn(dv, dv) : 0.0f;
      var = k == 0 ? sq : __fadd_rn(var, sq);
    }
    var = __fdiv_rn(var, nff);
    const float sd = __fsqrt_rn(var);
    score_n = (I)floorf(__fmul_rn(__fsub_rn(1.0f, sd), (float)MAX_NODE_SCORE));
  }
  I score = nf == 2 ? score2 : score_n;
  return nf < 2 ? (I)MAX_NODE_SCORE : score;
}

template <typename I>
__device__ I taint_score(const Planes& a, int ps, int n) {
  I cnt = 0;
  for (int t = 0; t < a.T; ++t) {
    // PreferNoSchedule, untolerated
    if (a.taint_effect[n * a.T + t] == 1 && !tolerated(a, ps, n, t)) cnt += 1;
  }
  return cnt;
}

template <typename I>
__device__ I score_raw(const Cfg& c, int j, const Planes& a, const State& s, int ps, int n) {
  switch (c.score[j]) {
    case S_FIT:
      return fit_score<I>(c, a, s, ps, n);
    case S_BALANCED:
      return balanced_score<I>(c, a, s, ps, n);
    case S_TAINT:
      return taint_score<I>(a, ps, n);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// block reductions (blockDim.x is a multiple of 32)
// ---------------------------------------------------------------------------

template <typename I> __device__ I block_max(I v, Smem<I>& sm) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = imax<I>(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) sm.red_v[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < nw ? sm.red_v[lane] : Lim<I>::lo;
    for (int o = 16; o > 0; o >>= 1) v = imax<I>(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) sm.red_v[0] = v;
  }
  __syncthreads();
  const I r = sm.red_v[0];
  __syncthreads();
  return r;
}

// (value, index) with the larger value winning and, on a tie, the lower
// index: jnp.argmax's first-occurrence rule. Index INT_MAX marks "none".
template <typename I> __device__ __forceinline__ void arg_better(I& v, int& i, I v2, int i2) {
  if (i2 != INT_MAX && (i == INT_MAX || v2 > v || (v2 == v && i2 < i))) {
    v = v2;
    i = i2;
  }
}

template <typename I> __device__ int block_argmax(I v, int i, Smem<I>& sm) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const I v2 = __shfl_down_sync(0xffffffffu, v, o);
    const int i2 = __shfl_down_sync(0xffffffffu, i, o);
    arg_better<I>(v, i, v2, i2);
  }
  if (lane == 0) {
    sm.red_v[wid] = v;
    sm.red_i[wid] = i;
  }
  __syncthreads();
  if (wid == 0) {
    v = lane < nw ? sm.red_v[lane] : Lim<I>::lo;
    i = lane < nw ? sm.red_i[lane] : INT_MAX;
    for (int o = 16; o > 0; o >>= 1) {
      const I v2 = __shfl_down_sync(0xffffffffu, v, o);
      const int i2 = __shfl_down_sync(0xffffffffu, i, o);
      arg_better<I>(v, i, v2, i2);
    }
    if (lane == 0) sm.red_i[0] = i;
  }
  __syncthreads();
  const int r = sm.red_i[0];
  __syncthreads();
  return r;
}

// ---------------------------------------------------------------------------
// the step: attempt (K1) and bind (K2)
// ---------------------------------------------------------------------------

// One Filter→Score→Normalize→select pass for pod ps. Writes codes[N,F],
// raw[N,S] and (when fin is not null) final[N,S]; returns sel to every
// thread. feas[N] is scratch.
template <typename I>
__device__ int attempt_body(const Cfg& c, const Planes& a, const State& s, const I* w, int ps,
                            int* codes, I* raw, I* fin, unsigned char* feas, Smem<I>& sm) {
  const int N = a.N, F = c.n_filters, S = c.n_scores;
  I mx[MAX_S];
  for (int j = 0; j < S; ++j) mx[j] = Lim<I>::lo;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    bool ok = a.node_mask[n] != 0;
    for (int f = 0; f < F; ++f) {
      const int code = filter_code<I>(c.filter[f], a, s, ps, n);
      codes[(size_t)n * F + f] = code;
      ok = ok && code == 0;
    }
    feas[n] = ok;
    for (int j = 0; j < S; ++j) {
      const I r = score_raw<I>(c, j, a, s, ps, n);
      raw[(size_t)n * S + j] = r;
      mx[j] = imax<I>(mx[j], ok ? r : (I)0);  // max(where(feasible, r, 0))
    }
  }
  for (int j = 0; j < S; ++j) {
    if (c.mode[j] != NORM_NONE) mx[j] = block_max<I>(mx[j], sm);
  }
  const I NEG = Lim<I>::lo / 2;
  I best = Lim<I>::lo;
  int best_i = INT_MAX;
  bool any = false;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const bool ok = feas[n] != 0;
    I total = 0;
    for (int j = 0; j < S; ++j) {
      const I r = raw[(size_t)n * S + j];
      I normed = r;
      if (c.mode[j] != NORM_NONE) {
        const I m = mx[j];
        const I scaled = fdiv<I>(wmul<I>(r, MAX_NODE_SCORE), imax<I>(m, 1));
        if (c.mode[j] == NORM_REVERSE)
          normed = m == 0 ? (I)MAX_NODE_SCORE : wsub<I>(MAX_NODE_SCORE, scaled);
        else
          normed = m == 0 ? r : scaled;
      }
      const I fv = wmul<I>(normed, w[j]);
      if (fin) fin[(size_t)n * S + j] = fv;
      total = wadd<I>(total, fv);
    }
    any = any || ok;
    arg_better<I>(best, best_i, ok ? total : NEG, n);
  }
  const bool any_feasible = __syncthreads_or(any) != 0;
  const int idx = block_argmax<I>(best, best_i, sm);
  return any_feasible ? idx : -1;
}

// Scatter pod p onto node sel (engine.py bind). p < 0 (a queue-bucket
// padding step) is an exact no-op; sel < 0 only records the pod as
// unschedulable.
template <typename I>
__device__ void bind_body(const Planes& a, const State& s, int p, int sel, int qi) {
  if (p < 0) return;
  const int R = a.R;
  if (sel >= 0) {
    I* rq = (I*)s.requested + (size_t)sel * R;
    I* srq = (I*)s.s_requested + (size_t)sel * R;
    const I* pr = (const I*)a.pod_req + (size_t)p * R;
    const I* psr = (const I*)a.pod_sreq + (size_t)p * R;
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      rq[r] = wadd<I>(rq[r], pr[r]);
      srq[r] = wadd<I>(srq[r], psr[r]);
    }
  }
  if (threadIdx.x == 0) {
    if (sel >= 0) s.n_pods[sel] = wadd<int>(s.n_pods[sel], 1);
    s.assignment[p] = sel;
    s.bound_seq[p] = sel >= 0 ? wadd<int>(a.P, qi) : -1;
  }
}

template <typename I>
__global__ void __launch_bounds__(1024)
    seq_attempt_kernel(Cfg c, Planes a, State s, const I* w, int p, int* codes, I* raw, I* fin,
                       int* sel, unsigned char* feas) {
  __shared__ Smem<I> sm;
  const int r = attempt_body<I>(c, a, s, w, p, codes, raw, fin, feas, sm);
  if (threadIdx.x == 0) *sel = r;
}

template <typename I>
__global__ void seq_bind_kernel(Planes a, State s, int p, const int* sel, int qi) {
  bind_body<I>(a, s, p, *sel, qi);
}

template <typename I>
__global__ void __launch_bounds__(1024)
    seq_run_kernel(Cfg c, Planes a, State s, const I* w, const int* queue, int Q, int record,
                   int* codes, I* raw, I* fin, int* sel, unsigned char* feas, int* codes_scratch,
                   I* raw_scratch) {
  __shared__ Smem<I> sm;
  const size_t nf = (size_t)a.N * c.n_filters, ns = (size_t)a.N * c.n_scores;
  for (int qi = 0; qi < Q; ++qi) {
    const int p = queue[qi];
    // a padding step (p == -1) evaluates pod 0 and discards the result
    const int ps = p > 0 ? p : 0;
    int* cr = record ? codes + (size_t)qi * nf : codes_scratch;
    I* rr = record ? raw + (size_t)qi * ns : raw_scratch;
    I* fr = record ? fin + (size_t)qi * ns : nullptr;
    int sl = attempt_body<I>(c, a, s, w, ps, cr, rr, fr, feas, sm);
    if (p < 0) sl = -1;
    if (threadIdx.x == 0) sel[qi] = sl;
    bind_body<I>(a, s, p, sl, qi);
    __syncthreads();  // pod qi+1 sees pod qi's bind
  }
}

int block_threads(int N) {
  int t = ((N + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

template <typename I>
int launch_attempt(const Cfg* c, const Planes* a, const State* s, const void* w, int p,
                   int* codes, void* raw, void* fin, int* sel, unsigned char* feas,
                   void* stream) {
  seq_attempt_kernel<I><<<1, block_threads(a->N), 0, (cudaStream_t)stream>>>(
      *c, *a, *s, (const I*)w, p, codes, (I*)raw, (I*)fin, sel, feas);
  return (int)cudaGetLastError();
}

template <typename I>
int launch_bind(const Planes* a, const State* s, int p, const int* sel, int qi, void* stream) {
  seq_bind_kernel<I><<<1, 32, 0, (cudaStream_t)stream>>>(*a, *s, p, sel, qi);
  return (int)cudaGetLastError();
}

template <typename I>
int launch_run(const Cfg* c, const Planes* a, const State* s, const void* w, const int* queue,
               int Q, int record, int* codes, void* raw, void* fin, int* sel,
               unsigned char* feas, int* codes_scratch, void* raw_scratch, void* stream) {
  seq_run_kernel<I><<<1, block_threads(a->N), 0, (cudaStream_t)stream>>>(
      *c, *a, *s, (const I*)w, queue, Q, record, codes, (I*)raw, (I*)fin, sel, feas,
      codes_scratch, (I*)raw_scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// plain C interface (engine/cuda.py binds it with ctypes). Each launcher
// returns cudaGetLastError() after the launch; the kernels run on the
// caller's stream and allocate nothing.
// ---------------------------------------------------------------------------

extern "C" {

int seq_cfg_ints() { return (int)(sizeof(Cfg) / sizeof(int)); }
int seq_planes_bytes() { return (int)sizeof(Planes); }
int seq_state_bytes() { return (int)sizeof(State); }

int seq_attempt_i32(const Cfg* c, const Planes* a, const State* s, const void* w, int p,
                    int* codes, void* raw, void* fin, int* sel, unsigned char* feas,
                    void* stream) {
  return launch_attempt<int>(c, a, s, w, p, codes, raw, fin, sel, feas, stream);
}
int seq_attempt_i64(const Cfg* c, const Planes* a, const State* s, const void* w, int p,
                    int* codes, void* raw, void* fin, int* sel, unsigned char* feas,
                    void* stream) {
  return launch_attempt<long long>(c, a, s, w, p, codes, raw, fin, sel, feas, stream);
}
int seq_bind_i32(const Planes* a, const State* s, int p, const int* sel, int qi, void* stream) {
  return launch_bind<int>(a, s, p, sel, qi, stream);
}
int seq_bind_i64(const Planes* a, const State* s, int p, const int* sel, int qi, void* stream) {
  return launch_bind<long long>(a, s, p, sel, qi, stream);
}
int seq_run_i32(const Cfg* c, const Planes* a, const State* s, const void* w, const int* queue,
                int Q, int record, int* codes, void* raw, void* fin, int* sel,
                unsigned char* feas, int* codes_scratch, void* raw_scratch, void* stream) {
  return launch_run<int>(c, a, s, w, queue, Q, record, codes, raw, fin, sel, feas,
                         codes_scratch, raw_scratch, stream);
}
int seq_run_i64(const Cfg* c, const Planes* a, const State* s, const void* w, const int* queue,
                int Q, int record, int* codes, void* raw, void* fin, int* sel,
                unsigned char* feas, int* codes_scratch, void* raw_scratch, void* stream) {
  return launch_run<long long>(c, a, s, w, queue, Q, record, codes, raw, fin, sel, feas,
                               codes_scratch, raw_scratch, stream);
}

}  // extern "C"
