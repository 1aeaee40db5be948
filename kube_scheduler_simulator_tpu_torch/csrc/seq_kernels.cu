// Hand-written Hopper (sm_90a) kernels for the sequential scheduling pass.
//
// Six kernels share the plugin bodies below (`filter_code`, `score_raw`),
// the dry run (`dry_run`) and the eviction (`evict_pod`):
//
//   seq_attempt  replaces kube_scheduler_simulator_tpu/engine/engine.py
//                BatchedScheduler._build_run.attempt (`seq.attempt`): for one
//                pod, the VolumeBinding prefilter, every enabled filter and
//                score plugin over all N nodes, the normalize step, the
//                weights and the masked argmax with lowest-index tie-break.
//   seq_bind     replaces _build_run.bind (`seq.bind`): the scatter of the
//                chosen pod's rows into per-node state, in place.
//   seq_evict    replaces _build_run.evict_all: the masked scatter-subtract
//                of preemption victims, in place.
//   seq_preempt  replaces engine/preempt.py build_preemption's `preempt`:
//                the DefaultPreemption dry run for one pod.
//   seq_run      replaces _build_run.step / run_segment / run (`seq.run`,
//                the lax.scan over the queue): one persistent block walks
//                the bucket-padded queue, attempt then bind per step, and
//                writes each step's trace row; with DefaultPreemption, an
//                unschedulable pod's step runs the dry run, evicts the
//                nominated node's victims, retries and runs a second dry
//                run (recorded, never evicting) before the bind.
//   sweep_run    replaces parallel/sweep.py WeightSweep's programs
//                (`sweep.vrun`, `vmap` of the pass over a [V, S] weight
//                matrix, :111-114; and the phase mode's event loop,
//                `sweep.until0` / `sweep.until` / `sweep.preempt1`,
//                :118-129): V variants of seq_run's pass, one block a
//                variant at a time, sharing its step body (`run_body`).
//                A block branches per variant, so the preemption branch
//                fires in each variant as seq_run's does; the reference
//                needs its masked form or host event loop only because
//                vmap cannot branch.
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
// sweep_run does seq_run's work once a variant: its bound is every
// variant's step operations (the planes, read by all variants, come from L2
// once warm; each variant reads and writes only its own state). Each block
// is as latency-bound as seq_run's, so the design fills the card with
// variants where seq_run uses one SM: a grid of as many resident blocks as
// fit (one an SM at 1,024 threads), striding over the variants; each block
// keeps one scratch and workspace slice for all of its variants. More than
// one variant a block, or blocks of fewer threads so that several fit an
// SM, is later work.
//
// The relational plugins (PodTopologySpread, InterPodAffinity) need counts
// over every bound pod before any node can be decided. A step is therefore
// a run of phases separated by __syncthreads(): clear a workspace (global
// memory, allocated once per launch by the caller), walk all P pods and
// scatter their matches into per-(term, topology pair) counters with
// integer atomics (integer adds commute, so the result does not depend on
// their order), aggregate nodes into topology pairs, then the node sweep
// (filters), the spread score's prologue over feasible nodes, the raw
// scores with their block reductions, and the normalize, argmax and bind.
// Plugins that are not enabled skip their phases.
//
// The dry run (one thread per candidate node) appends each bound pod of
// lower priority to its node's list with an atomic cursor, sorts each list
// into reprieve order, keeps every state-dependent filter's counters for
// the node with its victims removed (only what the pod's check reads),
// then returns them one by one, keeping each that leaves the pod feasible.
// The spread row's minimum over topology pairs comes from the step's base
// table (its two smallest entries) and the node's own changed entries, not
// from a per-node copy of the table. Three block reductions in 64 bits
// rank the candidates. A dry run costs O(P) for the lists, O(V^2) per node
// for the sort and O(V x rows) per node for the reprieve; it is latency
// bound as the step is.
//
// Arithmetic follows the reference bit for bit. Integer `//` floors (C++
// `/` truncates), every intermediate stays in the policy's type (int32 for
// TPU32, int64 for EXACT) and wraps as XLA's does, through unsigned
// arithmetic; the sums the reference takes in 64 bits (it runs with 64-bit
// types enabled: the spread total, the image sum, the node-affinity
// weights) are taken in 64 bits and cast at the end. Float steps use the round-to-nearest intrinsics, so no
// fused multiply-add changes a rounding; the build does not use
// --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "seq_layout.h"

namespace {

constexpr int PODS_RES = 3;
constexpr int MAX_NODE_SCORE = 100;
constexpr long long BALANCED_SCALE = 1LL << 16;
constexpr long long SPREAD_SCALE = 1LL << 12;
constexpr long long IMG_MIN_KI = 23 * 1024;
constexpr long long IMG_MAX_CONTAINER_KI = 1000 * 1024;
constexpr int BIG = INT_MAX;  // the custom normalizes' min/max sentinel

// plugin ids, as engine/kernels.py's registries name them
enum {
  F_UNSCHED = 0, F_NODENAME = 1, F_TAINT = 2, F_FIT = 3,
  F_AFFINITY = 4, F_PORTS = 5, F_SPREAD = 6, F_INTERPOD = 7,
  F_VOLRESTR = 8, F_EBS = 9, F_GCEPD = 10, F_AZURE = 11, F_NODEVOL = 12,
  F_VOLBIND = 13, F_VOLZONE = 14
};
// DefaultPreemption's per-node codes (engine/preempt.py PREEMPT_*)
enum { P_NO_LOWER = 0, P_NO_FIT = 1, P_CANDIDATE = 2, P_SELECTED = 3, P_SILENT = 4 };
// VolumeRestrictions reason codes (engine/kernels.py VR_*)
enum { VR_RWOP = 1, VR_DISK = 2 };
enum {
  S_FIT = 0, S_BALANCED = 1, S_TAINT = 2,
  S_AFFINITY = 3, S_IMAGE = 4, S_SPREAD = 5, S_INTERPOD = 6
};
enum { NORM_NONE = 0, NORM_DEFAULT = 1, NORM_REVERSE = 2, NORM_CUSTOM = 3 };
enum { FIT_LEAST = 0, FIT_MOST = 1, FIT_RTCR = 2 };
// label-selector clause types (engine/encode_rel.py)
enum { CL_PAD = -1, PAIR_ANY = 0, NOTIN = 1, EXISTS = 2, DNE = 3 };

}  // namespace


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

// Integer atomics in the policy's type (two's-complement adds wrap, as the
// reference's int32 scatter-adds do).
__device__ __forceinline__ void atomic_add(int* p, int v) { atomicAdd(p, v); }
__device__ __forceinline__ void atomic_add(long long* p, long long v) {
  atomicAdd((unsigned long long*)p, (unsigned long long)v);
}

// ---------------------------------------------------------------------------
// the per-step workspace of the relational plugins
// ---------------------------------------------------------------------------

// The dry run's per-node counters (DefaultPreemption), laid out after the
// step workspace when the configuration enables it. Each node's thread
// owns its rows: the victims it may evict, their reprieve flags, and every
// row filter's counters with the victims removed (engine/preempt.py).
struct Pws {
  int* vlist;             // [N, V] lower-priority pods per node, reprieve order
  unsigned char* vflag;   // [N, V] 1: the pod stays a victim after reprieve
  int* vcount;            // [N] lower-priority pods per node (append cursor)
  int* nrec;              // [N] victims recorded (candidate nodes only)
  int* code;              // [N] the node's code
  int* maxp;              // [N] highest victim priority
  long long* sump;        // [N] victim priorities summed in 64 bits
  long long* total3;      // [N] InterPodAffinity affinity matches over all pairs
  unsigned char* alive;   // [N] still a candidate in the ranking
  char* req;              // [N, R] NodeResourcesFit's requested, policy type
  int* npods;             // [N]
  int* upair;             // [N, Q] NodePorts' counters
  int* uwild;             // [N, Q]
  int* utrip;             // [N, V2]
  int* sp_cur;            // [N, HC] spread counts at the node's own pairs
  int* sp_min;            // [HC, 4] base minimum over present pairs, its pair,
                          //   the second minimum, any pair present
  int* ea_cur;            // [N, K] existing anti-affinity hits at the node's pairs
  int* f2_cur;            // [N, T_ian] the pod's anti-affinity matches at its pairs
  int* f3_cur;            // [N, T_ia] the pod's affinity matches at its pairs
  int* cl_cur;            // [N, CL] users of the pod's RWOP claims (by list slot)
  int* dk_any;            // [N, D] mounts of the pod's disks (by list slot)
  int* dk_rw;             // [N, D]
  int* vol3;              // [N, 3] per-type volume counts
};

// Pointers into the workspace the caller allocates once per launch. HC/SC:
// hard/soft spread constraints of the widest pod, NP1: topology pairs + 1.
struct Ws {
  void* wsum;             // [NP1] InterPodAffinity score weight per pair, policy type
  int* cnt_h;             // [HC, N] matching bound pods per hard constraint and node
  int* cnt_s;             // [SC, N] the same for soft constraints
  int* val_h;             // [HC, NP1] eligible nodes' counts summed per pair
  int* pres_h;            // [HC, NP1] eligible nodes per pair
  int* val_s;             // [SC, NP1]
  int* pres_s;            // [SC, NP1] scored nodes per pair
  int* min_h;             // [HC] least count over present pairs (INT_MAX: none)
  int* topo_s;            // [SC] present pairs (topology size)
  int* ea;                // [NP1] existing pods' anti-affinity hits per pair
  int* anti;              // [T_ian, NP1] the pod's anti-affinity matches per pair
  int* affc;              // [T_ia, NP1] the pod's affinity matches per pair
  int* scal;              // [2] affinity matches over all pairs > 0, scored nodes
  unsigned char* aff_ok;  // [N] the NodeAffinity filter body holds
  unsigned char* ign;     // [N] the spread score ignores the node
  int n_words;            // 32-bit words from wsum through scal, cleared each step
  int min_lo, min_hi;     // the words of min_h (cleared to INT_MAX)
  int* vol;               // [4] a RWOP claim of the pod is in use, its disks, its
                          //   RWOP claims, the dry run's overflow bits
  int* pdl;               // [D] the pod's disks (pod_disk_any > 0)
  int* pcl;               // [CL] the pod's RWOP claims
  Pws pw;                 // the dry run's counters (vbound > 0)
};

// The workspace layout for these planes, an integer type of `isz` bytes
// and a dry run keeping `V` victims per node (0: no dry run); fills *w from
// `base` when w is not null. Returns its size in bytes.
__host__ __device__ inline size_t ws_layout(const Planes& a, size_t isz, int V, char* base,
                                            Ws* w) {
  const size_t N = a.N, NP1 = a.NP1, HC = a.sph.T, SC = a.sps.T;
  size_t off = (NP1 * isz + 7) & ~(size_t)7;
  const size_t o_cnt_h = off;  off += HC * N * 4;
  const size_t o_cnt_s = off;  off += SC * N * 4;
  const size_t o_val_h = off;  off += HC * NP1 * 4;
  const size_t o_pres_h = off; off += HC * NP1 * 4;
  const size_t o_val_s = off;  off += SC * NP1 * 4;
  const size_t o_pres_s = off; off += SC * NP1 * 4;
  const size_t o_min_h = off;  off += HC * 4;
  const size_t o_topo_s = off; off += SC * 4;
  const size_t o_ea = off;     off += NP1 * 4;
  const size_t o_anti = off;   off += (size_t)a.ian.T * NP1 * 4;
  const size_t o_affc = off;   off += (size_t)a.ia.T * NP1 * 4;
  const size_t o_scal = off;   off += 2 * 4;
  const size_t words = off / 4;
  const size_t o_vol = off;    off += 4 * 4;
  const size_t o_pdl = off;    off += (size_t)a.D * 4;
  const size_t o_pcl = off;    off += (size_t)a.CL * 4;
  const size_t o_aff = off;    off += N;
  const size_t o_ign = off;    off += N;
  off = (off + 7) & ~(size_t)7;
  if (w) {
    w->wsum = base;
    w->cnt_h = (int*)(base + o_cnt_h);
    w->cnt_s = (int*)(base + o_cnt_s);
    w->val_h = (int*)(base + o_val_h);
    w->pres_h = (int*)(base + o_pres_h);
    w->val_s = (int*)(base + o_val_s);
    w->pres_s = (int*)(base + o_pres_s);
    w->min_h = (int*)(base + o_min_h);
    w->topo_s = (int*)(base + o_topo_s);
    w->ea = (int*)(base + o_ea);
    w->anti = (int*)(base + o_anti);
    w->affc = (int*)(base + o_affc);
    w->scal = (int*)(base + o_scal);
    w->aff_ok = (unsigned char*)(base + o_aff);
    w->ign = (unsigned char*)(base + o_ign);
    w->n_words = (int)words;
    w->min_lo = (int)(o_min_h / 4);
    w->min_hi = (int)(o_min_h / 4 + HC);
    w->vol = (int*)(base + o_vol);
    w->pdl = (int*)(base + o_pdl);
    w->pcl = (int*)(base + o_pcl);
  }
  if (V <= 0) return off;
  // the dry run's rows: 8-byte members first, then 4-byte, then bytes
  const size_t K = a.K;
  Pws p;
  auto take = [&](size_t bytes) {
    char* at = base ? base + off : nullptr;
    off += (bytes + 7) & ~(size_t)7;
    return at;
  };
  p.sump = (long long*)take(N * 8);
  p.total3 = (long long*)take(N * 8);
  p.req = take(N * a.R * isz);
  p.vlist = (int*)take(N * (size_t)V * 4);
  p.vcount = (int*)take(N * 4);
  p.nrec = (int*)take(N * 4);
  p.code = (int*)take(N * 4);
  p.maxp = (int*)take(N * 4);
  p.npods = (int*)take(N * 4);
  p.upair = (int*)take(N * a.Q * 4);
  p.uwild = (int*)take(N * a.Q * 4);
  p.utrip = (int*)take(N * a.V2 * 4);
  p.sp_cur = (int*)take(N * HC * 4);
  p.sp_min = (int*)take(HC * 4 * 4);
  p.ea_cur = (int*)take(N * K * 4);
  p.f2_cur = (int*)take(N * (size_t)a.ian.T * 4);
  p.f3_cur = (int*)take(N * (size_t)a.ia.T * 4);
  p.cl_cur = (int*)take(N * (size_t)a.CL * 4);
  p.dk_any = (int*)take(N * (size_t)a.D * 4);
  p.dk_rw = (int*)take(N * (size_t)a.D * 4);
  p.vol3 = (int*)take(N * N_VOL3 * 4);
  p.vflag = (unsigned char*)take(N * (size_t)V);
  p.alive = (unsigned char*)take(N);
  if (w) w->pw = p;
  return off;
}

// Which phases a step runs, from the enabled plugins.
struct Need {
  bool aff;       // the NodeAffinity body per node (its filter, or spread)
  bool f_spread;  // PodTopologySpread filter
  bool s_spread;  // PodTopologySpread score, PreScore enabled
  bool f_ipa;     // InterPodAffinity filter
  bool s_ipa;     // InterPodAffinity score, PreScore enabled
  bool rel;       // any of the four: the workspace is cleared and filled
  bool vr;        // VolumeRestrictions filter: the pod's claims and disks
  bool fit, ports, lim[N_VOL3];  // the other state-dependent filters
};

__device__ Need need_of(const Cfg& c) {
  Need nd = {};
  for (int f = 0; f < c.n_filters; ++f) {
    const int id = c.filter[f];
    nd.aff |= id == F_AFFINITY;
    nd.f_spread |= id == F_SPREAD;
    nd.f_ipa |= id == F_INTERPOD;
    nd.vr |= id == F_VOLRESTR;
    nd.fit |= id == F_FIT;
    nd.ports |= id == F_PORTS;
    if (id >= F_EBS && id <= F_AZURE) nd.lim[id - F_EBS] = true;
  }
  for (int j = 0; j < c.n_scores; ++j) {
    nd.s_spread |= c.score[j] == S_SPREAD && c.spread_on;
    nd.s_ipa |= c.score[j] == S_INTERPOD && c.interpod_on;
  }
  nd.aff |= nd.f_spread || nd.s_spread;
  nd.rel = nd.f_spread || nd.s_spread || nd.f_ipa || nd.s_ipa;
  return nd;
}

// Filters whose codes read no state (engine/preempt.py STATELESS_FILTERS):
// the dry run evaluates them once on the unmodified state.
__device__ __forceinline__ bool stateless(int fid) {
  return fid == F_UNSCHED || fid == F_NODENAME || fid == F_TAINT || fid == F_AFFINITY ||
         fid == F_VOLBIND || fid == F_VOLZONE || fid == F_NODEVOL;
}

// ---------------------------------------------------------------------------
// label selectors and node affinity (engine/encode_rel.py _eval_clauses,
// engine/kernels.py _terms_match)
// ---------------------------------------------------------------------------

// Term t of pod `owner` in domain d, against the labels of pod `target`: an
// AND over its clauses (CL_PAD neutral; NotIn matches an absent key; NEVER
// and unknown types match nothing).
__device__ bool clauses_match(const Planes& a, const Terms& d, int owner, int t, int target) {
  const size_t row = (size_t)owner * d.T + t;
  const int* ct = d.ctype + row * d.C;
  const int* ck = d.ckey + row * d.C;
  const int* cp = d.cpairs + row * d.C * d.VP;
  const unsigned char* pp = a.pair_present + (size_t)target * a.LP;
  const unsigned char* kp = a.key_present + (size_t)target * a.KK;
  for (int c = 0; c < d.C; ++c) {
    const int ty = ct[c];
    if (ty == CL_PAD) continue;
    bool m = false;
    if (ty == PAIR_ANY || ty == NOTIN) {
      bool hit = false;
      for (int v = 0; v < d.VP; ++v) {
        const int pid = cp[(size_t)c * d.VP + v];
        hit = hit || (pid >= 0 && pp[pid]);
      }
      m = ty == PAIR_ANY ? hit : !hit;
    } else if (ty == EXISTS || ty == DNE) {
      const int kid = ck[c];
      const bool kh = kid >= 0 && kp[kid];
      m = ty == EXISTS ? kh : !kh;
    }
    if (!m) return false;
  }
  return true;
}

// Term t of pod `owner` selects namespace `ns`.
__device__ __forceinline__ bool ns_ok(const Planes& a, const Terms& d, int owner, int t, int ns) {
  const size_t row = (size_t)owner * d.T + t;
  return d.nsall[row] || d.ns[row * a.NSV + ns];
}

// Node n carries the topology key of every constraint of pod ps in d.
__device__ bool has_all_keys(const Planes& a, const Terms& d, int ps, int n) {
  const int* npn = a.node_pair + (size_t)n * a.K;
  for (int t = 0; t < d.T; ++t) {
    const int key = d.key[(size_t)ps * d.T + t];
    if (key >= 0 && npn[key] == 0) return false;
  }
  return true;
}

// One node-selector expression (row e of nt) against node n.
template <typename I>
__device__ bool expr_match(const Planes& a, const NodeTerms& nt, size_t e, int n) {
  const int key = nt.key[e];
  if (key == -1) return true;  // padding is neutral for the AND
  const size_t lk = (size_t)n * a.K + key;
  const int nval = a.label_val[lk];
  const bool present = nval >= 0;
  const int op = nt.op[e];
  if (op == 0 || op == 1) {  // In, NotIn (NotIn also matches an absent key)
    bool eq = false;
    for (int v = 0; v < nt.VV; ++v) eq = eq || nt.vals[e * nt.VV + v] == nval;
    return (op == 0) == (present && eq);
  }
  if (op == 2) return present;   // Exists
  if (op == 3) return !present;  // DoesNotExist
  if (op == 4 || op == 5) {      // Gt, Lt: both sides must parse
    if (!(present && a.label_num_ok[lk] && nt.num_ok[e])) return false;
    const I lhs = ((const I*)a.label_num)[lk], rhs = ((const I*)nt.num)[e];
    return op == 4 ? lhs > rhs : lhs < rhs;
  }
  return false;  // OP_NEVER
}

template <typename I>
__device__ bool term_match(const Planes& a, const NodeTerms& nt, int ps, int t, int n) {
  const size_t tr = (size_t)ps * nt.TM + t;
  if (!nt.term_valid[tr]) return false;
  for (int e = 0; e < nt.E; ++e)
    if (!expr_match<I>(a, nt, tr * nt.E + e, n)) return false;
  return true;
}

// nodeSelector AND required terms OR-ed (no terms: pass).
template <typename I>
__device__ bool node_affinity_ok(const Planes& a, int ps, int n) {
  for (int j = 0; j < a.NS; ++j) {
    const int k = a.nsel_key[(size_t)ps * a.NS + j];
    if (k != -1 && a.label_val[(size_t)n * a.K + k] != a.nsel_val[(size_t)ps * a.NS + j])
      return false;
  }
  if (!a.pod_has_raff[ps]) return true;
  for (int t = 0; t < a.raff.TM; ++t)
    if (term_match<I>(a, a.raff, ps, t, n)) return true;
  return false;
}

// ---------------------------------------------------------------------------
// the relational prologue (engine/kernels.py _spread_counts,
// _forward_pair_counts, the reverse terms of build_interpod_filter/score)
// ---------------------------------------------------------------------------

// Bound pod q's contributions to the counts of step pod ps.
template <typename I>
__device__ void rel_pod(const Cfg& c, const Planes& a, const State& s, const Need& nd,
                        const Ws& w, int ps, int q) {
  const int nq = s.assignment[q];
  if (nq < 0 || !a.pod_mask[q]) return;  // only bound pods count
  const int* npq = a.node_pair + (size_t)nq * a.K;
  const int N = a.N, NP1 = a.NP1;
  const int nsp = a.ns_id[ps], nsq = a.ns_id[q];
  if ((nd.f_spread || nd.s_spread) && nsq == nsp && !a.deleted[q]) {
    if (nd.f_spread)
      for (int t = 0; t < a.sph.T; ++t)
        if (a.sph.key[(size_t)ps * a.sph.T + t] >= 0 && clauses_match(a, a.sph, ps, t, q))
          atomicAdd(&w.cnt_h[(size_t)t * N + nq], 1);
    if (nd.s_spread)
      for (int t = 0; t < a.sps.T; ++t)
        if (a.sps.key[(size_t)ps * a.sps.T + t] >= 0 && clauses_match(a, a.sps, ps, t, q))
          atomicAdd(&w.cnt_s[(size_t)t * N + nq], 1);
  }
  if (nd.f_ipa) {
    // (1) q's required anti-affinity against ps
    for (int t = 0; t < a.ian.T; ++t) {
      const int key = a.ian.key[(size_t)q * a.ian.T + t];
      if (key >= 0 && npq[key] > 0 && ns_ok(a, a.ian, q, t, nsp) &&
          clauses_match(a, a.ian, q, t, ps))
        atomicAdd(&w.ea[npq[key]], 1);
    }
    // (2) ps's required anti-affinity against q
    for (int t = 0; t < a.ian.T; ++t) {
      const int key = a.ian.key[(size_t)ps * a.ian.T + t];
      if (key >= 0 && npq[key] > 0 && ns_ok(a, a.ian, ps, t, nsq) &&
          clauses_match(a, a.ian, ps, t, q))
        atomicAdd(&w.anti[(size_t)t * NP1 + npq[key]], 1);
    }
    // (3) ps's required affinity against q
    for (int t = 0; t < a.ia.T; ++t) {
      const int key = a.ia.key[(size_t)ps * a.ia.T + t];
      if (key >= 0 && npq[key] > 0 && ns_ok(a, a.ia, ps, t, nsq) &&
          clauses_match(a, a.ia, ps, t, q)) {
        atomicAdd(&w.affc[(size_t)t * NP1 + npq[key]], 1);
        atomicAdd(&w.scal[0], 1);
      }
    }
  }
  if (nd.s_ipa) {
    I* wsum = (I*)w.wsum;
    // ps's preferred terms against q (±weight), then q's preferred terms
    // (±weight) and required affinity (hardPodAffinityWeight) against ps
    const Terms* doms[3] = {&a.ipa, &a.ipan, &a.ia};
    for (int k = 0; k < 2; ++k) {
      const Terms& d = *doms[k];
      const int sign = k == 0 ? 1 : -1;
      for (int t = 0; t < d.T; ++t) {
        const size_t r = (size_t)ps * d.T + t;
        const int key = d.key[r];
        if (key >= 0 && npq[key] > 0 && ns_ok(a, d, ps, t, nsq) && clauses_match(a, d, ps, t, q))
          atomic_add(&wsum[npq[key]], (I)wmul<int>(sign, d.weight[r]));
      }
    }
    for (int k = 0; k < (c.hard_w > 0 ? 3 : 2); ++k) {
      const Terms& d = *doms[k];
      const int sign = k == 0 ? 1 : -1;
      for (int t = 0; t < d.T; ++t) {
        const size_t r = (size_t)q * d.T + t;
        const int key = d.key[r];
        if (key >= 0 && npq[key] > 0 && ns_ok(a, d, q, t, nsp) && clauses_match(a, d, q, t, ps))
          atomic_add(&wsum[npq[key]], k == 2 ? (I)c.hard_w : (I)wmul<int>(sign, d.weight[r]));
      }
    }
  }
}

// Node n's NodeAffinity result, and its counts summed into its topology
// pairs: for the spread filter over eligible nodes (affinity, every key,
// real node), for the spread score over the nodes its counting mask keeps.
template <typename I>
__device__ void rel_node(const Planes& a, const Need& nd, const Ws& w, int ps, int n) {
  const bool aff = node_affinity_ok<I>(a, ps, n);
  w.aff_ok[n] = aff;
  if (!aff || !a.node_mask[n]) return;
  const int* npn = a.node_pair + (size_t)n * a.K;
  const int N = a.N, NP1 = a.NP1;
  if (nd.f_spread && has_all_keys(a, a.sph, ps, n)) {
    for (int t = 0; t < a.sph.T; ++t) {
      const int key = a.sph.key[(size_t)ps * a.sph.T + t];
      if (key < 0) continue;
      const size_t i = (size_t)t * NP1 + npn[key];
      const int cnt = w.cnt_h[(size_t)t * N + n];
      if (cnt) atomicAdd(&w.val_h[i], cnt);
      atomicAdd(&w.pres_h[i], 1);
    }
  }
  if (nd.s_spread && (!a.req_all[ps] || has_all_keys(a, a.sps, ps, n))) {
    for (int t = 0; t < a.sps.T; ++t) {
      const int key = a.sps.key[(size_t)ps * a.sps.T + t];
      if (key < 0 || npn[key] == 0) continue;
      const int cnt = w.cnt_s[(size_t)t * N + n];
      if (cnt) atomicAdd(&w.val_s[(size_t)t * NP1 + npn[key]], cnt);
    }
  }
}

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

// PodTopologySpread filter: the first failing hard constraint in order
// wins; 1 = the node lacks its topology key, 2 = maxSkew exceeded.
__device__ int spread_filter(const Planes& a, const Ws& w, int ps, int n) {
  const Terms& d = a.sph;
  const int* npn = a.node_pair + (size_t)n * a.K;
  for (int t = 0; t < d.T; ++t) {
    const size_t r = (size_t)ps * d.T + t;
    const int key = d.key[r];
    if (key < 0) continue;
    const int pr = npn[key];
    if (pr == 0) return 1;
    const int min_c = w.min_h[t] == INT_MAX ? 0 : w.min_h[t];  // 0: no pair present
    const int skew = wsub<int>(wadd<int>(w.val_h[(size_t)t * a.NP1 + pr], d.flag[r] ? 1 : 0), min_c);
    if (skew > d.skew[r]) return 2;
  }
  return 0;
}

// InterPodAffinity filter: 1 = an existing pod's anti-affinity, 2 = the
// pod's anti-affinity, 3 = the pod's affinity (in that precedence).
__device__ int interpod_filter(const Planes& a, const Ws& w, int ps, int n) {
  const int* npn = a.node_pair + (size_t)n * a.K;
  for (int k = 0; k < a.K; ++k)
    if (npn[k] > 0 && w.ea[npn[k]] > 0) return 1;
  for (int t = 0; t < a.ian.T; ++t) {
    const int key = a.ian.key[(size_t)ps * a.ian.T + t];
    if (key >= 0 && npn[key] > 0 && w.anti[(size_t)t * a.NP1 + npn[key]] > 0) return 2;
  }
  bool has_terms = false, satisfied = true, keys_all = true, self_all = true;
  for (int t = 0; t < a.ia.T; ++t) {
    const size_t r = (size_t)ps * a.ia.T + t;
    const int key = a.ia.key[r];
    if (key < 0) continue;
    has_terms = true;
    const int pr = npn[key];
    if (pr == 0) keys_all = false;
    if (pr == 0 || w.affc[(size_t)t * a.NP1 + pr] == 0) satisfied = false;
    if (!a.ia.flag[r]) self_all = false;
  }
  if (!has_terms || satisfied) return 0;
  // the first pod of a series: nothing matches anywhere and the pod matches
  // its own terms, on a node that carries every term's key
  if (keys_all && w.scal[0] == 0 && self_all) return 0;
  return 3;
}

// The volume-table filters (VolumeBinding, VolumeZone): the host's verdict
// for the pod's claims on node n, 0 for a pod without claims.
__device__ __forceinline__ int vol_table(const Planes& a, const int* table, int ps, int n) {
  const int row = a.vb_row[ps];
  return row >= 0 ? table[(size_t)n * a.VB + row] : 0;
}

// VolumeRestrictions: a RWOP claim of the pod in use anywhere fails every
// node (w.vol[0], from the step's volume phase); else a disk of the pod
// that node n mounts, unless both mounts are read-only.
__device__ int vol_restrictions(const Planes& a, const State& s, const Ws& w, int ps, int n) {
  if (w.vol[0]) return VR_RWOP;
  for (int i = 0; i < w.vol[1]; ++i) {
    const int d = w.pdl[i];
    const size_t nd = (size_t)n * a.D + d;
    if (s.node_disk_rw[nd] > 0 || (a.pod_disk_rw[(size_t)ps * a.D + d] > 0 &&
                                   s.node_disk_any[nd] > 0))
      return VR_DISK;
  }
  return 0;
}

// A volume-count limit: the pod's volumes of type j on top of node n's.
__device__ __forceinline__ int vol_limit(const Cfg& c, const Planes& a, const int* have, int ps,
                                         int j) {
  const int want = a.pod_vol3[(size_t)ps * N_VOL3 + j];
  return (want > 0 && wadd<int>(have[j], want) > c.vol_limit[j]) ? 1 : 0;
}

template <typename I>
__device__ int filter_code(const Cfg& c, int fid, const Planes& a, const State& s, const Ws& w,
                           int ps, int n) {
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
    case F_AFFINITY:
      return w.aff_ok[n] ? 0 : 1;
    case F_PORTS: {
      const int* ww = a.want_wild + (size_t)ps * a.Q;
      const int* up = s.used_pair + (size_t)n * a.Q;
      for (int q = 0; q < a.Q; ++q)
        if (ww[q] > 0 && up[q] > 0) return 1;
      const int* wt = a.want_trip + (size_t)ps * a.V2;
      const int* ut = s.used_trip + (size_t)n * a.V2;
      const int* uw = s.used_wild + (size_t)n * a.Q;
      for (int v = 0; v < a.V2; ++v)
        if (wt[v] > 0 && (ut[v] > 0 || uw[a.trip_pair[v]] > 0)) return 1;
      return 0;
    }
    case F_SPREAD:
      return spread_filter(a, w, ps, n);
    case F_INTERPOD:
      return interpod_filter(a, w, ps, n);
    case F_VOLRESTR:
      return vol_restrictions(a, s, w, ps, n);
    case F_EBS:
    case F_GCEPD:
    case F_AZURE:
      return vol_limit(c, a, s.node_vol3 + (size_t)n * N_VOL3, ps, fid - F_EBS);
    case F_VOLBIND:
      return vol_table(a, a.vb_code, ps, n);
    case F_VOLZONE:
      return vol_table(a, a.vz_code, ps, n);
  }
  return 0;  // F_NODEVOL: a pass-through
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

// NodeAffinity score: the weights of the preferred terms the node matches.
template <typename I>
__device__ I node_affinity_score(const Planes& a, int ps, int n) {
  long long sum = 0;
  for (int t = 0; t < a.paff.TM; ++t)
    if (term_match<I>(a, a.paff, ps, t, n)) sum += a.paff.weight[(size_t)ps * a.paff.TM + t];
  return (I)sum;
}

// ImageLocality: the clipped sum of the node's share of the pod's images
// (Ki), scaled to 0..100 as 100*x//den in two base-10 digits. Products in
// I, sums in 64 bits (the reference's jnp.sum), cast to I at the end.
template <typename I>
__device__ I image_score(const Planes& a, int ps, int n) {
  const I* contrib = (const I*)a.img_contrib + (size_t)n * a.I;
  const int* want = a.pod_img + (size_t)ps * a.I;
  long long ss = 0;
  for (int i = 0; i < a.I; ++i) ss += (long long)wmul<I>(contrib[i], (I)want[i]);
  const I ncont = (I)a.pod_ncont[ps];
  if (ncont == 0) return 0;  // zero-container pods score 0
  const I maxth = wmul<I>((I)IMG_MAX_CONTAINER_KI, ncont);
  const long long hi = imax<I>(maxth, (I)(IMG_MIN_KI + 1));
  ss = ss < IMG_MIN_KI ? IMG_MIN_KI : ss;
  ss = ss > hi ? hi : ss;
  const long long x = ss - IMG_MIN_KI;
  const long long den = imax<I>(wsub<I>(maxth, (I)IMG_MIN_KI), 1);
  const long long a1 = fdiv<long long>(x, den), r = fmod_<long long>(x, den);
  const long long d1 = fdiv<long long>(r * 10, den), r2 = fmod_<long long>(r * 10, den);
  const long long d2 = fdiv<long long>(r2 * 10, den);
  return (I)(a1 * 100 + d1 * 10 + d2);
}

// PodTopologySpread score: Σ count × log-weight in SPREAD_SCALE fixed point,
// plus Σ (maxSkew − 1), banker's-rounded. Counts and weights in int32, the
// sums in 64 bits (as the reference); ignored nodes score 0.
template <typename I>
__device__ I spread_score(const Cfg& c, const Planes& a, const Ws& w, int ps, int n) {
  if (!c.spread_on || w.ign[n]) return 0;
  const Terms& d = a.sps;
  const int* npn = a.node_pair + (size_t)n * a.K;
  long long totq = 0, mssum = 0;
  for (int t = 0; t < d.T; ++t) {
    const size_t r = (size_t)ps * d.T + t;
    const int key = d.key[r];
    if (key < 0 || npn[key] == 0) continue;
    const int pr = npn[key];
    const bool host = d.flag[r] != 0;
    // a hostname constraint counts the node's own pods; any other needs
    // the node's pair to hold a scored node
    if (!host && w.pres_s[(size_t)t * a.NP1 + pr] <= 0) continue;
    const int cnt = host ? w.cnt_s[(size_t)t * a.N + n] : w.val_s[(size_t)t * a.NP1 + pr];
    int wm = host ? w.scal[1] : w.topo_s[t];
    wm = wm < 0 ? 0 : (wm > a.LUT - 1 ? a.LUT - 1 : wm);
    totq += wmul<int>(cnt, a.spread_lut[wm]);
    mssum += wsub<int>(d.skew[r], 1);
  }
  const long long q = fdiv<long long>(totq, SPREAD_SCALE);
  const long long rr = fmod_<long long>(totq, SPREAD_SCALE);
  const bool up = 2 * rr > SPREAD_SCALE || (2 * rr == SPREAD_SCALE && fmod_<long long>(q, 2) == 1);
  return (I)(mssum + q + (up ? 1 : 0));
}

// InterPodAffinity score: the pair weights of every topology pair the node
// carries.
template <typename I>
__device__ I interpod_score(const Cfg& c, const Planes& a, const Ws& w, int n) {
  if (!c.interpod_on) return 0;
  const I* wsum = (const I*)w.wsum;
  const int* npn = a.node_pair + (size_t)n * a.K;
  I v = 0;
  for (int k = 0; k < a.K; ++k)
    if (npn[k] > 0) v = wadd<I>(v, wsum[npn[k]]);
  return v;
}

template <typename I>
__device__ I score_raw(const Cfg& c, int j, const Planes& a, const State& s, const Ws& w, int ps,
                       int n) {
  switch (c.score[j]) {
    case S_FIT:
      return fit_score<I>(c, a, s, ps, n);
    case S_BALANCED:
      return balanced_score<I>(c, a, s, ps, n);
    case S_TAINT:
      return taint_score<I>(a, ps, n);
    case S_AFFINITY:
      return node_affinity_score<I>(a, ps, n);
    case S_IMAGE:
      return image_score<I>(a, ps, n);
    case S_SPREAD:
      return spread_score<I>(c, a, w, ps, n);
    case S_INTERPOD:
      return interpod_score<I>(c, a, w, n);
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

template <typename I> __device__ I block_min(I v, Smem<I>& sm) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = imin<I>(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) sm.red_v[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < nw ? sm.red_v[lane] : Lim<I>::hi;
    for (int o = 16; o > 0; o >>= 1) v = imin<I>(v, __shfl_down_sync(0xffffffffu, v, o));
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

// Block-wide reductions a step's normalizes need, per score plugin: the
// max of where(feasible, raw, 0) for the default modes; for the custom
// ones the max and min of where(live, raw, ∓BIG) (live: feasible, and for
// PodTopologySpread not ignored) — over every node, padded ones included,
// as the reference reduces.
template <typename I> struct Norms {
  I mx[MAX_S], mn[MAX_S];
  bool any_live;  // a live node for the spread normalize
};

// Node n's raw scores (written to raw[n, :]) and their share of the
// reductions.
template <typename I>
__device__ __forceinline__ void score_node(const Cfg& c, const Planes& a, const State& s,
                                           const Ws& ws, int ps, int n, bool ok, I* raw,
                                           Norms<I>& nm) {
  const int S = c.n_scores;
  for (int j = 0; j < S; ++j) {
    const I r = score_raw<I>(c, j, a, s, ws, ps, n);
    raw[(size_t)n * S + j] = r;
    if (c.mode[j] == NORM_DEFAULT || c.mode[j] == NORM_REVERSE) {
      nm.mx[j] = imax<I>(nm.mx[j], ok ? r : (I)0);
    } else if (c.mode[j] == NORM_CUSTOM) {
      const bool live = ok && !(c.score[j] == S_SPREAD && c.spread_on && ws.ign[n]);
      nm.mx[j] = imax<I>(nm.mx[j], live ? r : (I)-BIG);
      nm.mn[j] = imin<I>(nm.mn[j], live ? r : (I)BIG);
      if (c.score[j] == S_SPREAD) nm.any_live = nm.any_live || live;
    }
  }
}

// The custom normalizes (engine/kernels.py build_spread_score/
// build_interpod_score `normalize`), on the reductions of every node.
// Integer // floors and the arithmetic wraps in I, as the reference's does
// when no node is feasible and the sentinels meet.
template <typename I>
__device__ I norm_custom(const Cfg& c, int j, const Ws& ws, int n, I r, I maxv, I minv,
                         bool spread_active) {
  if (c.score[j] == S_SPREAD) {
    if (!c.spread_on || !spread_active || ws.ign[n]) return 0;
    if (maxv == 0) return (I)MAX_NODE_SCORE;
    return fdiv<I>(wmul<I>((I)MAX_NODE_SCORE, wsub<I>(wadd<I>(maxv, minv), r)), imax<I>(maxv, 1));
  }
  if (c.score[j] == S_INTERPOD && c.interpod_on) {
    const I diff = wsub<I>(maxv, minv);
    return diff > 0 ? fdiv<I>(wmul<I>((I)MAX_NODE_SCORE, wsub<I>(r, minv)), imax<I>(diff, 1))
                    : (I)0;
  }
  return 0;
}

// The step's prologue for pod ps at state s: the relational counts over
// every bound pod and node, and the pod's volume lists. What it leaves in
// the workspace is what the filters, the scores and the dry run read.
template <typename I>
__device__ void prologue(const Cfg& c, const Need& nd, const Planes& a, const State& s, int ps,
                         const Ws& ws) {
  const int N = a.N, NP1 = a.NP1;
  if (nd.vr) {
    // a RWOP claim of the pod in use anywhere, the pod's disks and (for
    // the dry run) its RWOP claims; list order is free, readers only ask
    // whether any entry conflicts
    if (threadIdx.x == 0) ws.vol[0] = ws.vol[1] = ws.vol[2] = 0;
    __syncthreads();
    for (int k = threadIdx.x; k < a.CL; k += blockDim.x) {
      if (!a.pod_claim[(size_t)ps * a.CL + k]) continue;
      if (s.used_claims[k] > 0) ws.vol[0] = 1;
      if (c.preempt) ws.pcl[atomicAdd(&ws.vol[2], 1)] = k;
    }
    for (int d = threadIdx.x; d < a.D; d += blockDim.x)
      if (a.pod_disk_any[(size_t)ps * a.D + d] > 0) ws.pdl[atomicAdd(&ws.vol[1], 1)] = d;
    __syncthreads();
  }
  if (nd.rel) {
    // clear the counters, then every bound pod's matches
    int* words = (int*)ws.wsum;
    for (int i = threadIdx.x; i < ws.n_words; i += blockDim.x)
      words[i] = (i >= ws.min_lo && i < ws.min_hi) ? INT_MAX : 0;
    __syncthreads();
    for (int q = threadIdx.x; q < a.P; q += blockDim.x) rel_pod<I>(c, a, s, nd, ws, ps, q);
    __syncthreads();
  }
  if (nd.aff) {
    // NodeAffinity per node, and node counts into topology pairs
    for (int n = threadIdx.x; n < N; n += blockDim.x) rel_node<I>(a, nd, ws, ps, n);
    __syncthreads();
    if (nd.f_spread) {
      for (int i = threadIdx.x; i < a.sph.T * NP1; i += blockDim.x)
        if (i % NP1 > 0 && ws.pres_h[i] > 0) atomicMin(&ws.min_h[i / NP1], ws.val_h[i]);
      __syncthreads();
    }
  }
}

// The VolumeBinding prefilter's code for pod ps (0: passes, or disabled).
__device__ __forceinline__ int prefilter_code(const Cfg& c, const Planes& a, int ps) {
  return c.pf_vb ? a.vb_pf[ps] : 0;
}

// One PreFilter→Filter→Score→Normalize→select pass for pod ps. Writes
// codes[N,F], raw[N,S], (when fin is not null) final[N,S] and (when tot is
// not null) the masked totals tot[N]: the weighted sum where the node is
// feasible, NEG (the type's minimum // 2) where not — the gang engine's
// score row. Returns sel to every thread. feas[N] and the workspace ws are
// scratch.
template <typename I>
__device__ int attempt_body(const Cfg& c, const Need& nd, const Planes& a, const State& s,
                            const I* w, int ps, int* codes, I* raw, I* fin, unsigned char* feas,
                            const Ws& ws, Smem<I>& sm, I* tot = nullptr) {
  const int N = a.N, F = c.n_filters, S = c.n_scores, NP1 = a.NP1;
  prologue<I>(c, nd, a, s, ps, ws);
  const bool pf_ok = prefilter_code(c, a, ps) == 0;
  Norms<I> nm;
  for (int j = 0; j < S; ++j) {
    nm.mx[j] = Lim<I>::lo;
    nm.mn[j] = Lim<I>::hi;
  }
  nm.any_live = false;
  // the node sweep: filter codes and feasibility (and the raw scores, when
  // no score needs a count over the feasible nodes first)
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    bool ok = a.node_mask[n] != 0 && pf_ok;
    for (int f = 0; f < F; ++f) {
      const int code = filter_code<I>(c, c.filter[f], a, s, ws, ps, n);
      codes[(size_t)n * F + f] = code;
      ok = ok && code == 0;
    }
    feas[n] = ok;
    if (!nd.s_spread) score_node<I>(c, a, s, ws, ps, n, ok, raw, nm);
  }
  if (nd.s_spread) {
    // the spread score's prologue: scored nodes (feasible, not ignored),
    // their count, and the topology size of each soft constraint
    const Terms& d = a.sps;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const bool ok = feas[n] != 0;
      const bool ign = ok && a.req_all[ps] && !has_all_keys(a, d, ps, n);
      ws.ign[n] = ign;
      if (!ok || ign) continue;
      atomicAdd(&ws.scal[1], 1);
      const int* npn = a.node_pair + (size_t)n * a.K;
      for (int t = 0; t < d.T; ++t) {
        const int key = d.key[(size_t)ps * d.T + t];
        if (key >= 0 && npn[key] > 0) atomicAdd(&ws.pres_s[(size_t)t * NP1 + npn[key]], 1);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < d.T * NP1; i += blockDim.x)
      if (i % NP1 > 0 && ws.pres_s[i] > 0) atomicAdd(&ws.topo_s[i / NP1], 1);
    __syncthreads();
    for (int n = threadIdx.x; n < N; n += blockDim.x)
      score_node<I>(c, a, s, ws, ps, n, feas[n] != 0, raw, nm);
  }
  bool spread_active = false;
  for (int j = 0; j < S; ++j) {
    if (c.mode[j] == NORM_NONE) continue;
    nm.mx[j] = block_max<I>(nm.mx[j], sm);
    if (c.mode[j] == NORM_CUSTOM) nm.mn[j] = block_min<I>(nm.mn[j], sm);
    if (c.mode[j] == NORM_CUSTOM && c.score[j] == S_SPREAD && c.spread_on) {
      // active: the pod has a soft constraint and some node is live
      bool any_key = false;
      for (int t = 0; t < a.sps.T; ++t) any_key |= a.sps.key[(size_t)ps * a.sps.T + t] >= 0;
      spread_active = (__syncthreads_or(nm.any_live) != 0) && any_key;
    }
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
      const I m = nm.mx[j];
      if (c.mode[j] == NORM_CUSTOM) {
        normed = norm_custom<I>(c, j, ws, n, r, m, nm.mn[j], spread_active);
      } else if (c.mode[j] != NORM_NONE) {
        const I scaled = fdiv<I>(wmul<I>(r, MAX_NODE_SCORE), imax<I>(m, 1));
        if (c.mode[j] == NORM_REVERSE)
          normed = m == 0 ? (I)MAX_NODE_SCORE : wsub<I>(MAX_NODE_SCORE, scaled);
        else
          normed = m == 0 ? r : scaled;
      }
      // PACKED's bf16 score lane (the reference's engine.py:438-453) is a
      // round trip of `normed` through bfloat16 where 0 <= normed <= 256
      // and the mode is not custom: integers there are exact in bfloat16,
      // so it changes nothing and the kernel leaves it out (the plain
      // attempt keeps it, and tests pin it as the identity).
      const I fv = wmul<I>(normed, w[j]);
      if (fin) fin[(size_t)n * S + j] = fv;
      total = wadd<I>(total, fv);
    }
    any = any || ok;
    if (tot) tot[n] = ok ? total : NEG;
    arg_better<I>(best, best_i, ok ? total : NEG, n);
  }
  const bool any_feasible = __syncthreads_or(any) != 0;
  const int idx = block_argmax<I>(best, best_i, sm);
  return any_feasible ? idx : -1;
}

// Scatter pod p onto node sel (engine.py bind). p < 0 (a queue-bucket
// padding step) is an exact no-op; sel < 0 only records the pod as
// unschedulable.
// Thread threadIdx.x's index in a block-wide loop handed to warp `w` and
// on: the bind's independent counter families start on different warps so
// their dependent loads overlap (a permutation of the block's threads).
__device__ __forceinline__ int from_warp(int w) {
  return (threadIdx.x + 32 * w) % blockDim.x;
}

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
    // the host-port counters (NodePorts)
    for (int q = from_warp(1); q < a.Q; q += blockDim.x) {
      const size_t i = (size_t)sel * a.Q + q, k = (size_t)p * a.Q + q;
      s.used_pair[i] = wadd<int>(s.used_pair[i], a.want_pair[k]);
      s.used_wild[i] = wadd<int>(s.used_wild[i], a.want_wild[k]);
    }
    for (int v = from_warp(2); v < a.V2; v += blockDim.x) {
      const size_t i = (size_t)sel * a.V2 + v;
      s.used_trip[i] = wadd<int>(s.used_trip[i], a.want_trip[(size_t)p * a.V2 + v]);
    }
    // the volume counters: RWOP claims (global), disks and volume counts;
    // a pod's zero entries leave them as they are, so only the pod's rows
    // are read for a pod without volumes
    for (int k = from_warp(3); k < a.CL; k += blockDim.x)
      if (a.pod_claim[(size_t)p * a.CL + k]) s.used_claims[k] = wadd<int>(s.used_claims[k], 1);
    for (int d = from_warp(4); d < a.D; d += blockDim.x) {
      const size_t i = (size_t)sel * a.D + d, k = (size_t)p * a.D + d;
      const int x = a.pod_disk_any[k], y = a.pod_disk_rw[k];
      if (x) s.node_disk_any[i] = wadd<int>(s.node_disk_any[i], x);
      if (y) s.node_disk_rw[i] = wadd<int>(s.node_disk_rw[i], y);
    }
    for (int j = from_warp(5); j < N_VOL3; j += blockDim.x) {
      const size_t i = (size_t)sel * N_VOL3 + j;
      const int x = a.pod_vol3[(size_t)p * N_VOL3 + j];
      if (x) s.node_vol3[i] = wadd<int>(s.node_vol3[i], x);
    }
  }
  if (threadIdx.x == 0) {
    if (sel >= 0) s.n_pods[sel] = wadd<int>(s.n_pods[sel], 1);
    s.assignment[p] = sel;
    s.bound_seq[p] = sel >= 0 ? wadd<int>(a.P, qi) : -1;
  }
}

// ---------------------------------------------------------------------------
// eviction (K2 evict_all) and the DefaultPreemption dry run (K7)
// ---------------------------------------------------------------------------

// Remove bound pod v from node n (engine.py evict_all for one pod): its
// rows leave every per-node counter, its claims leave used_claims, and its
// assignment and bind order become -1. Integer atomics, so several threads
// may evict pods of one node at once.
template <typename I>
__device__ void evict_pod(const Planes& a, const State& s, int v, int n) {
  const int R = a.R;
  for (int r = 0; r < R; ++r) {
    atomic_add((I*)s.requested + (size_t)n * R + r,
               wsub<I>(0, ((const I*)a.pod_req)[(size_t)v * R + r]));
    atomic_add((I*)s.s_requested + (size_t)n * R + r,
               wsub<I>(0, ((const I*)a.pod_sreq)[(size_t)v * R + r]));
  }
  atomicAdd(&s.n_pods[n], -1);
  for (int q = 0; q < a.Q; ++q) {
    const size_t k = (size_t)v * a.Q + q;
    if (a.want_pair[k]) atomicAdd(&s.used_pair[(size_t)n * a.Q + q], -a.want_pair[k]);
    if (a.want_wild[k]) atomicAdd(&s.used_wild[(size_t)n * a.Q + q], -a.want_wild[k]);
  }
  for (int t = 0; t < a.V2; ++t) {
    const int x = a.want_trip[(size_t)v * a.V2 + t];
    if (x) atomicAdd(&s.used_trip[(size_t)n * a.V2 + t], -x);
  }
  for (int k = 0; k < a.CL; ++k)
    if (a.pod_claim[(size_t)v * a.CL + k]) atomicAdd(&s.used_claims[k], -1);
  for (int d = 0; d < a.D; ++d) {
    const int x = a.pod_disk_any[(size_t)v * a.D + d], y = a.pod_disk_rw[(size_t)v * a.D + d];
    if (x) atomicAdd(&s.node_disk_any[(size_t)n * a.D + d], -x);
    if (y) atomicAdd(&s.node_disk_rw[(size_t)n * a.D + d], -y);
  }
  for (int j = 0; j < N_VOL3; ++j) {
    const int x = a.pod_vol3[(size_t)v * N_VOL3 + j];
    if (x) atomicAdd(&s.node_vol3[(size_t)n * N_VOL3 + j], -x);
  }
  s.assignment[v] = -1;
  s.bound_seq[v] = -1;
}

// The reprieve order: priority descending (its int32 negation ascending,
// wrapping as the reference's), then bind order ascending, then pod index
// (the reference's stable sort). bound_seq is unique among the pods a pass
// binds; the index decides only for states built by hand.
__device__ __forceinline__ bool reprieve_before(const Planes& a, const State& s, int u, int v) {
  const int ku = (int)(0u - (unsigned)a.pod_priority[u]);
  const int kv = (int)(0u - (unsigned)a.pod_priority[v]);
  if (ku != kv) return ku < kv;
  if (s.bound_seq[u] != s.bound_seq[v]) return s.bound_seq[u] < s.bound_seq[v];
  return u < v;
}

// Node n is eligible for the spread counts of pod ps (the reference's
// _SpreadRow `elig`).
template <typename I>
__device__ __forceinline__ bool spread_elig(const Planes& a, const Ws& ws, int ps, int n) {
  return ws.aff_ok[n] && a.node_mask[n] && has_all_keys(a, a.sph, ps, n);
}

// Every row filter's counters of node n, with pod v's contribution added
// (sign +1) or taken away (sign -1): the reference's node_init (each victim
// taken away) and add_back, and the undo of a failed add_back.
template <typename I>
__device__ void row_apply(int sign, const Need& nd, const Planes& a, const Ws& ws, int ps, int n,
                          bool elig, int v) {
  const Pws& pw = ws.pw;
  if (nd.fit) {
    I* req = (I*)pw.req + (size_t)n * a.R;
    const I* pr = (const I*)a.pod_req + (size_t)v * a.R;
    for (int r = 0; r < a.R; ++r) req[r] = sign > 0 ? wadd<I>(req[r], pr[r]) : wsub<I>(req[r], pr[r]);
    pw.npods[n] = wadd<int>(pw.npods[n], sign);
  }
  if (nd.ports) {
    for (int q = 0; q < a.Q; ++q) {
      const size_t i = (size_t)n * a.Q + q, k = (size_t)v * a.Q + q;
      pw.upair[i] = wadd<int>(pw.upair[i], sign * a.want_pair[k]);
      pw.uwild[i] = wadd<int>(pw.uwild[i], sign * a.want_wild[k]);
    }
    for (int t = 0; t < a.V2; ++t) {
      const size_t i = (size_t)n * a.V2 + t;
      pw.utrip[i] = wadd<int>(pw.utrip[i], sign * a.want_trip[(size_t)v * a.V2 + t]);
    }
  }
  if (nd.f_spread && elig && a.ns_id[v] == a.ns_id[ps] && !a.deleted[v] && a.pod_mask[v]) {
    for (int t = 0; t < a.sph.T; ++t)
      if (a.sph.key[(size_t)ps * a.sph.T + t] >= 0 && clauses_match(a, a.sph, ps, t, v))
        pw.sp_cur[(size_t)n * a.sph.T + t] += sign;
  }
  if (nd.f_ipa) {
    const int* npn = a.node_pair + (size_t)n * a.K;
    const int nsp = a.ns_id[ps], nsv = a.ns_id[v];
    // (1) v's required anti-affinity against ps, at v's pairs on node n
    for (int t = 0; t < a.ian.T; ++t) {
      const int key = a.ian.key[(size_t)v * a.ian.T + t];
      if (key >= 0 && npn[key] > 0 && ns_ok(a, a.ian, v, t, nsp) &&
          clauses_match(a, a.ian, v, t, ps))
        pw.ea_cur[(size_t)n * a.K + key] += sign;
    }
    if (a.pod_mask[v]) {
      // (2) ps's required anti-affinity and (3) affinity against v
      for (int t = 0; t < a.ian.T; ++t) {
        const int key = a.ian.key[(size_t)ps * a.ian.T + t];
        if (key >= 0 && npn[key] > 0 && ns_ok(a, a.ian, ps, t, nsv) &&
            clauses_match(a, a.ian, ps, t, v))
          pw.f2_cur[(size_t)n * a.ian.T + t] += sign;
      }
      for (int t = 0; t < a.ia.T; ++t) {
        const int key = a.ia.key[(size_t)ps * a.ia.T + t];
        if (key >= 0 && npn[key] > 0 && ns_ok(a, a.ia, ps, t, nsv) &&
            clauses_match(a, a.ia, ps, t, v)) {
          pw.f3_cur[(size_t)n * a.ia.T + t] += sign;
          pw.total3[n] += sign;
        }
      }
    }
  }
  if (nd.vr) {
    for (int i = 0; i < ws.vol[2]; ++i)
      if (a.pod_claim[(size_t)v * a.CL + ws.pcl[i]]) pw.cl_cur[(size_t)n * a.CL + i] += sign;
    for (int i = 0; i < ws.vol[1]; ++i) {
      const size_t k = (size_t)v * a.D + ws.pdl[i], j = (size_t)n * a.D + i;
      pw.dk_any[j] = wadd<int>(pw.dk_any[j], sign * a.pod_disk_any[k]);
      pw.dk_rw[j] = wadd<int>(pw.dk_rw[j], sign * a.pod_disk_rw[k]);
    }
  }
  for (int j = 0; j < N_VOL3; ++j)
    if (nd.lim[j])
      pw.vol3[(size_t)n * N_VOL3 + j] =
          wadd<int>(pw.vol3[(size_t)n * N_VOL3 + j], sign * a.pod_vol3[(size_t)v * N_VOL3 + j]);
}

// Node n's row counters from the state, before any victim is taken away.
template <typename I>
__device__ void row_init(const Need& nd, const Planes& a, const State& s, const Ws& ws, int ps,
                         int n) {
  const Pws& pw = ws.pw;
  const int NP1 = a.NP1;
  if (nd.fit) {
    for (int r = 0; r < a.R; ++r)
      ((I*)pw.req)[(size_t)n * a.R + r] = ((const I*)s.requested)[(size_t)n * a.R + r];
    pw.npods[n] = s.n_pods[n];
  }
  if (nd.ports) {
    for (int q = 0; q < a.Q; ++q) {
      pw.upair[(size_t)n * a.Q + q] = s.used_pair[(size_t)n * a.Q + q];
      pw.uwild[(size_t)n * a.Q + q] = s.used_wild[(size_t)n * a.Q + q];
    }
    for (int t = 0; t < a.V2; ++t) pw.utrip[(size_t)n * a.V2 + t] = s.used_trip[(size_t)n * a.V2 + t];
  }
  const int* npn = a.node_pair + (size_t)n * a.K;
  if (nd.f_spread)
    for (int t = 0; t < a.sph.T; ++t) {
      const int key = a.sph.key[(size_t)ps * a.sph.T + t];
      const int pr = key >= 0 ? npn[key] : 0;
      pw.sp_cur[(size_t)n * a.sph.T + t] = pr > 0 ? ws.val_h[(size_t)t * NP1 + pr] : 0;
    }
  if (nd.f_ipa) {
    for (int k = 0; k < a.K; ++k) pw.ea_cur[(size_t)n * a.K + k] = npn[k] > 0 ? ws.ea[npn[k]] : 0;
    for (int t = 0; t < a.ian.T; ++t) {
      const int key = a.ian.key[(size_t)ps * a.ian.T + t];
      const int pr = key >= 0 ? npn[key] : 0;
      pw.f2_cur[(size_t)n * a.ian.T + t] = pr > 0 ? ws.anti[(size_t)t * NP1 + pr] : 0;
    }
    for (int t = 0; t < a.ia.T; ++t) {
      const int key = a.ia.key[(size_t)ps * a.ia.T + t];
      const int pr = key >= 0 ? npn[key] : 0;
      pw.f3_cur[(size_t)n * a.ia.T + t] = pr > 0 ? ws.affc[(size_t)t * NP1 + pr] : 0;
    }
    pw.total3[n] = ws.scal[0];
  }
  if (nd.vr) {
    for (int i = 0; i < ws.vol[2]; ++i) pw.cl_cur[(size_t)n * a.CL + i] = s.used_claims[ws.pcl[i]];
    for (int i = 0; i < ws.vol[1]; ++i) {
      pw.dk_any[(size_t)n * a.D + i] = s.node_disk_any[(size_t)n * a.D + ws.pdl[i]];
      pw.dk_rw[(size_t)n * a.D + i] = s.node_disk_rw[(size_t)n * a.D + ws.pdl[i]];
    }
  }
  for (int j = 0; j < N_VOL3; ++j) pw.vol3[(size_t)n * N_VOL3 + j] = s.node_vol3[(size_t)n * N_VOL3 + j];
}

// Pod ps passes every row filter on node n from the node's counters alone
// (each row class's `check`).
template <typename I>
__device__ bool row_check(const Cfg& c, const Need& nd, const Planes& a, const Ws& ws, int ps,
                          int n) {
  const Pws& pw = ws.pw;
  if (nd.fit) {
    const I* alloc = (const I*)a.node_alloc + (size_t)n * a.R;
    const I* used = (const I*)pw.req + (size_t)n * a.R;
    const I* req = (const I*)a.pod_req + (size_t)ps * a.R;
    if ((I)wadd<int>(pw.npods[n], 1) > alloc[PODS_RES]) return false;
    for (int r = 0; r < a.R; ++r)
      if (req[r] > 0 && req[r] > wsub<I>(alloc[r], used[r])) return false;
  }
  if (nd.ports) {
    for (int q = 0; q < a.Q; ++q)
      if (a.want_wild[(size_t)ps * a.Q + q] > 0 && pw.upair[(size_t)n * a.Q + q] > 0) return false;
    for (int t = 0; t < a.V2; ++t)
      if (a.want_trip[(size_t)ps * a.V2 + t] > 0 &&
          (pw.utrip[(size_t)n * a.V2 + t] > 0 || pw.uwild[(size_t)n * a.Q + a.trip_pair[t]] > 0))
        return false;
  }
  const int* npn = a.node_pair + (size_t)n * a.K;
  if (nd.f_spread) {
    const Terms& d = a.sph;
    for (int t = 0; t < d.T; ++t) {
      const size_t r = (size_t)ps * d.T + t;
      const int key = d.key[r];
      if (key < 0) continue;
      const int pr = npn[key];
      if (pr == 0) return false;
      // the least count over present pairs, node n's own pair moved
      const int* mn = pw.sp_min + (size_t)t * 4;
      const int cur = pw.sp_cur[(size_t)n * d.T + t];
      int min_c = 0;
      if (mn[3]) {
        min_c = pr == mn[1] ? mn[2] : mn[0];
        if (ws.pres_h[(size_t)t * a.NP1 + pr] > 0 && cur < min_c) min_c = cur;
      }
      const int skew = wsub<int>(wadd<int>(cur, d.flag[r] ? 1 : 0), min_c);
      if (skew > d.skew[r]) return false;
    }
  }
  if (nd.f_ipa) {
    for (int k = 0; k < a.K; ++k)
      if (npn[k] > 0 && pw.ea_cur[(size_t)n * a.K + k] > 0) return false;
    for (int t = 0; t < a.ian.T; ++t) {
      const int key = a.ian.key[(size_t)ps * a.ian.T + t];
      if (key >= 0 && npn[key] > 0 && pw.f2_cur[(size_t)n * a.ian.T + t] > 0) return false;
    }
    bool has_terms = false, satisfied = true, keys_all = true, self_all = true;
    for (int t = 0; t < a.ia.T; ++t) {
      const size_t r = (size_t)ps * a.ia.T + t;
      const int key = a.ia.key[r];
      if (key < 0) continue;
      has_terms = true;
      const int pr = npn[key];
      if (pr == 0) keys_all = false;
      if (pr == 0 || pw.f3_cur[(size_t)n * a.ia.T + t] <= 0) satisfied = false;
      if (!a.ia.flag[r]) self_all = false;
    }
    if (has_terms && !satisfied && !(keys_all && pw.total3[n] == 0 && self_all)) return false;
  }
  if (nd.vr) {
    for (int i = 0; i < ws.vol[2]; ++i)
      if (pw.cl_cur[(size_t)n * a.CL + i] > 0) return false;
    for (int i = 0; i < ws.vol[1]; ++i) {
      const size_t j = (size_t)n * a.D + i;
      if (pw.dk_rw[j] > 0 ||
          (a.pod_disk_rw[(size_t)ps * a.D + ws.pdl[i]] > 0 && pw.dk_any[j] > 0))
        return false;
    }
  }
  for (int j = 0; j < N_VOL3; ++j)
    if (nd.lim[j] && vol_limit(c, a, pw.vol3 + (size_t)n * N_VOL3, ps, j)) return false;
  return true;
}

// The DefaultPreemption dry run for pod ps at state s (the reference's
// build_preemption `preempt`), one thread per candidate node. The step's
// prologue must have run for (ps, s): the dry run reads its relational
// counts and volume lists as the rows' base. Writes each node's code to
// pcode (SELECTED for the nominated node) and, when off is not null, the
// victims of every candidate node as a CSR record: off[N+1] absolute
// offsets into vidx, starting at status[0], which advances. Overflow sets
// a bit of ws.vol[3] and records nothing. Returns the nominated node (-1:
// none) to every thread.
template <typename I>
__device__ __noinline__ int dry_run(const Cfg& c, const Need& nd, const Planes& a, const State& s,
                       const Ws& ws, int ps, int* pcode, int* off, int* vidx, int victim_cap,
                       int* status, Smem<long long>& sml) {
  const Pws& pw = ws.pw;
  const int N = a.N, V = c.vbound;
  // the base minima of the spread counts over present pairs: smallest, its
  // pair, second smallest (excluding that pair), any pair present
  if (nd.f_spread)
    for (int t = threadIdx.x; t < a.sph.T; t += blockDim.x) {
      int m1 = INT_MAX, a1 = -1, m2 = INT_MAX;
      for (int x = 1; x < a.NP1; ++x) {
        if (ws.pres_h[(size_t)t * a.NP1 + x] <= 0) continue;
        const int v = ws.val_h[(size_t)t * a.NP1 + x];
        if (a1 < 0 || v < m1) {
          if (a1 >= 0) m2 = m1;
          m1 = v;
          a1 = x;
        } else if (v < m2) {
          m2 = v;
        }
      }
      int* mn = pw.sp_min + (size_t)t * 4;
      mn[0] = m1, mn[1] = a1, mn[2] = m2, mn[3] = a1 >= 0;
    }
  for (int n = threadIdx.x; n < N; n += blockDim.x) pw.vcount[n] = 0;
  __syncthreads();
  // every bound pod of lower priority, appended to its node's list
  const int prio_p = a.pod_priority[ps];
  for (int q = threadIdx.x; q < a.P; q += blockDim.x) {
    const int n = s.assignment[q];
    if (n < 0 || !a.pod_mask[q] || a.pod_priority[q] >= prio_p) continue;
    const int slot = atomicAdd(&pw.vcount[n], 1);
    if (slot < V)
      pw.vlist[(size_t)n * V + slot] = q;
    else
      atomicOr(&ws.vol[3], 2);
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int cnt = pw.vcount[n] < V ? pw.vcount[n] : V;
    int* list = pw.vlist + (size_t)n * V;
    unsigned char* flag = pw.vflag + (size_t)n * V;
    int code = P_NO_LOWER, nv = 0, maxp = -INT_MAX;
    long long sump = 0;
    if (pw.vcount[n] > 0) {
      // a node the stateless filters refuse cannot fit: no counters needed
      bool fits = a.node_mask[n] != 0;
      for (int f = 0; f < c.n_filters && fits; ++f)
        if (stateless(c.filter[f]) && filter_code<I>(c, c.filter[f], a, s, ws, ps, n) != 0)
          fits = false;
      const bool elig = nd.f_spread && spread_elig<I>(a, ws, ps, n);
      if (fits) {
        row_init<I>(nd, a, s, ws, ps, n);
        for (int k = 0; k < cnt; ++k) row_apply<I>(-1, nd, a, ws, ps, n, elig, list[k]);
        fits = row_check<I>(c, nd, a, ws, ps, n);
      }
      if (!fits) {
        code = P_NO_FIT;
      } else {
        for (int i = 1; i < cnt; ++i) {  // insertion sort into reprieve order
          const int v = list[i];
          int j = i - 1;
          while (j >= 0 && reprieve_before(a, s, v, list[j])) {
            list[j + 1] = list[j];
            --j;
          }
          list[j + 1] = v;
        }
        // reprieve: each victim back in turn, kept where the pod still fits
        for (int k = 0; k < cnt; ++k) {
          const int v = list[k];
          row_apply<I>(1, nd, a, ws, ps, n, elig, v);
          const bool ok = row_check<I>(c, nd, a, ws, ps, n);
          flag[k] = !ok;
          if (!ok) {
            row_apply<I>(-1, nd, a, ws, ps, n, elig, v);
            const int pv = a.pod_priority[v];
            nv += 1;
            maxp = pv > maxp ? pv : maxp;
            sump += pv;
          }
        }
        code = nv > 0 ? P_CANDIDATE : P_SILENT;
      }
    }
    pw.code[n] = code;
    pw.nrec[n] = code == P_CANDIDATE ? nv : 0;
    pw.alive[n] = code == P_CANDIDATE;
    pw.maxp[n] = maxp;
    pw.sump[n] = sump;
  }
  __syncthreads();
  // the ranking: min highest victim priority, min priority sum, fewest
  // victims, each against the int32 max as the reference's, then the
  // lowest index
  for (int key = 0; key < 3; ++key) {
    long long local = INT_MAX;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const long long k = key == 0 ? pw.maxp[n] : key == 1 ? pw.sump[n] : pw.nrec[n];
      if (pw.alive[n] && k < local) local = k;
    }
    const long long best = block_min<long long>(local, sml);
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const long long k = key == 0 ? pw.maxp[n] : key == 1 ? pw.sump[n] : pw.nrec[n];
      pw.alive[n] = pw.alive[n] && k == best;
    }
  }
  long long first = INT_MAX;
  for (int n = threadIdx.x; n < N; n += blockDim.x)
    if (pw.alive[n] && n < first) first = n;
  const long long nom_ll = block_min<long long>(first, sml);
  const int nom = nom_ll == INT_MAX ? -1 : (int)nom_ll;
  if (pcode)
    for (int n = threadIdx.x; n < N; n += blockDim.x) pcode[n] = n == nom ? P_SELECTED : pw.code[n];
  if (off) {
    if (threadIdx.x == 0) {
      long long at = status[0];
      off[0] = (int)at;
      for (int n = 0; n < N; ++n) {
        at += pw.nrec[n];
        off[n + 1] = (int)(at < INT_MAX ? at : INT_MAX);
      }
      if (at > victim_cap)
        ws.vol[3] |= 1;
      else
        status[0] = (int)at;
    }
    __syncthreads();
    if (!(ws.vol[3] & 1))
      for (int n = threadIdx.x; n < N; n += blockDim.x) {
        if (!pw.nrec[n]) continue;
        int at = off[n];
        const int cnt = pw.vcount[n] < V ? pw.vcount[n] : V;
        for (int k = 0; k < cnt; ++k)
          if (pw.vflag[(size_t)n * V + k]) vidx[at++] = pw.vlist[(size_t)n * V + k];
      }
  }
  __syncthreads();
  return nom;
}

// Evict the nominated node's victims of the last dry run (the reference's
// evict = vmask[nominated]).
template <typename I>
__device__ __noinline__ void evict_nominated(const Cfg& c, const Planes& a, const State& s, const Ws& ws,
                                int nom) {
  const Pws& pw = ws.pw;
  const int V = c.vbound;
  const int cnt = pw.vcount[nom] < V ? pw.vcount[nom] : V;
  for (int k = threadIdx.x; k < cnt; k += blockDim.x)
    if (pw.vflag[(size_t)nom * V + k]) evict_pod<I>(a, s, pw.vlist[(size_t)nom * V + k], nom);
  __syncthreads();
}

template <typename I>
__global__ void __launch_bounds__(1024)
    seq_attempt_kernel(Cfg c, Planes a, State s, const I* w, int p, int* codes, I* raw, I* fin,
                       int* sel, int* pf, unsigned char* feas, char* wsp) {
  __shared__ Smem<I> sm;
  Ws ws;
  ws_layout(a, sizeof(I), c.vbound, wsp, &ws);
  const int r = attempt_body<I>(c, need_of(c), a, s, w, p, codes, raw, fin, feas, ws, sm);
  if (threadIdx.x == 0) {
    *sel = r;
    if (c.pf_vb) pf[0] = prefilter_code(c, a, p);
  }
}

template <typename I>
__global__ void seq_bind_kernel(Planes a, State s, int p, const int* sel, int qi) {
  bind_body<I>(a, s, p, *sel, qi);
}

template <typename I>
__global__ void __launch_bounds__(1024)
    seq_evict_kernel(Planes a, State s, const unsigned char* mask) {
  for (int v = threadIdx.x; v < a.P; v += blockDim.x) {
    if (!mask[v]) continue;
    const int n = s.assignment[v];
    evict_pod<I>(a, s, v, n > 0 ? n : 0);
  }
}

template <typename I>
__global__ void __launch_bounds__(1024)
    seq_preempt_kernel(Cfg c, Planes a, State s, int p, int* pcode, int* off, int* vidx,
                       int* nominated, int* status, char* wsp) {
  __shared__ Smem<long long> sml;
  Ws ws;
  ws_layout(a, sizeof(I), c.vbound, wsp, &ws);
  const Need nd = need_of(c);
  if (threadIdx.x == 0) ws.vol[3] = 0;
  prologue<I>(c, nd, a, s, p, ws);
  const int nom = dry_run<I>(c, nd, a, s, ws, p, pcode, off, vidx, a.P, status, sml);
  if (threadIdx.x == 0) {
    *nominated = nom;
    status[1] |= ws.vol[3];
  }
}

// The sequential pass over `queue` by one block, on state s with weights
// w: `seq_run`'s whole launch and one variant of `sweep_run`'s, so the two
// kernels run one step. feas, codes_scratch, raw_scratch and the workspace
// ws are the block's own.
// PRE: the configuration enables DefaultPreemption. Its own instantiation
// keeps the preemption branch's code and registers out of the other
// configurations' step. SKIP (`sweep_seg`'s per-variant segments, no trace):
// a padding step (p == -1) only writes sel = final_sel = -1, which is what
// its evaluation of pod 0 would have come to.
template <typename I, bool PRE, bool SKIP = false>
__device__ __forceinline__ void run_body(const Cfg& c, const Need& nd, const Planes& a,
                                         const State& s, const I* w, const int* queue,
                                         const int* qpos, int Q, int step0, const Trace& tr,
                                         unsigned char* feas, int* codes_scratch,
                                         I* raw_scratch, const Ws& ws, Smem<I>& sm,
                                         Smem<long long>& sml) {
  const int N = a.N;
  const size_t nf = (size_t)N * c.n_filters, ns = (size_t)N * c.n_scores;
  const bool record = tr.codes != nullptr;
  if (threadIdx.x == 0) ws.vol[3] = 0;
  for (int qi = 0; qi < Q; ++qi) {
    const int p = queue[qi];
    if (SKIP && p < 0) {
      if (threadIdx.x == 0) tr.sel[qi] = tr.final_sel[qi] = -1;
      continue;
    }
    // a padding step (p == -1) evaluates pod 0 and discards the result
    const int ps = p > 0 ? p : 0;
    const bool pf_ok = prefilter_code(c, a, ps) == 0;
    int sl = -1, fsel = -1, nom = -1;
    int* off = record ? tr.voff + (size_t)qi * 2 * (N + 1) : nullptr;
    // round 0 is the pod's attempt; round 1, the preemption branch's retry
    // on the state after eviction (one call site keeps one inlined copy)
    for (int round = 0; round < 2; ++round) {
      int* cr = codes_scratch;
      I* rr = raw_scratch;
      I* fr = nullptr;
      if (record) {
        cr = (round == 0 ? tr.codes : tr.codes2) + (size_t)qi * nf;
        rr = (I*)(round == 0 ? tr.raw : tr.raw2) + (size_t)qi * ns;
        fr = (I*)(round == 0 ? tr.fin : tr.fin2) + (size_t)qi * ns;
      }
      const int r = attempt_body<I>(c, nd, a, s, w, ps, cr, rr, fr, feas, ws, sm);
      int* pc = record ? (round == 0 ? tr.pcode : tr.pcode2) + (size_t)qi * N : nullptr;
      if (round == 0) {
        sl = fsel = p < 0 ? -1 : r;
        if (threadIdx.x == 0) {
          tr.sel[qi] = sl;
          if (record && c.pf_vb) tr.pf_codes[qi] = prefilter_code(c, a, ps);
        }
        if (!PRE) break;
        if (!(sl < 0 && pf_ok && a.pod_mask[ps] && p >= 0)) {
          // no dry run: zero codes, no nomination, empty victim records (the
          // retry rows stay as the caller zeroed them)
          if (record) {
            for (int n = threadIdx.x; n < N; n += blockDim.x) pc[n] = tr.pcode2[(size_t)qi * N + n] = 0;
            const int at = tr.status[0];
            for (int j = threadIdx.x; j < 2 * (N + 1); j += blockDim.x) off[j] = at;
            if (threadIdx.x == 0) {
              tr.did[qi] = 0;
              tr.nominated[qi] = tr.sel2[qi] = tr.nominated2[qi] = -1;
            }
          }
          break;
        }
        // the dry run; on a nomination, evict its victims on that node
        nom = dry_run<I>(c, nd, a, s, ws, ps, pc, off, tr.vidx, tr.victim_cap, tr.status, sml);
        if (nom >= 0) evict_nominated<I>(c, a, s, ws, nom);
      } else {
        // the retry's failure is recorded and never evicts
        const int nom2 = dry_run<I>(c, nd, a, s, ws, ps, pc, record ? off + N + 1 : nullptr,
                                    tr.vidx, tr.victim_cap, tr.status, sml);
        if (nom >= 0) fsel = r;
        if (threadIdx.x == 0 && record) {
          tr.did[qi] = 1;
          tr.nominated[qi] = nom;
          tr.sel2[qi] = r;
          tr.nominated2[qi] = nom2;
        }
      }
    }
    if (PRE && threadIdx.x == 0 && tr.final_sel) tr.final_sel[qi] = fsel;
    // bind order P + the step's queue position: step0 + qi, or qpos[qi]
    // where the caller gives each step's position (the gang engine's
    // preempt phase, whose pods keep their PrioritySort positions)
    bind_body<I>(a, s, p, fsel, qpos ? qpos[qi] : step0 + qi);
    __syncthreads();  // pod qi+1 sees pod qi's bind
  }
  if (threadIdx.x == 0) tr.status[1] |= ws.vol[3];
}

template <typename I, bool PRE>
__global__ void __launch_bounds__(1024)
    seq_run_kernel(Cfg c, Planes a, State s, const I* w, const int* queue, const int* qpos,
                   int Q, int step0, Trace tr, unsigned char* feas, int* codes_scratch,
                   I* raw_scratch, char* wsp) {
  __shared__ Smem<I> sm;
  __shared__ Smem<long long> sml;
  Ws ws;
  ws_layout(a, sizeof(I), c.vbound, wsp, &ws);
  run_body<I, PRE>(c, need_of(c), a, s, w, queue, qpos, Q, step0, tr, feas, codes_scratch,
                   raw_scratch, ws, sm, sml);
}

// Variant v's slice of a stacked pointer: `stride` bytes a variant.
#define SHIFT_PTR(type, name) \
  if (x.name) x.name = (type)((char*)x.name + (long long)v * st.name);

__device__ __forceinline__ State variant_state(State x, const StateStride& st, int v) {
  STATE_PTRS(SHIFT_PTR)
  return x;
}

__device__ __forceinline__ Trace variant_trace(Trace x, const TraceStride& st, int v) {
  TRACE_PTRS(SHIFT_PTR)
  return x;
}

// The tenant form (K11 `batch.seq.run`/`batch.gang.run`, TEN = true): each
// variant is a tenant of the batch plane with its own cluster, so the kernel
// takes a device table of Planes, one entry a tenant (engine/cuda.py builds
// it from each tenant's own encoding, with no copy of its tensors), where the
// other forms take one Planes for every variant. A block copies its tenant's
// entry into shared memory before it works on that tenant. The tenants'
// dims are equal (one compile signature a window), so a block lays out its
// workspace once.
template <bool TEN> struct PlanesArg { using T = Planes; };
template <> struct PlanesArg<true> { using T = const Planes*; };
template <bool TEN> struct PlanesCopy { using T = char; };
template <> struct PlanesCopy<true> { using T = Planes; };
static_assert(sizeof(Planes) % 8 == 0, "Planes is copied in 8-byte words");

// The planes of variant v: the kernel's own (one cluster)...
__device__ __forceinline__ const Planes& planes_of(const Planes& a, int, char&) { return a; }

// ...or tenant v's entry of the table, copied into the block's shared `sp`.
__device__ __forceinline__ const Planes& planes_of(const Planes* tab, int v, Planes& sp) {
  __syncthreads();  // every thread is done with the previous tenant's planes
  const unsigned long long* src = (const unsigned long long*)(tab + v);
  unsigned long long* dst = (unsigned long long*)&sp;
  for (int i = threadIdx.x; i < (int)(sizeof(Planes) / 8); i += blockDim.x) dst[i] = src[i];
  __syncthreads();
  return sp;
}

// The tenant forms' loop (K11 `batch.seq.run`, and with SKIP the phases of
// `batch.gang.run`): variant v is tenant v, with its own planes (entry v of
// the table `tab`, copied into shared memory by `planes_of`), its own queue
// row queue + v*Q and queue positions qpos + v*Q (null: step i binds at P +
// i), weights row, state and trace slices. The grid strides over the
// tenants as `sweep_run_kernel`'s over its variants.
template <typename I, bool PRE, bool SKIP>
__device__ __forceinline__ void tenant_loop(const Cfg& c, const Planes* tab, const State& s0,
                                            const StateStride& ss, const I* w, int V,
                                            const int* queue, const int* qpos, int Q,
                                            const Trace& tr0, const TraceStride& ts,
                                            unsigned char* feas_s, int* codes_s, I* raw_s,
                                            char* wsp, long long ws_bytes, Smem<I>& sm,
                                            Smem<long long>& sml) {
  __shared__ Planes sp;
  Ws ws;
  const Planes& a0 = planes_of(tab, 0, sp);
  ws_layout(a0, sizeof(I), c.vbound, wsp + (size_t)blockIdx.x * ws_bytes, &ws);
  const Need nd = need_of(c);
  const size_t N = a0.N;
  unsigned char* feas = feas_s + blockIdx.x * N;
  int* cs = codes_s + blockIdx.x * N * c.n_filters;
  I* rs = raw_s + blockIdx.x * N * c.n_scores;
  for (int v = blockIdx.x; v < V; v += gridDim.x) {
    const Planes& a = planes_of(tab, v, sp);
    const size_t vq = (size_t)v * Q;
    run_body<I, PRE, SKIP>(c, nd, a, variant_state(s0, ss, v), w + (size_t)v * c.n_scores,
                           queue + vq, qpos ? qpos + vq : nullptr, Q, 0,
                           variant_trace(tr0, ts, v), feas, cs, rs, ws, sm, sml);
    __syncthreads();  // the next tenant reuses the block's slices
  }
}

// K11 sweep: V weight variants of one pass, each exactly `seq_run` (step0 =
// 0, no queue positions) on its own weights row w[v] and its own state and
// trace slices, over the shared planes and queue. The grid strides over
// the variants (the host build runs one block); each block keeps one
// scratch and workspace slice, reused variant after variant.
// TEN (K11 `batch.seq.run`): variant v is tenant v, with its own planes
// (`a` is the table) and queue row (`tenant_loop`).
template <typename I, bool PRE, bool TEN = false>
__global__ void __launch_bounds__(1024)
    sweep_run_kernel(Cfg c, typename PlanesArg<TEN>::T a, State s0, StateStride ss,
                     const I* w, int V, const int* queue, int Q, Trace tr0, TraceStride ts,
                     unsigned char* feas_s, int* codes_s, I* raw_s, char* wsp,
                     long long ws_bytes) {
  __shared__ Smem<I> sm;
  __shared__ Smem<long long> sml;
  if constexpr (TEN) {
    tenant_loop<I, PRE, false>(c, a, s0, ss, w, V, queue, nullptr, Q, tr0, ts, feas_s, codes_s,
                               raw_s, wsp, ws_bytes, sm, sml);
  } else {
    Ws ws;
    ws_layout(a, sizeof(I), c.vbound, wsp + (size_t)blockIdx.x * ws_bytes, &ws);
    const Need nd = need_of(c);
    const size_t N = a.N;
    unsigned char* feas = feas_s + blockIdx.x * N;
    int* cs = codes_s + blockIdx.x * N * c.n_filters;
    I* rs = raw_s + blockIdx.x * N * c.n_scores;
    for (int v = blockIdx.x; v < V; v += gridDim.x) {
      run_body<I, PRE>(c, nd, a, variant_state(s0, ss, v), w + (size_t)v * c.n_scores, queue,
                       nullptr, Q, 0, variant_trace(tr0, ts, v), feas, cs, rs, ws, sm, sml);
      __syncthreads();  // the next variant reuses the block's slices
    }
  }
}

// K11 `gangsweep.vphase`: the gang sweep's preempt phase, each variant's
// own pending segment segs[v] (K steps, -1 padded) with its pods' queue
// positions qpos[v] (null: step i binds at P + i), run as `seq_run` with the
// preemption branch on its weights row, state and selections, the padding
// steps skipped (they bind nothing). No trace. The grid strides over the
// variants as `sweep_run_kernel`'s does. TEN (the phases of K11
// `batch.gang.run`): variant v is tenant v, with its own planes.
template <typename I, bool TEN = false>
__global__ void __launch_bounds__(1024)
    sweep_seg_kernel(Cfg c, typename PlanesArg<TEN>::T a, State s0, StateStride ss,
                     const I* w, int V, const int* segs, const int* qpos, int K, Trace tr0,
                     TraceStride ts, unsigned char* feas_s, int* codes_s, I* raw_s, char* wsp,
                     long long ws_bytes) {
  __shared__ Smem<I> sm;
  __shared__ Smem<long long> sml;
  if constexpr (TEN) {
    tenant_loop<I, true, true>(c, a, s0, ss, w, V, segs, qpos, K, tr0, ts, feas_s, codes_s,
                               raw_s, wsp, ws_bytes, sm, sml);
  } else {
    Ws ws;
    ws_layout(a, sizeof(I), c.vbound, wsp + (size_t)blockIdx.x * ws_bytes, &ws);
    const Need nd = need_of(c);
    const size_t N = a.N;
    unsigned char* feas = feas_s + blockIdx.x * N;
    int* cs = codes_s + blockIdx.x * N * c.n_filters;
    I* rs = raw_s + blockIdx.x * N * c.n_scores;
    for (int v = blockIdx.x; v < V; v += gridDim.x) {
      const size_t vk = (size_t)v * K;
      run_body<I, true, true>(c, nd, a, variant_state(s0, ss, v), w + (size_t)v * c.n_scores,
                              segs + vk, qpos ? qpos + vk : nullptr, K, 0,
                              variant_trace(tr0, ts, v), feas, cs, rs, ws, sm, sml);
      __syncthreads();  // the next variant reuses the block's slices
    }
  }
}

int block_threads(int n) {
  int t = ((n + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

template <typename I>
int launch_attempt(const Cfg* c, const Planes* a, const State* s, const void* w, int p,
                   int* codes, void* raw, void* fin, int* sel, int* pf, unsigned char* feas,
                   void* ws, void* stream) {
  seq_attempt_kernel<I><<<1, block_threads(a->N), 0, (cudaStream_t)stream>>>(
      *c, *a, *s, (const I*)w, p, codes, (I*)raw, (I*)fin, sel, pf, feas, (char*)ws);
  return (int)cudaGetLastError();
}

template <typename I>
int launch_bind(const Planes* a, const State* s, int p, const int* sel, int qi, void* stream) {
  seq_bind_kernel<I><<<1, 32, 0, (cudaStream_t)stream>>>(*a, *s, p, sel, qi);
  return (int)cudaGetLastError();
}

template <typename I>
int launch_evict(const Planes* a, const State* s, const unsigned char* mask, void* stream) {
  seq_evict_kernel<I><<<1, block_threads(a->P), 0, (cudaStream_t)stream>>>(*a, *s, mask);
  return (int)cudaGetLastError();
}

template <typename I>
int launch_preempt(const Cfg* c, const Planes* a, const State* s, int p, int* pcode, int* off,
                   int* vidx, int* nominated, int* status, void* ws, void* stream) {
  seq_preempt_kernel<I><<<1, block_threads(a->N), 0, (cudaStream_t)stream>>>(
      *c, *a, *s, p, pcode, off, vidx, nominated, status, (char*)ws);
  return (int)cudaGetLastError();
}

template <typename I>
int launch_run(const Cfg* c, const Planes* a, const State* s, const void* w, const int* queue,
               const int* qpos, int Q, int step0, const Trace* tr, unsigned char* feas,
               int* codes_scratch, void* raw_scratch, void* ws, void* stream) {
  if (c->preempt)
    seq_run_kernel<I, true><<<1, block_threads(a->N), 0, (cudaStream_t)stream>>>(
        *c, *a, *s, (const I*)w, queue, qpos, Q, step0, *tr, feas, codes_scratch,
        (I*)raw_scratch, (char*)ws);
  else
    seq_run_kernel<I, false><<<1, block_threads(a->N), 0, (cudaStream_t)stream>>>(
        *c, *a, *s, (const I*)w, queue, qpos, Q, step0, *tr, feas, codes_scratch,
        (I*)raw_scratch, (char*)ws);
  return (int)cudaGetLastError();
}

// `ap` is the one Planes (TEN = false) or the device table of the tenants'
// (TEN = true); `n_nodes` their node count.
template <typename I, bool TEN>
int launch_sweep(const Cfg* c, typename PlanesArg<TEN>::T ap, int n_nodes, const State* s,
                 const StateStride* ss, const void* w, int V, const int* queue, int Q,
                 const Trace* tr, const TraceStride* ts, int grid, unsigned char* feas,
                 int* codes_scratch, void* raw_scratch, void* ws, long long ws_bytes,
                 void* stream) {
  if (c->preempt)
    sweep_run_kernel<I, true, TEN><<<grid, block_threads(n_nodes), 0, (cudaStream_t)stream>>>(
        *c, ap, *s, *ss, (const I*)w, V, queue, Q, *tr, *ts, feas, codes_scratch,
        (I*)raw_scratch, (char*)ws, ws_bytes);
  else
    sweep_run_kernel<I, false, TEN><<<grid, block_threads(n_nodes), 0, (cudaStream_t)stream>>>(
        *c, ap, *s, *ss, (const I*)w, V, queue, Q, *tr, *ts, feas, codes_scratch,
        (I*)raw_scratch, (char*)ws, ws_bytes);
  return (int)cudaGetLastError();
}

template <typename I, bool TEN>
int launch_sweep_seg(const Cfg* c, typename PlanesArg<TEN>::T ap, int n_nodes, const State* s,
                     const StateStride* ss, const void* w, int V, const int* segs,
                     const int* qpos, int K, const Trace* tr, const TraceStride* ts, int grid,
                     unsigned char* feas, int* codes_scratch, void* raw_scratch, void* ws,
                     long long ws_bytes, void* stream) {
  if (!c->preempt) return -1;  // a phase belongs to DefaultPreemption
  sweep_seg_kernel<I, TEN><<<grid, block_threads(n_nodes), 0, (cudaStream_t)stream>>>(
      *c, ap, *s, *ss, (const I*)w, V, segs, qpos, K, *tr, *ts, feas, codes_scratch,
      (I*)raw_scratch, (char*)ws, ws_bytes);
  return (int)cudaGetLastError();
}

// The blocks of a kernel resident at once on the card for `n_nodes` nodes:
// the most blocks a launch needs (the caller allocates a scratch slice for
// each). The host build runs one block.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads) {
#ifdef __CUDACC__
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0) != cudaSuccess)
    return -1;
  return per_sm * sms;
#else
  return 1;
#endif
}

// The blocks of sweep_seg (TEN: its tenant form) resident at once.
template <typename I, bool TEN>
int sweep_seg_grid(int n_nodes) {
  return resident_blocks(sweep_seg_kernel<I, TEN>, block_threads(n_nodes));
}

// The blocks of sweep_run (TEN: its tenant form) resident at once, for a
// configuration with (pre) or without DefaultPreemption.
template <typename I, bool TEN>
int sweep_run_grid(int n_nodes, int pre) {
  const int t = block_threads(n_nodes);
  return pre ? resident_blocks(sweep_run_kernel<I, true, TEN>, t)
             : resident_blocks(sweep_run_kernel<I, false, TEN>, t);
}

}  // namespace

// ---------------------------------------------------------------------------
// plain C interface (engine/cuda.py binds it with ctypes). Each launcher
// returns cudaGetLastError() after the launch; the kernels run on the
// caller's stream and allocate nothing: the caller passes the workspace,
// `seq_workspace_bytes` large.
// ---------------------------------------------------------------------------

// The build (engine/cuda.py `build`) compiles this file four times at once,
// with SEQ_ONLY=32 and SEQ_ONLY=64 (each translation unit one integer type's
// kernels) and SEQ_TENANT=0 and 1 (the entry points without, or only, the
// tenant forms), and links the four; without SEQ_ONLY and SEQ_TENANT one
// unit holds everything.
extern "C" {

#if (!defined(SEQ_ONLY) || SEQ_ONLY == 32) && (!defined(SEQ_TENANT) || SEQ_TENANT == 0)
long long seq_workspace_bytes(const Planes* a, int int_bytes, int vbound) {
  return (long long)ws_layout(*a, (size_t)int_bytes, vbound, nullptr, nullptr);
}
#endif

#define SEQ_ENTRY_POINTS(T, I)                                                                \
  int seq_attempt_##T(const Cfg* c, const Planes* a, const State* s, const void* w, int p,    \
                      int* codes, void* raw, void* fin, int* sel, int* pf,                    \
                      unsigned char* feas, void* ws, void* stream) {                          \
    return launch_attempt<I>(c, a, s, w, p, codes, raw, fin, sel, pf, feas, ws, stream);      \
  }                                                                                           \
  int seq_bind_##T(const Planes* a, const State* s, int p, const int* sel, int qi,            \
                   void* stream) {                                                            \
    return launch_bind<I>(a, s, p, sel, qi, stream);                                          \
  }                                                                                           \
  int seq_evict_##T(const Planes* a, const State* s, const unsigned char* mask,              \
                    void* stream) {                                                           \
    return launch_evict<I>(a, s, mask, stream);                                               \
  }                                                                                           \
  int seq_preempt_##T(const Cfg* c, const Planes* a, const State* s, int p, int* pcode,       \
                      int* off, int* vidx, int* nominated, int* status, void* ws,             \
                      void* stream) {                                                         \
    return launch_preempt<I>(c, a, s, p, pcode, off, vidx, nominated, status, ws, stream);    \
  }                                                                                           \
  int seq_run_##T(const Cfg* c, const Planes* a, const State* s, const void* w,               \
                  const int* queue, const int* qpos, int Q, int step0, const Trace* tr,       \
                  unsigned char* feas, int* codes_scratch, void* raw_scratch, void* ws,       \
                  void* stream) {                                                             \
    return launch_run<I>(c, a, s, w, queue, qpos, Q, step0, tr, feas, codes_scratch,          \
                         raw_scratch, ws, stream);                                            \
  }                                                                                           \
  int sweep_run_grid_##T(int n_nodes, int pre) {                                              \
    return sweep_run_grid<I, false>(n_nodes, pre);                                            \
  }                                                                                           \
  int sweep_run_##T(const Cfg* c, const Planes* a, const State* s, const StateStride* ss,     \
                    const void* w, int V, const int* queue, int Q, const Trace* tr,           \
                    const TraceStride* ts, int grid, unsigned char* feas,                     \
                    int* codes_scratch, void* raw_scratch, void* ws, long long ws_bytes,      \
                    void* stream) {                                                           \
    return launch_sweep<I, false>(c, *a, a->N, s, ss, w, V, queue, Q, tr, ts, grid, feas,     \
                                  codes_scratch, raw_scratch, ws, ws_bytes, stream);          \
  }                                                                                           \
  int sweep_seg_grid_##T(int n_nodes) { return sweep_seg_grid<I, false>(n_nodes); }           \
  int sweep_seg_##T(const Cfg* c, const Planes* a, const State* s, const StateStride* ss,     \
                    const void* w, int V, const int* segs, const int* qpos, int K,            \
                    const Trace* tr, const TraceStride* ts, int grid, unsigned char* feas,    \
                    int* codes_scratch, void* raw_scratch, void* ws, long long ws_bytes,      \
                    void* stream) {                                                           \
    return launch_sweep_seg<I, false>(c, *a, a->N, s, ss, w, V, segs, qpos, K, tr, ts, grid,  \
                                      feas, codes_scratch, raw_scratch, ws, ws_bytes,         \
                                      stream);                                                \
  }

// the tenant forms: `tab` is the device table of the V tenants' Planes
#define TENANT_ENTRY_POINTS(T, I)                                                             \
  int batch_run_grid_##T(int n_nodes, int pre) { return sweep_run_grid<I, true>(n_nodes, pre); } \
  int batch_run_##T(const Cfg* c, const Planes* tab, int n_nodes, const State* s,            \
                    const StateStride* ss, const void* w, int V, const int* queues, int Q,    \
                    const Trace* tr, const TraceStride* ts, int grid, unsigned char* feas,    \
                    int* codes_scratch, void* raw_scratch, void* ws, long long ws_bytes,      \
                    void* stream) {                                                           \
    return launch_sweep<I, true>(c, tab, n_nodes, s, ss, w, V, queues, Q, tr, ts, grid, feas, \
                                 codes_scratch, raw_scratch, ws, ws_bytes, stream);           \
  }                                                                                           \
  int batch_seg_grid_##T(int n_nodes) { return sweep_seg_grid<I, true>(n_nodes); }            \
  int batch_seg_##T(const Cfg* c, const Planes* tab, int n_nodes, const State* s,            \
                    const StateStride* ss, const void* w, int V, const int* segs,             \
                    const int* qpos, int K, const Trace* tr, const TraceStride* ts, int grid,  \
                    unsigned char* feas, int* codes_scratch, void* raw_scratch, void* ws,     \
                    long long ws_bytes, void* stream) {                                       \
    return launch_sweep_seg<I, true>(c, tab, n_nodes, s, ss, w, V, segs, qpos, K, tr, ts,     \
                                     grid, feas, codes_scratch, raw_scratch, ws, ws_bytes,    \
                                     stream);                                                 \
  }

#if !defined(SEQ_TENANT) || SEQ_TENANT == 0
#if !defined(SEQ_ONLY) || SEQ_ONLY == 32
SEQ_ENTRY_POINTS(i32, int)
#endif
#if !defined(SEQ_ONLY) || SEQ_ONLY == 64
SEQ_ENTRY_POINTS(i64, long long)
#endif
#endif
#if !defined(SEQ_TENANT) || SEQ_TENANT == 1
#if !defined(SEQ_ONLY) || SEQ_ONLY == 32
TENANT_ENTRY_POINTS(i32, int)
#endif
#if !defined(SEQ_ONLY) || SEQ_ONLY == 64
TENANT_ENTRY_POINTS(i64, long long)
#endif
#endif

}  // extern "C"

// The gang engine's kernels (K9) share this unit's device functions: they
// are compiled with it, once per integer type.
#include "gang_kernels.cu"
