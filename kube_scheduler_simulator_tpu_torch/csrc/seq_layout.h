// The structs engine/cuda.py fills on the host and the kernels read
// (csrc/seq_kernels.cu), and the plain C functions that report their
// layout. Each struct is declared from a list that names every member once:
// `seq_layout()` reports every list's names in order, and engine/cuda.py
// builds its ctypes mirror from that report, so a plane is added here and
// in cuda.py's `_SPEC` (its dims and element type) only. The header holds
// no device code, so a host compiler builds it alone (the port's tests do).

#pragma once

// capacities of Cfg's arrays
constexpr int MAX_F = 16;
constexpr int MAX_S = 9;  // the default profile's 7 scores and both demo plugins
constexpr int MAX_SPEC = 16;
constexpr int MAX_PTS = 16;
constexpr int MAX_BAL = 16;
constexpr int N_VOL3 = 3;  // the volume-count limit plugins (EBS, GCE PD, Azure disk)

#define DECL_INT(name) int name;
#define DECL_INTS(name, n) int name[n];
#define NAME_INT(name) #name ","
#define COUNT_INT(name) out[i++] = 1;
#define DECL_PTR(type, name) type name;
#define DECL_DIM(name) int name;
#define NAME_INTS(name, n) #name ","
#define COUNT_INTS(name, n) out[i++] = n;
#define NAME_PTR(type, name) #name ","
#define NAME_DIM(name) #name ","

// The enabled plugins, their order, weights and static arguments: plain
// ints, packed by engine/cuda.py `pack_config` in this field order.
// spread_on / interpod_on: PreScore of PodTopologySpread / InterPodAffinity
// is enabled (without it the plugin's score is 0 and normalizes to 0);
// hard_w: InterPodAffinityArgs.hardPodAffinityWeight; pf_vb: the
// VolumeBinding prefilter is enabled; preempt: DefaultPreemption is
// enabled, and vbound is the victims per node its dry run keeps (the
// reference's `_victim_bound`); vol_limit: the per-node volume limits;
// nn_reverse: NodeNumberArgs.reverse (plugins/nodenumber.py).
// X1 names an int, XN an array of n ints.
#define CFG_FIELDS(X1, XN)                                                          \
  X1(n_filters) XN(filter, MAX_F) X1(n_scores) XN(score, MAX_S) XN(mode, MAX_S)     \
  X1(fit_type) X1(fit_wsum) X1(fit_n) XN(fit_r, MAX_SPEC) XN(fit_w, MAX_SPEC)       \
  X1(rtcr_n) XN(rtcr_x, MAX_PTS) XN(rtcr_y, MAX_PTS) X1(bal_n) XN(bal_r, MAX_BAL)   \
  X1(spread_on) X1(interpod_on) X1(hard_w) X1(pf_vb) X1(preempt) X1(vbound)         \
  XN(vol_limit, N_VOL3) X1(nn_reverse)

// Required or preferred node-affinity terms of every pod
// (ClusterArrays raff_* / paff_*): [P, TM, E(, VV)]. key: label key column
// | -1 pad; vals: value ids | VAL_PAD; num: the Gt/Lt operand in the
// policy's type; term_valid: the term has an expression; weight: preferred
// terms only, else null.
#define NODE_TERM_SETS(X) X(raff) X(paff)
#define NODE_TERM_PTRS(X)                                                       \
  X(const int*, key) X(const int*, op) X(const int*, vals) X(const void*, num)  \
  X(const unsigned char*, num_ok) X(const unsigned char*, term_valid)           \
  X(const int*, weight)
#define NODE_TERM_DIMS(X) X(TM) X(E) X(VV)

// One relational term domain of every pod (PodRelArrays): spread hard or
// soft constraints, or one InterPodAffinity term kind; unused members are
// null. key [P, T]: node-label key column | -1 pad; ctype [P, T, C]: clause
// type | CL_PAD; ckey [P, T, C]: pod-label key id | -1; cpairs [P, T, C,
// VP]: pod-label pair id | -1; skew: spread maxSkew; flag: sph_self /
// sps_host / ia_self; nsall: the term selects every namespace; ns [P, T,
// NSV]: it selects that namespace; weight: preferred-term weight.
#define TERM_DOMAINS(X) X(sph) X(sps) X(ia) X(ian) X(ipa) X(ipan)
#define TERM_PTRS(X)                                                            \
  X(const int*, key) X(const int*, ctype) X(const int*, ckey)                   \
  X(const int*, cpairs) X(const int*, skew) X(const unsigned char*, flag)       \
  X(const unsigned char*, nsall) X(const unsigned char*, ns) X(const int*, weight)
#define TERM_DIMS(X) X(T) X(C) X(VP)

// Device pointers of the cluster planes (engine/encode.py ClusterArrays and
// engine/encode_rel.py PodRelArrays). Planes of the policy's integer type
// are void*; bools are one byte. label_val [N, K]: value id | -1 absent;
// node_pair [N, K]: topology pair id + 1 | 0 absent. The volume planes
// (engine/encode_vol.py): vb_row [P] (row of vb_code/vz_code [N, VB] | -1),
// vb_pf [P] prefilter message id, pod_claim [P, CL] ReadWriteOncePod
// claims, pod_disk_any / pod_disk_rw [P, D] disk mounts, pod_vol3 [P, 3].
// The out-of-tree plugins' planes (engine/cuda.py SeqProgram.planes; null
// when the plugin is off): NetworkBandwidth's nb_limit [N] (Mi, the
// policy's type), nb_has [N] (the node has a limit), nb_bw [P] (the pod's
// request, Mi, the policy's type); NodeNumber's nn_node [N] / nn_pod [P]
// (the name's trailing digit; -1 / -2: none).
#define PLANE_PTRS(X)                                                            \
  X(const void*, node_alloc) X(const unsigned char*, node_unsched)               \
  X(const unsigned char*, node_mask) X(const void*, pod_req) X(const void*, pod_sreq) \
  X(const int*, pod_req_rank) X(const int*, pod_node_name)                       \
  X(const unsigned char*, pod_tol_unsched) X(const unsigned char*, pod_mask)     \
  X(const int*, taint_key) X(const int*, taint_val) X(const int*, taint_effect)  \
  X(const int*, tol_key) X(const int*, tol_val) X(const int*, tol_effect)        \
  X(const int*, tol_op) X(const int*, label_val) X(const void*, label_num)       \
  X(const unsigned char*, label_num_ok) X(const int*, nsel_key)                  \
  X(const int*, nsel_val) X(const unsigned char*, pod_has_raff)                  \
  X(const int*, want_wild) X(const int*, want_trip) X(const int*, want_pair)     \
  X(const int*, trip_pair) X(const void*, img_contrib) X(const int*, pod_img)    \
  X(const int*, pod_ncont) X(const unsigned char*, pair_present)                 \
  X(const unsigned char*, key_present) X(const int*, ns_id)                      \
  X(const unsigned char*, deleted) X(const int*, node_pair)                      \
  X(const unsigned char*, req_all) X(const int*, spread_lut)                     \
  X(const int*, pod_priority) X(const int*, vb_row) X(const int*, vb_code)       \
  X(const int*, vz_code) X(const int*, vb_pf) X(const unsigned char*, pod_claim)  \
  X(const int*, pod_disk_any) X(const int*, pod_disk_rw) X(const int*, pod_vol3)  \
  X(const void*, nb_limit) X(const unsigned char*, nb_has) X(const void*, nb_bw)  \
  X(const int*, nn_node) X(const int*, nn_pod)
#define PLANE_DIMS(X)                                                            \
  X(N) X(P) X(R) X(T) X(L) X(K) X(NS) X(Q) X(V2) X(I) X(LP) X(KK) X(NSV) X(NP1) X(LUT) \
  X(VB) X(CL) X(D)

// Device pointers of the state (engine/encode.py SchedState), updated in place.
#define STATE_PTRS(X)                                                            \
  X(void*, requested) X(void*, s_requested) X(int*, n_pods) X(int*, assignment)  \
  X(int*, used_pair) X(int*, used_wild) X(int*, used_trip) X(int*, used_claims)  \
  X(int*, node_disk_any) X(int*, node_disk_rw) X(int*, node_vol3) X(int*, bound_seq)

// The outputs of one `seq_run` launch (engine/cuda.py TRACE_SLOTS_*), rows
// by queue step; a null pointer is not written. The preemption record:
// did [Q]; pcode, pcode2 [Q, N]; nominated, sel2, nominated2, final_sel
// [Q]; the retry attempt's codes2 [Q, N, F] and raw2 / fin2 [Q, N, S],
// written for the steps that fired only (the caller zeroes them); voff
// [Q, 2, N+1], the offsets into vidx [victim_cap] of each dry run's
// victims by node (all equal where the step did not fire). status [2]:
// victims recorded, overflow bits (1: victim_cap, 2: a node held more
// lower-priority pods than vbound).
#define TRACE_PTRS(X)                                                            \
  X(int*, pf_codes) X(int*, codes) X(void*, raw) X(void*, fin) X(int*, sel)      \
  X(unsigned char*, did) X(int*, pcode) X(int*, nominated) X(int*, sel2)         \
  X(int*, pcode2) X(int*, nominated2) X(int*, final_sel) X(int*, codes2)         \
  X(void*, raw2) X(void*, fin2) X(int*, voff) X(int*, vidx) X(int*, status)
#define TRACE_DIMS(X) X(victim_cap)

// Per-variant strides of a `sweep_run` launch: for each State and Trace
// pointer, the bytes from one variant's slice to the next (0: shared or
// not written).
#define DECL_STRIDE(type, name) long long name;

#define DECL_NODE_TERMS(name) NodeTerms name;
#define DECL_TERMS(name) Terms name;

struct Cfg { CFG_FIELDS(DECL_INT, DECL_INTS) };
struct NodeTerms { NODE_TERM_PTRS(DECL_PTR) NODE_TERM_DIMS(DECL_DIM) };
struct Terms { TERM_PTRS(DECL_PTR) TERM_DIMS(DECL_DIM) };
struct Planes {
  PLANE_PTRS(DECL_PTR)
  NODE_TERM_SETS(DECL_NODE_TERMS)
  TERM_DOMAINS(DECL_TERMS)
  PLANE_DIMS(DECL_DIM)
};
struct State { STATE_PTRS(DECL_PTR) };
struct Trace { TRACE_PTRS(DECL_PTR) TRACE_DIMS(DECL_DIM) };
struct StateStride { STATE_PTRS(DECL_STRIDE) };
struct TraceStride { TRACE_PTRS(DECL_STRIDE) };

// The layout report, in one translation unit of the library (the build's
// SEQ_ONLY=32 one without the tenant forms, or the only one).
#if (!defined(SEQ_ONLY) || SEQ_ONLY == 32) && (!defined(SEQ_TENANT) || SEQ_TENANT == 0)
extern "C" {

// Every struct's members in order, as "list=name,name,...;".
const char* seq_layout() {
  return "cfg=" CFG_FIELDS(NAME_INT, NAME_INTS) ";node_term_sets=" NODE_TERM_SETS(NAME_DIM)
         ";node_term_ptrs=" NODE_TERM_PTRS(NAME_PTR) ";node_term_dims=" NODE_TERM_DIMS(NAME_DIM)
         ";term_domains=" TERM_DOMAINS(NAME_DIM) ";term_ptrs=" TERM_PTRS(NAME_PTR)
         ";term_dims=" TERM_DIMS(NAME_DIM) ";plane_ptrs=" PLANE_PTRS(NAME_PTR)
         ";plane_dims=" PLANE_DIMS(NAME_DIM) ";state_ptrs=" STATE_PTRS(NAME_PTR)
         ";trace_ptrs=" TRACE_PTRS(NAME_PTR) ";trace_dims=" TRACE_DIMS(NAME_DIM) ";";
}
// Cfg's ints per field, in its order; returns the field count.
int seq_cfg_counts(int* out) {
  int i = 0;
  CFG_FIELDS(COUNT_INT, COUNT_INTS)
  return i;
}
int seq_planes_bytes() { return (int)sizeof(Planes); }
int seq_state_bytes() { return (int)sizeof(State); }
int seq_trace_bytes() { return (int)sizeof(Trace); }
int seq_stride_bytes() { return (int)(sizeof(StateStride) + sizeof(TraceStride)); }

}  // extern "C"
#endif
