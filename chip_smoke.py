#!/usr/bin/env python3
"""Drive the PyTorch port's scheduling passes on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Three paths run through the same kernels: the fit path (the first slice's
plugin set, `fit_config()`), the affinity path (the default profile without
volumes and preemption, `affinity_config()`, on BASELINE config #3's
workload) and the default path (the reference's whole default profile,
`supported_config()`: the volume family and DefaultPreemption, on
`preemption_cluster`, BASELINE config #2's width with config #5's mixed
PriorityClass preemption). A fourth, the serving path, drives
`SimulatorService.scheduler.schedule()` pass after pass over a store,
through the delta encoder and its K10 row scatters. A fifth, the gang
path, runs `GangScheduler` (rounds of all pending pods through the K9
kernels of csrc/gang_kernels.cu, preempt phases through `seq_run`) and
`schedule_gang()`. A sixth, the weight sweep, runs `WeightSweep` (every
variant's pass in one launch of `sweep_run`) at BASELINE config #4. A
seventh, the gang weight sweep, runs `GangSweep` (every round of every
variant one launch of each K9 kernel, every preempt phase one `sweep_run`
over per-variant segments). An eighth, the batch plane, serves several
sessions' passes of a `SessionManager` as one launch (`batch.seq.run`: the
tenant form of `sweep_run`; `batch.gang.run`: the tenant forms of the K9
kernels and of `sweep_run`'s segments). A ninth, the fault sweep, runs
`FaultSweep` (node-failure scenarios of one cluster: `fault_evict`, the
gang rounds of every scenario through the K9 kernels' tenant forms over a
scenario table, `fault_tally`). A tenth, the counted gang loops, runs
`GangScheduler`, `GangSweep` and `FaultSweep` with `loop="static"`
(`gang_match_counted` and `gang_advance`: a pass of round slots with the
round accounting on the card and one readback). An eleventh, the PACKED
dtype policy (`KSS_DTYPE_POLICY=packed`), runs the sequential, gang and
serving paths on narrow, bit-packed encodings that the K8 kernel
(`pack_widen`, csrc/pack_kernels.cu) widens once a pass. A twelfth, the
demo out-of-tree plugins (NetworkBandwidth and NodeNumber, registered by
importing `plugins.networkbandwidth` and `plugins.nodenumber`), runs the
sequential path, its step functions and the gang kernels with both
plugins' bodies (csrc/seq_kernels.cu `F_NETBW`, `S_NETBW`, `S_NODENUM`,
NetworkBandwidth's prologue sum, normalize and dry-run row) on clusters
annotated by `synth.annotate_bandwidth`. A thirteenth, the fleet & memory
observatory (`KSS_FLEET_STATS`, utils/fleetstats.py), samples the serving
path's passes through K12 (`fleet_quality`, csrc/fleet_kernels.cu), with the
pass-level spans of utils/telemetry.py (`KSS_TRACE`). The plain versions of
the whole passes that phases 3, 4, 4b, 4j, 4k, 4l, 4n and 5e are held against
run on the host CPU in three more processes (`chip_smoke.py --plain-worker DIR
PART`, started at once when the build is done and stopped at the end; the
card's phases hand them their inputs through DIR), beside the card's phases;
the fourth also runs phase 4c's plain segment on the card; phase 4h compares.
Phases,
in order; any failure raises and the process exits non-zero:

1. the device: its name, `nvidia-smi`'s name and power limit, the torch
   and CUDA versions;
2. build: the CUDA kernels compiled for sm_90a into one library in
   build/kernels/, all at once (csrc/seq_kernels.cu by four `nvcc`
   processes, one an integer type and half of its entry points, the
   tenant forms apart, csrc/delta_kernels.cu by a fifth,
   csrc/fault_kernels.cu by a sixth, csrc/pack_kernels.cu by a seventh,
   csrc/fleet_kernels.cu by an eighth),
   with the compiler's register and spill report;
3. each kernel against its plain PyTorch version on the card, under TPU32
   and EXACT, exact equality: (fit) three fit-path configurations on a
   256-node x 2,000-pod cluster dressed with taints, tolerations, cordoned
   nodes, nodeName pods and pods too large for any node; (affinity)
   `affinity_config()` on `synth.dressed_affinity_cluster(256, 2000)`;
   (default) `supported_config()` on `synth.dressed_default_cluster(256,
   300)`: 256 nodes filled to 90% by some 7,400 pre-bound low-priority
   pods with volumes and the affinity dressing, and 300 pending pods (the
   plain pass runs each dry run in small PyTorch launches, which is what
   bounds the queue). Each: `seq_attempt` at 64 pods x random states,
   `seq_bind` on those pods, `seq_run` over the whole queue (trace, final
   state, placements; the plain pass runs in the fourth process and 4h
   compares); on the default path also `seq_preempt` and `seq_evict` at 64
   random states and the decoded records of both passes, victim lists
   included; (K10) the three delta scatters on random bool,
   int32 and int64 planes with rows of rank 0 to 3 (repeated add indices,
   int32 wraparound, a zero-width plane), then every scatter of three delta
   passes over a dressed 256-node store under TPU32 and EXACT (arrivals from
   the reference's delta templates), the encoder on the card against the
   one on the CPU and a from-scratch encode; (gang) `gang_eval`,
   `gang_topk`, `gang_match` and `gang_bind` at random states on
   `dressed_default_cluster(256, 64)` and `dressed_affinity_cluster(256,
   2000)` (required anti-affinity carriers), TPU32 and EXACT, then one
   whole gang pass, `run_recorded()` + `results()`, through the kernels on
   `dressed_default_cluster(256, 300)` (the plain versions' pass in the
   third process; 4h compares state, rounds, records), and the four on
   the annotated `dressed_default_cluster(256, 64)` under the demo plugins'
   configuration, TPU32; (plugins) `kp.demo_config()` (the default profile
   plus NetworkBandwidth's filter and score at weight 2 and NodeNumber's
   score: 16 filters, 9 scores) on the annotated
   `dressed_default_cluster(256, 300)` as the default path's checks, under
   TPU32 and EXACT, and with NodeNumber's `reverse` arg under TPU32
   (attempts, binds and the whole pass): every whole pass's plain version in
   the fourth process, some pod carrying NetworkBandwidth's filter message;
   (K11) `WeightSweep.run` with and without the trace, three weight
   variants (the configuration's own, then two random) on the default
   path's cluster under TPU32 and EXACT, and one `sweep_run` launch of two
   blocks (fewer than the variants) against the first; (gang sweep) the
   four K9 kernels at V = 3 (random per-variant states, weights and row
   lists, one variant frozen at live 0) on the two gang clusters, TPU32 and
   EXACT; one whole `GangSweep.run` of three variants on
   `dressed_default_cluster(256, 300)` (its plain version in the third
   process, compared in 4h), and `sweep_run` over its first preempt phase's
   per-variant segments with queue positions and one more all-padding
   variant;
4. the fit path at full width: `schedule()` on 1,024 nodes x 10,000 pods
   (TPU32, trace recorded) with the launch counters set to 0 just before
   and read just after — the pass must launch `seq_run` and no plain
   version; its placements, trace and 100 sampled pods' annotations must
   equal the plain version's run (phase 4h). Then the single-pod step
   path (`attempt_bind_fn`, launching `seq_attempt` and `seq_bind`) is
   driven over the same queue with the counters reset again, and each step
   must reproduce the pass's trace row;
4b. the affinity path at full width, the same way: BASELINE config #3,
   `synthetic_affinity_cluster(500, 5000, seed=11)`;
4c. the default path at full width: `preemption_cluster(1024, 10000,
   seed=7)` (10,000 pending pods on some 28,000 pre-bound) through the
   entry points `schedule()` composes (`encode_cluster`,
   `BatchedScheduler.run`, `placements`, `results` of 100 sampled pods),
   once, with the counters reset — `seq_run` only, no plain call;
   its dry runs, nominations, evictions, per-filter rejections (every
   filter but NodeVolumeLimits must reject some pod on some node; at
   least 1,000 dry runs and 300 nominations), trace bytes and peak memory;
   the 1,024-step segment with the fewest dry runs among those holding 100
   nominations run again from the kernel pass's own state at its first
   step, its plain version from that state on the card in the fourth
   process (4h compares; the whole queue's plain pass would not fit the
   time limit); and the single-pod step path (`attempt_fn`,
   `preempt_fn`, `evict_fn`, `bind_fn`), each step reproducing its trace
   row and victim records;
4d. the serving path at BASELINE config #2's width: `synthetic_cluster(1024,
   13072, seed=7)`, its first 10,000 pods bound by one kernel pass and
   imported with the next 128 pending into a `SimulatorService` on the
   card; 7 `schedule()` passes, each after 128 arrivals and a cordon (one
   arrival before pass 6 must preempt), then two with no event between.
   After each pass the service's retained encoding must equal a
   from-scratch encode of the store, its records, placements, victims and
   written-back annotations a fresh kernel pass's, and the launch counters
   (set to 0 just before the pass) must show K10 on delta passes only,
   `seq_run` on every pass with a queue, and no plain version; on passes
   5 and 6 (6 holds the preemptor's dry run) the plain version of the
   whole pass on the card over the from-scratch encode must give the
   served pass's trace, victims, final state and records;
4e. the gang default path at full width: `GangScheduler(enc, chunk=64)` on
   the 4c cluster — `run()` with the counters set to 0 just before and
   read just after (K9 and the preempt phases' `seq_run`, no plain call),
   then a second `run()` with each kernel call between CUDA events (device
   ms per round; the wall is the first run's, with no timer), then
   `run_recorded()` + `results()` of the sampled pods (the same
   placements; the replay's seconds; dry runs and nominations), and round
   1's `gang_eval` rows of 64 sampled pods against `seq_attempt`'s masked
   totals at state0; then `run()` on the 4b cluster under
   `affinity_config()`, one exclusive round a carrier, timed the same way;
4f. three `schedule_gang(record=True)` passes of 128 arrivals in a
   1,024-node `SimulatorService` session (the second with `window=64`),
   each with K9 launched and no plain call and its records written back;
   the third held against the plain gang on the card;
4g. BASELINE config #4, the Monte-Carlo weight sweep: 1,000 score-weight
   variants (the configuration's own, then integers 1-10 per plugin from
   seed 42) of `synthetic_cluster(1024, 10000, seed=42)` under
   `supported_config()`, TPU32, through `WeightSweep.run` with the
   counters set to 0 just before and read just after: one `sweep_run`
   launch and no plain call; variant 0 against the engine's own pass, two
   sampled variants against single-variant `seq_run` launches (variant 0
   and the first sampled one against the plain version too, in 4h and
   5e). Then a
   preempting sweep, one variant per SM, on the 4c cluster: variant 0
   against phase 4c's final state, a dry run in every variant;
4i. the gang weight sweep: `GangSweep.run` of 128 variants (the
   configuration's own weights, then integers 1-10 per plugin from seed
   42) of config #4's cluster, TPU32, with the counters set to 0 just
   before and read just after: each round one launch of each K9 kernel for
   all variants, each phase one `sweep_run`, no plain call; variant 0 and
   two sampled variants against single-variant GangScheduler(compact=False)
   runs on the card. Then four variants of the 4c cluster (chunk 64):
   rounds, phases, the pods each phase took, evictions in every variant;
   variant 0 against phase 4e's GangScheduler where its own loop stops
   where the sweep's did, else against a one-variant sweep held to the
   sweep's phases and passes;
4j. the batch plane through `SessionManager` on the card with its plane
   armed from `KSS_BATCH` (a long window, `KSS_BATCH_MAX_SESSIONS` = the
   tenants: each window flushes full, the passes barrier-aligned), TPU32:
   (a) 3 tenants of phase 4d's serving cluster (1,024 nodes, 10,000 pods
   bound, 128 pending; tenant i's pending CPU requests scaled by 1 + i / 8)
   in one sequential window: one `batch_run` launch, no `seq_run` and no
   plain call, all compile signatures equal, every pass counted batched and
   no solo fallback (a failed batched launch fails the phase); (b) 2
   tenants of phase 4c's cluster with 128 pending each, a dry run in every
   tenant; (c) `schedule_gang(record=False)` passes after 128 more
   arrivals each, the 3 serving tenants in one window, 2 of the preempting
   ones in another: every round one launch of each K9 tenant form, every
   phase one `batch_seg`, the preempting window's phases run. In each
   window every tenant's final state, trace and victims (sequential) or
   state, rounds and placements (gang) equal a solo dispatch of its own
   encoding on the card (the engine a solo pass runs), timed one after
   another, and the last tenant's records its solo engine's; the windows'
   walls, device ms, peak memory and decisions/s;
4k. the fault sweep, TPU32: (a) docs/lifecycle.md's example at full
   width: `FaultSweep.from_cluster` on phase 4's cluster (1,024 nodes x
   10,000 pods, `fit_config()`) with phase 4's placements as the baseline
   (placed pods bound, the rest pending), `sample_masks(256, seed=7,
   fail_prob=0.05)`, `run`, with the counters set to 0 just before the
   construction and read just after the run: the baseline's one
   `gang_bind`, one `fault_evict`, each round one launch of each K9 tenant
   form for all 256 scenarios, one `fault_tally`, no plain call; `run_one`
   of scenario 0 and of the worst scenario equal their rows of `run`, no
   scenario places a pod on a failed node, rescheduled + stranded =
   evicted; wall, scenario-decisions/s, rounds, readbacks, peak memory
   beside the round-1 scores' size, the profile's totals and (a second
   run) the device ms by kernel; (b) the default profile at phase 3's
   size: 8 scenarios at fail_prob 0.02 of phase 3's default cluster, its
   TPU32 kernel pass's placements as the baseline, whose plain sweep two of
   the plain processes share (4h compares baseline, assignments, counters,
   rounds and final states of every scenario), then the same sweep at
   fail_prob 0.1 on the card alone (launches, `run_one` of scenarios 0 and
   worst, no pod on a failed node, the counters' sum);
4l. the counted gang forms (`loop="static"`), TPU32, each run with the
   counters set to 0 just before and read just after (the counted kernels
   launched, the while-loop matching never, no plain call) and again with
   each launch timed: (a) `GangScheduler` on phase 4's fit cluster and on
   4e's affinity cluster (config #3), placements equal to the dynamic runs
   at equal `inner_iters`, rounds one fewer; (b) the fit cluster at
   `static_rounds=4` (resumed passes), the same placements; (c)
   `GangSweep` of 8 of config #4's variants against the dynamic sweep of
   the same 8; (d) `FaultSweep` of 4k(a)'s 256 masks, every scenario inside
   the budget: 4k(a)'s profile; (e) `FaultSweep` of 4k(b)'s 8 scenarios at
   fail_prob 0.1, at the default budget (every pod of the cluster counts in
   ceil(P/N) + 4) and at a budget of 2 set after construction, which strands
   pods the dynamic sweep places (each placed pod where the dynamic sweep
   put it), the latter held whole against the plain versions in the three
   workers (4h). Each prints rounds progressed against
   slots launched, readbacks against the dynamic run's, wall and device ms
   by kernel;
4m. the PACKED policy at full width, each run with the counters set to 0
   just before and read just after (one `pack_widen` a pass, no plain
   call): (a) the fit, affinity and default cells (phases 4, 4b and 4c's
   clusters) through `encode_cluster(policy=PACKED)`, the pass and the
   decode of the sampled pods, each byte-equal to its TPU32 run (trace,
   final state, placements, annotations), with the planes bit-packed and
   narrowed, the encoding's bytes, peak memory and the encode / pass /
   decode split under both policies; (b) the fit cell's gang on (a)'s
   encoding: rounds, state and placements 4l(a)'s dynamic TPU32 gang's;
   (c) 4d's first 5 serving passes again on a service
   under `KSS_DTYPE_POLICY=packed`: passes 2-4 delta passes that launch
   K10's 2-byte set, every pass's records 4d's, the fifth after a flip to
   TPU32 (a full encode, one `encodePolicyMisses`);
4n. the demo plugins at full width, annotated by `synth.annotate_bandwidth`
   (seed 7), each pass through the entry points `schedule()` composes with
   the counters set to 0 just before and read just after (`seq_run`, no
   plain call; at least a tenth of the pods carry NetworkBandwidth's filter
   message): (a) phase 4's fit cell under `fit_config()` plus both plugins,
   TPU32 (its whole pass held against the plain version in the second
   worker, 4h) and PACKED (byte-equal to TPU32's run); (b)
   `preemption_cluster(1024, 2500, seed=7)` under `kp.demo_config()`: the
   pass, the 64-step segment with the fewest dry runs among those holding 4
   nominations run again from the kernel pass's state and held against the
   plain version on the card, and the single-pod step path over it. Each
   prints its wall (encode, pass, decode), decisions/s, peak memory, dry
   runs and nominations, and the pods carrying the filter message;
4o. the fleet & memory observatory on a `SimulatorService` at 4d's
   cluster (1,024 nodes, 10,000 bound, TPU32) with a `FleetRecorder`
   armed, each pass with the counters set to 0 just before and read just
   after (one `fleet_quality` launch, no plain call): 4d's first three
   passes replayed (the snapshot's 128 pending; 128 arrivals, a cordon and
   an uncordon each), their records 4d's, which ran with stats off; 4d's
   fourth pass's events and one `schedule_gang(record=False)`, its
   placements a stats-off `GangScheduler`'s over a from-scratch encode.
   Each sample's K12 buffer held against the plain version on the card
   over the same tensors, its fields against the buffer, the card's memory
   fields present, its host split timed (the launch, the readback, the
   pending ages, the census). Then a batch window of 2 tenants with stats
   on and `KSS_TRACE` armed: one `batch_run`, one `fleet_quality` a tenant,
   each tenant's sample under its session, balanced nesting, each tenant's
   `pass.sequential`, `pass.encode`, `device.execute` and `batch.enroll`
   with its pass id, `batch.execute` and the five counter tracks;
4h. the plain processes' versions: phase 3's whole gang pass and gang
   sweep (state, rounds, records; assignments, rounds, states, phases);
   phase 3's sweeps (every
   variant's trace, victims, state and selections), phases 4's, 4b's and
   4n(a)'s passes (trace, state, placements, sampled annotations), phase 4c's
   segment (trace, victims, state; its plain version on the card), config
   #4's variant 0 and first sampled variant (state and selections), and
   tenant 0 of each phase-4j
   cluster run through its session with the plain versions (records,
   state, trace, rounds, placements, pods), and phase 4k(b)'s sweep, each
   after checking that both processes encoded the same inputs;
5. kernel times on all paths (CUDA events; the per-pod kernels replayed
   from a CUDA graph so host enqueue time is not counted, at the state
   half-way through the queue; the default path's `seq_run` on its plain
   segment, `seq_preempt` and `seq_evict` on the first nominating step
   past the middle, each first held against its plain version there), the
   plain versions' times (on the card, except the fit and affinity
   `seq_run` rows' and K11's: the second process's on the host CPU, marked
   by `plain_basis`) and each kernel's bound, printed as one JSON line
   with a `path` field per entry; 5b: each plugin body alone inside
   `seq_attempt` (the first slice's on the fit path's cluster, the
   second's on the affinity path's, the volume family's on the default
   path's); 5c: the K10 kernels at the real dirty lists of
   serving delta passes (set and add: pass 5's calls; vector add: pass
   2's, the pass that replays the claim pods' binds), beside their plain
   versions and the one PyTorch call that computes each; 5d: K9 at round 1
   of the full-width default gang (`torch.topk` and `index_add_` as the
   library calls of top-k and bind); 5e: K11 at config #4's shape (the
   plain time is variant 0's plain pass on the host CPU: one variant, not
   V; V times it is printed as an estimate); 5f: the K9 kernels at round
   1 of 4i's 128 variants (`torch.topk` on [V Q, N], `index_add_` on the
   stacked planes) and the segmented `sweep_run` of 4i's first preempt
   phase (its time from that launch), each held against its plain version
   first (gang_eval on 8 rows of two variants, the matching on 8 variants,
   the phase on its first 8 steps of each segment); 5g: the batch plane's
   tenant forms at their launches in phase 4j (`batch_run` at the
   preempting sequential window, `batch_eval`, `batch_match` and
   `batch_bind` at round 1 of the serving gang window, `batch_seg` at the
   preempting gang window's first phase), each first held against its
   plain version; 5h: the fault sweep's kernels at phase 4k(a)'s shapes,
   launched again from the inputs 4k kept: the baseline's `gang_bind`,
   `fault_evict` and `fault_tally` over all 256 scenarios, and round 1's
   launches of the tenant forms over the scenario table, each first held
   against its plain version (`((a >= 0) & m).sum(1)`, `torch.topk` and
   `index_add_` as the library calls); 5i: `gang_match_counted` at 4l(a)'s
   round 1, `batch_match_counted` at 4l(d)'s, `gang_advance` at both, each
   first held against its plain version (the counted sel also against the
   while-loop matching's, whose time on the same inputs is printed beside);
   5j: `pack_widen` on 4m(a)'s three PACKED encodings, held bit for bit
   against its plain version on the card over every leaf, then timed (a
   CUDA graph of its launch), beside `.to(torch.int32)` over the narrow
   leaves; K10's 2-byte set at 4m(c)'s recorded calls; 5k: each demo
   plugin body alone inside `seq_attempt` at 4n(a)'s mid-queue state
   (NetworkBandwidth's filter, its score with its normalize, NodeNumber's
   score), beside NetworkBandwidth's allocated sum as one
   `torch.zeros(N).index_add_` call, `seq_preempt` with NetworkBandwidth's
   row at 4n(b)'s first nominating step past the middle, and 4n's passes;
   5l: `fleet_quality` at 4o's serving state and at config #5's shape
   (5,000 nodes x 50,000 pods, a seeded synthetic state), each first held
   against its plain version on the card (bins, pending, max exact; mean
   and fragmentation within 1e-5), beside the plain version's time;
6. the card's name and power limit, then the result line.

Each phase prints its seconds. It runs in 13 to 16 minutes on an H100, the
build included (the host's speed varies most).
It imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import functools
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# the whole run, build included, stays inside 1,200 s
TIME_LIMIT_S = 1100
# the default path's phase-3 queue (the plain pass runs every dry run in
# small PyTorch launches) and its plain segment at full width
DEFAULT_PHASE3_PENDING = 300
SEGMENT = 1024
# K11: BASELINE config #4 (phase 4g), a Monte-Carlo sweep of score weights:
# 1,000 variants of a 1,024-node cluster with 10,000 pending pods; phase 3's
# sweep holds three variants against the plain version
SWEEP_VARIANTS = 1000
SWEEP_NODES, SWEEP_PODS, SWEEP_SEED = 1024, 10000, 42
PHASE3_VARIANTS = 3
# the gang weight sweep (phase 4i): config #4's cluster with 128 variants, and
# the default path's preempting cluster with four
GANGSWEEP_VARIANTS = 128
GANGSWEEP_PREEMPT_VARIANTS = 4
# phase 5f's plain checks: the matching of this many variants, the first steps
# of each variant's preempt segment
MATCH_PLAIN_VARIANTS = 8
PHASE_PLAIN_STEPS = 8
# the batch plane (phase 4j): tenants of the serving cluster in one window,
# tenants of the preemption cluster with this many pending pods each (each
# tenant's full encode and decode is host work on the main thread: 4 and 2
# tenants, from 8 and 4, made room for phase 4n; 3 serving tenants, from 4,
# for phase 4o)
BATCH_TENANTS = 3
BATCH_PREEMPT_TENANTS = 2
BATCH_PREEMPT_NODES, BATCH_PREEMPT_PENDING = 1024, 128
# the preempting gang window's tenants (each pass after (b) is a full encode,
# the costliest host step of the phase)
BATCH_PREEMPT_GANG = 2
# the fault sweep (phase 4k): (a) docs/lifecycle.md's example, 256 scenarios
# at fail_prob 0.05 of phase 4's cluster, phase 4's placements the baseline;
# (b) 8 scenarios of phase 3's default cluster, its kernel pass's placements
# the baseline, at fail_prob 0.1 on the card alone and at 0.02 held whole
# against the plain sweep, which two workers share (their result's name ->
# its scenarios; worker c is idle sooner and takes the costlier two). At 0.1
# that plain sweep (558-1,171 evicted pods and 22-50 rounds a scenario on the
# card) does not end inside the time limit; at 0.02 a scenario evicts 73-469
FAULT_SCENARIOS, FAULT_SEED, FAULT_PROB = 256, 7, 0.05
FAULT3_SCENARIOS, FAULT3_SEED, FAULT3_PROB, FAULT3_CARD_PROB = 8, 11, 0.02, 0.1
FAULT3_PARTS = {"fault3_c": (0, 2), "fault3_b": (2, 8)}
# the counted loops (phase 4l): 4l(b)'s budget, below the fit cluster's
# fixpoint so that its passes resume; 4l(c)'s variants, the first of 4i(a)'s;
# 4l(e)'s counted sweep at FAULT3_CARD_PROB, at the default budget (ceil(P /
# N) + 4 with every pod of the cluster in P) on the card alone, then at a
# budget of FAULT4L_BUDGET set after construction (far below the 22-50
# dynamic rounds a scenario there), held whole against the plain versions in
# the three workers (their result's name -> its scenarios; each slot
# evaluates every pending pod, so a share costs about its scenarios' evicted
# pods, and each worker takes the share that ends it about when the others
# end)
COUNTED_BUDGET = 4
COUNTED_SWEEP_VARIANTS = 8
FAULT4L_BUDGET = 2
FAULT4L_PARTS = {"fault4l_c": (0, 5), "fault4l_b": (5, 7), "fault4l_a": (7, 8)}
# the demo out-of-tree plugins (phases 3, 4n, 5k): 4n(b)'s queue on config
# #2's 1,024 nodes, a quarter of the default cell's (its encode and its dry
# runs are main-thread time), and its segment held against the plain version
# on the card (at least PLUGINS_NOMINATIONS nominations, the fewest dry runs)
PLUGINS_NODES, PLUGINS_PENDING = 1024, 2500
PLUGINS_SEGMENT, PLUGINS_NOMINATIONS = 64, 4
# NodeNumber's reverse arg changes its score only: phase 3 runs that
# configuration under TPU32, without the dry-run checks
TPU32_ONLY = {"plugins-rev"}
# the plain versions of whole passes run on the host CPU in a second process
# (`plain_worker`), beside the card's phases; their results come back here
PLAIN_DIR = Path(__file__).resolve().parent / "build" / "smoke"
PLAIN_THREADS = 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
SOURCE = "kube_scheduler_simulator_tpu_torch/csrc/seq_kernels.cu"
REPLACES = {
    "seq_attempt": "kube_scheduler_simulator_tpu/engine/engine.py:404",
    "seq_bind": "kube_scheduler_simulator_tpu/engine/engine.py:466",
    "seq_run": "kube_scheduler_simulator_tpu/engine/engine.py:657",
    "seq_preempt": "kube_scheduler_simulator_tpu/engine/preempt.py:399",
    "seq_evict": "kube_scheduler_simulator_tpu/engine/engine.py:507",
    "delta_scatter_set": "kube_scheduler_simulator_tpu/engine/delta.py:183",
    "delta_scatter_add": "kube_scheduler_simulator_tpu/engine/delta.py:188",
    "delta_vec_add": "kube_scheduler_simulator_tpu/engine/delta.py:193",
    "gang_eval": "kube_scheduler_simulator_tpu/engine/gang.py:520",
    "gang_topk": "kube_scheduler_simulator_tpu/engine/gang.py:859",
    "gang_match": "kube_scheduler_simulator_tpu/engine/gang.py:740",
    "gang_bind": "kube_scheduler_simulator_tpu/engine/gang.py:641",
    "sweep_run": "kube_scheduler_simulator_tpu/parallel/sweep.py:113",
    "gangsweep.vrun": "kube_scheduler_simulator_tpu/parallel/sweep.py:325",
    "gangsweep.vphase": "kube_scheduler_simulator_tpu/parallel/sweep.py:334",
    "batch.seq.run": "kube_scheduler_simulator_tpu/server/batchplane.py:94",
    "batch.gang.run": "kube_scheduler_simulator_tpu/server/batchplane.py:95",
    "faultsweep.vrun": "kube_scheduler_simulator_tpu/lifecycle/faultsweep.py:107",
    "faultsweep.bind_all": "kube_scheduler_simulator_tpu/lifecycle/faultsweep.py:167",
    # the demo plugins' bodies (inside seq_attempt / seq_run) and row (seq_preempt)
    "filter NetworkBandwidth": "kube_scheduler_simulator_tpu/plugins/networkbandwidth.py:131",
    "score NetworkBandwidth": "kube_scheduler_simulator_tpu/plugins/networkbandwidth.py:158",
    "score NodeNumber": "kube_scheduler_simulator_tpu/plugins/nodenumber.py:53",
    "row NetworkBandwidth": "kube_scheduler_simulator_tpu/plugins/networkbandwidth.py:196",
}
GANG_SOURCE = "kube_scheduler_simulator_tpu_torch/csrc/gang_kernels.cu"
GANG_KERNELS = ("gang_eval", "gang_topk", "gang_match", "gang_bind")


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_report(text):
    """One line per kernel from nvcc's -Xptxas -v output: registers, stack,
    spills."""
    import re

    types = {"i": "int32", "x": "int64", "l": "int64", "h": "uint8", "t": "uint16",
             "j": "uint32", "m": "uint64"}
    out, name, props = [], None, ""
    for ln in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?_Z\w*?"
                      r"(seq_(?:attempt|bind|run|preempt|evict)_kernel|sweep_(?:run|seg)_kernel|"
                      r"gang_(?:eval|topk|match_counted|match|bind)_kernel|scatter_set_kernel|"
                      r"scatter_add_kernel|vec_add_kernel|fault_evict_kernel)I([ixlhtjm])"
                      r"((?:Lb[01]E)*)", ln)
        untyped = re.search(r"(?:Compiling entry function|Function properties for) '?_Z\w*?"
                            r"(fault_tally_kernel|gang_advance_kernel|pack_widen_kernel)E", ln)
        if untyped:
            name = untyped.group(1)
        elif m:
            # the template's bool arguments (PRE, SKIP, STACK, TEN) as 0/1
            flags = "".join(f", {b}" for b in re.findall(r"Lb([01])E", m.group(3)))
            name = f"{m.group(1)}<{types[m.group(2)]}{flags}>"
        elif "spill" in ln:
            props = ln.strip()
        elif "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {props}")
            name, props = None, ""
    # a report whose names this parser does not know is shown as it is
    return out or [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]


def dressed_cluster(kp, n_nodes, n_pods, seed):
    """The port's synthetic cluster with every code path of the slice in
    it: NoSchedule taints on every 7th node, PreferNoSchedule on every 11th,
    NoExecute on every 13th, cordoned nodes, ephemeral storage, tolerations
    on every 5th pod, pods pinned to an existing node (pre-bound) or to a
    missing one, and pods too large for any node."""
    nodes, pods = kp.synthetic_cluster(n_nodes, n_pods, seed=seed, priorities=True)
    for i, nd in enumerate(nodes):
        taints = []
        if i % 7 == 0:
            taints.append({"key": "dedicated", "value": "gpu", "effect": "NoSchedule"})
        if i % 11 == 0:
            taints.append({"key": "spot", "value": "true", "effect": "PreferNoSchedule"})
        if i % 13 == 4:
            taints.append({"key": "maint", "effect": "NoExecute"})
        nd["spec"] = {"taints": taints} if taints else {}
        if i % 17 == 6:
            nd["spec"]["unschedulable"] = True
        if i % 3 == 1:
            nd["status"]["allocatable"]["ephemeral-storage"] = f"{20 + i % 50}Gi"
    for j, pd in enumerate(pods):
        spec = pd["spec"]
        req = spec["containers"][0]["resources"]["requests"]
        if j % 5 == 0:
            spec["tolerations"] = [
                {"key": "dedicated", "operator": "Equal", "value": "gpu", "effect": "NoSchedule"},
                {"key": "spot", "operator": "Exists"},
            ]
        if j % 35 == 7:
            spec["tolerations"] = [{"operator": "Exists"}]
        if j % 37 == 3:
            spec["nodeName"] = nodes[(j * 7) % len(nodes)]["metadata"]["name"]
        if j % 41 == 5:
            spec["nodeName"] = "missing-node"
        if j % 97 == 11:
            req.update({"cpu": "200", "memory": "2Ti"})
        if j % 6 == 1:
            req["ephemeral-storage"] = f"{1 + j % 9}Gi"
    return nodes, pods


def configs(kp):
    """The fit path's configuration, and two that reach the other
    NodeResourcesFit strategies and BalancedAllocation's 3-resource branch
    (the float32 branch under TPU32)."""
    from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration

    plugins = kp.fit_config().to_dict()["profiles"][0]["plugins"]
    three = [{"name": r, "weight": 1} for r in ("cpu", "memory", "ephemeral-storage")]

    def with_args(fit_strategy):
        return SchedulerConfiguration.from_dict({"profiles": [{
            "schedulerName": "default-scheduler",
            "plugins": plugins,
            "pluginConfig": [
                {"name": "NodeResourcesFit", "args": {"scoringStrategy": fit_strategy}},
                {"name": "NodeResourcesBalancedAllocation", "args": {"resources": three}},
            ],
        }]})

    return {
        "fit": kp.fit_config(),
        "most-3": with_args({"type": "MostAllocated", "resources": [
            {"name": "cpu", "weight": 2}, {"name": "memory", "weight": 1},
            {"name": "example.com/absent", "weight": 1}]}),
        "rtcr-3": with_args({"type": "RequestedToCapacityRatio", "resources": three,
                             "requestedToCapacityRatio": {"shape": [
                                 {"utilization": 0, "score": 10},
                                 {"utilization": 40, "score": 6},
                                 {"utilization": 100, "score": 1}]}}),
    }


STATE_FIELDS = ("requested", "s_requested", "n_pods", "assignment", "used_pair",
                "used_wild", "used_trip", "used_claims", "node_disk_any", "node_disk_rw",
                "node_vol3", "bound_seq")
ATTEMPT_OUT = ("codes", "raw", "final", "sel", "pf_codes")


class Diff:
    """Exact comparison of kernel and plain outputs; keeps the largest
    absolute difference seen per (path, kernel)."""

    def __init__(self):
        self.err = {}

    def check(self, path, kernel, what, got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{path} {kernel} {what}: {got.dtype}{tuple(got.shape)} "
                                 f"vs plain {want.dtype}{tuple(want.shape)}")
        err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        self.err[path, kernel] = max(self.err.get((path, kernel), 0.0), err)
        if not torch.equal(got, want):
            raise AssertionError(
                f"{path} {kernel} {what}: kernel differs from plain (max |d| {err})")


def random_state(enc, rng, bind):
    """A node state with usage up to 130% of capacity and pod counts about
    the 110-pod limit (what the pass reaches only partly). `bind`: port
    counters of 0..2 users, and about half of the pending pods bound,
    mostly to the first third of the nodes (skewed topology counts)."""
    alloc = enc.arrays.node_alloc.cpu().numpy()
    dt, dev = alloc.dtype, enc.device
    req = np.floor(alloc * rng.uniform(0.0, 1.3, alloc.shape)).astype(dt)
    sreq = np.floor(alloc * rng.uniform(0.0, 1.3, alloc.shape)).astype(dt)
    n_pods = rng.integers(0, 112, alloc.shape[0]).astype(np.int32)
    st = enc.state0.clone()
    st.requested = torch.as_tensor(req, device=dev)
    st.s_requested = torch.as_tensor(sreq, device=dev)
    st.n_pods = torch.as_tensor(n_pods, device=dev)
    if bind:
        for f in ("used_pair", "used_wild", "used_trip"):
            setattr(st, f, torch.as_tensor(rng.integers(0, 3, tuple(getattr(st, f).shape)),
                                           dtype=torch.int32, device=dev))
        assignment = enc.state0.assignment.cpu().numpy().copy()
        free = (assignment < 0) & (rng.random(assignment.shape) < 0.5)
        free[enc.n_pods:] = False
        hi = np.where(rng.random(int(free.sum())) < 0.8, max(1, enc.n_nodes // 3), enc.n_nodes)
        assignment[free] = rng.integers(0, hi)
        st.assignment = torch.as_tensor(assignment, device=dev)
    return st


def slots(prog):
    """The trace slots of this program's `seq_run`."""
    from kube_scheduler_simulator_tpu_torch.engine import cuda

    return cuda.TRACE_SLOTS_PREEMPT if prog.preempt is not None else cuda.TRACE_SLOTS_PLAIN


def demo_plugins():
    """Register the demo out-of-tree plugins, as a user does: by importing
    their modules."""
    import kube_scheduler_simulator_tpu_torch.plugins.networkbandwidth  # noqa: F401
    import kube_scheduler_simulator_tpu_torch.plugins.nodenumber  # noqa: F401


def plugins_cluster(kp, n_nodes, n_pending, seed=11):
    """The dressed default cluster annotated for NetworkBandwidth
    (`synth.annotate_bandwidth`, seed 7): (nodes, pods, objects)."""
    from kube_scheduler_simulator_tpu_torch.synth import annotate_bandwidth, dressed_default_cluster

    nodes, pods, objects = dressed_default_cluster(n_nodes, n_pending, seed=seed)
    annotate_bandwidth(nodes, pods, seed=7)
    return nodes, pods, objects


def phase3_workloads(kp):
    """Phase 3's clusters by path: (nodes, pods, {name: configuration},
    bind random states, the encoder's extra objects). The plugins path:
    the default cluster annotated, under the default profile plus both
    demo plugins (16 filters, 9 scores), and with NodeNumber's reverse arg."""
    from kube_scheduler_simulator_tpu_torch.synth import (
        DRESSED_NAMESPACES,
        dressed_affinity_cluster,
        dressed_default_cluster,
    )

    demo_plugins()
    nodes, pods = dressed_cluster(kp, 256, 2000, seed=11)
    an, ap = dressed_affinity_cluster(256, 2000, seed=11)
    dn, dp, objects = dressed_default_cluster(256, DEFAULT_PHASE3_PENDING, seed=11)
    pn, pp, pobj = plugins_cluster(kp, 256, DEFAULT_PHASE3_PENDING)
    return {
        "fit": (nodes, pods, configs(kp), False, {}),
        "affinity": (an, ap, {"affinity": kp.affinity_config()}, True,
                     {"namespaces": DRESSED_NAMESPACES}),
        "default": (dn, dp, {"default": kp.supported_config()}, True, objects),
        "plugins": (pn, pp, {"plugins": kp.demo_config(),
                             "plugins-rev": kp.demo_config(reverse=True)}, True, pobj),
    }


def phase3_cases(kp, cfgs):
    """(policy, configuration name, configuration) of a phase-3 path: each
    under TPU32 and EXACT, those of TPU32_ONLY under TPU32."""
    return [(pol, cname, cfg) for pol in (kp.TPU32, kp.EXACT) for cname, cfg in cfgs.items()
            if pol is kp.TPU32 or cname not in TPU32_ONLY]


def nb_rejections(eng, codes):
    """Steps whose pod carries NetworkBandwidth's filter message: on some
    real node every filter before it passes and it fails (codes [Q, N, F])."""
    j = eng.program.filter_names.index("NetworkBandwidth")
    c = codes[:, :eng.enc.n_nodes]
    return int(((c[..., j] != 0) & (c[..., :j] == 0).all(dim=-1)).any(dim=1).sum())


def compare_kernels(kp, cuda, diff, path, nodes, pods, cfgs, bind, objects=None):
    """Phase 3: every kernel against its plain version, exact, for each
    configuration in `cfgs` under TPU32 and EXACT. With DefaultPreemption
    enabled, `seq_preempt` and `seq_evict` at 64 random states too. The
    whole pass's plain version runs in the fourth process: returns, by
    (path, policy, configuration), what phase 4h holds against it
    (`check_plain_passes`): the encoding's digest, the kernel pass's trace
    and final state, its unrecorded selections and state, and with
    DefaultPreemption its decoded records (victim lists included)."""
    objects = objects or {}
    runs = {}
    for pol, cname, cfg in phase3_cases(kp, cfgs):
        enc = kp.encode_cluster(nodes, pods, cfg, policy=pol, **objects)
        eng = kp.BatchedScheduler(enc)
        prog, a, w = eng.program, enc.arrays, eng.weights
        rng = np.random.default_rng(3)
        for k in range(4):
            st = random_state(enc, rng, bind)
            for qi, p in enumerate(rng.choice(enc.n_pods, 16, replace=False).tolist()):
                got = cuda.seq_attempt(prog, a, st, w, p)
                want = cuda.seq_attempt_plain(prog, a, st, w, p)
                for name, g, h in zip(ATTEMPT_OUT, got, want):
                    diff.check(path, "seq_attempt", f"{pol.name}/{cname} pod {p} {name}",
                               g, h)
                # bind the selection, an unschedulable pick, and a padding step
                for pp, sel in ((p, got[3]), (p, torch.full_like(got[3], -1)),
                                (-1, got[3])):
                    s1 = cuda.seq_bind(prog, a, st.clone(), pp, sel, qi + 16 * k)
                    s2 = cuda.seq_bind_plain(prog, a, st.clone(), pp, sel, qi + 16 * k)
                    for f in STATE_FIELDS:
                        diff.check(path, "seq_bind", f"{pol.name}/{cname} pod {pp} {f}",
                                   getattr(s1, f), getattr(s2, f))
        nominated = 0
        if prog.preempt is not None and cname not in TPU32_ONLY:
            for k in range(16):
                st = random_state(enc, rng, bind)
                for p in rng.choice(enc.n_pods, 4, replace=False).tolist():
                    got = cuda.seq_preempt(prog, a, st, p)
                    want = cuda.seq_preempt_plain(prog, a, st, p)
                    for name, g, h in zip(("pcode", "voff", "vidx", "nominated"), got, want):
                        diff.check(path, "seq_preempt", f"{pol.name} pod {p} {name}", g, h)
                    nominated += int(got[3]) >= 0
                    mask = (st.assignment >= 0) & torch.as_tensor(
                        rng.random(enc.P) < 0.3, device=enc.device)
                    s1 = cuda.seq_evict(prog, a, st.clone(), mask)
                    s2 = cuda.seq_evict_plain(prog, a, st.clone(), mask)
                    for f in STATE_FIELDS:
                        diff.check(path, "seq_evict", f"{pol.name} state {f}",
                                   getattr(s1, f), getattr(s2, f))
        queue = padded_queue(eng)
        s_k, t_k = cuda.seq_run(prog, a, enc.state0, queue, w, record=True)
        s_n, sel_n = cuda.seq_run(prog, a, enc.state0, queue, w, record=False)
        run = dict(digest=encoding_digest(enc), state=s_k, trace=t_k, unrecorded=(s_n, sel_n),
                   slots=slots(prog))
        extra = ""
        if prog.preempt is not None:
            eng._final_state, eng._trace = s_k, t_k
            run["records"] = [r.to_annotations() for r in eng.results()]
            run["placements"] = eng.placements()  # 4k(b)'s baseline
            did = t_k[slots(prog).index("did")]
            noms = t_k[slots(prog).index("nominated")]
            extra = (f"; 64 dry runs ({nominated} nominating) and 64 evictions at random "
                     f"states" if cname not in TPU32_ONLY else "") + (
                f"; the pass fired {int(did.sum())} dry runs, "
                f"{int((noms >= 0).sum())} nominating")
        if "NetworkBandwidth" in prog.filter_names:
            n_nb = nb_rejections(eng, t_k[1][: len(enc.queue)])
            if n_nb == 0 or (len(prog.filter_names), len(prog.score_names)) != (16, 9):
                raise AssertionError(f"{path} {cname}: {len(prog.filter_names)} filters, "
                                     f"{len(prog.score_names)} scores, {n_nb} pods with "
                                     "NetworkBandwidth's filter message")
            extra += f"; {n_nb} pods carry NetworkBandwidth's filter message"
        runs[path, pol.name, cname] = run
        placed = int((s_k.assignment >= 0).sum()) - int((enc.state0.assignment >= 0).sum())
        codes = t_k[1][: len(enc.queue)]
        seen = [sorted(set(codes[:, :, f].unique().tolist())) for f in range(codes.shape[2])]
        log(f"  {path:8s} {pol.name:5s} {cname:7s}: 64 attempts and 192 binds equal to "
            f"plain, a {len(queue)}-step pass ({placed} of {len(enc.queue)} pending pods "
            f"placed; filter codes seen {seen}){extra}; its plain version in the fourth "
            "process (4h)")
    return runs


def plain_passes(kp, cuda):
    """The fourth process's part: phase 3's whole passes through the plain
    versions on the host CPU, each path, policy and configuration (trace,
    final state, and with DefaultPreemption the decoded records)."""
    cpu = torch.device("cpu")
    out = {}
    for path, (nodes, pods, cfgs, _, objects) in phase3_workloads(kp).items():
        for pol, cname, cfg in phase3_cases(kp, cfgs):
            enc = kp.encode_cluster(nodes, pods, cfg, policy=pol, device=cpu, **objects)
            eng = kp.BatchedScheduler(enc, device=cpu)
            t0 = time.perf_counter()
            s_p, t_p = cuda.seq_run_plain(eng.program, enc.arrays, enc.state0,
                                          padded_queue(eng), eng.weights, record=True)
            run = dict(digest=encoding_digest(enc), state=_state_dict(s_p), trace=t_p,
                       seconds=time.perf_counter() - t0)
            if eng.program.preempt is not None:
                eng._final_state, eng._trace = s_p, t_p
                run["records"] = [r.to_annotations() for r in eng.results()]
            out[path, pol.name, cname] = run
    return out


def check_plain_passes(cuda, diff, runs, plain):
    """Phase 4h for phase 3's whole passes: each kernel pass's trace, final
    state, unrecorded selections and state, and records against the plain
    versions' run of the same encoding in the fourth process."""
    secs = 0.0
    for key, run in runs.items():
        path, pol, cname = key
        want = plain[key]
        if want["digest"] != run["digest"]:
            raise AssertionError(f"phase 3 {key}: the fourth process encoded other inputs")
        dev = run["state"].assignment.device
        t_p = [x.to(dev) for x in want["trace"]]
        for name, g, h in zip(run["slots"], run["trace"], t_p):
            diff.check(path, "seq_run", f"{pol}/{cname} {name}", g, h)
        for f in STATE_FIELDS:
            diff.check(path, "seq_run", f"{pol}/{cname} state {f}", getattr(run["state"], f),
                       want["state"][f].to(dev))
        s_n, sel_n = run["unrecorded"]
        final_sel = t_p[run["slots"].index("final_sel" if "records" in run else "sel")]
        diff.check(path, "seq_run", f"{pol}/{cname} unrecorded sel", sel_n, final_sel)
        diff.check(path, "seq_run", f"{pol}/{cname} unrecorded assignment", s_n.assignment,
                   want["state"]["assignment"].to(dev))
        if run.get("records") != want.get("records"):
            raise AssertionError(f"phase 3 {key}: decoded records differ")
        secs += want["seconds"]
    log(f"    phase 3's {len(runs)} whole passes (fit, affinity, default, plugins; TPU32 and "
        f"EXACT): traces, final states, unrecorded selections and the preempting paths' "
        f"records equal the plain versions' (host CPU, {secs:.3f} s in all)")


def padded_queue(eng):
    """The engine's queue padded to its bucket with -1, on its device."""
    q = eng.enc.queue
    return torch.as_tensor(np.concatenate([q, np.full(eng.queue_bucket(len(q)) - len(q), -1)])
                           .astype(np.int32), device=eng.device)


def events_ms(fn, iters, reps=5):
    """Median over `reps` of the mean time of `iters` calls of fn, from
    CUDA events."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / iters)
    return statistics.median(out)


def graph_ms(fn, iters=100, reps=5):
    """Median device time of one call of fn, from a CUDA graph of `iters`
    calls replayed between events: the host's enqueue time is not in it."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    return events_ms(g.replay, 1, reps) / iters


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def ops_per_node(enc, prog):
    """A rough count of the integer operations one attempt does per node,
    read off the kernel's code for this configuration (each compare, add,
    multiply or divide counts one)."""
    from kube_scheduler_simulator_tpu_torch.engine import kernels as K

    a, rel = enc.arrays, enc.arrays.rel
    T, L, R = a.taint_key.shape[1], a.tol_key.shape[1], enc.R
    K_, HC, SC = a.label_val.shape[1], rel.sph_key.shape[1], rel.sps_key.shape[1]
    taint = T * (3 + 8 * L)
    _, TM, E, VV = a.raff_vals.shape
    affinity = 3 * a.nsel_key.shape[1] + TM * E * (VV + 6)
    n_disks = int((a.pod_disk_any > 0).sum(dim=1).max()) if a.pod_disk_any.numel() else 0
    per_filter = {"NodeUnschedulable": 3, "NodeName": 3, "TaintToleration": taint,
                  "NodeResourcesFit": 4 + 6 * R, "NodeAffinity": 2,
                  "NodePorts": 2 * a.want_wild.shape[1] + 4 * a.want_trip.shape[1],
                  "PodTopologySpread": 8 * HC,
                  "InterPodAffinity": 3 * K_ + 4 * rel.ian_key.shape[1] + 6 * rel.ia_key.shape[1],
                  "VolumeRestrictions": 2 + 5 * n_disks, "EBSLimits": 4, "GCEPDLimits": 4,
                  "AzureDiskLimits": 4, "NodeVolumeLimits": 1, "VolumeBinding": 3,
                  "VolumeZone": 3, "NetworkBandwidth": 5}
    per_score = {"NodeResourcesFit": 12 * len(K.fit_score_args(enc)[1]) + 4,
                 "NodeResourcesBalancedAllocation": 45 * len(K.balanced_resources(enc)) + 20,
                 "TaintToleration": taint,
                 "NodeAffinity": a.paff_vals.shape[1] * E * (VV + 6),
                 "ImageLocality": 3 * a.pod_img.shape[1] + 20,
                 "PodTopologySpread": 14 * SC + 10, "InterPodAffinity": 3 * K_,
                 "NetworkBandwidth": 3, "NodeNumber": 5}
    normalize_select = 10 * len(prog.score_names) + 8
    # the relational node phases: NodeAffinity per node, pair aggregation,
    # the spread score's prologue
    rel_node = 0
    if {"NodeAffinity", "PodTopologySpread"} & set(prog.filter_names + prog.score_names):
        rel_node = affinity + 6 * (HC + SC)
    return (sum(per_filter[n] for n in prog.filter_names)
            + sum(per_score[n] for n in prog.score_names) + normalize_select + rel_node)


def bound(bytes_moved, ops):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def cluster_bytes(enc):
    """Every plane the kernels read, each once."""
    import dataclasses

    a = enc.arrays
    return (nbytes(*(getattr(a, f.name) for f in dataclasses.fields(a) if f.name != "rel"))
            + nbytes(*(getattr(a.rel, f.name) for f in dataclasses.fields(a.rel))))


# planes and state indexed by node (or by neither axis), read whole; of the
# others, indexed by pod, an attempt reads the step pod's row
NODE_PLANES = {"node_alloc", "node_unsched", "node_mask", "taint_key", "taint_val",
               "taint_effect", "label_val", "label_num", "label_num_ok", "trip_pair",
               "img_contrib", "node_pair", "spread_lut", "requested", "s_requested",
               "n_pods", "used_pair", "used_wild", "used_trip", "used_claims", "node_vol3",
               "nb_limit", "nb_has", "nn_node"}
# planes an attempt reads one column of, [N, ·]: one 32-byte sector a node
COLUMN_PLANES = {"vb_code", "vz_code"}
LABELS = ("label_val", "label_num", "label_num_ok")
NODE_AFFINITY = ("nsel_key", "nsel_val", "pod_has_raff", "raff_key", "raff_op", "raff_vals",
                 "raff_num", "raff_num_ok", "raff_term_valid")
TAINTS = ("taint_key", "taint_val", "taint_effect", "tol_key", "tol_val", "tol_effect",
          "tol_op")
FLAG = {"sph": "sph_self", "sps": "sps_host", "ia": "ia_self"}


def domain(d):
    """The planes of relational term domain d."""
    return tuple(f"{d}_{m}" for m in ("key", "ctype", "ckey", "cpairs", "skew", "nsall", "ns",
                                      "weight")) + ((FLAG[d],) if d in FLAG else ())


# What each plugin reads in the kernel (csrc/seq_kernels.cu filter_code,
# score_raw and the node phases), besides the other pods' relational rows
# that `rel_reads` counts. The spread plugins run the NodeAffinity body.
READS = {
    ("filter", "NodeUnschedulable"): ("node_unsched", "pod_tol_unsched"),
    ("filter", "NodeName"): ("pod_node_name",),
    ("filter", "TaintToleration"): TAINTS,
    ("filter", "NodeResourcesFit"): ("node_alloc", "requested", "n_pods", "pod_req",
                                     "pod_req_rank"),
    ("filter", "NodeAffinity"): LABELS + NODE_AFFINITY,
    ("filter", "NodePorts"): ("used_pair", "used_wild", "used_trip", "trip_pair", "want_wild",
                              "want_trip"),
    ("filter", "PodTopologySpread"): LABELS + NODE_AFFINITY + ("node_pair", "ns_id")
    + domain("sph"),
    ("filter", "InterPodAffinity"): ("node_pair", "ns_id") + domain("ia") + domain("ian"),
    ("score", "NodeResourcesFit"): ("node_alloc", "s_requested", "pod_sreq"),
    ("score", "NodeResourcesBalancedAllocation"): ("node_alloc", "s_requested", "pod_sreq"),
    ("score", "TaintToleration"): TAINTS,
    ("score", "NodeAffinity"): LABELS + ("paff_key", "paff_op", "paff_vals", "paff_num",
                                         "paff_num_ok", "paff_weight", "paff_term_valid"),
    ("score", "ImageLocality"): ("img_contrib", "pod_img", "pod_ncont"),
    ("score", "PodTopologySpread"): LABELS + NODE_AFFINITY
    + ("node_pair", "ns_id", "req_all", "spread_lut") + domain("sps"),
    ("score", "InterPodAffinity"): ("node_pair", "ns_id") + domain("ipa") + domain("ipan")
    + domain("ia"),
    # the volume family; VolumeRestrictions' per-node disk columns are
    # counted apart (`vol_disk_bytes`)
    ("filter", "VolumeRestrictions"): ("pod_claim", "used_claims", "pod_disk_any", "pod_disk_rw"),
    ("filter", "EBSLimits"): ("pod_vol3", "node_vol3"),
    ("filter", "GCEPDLimits"): ("pod_vol3", "node_vol3"),
    ("filter", "AzureDiskLimits"): ("pod_vol3", "node_vol3"),
    ("filter", "NodeVolumeLimits"): (),
    ("filter", "VolumeBinding"): ("vb_row", "vb_code"),
    ("filter", "VolumeZone"): ("vb_row", "vz_code"),
    ("preFilter", "VolumeBinding"): ("vb_pf",),
    # the demo plugins (their planes are the program's); NetworkBandwidth's
    # allocated sum reads every pod's request, assignment and mask besides
    # (`plugin_cost`)
    ("filter", "NetworkBandwidth"): ("nb_limit", "nb_has", "nb_bw"),
    ("score", "NetworkBandwidth"): ("nb_limit", "nb_has"),
    ("score", "NodeNumber"): ("nn_node", "nn_pod"),
}


def relational(enc, prog):
    """Which relational phases the kernel runs for this program (its
    `need_of`): spread filter, spread score, inter-pod filter and score,
    and hardPodAffinityWeight."""
    from kube_scheduler_simulator_tpu_torch.engine import kernels as K

    prescore = enc.config.enabled("preScore")
    return ("PodTopologySpread" in prog.filter_names,
            "PodTopologySpread" in prog.score_names and "PodTopologySpread" in prescore,
            "InterPodAffinity" in prog.filter_names,
            "InterPodAffinity" in prog.score_names and "InterPodAffinity" in prescore,
            K.interpod_hard_weight(enc))


def term_ops(C, VP):
    return C * (VP + 3) + 6


def rel_reads(enc, prog, st, p):
    """(bytes, operations) of one attempt's walk over the other pods for
    step pod p at state st, as the kernel's `rel_pod` reads them: every
    pod's assignment; for each bound pod its mask, namespace and (spread)
    deletion flag; the key row of each of its terms the reverse directions
    test and, for a term whose topology pair is on the pod's node and whose
    namespace matches, that term's namespace and clause rows; and one 32-byte
    sector for each distinct sector of the pod-label bitsets a clause
    gathers (the other pod's row in the forward directions, p's in the
    reverse). A term's clauses are counted whole where the kernel stops at
    the first that fails."""
    f_spread, s_spread, f_ipa, s_ipa, hard_w = relational(enc, prog)
    if not (f_spread or s_spread or f_ipa or s_ipa):
        return 0, 0
    import dataclasses

    rel = {f.name: getattr(enc.arrays.rel, f.name).cpu().numpy()
           for f in dataclasses.fields(enc.arrays.rel)}
    asg = st.assignment.cpu().numpy()
    live = (asg >= 0) & enc.arrays.pod_mask.cpu().numpy()
    P, LP = rel["pair_present"].shape
    KK = rel["key_present"].shape[1]
    byts, ops = 4 * P + int((asg >= 0).sum()), 2 * P
    qs = np.nonzero(live)[0]
    npq = rel["node_pair"][asg[qs]]  # [Q, K] the bound pods' nodes' pair ids
    ns_q, ns_p = rel["ns_id"][qs], int(rel["ns_id"][p])
    byts += 4 * len(qs)
    ops += 4 * len(qs)
    gathers = {"pair_present": [], "key_present": []}  # flat element indices

    def cols(d, owners, t):
        """Per owner, the pair ids and key ids term t's clauses gather."""
        ct = rel[f"{d}_ctype"][owners, t]  # [O, C]
        cp = np.where(((ct == 0) | (ct == 1))[..., None], rel[f"{d}_cpairs"][owners, t], -1)
        ck = np.where((ct == 2) | (ct == 3), rel[f"{d}_ckey"][owners, t], -1)
        return cp.reshape(len(owners), cp.shape[1] * cp.shape[2]), ck

    def gather(rows, pids, kids, width_p=LP, width_k=KK):
        for plane, ids, width in (("pair_present", pids, width_p), ("key_present", kids, width_k)):
            flat = (rows[:, None].astype(np.int64) * width + ids)[ids >= 0]
            gathers[plane].append(flat)

    def forward(d, extra):
        nonlocal ops
        _, T, C, VP = rel[f"{d}_cpairs"].shape
        for t in range(T):
            key = int(rel[f"{d}_key"][p, t])
            if key < 0:
                continue
            sel = extra(d, t, key)
            pids, kids = cols(d, np.array([p]), t)
            tq = qs[sel]
            gather(tq, np.repeat(pids, len(tq), 0), np.repeat(kids, len(tq), 0))
            ops += int(sel.sum()) * term_ops(C, VP)

    def spread_ok(d, t, key):
        return (ns_q == ns_p) & ~rel["deleted"][qs]

    def ipa_ok(d, t, key):
        ns_ok = rel[f"{d}_nsall"][p, t] | rel[f"{d}_ns"][p, t][ns_q]
        return (npq[:, key] > 0) & ns_ok

    if f_spread or s_spread:
        byts += int((ns_q == ns_p).sum())  # deleted
        for d, on in (("sph", f_spread), ("sps", s_spread)):
            if on:
                forward(d, spread_ok)
    fwd = (("ian", "ia") if f_ipa else ()) + (("ipa", "ipan") if s_ipa else ())
    for d in fwd:
        forward(d, ipa_ok)
    rev = (("ian",) if f_ipa else ()) + ((("ipa", "ipan", "ia") if hard_w > 0
                                          else ("ipa", "ipan")) if s_ipa else ())
    for d in rev:
        _, T, C, VP = rel[f"{d}_cpairs"].shape
        row = 4 * C * (2 + VP) + (4 if f"{d}_weight" in rel else 0)
        for t in range(T):
            keys = rel[f"{d}_key"][qs, t]
            on = (keys >= 0) & (npq[np.arange(len(qs)), np.maximum(keys, 0)] > 0)
            nsall = rel[f"{d}_nsall"][qs, t]
            ok = on & (nsall | rel[f"{d}_ns"][qs, t, ns_p])
            byts += 4 * len(qs) + int(on.sum()) + int((on & ~nsall).sum()) + row * int(ok.sum())
            ops += 3 * len(qs) + term_ops(C, VP) * int(ok.sum())
            pids, kids = cols(d, qs[ok], t)
            gather(np.full(len(pids), p), pids, kids)
    for plane, parts in gathers.items():
        if parts:
            byts += 32 * np.unique(np.concatenate(parts) // 32).size
    return byts, ops


def vol_disk_bytes(enc, p):
    """The node disk counters VolumeRestrictions reads for pod p: both
    counters of each of its disks on every node."""
    return 2 * 4 * enc.N * int((enc.arrays.pod_disk_any[p] > 0).sum())


def attempt_bound(enc, prog, st, p, weights):
    """The least time of one attempt of pod p at state st (`bound` of
    `attempt_cost`)."""
    return bound(*attempt_cost(enc, prog, st, p, weights))


def attempt_cost(enc, prog, st, p, weights):
    """(bytes, operations) of one attempt of pod p at state st: the node
    planes its plugins read, whole, the pod's own rows, the other pods'
    relational reads (`rel_reads`), the weights and one trace row written,
    against the rough operation count."""
    planes = {"node_mask"}
    for n in prog.filter_names:
        planes.update(READS["filter", n])
    for n in prog.score_names:
        planes.update(READS["score", n])
    if prog.prefilters:
        planes.update(READS["preFilter", "VolumeBinding"])
    a, P = enc.arrays, enc.P
    byts = vol_disk_bytes(enc, p) if "VolumeRestrictions" in prog.filter_names else 0
    plugin_b, plugin_ops = plugin_cost(enc, prog)
    byts += plugin_b
    for name in planes:
        t = prog.planes.get(name)
        t = t if t is not None else next(
            (getattr(o, name) for o in (a, a.rel, st) if hasattr(o, name)), None)
        if t is None:
            continue
        if name in NODE_PLANES:
            byts += nbytes(t)
        elif name in COLUMN_PLANES:
            byts += 32 * enc.N
        else:
            byts += nbytes(t) // t.shape[0]
    F, S, isz = len(prog.filter_names), len(prog.score_names), a.node_alloc.element_size()
    rel_b, rel_ops = rel_reads(enc, prog, st, p)
    byts += rel_b + nbytes(weights) + enc.N * (4 * F + 2 * isz * S) + 4
    return byts, ops_per_node(enc, prog) * enc.N + rel_ops + plugin_ops


def plugin_cost(enc, prog):
    """(bytes, operations) of NetworkBandwidth's allocated sum in a step's
    prologue, where the program enables the plugin: every pod's assignment,
    mask and request read, the [N] sum cleared and each bound pod's atomic
    add (this run's bound pods)."""
    if "nb_bw" not in prog.planes:
        return 0, 0
    isz, P, N = prog.planes["nb_bw"].element_size(), enc.P, enc.N
    return P * (4 + 1 + isz) + 2 * N * isz, 3 * P + N


def mid_state(cuda, eng):
    """The state after the first half of the queue (the kernel's pass, not
    recorded), and the next pod: the work an attempt does mid-pass."""
    enc = eng.enc
    half = len(enc.queue) // 2
    queue = padded_queue(eng)[:half].contiguous()
    st, _ = cuda.seq_run(eng.program, enc.arrays, enc.state0, queue, eng.weights, record=False)
    return st, int(enc.queue[half])


def path_workload(kp, path):
    """Phase 4's and 4b's cluster, configuration and 100 sampled pods:
    (nodes, pods, config, sample)."""
    if path == "fit":
        nodes, pods = kp.synthetic_cluster(1024, 10000, seed=7)
        cfg, seed = kp.fit_config(), 7
    else:
        nodes, pods = kp.synthetic_affinity_cluster(500, 5000, seed=11)
        cfg, seed = kp.affinity_config(), 11
    rng = np.random.default_rng(seed)
    sample = {("default", f"pod-{i}") for i in rng.choice(len(pods), 100, replace=False)}
    return nodes, pods, cfg, sample


def encoding_digest(enc):
    """A hash of every tensor of an encoding and its queue: two processes
    that encode the same cluster hold the same inputs."""
    h = hashlib.sha256()
    for obj in (enc.arrays, enc.arrays.rel, enc.state0):
        for f in dataclasses.fields(obj):
            t = getattr(obj, f.name)
            if isinstance(t, torch.Tensor):
                h.update(f"{f.name} {t.dtype} {tuple(t.shape)}".encode())
                h.update(t.contiguous().cpu().numpy().tobytes())
    h.update(np.asarray(enc.queue, np.int64).tobytes())
    return h.hexdigest()


def drive_path(kp, cuda, diff, path, nodes, pods, cfg, sample, smi):
    """Phase 4 / 4b: one path at full width. `schedule()` with the counters
    set to 0 just before and read just after, the layer split, then the
    single-pod step path with the counters reset again. The plain version
    of the pass runs in the second process (`plain_worker`); phase 4h holds
    this pass against it (`check_plain_path`). Returns what they need."""
    n_pods = len(pods)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    cuda.reset_counts()
    t0 = time.perf_counter()
    placements, results = kp.schedule(nodes, pods, config=cfg, policy=kp.TPU32, decode=sample)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    pass_counts, pass_plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() - base
    if pass_counts["seq_run"] < 1 or any(pass_plain.values()):
        raise AssertionError(f"the pass did not go through seq_run: {pass_counts} {pass_plain}")
    n_placed = sum(1 for v in placements.values() if v)
    log(f"    schedule(): {wall_s:.3f} s wall (encode + pass + decode of {len(sample)} pods), "
        f"{n_pods / wall_s:.1f} decisions/s, {n_placed} placed, peak memory "
        f"{peak / 2**30:.3f} GiB, launches {pass_counts}, plain calls {pass_plain} "
        f"[{smi}]")

    # where the time goes: the same pass split into its layers
    t0 = time.perf_counter()
    enc = kp.encode_cluster(nodes, pods, cfg, policy=kp.TPU32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng = kp.BatchedScheduler(enc)
    state_k, trace_k = eng.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    eng.placements()
    eng.results(pods=sample)
    t3 = time.perf_counter()
    split = (t1 - t0, t2 - t1, t3 - t2)
    log(f"    split: encode {split[0]:.3f} s, engine + pass {split[1]:.3f} s, decode "
        f"(placements + {len(sample)} records) {split[2]:.3f} s")
    got = {(r.pod_namespace, r.pod_name): r.to_annotations() for r in results}
    if len(got) != len(sample & set(placements)):
        raise AssertionError(f"{path} full width: {len(got)} sampled records decoded")

    # the single-pod step path: attempt_bind_fn over the same queue
    a, w = enc.arrays, eng.weights
    st = enc.state0.clone()
    bad = torch.zeros((), dtype=torch.bool, device=enc.device)
    cuda.reset_counts()
    t0 = time.perf_counter()
    for qi, p in enumerate(enc.queue.tolist()):
        _, codes, raw, final, sel, _, st = eng.attempt_bind_fn(a, st, w, p, qi)
        for row, out in zip(trace_k[1:], (codes, raw, final, sel)):
            bad |= (row[qi] != out).any()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_counts, step_plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    if bool(bad):
        raise AssertionError(f"{path}: single-pod steps differ from the pass's trace rows")
    for f in STATE_FIELDS:
        diff.check(path, "seq_bind", f"step path state {f}", getattr(st, f), getattr(state_k, f))
    n_q = len(enc.queue)
    if step_counts["seq_attempt"] != n_q or step_counts["seq_bind"] != n_q or any(
            step_plain.values()):
        raise AssertionError(f"{path} step path launches {step_counts}, plain {step_plain}")
    log(f"    single-pod step path: {n_q} steps in {step_s:.3f} s, every trace row and the "
        f"final state equal the pass's; launches {step_counts}")
    return dict(enc=enc, eng=eng, trace=trace_k, state=state_k, placements=placements,
                annotations=got, digest=encoding_digest(enc), pass_counts=pass_counts,
                step_counts=step_counts, mid=mid_state(cuda, eng), peak=peak, split=split)


def check_plain_path(cuda, diff, path, run, plain):
    """Phase 4h for phase 4 / 4b: the kernel pass (trace, final state,
    placements and the sampled pods' annotations) against the plain
    version's run of the same encoding in the second process."""
    if plain["digest"] != run["digest"]:
        raise AssertionError(f"{path}: the second process encoded other inputs")
    dev = run["enc"].device
    for slot, g, h in zip(cuda.TRACE_SLOTS_PLAIN, run["trace"], plain["trace"]):
        diff.check(path, "seq_run", f"full width {slot}", g, h.to(dev))
    for f in STATE_FIELDS:
        diff.check(path, "seq_run", f"full width state {f}", getattr(run["state"], f),
                   plain["state"][f].to(dev))
    if plain["placements"] != run["placements"]:
        raise AssertionError(f"{path} full width: placements differ from the plain run's")
    if plain["annotations"] != run["annotations"]:
        raise AssertionError(f"{path} full width: sampled annotations differ from the plain run's")
    run["plain_run_s"] = plain["seconds"]
    log(f"    {path}: the plain version of the pass on the host CPU, {plain['seconds']:.3f} s; "
        f"trace ({len(run['trace'][4])} steps), state, placements and "
        f"{len(run['annotations'])} pods' annotations equal the kernel pass's")


def segment_of(did, nominated, length, want_nominations=100):
    """The window of `length` consecutive live steps, starting at a multiple
    of 128, with at least `want_nominations` nominations and the fewest
    dry runs (the plain version pays for every dry run)."""
    best = None
    for s0 in range(0, max(1, len(did) - length + 1), 128):
        n_nom = int((nominated[s0:s0 + length] >= 0).sum())
        n_did = int(did[s0:s0 + length].sum())
        if n_nom >= want_nominations and (best is None or n_did < best[2]):
            best = (s0, n_nom, n_did)
    if best is None:
        raise AssertionError(f"no {length}-step segment holds {want_nominations} nominations")
    return best


def drive_default(kp, cuda, diff, nodes, pods, objects, sample, smi):
    """Phase 4c: the default path at full width — the reference's whole
    default profile, preemption included. The pass through the entry points
    `schedule()` composes, with the counters set to 0 just before and read
    just after, each part timed (the layer split); the
    pass's counts; a segment of the pass against the plain version from the
    kernel pass's own state; the single-pod step path (`attempt_fn`,
    `preempt_fn`, `evict_fn`, `bind_fn`) with the counters reset again."""
    path, cfg = "default", kp.supported_config()
    TRACE_SLOTS_PREEMPT = cuda.TRACE_SLOTS_PREEMPT
    n_pods = len(pods)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cuda.reset_counts()
    # the pass through the entry points `schedule()` composes (encode, run,
    # placements, the sampled records), each part timed
    t0 = time.perf_counter()
    enc = kp.encode_cluster(nodes, pods, cfg, policy=kp.TPU32, **objects)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng = kp.BatchedScheduler(enc)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    state_k, trace_k = eng.run()
    e1.record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pass_ms = e0.elapsed_time(e1)
    placements = eng.placements()
    annotations = {(r.pod_namespace, r.pod_name): r.to_annotations()
                   for r in eng.results(pods=sample)}
    t3 = time.perf_counter()
    wall_s = t3 - t0
    split = (t1 - t0, t2 - t1, t3 - t2)
    pass_counts, pass_plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() - base
    if pass_counts["seq_run"] < 1 or any(pass_plain.values()):
        raise AssertionError(f"the pass did not go through seq_run: {pass_counts} {pass_plain}")
    n_placed = sum(1 for v in placements.values() if v)
    log(f"    encode_cluster + BatchedScheduler.run + placements + results (what schedule() "
        f"composes): {wall_s:.3f} s wall (encode + pass + decode of {len(sample)} pods), "
        f"{len(placements) / wall_s:.1f} decisions/s, {n_placed} of {len(placements)} pending "
        f"placed ({n_pods} pods in all), peak memory {peak / 2**30:.3f} GiB, launches "
        f"{pass_counts}, plain calls {pass_plain} [{smi}]")
    log(f"    split: encode {t1 - t0:.3f} s (the volume verdict tables included), engine + "
        f"pass {t2 - t1:.3f} s (seq_run {pass_ms:.1f} ms on the card), decode (placements + "
        f"{len(sample)} records) {t3 - t2:.3f} s")
    t = dict(zip(TRACE_SLOTS_PREEMPT, trace_k))
    Q = len(enc.queue)
    host = {k: t[k].cpu().numpy() for k in ("did", "nominated", "voff", "vidx")}
    did, nominated = host["did"][:Q], host["nominated"][:Q]
    voff, vidx = host["voff"], host["vidx"]
    evicted = 0
    for qi in np.nonzero(did & (nominated >= 0))[0]:
        row = voff[qi, 0]
        evicted += int(row[nominated[qi] + 1] - row[nominated[qi]])
    codes = t["codes"][:Q]
    rejections = {f: int((codes[:, :enc.n_nodes, j] != 0).sum())
                  for j, f in enumerate(eng._filter_names)}
    trace_bytes = nbytes(*trace_k)
    log(f"    dry runs {int(did.sum())}, nominations {int((nominated >= 0).sum())}, evictions "
        f"{evicted}; (pod, node) rejections by filter {rejections}; trace {trace_bytes / 2**30:.3f}"
        f" GiB ({len(vidx)} victim entries), peak memory {peak / 2**30:.3f} GiB")
    if int(did.sum()) < 1000 or int((nominated >= 0).sum()) < 300:
        raise AssertionError("the default path ran fewer than 1000 dry runs or 300 nominations")
    silent = [f for f, n in rejections.items() if n == 0 and f != "NodeVolumeLimits"]
    if silent or rejections["NodeVolumeLimits"]:
        raise AssertionError(f"filters that rejected nothing: {silent}")

    # a segment of the pass against the plain version, from the kernel
    # pass's own state at its first step
    prog, a, w = eng.program, enc.arrays, eng.weights
    queue = padded_queue(eng)
    s0, n_nom, n_did = segment_of(did, nominated, SEGMENT)
    seg = queue[s0:s0 + SEGMENT].contiguous()
    st0, _ = cuda.seq_run(prog, a, enc.state0, queue[:s0].contiguous(), w, record=False)
    e0.record()
    s_k, t_k = cuda.seq_run(prog, a, st0, seg, w, record=True, step0=s0)
    e1.record()
    torch.cuda.synchronize()
    seg_ms = e0.elapsed_time(e1)
    # the plain version of the segment runs on the card in the fourth process
    # (its Python issues small launches: the main process goes on meanwhile),
    # from this state; phase 4h compares
    digest = encoding_digest(enc)
    save_input("seg4c_in", dict(digest=digest, s0=s0, seg=seg.cpu(), state=_state_dict(st0)))
    for name in ("codes", "raw", "final", "sel", "did", "pcode", "nominated", "final_sel"):
        diff.check(path, "seq_run", f"segment against the pass {name}",
                   t_k[TRACE_SLOTS_PREEMPT.index(name)], t[name][s0:s0 + SEGMENT])
    log(f"    the pass's steps {s0}..{s0 + SEGMENT - 1} ({n_did} dry runs, {n_nom} "
        f"nominations) again from the kernel pass's state at step {s0}: {seg_ms:.1f} ms, "
        "equal to the pass's rows; the plain version of the segment runs on the card in the "
        "fourth process (phase 4h)")

    # the single-pod step path over the same queue
    st = enc.state0.clone()
    cuda.reset_counts()
    t0 = time.perf_counter()
    bad = default_steps(eng, t, host, st, range(Q))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_counts, step_plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    if bool(bad):
        raise AssertionError("default: single-pod steps differ from the pass's trace rows")
    for f in STATE_FIELDS:
        diff.check(path, "seq_evict", f"step path state {f}", getattr(st, f),
                   getattr(state_k, f))
    n_fire = int(did.sum())
    want = {"seq_attempt": Q + n_fire, "seq_bind": Q, "seq_preempt": 2 * n_fire,
            "seq_evict": int((nominated >= 0).sum())}
    if any(step_counts[k] != n for k, n in want.items()) or any(step_plain.values()):
        raise AssertionError(f"default step path launches {step_counts}, plain {step_plain}")
    log(f"    single-pod step path: {Q} steps in {step_s:.3f} s, every trace row, victim "
        f"record and the final state equal the pass's; launches {step_counts}")
    mid = mid_state(cuda, eng)
    # a dry run mid-pass: the first step past the middle whose dry run
    # nominated, at the kernel pass's state before it
    qf = next(qi for qi in range(Q // 2, Q) if did[qi] and nominated[qi] >= 0)
    st_f, _ = cuda.seq_run(prog, a, enc.state0, queue[:qf].contiguous(), w, record=False)
    return dict(enc=enc, eng=eng, trace=trace_k, pass_counts=pass_counts,
                step_counts=step_counts, pass_ms=pass_ms, seg=[s0, seg_ms, None, seg],
                seg_out=(s_k, t_k, n_did, n_nom), mid=mid, dry=(st_f, int(enc.queue[qf]), qf),
                wall_s=wall_s, digest=digest, state=state_k, placements=placements,
                annotations=annotations, peak=peak, split=split)


def default_steps(eng, t, host, st, steps):
    """The single-pod step path (`attempt_fn`, `preempt_fn`, `evict_fn`,
    `bind_fn`) of a preempting engine over the queue positions `steps`,
    from state st (updated in place), against the recorded pass's rows
    (`t`: its trace slots by name; `host`: did, nominated, voff, vidx on the
    host). Returns a 0-dim bool on the card: some row differed."""
    enc = eng.enc
    a, w = enc.arrays, eng.weights
    did, nominated, voff, vidx = (host[k] for k in ("did", "nominated", "voff", "vidx"))
    bad = torch.zeros((), dtype=torch.bool, device=enc.device)
    for qi in steps:
        p = int(enc.queue[qi])
        pf, codes_, raw, final, sel, pf_ok = eng.attempt_fn(a, st, w, p)
        for name, out in (("codes", codes_), ("raw", raw), ("final", final), ("sel", sel)):
            bad |= (t[name][qi] != out).any()
        fsel = sel
        if did[qi]:
            nom = int(nominated[qi])
            for j, name in ((0, "pcode"), (1, "pcode2")):
                pcode, off, idx, nom_j = eng.preempt_fn(a, st, p)
                lo, hi = int(voff[qi, j, 0]), int(voff[qi, j, -1])
                bad |= (pcode != t[name][qi]).any() | (nom_j != t[
                    "nominated" if j == 0 else "nominated2"][qi])
                if idx.shape[0] != hi - lo:
                    raise AssertionError(f"step {qi}: dry run {j} names {idx.shape[0]} victims, "
                                         f"the pass {hi - lo}")
                bad |= (idx != t["vidx"][lo:hi]).any() | (off != t["voff"][qi, j] - lo).any()
                if j == 0:
                    if nom >= 0:
                        mask = torch.zeros(enc.P, dtype=torch.bool, device=enc.device)
                        row = voff[qi, 0]
                        mask[torch.as_tensor(vidx[row[nom]:row[nom + 1]], dtype=torch.long,
                                             device=enc.device)] = True
                        eng.evict_fn(a, st, mask)
                    _, codes2, raw2, final2, sel2, _ = eng.attempt_fn(a, st, w, p)
                    for name2, out in (("codes2", codes2), ("raw2", raw2), ("final2", final2)):
                        bad |= (t[name2][qi] != out).any()
                    bad |= sel2 != t["sel2"][qi]
                    if nom >= 0:
                        fsel = sel2
        bad |= fsel != t["final_sel"][qi]
        eng.bind_fn(a, st, p, fsel, qi)
    return bad


def check_plain_segment(cuda, diff, run, plain):
    """Phase 4h for phase 4c: the kernel's segment of the default pass
    (trace, victims, final state) against the plain version's run of it on
    the card in the fourth process, from the same state."""
    if plain["digest"] != run["digest"]:
        raise AssertionError("default: the fourth process encoded other inputs")
    s_k, t_k, n_did, n_nom = run.pop("seg_out")
    dev = run["enc"].device
    for name, g, h in zip(cuda.TRACE_SLOTS_PREEMPT, t_k, plain["trace"]):
        diff.check("default", "seq_run", f"segment {name}", g, h.to(dev))
    for f in STATE_FIELDS:
        diff.check("default", "seq_run", f"segment state {f}", getattr(s_k, f),
                   plain["state"][f].to(dev))
    s0, seg_ms, _, seg = run["seg"]
    run["seg"][2] = plain["seconds"] * 1e3
    log(f"    default: the plain version of the pass on steps {s0}..{s0 + len(seg) - 1} "
        f"({n_did} dry runs, {n_nom} nominations) on the card in the fourth process, "
        f"{plain['seconds'] * 1e3:.1f} ms against the kernel's {seg_ms:.1f} ms; trace, victims "
        "and state equal")


def kernel_rows(cuda, diff, path, run):
    """Phase 5 for one path: each kernel's time, its plain version's time
    and its bound, as entries of the kernels line. The per-pod kernels are
    timed at the state half-way through the queue, on the next pod."""
    enc, eng, trace_k = run["enc"], run["eng"], run["trace"]
    a, w, prog = enc.arrays, eng.weights, eng.program
    queue = padded_queue(eng)
    st, q = run["mid"]
    st = st.clone()
    codes, raw, final, sel, _ = cuda.seq_attempt(prog, a, st, w, q)
    attempt_ms = graph_ms(lambda: cuda.seq_attempt(prog, a, st, w, q))
    attempt_plain_ms = events_ms(lambda: cuda.seq_attempt_plain(prog, a, st, w, q), 20)
    b_att = attempt_bound(enc, prog, st, q, w)
    # binding the pod again and again only grows the counters it adds to
    bind_ms = graph_ms(lambda: cuda.seq_bind(prog, a, st, q, sel, 0))
    bind_plain_ms = events_ms(lambda: cuda.seq_bind_plain(prog, a, st, q, sel, 0), 20)
    state_bytes = nbytes(*(getattr(enc.state0, f) for f in STATE_FIELDS))
    pod_row = nbytes(a.pod_req[0], a.pod_sreq[0], a.want_pair[0], a.want_wild[0],
                     a.want_trip[0], a.pod_claim[0], a.pod_disk_any[0], a.pod_disk_rw[0],
                     a.pod_vol3[0])
    # the pod's rows, read; its node's rows, read and written; the pod's
    # claims' counters, the pod's count, assignment and bind order
    node_row = 2 * nbytes(st.requested[0]) + 4 * (2 * a.want_pair.shape[1] + a.want_trip.shape[1]
                                                  + 2 * a.pod_disk_any.shape[1] + 3 + 1)
    b_bind = bound(pod_row + 2 * node_row + 2 * 4 * a.pod_claim.shape[1] + 3 * 4,
                   pod_row // 4 + a.pod_claim.shape[1] + 4)
    # the mid-pass step's operations for every step: the relational walk
    # grows with the bound pods, so the middle step is about the mean
    step_ops = ops_per_node(enc, prog) * enc.N + rel_reads(enc, prog, run["mid"][0], q)[1]
    if "seg" in run:
        # the default path: the segment both versions ran, with its own bound
        s0, run_ms, plain_ms, seg = run["seg"]
        seg_trace = [x[s0:s0 + len(seg)] if x.shape[0] == len(queue) else x for x in trace_k]
        b_run = bound(cluster_bytes(enc) + 2 * state_bytes + nbytes(seg, w) + nbytes(*seg_trace),
                      step_ops * len(seg))
        run_row = ("seq_run", run["pass_counts"], run_ms, plain_ms, b_run)
    else:
        run_ms = events_ms(lambda: cuda.seq_run(prog, a, enc.state0, queue, w, record=True),
                           1, 3)
        b_run = bound(cluster_bytes(enc) + state_bytes + nbytes(queue, w) + nbytes(*trace_k)
                      + state_bytes, step_ops * len(queue))
        run_row = ("seq_run", run["pass_counts"], run_ms, run["plain_run_s"] * 1e3, b_run)
    rows = [
        ("seq_attempt", run["step_counts"], attempt_ms, attempt_plain_ms, b_att),
        ("seq_bind", run["step_counts"], bind_ms, bind_plain_ms, b_bind),
        run_row,
    ]
    if prog.preempt is not None:
        rows += preempt_rows(cuda, diff, path, run)
    out = []
    for k, counts, ms, plain_ms, b in rows:
        row = {"name": k, "path": path, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[k], "launches": counts[k],
               "max_abs_err": diff.err[path, k], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
        if k == "seq_run" and "seg" in run:
            row["steps"] = [run["seg"][0], run["seg"][0] + len(run["seg"][3])]
            row["plain_basis"] = "on the card, in the fourth process"
        elif k == "seq_run":
            row["plain_basis"] = "host CPU (the second process)"
        out.append(row)
    return out


def preempt_bound(enc, prog, st, p, n_victims):
    """The least time of one dry run of pod p at state st (`seq_preempt`:
    the step's prologue, then the dry run): each pod's assignment, mask
    and priority; each lower-priority bound pod's bind order and the rows
    its node's enabled row filters take it out of and put it back into;
    each such node's state rows and the stateless filters' planes (as one
    attempt's, `attempt_bound`); the codes and the victim record written.
    Operations: per lower-priority pod its rows three times (removal,
    reprieve, undo) and the sort's comparisons."""
    a, P = enc.arrays, enc.P
    asg = st.assignment.cpu().numpy()
    prio = a.pod_priority.cpu().numpy()
    lower = (asg >= 0) & a.pod_mask.cpu().numpy() & (prio < prio[p])
    per_node = np.bincount(asg[lower], minlength=enc.N)
    row = nbytes(a.pod_req[0], a.want_pair[0], a.want_wild[0], a.want_trip[0], a.pod_claim[0],
                 a.pod_disk_any[0], a.pod_disk_rw[0], a.pod_vol3[0]) + 4
    if "NetworkBandwidth" in prog.filter_names:  # its row: the victim's request
        row += prog.planes["nb_bw"].element_size()
    node_row = nbytes(st.requested[0], st.used_pair[0], st.used_wild[0], st.used_trip[0],
                      st.node_disk_any[0], st.node_disk_rw[0], st.node_vol3[0]) + 4
    att_bytes, att_ops = attempt_cost(enc, prog, st, p, torch.zeros(0))
    byts = (9 * P + int(lower.sum()) * row + int((per_node > 0).sum()) * node_row
            + att_bytes + 4 * (2 * enc.N + 1 + n_victims))
    ops = int(lower.sum()) * 3 * (row // 4) + int((per_node * per_node).sum()) // 4
    return bound(byts, ops + att_ops)


def preempt_rows(cuda, diff, path, run):
    """Phase 5 for the dry run and the eviction: `seq_preempt` at the
    kernel pass's state before its first nominating step past the middle
    of the queue, and `seq_evict` of that dry run's victims on its
    nominated node, each held against its plain version there first."""
    enc, eng = run["enc"], run["eng"]
    a, prog = enc.arrays, eng.program
    st, p, qf = run["dry"]
    got = cuda.seq_preempt(prog, a, st, p)
    want = cuda.seq_preempt_plain(prog, a, st, p)
    for name, g, h in zip(("pcode", "voff", "vidx", "nominated"), got, want):
        diff.check(path, "seq_preempt", f"full width, step {qf} {name}", g, h)
    pcode, off, idx, nom = got
    ms = graph_ms(lambda: cuda.preempt_launch(prog, a, st, p))
    plain_ms = events_ms(lambda: cuda.seq_preempt_plain(prog, a, st, p), 5, 3)
    b_pre = preempt_bound(enc, prog, st, p, int(idx.shape[0]))
    n = int(nom)
    mask = torch.zeros(enc.P, dtype=torch.bool, device=enc.device)
    mask[idx[int(off[n]):int(off[n + 1])].long()] = True
    s_k = cuda.seq_evict(prog, a, st.clone(), mask)
    s_p = cuda.seq_evict_plain(prog, a, st.clone(), mask)
    for f in STATE_FIELDS:
        diff.check(path, "seq_evict", f"full width, step {qf} state {f}", getattr(s_k, f),
                   getattr(s_p, f))
    # evicting the same pods again and again only lowers the counters
    st2 = st.clone()
    evict_ms = graph_ms(lambda: cuda.seq_evict(prog, a, st2, mask))
    st3 = st.clone()
    evict_plain_ms = events_ms(lambda: cuda.seq_evict_plain(prog, a, st3, mask), 20)
    k = int(mask.sum())
    pod_row = nbytes(a.pod_req[0], a.pod_sreq[0], a.want_pair[0], a.want_wild[0],
                     a.want_trip[0], a.pod_claim[0], a.pod_disk_any[0], a.pod_disk_rw[0],
                     a.pod_vol3[0])
    node_row = nbytes(st.requested[0], st.s_requested[0], st.used_pair[0], st.used_wild[0],
                      st.used_trip[0], st.node_disk_any[0], st.node_disk_rw[0], st.node_vol3[0])
    b_ev = bound(enc.P + 4 * enc.P + k * (pod_row + 8) + 2 * node_row,
                 k * pod_row // 4 + enc.P)
    log(f"    dry run at step {run['dry'][2]} (pod {p}): nominated node {n}, {k} victims of "
        f"{int(idx.shape[0])} named")
    return [("seq_preempt", run["step_counts"], ms, plain_ms, b_pre),
            ("seq_evict", run["step_counts"], evict_ms, evict_plain_ms, b_ev)]


# The plugin bodies timed alone inside seq_attempt (phase 5b), by path:
# (extension point, plugin, its args or None). PR 2's affinity bodies; the
# volume family (K6); the first slice's bodies, NodeResourcesFit's score
# under each of its strategies.
AFFINITY_BODIES = (
    ("filter", "NodeAffinity", None), ("filter", "NodePorts", None),
    ("filter", "PodTopologySpread", None), ("filter", "InterPodAffinity", None),
    ("score", "NodeAffinity", None), ("score", "ImageLocality", None),
    ("score", "PodTopologySpread", None), ("score", "InterPodAffinity", None))
VOLUME_BODIES = (
    ("preFilter", "VolumeBinding", None), ("filter", "VolumeBinding", None),
    ("filter", "VolumeZone", None), ("filter", "VolumeRestrictions", None),
    ("filter", "EBSLimits", None), ("filter", "GCEPDLimits", None),
    ("filter", "AzureDiskLimits", None), ("filter", "NodeVolumeLimits", None))
FIT_BODIES = (
    ("filter", "NodeUnschedulable", None), ("filter", "NodeName", None),
    ("filter", "TaintToleration", None), ("filter", "NodeResourcesFit", None),
    ("score", "NodeResourcesFit", None),
    ("score", "NodeResourcesFit", {"scoringStrategy": {"type": "MostAllocated"}}),
    ("score", "NodeResourcesFit", {"scoringStrategy": {
        "type": "RequestedToCapacityRatio", "requestedToCapacityRatio": {"shape": [
            {"utilization": 0, "score": 10}, {"utilization": 100, "score": 0}]}}}),
    ("score", "NodeResourcesBalancedAllocation", None), ("score", "TaintToleration", None))


def body_pod(enc, st, name, q):
    """The pod a body is timed on: the mid-queue pod `q`, or for a volume
    body the first pending pod from the middle of the queue on that asks
    for what the body checks (claims, disks, volumes of its type)."""
    a = enc.arrays
    want = {"VolumeBinding": a.vb_row >= 0, "VolumeZone": a.vb_row >= 0,
            "VolumeRestrictions": (a.pod_disk_any > 0).any(dim=1) | a.pod_claim.any(dim=1),
            "EBSLimits": a.pod_vol3[:, 0] > 0, "GCEPDLimits": a.pod_vol3[:, 1] > 0,
            "AzureDiskLimits": a.pod_vol3[:, 2] > 0}.get(name)
    if want is None:
        return q
    ok = (want & (st.assignment < 0)).cpu().numpy()
    queue = enc.queue[len(enc.queue) // 2:]
    return int(next((p for p in queue if ok[p]), q))


def body_times(kp, cuda, run, bodies, smi):
    """Phase 5b: each plugin body in `bodies`, timed inside `seq_attempt`
    with that plugin alone enabled (its PreScore too), beside its plain
    body on the same inputs and the bound of that attempt
    (`attempt_bound`). On the path's cluster at the state half-way through
    its queue. The time includes the launch and the select that every
    attempt does."""
    from kube_scheduler_simulator_tpu_torch.engine import kernels as K
    from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration

    enc = run["enc"]
    a = enc.arrays
    st, q = run["mid"]
    out = []
    for point, name, args in bodies:
        star = [{"name": "*"}]
        plugins = {pt: {"disabled": star, "enabled": []}
                   for pt in ("preFilter", "filter", "postFilter", "preScore", "score")}
        plugins[point]["enabled"] = [{"name": name, "weight": 1}] if point == "score" else [
            {"name": name}]
        if point == "score" and name in K.TRIVIAL_PRESCORE:
            plugins["preScore"]["enabled"] = [{"name": name}]
        profile = {"schedulerName": "default-scheduler", "plugins": plugins}
        if args:
            profile["pluginConfig"] = [{"name": name, "args": args}]
        cfg = SchedulerConfiguration.from_dict({"profiles": [profile]})
        enc1 = type(enc)(a, enc.state0, node_names=enc.node_names, pod_keys=enc.pod_keys,
                         resource_names=enc.resource_names, queue=enc.queue,
                         policy=enc.policy, config=cfg, n_nodes=enc.n_nodes,
                         n_pods=enc.n_pods, aux=enc.aux, pods=enc.pods)
        enc1.objects = enc.objects  # what out-of-tree plugins featurize
        eng = kp.BatchedScheduler(enc1)
        prog, w = eng.program, eng.weights
        p = body_pod(enc, st, name, q)
        ms = graph_ms(lambda: cuda.seq_attempt(prog, a, st, w, p))
        reg = {"filter": K.FILTER_KERNELS, "score": K.SCORE_KERNELS,
               "preFilter": K.PREFILTER_KERNELS}[point]
        body = reg[name][0](enc1)
        feasible = a.node_mask.clone()
        plain = (lambda: body(a, st, p, feasible)) if point == "score" else (
            lambda: body(a, st, p))
        if name in PLUGIN_NAMES and hasattr(body, "_normalize"):
            # the demo plugin's row is its score with its normalize
            def plain(body=body):
                return body._normalize(a, st, p, body(a, st, p, feasible), feasible)
        plain_ms = events_ms(plain, 20)
        b = attempt_bound(enc1, prog, st, p, w)
        label = name + (f" ({args['scoringStrategy']['type']})" if args else "")
        out.append((point, label, ms, plain_ms, b, p))
        log(f"    {point:9s} {label:44s} seq_attempt alone {ms:.6f} ms on pod {p} (plain body "
            f"{plain_ms:.3f} ms, bound {b[0]:.7f} ms by {b[1]}) [{smi}]")
    return out


# ---------------------------------------------------------------------------
# the serving path: the delta encoder's K10 scatters (phases 3 and 4d)
# ---------------------------------------------------------------------------

# The reference's delta templates (tests/test_delta_encode.py): tolerations,
# labels, a nodeSelector, a spread constraint; every append field gets a row.
TEMPLATES = [
    {"metadata": {"name": "plain"}, "spec": {"containers": [
        {"name": "c", "resources": {"requests": {"cpu": "100m", "memory": "64Mi"}}}]}},
    {"metadata": {"name": "tol"}, "spec": {
        "tolerations": [{"key": "flaky", "operator": "Exists", "effect": "NoSchedule"}],
        "containers": [{"name": "c", "resources": {"requests": {"cpu": "50m"}}}]}},
    {"metadata": {"name": "lab", "labels": {"app": "web", "tier": "fe"}}, "spec": {
        "containers": [{"name": "c", "resources": {"requests": {"memory": "32Mi"}}}]}},
    {"metadata": {"name": "sel"}, "spec": {
        "nodeSelector": {"zone": "a"},
        "containers": [{"name": "c", "resources": {"requests": {"cpu": "25m"}}}]}},
    {"metadata": {"name": "spread", "labels": {"app": "web"}}, "spec": {
        "topologySpreadConstraints": [{
            "maxSkew": 1, "topologyKey": "kubernetes.io/hostname",
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": "web"}}}],
        "containers": [{"name": "c", "resources": {"requests": {"cpu": "10m"}}}]}},
]
K10_WRAPPERS = {"scatter_set": "delta_scatter_set", "scatter_add": "delta_scatter_add",
                "vec_add": "delta_vec_add"}
# phase 4d: BASELINE config #2's width (1,024 nodes), 10,000 pods bound
# and 7 passes of 128 arrivals (of the 13,072 pods generated; 4f takes its
# arrivals from the same list)
SERVING_NODES, SERVING_PODS, SERVING_BOUND = 1024, 13072, 10000
SERVING_PASSES = 7
SERVING_ARRIVALS = 128
PREEMPT_PASS = 6
# phase 4m(c): the first passes of 4d again under PACKED (passes 2..4 delta
# passes), the last of them after a flip back to TPU32
PACKED_SERVING_PASSES = 5
# the delta passes whose K10 calls phase 5c times: pass 5's set and add
# calls, pass 2's vector add (it replays the claim pods' binds)
K10_TIMED_PASSES = {"delta_scatter_set": 5, "delta_scatter_add": 5, "delta_vec_add": 2}
# the passes whose served run is held against the plain version of the
# whole pass (pass 6 holds the preemptor's dry run)
PLAIN_PASSES = (5, PREEMPT_PASS)
CARD = torch.device("cuda")


def from_template(t, name):
    return {"metadata": {**t["metadata"], "name": name}, "spec": dict(t["spec"])}


class K10Recorder:
    """Wraps the K10 wrappers the delta encoder calls (engine/scatter.py)
    and keeps each call: (kernel, target, the target's contents before the
    call, the host rows). Calls go through unchanged."""

    def __init__(self, scatter):
        self.scatter = scatter
        self.calls = []

    def __enter__(self):
        self.orig = {n: getattr(self.scatter, n) for n in K10_WRAPPERS}
        for n, f in self.orig.items():
            setattr(self.scatter, n, self._wrap(K10_WRAPPERS[n], f))
        return self

    def _wrap(self, kernel, f):
        def call(arr, *rows):
            self.calls.append((kernel, arr, arr.clone(), [r.clone() for r in rows]))
            return f(arr, *rows)
        return call

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.scatter, n, f)


def k10_plain(scatter, kernel):
    return {"delta_scatter_set": scatter.scatter_set_plain,
            "delta_scatter_add": scatter.scatter_add_plain,
            "delta_vec_add": scatter.vec_add_plain}[kernel]


def k10_launch(scatter, kernel):
    return {"delta_scatter_set": scatter.launch_set, "delta_scatter_add": scatter.launch_add,
            "delta_vec_add": scatter.launch_vec}[kernel]


def replay_k10(scatter, diff, calls, what):
    """Each recorded call again: the kernel on a copy of the target as it
    was, against the plain version on the CPU, exact."""
    for kernel, arr, before, rows in calls:
        dev = before.device
        got = k10_launch(scatter, kernel)(before.clone(), *(r.to(dev) for r in rows))
        want = k10_plain(scatter, kernel)(before.cpu(), *rows)
        diff.check("serving", kernel, f"{what} {tuple(before.shape)} {before.dtype}",
                   got.cpu(), want)


def store_encode(kp, store, cfg, policy):
    """A from-scratch encode of a store on the card, at the delta encoder's
    capacity buckets."""
    from kube_scheduler_simulator_tpu_torch.utils.compilecache import capacity_buckets

    nodes, pods = store.list("nodes"), store.list("pods")
    ncap, pcap = capacity_buckets(len(nodes), len(pods))
    return kp.encode_cluster(
        nodes, pods, cfg, policy=policy, priorityclasses=store.list("priorityclasses"),
        namespaces=store.list("namespaces"), pvcs=store.list("pvcs"), pvs=store.list("pvs"),
        storageclasses=store.list("storageclasses"), node_capacity=ncap, pod_capacity=pcap)


def same_encoding(got, want, what):
    """Every tensor of two encodings (cluster planes, relational planes,
    initial state), the queue and the host tables, exactly equal."""
    for g, w in ((got.arrays, want.arrays), (got.arrays.rel, want.arrays.rel),
                 (got.state0, want.state0)):
        for f in g.__dataclass_fields__:
            x, y = getattr(g, f), getattr(w, f)
            if isinstance(x, torch.Tensor) and not (
                    x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y.to(x.device))):
                raise AssertionError(f"{what}: {f} differs from the from-scratch encode")
    if not (np.array_equal(got.queue, want.queue) and got.pod_keys == want.pod_keys
            and got.node_names == want.node_names and (got.n_pods, got.n_nodes) == (
                want.n_pods, want.n_nodes)):
        raise AssertionError(f"{what}: the queue or host tables differ")


def compare_k10(kp, scatter, diff):
    """Phase 3 for K10: each kernel against its plain version, exact, on
    random planes (bool, int32, int64; rows of rank 0 to 3; repeated add
    indices with int32 wraparound; a zero-width plane that launches
    nothing), then on the real dirty lists of a dressed store's delta passes
    under TPU32 and EXACT (arrivals from the reference's delta templates,
    write-back binds, cordons): the encoder on the card and on the CPU keep
    equal encodings, both equal to a from-scratch encode."""
    from kube_scheduler_simulator_tpu_torch.engine.delta import DeltaEncoder
    from kube_scheduler_simulator_tpu_torch.models.store import ResourceStore
    from kube_scheduler_simulator_tpu_torch.sched.config import SchedulerConfiguration

    card = CARD
    rng = np.random.default_rng(5)
    P, k = 4096, 256

    def rand(dtype, shape):
        if dtype == torch.bool:
            return torch.as_tensor(rng.random(shape) < 0.5)
        info = torch.iinfo(dtype)
        edge = rng.integers(info.min, info.max, shape, dtype=np.int64, endpoint=True)
        return torch.as_tensor(np.where(rng.random(shape) < 0.5, edge,
                                        rng.integers(-5, 6, shape))).to(dtype)

    scatter.reset_counts()
    n_cmp = 0
    for dtype in (torch.bool, torch.int32, torch.int64):
        for shape in ((), (3,), (2, 5), (2, 3, 4), (0,)):
            arr = rand(dtype, (P, *shape))
            idx = torch.as_tensor(rng.choice(P, k, replace=False).astype(np.int32))
            rows = rand(dtype, (k, *shape))
            cases = [("delta_scatter_set", scatter.scatter_set, (idx, rows))]
            if dtype != torch.bool:
                add_idx = torch.as_tensor(rng.integers(0, 16, 4 * k).astype(np.int32))
                cases += [("delta_scatter_add", scatter.scatter_add,
                           (add_idx, rand(dtype, (4 * k, *shape)))),
                          ("delta_vec_add", scatter.vec_add, (rand(dtype, (P, *shape)),))]
            for kernel, wrapper, args in cases:
                got = wrapper(arr.to(card, copy=True), *args).cpu()
                want = k10_plain(scatter, kernel)(arr.clone(), *args)
                diff.check("serving", kernel, f"random {dtype} rows{shape}", got, want)
                n_cmp += 1
    if scatter.LAUNCHES != {"delta_scatter_set": 12, "delta_scatter_add": 8,
                            "delta_vec_add": 8} or any(scatter.PLAIN_CALLS.values()):
        raise AssertionError(f"K10 random cases launched {scatter.LAUNCHES}, "
                             f"plain {scatter.PLAIN_CALLS}")
    log(f"  k10      random planes: {n_cmp} updates equal to plain (zero-width planes "
        "launched nothing)")

    for pol in (kp.TPU32, kp.EXACT):
        nodes, _ = kp.synthetic_cluster(256, 0, seed=13)
        store = ResourceStore()
        for i, nd in enumerate(nodes):
            nd["metadata"]["labels"] = {"zone": "a" if i % 2 else "b",
                                        "kubernetes.io/hostname": nd["metadata"]["name"]}
            if i % 9 == 4:
                nd["spec"] = {"taints": [{"key": "flaky", "effect": "NoSchedule"}]}
            store.apply("nodes", nd)
        for j in range(1500):
            pd = from_template(TEMPLATES[j % len(TEMPLATES)], f"seed-{j}")
            if j % 3:
                pd["spec"]["nodeName"] = nodes[j % 256]["metadata"]["name"]
            store.apply("pods", pd)
        cfg = SchedulerConfiguration.default()
        on_card, on_cpu = DeltaEncoder(policy=pol), DeltaEncoder(policy=pol, device="cpu")
        on_card.encode(store, cfg)
        on_cpu.encode(store, cfg)
        n_calls, fields = 0, set()
        for step in range(3):
            for j in range(64):
                store.apply("pods", from_template(TEMPLATES[(j + step) % len(TEMPLATES)],
                                                  f"arrival-{step}-{j}"))
            pending = [p for p in store.list("pods") if not p["spec"].get("nodeName")]
            for j, p in enumerate(pending[:64]):
                store.apply("pods", {"metadata": {"name": p["metadata"]["name"],
                                                  "annotations": {"result": "Scheduled"}},
                                     "spec": {"nodeName": nodes[(7 * j) % 256]["metadata"][
                                         "name"]}})
            store.apply("nodes", {"metadata": {"name": nodes[step]["metadata"]["name"]},
                                  "spec": {"unschedulable": True}})
            scatter.reset_counts()
            with K10Recorder(scatter) as rec:
                enc_k, info = on_card.encode(store, cfg)
            launches = dict(scatter.LAUNCHES)
            enc_c, info_c = on_cpu.encode(store, cfg)
            if info["mode"] != "delta" or info != info_c or not sum(launches.values()):
                raise AssertionError(f"{pol.name} step {step}: {info} / {info_c}, {launches}")
            same_encoding(enc_k, enc_c, f"{pol.name} step {step} card against CPU")
            same_encoding(enc_k, store_encode(kp, store, cfg, pol),
                          f"{pol.name} step {step} card against from scratch")
            replay_k10(scatter, diff, rec.calls, f"{pol.name} step {step}")
            n_calls += len(rec.calls)
            fields |= {tuple(c[2].shape[1:]) for c in rec.calls}
        log(f"  k10      {pol.name:5s} dressed store (256 nodes, 1,500 pods, 3 delta passes of 64 "
            f"arrivals, 64 binds, a cordon): {n_calls} scatters ({len(fields)} row shapes) equal "
            "to plain; the card's encoding equals the CPU's and a from-scratch encode")


def serving_snapshot(kp, n_nodes, n_pods, n_bound, seed):
    """BASELINE config #2's width as an imported snapshot: the first
    `n_bound` pods of `synthetic_cluster(n_nodes, n_pods, seed)` bound by one
    kernel pass (unplaced ones dropped), then the next `SERVING_ARRIVALS`
    pending, 8 of them mounting a ReadWriteOncePod claim (so a later pass's
    binds move the claim counters). Returns (snapshot, the later arrivals)."""
    nodes, pods = kp.synthetic_cluster(n_nodes, n_pods, seed=seed)
    enc = kp.encode_cluster(nodes, pods[:n_bound], kp.supported_config(), policy=kp.TPU32)
    eng = kp.BatchedScheduler(enc, record=False)
    eng.run()
    placed = eng.placements()
    bound = []
    for pd in pods[:n_bound]:
        sel = placed[("default", pd["metadata"]["name"])]
        if sel:
            bound.append({**pd, "spec": {**pd["spec"], "nodeName": sel}})
    first = [dict(pd) for pd in pods[n_bound:n_bound + SERVING_ARRIVALS]]
    pvcs, pvs = [], []
    for c in range(8):
        pvs.append({"metadata": {"name": f"rwop-pv-{c}"}, "spec": {
            "capacity": {"storage": "10Gi"}, "accessModes": ["ReadWriteOncePod"]}})
        pvcs.append({"metadata": {"name": f"rwop-{c}", "namespace": "default"}, "spec": {
            "volumeName": f"rwop-pv-{c}", "accessModes": ["ReadWriteOncePod"],
            "resources": {"requests": {"storage": "1Gi"}}}})
        j = c * (len(first) // 8)
        pd = first[j]
        first[j] = {**pd, "spec": {**pd["spec"], "volumes": [
            {"name": "data", "persistentVolumeClaim": {"claimName": f"rwop-{c}"}}]}}
    snap = {"nodes": nodes, "pods": bound + first, "pvcs": pvcs, "pvs": pvs}
    return snap, pods[n_bound + SERVING_ARRIVALS:], len(bound)


def plain_pass(kp, cuda, diff, sched, fresh, results, k):
    """The plain version of a whole served pass on the card: `seq_run_plain`
    over the from-scratch encode (equal to the retained one, check (a))
    must give the served engine's trace, victim records and final state,
    and its decoded records the served ones, exactly."""
    served = next(reversed(sched._engines.values()))  # the engine that ran the pass
    eng_p = kp.BatchedScheduler(fresh)
    eng_p.run_fn = functools.partial(cuda.seq_run_plain, eng_p.program, record=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_p, trace_p = eng_p.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if len(served._trace) != len(cuda.TRACE_SLOTS_PREEMPT) or len(trace_p) != len(
            served._trace):
        raise AssertionError(f"pass {k}: the served trace has {len(served._trace)} slots")
    for slot, g, h in zip(cuda.TRACE_SLOTS_PREEMPT, served._trace, trace_p):
        diff.check("serving", "seq_run", f"pass {k} {slot}", g, h)
    for f in STATE_FIELDS:
        diff.check("serving", "seq_run", f"pass {k} state {f}",
                   getattr(served._final_state, f), getattr(state_p, f))
    if eng_p.results() != results:
        raise AssertionError(f"pass {k}: the served records differ from the plain pass's")
    did = int(trace_p[cuda.TRACE_SLOTS_PREEMPT.index("did")][:len(fresh.queue)].sum())
    log(f"    pass {k:2d}: the plain version of the whole pass on the card ({len(fresh.queue)} "
        f"pods, {did} dry runs) in {secs:.3f} s; trace, victims, final state and "
        f"{len(results)} records equal the served pass's")


def drive_serving(kp, cuda, scatter, diff, smi):
    """Phase 4d: a serving session at BASELINE config #2's width through
    `SimulatorService` on the card. SERVING_PASSES `schedule()` passes, each
    but the first after SERVING_ARRIVALS arrivals and a cordon/uncordon (PREEMPT_PASS's
    arrivals carry a pod that must preempt), then two with no event between:
    the first replays the last pass's write-backs (a delta pass), the second
    finds the store unchanged (cached). Before each pass the store is
    encoded from scratch; after it: (a) the service's retained encoding equals that
    encode; (b) a fresh kernel pass over it gives the records, placements,
    victims and 13 annotations the service wrote back; (c) a delta pass
    launched the K10 kernels and no plain scatter, a full or cached pass
    none, and a pass with a pending queue `seq_run` and no plain pass; (d)
    on `PLAIN_PASSES`, the plain version of the whole pass gives the served
    trace, state and records. The counters are set to 0 just before each
    `schedule()` and read just after."""
    from kube_scheduler_simulator_tpu_torch.server.service import SimulatorService

    n_nodes, n_pods, n_bound = SERVING_NODES, SERVING_PODS, SERVING_BOUND
    t_setup = time.perf_counter()
    snap, later, n_kept = serving_snapshot(kp, n_nodes, n_pods, n_bound, seed=7)
    # phase 4j's tenants hold this snapshot, their gang window's arrivals
    # are the next SERVING_ARRIVALS pods; tenant 0's go to the host-CPU worker
    batch_in = (json.loads(json.dumps(snap)), json.loads(json.dumps(later[:SERVING_ARRIVALS])))
    save_input("serving4j_in", dict(snap=tenant_copy(batch_in[0], 0),
                                    arrivals=tenant_copy({"pods": batch_in[1]}, 0)["pods"]))
    sim = SimulatorService()
    sim.import_(snap)
    store, sched = sim.store, sim.scheduler
    cfg = sched.config
    cpu_max = max(int(nd["status"]["allocatable"]["cpu"]) for nd in snap["nodes"])
    log(f"    snapshot: {n_nodes} nodes, {n_kept} of the first {n_bound} pods bound by one "
        f"kernel pass, {SERVING_ARRIVALS} pending (8 with a ReadWriteOncePod claim); set-up "
        f"{time.perf_counter() - t_setup:.1f} s")
    # phase 4m(c) replays the first PACKED_SERVING_PASSES passes' events
    replay = dict(snap=json.loads(json.dumps(snap)), records={}, later=json.loads(json.dumps(
        later[:(PACKED_SERVING_PASSES - 1) * SERVING_ARRIVALS])))
    totals = dict.fromkeys(scatter.KERNELS, 0)
    rows, recorded, walls, placed, peak = [], {}, [], 0, 0
    preemptor = None
    for k in range(1, SERVING_PASSES + 3):
        if 2 <= k <= SERVING_PASSES:
            arrivals = later[(k - 2) * SERVING_ARRIVALS:(k - 1) * SERVING_ARRIVALS]
            for j, pd in enumerate(arrivals):
                if k == PREEMPT_PASS and j == 0:
                    pd = {"metadata": {"name": "preemptor", "namespace": "default"},
                          "spec": {"priority": 1000, "containers": [{"name": "c", "resources": {
                              "requests": {"cpu": str(cpu_max), "memory": "1Gi"}}}]}}
                store.apply("pods", pd)
            store.apply("nodes", {"metadata": {"name": f"node-{k}"},
                                  "spec": {"unschedulable": True}})
            store.apply("nodes", {"metadata": {"name": f"node-{k - 1}"},
                                  "spec": {"unschedulable": False}})
        fresh = store_encode(kp, store, cfg, kp.TPU32)
        before = sched.metrics.phases()
        cuda.reset_counts()
        scatter.reset_counts()
        rec = K10Recorder(scatter) if k in K10_TIMED_PASSES.values() else None
        torch.cuda.synchronize()
        # the pass's own peak: above what is held before it (the service's
        # retained encoding and engines, and the check's encode)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if rec is not None:
            with rec:
                results = sched.schedule()
        else:
            results = sched.schedule()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = max(peak, torch.cuda.max_memory_allocated() - held)
        k10, k10_plain_calls = dict(scatter.LAUNCHES), dict(scatter.PLAIN_CALLS)
        seq, seq_plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
        after = sched.metrics.phases()
        info = dict(sched.last_encode_info)
        mode = info["mode"]
        # (c) the launch counters
        if mode == "delta":
            ok = sum(k10.values()) > 0 and not any(k10_plain_calls.values())
        else:
            ok = not any(k10.values()) and not any(k10_plain_calls.values())
        if not ok or seq["seq_run"] != int(len(fresh.queue) > 0) or any(seq_plain.values()):
            raise AssertionError(f"pass {k} ({mode}): K10 {k10} plain {k10_plain_calls}, "
                                 f"seq {seq} plain {seq_plain}")
        for name, n in k10.items():
            totals[name] += n
        if rec is not None:
            if mode != "delta":
                raise AssertionError(f"pass {k}, whose K10 calls are timed, was {mode}")
            recorded[k] = rec.calls
        # (a) the retained encoding against the from-scratch encode
        same_encoding(sched._delta._st.enc, fresh, f"pass {k} ({mode})")
        # (b) a fresh kernel pass over it: placements, victims, annotations
        eng = kp.BatchedScheduler(fresh)
        eng.run()
        want = eng.results()
        if results != want:
            raise AssertionError(f"pass {k}: the served records differ from a fresh pass's")
        if k <= PACKED_SERVING_PASSES:
            replay["records"][k] = results
        if k in PLAIN_PASSES:
            plain_pass(kp, cuda, diff, sched, fresh, results, k)
        want_place = fresh.decode_assignment(eng._final_state.assignment)
        last = {(r.pod_namespace, r.pod_name): r for r in want}
        for (ns, name), r in last.items():
            pd = store.get("pods", name, ns)
            if (pd["metadata"].get("annotations") != r.to_annotations()
                    or pd["spec"].get("nodeName", "") != want_place[ns, name]):
                raise AssertionError(f"pass {k}: pod {ns}/{name} was written back wrong")
        b0 = fresh.state0.assignment.cpu().numpy()
        a1 = eng._final_state.assignment.cpu().numpy()
        victims = [fresh.pod_keys[i] for i in np.nonzero((b0 >= 0) & (a1 < 0))[0]]
        if any(store.get("pods", name, ns) is not None for ns, name in victims):
            raise AssertionError(f"pass {k}: a preemption victim is still in the store")
        if k == PREEMPT_PASS:
            nom = [r for r in results if r.pod_name == "preemptor" and r.status == "Nominated"]
            if not nom or not nom[0].preemption_victims or len(victims) != len(
                    nom[0].preemption_victims):
                raise AssertionError(f"pass {k}: the preemptor was not nominated with victims")
            preemptor = (nom[0].nominated_node, len(victims))
        n_sched = sum(1 for r in results if r.status == "Scheduled")
        placed += n_sched
        walls.append(wall)
        d = {key: after[key] - before[key] for key in
             ("encodeSeconds", "compileSeconds", "executeSeconds", "decodeSeconds")}
        xfer = 0 if mode == "cached" else sched._delta.last_transfer_bytes
        rows.append((k, info, d, xfer, sum(k10.values()), wall))
        log(f"    pass {k:2d}: {mode:6s} {info.get('reason', ''):22s} appended "
            f"{info.get('appended', 0):3d} rebound {info.get('rebound', 0):3d} nodes touched "
            f"{info.get('nodesTouched', 0)}; encode {d['encodeSeconds']:.3f} s, execute "
            f"{d['executeSeconds'] + d['compileSeconds']:.3f} s, decode + write-back "
            f"{d['decodeSeconds']:.3f} s, wall {wall:.3f} s; {len(results)} records, "
            f"{n_sched} scheduled, {len(victims)} victims; {rows[-1][3]} bytes to the card; "
            f"K10 launches {k10} [{smi}]")
    modes = [r[1]["mode"] for r in rows]
    n_delta = modes.count("delta")
    if (n_delta < SERVING_PASSES - 3 or modes[0] != "full" or modes[-2:] != ["delta", "cached"]
            or preemptor is None):
        raise AssertionError(f"serving modes {modes}, preemptor {preemptor}")
    enc_s = {m: [r[2]["encodeSeconds"] for r in rows if r[1]["mode"] == m]
             for m in ("delta", "full")}
    total = sum(walls)
    log(f"    {len(rows)} passes ({n_delta} delta, {modes.count('full')} full, "
        f"{modes.count('cached')} cached) in {total:.3f} s: {len(rows) / total:.3f} passes/s, "
        f"{placed / total:.1f} arrivals placed/s ({placed} placed); median encode delta "
        f"{statistics.median(enc_s['delta']):.4f} s against full "
        f"{statistics.median(enc_s['full']):.4f} s; preemptor nominated on "
        f"{preemptor[0]} with {preemptor[1]} victims deleted; K10 launches {totals}; peak "
        f"memory of a pass {peak / 2**30:.3f} GiB above what was held before it [{smi}]")
    calls = [c for k, cs in recorded.items() for c in cs if K10_TIMED_PASSES[c[0]] == k]
    return dict(calls=calls, totals=totals, n_delta=n_delta, batch_in=batch_in, replay=replay)


def k10_rows(kp, scatter, diff, serving, smi):
    """Phase 5 for K10, at the real dirty lists of phase 4d's delta passes
    (`K10_TIMED_PASSES`: pass 5's set and add calls, pass 2's vector add):
    per kernel, the mean device time of one launch over that pass's calls,
    from a CUDA graph of 100 replays of them on copies of the targets; the
    plain version's (CUDA events) and the one PyTorch call's (`index_copy_`,
    `index_put_(accumulate=True)`, `add_`; a CUDA graph too). Bound: the
    bytes each call moves (every row read and written, the add's target
    rows read too, 4 bytes an index) over 3.35 TB/s."""
    card = CARD
    by_kernel = {name: [] for name in scatter.KERNELS}
    for kernel, arr, before, rows in serving["calls"]:
        by_kernel[kernel].append((before.clone(), [r.to(card) for r in rows]))
    missing = [kernel for kernel, calls in by_kernel.items() if not calls]
    if missing:
        raise AssertionError(f"the timed serving passes made no call of {missing}")
    out = []
    for kernel, calls in by_kernel.items():
        launch, plain = k10_launch(scatter, kernel), k10_plain(scatter, kernel)
        for arr, rows in calls:  # each launch once more against the plain version
            diff.check("serving", kernel, "timed inputs", launch(arr.clone(), *rows),
                       plain(arr.clone(), *rows))

        def run_all():
            for arr, rows in calls:
                launch(arr, *rows)

        def run_plain():
            for arr, rows in calls:
                plain(arr, *rows)

        if kernel == "delta_scatter_set":
            lib = [(a, r[0].long(), r[1]) for a, r in calls]

            def run_lib():
                for a, i, r in lib:
                    a.index_copy_(0, i, r)
        elif kernel == "delta_scatter_add":
            lib = [(a, (r[0].long(),), r[1]) for a, r in calls]

            def run_lib():
                for a, i, r in lib:
                    a.index_put_(i, r, accumulate=True)
        else:
            def run_lib():
                for a, r in calls:
                    a.add_(r[0])
        n = len(calls)
        ms = graph_ms(run_all) / n
        plain_ms = events_ms(run_plain, 5) / n
        library_ms = graph_ms(run_lib) / n
        moved = 0
        for arr, rows in calls:
            row = arr[0].numel() * arr.element_size() if arr.dim() else 0
            if kernel == "delta_vec_add":
                moved += 3 * arr.numel() * arr.element_size()
            else:
                k = rows[0].shape[0]
                moved += k * ((3 if kernel == "delta_scatter_add" else 2) * row + 4)
        b = bound(moved / n, 0)
        per_pass = serving["totals"][kernel] / serving["n_delta"]
        row = {"name": kernel, "path": "serving", "route": "cuda",
               "source": "kube_scheduler_simulator_tpu_torch/csrc/delta_kernels.cu",
               "replaces": REPLACES[kernel], "launches": serving["totals"][kernel],
               "launches_per_delta_pass": per_pass,
               "max_abs_err": diff.err.get(("serving", kernel), 0.0), "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
               "library_ms": library_ms, "calls_timed": n}
        out.append(row)
        log(f"    serving  {kernel:17s} {ms:.6f} ms a launch over the {n} calls of pass "
            f"{K10_TIMED_PASSES[kernel]}"
            f" (plain {plain_ms:.4f} ms, library {library_ms:.6f} ms, bound "
            f"{b[0]:.7f} ms by {b[1]}), {per_pass:.1f} launches a delta pass [{smi}]")
    return out


# ---------------------------------------------------------------------------
# the gang path: K9 (phases 3, 4e, 4f and its kernel rows)
# ---------------------------------------------------------------------------


class Swap:
    """Module functions replaced for the block: `table` maps a name to its
    stand-in, built from the original."""

    def __init__(self, module, table):
        self.module, self.table = module, table

    def __enter__(self):
        self.orig = {n: getattr(self.module, n) for n in self.table}
        for n, make in self.table.items():
            setattr(self.module, n, make(self.orig[n]))
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.module, n, f)


def plain_gang(cuda):
    """The gang engine's kernels (and the preempt phase's seq_run) swapped
    for their plain versions, which run on card tensors as well."""
    return Swap(cuda, {n: (lambda f, n=n: getattr(cuda, n + "_plain"))
                       for n in GANG_KERNELS + ("seq_run",)})


class GangTimer(Swap):
    """Each gang kernel call (and each preempt phase's seq_run) between two
    CUDA events; `ms()` sums the device time by kernel."""

    def __init__(self, cuda):
        self.events = []

        def timed(name):
            def make(f):
                def call(*args, **kw):
                    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                        enable_timing=True)
                    e0.record()
                    out = f(*args, **kw)
                    e1.record()
                    self.events.append((name, e0, e1))
                    return out
                return call
            return make

        super().__init__(cuda, {n: timed(n) for n in GANG_KERNELS + ("seq_run",)})

    def ms(self):
        torch.cuda.synchronize()
        out = dict.fromkeys(GANG_KERNELS + ("seq_run",), 0.0)
        for name, e0, e1 in self.events:
            out[name] += e0.elapsed_time(e1)
        return out


def timed_run(kp, cuda, enc, placements, rounds, **kw):
    """A second run() of a fresh GangScheduler(enc, **kw) with each kernel
    call between CUDA events: its device ms by kernel. It must place as the
    untimed run did, in as many rounds."""
    g = kp.GangScheduler(enc, **kw)
    timer = GangTimer(cuda)
    with timer:
        _, n = g.run()
    if n != rounds or g.placements() != placements:
        raise AssertionError("a timed gang run placed differently from the untimed one")
    return timer.ms()


def gang_path_kernels(g):
    """The K9 kernels a gang pass launches: gang_topk only below full width."""
    return [k for k in GANG_KERNELS if k != "gang_topk" or g.match_width < g.enc.N]


def gang_inputs(g, enc, rng, st, n_rows):
    """A random row list of the queue's pods (some bound at st) and a live
    count just below it, on the card."""
    rows = rng.permutation(np.asarray(enc.queue))[:n_rows].astype(np.int32)
    live = torch.tensor([max(1, len(rows) - 4)], dtype=torch.int32, device=enc.device)
    return torch.as_tensor(rows, device=enc.device), live


def compare_gang_kernels(kp, cuda, diff, path, enc, rng):
    """gang_eval (score rows; trace rows), gang_topk, gang_match (with and
    without carriers, full width and top-k) and gang_bind against their
    plain versions at 4 random states, exact."""
    g = kp.GangScheduler(enc)
    g._prep()
    prog, a, w, N = g._base.program, enc.arrays, g.weights, enc.N
    C = a.pod_claim.shape[1]
    n_carriers = int(g._carrier.sum()) if g._carrier is not None else 0
    for k in range(4):
        st = random_state(enc, rng, bind=True)
        rows, live = gang_inputs(g, enc, rng, st, 64)
        n = int(live)
        got = cuda.gang_eval(prog, a, st, w, rows, live, g._order)
        want = cuda.gang_eval_plain(prog, a, st, w, rows, live, g._order)
        diff.check(path, "gang_eval", f"{enc.policy.name} state {k} scores", got[:n], want[:n])
        Q = len(enc.queue)
        slot = torch.as_tensor(rng.choice(Q, len(rows), replace=False).astype(np.int32),
                               device=enc.device)
        traces = []
        for fn in (cuda.gang_eval, cuda.gang_eval_plain):
            tr = (torch.zeros((Q, len(prog.prefilters)), dtype=torch.int32, device=enc.device),
                  torch.zeros((Q, N, len(prog.filters)), dtype=torch.int32, device=enc.device),
                  torch.zeros((Q, N, len(prog.scores)), dtype=prog.score_dtype,
                              device=enc.device),
                  torch.zeros((Q, N, len(prog.scores)), dtype=prog.score_dtype,
                              device=enc.device))
            fn(prog, a, st, w, rows, None, g._order, check_pending=False, slot=slot, trace=tr)
            traces.append(tr)
        for name, x, y in zip(("pf", "codes", "raw", "final"), *traces):
            diff.check(path, "gang_eval", f"{enc.policy.name} state {k} trace {name}", x, y)
        for mw in (8, N):
            if mw < N:
                vals, idx = cuda.gang_topk(got, live, mw)
                pv, pi = cuda.gang_topk_plain(want, live, mw)
                diff.check(path, "gang_topk", f"state {k} vals", vals[:n], pv[:n])
                diff.check(path, "gang_topk", f"state {k} idx", idx[:n], pi[:n])
            else:
                vals, idx, pv, pi = got, None, want, None
            for carrier in (None, g._carrier):
                args = (rows, live, g._order, g._claims, carrier, N, C, 64)
                sel, stat = cuda.gang_match(vals, idx, *args)
                psel, pstat = cuda.gang_match_plain(pv, pi, *args)
                diff.check(path, "gang_match", f"state {k} width {mw} sel", sel, psel)
                diff.check(path, "gang_match", f"state {k} width {mw} stat", stat, pstat)
            s1 = cuda.gang_bind(prog, a, st.clone(), rows, live, sel, g._order)
            s2 = cuda.gang_bind_plain(prog, a, st.clone(), rows, live, sel, g._order)
            for f in STATE_FIELDS:
                diff.check(path, "gang_bind", f"state {k} width {mw} {f}", getattr(s1, f),
                           getattr(s2, f))
    log(f"  {path:13s} {enc.policy.name:5s}: gang_eval (64 rows, score and trace rows), "
        f"gang_topk (width 8), gang_match (width 8 and {N}, with and without the "
        f"{n_carriers} carriers) and gang_bind at 4 random states equal to plain")


def gang_records_equal(got, want, what):
    if [(r.pod_name, r.status, r.to_annotations()) for r in got] != [
            (r.pod_name, r.status, r.to_annotations()) for r in want]:
        raise AssertionError(f"{what}: the records differ")


def compare_gang(kp, cuda, diff, smi):
    """Phase 3 for K9: the four gang kernels against their plain versions on
    the 256-node dressed default cluster (64 pending pods) and the dressed
    affinity cluster (required anti-affinity carriers) under TPU32 and
    EXACT, one variant and V = 3, and on the default cluster annotated under
    the demo plugins' configuration (TPU32); then one whole gang pass, run_recorded()
    + results(), through the kernels on dressed_default_cluster(256, 300),
    TPU32. The plain versions' pass runs in the third process; phase 4h
    compares final state, rounds and every record (`check_plain_gang`).
    Returns what it needs."""
    from kube_scheduler_simulator_tpu_torch.synth import (
        DRESSED_NAMESPACES,
        dressed_affinity_cluster,
        dressed_default_cluster,
    )

    rng = np.random.default_rng(5)
    nodes, pods, objects = dressed_default_cluster(256, 64, seed=11)
    an, ap = dressed_affinity_cluster(256, 2000, seed=11)
    for pol in (kp.TPU32, kp.EXACT):
        enc_d = kp.encode_cluster(nodes, pods, kp.supported_config(), policy=pol, **objects)
        enc_a = kp.encode_cluster(an, ap, kp.affinity_config(), policy=pol,
                                  namespaces=DRESSED_NAMESPACES)
        compare_gang_kernels(kp, cuda, diff, "gang default", enc_d, rng)
        compare_gang_kernels(kp, cuda, diff, "gang affinity", enc_a, rng)
        compare_stacked_gang(kp, cuda, diff, "gang default", enc_d, rng)
        compare_stacked_gang(kp, cuda, diff, "gang affinity", enc_a, rng)
    # the demo plugins' bodies through gang_eval (attempt_body), one round's
    # kernels at 4 random states of the annotated default cluster
    pn, pp, pobj = plugins_cluster(kp, 256, 64)
    compare_gang_kernels(kp, cuda, diff, "gang plugins",
                         kp.encode_cluster(pn, pp, kp.demo_config(), policy=kp.TPU32, **pobj), rng)
    enc = gang_sweep3_encoding(kp)
    g = kp.GangScheduler(enc)
    cuda.reset_counts()
    t0 = time.perf_counter()
    got = g.results()
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    counts, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    if any(plain.values()) or counts["gang_eval"] < 1:
        raise AssertionError(f"whole gang pass: launches {counts}, plain calls {plain}")
    log(f"  gang default  TPU32: a whole gang pass, run_recorded() + results(), on "
        f"dressed_default_cluster(256, {DEFAULT_PHASE3_PENDING}): {g.last_stats}, "
        f"{len(got)} records; kernels {k_s:.3f} s (launches "
        f"{ {k: counts[k] for k in GANG_KERNELS + ('seq_run',)} }); the plain versions run in "
        f"the third process (4h) [{smi}]")
    return dict(digest=encoding_digest(enc), state=g._final_state, rounds=g._rounds,
                stats=dict(g.last_stats), records=record_rows(got))


def record_rows(records):
    return [(r.pod_name, r.status, r.to_annotations()) for r in records]


def check_plain_gang(cuda, diff, run, plain):
    """Phase 4h for phase 3's whole gang pass: final state, rounds, the
    engine's counts and every record against the plain versions' run."""
    if plain["digest"] != run["digest"]:
        raise AssertionError("phase 3 gang pass: the third process encoded other inputs")
    dev = run["state"].assignment.device
    for f in STATE_FIELDS:
        diff.check("gang default", "gang_bind", f"whole pass state {f}",
                   getattr(run["state"], f), plain["state"][f].to(dev))
    if run["rounds"] != plain["rounds"] or run["stats"] != plain["stats"]:
        raise AssertionError(f"whole gang pass: {run['stats']} against plain {plain['stats']}")
    if run["records"] != plain["records"]:
        raise AssertionError("whole gang pass: the records differ")
    log(f"    phase 3 gang pass: state, rounds and {len(run['records'])} records equal the "
        f"plain versions' (host CPU, {plain['seconds']:.3f} s)")


def masked_totals(cuda, prog, a, st, w, p):
    """The attempt's masked totals for pod p (NEG where infeasible), from
    seq_attempt's rows: what gang_eval writes for a pending pod."""
    codes, raw, final, sel, pf = cuda.seq_attempt(prog, a, st, w, p)
    feasible = (codes == 0).all(dim=1) & a.node_mask & (pf == 0).all()
    total = final.sum(dim=1, dtype=prog.score_dtype)
    return torch.where(feasible, total, torch.full_like(total, cuda._neg(prog.score_dtype)))


def drive_gang_default(kp, cuda, diff, nodes, pods, objects, sample, smi):
    """Phase 4e: the gang default path at full width: GangScheduler(enc,
    chunk=64) on preemption_cluster(1024, 10000), TPU32. run() with the
    counters set to 0 just before and read just after (K9 and the preempt
    phases' seq_run, no plain call), then a second run() with each kernel
    call between CUDA events; then run_recorded() and results() of the
    sampled pods: the same placements, the replay's seconds. Round 1's gang_eval rows of 64
    sampled pods must equal seq_attempt's masked totals at state0."""
    path, cfg = "gang default", kp.supported_config()
    t0 = time.perf_counter()
    enc = kp.encode_cluster(nodes, pods, cfg, policy=kp.TPU32, **objects)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    g = kp.GangScheduler(enc, chunk=64)
    grid, ws, scratch = cuda.gang_eval_scratch_bytes(g._base.program, enc.arrays)
    log(f"    gang_eval: {grid} blocks of {min(256, -(-enc.N // 32) * 32)} threads, each with "
        f"its own {ws:,} B workspace slice; {scratch:,} B of scratch a launch")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cuda.reset_counts()
    t0 = time.perf_counter()
    state, rounds = g.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() - base
    if (any(counts[k] < 1 for k in gang_path_kernels(g)) or counts["gang_topk"] and
            g.match_width == enc.N or counts["seq_run"] != g.last_stats["phases"]
            or any(plain.values())):
        raise AssertionError(f"the gang pass: launches {counts}, plain calls {plain}")
    stats = dict(g.last_stats)
    placements = g.placements()
    kms = timed_run(kp, cuda, enc, placements, rounds, chunk=64)
    Q = len(enc.queue)
    n_placed = sum(1 for v in placements.values() if v)
    per_round = {k: kms[k] / rounds for k in GANG_KERNELS}
    log(f"    run(): {run_s:.3f} s wall (encode {enc_s:.3f} s apart), {Q / run_s:.1f} "
        f"decisions/s, {n_placed} of {Q} pending placed, {rounds} rounds, "
        f"{stats['phases']} preempt phases over {stats['phase_pods']} pods, "
        f"{stats['host_syncs']} host readbacks by the driver (and 3 in each phase's "
        f"seq_run), peak memory {peak / 2**30:.3f} GiB; device ms per round (a second "
        f"run, timed): "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_round.items())
        + f"; phases' seq_run {kms['seq_run']:.1f} ms in all; launches "
        f"{ {k: counts[k] for k in GANG_KERNELS + ('seq_run',)} }, plain calls none [{smi}]")

    # the record path: the same placements, the replay's seconds
    g2 = kp.GangScheduler(enc, chunk=64)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cuda.reset_counts()
    t0 = time.perf_counter()
    g2.run_recorded()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    g2._trace = g2._assemble_trace()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    results = g2.results(pods=sample)
    t3 = time.perf_counter()
    rec_peak = torch.cuda.max_memory_allocated() - base
    rec_counts = dict(cuda.LAUNCHES)
    if g2.placements() != placements or not torch.equal(g2._final_state.assignment,
                                                        state.assignment):
        raise AssertionError("gang default: run_recorded() places differently from run()")
    t = dict(zip(cuda.TRACE_SLOTS_PREEMPT, g2._trace))
    did, nominated = t["did"], t["nominated"]
    n_did, n_nom = int(did.sum()), int((nominated >= 0).sum())
    if len(results) < len(sample) or any(r.selected_node and r.selected_node != placements[
            (r.pod_namespace, r.pod_name)] for r in results if r.status == "Scheduled"):
        raise AssertionError("gang default: the sampled records disagree with the placements")
    log(f"    run_recorded() + results(): {t3 - t0:.3f} s wall ({Q / (t3 - t0):.1f} "
        f"decisions/s): the drive {t1 - t0:.3f} s (the phases' traces recorded), the replay "
        f"{t2 - t1:.3f} s, decode of {len(sample)} sampled pods {t3 - t2:.3f} s; peak memory "
        f"{rec_peak / 2**30:.3f} GiB; placements equal run()'s; the phases' dry runs {n_did}, "
        f"nominations {n_nom}; launches { {k: rec_counts[k] for k in GANG_KERNELS + ('seq_run',)} }")

    # round 1's evaluation of 64 sampled pods against the sequential attempt
    prog, a, w = g._base.program, enc.arrays, g.weights
    rng = np.random.default_rng(7)
    rows = torch.as_tensor(rng.choice(np.asarray(enc.queue), 64, replace=False).astype(np.int32),
                           device=enc.device)
    got = cuda.gang_eval(prog, a, enc.state0, w, rows, None, g._order)
    want = torch.stack([masked_totals(cuda, prog, a, enc.state0, w, int(p)) for p in rows])
    diff.check(path, "gang_eval", "round 1 against seq_attempt", got, want)
    log("    round 1's gang_eval rows of 64 sampled pods equal seq_attempt's masked totals at "
        "state0")
    return dict(enc=enc, g=g, counts=counts, kms=kms, rounds=rounds, stats=stats)


def drive_gang_affinity(kp, cuda, nodes, pods, seq_placements, smi):
    """Phase 4e, second part: run() on BASELINE config #3 under
    affinity_config(): every pod carries a required anti-affinity term, so
    each takes an exclusive round (rel_serialize)."""
    enc = kp.encode_cluster(nodes, pods, kp.affinity_config(), policy=kp.TPU32)
    g = kp.GangScheduler(enc)
    torch.cuda.synchronize()
    cuda.reset_counts()
    t0 = time.perf_counter()
    _, rounds = g.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    if (any(counts[k] < 1 for k in ("gang_eval", "gang_match", "gang_bind"))
            or counts["gang_topk"] or any(plain.values())):
        raise AssertionError(f"the affinity gang pass: launches {counts}, plain calls {plain}")
    placements = g.placements()
    kms = timed_run(kp, cuda, enc, placements, rounds)
    same = sum(1 for k, v in placements.items() if seq_placements.get(k) == v)
    log(f"    affinity run(): {enc.n_nodes} nodes x {len(enc.queue)} pods, "
        f"{int(g._carrier.sum())} carriers: {run_s:.3f} s wall, {len(enc.queue) / run_s:.1f} "
        f"decisions/s, {rounds} rounds, {g.last_stats['host_syncs']} host readbacks, "
        f"{sum(1 for v in placements.values() if v)} placed ({same} placements equal the "
        f"sequential pass's); device ms in all (a second run, timed): "
        + ", ".join(f"{k} {kms[k]:.1f}" for k in GANG_KERNELS)
        + f" (per round {sum(kms[k] for k in GANG_KERNELS) / rounds:.3f}); launches "
        f"{ {k: counts[k] for k in GANG_KERNELS} } [{smi}]")
    return dict(run_s=run_s, rounds=rounds, kms=kms, enc=enc, placements=placements,
                state=g._final_state, host_syncs=g.last_stats["host_syncs"], counts=counts)


def gang_rows(kp, cuda, diff, run, smi):
    """Phase 5 for K9 at the full-width default path's round 1 (state0, the
    queue's 10,000 pods pending): gang_topk, gang_match and gang_bind at
    its shapes; gang_eval, whose plain version takes about 15 ms a pod,
    over the first 64 pending rows. Each held against its plain version
    there first. Bounds: bytes over 3.35 TB/s or operations over 67
    TFLOP/s, the larger; gang_eval's bytes the cluster planes and state
    read once and the rows written, its operations 64 attempts'."""
    enc, g = run["enc"], run["g"]
    prog, a, w, N = g._base.program, enc.arrays, g.weights, enc.N
    C = a.pod_claim.shape[1]
    st0 = enc.state0
    rows, count = g._pending(cuda.as_variants(st0), sort=True)
    rows, count = rows[0], count[:1]
    K, mw, isz = rows.shape[0], g.match_width, a.node_alloc.element_size()
    live64 = torch.tensor([64], dtype=torch.int32, device=enc.device)
    scores = cuda.gang_eval(prog, a, st0, w, rows, count, g._order)
    want64 = cuda.gang_eval_plain(prog, a, st0, w, rows, live64, g._order)
    diff.check("gang default", "gang_eval", "round 1, 64 rows", scores[:64], want64[:64])
    eval_ms = events_ms(lambda: cuda.gang_eval(prog, a, st0, w, rows, live64, g._order), 20)
    eval_plain_ms = events_ms(lambda: cuda.gang_eval_plain(prog, a, st0, w, rows, live64,
                                                           g._order), 1, 1)
    eval_round_ms = events_ms(lambda: cuda.gang_eval(prog, a, st0, w, rows, count, g._order),
                              1, 3)
    ops = sum(attempt_cost(enc, prog, st0, int(p), w)[1] for p in rows[:64].tolist())
    state_bytes = nbytes(*(getattr(st0, f) for f in STATE_FIELDS))
    b_eval = bound(cluster_bytes(enc) + state_bytes + 64 * N * isz, ops)
    vals, idx = cuda.gang_topk(scores, count, mw)
    pv, pi = cuda.gang_topk_plain(scores, count, mw)
    diff.check("gang default", "gang_topk", "round 1 vals", vals, pv)
    diff.check("gang default", "gang_topk", "round 1 idx", idx, pi)
    topk_ms = events_ms(lambda: cuda.gang_topk(scores, count, mw), 5)
    topk_plain_ms = events_ms(lambda: cuda.gang_topk_plain(scores, count, mw), 3)
    topk_lib_ms = events_ms(lambda: torch.topk(scores, mw, dim=1), 5)
    b_topk = bound(K * N * isz + K * mw * (isz + 4), K * N)
    args = (rows, count, g._order, g._claims, g._carrier, N, C, g.inner_iters)
    sel, stat = cuda.gang_match(vals, idx, *args)
    psel, pstat = cuda.gang_match_plain(vals, idx, *args)
    diff.check("gang default", "gang_match", "round 1 sel", sel, psel)
    diff.check("gang default", "gang_match", "round 1 stat", stat, pstat)
    match_ms = events_ms(lambda: cuda.gang_match(vals, idx, *args), 5)
    match_plain_ms = events_ms(lambda: cuda.gang_match_plain(vals, idx, *args), 1, 3)
    b_match = bound(K * mw * (isz + 4) + K * 4 * 3 + 4 * K, K * mw)
    s1 = cuda.gang_bind(prog, a, st0.clone(), rows, count, sel, g._order)
    s2 = cuda.gang_bind_plain(prog, a, st0.clone(), rows, count, sel, g._order)
    for f in STATE_FIELDS:
        diff.check("gang default", "gang_bind", f"round 1 {f}", getattr(s1, f), getattr(s2, f))
    committed = int(stat[0])
    st_b = st0.clone()
    bind_ms = events_ms(lambda: cuda.gang_bind(prog, a, st_b, rows, count, sel, g._order), 20)
    st_p = st0.clone()
    bind_plain_ms = events_ms(lambda: cuda.gang_bind_plain(prog, a, st_p, rows, count, sel,
                                                           g._order), 5)
    keep = sel >= 0
    pods_c, tgt = rows[keep].long(), sel[keep].long()
    srcs = {f: getattr(a, src)[pods_c] for f, src in (
        ("requested", "pod_req"), ("s_requested", "pod_sreq"), ("used_pair", "want_pair"),
        ("used_wild", "want_wild"), ("used_trip", "want_trip"),
        ("node_disk_any", "pod_disk_any"), ("node_disk_rw", "pod_disk_rw"),
        ("node_vol3", "pod_vol3"))}
    ones = torch.ones_like(tgt, dtype=torch.int32)
    claims = a.pod_claim[pods_c].to(torch.int32)
    seqs = g._order[pods_c] + enc.P
    tgt32 = tgt.to(torch.int32)

    def bind_lib(st):
        # bind_all as PyTorch calls, the committed rows gathered beforehand:
        # index_add_ over every plane it writes, the claim counts summed,
        # assignment and bound_seq set
        for f, src in srcs.items():
            getattr(st, f).index_add_(0, tgt, src)
        st.n_pods.index_add_(0, tgt, ones)
        st.used_claims.add_(claims.sum(dim=0, dtype=torch.int32))
        st.assignment.index_put_((pods_c,), tgt32)
        st.bound_seq.index_put_((pods_c,), seqs)

    st_l = st0.clone()
    bind_lib(st_l)
    if not all(torch.equal(getattr(st_l, f), getattr(s1, f)) for f in STATE_FIELDS):
        raise AssertionError("the index_add_ form of gang_bind disagrees with the kernel")
    st_l = st0.clone()
    bind_lib_ms = events_ms(lambda: bind_lib(st_l), 20)
    pod_row = nbytes(a.pod_req[0], a.pod_sreq[0], a.want_pair[0], a.want_wild[0],
                     a.want_trip[0], a.pod_claim[0], a.pod_disk_any[0], a.pod_disk_rw[0],
                     a.pod_vol3[0])
    node_row = nbytes(st0.requested[0], st0.s_requested[0], st0.used_pair[0],
                      st0.used_wild[0], st0.used_trip[0], st0.node_disk_any[0],
                      st0.node_disk_rw[0], st0.node_vol3[0], st0.n_pods[0])
    b_bind = bound(4 * 3 * K + committed * (pod_row + 2 * node_row + 8),
                   committed * (pod_row // 4 + 2))
    log(f"    K9 at round 1 of the full-width default gang ({K} pending rows, {committed} "
        f"committed): gang_eval over all rows {eval_round_ms:.3f} ms; gang_bind's library "
        f"time is index_add_ over every plane bind_all writes [{smi}]")
    rows_out = []
    for name, ms, plain_ms, b, lib, shape in (
            ("gang_eval", eval_ms, eval_plain_ms, b_eval, None, "64 rows"),
            ("gang_topk", topk_ms, topk_plain_ms, b_topk, topk_lib_ms, f"{K} x {N} -> {mw}"),
            ("gang_match", match_ms, match_plain_ms, b_match, None, f"{K} x {mw}"),
            ("gang_bind", bind_ms, bind_plain_ms, b_bind, bind_lib_ms, f"{committed} commits")):
        rows_out.append({"name": name, "path": "gang default", "route": "cuda",
                         "source": GANG_SOURCE, "replaces": REPLACES[name],
                         "launches": run["counts"][name],
                         "max_abs_err": diff.err[("gang default", name)], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                         "library_ms": lib, "shape": shape})
        log(f"    gang default {name:10s} {ms:.6f} ms at {shape} (plain {plain_ms:.3f} ms, "
            f"bound {b[0]:.7f} ms by {b[1]}, library "
            f"{'none' if lib is None else f'{lib:.6f} ms'}), {run['counts'][name]} launches "
            f"on the main path [{smi}]")
    return rows_out


def drive_serving_gang(kp, cuda, diff, smi):
    """Phase 4f: three schedule_gang(record=True) passes of 128 arrivals in
    a 1,024-node SimulatorService session on the card (the second with
    window=64). The counters are set to 0 just before each pass and read
    just after: K9 and no plain version. Each pass's records are written
    back onto the pods; the third is held against the plain gang on the
    card over a from-scratch encode of the store."""
    from kube_scheduler_simulator_tpu_torch.server.service import SimulatorService, gang_chunk

    t_setup = time.perf_counter()
    snap, later, n_kept = serving_snapshot(kp, SERVING_NODES, SERVING_PODS, SERVING_BOUND, seed=7)
    sim = SimulatorService()
    sim.import_(snap)
    store, sched = sim.store, sim.scheduler
    log(f"    snapshot: {SERVING_NODES} nodes, {n_kept} pods bound, {SERVING_ARRIVALS} pending; "
        f"set-up {time.perf_counter() - t_setup:.1f} s")
    walls = []
    for k, window in ((1, None), (2, 64), (3, None)):
        if k > 1:
            for pd in later[(k - 2) * SERVING_ARRIVALS:(k - 1) * SERVING_ARRIVALS]:
                store.apply("pods", pd)
        fresh = store_encode(kp, store, sched.config, kp.TPU32) if k == 3 else None
        cuda.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        placements, rounds, results = sched.schedule_gang(record=True, window=window)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls.append(wall)
        counts, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
        engine = next(reversed(sched._engines.values()))
        if any(counts[n] < 1 for n in gang_path_kernels(engine)) or any(plain.values()):
            raise AssertionError(f"gang pass {k}: launches {counts}, plain calls {plain}")
        last = {(r.pod_namespace, r.pod_name): r for r in results}
        for (ns, name), r in last.items():
            pd = store.get("pods", name, ns)
            if (pd["metadata"].get("annotations") != r.to_annotations()
                    or pd["spec"].get("nodeName", "") != placements[ns, name]):
                raise AssertionError(f"gang pass {k}: pod {ns}/{name} was written back wrong")
        extra = ""
        if fresh is not None:
            p = kp.GangScheduler(fresh, chunk=gang_chunk())
            t1 = time.perf_counter()
            with plain_gang(cuda):
                want = p.results()
            torch.cuda.synchronize()
            gang_records_equal(results, want, f"gang pass {k}")
            if p.placements() != placements:
                raise AssertionError(f"gang pass {k}: placements differ from the plain gang's")
            extra = (f"; the plain gang on the card over a from-scratch encode "
                     f"({time.perf_counter() - t1:.3f} s) gives the same records")
        log(f"    gang pass {k} (window {window}): {sched.last_encode_info['mode']} encode, "
            f"{rounds} rounds, {engine.last_stats['host_syncs']} host readbacks, wall "
            f"{wall:.3f} s; {len(results)} records written back, "
            f"{sum(1 for v in placements.values() if v)} placed; launches "
            f"{ {n: counts[n] for n in GANG_KERNELS} }{extra} [{smi}]")
    log(f"    3 gang passes in {sum(walls):.3f} s: {3 / sum(walls):.3f} passes/s; engines "
        f"built {sched.metrics.phases()['engineBuilds']}")


# ---------------------------------------------------------------------------
# K11: the weight sweep (phases 3, 4g and its kernel row)
# ---------------------------------------------------------------------------


def sweep_weights(kp, enc, n_variants, seed):
    """[V, S] int32: row 0 the configuration's own weights, the other rows
    integers 1-10 per score plugin from default_rng(seed)."""
    base = kp.weights_for(enc, {})
    rng = np.random.default_rng(seed)
    rest = rng.integers(1, 11, (n_variants - 1, len(base))).astype(np.int32)
    return np.concatenate([base[None, :], rest])


def sampled_variants(n_variants):
    """Phase 4g's two sampled variants besides variant 0."""
    rng = np.random.default_rng(SWEEP_SEED)
    return sorted(rng.choice(np.arange(1, n_variants), 2, replace=False).tolist())


def sweep_inputs(enc, w):
    """The stacked initial states, the queue and the weights of a direct
    `sweep_run` launch on the encoding's device."""
    from kube_scheduler_simulator_tpu_torch.engine import cuda

    states0 = cuda.stack_states([enc.state0] * len(w))
    queue = torch.as_tensor(np.asarray(enc.queue, np.int32), device=enc.device)
    return states0, queue, torch.as_tensor(w, device=enc.device).to(enc.policy.score)


def phase3_sweep_encoding(kp, pol, device=None):
    from kube_scheduler_simulator_tpu_torch.synth import dressed_default_cluster

    nodes, pods, objects = dressed_default_cluster(256, DEFAULT_PHASE3_PENDING, seed=11)
    return kp.encode_cluster(nodes, pods, kp.supported_config(), policy=pol, device=device,
                             **objects)


def compare_sweep(kp, cuda, diff):
    """Phase 3 for K11: `supported_config()` on the dressed default cluster
    (dry runs fire), three variants, TPU32 and EXACT: `WeightSweep.run`
    with and without the trace through `sweep_run`, and one launch of two
    blocks (fewer than the variants: the grid-stride walk) against the
    first. The plain version runs in the second process; phase 4h holds
    these against it (`check_plain_sweep`). Returns what it needs."""
    runs = {}
    for pol in (kp.TPU32, kp.EXACT):
        enc = phase3_sweep_encoding(kp, pol)
        w = sweep_weights(kp, enc, PHASE3_VARIANTS, seed=3)
        cuda.reset_counts()
        st_r, tr_r = kp.WeightSweep(enc, record=True).run(w)
        st_n, sel_n = kp.WeightSweep(enc).run(w)
        if cuda.LAUNCHES["sweep_run"] != 2 or any(cuda.PLAIN_CALLS.values()):
            raise AssertionError(f"phase 3 sweeps: {cuda.LAUNCHES} {cuda.PLAIN_CALLS}")
        prog = kp.BatchedScheduler(enc, record=False).program
        st_g, tr_g = cuda.sweep_run(prog, enc.arrays, *sweep_inputs(enc, w), record=True, grid=2)
        for name, g, h in zip(cuda.TRACE_SLOTS_PREEMPT, tr_g, tr_r):
            diff.check("default", "sweep_run", f"{pol.name} two blocks {name}", g, h)
        for f in STATE_FIELDS:
            diff.check("default", "sweep_run", f"{pol.name} two blocks state {f}",
                       getattr(st_g, f), getattr(st_r, f))
            diff.check("default", "sweep_run", f"{pol.name} unrecorded state {f}",
                       getattr(st_n, f), getattr(st_r, f))
        did = tr_r[cuda.TRACE_SLOTS_PREEMPT.index("did")]
        log(f"  default  {pol.name:5s} sweep_run: {PHASE3_VARIANTS} variants x "
            f"{len(enc.queue)} steps, with and without the trace and on two blocks; dry runs by "
            f"variant {did.sum(dim=1).tolist()}")
        if not bool((did.sum(dim=1) > 0).all()):
            raise AssertionError("phase 3 sweep: a variant ran no dry run")
        runs[pol.name] = dict(digest=encoding_digest(enc), states=st_r, trace=tr_r,
                              unrecorded=(st_n, sel_n))
    return runs


def check_plain_sweep(cuda, diff, runs, plain):
    """Phase 4h for phase 3's sweeps: every variant's final state, trace
    (victim records included) and selections against the plain sweep."""
    for pol, run in runs.items():
        want = plain[pol]
        if want["digest"] != run["digest"]:
            raise AssertionError(f"phase 3 sweep {pol}: the second process encoded other inputs")
        dev = run["states"].assignment.device
        for name, g, h in zip(cuda.TRACE_SLOTS_PREEMPT, run["trace"], want["trace"]):
            diff.check("default", "sweep_run", f"{pol} {name}", g, h.to(dev))
        for f in STATE_FIELDS:
            diff.check("default", "sweep_run", f"{pol} state {f}", getattr(run["states"], f),
                       want["states"][f].to(dev))
        final_sel = want["trace"][cuda.TRACE_SLOTS_PREEMPT.index("final_sel")].to(dev)
        diff.check("default", "sweep_run", f"{pol} unrecorded selections", run["unrecorded"][1],
                   final_sel)
        log(f"    phase 3 sweep {pol}: {PHASE3_VARIANTS} variants' traces, victims, states and "
            f"selections equal the plain sweep's (host CPU, {want['seconds']:.3f} s)")


def dry_runs_fired(enc, states, sels):
    """Per variant of an unrecorded sweep: (steps whose dry run left the pod
    unschedulable, pre-bound pods evicted). A step runs its dry run when
    its pod is unschedulable and passed the prefilter; a dry run that
    nominates evicts, and one that does not leaves the pod unschedulable,
    so a variant ran a dry run exactly when one of the two is nonzero."""
    a = enc.arrays
    queue = torch.as_tensor(np.asarray(enc.queue, np.int64), device=enc.device)
    pf_ok = a.pod_mask[queue] & ((a.vb_pf[queue] == 0) | (enc.config.enabled("preFilter").count(
        "VolumeBinding") == 0))
    unsched = ((sels < 0) & pf_ok[None, :]).sum(dim=1)
    pre = enc.state0.assignment >= 0
    evicted = ((states.assignment < 0) & pre[None, :]).sum(dim=1)
    return unsched, evicted


def config4_encoding(kp):
    nodes, pods = kp.synthetic_cluster(SWEEP_NODES, SWEEP_PODS, seed=SWEEP_SEED)
    return kp.encode_cluster(nodes, pods, kp.supported_config(), policy=kp.TPU32)


def timed_sweep(cuda, sweep, w):
    """`sweep.run(w)` with the counters set to 0 just before and read just
    after: (states, selections, wall s, device ms, peak bytes, launches,
    plain calls)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cuda.reset_counts()
    t0 = time.perf_counter()
    e0.record()
    states, sels = sweep.run(w)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    if counts["sweep_run"] != 1 or any(v for k, v in counts.items() if k != "sweep_run") or any(
            plain.values()):
        raise AssertionError(f"the sweep: launches {counts}, plain calls {plain}")
    return (states, sels, wall, e0.elapsed_time(e1), torch.cuda.max_memory_allocated() - base,
            counts, plain)


def drive_sweep(kp, cuda, diff, dflt, smi):
    """Phase 4g: BASELINE config #4 — 1,000 score-weight variants of
    `synthetic_cluster(1024, 10000, seed=42)` under `supported_config()`,
    TPU32, no trace — through `WeightSweep.run`: one `sweep_run` launch and
    no plain call. Variant 0 against the engine's own pass, two sampled
    variants against single-variant `seq_run` launches. Then a preempting
    sweep, one variant per SM, on phase 4c's cluster: variant 0 against
    phase 4c's final state, evictions in every variant."""
    t0 = time.perf_counter()
    enc = config4_encoding(kp)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    w = sweep_weights(kp, enc, SWEEP_VARIANTS, seed=SWEEP_SEED)
    sweep = kp.WeightSweep(enc)
    states, sels, wall, dev_ms, peak, counts, _ = timed_sweep(cuda, sweep, w)
    V, Q = w.shape[0], len(enc.queue)
    unsched, evicted = dry_runs_fired(enc, states, sels)
    distinct = len({tuple(r) for r in sels.cpu().numpy().tolist()})
    log(f"    WeightSweep.run: {V} variants x {Q} pods on {enc.N} nodes in {wall:.3f} s wall "
        f"(encode {enc_s:.3f} s apart), {V * Q / wall:.1f} decisions/s, sweep_run "
        f"{dev_ms:.1f} ms on the card, peak memory {peak / 2**30:.3f} GiB above what was held, "
        f"launches {counts['sweep_run']} sweep_run, plain calls none; {distinct} distinct "
        f"placement vectors; variants that ran a dry run: "
        f"{int(((unsched > 0) | (evicted > 0)).sum())} of {V} (pods left unschedulable after "
        f"their dry run: {int(unsched.sum())} in all, evictions {int(evicted.sum())}) [{smi}]")
    eng = kp.BatchedScheduler(enc, record=False)
    st0, out0 = eng.run()
    for f in STATE_FIELDS:
        diff.check("config4", "sweep_run", f"variant 0 state {f}", getattr(states, f)[0],
                   getattr(st0, f))
    diff.check("config4", "sweep_run", "variant 0 selections", sels[0], out0[:Q])
    picked = sampled_variants(V)
    q = torch.as_tensor(np.asarray(enc.queue, np.int32), device=enc.device)
    one_ms = []
    for v in picked:
        wv = torch.as_tensor(w[v], device=enc.device).to(enc.policy.score)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        st_v, sel_v = cuda.seq_run(eng.program, enc.arrays, enc.state0, q, wv, record=False)
        e1.record()
        torch.cuda.synchronize()
        one_ms.append(e0.elapsed_time(e1))
        for f in STATE_FIELDS:
            diff.check("config4", "sweep_run", f"variant {v} state {f}", getattr(states, f)[v],
                       getattr(st_v, f))
        diff.check("config4", "sweep_run", f"variant {v} selections", sels[v], sel_v)
    log(f"    variant 0 equals BatchedScheduler(record=False).run(); variants {picked} equal "
        f"single-variant seq_run launches with their weights")
    most = int(getattr(cuda.library(), "sweep_run_grid_i32")(enc.N, int(eng.preempts)))
    blocks, one = min(V, most), statistics.mean(one_ms)
    log(f"    one variant alone (seq_run over the {Q} pods, variants {picked}): "
        + " / ".join(f"{x:.1f}" for x in one_ms) + f" ms on the card; the sweep ran {blocks} "
        f"blocks of {min(1024, -(-enc.N // 32) * 32)} threads, {V / blocks:.2f} variants a "
        f"block: {V * one / dev_ms:.1f} variants' seq_run at once")
    out = dict(enc=enc, eng=eng, w=w, wall=wall, dev_ms=dev_ms, counts=counts,
               state0=states, sels=sels, picked=picked, one_ms=one)

    # the preempting sweep: one variant per SM on phase 4c's cluster
    enc_d = dflt["enc"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    w_d = sweep_weights(kp, enc_d, n_sm, seed=7)
    states_d, sels_d, wall_d, dev_ms_d, peak_d, counts_d, _ = timed_sweep(
        cuda, kp.WeightSweep(enc_d), w_d)
    for f in STATE_FIELDS:
        diff.check("default", "sweep_run", f"preempting sweep variant 0 state {f}",
                   getattr(states_d, f)[0], getattr(dflt["eng"]._final_state, f))
    unsched, evicted = dry_runs_fired(enc_d, states_d, sels_d)
    if not bool(((unsched > 0) | (evicted > 0)).all()):
        raise AssertionError("the preempting sweep: a variant ran no dry run")
    placed = (sels_d >= 0).sum(dim=1).float()
    Qd = len(enc_d.queue)
    log(f"    preempting sweep: {n_sm} variants (one per SM) x {Qd} pods on phase 4c's cluster in "
        f"{wall_d:.3f} s wall, {n_sm * Qd / wall_d:.1f} decisions/s, sweep_run {dev_ms_d:.1f} ms "
        f"on the card, peak memory {peak_d / 2**30:.3f} GiB; variant 0 equals phase 4c's final "
        f"state; dry runs in every variant: pre-bound pods evicted (min/median/max "
        f"{int(evicted.min())}/{int(evicted.median())}/{int(evicted.max())}), pods left "
        f"unschedulable after their dry run ({int(unsched.min())}/{int(unsched.median())}/"
        f"{int(unsched.max())}); placed "
        f"{int(placed.min())}..{int(placed.max())} of {Qd}; launches {counts_d['sweep_run']} "
        f"sweep_run, plain calls none [{smi}]")
    out.update(preempting=dict(V=n_sm, wall=wall_d, dev_ms=dev_ms_d))
    return out


def sweep_row(cuda, diff, run, plain, plain_v, smi):
    """Phase 5e: the K11 row at config #4's shape. Variant 0 and the first
    sampled variant against their plain passes (host CPU, second process);
    the sampled one carries random weights and runs in a block whose
    scratch an earlier variant used. ms: CUDA events around phase 4g's
    launch; plain: variant 0's plain pass, one variant (V times it is only
    printed, as an estimate); bound: each input read once (the cluster
    planes, V initial states, the weights, the queue) and each output
    written once (V final states, the selections), against the steps'
    operations for every variant."""
    enc, eng, w = run["enc"], run["eng"], run["w"]
    V, Q = w.shape[0], len(enc.queue)
    v = plain_v["v"]
    if plain["digest"] != encoding_digest(enc) or plain_v["digest"] != plain["digest"]:
        raise AssertionError("config #4: the second process encoded other inputs")
    if v != run["picked"][0] or not np.array_equal(plain_v["weights"], w[v]):
        raise AssertionError(f"config #4: the second process ran other weights for variant {v}")
    for i, pl in ((0, plain), (v, plain_v)):
        for f in STATE_FIELDS:
            diff.check("config4", "sweep_run", f"variant {i} against the plain pass {f}",
                       getattr(run["state0"], f)[i], pl["state"][f].to(enc.device))
        diff.check("config4", "sweep_run", f"variant {i} selections against the plain pass",
                   run["sels"][i], pl["sels"].to(enc.device))
    prog = eng.program
    state_bytes = nbytes(*(getattr(enc.state0, f) for f in STATE_FIELDS))
    st_mid, q_mid = mid_state(cuda, eng)
    step_ops = ops_per_node(enc, prog) * enc.N + rel_reads(enc, prog, st_mid, q_mid)[1]
    b = bound(cluster_bytes(enc) + 2 * V * state_bytes + 4 * Q + w.size * w.itemsize
              + 4 * V * Q, step_ops * Q * V)
    per_step = bound(cluster_bytes(enc) * Q * V, 0)[0]
    plain_ms = plain["seconds"] * 1e3
    log(f"    sweep_run, config #4 ({V} variants x {Q} steps, {enc.N} nodes): {run['dev_ms']:.3f} "
        f"ms on the card, {run['counts']['sweep_run']} launch; variants 0 and {v} equal their "
        f"plain passes on the host CPU ({plain['seconds']:.3f} / {plain_v['seconds']:.3f} s); "
        f"plain {plain_ms:.1f} ms for one variant (estimate for all {V}, not run: "
        f"{plain_ms * V:.1f} ms); bound {b[0]:.3f} ms by {b[1]} (reading the cluster planes "
        f"once a step and variant instead: {per_step:.3f} ms) [{smi}]")
    return [{"name": "sweep_run", "path": "config4", "route": "cuda", "source": SOURCE,
             "replaces": REPLACES["sweep_run"], "launches": run["counts"]["sweep_run"],
             "max_abs_err": max(diff.err[p, "sweep_run"] for p in ("default", "config4")),
             "ms": run["dev_ms"], "plain_ms": plain_ms,
             "plain_basis": "1 variant (variant 0's plain pass on the host CPU)",
             "bound_ms": b[0], "bound_by": b[1], "library_ms": None}]


# ---------------------------------------------------------------------------
# K9 x K11: the gang weight sweep (phases 3, 4i and its kernel rows, 5f)
# ---------------------------------------------------------------------------


def stacked_weights(w):
    """Three variants' weights [3, S] from one row: w, all ones, 3 w + 1."""
    return torch.stack([w, torch.ones_like(w), w * 3 + 1]).contiguous()


def compare_stacked_gang(kp, cuda, diff, path, enc, rng):
    """Phase 3 for the variant axis: gang_eval, gang_topk, gang_match (with
    and without carriers, full width and top-k) and gang_bind at V = 3, one
    launch each, against their plain versions (each variant alone): random
    per-variant states, weights and row lists of 64 pods, the live counts
    60, 0 (a frozen variant) and 64."""
    g = kp.GangScheduler(enc)
    g._prep()
    prog, a, N = g._base.program, enc.arrays, enc.N
    C = a.pod_claim.shape[1]
    states = cuda.stack_states([random_state(enc, rng, bind=True) for _ in range(3)])
    w = stacked_weights(g.weights)
    K = min(64, len(enc.queue))
    rows = torch.as_tensor(np.stack([rng.permutation(np.asarray(enc.queue))[:K]
                                     for _ in range(3)]).astype(np.int32), device=enc.device)
    live = torch.tensor([K - 4, 0, K], dtype=torch.int32, device=enc.device)
    n_live = live.tolist()
    tag = f"{path} {enc.policy.name} V=3"
    got = cuda.gang_eval(prog, a, states, w, rows, live, g._order)
    want = cuda.gang_eval_plain(prog, a, states, w, rows, live, g._order)
    for v, n in enumerate(n_live):
        diff.check("gangsweep", "gang_eval", f"{tag} variant {v} scores", got[v, :n], want[v, :n])
    vals, idx = cuda.gang_topk(got, live, 8)
    pv, pi = cuda.gang_topk_plain(want, live, 8)
    for v, n in enumerate(n_live):
        diff.check("gangsweep", "gang_topk", f"{tag} variant {v} vals", vals[v, :n], pv[v, :n])
        diff.check("gangsweep", "gang_topk", f"{tag} variant {v} idx", idx[v, :n], pi[v, :n])
    for kv, ki, wv, wi, mw in ((vals, idx, pv, pi, 8), (got, None, want, None, N)):
        for carrier in (None, g._carrier):
            args = (rows, live, g._order, g._claims, carrier, N, C, 64)
            sel, stat = cuda.gang_match(kv, ki, *args)
            psel, pstat = cuda.gang_match_plain(wv, wi, *args)
            diff.check("gangsweep", "gang_match", f"{tag} width {mw} sel", sel, psel)
            diff.check("gangsweep", "gang_match", f"{tag} width {mw} stat", stat, pstat)
        s1 = cuda.gang_bind(prog, a, states.clone(), rows, live, sel, g._order)
        s2 = cuda.gang_bind_plain(prog, a, states.clone(), rows, live, sel, g._order)
        for f in STATE_FIELDS:
            diff.check("gangsweep", "gang_bind", f"{tag} width {mw} {f}", getattr(s1, f),
                       getattr(s2, f))
    log(f"  {path:13s} {enc.policy.name:5s}: gang_eval, gang_topk (width 8), gang_match "
        f"(width 8 and {N}, with and without carriers) and gang_bind at V = 3 (live "
        f"{n_live}), one launch each, equal to plain")


def compare_segments(cuda, diff, phase):
    """Phase 3 for `gangsweep.vphase`: the first preempt phase of phase 3's
    gang sweep (`phase`: its launch's inputs, each variant's pending pods
    at the end of its gang pass with their queue positions, from the
    variants' own states) with one more variant whose segment is all
    padding, in one sweep_run launch, against the plain version; variant 0
    also against seq_run_plain on its own unpadded segment."""
    prog, a, st_in, segs, w, qpos = phase
    V, K = segs.shape
    segs = torch.cat([segs, segs.new_full((1, K), -1)])
    qpos = torch.cat([qpos, qpos.new_zeros((1, K))])
    w = torch.cat([w, w[:1]])
    st0 = cuda.stack_states([cuda.variant_state(st_in, v) for v in range(V)]
                            + [cuda.variant_state(st_in, 0)])
    cuda.reset_counts()
    s_k, sel_k = cuda.sweep_run(prog, a, st0, segs, w, record=False, qpos=qpos)
    if cuda.LAUNCHES["sweep_run"] != 1 or any(cuda.PLAIN_CALLS.values()):
        raise AssertionError(f"segmented sweep_run: {cuda.LAUNCHES} {cuda.PLAIN_CALLS}")
    t0 = time.perf_counter()
    s_p, sel_p = cuda.sweep_run_plain(prog, a, st0, segs, w, record=False, qpos=qpos)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    diff.check("gangsweep", "sweep_run", "segments selections", sel_k, sel_p)
    for f in STATE_FIELDS:
        diff.check("gangsweep", "sweep_run", f"segments state {f}", getattr(s_k, f),
                   getattr(s_p, f))
        diff.check("gangsweep", "sweep_run", f"all-padding segment state {f}",
                   getattr(s_k, f)[V], getattr(st0, f)[V])
    n = int((segs[0] >= 0).sum())
    st, sel = cuda.seq_run_plain(prog, a, cuda.variant_state(st0, 0), segs[0, :n].contiguous(),
                                 w[0], record=False, qpos=qpos[0, :n].contiguous())
    diff.check("gangsweep", "sweep_run", "segment 0 selections", sel_k[0, :n], sel)
    for f in STATE_FIELDS:
        diff.check("gangsweep", "sweep_run", f"segment 0 state {f}", getattr(s_k, f)[0],
                   getattr(st, f))
    lengths = (segs >= 0).sum(dim=1).tolist()
    if min(lengths[:V]) < 1 or bool((sel_k[V] >= 0).any()):
        raise AssertionError(f"segmented sweep_run: segments of {lengths}")
    evicted = ((s_k.assignment < 0) & (st0.assignment >= 0)).sum(dim=1).tolist()
    bound = (sel_k >= 0).sum(dim=1).tolist()
    log(f"  default  TPU32 sweep_run over per-variant segments (phase 3's gang sweep's first "
        f"phase, {lengths} pods, the last all padding; queue positions): selections and states "
        f"equal the plain version's ({plain_s:.3f} s on the card) and variant 0's own seq_run "
        f"segment; pods bound {bound}, evictions {evicted}")


def gang_sweep3_encoding(kp, device=None):
    return phase3_sweep_encoding(kp, kp.TPU32, device)


def compare_gang_sweep3(kp, cuda, diff):
    """Phase 3: one whole GangSweep.run of three variants (the
    configuration's own weights, then two random) on
    dressed_default_cluster(256, 300) under supported_config(), TPU32,
    through the kernels. The plain sweep runs in the second process; phase
    4h compares (`check_plain_gang_sweep`)."""
    enc = gang_sweep3_encoding(kp)
    w = sweep_weights(kp, enc, PHASE3_VARIANTS, seed=3)
    sweep = kp.GangSweep(enc)
    cap = PhaseCapture(cuda)
    cuda.reset_counts()
    t0 = time.perf_counter()
    with cap:
        asg, rounds = sweep.run(w)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    stats = dict(sweep.last_stats)
    check_gang_sweep_launches(sweep, stats, counts, plain, "phase 3 gang sweep")
    if cap.first is None:
        raise AssertionError(f"phase 3 gang sweep ran no preempt phase: {stats}")
    log(f"  default  TPU32 GangSweep.run: {PHASE3_VARIANTS} variants on "
        f"dressed_default_cluster(256, {DEFAULT_PHASE3_PENDING}) in {secs:.3f} s: rounds "
        f"{rounds.tolist()}, {stats['phases']} phases binding {stats['phase_bound']}; "
        f"launches { {k: counts[k] for k in GANG_KERNELS + ('sweep_run',)} }")
    compare_segments(cuda, diff, cap.first[0])
    return dict(digest=encoding_digest(enc), w=w, asg=asg, rounds=rounds, stats=stats,
                states=sweep._states)


def check_plain_gang_sweep(cuda, diff, run, plain):
    """Phase 4h for phase 3's gang sweep: assignments, rounds, every state
    field and the sweep's counts against the plain sweep's."""
    if plain["digest"] != run["digest"] or not np.array_equal(plain["w"], run["w"]):
        raise AssertionError("phase 3 gang sweep: the second process ran other inputs")
    dev = run["asg"].device
    diff.check("gangsweep", "gang_bind", "phase 3 sweep assignments", run["asg"],
               plain["asg"].to(dev))
    diff.check("gangsweep", "gang_match", "phase 3 sweep rounds", run["rounds"],
               plain["rounds"].to(dev))
    for f in STATE_FIELDS:
        diff.check("gangsweep", "sweep_run", f"phase 3 sweep state {f}",
                   getattr(run["states"], f), plain["states"][f].to(dev))
    drop = ("host_syncs",)  # the plain versions' sweep_run reads back no status
    if {k: v for k, v in run["stats"].items() if k not in drop} != {
            k: v for k, v in plain["stats"].items() if k not in drop}:
        raise AssertionError(f"phase 3 gang sweep: {run['stats']} against plain {plain['stats']}")
    log(f"    phase 3 gang sweep: {PHASE3_VARIANTS} variants' assignments, rounds, states and "
        f"phases equal the plain sweep's (host CPU, {plain['seconds']:.3f} s)")


def check_gang_sweep_launches(sweep, stats, counts, plain, what):
    """Each round one launch of each K9 kernel for every variant of a group
    (gang_topk below full width only), each phase one sweep_run launch, no
    plain call."""
    n_rounds = stats["host_syncs"] - stats["phases"]
    topk = n_rounds if sweep.gang.match_width < sweep.enc.N else 0
    want = {**dict.fromkeys(counts, 0), "gang_eval": n_rounds, "gang_match": n_rounds,
            "gang_bind": n_rounds, "gang_topk": topk, "sweep_run": stats["phases"]}
    if counts != want or any(plain.values()):
        raise AssertionError(f"{what}: launches {counts} (want {want}), plain calls {plain}")


class PhaseCapture(Swap):
    """The first per-variant (preempt phase) sweep_run call: its inputs
    (the stacked states copied) and its device ms from CUDA events."""

    def __init__(self, cuda):
        self.first = None

        def make(f):
            def call(prog, a, states, queue, weights, **kw):
                if self.first is not None or queue.dim() != 2:
                    return f(prog, a, states, queue, weights, **kw)
                inputs = (prog, a, states.clone(), queue, weights, kw.get("qpos"))
                e0, e1 = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                e0.record()
                out = f(prog, a, states, queue, weights, **kw)
                e1.record()
                self.first = (inputs, e0, e1)
                return out
            return call

        super().__init__(cuda, {"sweep_run": make})

    def ms(self):
        torch.cuda.synchronize()
        return self.first[1].elapsed_time(self.first[2])


def timed_gang_sweep(cuda, sweep, w, what, capture=None):
    """`sweep.run(w)` with the counters set to 0 just before and read just
    after, each round one launch of each K9 kernel and each phase one
    sweep_run (`check_gang_sweep_launches`). Returns a dict: assignments,
    rounds, wall s, peak bytes, launches, the sweep's counts."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cuda.reset_counts()
    t0 = time.perf_counter()
    if capture is not None:
        with capture:
            asg, rounds = sweep.run(w)
    else:
        asg, rounds = sweep.run(w)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    stats = dict(sweep.last_stats)
    check_gang_sweep_launches(sweep, stats, counts, plain, what)
    if any(x != 1 for x in stats["groups"]):
        raise AssertionError(f"{what}: the variants ran in groups {stats['groups']}")
    return dict(asg=asg, rounds=rounds, wall=wall, peak=torch.cuda.max_memory_allocated() - base,
                counts=counts, stats=stats)


def own_loop(stats, v):
    """(phases, passes) variant v's own GangScheduler loop would have run:
    it stops before a phase with nothing pending and after a phase that
    binds nothing."""
    phases, passes = 0, 1
    for pend, got in zip(stats["phase_pending"], stats["phase_bound"]):
        if pend[v] == 0:
            break
        phases += 1
        if got[v] == 0:
            break
        passes += 1
    return phases, passes


def drive_gang_sweep(kp, cuda, diff, sweep4g, gang4e, smi):
    """Phase 4i: the gang weight sweep at full width, TPU32. (a) config #4's
    cluster (phase 4g's encoding) with GANGSWEEP_VARIANTS variants through
    GangSweep.run: one launch of each K9 kernel a round for every variant,
    one sweep_run a phase, no plain call; variant 0 and two sampled
    variants against single-variant GangScheduler(enc, compact=False) runs
    on the card. (b) the 4c cluster, GangSweep(enc, chunk=64), four
    variants: rounds, phases, the pods each phase took; variant 0 against
    phase 4e's GangScheduler where its own loop stops where the sweep did,
    else against a one-variant sweep held to the sweep's phases; evictions
    in every variant."""
    enc = sweep4g["enc"]
    w = sweep_weights(kp, enc, GANGSWEEP_VARIANTS, seed=SWEEP_SEED)
    sweep = kp.GangSweep(enc)
    run = timed_gang_sweep(cuda, sweep, w, "4i(a)")
    V, Q = w.shape[0], len(enc.queue)
    r = run["rounds"].cpu().numpy()
    st = run["stats"]
    placed = (run["asg"][:, torch.as_tensor(np.asarray(enc.queue), device=enc.device)] >= 0).sum(
        dim=1).cpu().numpy()
    log(f"    GangSweep.run: {V} variants x {Q} pods on {enc.N} nodes in {run['wall']:.3f} s wall, "
        f"{V * Q / run['wall']:.1f} decisions/s; rounds per variant min/median/max "
        f"{r.min()}/{int(np.median(r))}/{r.max()} (round launches {st['host_syncs'] - st['phases']}, "
        f"each over all {V} variants); {st['phases']} phases (segments of "
        f"{max(st['phase_pending'][0]) if st['phases'] else 0} pods at most, binding "
        f"{sum(map(sum, st['phase_bound']))}); placed {placed.min()}..{placed.max()} of {Q}; peak "
        f"memory {run['peak'] / 2**30:.3f} GiB above what was held; variant groups "
        f"{st['groups']}; launches { {k: run['counts'][k] for k in GANG_KERNELS + ('sweep_run',)} }, "
        f"plain calls none [{smi}]")
    picked = sampled_variants(V)
    for v in [0] + picked:
        g = kp.GangScheduler(enc, compact=False)
        state_v, rounds_v = g.run(torch.as_tensor(w[v]))
        diff.check("gangsweep", "gang_bind", f"4i(a) variant {v} assignment", run["asg"][v],
                   state_v.assignment)
        for f in STATE_FIELDS:
            diff.check("gangsweep", "gang_bind", f"4i(a) variant {v} state {f}",
                       getattr(sweep._states, f)[v], getattr(state_v, f))
        if rounds_v != int(r[v]):
            raise AssertionError(f"4i(a) variant {v}: {int(r[v])} rounds, alone {rounds_v}")
    log(f"    variants {[0] + picked} equal single-variant GangScheduler(compact=False) runs on "
        f"the card: state and rounds")
    out = dict(a=dict(enc=enc, w=w, sweep=sweep, **run))

    # (b) the preempting gang sweep on the 4c cluster
    enc_d = gang4e["enc"]
    w_d = sweep_weights(kp, enc_d, GANGSWEEP_PREEMPT_VARIANTS, seed=7)
    sweep_d = kp.GangSweep(enc_d, chunk=64)
    cap = PhaseCapture(cuda)
    run_d = timed_gang_sweep(cuda, sweep_d, w_d, "4i(b)", capture=cap)
    st_d = run_d["stats"]
    Qd = len(enc_d.queue)
    if st_d["phases"] < 1 or cap.first is None:
        raise AssertionError(f"4i(b): no preempt phase ran: {st_d}")
    pre = enc_d.state0.assignment >= 0
    evicted = ((run_d["asg"] < 0) & pre[None, :]).sum(dim=1).tolist()
    if min(evicted) < 1:
        raise AssertionError(f"4i(b): a variant evicted nothing: {evicted}")
    phase_ms = cap.ms()
    log(f"    preempting GangSweep.run: {GANGSWEEP_PREEMPT_VARIANTS} variants x {Qd} pods on the "
        f"4c cluster (chunk 64) in {run_d['wall']:.3f} s wall, "
        f"{GANGSWEEP_PREEMPT_VARIANTS * Qd / run_d['wall']:.1f} decisions/s; rounds "
        f"{run_d['rounds'].tolist()}; {st_d['phases']} phases over {st_d['passes']} passes: "
        f"segments {st_d['phase_pending']}, pods bound {st_d['phase_bound']}; the first "
        f"phase's sweep_run {phase_ms:.1f} ms on the card; pre-bound pods evicted {evicted}; "
        f"peak memory {run_d['peak'] / 2**30:.3f} GiB; launches "
        f"{ {k: run_d['counts'][k] for k in GANG_KERNELS + ('sweep_run',)} }, plain calls none "
        f"[{smi}]")
    own = own_loop(st_d, 0)
    g4 = gang4e["g"]
    if own == (st_d["phases"], st_d["passes"]):
        for f in STATE_FIELDS:
            diff.check("gangsweep", "sweep_run", f"4i(b) variant 0 against 4e {f}",
                       getattr(sweep_d._states, f)[0], getattr(g4._final_state, f))
        if int(run_d["rounds"][0]) != gang4e["rounds"]:
            raise AssertionError(f"4i(b) variant 0: {int(run_d['rounds'][0])} rounds, phase 4e "
                                 f"{gang4e['rounds']}")
        log(f"    variant 0's own loop stops where the sweep did ({own[0]} phases): its state and "
            f"rounds equal phase 4e's GangScheduler")
    else:
        held = kp.GangSweep(enc_d, chunk=64)
        held._hold = (st_d["phases"], st_d["passes"])
        asg_h, rounds_h = held.run(w_d[:1])
        for f in STATE_FIELDS:
            diff.check("gangsweep", "sweep_run", f"4i(b) variant 0 held {f}",
                       getattr(sweep_d._states, f)[0], getattr(held._states, f)[0])
        if int(rounds_h[0]) != int(run_d["rounds"][0]):
            raise AssertionError("4i(b) variant 0 differs from its held one-variant sweep")
        log(f"    variant 0's own loop would stop after {own[0]} phases and {own[1]} passes, the "
            f"sweep ran {st_d['phases']} and {st_d['passes']}: its state and rounds equal a "
            f"one-variant sweep held to those (phase 4e's GangScheduler: {gang4e['rounds']} "
            f"rounds)")
    out["b"] = dict(enc=enc_d, w=w_d, sweep=sweep_d, capture=cap.first[0], phase_ms=phase_ms,
                    **run_d)
    return out


def stacked_bind_lib(enc, rows, sel, order):
    """bind_all of every variant as PyTorch calls on the stacked planes: the
    committed rows gathered beforehand, index_add_ at variant v's node n as
    row v N + n of each plane viewed [V N, ...]; the claim counts summed
    per variant; assignment and bound_seq set. Returns the call."""
    a = enc.arrays
    V, N, P = rows.shape[0], enc.N, enc.P
    keep = sel >= 0
    var = torch.arange(V, device=enc.device)[:, None].expand_as(rows)[keep]
    pods, tgt = rows[keep].long(), sel[keep].long()
    flat = var * N + tgt
    srcs = {f: getattr(a, src)[pods] for f, src in (
        ("requested", "pod_req"), ("s_requested", "pod_sreq"), ("used_pair", "want_pair"),
        ("used_wild", "want_wild"), ("used_trip", "want_trip"),
        ("node_disk_any", "pod_disk_any"), ("node_disk_rw", "pod_disk_rw"),
        ("node_vol3", "pod_vol3"))}
    ones = torch.ones_like(flat, dtype=torch.int32)
    claims = a.pod_claim[pods].to(torch.int32)
    at = var * P + pods
    seqs = order[pods] + P
    tgt32 = tgt.to(torch.int32)

    def call(st):
        for f, src in srcs.items():
            x = getattr(st, f)
            x.view(V * N, *x.shape[2:]).index_add_(0, flat, src)
        st.n_pods.view(V * N).index_add_(0, flat, ones)
        st.used_claims.index_add_(0, var, claims)
        st.assignment.view(V * P).index_put_((at,), tgt32)
        st.bound_seq.view(V * P).index_put_((at,), seqs)

    return call


def gangsweep_rows(kp, cuda, diff, run, smi):
    """Phase 5f: the four K9 kernels at round 1 of phase 4i(a) (V variants,
    every queue pod pending) and sweep_run over the per-variant segments of
    phase 4i(b)'s first phase. Each is held against its plain version
    first: top-k and bind at the whole round, match on its first
    MATCH_PLAIN_VARIANTS variants; gang_eval on the first 8 rows of
    variants 0 and 1 (its plain version takes tens of ms a pod); the phase
    on the first PHASE_PLAIN_STEPS steps of each variant's segment from the
    phase's own start state (its plain version runs every dry run in small
    launches). ms: CUDA events; the phase's from phase 4i(b)'s own
    launch. Bounds: bytes over 3.35 TB/s or operations over 67 TFLOP/s,
    the larger. Library calls: torch.topk on [V Q, N]; index_add_ for
    bind."""
    ra = run["a"]
    enc, w, sweep = ra["enc"], ra["w"], ra["sweep"]
    g = sweep.gang
    prog, a, N = g._base.program, enc.arrays, enc.N
    C, V, mw = a.pod_claim.shape[1], w.shape[0], g.match_width
    isz = a.node_alloc.element_size()
    W = torch.as_tensor(w, device=enc.device).to(enc.policy.score)
    states0 = cuda.stack_states([enc.state0] * V)
    rows, count = g._pending(states0, sort=True)
    rows = rows.contiguous()
    K = rows.shape[1]
    scores = cuda.gang_eval(prog, a, states0, W, rows, count, g._order)
    eight = torch.tensor([8], dtype=torch.int32, device=enc.device)
    for v in (0, 1):
        one = cuda.stack_states([enc.state0])
        want = cuda.gang_eval_plain(prog, a, one, W[v:v + 1], rows[v:v + 1, :8], eight, g._order)
        diff.check("gangsweep", "gang_eval", f"round 1 variant {v}, 8 rows", scores[v, :8],
                   want[0])
    eval_ms = events_ms(lambda: cuda.gang_eval(prog, a, states0, W, rows, count, g._order), 1, 1)
    eval_plain_ms = events_ms(lambda: cuda.gang_eval_plain(
        prog, a, cuda.stack_states([enc.state0]), W[:1], rows[:1, :8], eight, g._order), 1, 1)
    st_mid = enc.state0
    sample = np.random.default_rng(5).choice(np.asarray(enc.queue), 64, replace=False)
    per_row = statistics.mean(attempt_cost(enc, prog, st_mid, int(p), g.weights)[1]
                              for p in sample.tolist())
    state_bytes = nbytes(*(getattr(enc.state0, f) for f in STATE_FIELDS))
    b_eval = bound(cluster_bytes(enc) + V * state_bytes + V * K * N * isz, per_row * V * K)
    vals, idx = cuda.gang_topk(scores, count, mw)
    pv, pi = cuda.gang_topk_plain(scores, count, mw)
    diff.check("gangsweep", "gang_topk", "round 1 vals", vals, pv)
    diff.check("gangsweep", "gang_topk", "round 1 idx", idx, pi)
    del pv, pi
    topk_ms = events_ms(lambda: cuda.gang_topk(scores, count, mw), 1, 3)
    topk_plain_ms = events_ms(lambda: cuda.gang_topk_plain(scores, count, mw), 1, 1)
    flat = scores.view(V * K, N)
    topk_lib_ms = events_ms(lambda: torch.topk(flat, mw, dim=1), 1, 3)
    b_topk = bound(V * K * N * isz + V * K * mw * (isz + 4), V * K * N)
    args = (rows, count, g._order, g._claims, g._carrier, N, C, g.inner_iters)
    sel, stat = cuda.gang_match(vals, idx, *args)
    sub = slice(0, MATCH_PLAIN_VARIANTS)  # the plain matching walks its variants one by one
    sub_args = (rows[sub], count[sub]) + args[2:]
    psel, pstat = cuda.gang_match_plain(vals[sub], idx[sub], *sub_args)
    diff.check("gangsweep", "gang_match", "round 1 sel", sel[sub], psel)
    diff.check("gangsweep", "gang_match", "round 1 stat", stat[sub], pstat)
    match_ms = events_ms(lambda: cuda.gang_match(vals, idx, *args), 1, 3)
    match_plain_ms = events_ms(lambda: cuda.gang_match_plain(vals[sub], idx[sub], *sub_args),
                               1, 1)
    b_match = bound(V * (K * mw * (isz + 4) + K * 4 * 3) + 4 * K, V * K * mw)
    del scores, flat
    s1 = cuda.gang_bind(prog, a, states0.clone(), rows, count, sel, g._order)
    s2 = cuda.gang_bind_plain(prog, a, states0.clone(), rows, count, sel, g._order)
    for f in STATE_FIELDS:
        diff.check("gangsweep", "gang_bind", f"round 1 {f}", getattr(s1, f), getattr(s2, f))
    lib = stacked_bind_lib(enc, rows, sel, g._order)
    s3 = states0.clone()
    lib(s3)
    if not all(torch.equal(getattr(s3, f), getattr(s1, f)) for f in STATE_FIELDS):
        raise AssertionError("the index_add_ form of the stacked gang_bind disagrees")
    committed = int(stat[:, 0].sum())
    st_b, st_p, st_l = states0.clone(), states0.clone(), states0.clone()
    bind_ms = events_ms(lambda: cuda.gang_bind(prog, a, st_b, rows, count, sel, g._order), 5)
    bind_plain_ms = events_ms(lambda: cuda.gang_bind_plain(prog, a, st_p, rows, count, sel,
                                                           g._order), 1, 3)
    bind_lib_ms = events_ms(lambda: lib(st_l), 5)
    pod_row = nbytes(a.pod_req[0], a.pod_sreq[0], a.want_pair[0], a.want_wild[0],
                     a.want_trip[0], a.pod_claim[0], a.pod_disk_any[0], a.pod_disk_rw[0],
                     a.pod_vol3[0])
    node_row = nbytes(enc.state0.requested[0], enc.state0.s_requested[0],
                      enc.state0.used_pair[0], enc.state0.used_wild[0], enc.state0.used_trip[0],
                      enc.state0.node_disk_any[0], enc.state0.node_disk_rw[0],
                      enc.state0.node_vol3[0], enc.state0.n_pods[0])
    b_bind = bound(4 * 3 * V * K + committed * (pod_row + 2 * node_row + 8),
                   committed * (pod_row // 4 + 2))
    log(f"    K9 at round 1 of phase 4i(a): {V} variants x {K} pending rows, {committed} "
        f"commits in all; one launch of each kernel [{smi}]")

    # the first preempt phase of 4i(b), from its own start state
    rb = run["b"]
    (prog_b, a_b, st_in, segs, w_b, qpos), phase_ms = rb["capture"], rb["phase_ms"]
    enc_b = rb["enc"]
    cut = min(PHASE_PLAIN_STEPS, segs.shape[1])
    s_k, sel_k = cuda.sweep_run(prog_b, a_b, st_in, segs[:, :cut].contiguous(), w_b,
                                record=False, qpos=qpos[:, :cut].contiguous())
    t0 = time.perf_counter()
    s_p, sel_p = cuda.sweep_run_plain(prog_b, a_b, st_in, segs[:, :cut].contiguous(), w_b,
                                      record=False, qpos=qpos[:, :cut].contiguous())
    torch.cuda.synchronize()
    phase_plain_ms = (time.perf_counter() - t0) * 1e3
    diff.check("gangsweep", "sweep_run", f"first phase, {cut} steps, selections", sel_k, sel_p)
    for f in STATE_FIELDS:
        diff.check("gangsweep", "sweep_run", f"first phase, {cut} steps, state {f}",
                   getattr(s_k, f), getattr(s_p, f))
    Vb = segs.shape[0]
    steps = int((segs >= 0).sum())
    st_b0 = cuda.variant_state(st_in, 0)
    step_ops = ops_per_node(enc_b, prog_b) * enc_b.N + rel_reads(
        enc_b, prog_b, st_b0, int(segs[0, 0]))[1]
    state_b = nbytes(*(getattr(enc_b.state0, f) for f in STATE_FIELDS))
    b_phase = bound(cluster_bytes(enc_b) + 2 * Vb * state_b + 2 * segs.numel() * 4
                    + w_b.numel() * w_b.element_size() + 4 * 2 * segs.numel(), step_ops * steps)
    log(f"    sweep_run at 4i(b)'s first phase: {Vb} variants' segments of "
        f"{(segs >= 0).sum(dim=1).tolist()} pods ({steps} steps) in {phase_ms:.3f} ms; the "
        f"first {cut} steps of each equal the plain version ({phase_plain_ms:.1f} ms on the "
        f"card for those) [{smi}]")
    rows_out = []
    launches = ra["counts"]
    for name, ms, plain_ms, b, lib_ms, shape, basis, n_launch, path in (
            ("gang_eval", eval_ms, eval_plain_ms, b_eval, None, f"{V} x {K} rows",
             "8 rows of one variant", launches["gang_eval"], "gangsweep config4"),
            ("gang_topk", topk_ms, topk_plain_ms, b_topk, topk_lib_ms, f"{V} x {K} x {N} -> {mw}",
             None, launches["gang_topk"], "gangsweep config4"),
            ("gang_match", match_ms, match_plain_ms, b_match, None, f"{V} x {K} x {mw}",
             f"{MATCH_PLAIN_VARIANTS} of the {V} variants", launches["gang_match"],
             "gangsweep config4"),
            ("gang_bind", bind_ms, bind_plain_ms, b_bind, bind_lib_ms, f"{committed} commits",
             None, launches["gang_bind"], "gangsweep config4"),
            ("sweep_run", phase_ms, phase_plain_ms, b_phase, None, f"{Vb} x {segs.shape[1]} steps",
             f"the first {cut} steps of each segment", rb["counts"]["sweep_run"],
             "gangsweep phase")):
        row = {"name": name, "path": path, "route": "cuda",
               "source": SOURCE if name == "sweep_run" else GANG_SOURCE,
               "replaces": REPLACES["gangsweep.vphase" if name == "sweep_run"
                                    else "gangsweep.vrun"],
               "launches": n_launch, "max_abs_err": diff.err[("gangsweep", name)], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1], "library_ms": lib_ms,
               "shape": shape}
        if basis:
            row["plain_basis"] = basis
        rows_out.append(row)
        log(f"    {path:17s} {name:10s} {ms:.6f} ms at {shape} (plain {plain_ms:.3f} ms"
            + (f" for {basis}" if basis else "") + f", bound {b[0]:.7f} ms by {b[1]}, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.6f} ms'}), {n_launch} launches on the "
            f"main path [{smi}]")
    return rows_out


# ---------------------------------------------------------------------------
# the batch plane (phases 4j and 5g): sessions' passes served by one launch
# ---------------------------------------------------------------------------


def tenant_copy(snap, i):
    """Tenant i's copy of a snapshot: every pending pod's CPU request scaled
    by 1 + i / 8, as the reference's batch-plane fixtures vary their tenants
    (equal shapes, so one compile signature; each tenant's own values)."""
    from kube_scheduler_simulator_tpu_torch.utils.quantity import parse_quantity

    out = json.loads(json.dumps(snap))
    f = 1 + i / 8
    for pd in out.get("pods", []):
        if pd["spec"].get("nodeName"):
            continue
        for c in pd["spec"].get("containers", []):
            req = (c.get("resources") or {}).get("requests") or {}
            if "cpu" in req:
                req["cpu"] = f"{max(1, round(parse_quantity(req['cpu']).milli * f))}m"
    return out


def preempt_base(kp):
    """Phase 4c's cluster (preemption_cluster at 1,024 nodes, seed 7) as a
    snapshot with BATCH_PREEMPT_PENDING pending pods, and as many more
    pending pods: the gang window's arrivals."""
    nodes, pods, objects = kp.preemption_cluster(BATCH_PREEMPT_NODES, 2 * BATCH_PREEMPT_PENDING,
                                                 seed=7)
    bound = [pd for pd in pods if pd["spec"].get("nodeName")]
    pending = [pd for pd in pods if not pd["spec"].get("nodeName")]
    snap = {"nodes": nodes, "pods": bound + pending[:BATCH_PREEMPT_PENDING],
            "pvcs": objects["pvcs"], "pvs": objects["pvs"],
            "storageClasses": objects["storageclasses"]}
    return snap, pending[BATCH_PREEMPT_PENDING:]


def snapshot_digest(snap):
    return hashlib.sha256(json.dumps(snap, sort_keys=True).encode()).hexdigest()


def records_doc(results):
    """A pass's records as one byte string: status, node, all 13 annotations."""
    return json.dumps([{"ns": r.pod_namespace, "name": r.pod_name, "status": r.status,
                        "node": r.selected_node, "ann": r.to_annotations()}
                       for r in results], sort_keys=True)


def pods_doc(sess):
    return json.dumps(sess.service.store.list("pods"), sort_keys=True)


def tenant_sequence(snap, arrivals):
    """One tenant's session on the host CPU (the plain versions): import,
    `schedule()` (the sequential window's pass), the arrivals,
    `schedule_gang(record=False)` (the gang window's pass). Returns what
    each pass gave: the records, the engine's final state and trace, the
    rounds and placements, the store's pods after each, the encodings'
    digests and the seconds (the passes', and the sequential engine's
    build and plain pass alone)."""
    from kube_scheduler_simulator_tpu_torch.server.sessions import SessionManager

    sess, _ = SessionManager(device="cpu").create(snapshot=snap)
    sched = sess.service.scheduler
    ph0 = sched.metrics.phases()
    t0 = time.perf_counter()
    results = sched.schedule()
    seq_s = time.perf_counter() - t0
    ph1 = sched.metrics.phases()
    run_s = sum(ph1[k] - ph0[k] for k in ("compileSeconds", "executeSeconds"))
    eng = next(reversed(sched._engines.values()))
    out = dict(snap_digest=snapshot_digest(snap), seq_digest=encoding_digest(eng.enc),
               seq_records=records_doc(results), seq_state=_state_dict(eng._final_state),
               seq_trace=[x.cpu() for x in eng._trace], seq_store=pods_doc(sess),
               seq_seconds=seq_s, seq_run_seconds=run_s)
    for pd in arrivals:
        sess.service.store.apply("pods", pd)
    t0 = time.perf_counter()
    placements, rounds, _ = sched.schedule_gang(record=False)
    gang_s = time.perf_counter() - t0
    g = next(reversed(sched._engines.values()))
    out.update(gang_digest=encoding_digest(g.enc), gang_state=_state_dict(g._final_state),
               rounds=rounds, placements=placements, gang_store=pods_doc(sess),
               gang_seconds=gang_s, gang_phases=g.last_stats["phases"])
    return out


TENANT_FORMS = ("batch_run", "batch_seg", "batch_eval", "batch_match", "batch_bind", "gang_topk")


class TimedLibrary:
    """The kernel library with each launch of the tenant forms (and of
    gang_topk) between two CUDA events recorded around the library call
    alone: the launch on the caller's stream, none of its wrapper's host
    work (checks, scratch, the tenants' Planes table, readbacks). Other
    entry points pass through."""

    def __init__(self, lib, events):
        self._lib, self._events = lib, events

    def __getattr__(self, attr):
        f = getattr(self._lib, attr)
        form, _, t = attr.rpartition("_")
        if t not in ("i32", "i64"):
            form = attr
        if form not in self._events:
            return f

        def call(*args):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            rc = f(*args)
            e1.record()
            self._events[form].append((e0, e1))
            return rc
        return call


class TenantLaunches(Swap):
    """While active, every launch of the tenant forms (and of gang_topk), or
    of the wrappers `forms` names, is timed at its library call
    (`TimedLibrary`), and the first call of each wrapper keeps its inputs (a
    stacked state argument cloned, and a tensor that is a view, such as a
    counted pass's live row of its accounting, or every tensor of
    gang_advance: the launches after it update them in place). The calls go
    through unchanged."""

    def __init__(self, cuda, forms=TENANT_FORMS):
        from kube_scheduler_simulator_tpu_torch.engine.encode import SchedState

        self.events = {n: [] for n in forms}
        self.first = {}

        def keep(wrapper):
            def make(f):
                def call(*args, **kw):
                    # the counted matchings are their wrappers' `counted` calls
                    name = wrapper
                    if wrapper.endswith("_match") and kw.get("counted"):
                        name += "_counted"
                    if name in forms and name not in self.first:
                        self.first[name] = ([x.clone() if isinstance(x, SchedState) or (
                            isinstance(x, torch.Tensor)
                            and (x._base is not None or name == "gang_advance")) else x
                            for x in args], dict(kw))
                    return f(*args, **kw)
                return call
            return make

        table = {n: keep(n) for n in {f.removesuffix("_counted") for f in forms}}
        table["library"] = lambda f: (lambda: TimedLibrary(f(), self.events))
        super().__init__(cuda, table)

    def ms(self, name):
        torch.cuda.synchronize()
        return [e0.elapsed_time(e1) for e0, e1 in self.events[name]]


RELAUNCHES = 3  # the warm launches a phase-5g time is the median of


def relaunch_ms(cuda, name, fn, reps=RELAUNCHES, forms=TENANT_FORMS):
    """fn() (a warm launch of tenant form `name`, or of another wrapper of
    `forms`, from captured inputs) `reps` times, each timed at its library
    call: (the median ms, fn's last output)."""
    rec = TenantLaunches(cuda, forms)
    with rec:
        for _ in range(reps):
            out = fn()
    ms = rec.ms(name)
    if len(ms) != reps:
        raise AssertionError(f"{name}: {len(ms)} launches timed, want {reps}")
    return statistics.median(ms), out


def batch_counters(sess):
    ph = sess.service.scheduler.metrics.phases()
    return {k: ph[k] for k in ("batchedPasses", "batchWindows", "batchOccupancySum",
                                "soloFallbacks", "batchedGangPasses")}


def run_window(cuda, mgr, sessions, fn, what):
    """fn(session) for every tenant at once, barrier-aligned: the window (as
    long as the plane's) fills with all of them and flushes full, as the
    reference's batch-plane tests align theirs. The counters are set to 0
    just before and read just after. Returns (outputs, wall, launches, plain
    calls, tenant launches, peak memory above what was held)."""
    import threading

    out, errors = {}, {}
    barrier = threading.Barrier(len(sessions) + 1)

    def run(i):
        try:
            barrier.wait(timeout=120)
            with mgr.pass_slot():
                out[i] = fn(sessions[i])
        except Exception as e:  # noqa: BLE001 — raised below
            errors[i] = repr(e)

    before = [batch_counters(x) for x in sessions + [mgr.get("default")]]
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(sessions))]
    for t in threads:
        t.start()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_counts()
    with TenantLaunches(cuda) as rec:
        barrier.wait(timeout=120)
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() - held
    if errors or len(out) != len(sessions):
        raise AssertionError(f"{what}: passes failed: {errors}")
    after = [batch_counters(x) for x in sessions + [mgr.get("default")]]
    moved = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
    return out, wall, counts, plain, rec, peak, moved


def check_window(moved, counts, plain, want, what, gang=False):
    """The window was ONE batched launch of the tenant forms that served
    every tenant: in the window (`moved`: each tenant's counters, then the
    plane's) each tenant's pass counted batched (a gang pass as a batched
    gang pass) and no solo fallback (a batched launch that failed and fell
    back to solo fails the phase); one window of B on the plane's registry;
    the kernels in `want` launched and no plain version called."""
    *tenants, plane = moved
    B = len(tenants)
    for i, c in enumerate(tenants):
        if (c["batchedPasses"], c["soloFallbacks"], c["batchedGangPasses"]) != (1, 0, int(gang)):
            raise AssertionError(f"{what}: tenant {i} was not served by the batched launch: {c}")
    if (plane["batchWindows"], plane["batchOccupancySum"]) != (1, B):
        raise AssertionError(f"{what}: windows {plane}")
    bad = {k: counts[k] for k, n in want.items() if (counts[k] < 1 if n is None else counts[k] != n)}
    if bad or any(plain.values()):
        raise AssertionError(f"{what}: launches {counts}, plain calls {plain}")


def armed_manager(B):
    """A SessionManager on the card with its batch plane armed the way a
    user arms it (KSS_BATCH, a long window, KSS_BATCH_MAX_SESSIONS = B: the
    window flushes full)."""
    from kube_scheduler_simulator_tpu_torch.server.sessions import SessionManager

    env = {"KSS_BATCH": "1", "KSS_BATCH_WINDOW_MS": "600000", "KSS_BATCH_MAX_SESSIONS": str(B)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        mgr = SessionManager(max_sessions=2 * B + 2, max_concurrent_passes=B)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    if mgr.batch_plane is None or mgr.batch_plane.max_sessions != B:
        raise AssertionError("KSS_BATCH did not arm the plane")
    return mgr


def seq_window(kp, cuda, diff, label, mgr, sessions, smi, preempting):
    """One sequential window (`batch.seq.run`) and its checks: one batched
    launch; every tenant's compile signature equal; each tenant's slice
    (final state, trace, victims) byte-equal to a solo dispatch of its own
    encoding on the card (the engine a solo pass runs), timed one tenant
    after another; the last tenant's records against its solo engine's
    (tenant 0's records and pods against its session on the host CPU's
    plain versions, 4h). `preempting`: every tenant ran a dry run."""
    B = len(sessions)
    outs, wall, counts, plain, rec, peak, moved = run_window(
        cuda, mgr, sessions, lambda s: s.service.scheduler.schedule(), label)
    check_window(moved, counts, plain, {"batch_run": 1, "seq_run": 0}, label)
    engines = [s.service.scheduler._batch_decode_cache[1] for s in sessions]
    sigs = {kp.BatchedScheduler.compile_signature(e.enc) for e in engines}
    if len(sigs) != 1:
        raise AssertionError(f"{label}: {len(sigs)} compile signatures among {B} tenants")
    launch_ms = rec.ms("batch_run")[0]
    solo_ms, solo_wall, dids = [], 0.0, []
    pre = engines[0].preempts
    for i, e in enumerate(engines):
        s = kp.BatchedScheduler(e.enc)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        s.run()
        e1.record()
        torch.cuda.synchronize()
        solo_wall += time.perf_counter() - t0
        solo_ms.append(e0.elapsed_time(e1))
        slots = cuda.TRACE_SLOTS_PREEMPT if pre else cuda.TRACE_SLOTS_PLAIN
        for slot, g, h in zip(slots, e._trace, s._trace):
            diff.check("batch", "batch_run", f"{label} tenant {i} {slot}", g, h)
        for f in STATE_FIELDS:
            diff.check("batch", "batch_run", f"{label} tenant {i} state {f}",
                       getattr(e._final_state, f), getattr(s._final_state, f))
        if pre:
            dids.append(int(e._trace[cuda.TRACE_SLOTS_PREEMPT.index("did")][:len(e.enc.queue)]
                            .sum()))
        if i == B - 1 and records_doc(s.results()) != records_doc(outs[i]):
            raise AssertionError(f"{label}: tenant {i}'s records differ from its solo engine's")
    # phase 5g's time: warm launches from the window's inputs, while the
    # tenants' planes are still the window's (a later pass updates them)
    args, kw = rec.first["batch_run"]
    relaunch, (s_r, _) = relaunch_ms(cuda, "batch_run", lambda: cuda.batch_run(*args, **kw))
    by_prog = {id(e.program): e for e in engines}
    enrolled = [by_prog[id(p)] for p in args[0]]  # the window's order: as the tenants enrolled
    for f in STATE_FIELDS:
        diff.check("batch", "batch_run", f"{label} re-launch, state {f}", getattr(s_r, f),
                   torch.stack([getattr(e._final_state, f) for e in enrolled]))
    pods = sum(len(e.enc.queue) for e in engines)
    log(f"    {label}: {B} tenants' passes in one window, {wall:.3f} s wall (encode, one "
        f"batch_run launch of {launch_ms:.3f} ms (warm, launched again from its inputs: "
        f"{relaunch:.3f} ms), decode and write-back of every tenant), "
        f"{pods / wall:.1f} decisions/s ({B} x {pods // B} pods), peak memory "
        f"{peak / 2**30:.3f} GiB above what was held; launches {dict((k, counts[k]) for k in ('batch_run', 'seq_run'))}, "
        f"plain calls none; compile signatures equal; soloFallbacks 0" + (
            f"; dry runs by tenant {dids}" if pre else "") + f" [{smi}]")
    log(f"    {label}: the same {B} passes dispatched solo one after another on the card: "
        f"seq_run {sum(solo_ms):.3f} ms in all ({' / '.join(f'{x:.3f}' for x in solo_ms)}; "
        f"{solo_wall:.3f} s wall); each tenant's final state, trace and victims equal its slice "
        f"of the window, tenant {B - 1}'s records its solo engine's [{smi}]")
    if preempting and not all(dids):
        raise AssertionError(f"{label}: a tenant ran no dry run: {dids}")
    return dict(engines=engines, launch_ms=launch_ms, relaunch_ms=relaunch, solo_ms=solo_ms,
                wall=wall,
                counts=counts, peak=peak, pods=pods, dids=dids,
                tenant0=dict(digest=encoding_digest(engines[0].enc), records=records_doc(outs[0]),
                             state=_state_dict(engines[0]._final_state),
                             trace=[x.cpu() for x in engines[0]._trace],
                             store=pods_doc(sessions[0])))


def gang_window(kp, cuda, diff, label, mgr, sessions, smi, phases):
    """One gang window (`batch.gang.run`, unrecorded `schedule_gang`) and
    its checks: one batched fixpoint (every round one launch of each tenant
    form, each preempt phase one `batch_seg`); every tenant's (state,
    rounds) and placements equal to a solo GangScheduler.run() of its own
    encoding on the card, timed one after another (tenant 0's pods also
    against its session on the host CPU's plain versions, 4h). `phases`:
    every tenant ran a preempt phase."""
    from kube_scheduler_simulator_tpu_torch.server.service import gang_chunk

    B = len(sessions)
    outs, wall, counts, plain, rec, peak, moved = run_window(
        cuda, mgr, sessions, lambda s: s.service.scheduler.schedule_gang(record=False), label)
    want = {"batch_eval": None, "batch_match": None, "batch_bind": None, "gang_eval": 0,
            "gang_match": 0, "seq_run": 0, "sweep_run": 0}
    if phases:
        want["batch_seg"] = None
    check_window(moved, counts, plain, want, label, gang=True)
    gangs = [s.service.scheduler._batch_gang_decode_cache[1] for s in sessions]
    sigs = {kp.GangScheduler.compile_signature(g.enc) for g in gangs}
    if len(sigs) != 1:
        raise AssertionError(f"{label}: {len(sigs)} gang signatures among {B} tenants")
    stats = [g.last_stats for g in gangs]
    if phases and not all(st["phases"] for st in stats):
        raise AssertionError(f"{label}: a tenant ran no preempt phase: {stats}")
    dev_ms = {n: sum(rec.ms(n)) for n in TENANT_FORMS if rec.events[n]}
    solo_ms, solo_wall = [], 0.0
    for i, g in enumerate(gangs):
        s = kp.GangScheduler(g.enc, chunk=gang_chunk())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, rounds = s.run()
        torch.cuda.synchronize()
        solo_wall += time.perf_counter() - t0
        if rounds != g._rounds or (rounds, s.placements()) != outs[i][1::-1]:
            raise AssertionError(f"{label}: tenant {i} differs from its solo engine's pass")
        for f in STATE_FIELDS:
            diff.check("batch", "batch_bind", f"{label} tenant {i} state {f}",
                       getattr(g._final_state, f), getattr(st, f))
    pods = sum(len(g.enc.queue) for g in gangs)
    log(f"    {label}: {B} tenants' gang passes in one window, {wall:.3f} s wall, "
        f"{pods / wall:.1f} decisions/s ({pods} pods), rounds {[g._rounds for g in gangs]}, "
        f"phases {[st['phases'] for st in stats]}, {stats[0]['host_syncs']} host readbacks; "
        f"the tenant forms on the card {', '.join(f'{n} {x:.3f} ms' for n, x in dev_ms.items())}; "
        f"launches {dict((k, counts[k]) for k in TENANT_FORMS)}, plain calls none; peak memory "
        f"{peak / 2**30:.3f} GiB above what was held [{smi}]")
    log(f"    {label}: the same {B} gang passes solo one after another on the card: "
        f"{solo_wall:.3f} s wall; each tenant's state, rounds and placements equal its slice "
        f"[{smi}]")
    return dict(gangs=gangs, rec=rec, counts=counts, wall=wall, dev_ms=dev_ms, pods=pods,
                tenant0=dict(digest=encoding_digest(gangs[0].enc),
                             state=_state_dict(gangs[0]._final_state), rounds=gangs[0]._rounds,
                             placements=outs[0][0], store=pods_doc(sessions[0])))


def drive_batch(kp, cuda, diff, serving_in, smi):
    """Phase 4j: the batch plane through SessionManager on the card, TPU32.
    (a) BATCH_TENANTS tenants of phase 4d's serving cluster (1,024 nodes,
    10,000 pods bound, SERVING_ARRIVALS pending; tenant i's pending CPU
    requests scaled by 1 + i / 8) in one sequential window; (b) BATCH_PREEMPT_TENANTS tenants
    of phase 4c's preemption cluster with BATCH_PREEMPT_PENDING pending pods
    each, dry runs in every tenant; (c) gang passes
    (`schedule_gang(record=False)`) after as many more arrivals: every
    serving tenant in one window, the first BATCH_PREEMPT_GANG of the
    preempting ones in another (each of whose encodes is a full one, the
    victims of (b) deleted), whose phases must run. Tenant 0 of each
    cluster also runs, with the plain versions, in the host-CPU worker
    (4h)."""
    out = {}
    for label, base, arrivals, B, B_gang, phases in (
            ("serving", *serving_in, BATCH_TENANTS, BATCH_TENANTS, False),
            ("preempt", *preempt_base(kp), BATCH_PREEMPT_TENANTS, BATCH_PREEMPT_GANG, True)):
        t0 = time.perf_counter()
        mgr = armed_manager(B)
        snaps = [tenant_copy(base, i) for i in range(B)]
        sessions = [mgr.create(name=f"{label}-{i}", snapshot=sn)[0] for i, sn in enumerate(snaps)]
        log(f"    {label}: {B} tenants of {len(base['nodes'])} nodes and {len(base['pods'])} pods "
            f"imported in {time.perf_counter() - t0:.1f} s; the plane armed from KSS_BATCH "
            f"({mgr.batch_plane.stats()})")
        seq = seq_window(kp, cuda, diff, f"{label} seq", mgr, sessions, smi, phases)
        for i, sess in enumerate(sessions[:B_gang]):
            for pd in tenant_copy({"pods": arrivals}, i)["pods"]:
                sess.service.store.apply("pods", pd)
        mgr.batch_plane.max_sessions = B_gang  # the gang window fills with B_gang tenants
        gang = gang_window(kp, cuda, diff, f"{label} gang", mgr, sessions[:B_gang], smi, phases)
        out[label] = dict(seq=seq, gang=gang, B=B, snap_digest=snapshot_digest(snaps[0]))
        mgr.shutdown()
    return out


def check_plain_batch(diff, label, run, plain):
    """Phase 4h for phase 4j: tenant 0's slices of the sequential and the
    gang window (records, final state, trace, rounds, placements, pods)
    against the same tenant's session run with the plain versions on the
    host CPU, after checking that both processes encoded the same inputs."""
    seq, gang = run["seq"]["tenant0"], run["gang"]["tenant0"]
    if (plain["snap_digest"], plain["seq_digest"], plain["gang_digest"]) != (
            run["snap_digest"], seq["digest"], gang["digest"]):
        raise AssertionError(f"batch {label}: the worker encoded other inputs")
    for i, (g, h) in enumerate(zip(seq["trace"], plain["seq_trace"])):
        diff.check("batch", "batch_run", f"{label} plain trace slot {i}", g, h)
    for f in STATE_FIELDS:
        diff.check("batch", "batch_run", f"{label} plain state {f}", seq["state"][f],
                   plain["seq_state"][f])
        diff.check("batch", "batch_bind", f"{label} gang plain state {f}", gang["state"][f],
                   plain["gang_state"][f])
    if seq["records"] != plain["seq_records"] or seq["store"] != plain["seq_store"]:
        raise AssertionError(f"batch {label}: tenant 0's records or pods differ from the plain run")
    if (gang["rounds"], gang["placements"], gang["store"]) != (
            plain["rounds"], plain["placements"], plain["gang_store"]):
        raise AssertionError(f"batch {label}: tenant 0's gang pass differs from the plain run")
    run["plain_s"] = (plain["seq_run_seconds"], plain["gang_seconds"])
    log(f"    batch {label}: tenant 0's sequential slice (records, state, trace, pods) and gang "
        f"slice (state, {gang['rounds']} rounds, placements, pods) equal its session on the "
        f"host CPU's plain versions ({plain['seq_seconds']:.3f} s and "
        f"{plain['gang_seconds']:.3f} s there)")


def batch_rows(cuda, diff, run, smi):
    """Phase 5g: the tenant forms at their launches in phase 4j, each
    launched again from the inputs captured there (warm: the median of
    RELAUNCHES launches, each timed at its library call alone,
    `relaunch_ms`) and held against its plain version. batch_run: the
    preempting window's launch (launched again in 4j, while the tenants'
    planes are the window's, and held against the window's slices; its
    plain version: tenant 0's pass on the host CPU, 4h); batch_eval,
    batch_match, batch_bind: round 1 of the serving gang window (the plain
    eval on 8 rows of tenants 0 and 1, the matching and bind on every
    tenant); batch_seg: the preempting gang window's first phase, the plain
    version on its first PHASE_PLAIN_STEPS steps of each segment. Bounds:
    bytes over 3.35 TB/s or operations over 67 TFLOP/s, the larger. No
    library call computes these."""
    rows_out = []
    # batch_run at the preempting window
    rp = run["preempt"]["seq"]
    engines = rp["engines"]
    B = len(engines)
    enc0, prog0 = engines[0].enc, engines[0].program
    st_bytes = nbytes(*(getattr(enc0.state0, f) for f in STATE_FIELDS))
    steps = sum(len(e.enc.queue) for e in engines)
    sample = np.random.default_rng(5).choice(np.asarray(enc0.queue), 16, replace=False)
    per_step = statistics.mean(attempt_cost(enc0, prog0, enc0.state0, int(p), engines[0].weights)[1]
                               for p in sample.tolist())
    b_run = bound(sum(cluster_bytes(e.enc) for e in engines) + 2 * B * st_bytes
                  + sum(nbytes(*e._trace) for e in engines), per_step * steps)
    rows_out.append(("batch_run", "batch.seq.run", rp["relaunch_ms"],
                     run["preempt"]["plain_s"][0] * 1e3, b_run, rp["counts"]["batch_run"],
                     f"{B} tenants x {len(engines[0].padded_queue())} steps",
                     "1 of the tenants: its engine's build and plain pass on the host CPU (4h)",
                     "batch preempt"))
    # the gang forms at round 1 of the serving gang window
    rg = run["serving"]["gang"]
    rec = rg["rec"]
    (progs, arrays, states, w, rows, live, orders), _ = rec.first["batch_eval"]
    eval_ms, scores = relaunch_ms(
        cuda, "batch_eval", lambda: cuda.batch_eval(progs, arrays, states, w, rows, live, orders))
    Bs, K = rows.shape
    eight = torch.full((2,), 8, dtype=torch.int32, device=rows.device)
    sub = cuda.stack_states([cuda.variant_state(states, 0), cuda.variant_state(states, 1)])
    t0 = time.perf_counter()
    want = cuda.batch_eval_plain(progs[:2], arrays[:2], sub, w[:2], rows[:2, :8].contiguous(),
                                 eight, orders[:2])
    torch.cuda.synchronize()
    eval_plain_ms = (time.perf_counter() - t0) * 1e3
    n_eval = min(8, int(live[:2].min()))
    diff.check("batch", "batch_eval", "round 1, tenants 0 and 1, 8 rows", scores[:2, :n_eval],
               want[:, :n_eval])
    # tenant 0 of the launch: the first to enroll in the window
    encg = next(gg.enc for gg in rg["gangs"] if gg.enc.arrays is arrays[0])
    isz = encg.arrays.node_alloc.element_size()
    N = encg.N
    rows_live = int(live.sum())
    per_row = statistics.mean(attempt_cost(encg, progs[0], encg.state0, int(p), w[0])[1]
                              for p in rows[0, :8].tolist() if p >= 0)
    st_g = nbytes(*(getattr(encg.state0, f) for f in STATE_FIELDS))
    b_eval = bound(sum(cluster_bytes(gg.enc) for gg in rg["gangs"]) + Bs * st_g
                   + rows_live * N * isz, per_row * rows_live)
    (vals, idx, rows_m, live_m, orders_m, claims, carriers, n_nodes, n_claims, iters), _ = \
        rec.first["batch_match"]
    match_ms, (sel, stat) = relaunch_ms(
        cuda, "batch_match", lambda: cuda.batch_match(vals, idx, rows_m, live_m, orders_m, claims,
                                                      carriers, n_nodes, n_claims, iters))
    t0 = time.perf_counter()
    psel, pstat = cuda.batch_match_plain(vals, idx, rows_m, live_m, orders_m, claims, carriers,
                                         n_nodes, n_claims, iters)
    torch.cuda.synchronize()
    match_plain_ms = (time.perf_counter() - t0) * 1e3
    diff.check("batch", "batch_match", "round 1 sel", sel, psel)
    diff.check("batch", "batch_match", "round 1 stat", stat, pstat)
    W = vals.shape[2]
    b_match = bound(rows_live * (W * (isz + 4)) + Bs * K * 4 * 3, rows_live * W)
    (progs_b, arrays_b, states_b, rows_b, live_b, sel_b, orders_b), _ = rec.first["batch_bind"]
    bind_ms, s1 = relaunch_ms(
        cuda, "batch_bind", lambda: cuda.batch_bind(progs_b, arrays_b, states_b.clone(), rows_b,
                                                    live_b, sel_b, orders_b))
    t0 = time.perf_counter()
    s2 = cuda.batch_bind_plain(progs_b, arrays_b, states_b.clone(), rows_b, live_b, sel_b,
                               orders_b)
    torch.cuda.synchronize()
    bind_plain_ms = (time.perf_counter() - t0) * 1e3
    for f in STATE_FIELDS:
        diff.check("batch", "batch_bind", f"round 1 {f}", getattr(s1, f), getattr(s2, f))
    committed = int((sel_b >= 0).sum())
    a0 = arrays_b[0]
    pod_row = nbytes(a0.pod_req[0], a0.pod_sreq[0], a0.want_pair[0], a0.want_wild[0],
                     a0.want_trip[0], a0.pod_claim[0], a0.pod_disk_any[0], a0.pod_disk_rw[0],
                     a0.pod_vol3[0])
    node_row = nbytes(*(getattr(encg.state0, f)[0] for f in (
        "requested", "s_requested", "used_pair", "used_wild", "used_trip", "node_disk_any",
        "node_disk_rw", "node_vol3", "n_pods")))
    b_bind = bound(4 * 3 * Bs * K + committed * (pod_row + 2 * node_row + 8),
                   committed * (pod_row // 4 + 2))
    counts = rg["counts"]
    rows_out += [
        ("batch_eval", "batch.gang.run", eval_ms, eval_plain_ms, b_eval, counts["batch_eval"],
         f"{Bs} tenants x {K} rows ({rows_live} live)", "8 rows of 2 tenants", "batch serving"),
        ("batch_match", "batch.gang.run", match_ms, match_plain_ms, b_match,
         counts["batch_match"], f"{Bs} tenants x {K} x {W}", None, "batch serving"),
        ("batch_bind", "batch.gang.run", bind_ms, bind_plain_ms, b_bind, counts["batch_bind"],
         f"{committed} commits", None, "batch serving"),
    ]
    # batch_seg at the preempting gang window's first phase
    rq = run["preempt"]["gang"]
    (progs_q, arrays_q, st_in, segs, w_q, qpos), _ = rq["rec"].first["batch_seg"]
    phase_ms, _ = relaunch_ms(cuda, "batch_seg",
                              lambda: cuda.batch_seg(progs_q, arrays_q, st_in, segs, w_q, qpos))
    cut = min(PHASE_PLAIN_STEPS, segs.shape[1])
    s_k, sel_k = cuda.batch_seg(progs_q, arrays_q, st_in, segs[:, :cut].contiguous(), w_q,
                                qpos[:, :cut].contiguous())
    t0 = time.perf_counter()
    s_p, sel_p = cuda.batch_seg_plain(progs_q, arrays_q, st_in, segs[:, :cut].contiguous(), w_q,
                                      qpos[:, :cut].contiguous())
    torch.cuda.synchronize()
    seg_plain_ms = (time.perf_counter() - t0) * 1e3
    diff.check("batch", "batch_seg", f"first phase, {cut} steps, selections", sel_k, sel_p)
    for f in STATE_FIELDS:
        diff.check("batch", "batch_seg", f"first phase, {cut} steps, state {f}",
                   getattr(s_k, f), getattr(s_p, f))
    encq = next(gg.enc for gg in rq["gangs"] if gg.enc.arrays is arrays_q[0])
    n_steps = int((segs >= 0).sum())
    step_ops = ops_per_node(encq, progs_q[0]) * encq.N + rel_reads(
        encq, progs_q[0], cuda.variant_state(st_in, 0), int(segs[0, 0]))[1]
    st_q = nbytes(*(getattr(encq.state0, f) for f in STATE_FIELDS))
    Bq = segs.shape[0]
    b_seg = bound(sum(cluster_bytes(gg.enc) for gg in rq["gangs"]) + 2 * Bq * st_q
                  + 4 * 3 * segs.numel() + w_q.numel() * w_q.element_size(), step_ops * n_steps)
    rows_out.append(("batch_seg", "batch.gang.run", phase_ms, seg_plain_ms, b_seg,
                     rq["counts"]["batch_seg"],
                     f"{Bq} tenants' segments of {(segs >= 0).sum(dim=1).tolist()} pods",
                     f"the first {cut} steps of each segment", "batch preempt"))
    out = []
    for name, kind, ms, plain_ms, b, n_launch, shape, basis, path in rows_out:
        row = {"name": name, "path": path, "route": "cuda",
               "source": GANG_SOURCE if name in ("batch_eval", "batch_match", "batch_bind")
               else SOURCE, "replaces": REPLACES[kind], "launches": n_launch,
               "max_abs_err": diff.err[("batch", name)], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b[0], "bound_by": b[1], "library_ms": None, "shape": shape}
        if basis:
            row["plain_basis"] = basis
        out.append(row)
        log(f"    {path:14s} {name:11s} {ms:.6f} ms at {shape} (plain {plain_ms:.3f} ms"
            + (f" for {basis}" if basis else "") + f", bound {b[0]:.7f} ms by {b[1]}, library "
            f"none), {n_launch} launches on the main path [{smi}]")
    return out


# ---------------------------------------------------------------------------
# the fault sweep: K11 `faultsweep.*` (phases 4k and 5h)
# ---------------------------------------------------------------------------

FAULT_FORMS = ("fault_evict", "batch_eval", "gang_topk", "batch_match", "batch_bind",
               "fault_tally")
FAULT_SOURCE = "kube_scheduler_simulator_tpu_torch/csrc/fault_kernels.cu"


def fault_baseline(nodes, pods, placed):
    """The pods as a fault sweep's baseline: each pending pod a pass placed
    bound where it went (`spec.nodeName`), the others as they were. Pods
    pinned to a node the cluster lacks are left out: `FaultSweep.from_cluster`
    rejects a binding to an unknown node, as the reference's does."""
    names = {nd["metadata"]["name"] for nd in nodes}
    out = []
    for pd in pods:
        node = pd["spec"].get("nodeName")
        if node and node not in names:
            continue
        key = (pd["metadata"].get("namespace", "default"), pd["metadata"]["name"])
        if not node and placed.get(key):
            pd = {**pd, "spec": {**pd["spec"], "nodeName": placed[key]}}
        out.append(pd)
    return out


def fault3_input(kp, passes3):
    """The default-profile sweep's inputs at phase 3's size: phase 3's
    default cluster with the TPU32 kernel pass's placements as the
    baseline."""
    nodes, pods, _, _, objects = phase3_workloads(kp)["default"]
    placed = passes3["default", kp.TPU32.name, "default"]["placements"]
    return dict(nodes=nodes, pods=fault_baseline(nodes, pods, placed), objects=objects)


def fault3_sweep(kp, inp, device, lo=0, hi=FAULT3_SCENARIOS, prob=FAULT3_PROB, budget=None,
                 **opts):
    """Scenarios [lo, hi) of the default-profile sweep on `device` (at
    fail_prob `prob`, FaultSweep options `opts`, a counted budget `budget`
    set after construction): the sweep, its masks, profile and final
    states. Each scenario runs on its own, so a share of the scenarios gives
    their rows of the whole sweep."""
    sw = kp.FaultSweep.from_cluster(inp["nodes"], inp["pods"], kp.supported_config(),
                                    policy=kp.TPU32, device=device, **inp["objects"], **opts)
    if budget is not None:
        sw.gang.static_rounds = budget  # read at run time
    masks = sw.sample_masks(FAULT3_SCENARIOS, seed=FAULT3_SEED, fail_prob=prob)
    t0 = time.perf_counter()
    prof = sw.run(masks[lo:hi])
    return sw, masks, prof, time.perf_counter() - t0


def plain_fault3(kp, out_dir, part):
    """A plain worker's share of the default-profile sweep (phase 4k), or of
    its counted sweep at FAULT3_CARD_PROB (phase 4l(e)), on the host CPU
    through the plain versions."""
    if part in FAULT4L_PARTS:
        (lo, hi), opts = FAULT4L_PARTS[part], dict(prob=FAULT3_CARD_PROB, loop="static",
                                                   budget=FAULT4L_BUDGET)
    else:
        (lo, hi), opts = FAULT3_PARTS[part], {}
    inp = wait_input(out_dir, "fault3_in")
    sw, masks, prof, secs = fault3_sweep(kp, inp, torch.device("cpu"), lo, hi, **opts)
    return dict(digest=encoding_digest(sw.enc), masks=masks, lo=lo, hi=hi, profile=prof,
                states=_state_dict(sw._states), bound=_state_dict(sw._state_bound),
                seconds=secs)


def fault_launches(counts, plain, rounds, what, topk=True, binds=1):
    """A sweep's launches: the baseline's `binds` gang_bind (1 with the
    sweep's construction), one fault_evict and one fault_tally, one launch
    of each tenant form a round, no plain call."""
    want = {"gang_bind": binds, "fault_evict": 1, "fault_tally": 1, "batch_eval": rounds,
            "batch_match": rounds, "batch_bind": rounds, "gang_topk": rounds if topk else 0}
    got = {k: counts[k] for k in want}
    others = {k: v for k, v in counts.items() if k not in want and v}
    if got != want or others or any(plain.values()):
        raise AssertionError(f"{what}: launches {counts}, want {want}; plain {plain}")


def check_run_one(sw, masks, prof, what):
    """`run_one` of scenario 0 and of the worst scenario equal their rows of
    `run`. Returns the scenarios checked."""
    scenarios = sorted({0, prof["worstScenario"]})
    for s in scenarios:
        a, ev, re, st, r = sw.run_one(masks[s])
        if (not np.array_equal(a.cpu().numpy(), prof["assignments"][s])
                or [int(ev), int(re), int(st), int(r)] != [
                    prof[k][s] for k in ("evicted", "rescheduled", "stranded", "rounds")]):
            raise AssertionError(f"{what}: run_one of scenario {s} differs from its row of run")
    return scenarios


def check_fault_profile(prof, masks, what):
    """No scenario places a pod on a node that failed in it, and every
    evicted pod is rescheduled or stranded."""
    a, fail = prof["assignments"], masks.cpu().numpy()
    s_idx = np.nonzero(a >= 0)
    if fail[s_idx[0], a[s_idx]].any():
        raise AssertionError(f"{what}: a pod was placed on a failed node")
    for s, (ev, re, st) in enumerate(zip(prof["evicted"], prof["rescheduled"], prof["stranded"])):
        if re + st != ev:
            raise AssertionError(f"{what}: scenario {s} rescheduled {re} + stranded {st} != "
                                 f"evicted {ev}")


def drive_fault_sweep(kp, cuda, diff, fit, fault3_in, smi):
    """Phase 4k: (a) the fault sweep at full width, docs/lifecycle.md's
    example: `FaultSweep.from_cluster` on phase 4's cluster with phase 4's
    placements as the baseline, `sample_masks(256, seed=7, fail_prob=0.05)`,
    `run`, with the counters set to 0 just before the construction and read
    just after the run: one gang_bind (the baseline), one fault_evict, one
    launch of each tenant form a round, one fault_tally, no plain call.
    `run_one` of scenario 0 and of the worst scenario equal their rows, no
    pod lands on a failed node, rescheduled + stranded = evicted. A second
    run with each launch between CUDA events gives the device ms by kernel
    and the inputs phase 5h launches again. (b) the default profile at phase
    3's size: FAULT3_SCENARIOS scenarios at FAULT3_PROB of phase 3's default
    cluster on the card, whose plain sweep two workers share (4h), then at
    FAULT3_CARD_PROB on the card alone, checked as (a) is."""
    nodes, pods, cfg, _ = path_workload(kp, "fit")
    base = fault_baseline(nodes, pods, fit["placements"])
    n_bound = sum(1 for pd in base if pd["spec"].get("nodeName"))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_counts()
    t0 = time.perf_counter()
    sw = kp.FaultSweep.from_cluster(nodes, base, cfg, policy=kp.TPU32)
    masks = sw.sample_masks(FAULT_SCENARIOS, seed=FAULT_SEED, fail_prob=FAULT_PROB)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prof = sw.run(masks)
    wall = time.perf_counter() - t1
    counts, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() - held
    stats = dict(sw.last_stats)
    rounds = prof["rounds"]
    enc, g = sw.enc, sw.gang
    fault_launches(counts, plain, max(rounds), "4k", g.match_width < enc.N)
    check_fault_profile(prof, masks, "4k")
    S, N = masks.shape
    worst = prof["worstScenario"]
    checked = check_run_one(sw, masks, prof, "4k")
    pending = len(enc.queue) - n_bound
    decisions = sum(prof["evicted"]) + S * pending
    k0 = max(prof["evicted"]) + pending
    isz = enc.arrays.node_alloc.element_size()
    tot = prof["totals"]
    log(f"    (a) {S} scenarios of {enc.N} nodes x {len(base)} pods ({n_bound} bound by phase "
        f"4's pass, {pending} pending), fail_prob {FAULT_PROB}, seed {FAULT_SEED}: set-up "
        f"(encode, baseline bind, masks) {t1 - t0:.3f} s; run {wall:.3f} s wall, "
        f"{decisions / wall:.1f} scenario-decisions/s ({decisions} pods to place over the "
        f"scenarios: the evicted and the baseline's pending); rounds max {max(rounds)} mean "
        f"{statistics.mean(rounds):.2f}; {stats['host_syncs']} host readbacks; failed nodes "
        f"mean {prof['failedNodes']['mean']:.2f} max {prof['failedNodes']['max']}; totals "
        f"{tot}; worst scenario {worst} ({prof['stranded'][worst]} stranded); peak memory "
        f"{peak / 2**30:.3f} GiB above what was held (scores S x K x N x {isz} B = "
        f"{S * k0 * N * isz / 2**30:.3f} GiB at round 1's K = {k0}; the order, claim and "
        f"carrier rows repeated a scenario {stats['dup_bytes'] / 2**20:.1f} MiB); launches "
        f"{ {k: v for k, v in counts.items() if v} }; run_one of scenarios "
        f"{checked} equal their rows; no pod on a failed node [{smi}]")
    timer = TenantLaunches(cuda, FAULT_FORMS)
    with timer:
        prof2 = sw.run(masks)
    if prof2["totals"] != tot or not np.array_equal(prof2["assignments"], prof["assignments"]):
        raise AssertionError("4k: the timed run differs from the first")
    ms = {n: sum(timer.ms(n)) for n in FAULT_FORMS}
    log("    (a) device ms by kernel (a second run, each launch between CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f"; {sum(ms.values()):.3f} ms of {wall * 1e3:.1f} ms wall [{smi}]")
    # (b) the default profile at phase 3's size
    cuda.reset_counts()
    t0 = time.perf_counter()
    sw3, masks3, prof3, secs3 = fault3_sweep(kp, fault3_in, CARD)
    states3 = sw3._states  # the next run of sw3 replaces them
    counts3, plain3 = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    fault_launches(counts3, plain3, max(prof3["rounds"]), "4k(b)",
                   sw3.gang.match_width < sw3.enc.N)
    check_fault_profile(prof3, masks3, "4k(b)")
    log(f"    (b) {FAULT3_SCENARIOS} scenarios of phase 3's default cluster ({sw3.enc.N} nodes, "
        f"{sw3.enc.n_pods} pods, supported_config(), its kernel pass's placements as the "
        f"baseline), fail_prob {FAULT3_PROB}: run {secs3:.3f} s ({time.perf_counter() - t0:.3f} "
        f"s with the encode); evicted {prof3['evicted']}, rescheduled {prof3['rescheduled']}, "
        f"rounds {prof3['rounds']}; launches { {k: v for k, v in counts3.items() if v} }; the "
        f"plain sweep's halves in two workers (4h) [{smi}]")
    # the same sweep at fail_prob FAULT3_CARD_PROB, on the card alone
    masks_hi = sw3.sample_masks(FAULT3_SCENARIOS, seed=FAULT3_SEED, fail_prob=FAULT3_CARD_PROB)
    cuda.reset_counts()
    t0 = time.perf_counter()
    prof_hi = sw3.run(masks_hi)
    secs_hi = time.perf_counter() - t0
    syncs_hi = sw3.last_stats["host_syncs"]
    fault_launches(dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS), max(prof_hi["rounds"]),
                   "4k(b) card", sw3.gang.match_width < sw3.enc.N, binds=0)
    check_fault_profile(prof_hi, masks_hi, "4k(b) card")
    checked = check_run_one(sw3, masks_hi, prof_hi, "4k(b) card")
    log(f"    (b) the same {FAULT3_SCENARIOS} scenarios' sweep at fail_prob {FAULT3_CARD_PROB} on "
        f"the card alone: run {secs_hi:.3f} s; evicted {prof_hi['evicted']}, rescheduled "
        f"{prof_hi['rescheduled']}, rounds {prof_hi['rounds']}; run_one of scenarios {checked} "
        f"equal their rows; no pod on a failed node [{smi}]")
    return dict(sw=sw, masks=masks, prof=prof, counts=counts, rec=timer, k0=k0, wall=wall,
                host_syncs=stats["host_syncs"], sw3=sw3, masks_hi=masks_hi, prof_hi=prof_hi,
                syncs_hi=syncs_hi, wall_hi=secs_hi,
                fault3=dict(digest=encoding_digest(sw3.enc), masks=masks3, profile=prof3,
                            states=states3, bound=sw3._state_bound))


def check_plain_fault3(diff, run, plains, what="4k(b)", path="fault"):
    """Phase 4h for 4k(b) (and 4l(e)): each worker's scenarios (their masks, baseline,
    assignments, counters, rounds and final states) against the card's
    sweep, after checking that both processes encoded the same inputs."""
    secs = []
    for plain in plains:
        lo, hi = plain["lo"], plain["hi"]
        if plain["digest"] != run["digest"] or not torch.equal(plain["masks"],
                                                                run["masks"].cpu()):
            raise AssertionError(f"{what}: the worker encoded other inputs or drew other masks")
        got, want = run["profile"], plain["profile"]
        if not np.array_equal(got["assignments"][lo:hi], want["assignments"]):
            raise AssertionError(f"{what}: scenarios {lo}-{hi - 1}' assignments differ")
        for k in ("evicted", "rescheduled", "stranded", "rounds"):
            if got[k][lo:hi] != want[k]:
                raise AssertionError(f"{what}: scenarios {lo}-{hi - 1}' {k} differ")
        for f in STATE_FIELDS:
            diff.check(path, "fault_evict", f"{what} baseline {f}", getattr(run["bound"], f),
                       plain["bound"][f].to(CARD))
            diff.check(path, "batch_bind", f"{what} scenarios {lo}-{hi - 1} {f}",
                       getattr(run["states"], f)[lo:hi], plain["states"][f].to(CARD))
        secs.append(plain["seconds"])
    log(f"    {what}: all {FAULT3_SCENARIOS} scenarios of the default-profile sweep (baseline, "
        f"assignments, evicted, rescheduled, stranded, rounds, final states) equal the plain "
        f"versions' in {len(secs)} workers on the host CPU "
        f"({' + '.join(f'{x:.1f}' for x in secs)} s)")


def fault_rows(kp, cuda, diff, run, smi):
    """Phase 5h: fault_evict and fault_tally at 4k(a)'s shapes, each held
    equal to its plain version over all its scenarios and then launched
    again from the inputs 4k's timed run kept (the median of RELAUNCHES
    launches, each timed at its library call, `relaunch_ms`); then the
    round-1 launches of the tenant forms over 4k's scenario table, each
    held against its plain version (eval on 8 rows of scenarios 0 and 1,
    the matching on MATCH_PLAIN_VARIANTS scenarios, top-k and bind on all
    of them). Bounds: bytes over 3.35 TB/s or integer operations over 67
    TFLOP/s, the larger. Library calls: `((a >= 0) & m).sum(1)` for the
    tally, torch.topk for top-k."""
    sw, first, counts = run["sw"], run["rec"].first, run["counts"]
    enc, g = sw.enc, sw.gang
    a0, N, P = enc.arrays, enc.N, enc.P
    isz = a0.node_alloc.element_size()
    st_row = nbytes(*(getattr(enc.state0, f) for f in STATE_FIELDS))
    pod_row = nbytes(a0.pod_req[0], a0.pod_sreq[0], a0.want_pair[0], a0.want_wild[0],
                     a0.want_trip[0], a0.pod_claim[0], a0.pod_disk_any[0], a0.pod_disk_rw[0],
                     a0.pod_vol3[0])
    node_row = nbytes(*(getattr(enc.state0, f)[0] for f in (
        "requested", "s_requested", "used_pair", "used_wild", "used_trip", "node_disk_any",
        "node_disk_rw", "node_vol3", "n_pods")))
    rows_out = []
    # fault_evict over all the scenarios
    (prog, a, states_in, fail), _ = first["fault_evict"]
    S = fail.shape[0]
    s_k, s_p = states_in.clone(), states_in.clone()
    ev, n_ev, masks = cuda.fault_evict(prog, a, s_k, fail)
    t0 = time.perf_counter()
    ev_p, n_p, masks_p = cuda.fault_evict_plain(prog, a, s_p, fail)
    torch.cuda.synchronize()
    evict_plain_ms = (time.perf_counter() - t0) * 1e3
    for what, x, y in (("evict mask", ev, ev_p), ("evicted", n_ev, n_p),
                       ("node masks", masks, masks_p)):
        diff.check("fault", "fault_evict", f"{S} scenarios {what}", x, y)
    for f in STATE_FIELDS:
        diff.check("fault", "fault_evict", f"{S} scenarios state {f}", getattr(s_k, f),
                   getattr(s_p, f))
    evict_ms, _ = relaunch_ms(cuda, "fault_evict",
                              lambda: cuda.fault_evict(prog, a, states_in.clone(), fail),
                              forms=FAULT_FORMS)
    n_evicted = int(n_ev.sum())
    b_evict = bound(S * P * (4 + 1) + S * N * 2 + N + S * 4
                    + n_evicted * (pod_row + 2 * node_row + 8),
                    S * P * 2 + S * N * 2 + n_evicted * (pod_row // 4 + 2))
    rows_out.append(("fault_evict", FAULT_SOURCE, "faultsweep.vrun", evict_ms, evict_plain_ms,
                     b_evict, None, counts["fault_evict"],
                     f"{S} scenarios x {P} pods, {n_evicted} evicted", None))
    # the tenant forms at round 1 over the scenario table
    (progs, arrays, st_e, w, rows, live, orders), kw_e = first["batch_eval"]
    eval_ms, scores = relaunch_ms(
        cuda, "batch_eval", lambda: cuda.batch_eval(progs, arrays, st_e, w, rows, live, orders,
                                                    **kw_e), forms=FAULT_FORMS)
    eight = torch.full((2,), 8, dtype=torch.int32, device=rows.device)
    sub = cuda.stack_states([cuda.variant_state(st_e, 0), cuda.variant_state(st_e, 1)])
    t0 = time.perf_counter()
    want = cuda.batch_eval_plain(progs[:2], arrays[:2], sub, w[:2], rows[:2, :8].contiguous(),
                                 eight, orders[:2])
    torch.cuda.synchronize()
    eval_plain_ms = (time.perf_counter() - t0) * 1e3
    n8 = min(8, int(live[:2].min()))
    diff.check("fault", "batch_eval", "round 1, scenarios 0 and 1, 8 rows", scores[:2, :n8],
               want[:, :n8])
    K = rows.shape[1]
    rows_live = int(live.sum())
    sample = [int(p) for p in rows[0, :8].tolist() if p >= 0]
    per_row = statistics.mean(attempt_cost(enc, prog, sw._state_bound, p, g.weights)[1]
                              for p in sample)
    b_eval = bound(cluster_bytes(enc) + S * N + S * st_row + rows_live * N * isz,
                   per_row * rows_live)
    rows_out.append(("batch_eval", GANG_SOURCE, "faultsweep.vrun", eval_ms, eval_plain_ms,
                     b_eval, None, counts["batch_eval"],
                     f"{S} scenarios x {K} rows ({rows_live} live)", "8 rows of 2 scenarios"))
    if "gang_topk" in first:
        (sc, live_t, mw), _ = first["gang_topk"]
        topk_ms, (vals, idx) = relaunch_ms(cuda, "gang_topk",
                                           lambda: cuda.gang_topk(sc, live_t, mw),
                                           forms=FAULT_FORMS)
        t0 = time.perf_counter()
        pv, pi = cuda.gang_topk_plain(sc, live_t, mw)
        torch.cuda.synchronize()
        topk_plain_ms = (time.perf_counter() - t0) * 1e3
        for s, lv in enumerate(live_t.tolist()):
            diff.check("fault", "gang_topk", f"round 1 scenario {s} vals", vals[s, :lv],
                       pv[s, :lv])
            diff.check("fault", "gang_topk", f"round 1 scenario {s} idx", idx[s, :lv],
                       pi[s, :lv])
        flat = sc.view(-1, sc.shape[-1])
        topk_lib_ms = events_ms(lambda: torch.topk(flat, mw, dim=1), 1, 3)
        b_topk = bound(rows_live * N * isz + rows_live * mw * (isz + 4), rows_live * N)
        rows_out.append(("gang_topk", GANG_SOURCE, "faultsweep.vrun", topk_ms, topk_plain_ms,
                         b_topk, topk_lib_ms, counts["gang_topk"],
                         f"{S} x {K} x {N} -> {mw} ({rows_live} live rows)", None))
    (vals_m, idx_m, rows_m, live_m, orders_m, claims, carriers, n_nodes, n_claims,
     iters), _ = first["batch_match"]
    match_ms, (sel, stat) = relaunch_ms(
        cuda, "batch_match", lambda: cuda.batch_match(vals_m, idx_m, rows_m, live_m, orders_m,
                                                      claims, carriers, n_nodes, n_claims,
                                                      iters), forms=FAULT_FORMS)
    sub = slice(0, MATCH_PLAIN_VARIANTS)
    t0 = time.perf_counter()
    psel, pstat = cuda.batch_match_plain(
        vals_m[sub], None if idx_m is None else idx_m[sub], rows_m[sub], live_m[sub],
        orders_m[sub], claims[sub], None if carriers is None else carriers[sub], n_nodes,
        n_claims, iters)
    torch.cuda.synchronize()
    match_plain_ms = (time.perf_counter() - t0) * 1e3
    diff.check("fault", "batch_match", "round 1 sel", sel[sub], psel)
    diff.check("fault", "batch_match", "round 1 stat", stat[sub], pstat)
    Wm = vals_m.shape[2]
    b_match = bound(rows_live * Wm * (isz + 4) + S * K * 4 * 3, rows_live * Wm)
    rows_out.append(("batch_match", GANG_SOURCE, "faultsweep.vrun", match_ms, match_plain_ms,
                     b_match, None, counts["batch_match"], f"{S} x {K} x {Wm}",
                     f"{MATCH_PLAIN_VARIANTS} of the {S} scenarios"))
    (progs_b, arrays_b, st_b, rows_b, live_b, sel_b, orders_b), kw_b = first["batch_bind"]
    bind_ms, s1 = relaunch_ms(
        cuda, "batch_bind", lambda: cuda.batch_bind(progs_b, arrays_b, st_b.clone(), rows_b,
                                                    live_b, sel_b, orders_b, **kw_b),
        forms=FAULT_FORMS)
    t0 = time.perf_counter()
    s2 = cuda.batch_bind_plain(progs_b, arrays_b, st_b.clone(), rows_b, live_b, sel_b,
                               orders_b)
    torch.cuda.synchronize()
    bind_plain_ms = (time.perf_counter() - t0) * 1e3
    for f in STATE_FIELDS:
        diff.check("fault", "batch_bind", f"round 1 {f}", getattr(s1, f), getattr(s2, f))
    committed = int((sel_b >= 0).sum())
    b_bind = bound(4 * 3 * S * K + committed * (pod_row + 2 * node_row + 8),
                   committed * (pod_row // 4 + 2))
    rows_out.append(("batch_bind", GANG_SOURCE, "faultsweep.vrun", bind_ms, bind_plain_ms,
                     b_bind, None, counts["batch_bind"], f"{committed} commits", None))
    # fault_tally at the sweep's end
    (asg, evict, evicted), _ = first["fault_tally"]
    tally_ms, (re, st) = relaunch_ms(cuda, "fault_tally",
                                     lambda: cuda.fault_tally(asg, evict, evicted),
                                     forms=FAULT_FORMS)
    t0 = time.perf_counter()
    re_p, st_p = cuda.fault_tally_plain(asg, evict, evicted)
    torch.cuda.synchronize()
    tally_plain_ms = (time.perf_counter() - t0) * 1e3
    diff.check("fault", "fault_tally", f"{S} scenarios rescheduled", re, re_p)
    diff.check("fault", "fault_tally", f"{S} scenarios stranded", st, st_p)
    tally_lib_ms = events_ms(lambda: ((asg >= 0) & evict).sum(1), 1, 3)
    b_tally = bound(S * P * (4 + 1) + S * 4 * 3, S * P * 3)
    rows_out.append(("fault_tally", FAULT_SOURCE, "faultsweep.vrun", tally_ms, tally_plain_ms,
                     b_tally, tally_lib_ms, counts["fault_tally"], f"{S} scenarios x {P} pods",
                     None))
    # the baseline's bind (K11 `faultsweep.bind_all`): one gang_bind over the
    # assigned pods at construction, launched again from state0
    asg0 = sw._state_bound.assignment
    rows0 = torch.nonzero(asg0 >= 0)[:, 0].to(torch.int32)
    sel0 = asg0[rows0.long()].contiguous()
    prog0 = g._base.program
    got0 = cuda.gang_bind(prog0, a0, enc.state0.clone(), rows0, None, sel0, sw._order)
    t0 = time.perf_counter()
    want0 = cuda.gang_bind_plain(prog0, a0, enc.state0.clone(), rows0, None, sel0, sw._order)
    torch.cuda.synchronize()
    bind0_plain_ms = (time.perf_counter() - t0) * 1e3
    for f in STATE_FIELDS:
        diff.check("fault", "gang_bind", f"bind_all {f}", getattr(got0, f), getattr(want0, f))
        diff.check("fault", "gang_bind", f"bind_all against the sweep's baseline {f}",
                   getattr(got0, f), getattr(sw._state_bound, f))
    n0 = rows0.numel()
    lib0 = stacked_bind_lib(enc, rows0[None], sel0[None], sw._order)
    st_k0, st_l0 = cuda.as_variants(enc.state0.clone()), cuda.as_variants(enc.state0.clone())
    bind0_ms = events_ms(lambda: cuda.gang_bind(prog0, a0, st_k0, rows0[None], None, sel0[None],
                                                sw._order), 1, 3)
    bind0_lib_ms = events_ms(lambda: lib0(st_l0), 1, 3)
    b_bind0 = bound(4 * 3 * n0 + n0 * (pod_row + 2 * node_row + 8), n0 * (pod_row // 4 + 2))
    rows_out.insert(0, ("gang_bind", GANG_SOURCE, "faultsweep.bind_all", bind0_ms,
                        bind0_plain_ms, b_bind0, bind0_lib_ms, 1, f"{n0} baseline pods", None))
    out = []
    for name, source, kind, ms, plain_ms, b, lib_ms, n_launch, shape, basis in rows_out:
        row = {"name": name, "path": "fault", "route": "cuda", "source": source,
               "replaces": REPLACES[kind], "launches": n_launch,
               "max_abs_err": diff.err[("fault", name)], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b[0], "bound_by": b[1], "library_ms": lib_ms, "shape": shape}
        if basis:
            row["plain_basis"] = basis
        out.append(row)
        log(f"    fault {name:11s} {ms:.6f} ms at {shape} (plain {plain_ms:.3f} ms"
            + (f" for {basis}" if basis else "") + f", bound {b[0]:.7f} ms by {b[1]}, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.6f} ms'}), {n_launch} launches on "
            f"4k's path [{smi}]")
    return out


# ---------------------------------------------------------------------------
# the counted loops: K9's counted forms (phases 4l and 5i)
# ---------------------------------------------------------------------------

COUNTED_FORMS = ("gang_eval", "gang_topk", "gang_match_counted", "gang_bind", "gang_advance")
COUNTED_FAULT_FORMS = ("fault_evict", "batch_eval", "gang_topk", "batch_match_counted",
                       "batch_bind", "gang_advance", "fault_tally")
COUNTED_SOURCE = GANG_SOURCE
REPLACES.update({"gang.m_scan": "kube_scheduler_simulator_tpu/engine/gang.py:884",
                 "gang.r_scan": "kube_scheduler_simulator_tpu/engine/gang.py:1055"})


def counted_forms(forms, g):
    """The kernels a counted pass of gang `g` launches: gang_topk only below
    full width."""
    return tuple(k for k in forms if k != "gang_topk" or g.match_width < g.enc.N)


def check_counted_launches(counts, plain, forms, what):
    """Each kernel of `forms` launched, the while-loop matching never, no
    plain call."""
    if (any(counts[k] < 1 for k in forms) or counts["gang_match"] or counts["batch_match"]
            or any(plain.values())):
        raise AssertionError(f"{what}: launches {counts}, plain calls {plain}")


def counted_run(cuda, forms, fn, what):
    """fn() with the counters set to 0 just before and read just after, then
    again with each launch of `forms` timed at its library call
    (`TenantLaunches`): (the first call's output, its wall s, its launches,
    device ms by kernel of the second, the second's first inputs of each
    kernel). Both calls must give equal outputs (`same`)."""
    torch.cuda.synchronize()
    cuda.reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    check_counted_launches(counts, plain, forms, what)
    rec = TenantLaunches(cuda, forms)
    with rec:
        out2 = fn()
    return out, out2, wall, counts, {n: sum(rec.ms(n)) for n in forms}, rec.first


def log_counted(what, rounds, slots, syncs, dyn_rounds, dyn_syncs, wall, dyn_wall, ms, counts,
                forms, smi, extra=""):
    log(f"    {what}: {rounds} rounds progressed in {slots} round slots launched; readbacks "
        f"{syncs} (dynamic {dyn_syncs}); dynamic rounds {dyn_rounds}; wall {wall:.3f} s "
        f"(dynamic {dyn_wall:.3f} s); device ms (a second run, each launch timed at its library "
        "call): " + ", ".join(f"{k} {ms[k]:.3f}" for k in forms)
        + f"; launches { {k: counts[k] for k in forms} }{extra} [{smi}]")


def counted_gang(kp, cuda, enc, dyn, what, smi, **kw):
    """GangScheduler(enc, loop="static", **kw).run() through `counted_run`:
    its placements and assignment equal the dynamic run `dyn`'s (same
    inner_iters), its rounds one fewer (the slots that progressed: the
    dynamic loop counts its last, empty round)."""
    forms = counted_forms(COUNTED_FORMS, kp.GangScheduler(enc, **kw))
    engines = []

    def run():
        engines.append(kp.GangScheduler(enc, loop="static", **kw))
        return engines[-1].run()

    (state, rounds), (state2, rounds2), wall, counts, ms, first = counted_run(cuda, forms, run,
                                                                               what)
    g = engines[0]
    if (g.placements() != dyn["placements"] or rounds != dyn["rounds"] - 1
            or not torch.equal(state.assignment, dyn["state"].assignment)):
        raise AssertionError(f"{what}: {rounds} rounds (dynamic {dyn['rounds']}), or placements "
                             "other than the dynamic run's")
    if rounds2 != rounds or not torch.equal(state2.assignment, state.assignment):
        raise AssertionError(f"{what}: the timed run differs from the first")
    st = g.last_stats
    log_counted(what, rounds, counts["gang_advance"], st["host_syncs"], dyn["rounds"],
                dyn["host_syncs"], wall, dyn["wall"], ms, counts, forms, smi,
                f"; budget {g.static_rounds} slots a pass, {st['phases']} preempt phases")
    return dict(g=g, counts=counts, first=first, ms=ms, wall=wall, rounds=rounds)


def dynamic_gang(kp, enc):
    """A dynamic GangScheduler(enc).run(): what counted_gang compares."""
    g = kp.GangScheduler(enc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, rounds = g.run()
    torch.cuda.synchronize()
    return dict(placements=g.placements(), rounds=rounds, state=state,
                host_syncs=g.last_stats["host_syncs"], wall=time.perf_counter() - t0)


def baseline_of(sw):
    """A fault sweep's baseline as FaultSweep's assignment argument."""
    return {k: v for k, v in sw.enc.decode_assignment(sw._state_bound.assignment).items() if v}


def counted_fault(kp, cuda, diff, sw, masks, prof, dyn_syncs, dyn_wall, what, smi, budget=None):
    """FaultSweep(loop="static") over `sw`'s encoding and baseline (the
    construction's baseline bind inside the counted run; `budget`, when
    given, set after construction) on `masks` through `counted_run`. Each
    scenario's rounds are min(dynamic - 1, budget) and
    every pod the counted sweep places is where the dynamic sweep `prof`
    placed it (its slots are the dynamic loop's first rounds); returns the
    sweep, its profile and, where every scenario fit the budget, checks it
    equal to `prof`."""
    forms = counted_forms(COUNTED_FAULT_FORMS, sw.gang)
    sweeps, base = [], baseline_of(sw)

    def run():
        sweeps.append(kp.FaultSweep(sw.enc, base, loop="static"))
        if budget is not None:
            sweeps[-1].gang.static_rounds = budget
        return sweeps[-1].run(masks)

    got, got2, wall, counts, ms, first = counted_run(cuda, forms + ("gang_bind",), run, what)
    sw_s = sweeps[0]
    budget = sw_s.gang.static_rounds
    for f in STATE_FIELDS:
        diff.check("counted", "gang_bind", f"{what} baseline {f}", getattr(sw_s._state_bound, f),
                   getattr(sw._state_bound, f))
    check_fault_profile(got, masks, what)
    a_s, a_d = got["assignments"], prof["assignments"]
    want_rounds = [min(r - 1, budget) for r in prof["rounds"]]
    if got["rounds"] != want_rounds or ((a_s >= 0) & (a_s != a_d)).any():
        raise AssertionError(f"{what}: rounds {got['rounds']} (want {want_rounds}), or a pod "
                             "placed where the dynamic sweep did not place it")
    if max(prof["rounds"]) - 1 <= budget and (not np.array_equal(a_s, a_d) or any(
            got[k] != prof[k] for k in ("evicted", "rescheduled", "stranded"))):
        raise AssertionError(f"{what}: every scenario fit the budget, yet the profile differs "
                             "from the dynamic sweep's")
    if got2["totals"] != got["totals"] or not np.array_equal(got2["assignments"], a_s):
        raise AssertionError(f"{what}: the timed run differs from the first")
    each = masks.shape[0] <= FAULT3_SCENARIOS  # few scenarios: print each one's
    stranded = [(x["stranded"] if each else x["totals"]["stranded"]) for x in (got, prof)]
    log_counted(what, got["rounds"] if each else f"max {max(got['rounds'])}",
                counts["gang_advance"], sw_s.last_stats["host_syncs"],
                prof["rounds"] if each else f"max {max(prof['rounds'])}", dyn_syncs, wall,
                dyn_wall, ms, counts, forms, smi,
                f"; budget {budget} slots; stranded {stranded[0]} (dynamic {stranded[1]})")
    return dict(sw=sw_s, prof=got, counts=counts, first=first, ms=ms, wall=wall)


def drive_counted(kp, cuda, diff, fit, gang_aff, gsweep, fault, smi):
    """Phase 4l: the counted gang forms (loop="static"), TPU32, each run with
    the counters set to 0 just before and read just after (every counted
    kernel launched, the while-loop matching never, no plain call), then
    again with each launch timed: (a) GangScheduler on phase 4's fit cluster
    and on phase 4e's affinity gang cluster (config #3), placements and
    assignment equal to the dynamic runs (a fresh one on the fit cluster,
    4e's on the affinity one) at equal inner_iters, rounds one fewer; (b)
    the fit cluster at static_rounds=COUNTED_BUDGET, so that passes resume: the same
    placements; (c) GangSweep(loop="static") of config #4's first
    COUNTED_SWEEP_VARIANTS variants (4i(a)'s weights) against the dynamic
    sweep of the same; (d) FaultSweep(loop="static") of 4k(a)'s 256 masks,
    whose every scenario fits the budget: 4k(a)'s profile; (e) the same
    over 4k(b)'s 8 scenarios at FAULT3_CARD_PROB, whose longer fixpoints
    the budget cuts, at the default budget and at FAULT4L_BUDGET set after
    construction: stranded pods, the placed ones where the dynamic sweep put
    them, the latter held whole against the plain versions in the three
    workers (4h). Each prints rounds progressed against slots launched, readbacks against
    the dynamic run's, wall and device ms by kernel."""
    out = {}
    enc_fit = fit["eng"].enc
    dyn_fit = out["dyn_fit"] = dynamic_gang(kp, enc_fit)  # phase 4m(b) reads it too
    out["fit"] = counted_gang(kp, cuda, enc_fit, dyn_fit, "(a) fit cluster", smi)
    aff = dict(gang_aff, wall=gang_aff["run_s"])
    out["affinity"] = counted_gang(kp, cuda, gang_aff["enc"], aff, "(a) affinity cluster", smi)
    out["resumed"] = counted_gang(kp, cuda, enc_fit, dyn_fit,
                                  f"(b) fit cluster, budget {COUNTED_BUDGET}", smi,
                                  static_rounds=COUNTED_BUDGET)
    if out["resumed"]["g"].last_stats["host_syncs"] < 2:
        raise AssertionError(f"4l(b): the budget of {COUNTED_BUDGET} did not resume")
    # (c) the gang sweep
    enc4, w8 = gsweep["a"]["enc"], gsweep["a"]["w"][:COUNTED_SWEEP_VARIANTS]
    dyn_sw = kp.GangSweep(enc4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    asg_d, rounds_d = dyn_sw.run(w8)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    forms = counted_forms(COUNTED_FORMS, dyn_sw.gang)
    sweeps = []

    def sweep():
        sweeps.append(kp.GangSweep(enc4, loop="static"))
        return sweeps[-1].run(w8)

    (asg_s, rounds_s), (asg_2, _), wall, counts, ms, _ = counted_run(cuda, forms, sweep,
                                                                     "4l(c)")
    if not torch.equal(asg_s, asg_d) or not torch.equal(asg_2, asg_s):
        raise AssertionError("4l(c): the counted sweep places otherwise than the dynamic one")
    st = sweeps[0].last_stats
    log_counted(f"(c) GangSweep of {len(w8)} config #4 variants", rounds_s.tolist(),
                counts["gang_advance"], st["host_syncs"], rounds_d.tolist(),
                dyn_sw.last_stats["host_syncs"], wall, wall_d, ms, counts, forms, smi,
                f"; {st['passes']} passes, {st['phases']} phases; assignments equal the dynamic "
                "sweep's")
    out["sweep"] = dict(counts=counts, ms=ms, wall=wall)
    # (d), (e) the fault sweeps
    out["fault"] = counted_fault(kp, cuda, diff, fault["sw"], fault["masks"], fault["prof"],
                                 fault["host_syncs"], fault["wall"],
                                 f"(d) FaultSweep of 4k(a)'s {FAULT_SCENARIOS} masks", smi)
    sw3, what = fault["sw3"], (f"(e) FaultSweep of 4k(b)'s {FAULT3_SCENARIOS} scenarios at "
                               f"fail_prob {FAULT3_CARD_PROB}")
    args = (kp, cuda, diff, sw3, fault["masks_hi"], fault["prof_hi"], fault["syncs_hi"],
            fault["wall_hi"])
    out["faulte_default"] = counted_fault(*args, f"{what}, the default budget", smi)
    e = counted_fault(*args, f"{what}, a budget of {FAULT4L_BUDGET}", smi, FAULT4L_BUDGET)
    if e["prof"]["totals"]["stranded"] <= fault["prof_hi"]["totals"]["stranded"]:
        raise AssertionError("4l(e): the budget stranded no pod the dynamic sweep placed")
    out["faulte"] = e
    out["fault4l"] = dict(digest=encoding_digest(sw3.enc), masks=fault["masks_hi"],
                          profile=e["prof"], states=e["sw"]._states, bound=e["sw"]._state_bound)
    return out


def counted_rows(cuda, diff, run, smi):
    """Phase 5i: gang_match's counted form at 4l(a)'s round 1 on the fit
    cluster (one variant, every pending row) and its tenant form at 4l(d)'s
    round 1 (every scenario), gang_advance at both: each held equal to its
    plain version (the tenant matching on MATCH_PLAIN_VARIANTS scenarios),
    the counted matching's sel also to the while-loop matching's, then
    launched again from the inputs 4l's timed runs kept (the median of
    RELAUNCHES launches at the library call, `relaunch_ms`), beside the
    while-loop matching's time on the same inputs. Bounds: bytes over 3.35
    TB/s or integer operations over 67 TFLOP/s, the larger; the counted
    matching's operations are its iterations' compares. No PyTorch call
    computes either function."""
    names = ("gang_match_counted", "batch_match_counted", "gang_advance")
    launches = {k: sum(run[r]["counts"][k] for r in ("fit", "affinity", "resumed", "sweep",
                                                      "fault", "faulte_default", "faulte"))
                for k in names}
    forms = names + ("gang_match", "batch_match")
    out = []

    def row(path, name, kind, ms, plain_ms, b, shape, basis=None, **extra):
        r = {"name": name, "path": path, "route": "cuda", "source": COUNTED_SOURCE,
             "replaces": REPLACES[kind], "launches": launches[name],
             "max_abs_err": diff.err[(path, name)], "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b[0], "bound_by": b[1], "library_ms": None, "shape": shape, **extra}
        if basis:
            r["plain_basis"] = basis
        out.append(r)
        log(f"    {path:13s} {name:19s} {ms:.6f} ms at {shape} (plain {plain_ms:.3f} ms"
            + (f" for {basis}" if basis else "") + f", bound {b[0]:.7f} ms by {b[1]}, library "
            f"none), {launches[name]} launches on 4l's runs [{smi}]")

    for path, what, src, name, plain_fn, sub in (
            ("counted", "4l(a) fit, round 1", run["fit"], "gang_match_counted",
             cuda.gang_match_plain, slice(None)),
            ("counted fault", f"4l(d) {FAULT_SCENARIOS} scenarios, round 1", run["fault"],
             "batch_match_counted", cuda.batch_match_plain, slice(0, MATCH_PLAIN_VARIANTS))):
        args, _ = src["first"][name]
        vals, idx, rows, live, order, claims, carrier, n_nodes, n_claims, iters = args
        wrapper = cuda.gang_match if name == "gang_match_counted" else cuda.batch_match
        ms, (sel, stat) = relaunch_ms(cuda, name, lambda: wrapper(*args, counted=True),
                                      forms=forms)
        dyn_ms, (dsel, _) = relaunch_ms(cuda, name.replace("_counted", ""),
                                        lambda: wrapper(*args), forms=forms)
        tenant = name == "batch_match_counted"
        cut = [vals[sub], None if idx is None else idx[sub], rows[sub], live[sub]] + [
            x if x is None or not tenant else x[sub] for x in (order, claims, carrier)]
        t0 = time.perf_counter()
        psel, pstat = plain_fn(*cut, n_nodes, n_claims, iters, counted=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        diff.check(path, name, f"{what} sel", sel[sub], psel)
        diff.check(path, name, f"{what} stat", stat[sub], pstat)
        diff.check(path, name, f"{what} sel against the while loop's", sel, dsel)
        V, K, W = vals.shape
        n_live = int(live.clamp(min=0).sum())
        b = bound(n_live * W * (vals.element_size() + (4 if idx is not None else 0))
                  + V * K * 4 * 3, iters * n_live * W)
        row(path, name, "gang.m_scan", ms, plain_ms, b,
            f"{V} x {K} x {W}, {iters} iterations, {n_live} live rows",
            None if sub == slice(None) else f"{MATCH_PLAIN_VARIANTS} of the {V} scenarios",
            while_loop_ms=dyn_ms)
        (stat_a, acc, wp, n_pods), _ = src["first"]["gang_advance"]
        adv_ms, acc_k = relaunch_ms(cuda, "gang_advance",
                                    lambda: cuda.gang_advance(stat_a, acc.clone(), wp, n_pods),
                                    forms=forms)
        t0 = time.perf_counter()
        acc_p = cuda.gang_advance_plain(stat_a, acc.clone(), wp, n_pods)
        torch.cuda.synchronize()
        adv_plain_ms = (time.perf_counter() - t0) * 1e3
        diff.check(path, "gang_advance", f"{what} accounting", acc_k, acc_p)
        Va = acc.shape[1]
        row(path, "gang_advance", "gang.r_scan", adv_ms, adv_plain_ms,
            bound(Va * (8 + 2 * 4 * acc.shape[0]), Va * 24),
            f"{Va} variants' accounting, window {wp or 'none'}")
    return out


# ---------------------------------------------------------------------------
# the PACKED dtype policy: K8 (phases 4m and 5j)
# ---------------------------------------------------------------------------

PACK_SOURCE = "kube_scheduler_simulator_tpu_torch/csrc/pack_kernels.cu"
PACK_REPLACES = "kube_scheduler_simulator_tpu/engine/packing.py:158"


def pack_leaves(enc):
    """(names, leaves, lane counts) of every bit-packed (lanes n > 0) or
    narrow (0) plane of a PACKED encoding: what `packing.widen` hands K8."""
    from kube_scheduler_simulator_tpu_torch.engine.packing import widen_leaves

    picked = widen_leaves(enc.arrays, enc.aux["packed_dims"])
    return ([name for _, name, _, _ in picked], [t for _, _, t, _ in picked],
            [n for _, _, _, n in picked])


def check_same_run(what, got_trace, got_state, want_trace, want_state, slots):
    """Byte equality of two kernel runs' traces and final states."""
    if len(got_trace) != len(want_trace):
        raise AssertionError(f"{what}: {len(got_trace)} trace slots against {len(want_trace)}")
    for slot, g, h in zip(slots, got_trace, want_trace):
        if g.dtype != h.dtype or g.shape != h.shape or not torch.equal(g, h):
            raise AssertionError(f"{what}: trace slot {slot} differs from the TPU32 run's")
    for f in STATE_FIELDS:
        if not torch.equal(getattr(got_state, f), getattr(want_state, f)):
            raise AssertionError(f"{what}: final state {f} differs from the TPU32 run's")


def packed_pass(kp, cuda, path, cluster, tpu32, smi):
    """Phase 4m(a) for one cell: encode_cluster(policy=PACKED), the pass
    (one K8 launch at its entry, then seq_run), placements and the sampled
    records, each part timed, the counters set to 0 just before and read
    just after; held byte-equal to the TPU32 kernel run of phase 4, 4b or
    4c (trace, final state, placements, the sampled pods' annotations)."""
    from kube_scheduler_simulator_tpu_torch.engine.packing import encoded_device_bytes

    nodes, pods, cfg, sample, objects = cluster
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cuda.reset_counts()
    t0 = time.perf_counter()
    enc = kp.encode_cluster(nodes, pods, cfg, policy=kp.PACKED, **objects)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng = kp.BatchedScheduler(enc)
    state, trace = eng.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    placements = eng.placements()
    annotations = {(r.pod_namespace, r.pod_name): r.to_annotations()
                   for r in eng.results(pods=sample)}
    t3 = time.perf_counter()
    counts, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() - base
    if counts["pack_widen"] != 1 or counts["seq_run"] != 1 or any(plain.values()):
        raise AssertionError(f"4m(a) {path}: launches {counts}, plain calls {plain}")
    slots = cuda.TRACE_SLOTS_PREEMPT if eng.preempts else cuda.TRACE_SLOTS_PLAIN
    check_same_run(f"4m(a) {path}", trace, state, tpu32["trace"], tpu32["state"], slots)
    if placements != tpu32["placements"] or annotations != tpu32["annotations"]:
        raise AssertionError(f"4m(a) {path}: placements or sampled annotations differ from "
                             "the TPU32 run's")
    names, _, lanes = pack_leaves(enc)
    bits = {n: k for n, k in zip(names, lanes) if k}
    b_p, b_w = encoded_device_bytes(enc), encoded_device_bytes(tpu32["enc"])
    sw = tpu32["split"]
    log(f"    {path}: {len(enc.queue)} pods; bit-packed {bits}, {len(names) - len(bits)} planes "
        f"narrowed; arrays {b_w['arrays']} -> {b_p['arrays']} bytes on the card (state0 "
        f"{b_p['state0']}); peak memory {peak / 2**30:.3f} GiB (TPU32 {tpu32['peak'] / 2**30:.3f}"
        f" GiB); encode {t1 - t0:.3f} s, pass {t2 - t1:.3f} s, decode {t3 - t2:.3f} s (TPU32 "
        f"{sw[0]:.3f} / {sw[1]:.3f} / {sw[2]:.3f} s); trace, state, {len(placements)} placements "
        f"and {len(annotations)} pods' annotations equal the TPU32 run's; launches "
        f"{ {k: v for k, v in counts.items() if v} } [{smi}]")
    if path != "fit" and not bits:
        raise AssertionError(f"4m(a) {path}: no plane was bit-packed")
    return dict(enc=enc, counts=counts, peak=peak, split=(t1 - t0, t2 - t1, t3 - t2),
                bytes=(b_w, b_p), bits=bits, narrowed=len(names) - len(bits))


def packed_gang(kp, cuda, enc, dyn, smi):
    """Phase 4m(b): the fit cell's gang under PACKED on 4m(a)'s PACKED
    encoding: one K8 launch for the drive, then the K9 kernels; rounds,
    final state and placements equal 4l(a)'s dynamic TPU32 gang `dyn` on
    the same cluster."""
    g = kp.GangScheduler(enc)
    torch.cuda.synchronize()
    cuda.reset_counts()
    t0 = time.perf_counter()
    state, rounds = g.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    if counts["pack_widen"] != 1 or counts["gang_eval"] < 1 or any(plain.values()):
        raise AssertionError(f"4m(b): launches {counts}, plain calls {plain}")
    if (rounds != dyn["rounds"] or g.placements() != dyn["placements"]
            or any(not torch.equal(getattr(state, f), getattr(dyn["state"], f))
                   for f in STATE_FIELDS)):
        raise AssertionError("4m(b): the PACKED gang differs from 4l(a)'s dynamic TPU32 gang")
    log(f"    fit gang: {rounds} rounds in {wall:.3f} s (TPU32 {dyn['wall']:.3f} s), state and "
        f"placements equal 4l(a)'s dynamic gang's; launches {counts['pack_widen']} pack_widen, "
        f"{ {k: counts[k] for k in GANG_KERNELS} } [{smi}]")
    return dict(counts=counts, wall=wall)


def drive_packed_serving(kp, cuda, scatter, serving, smi):
    """Phase 4m(c): 4d's first PACKED_SERVING_PASSES passes again, on a
    service under KSS_DTYPE_POLICY=packed: the snapshot, then each pass's
    arrivals and cordon. Pass 1 is a full encode, passes 2.. delta passes
    (no `packed-overflow` fallback) that launch K10's 2-byte set for the
    int16 planes; each pass's records (placements, annotations, victims)
    equal 4d's TPU32 pass's. The last pass runs after a flip back to TPU32:
    a full encode with `dtype-policy-change`, counted once in
    `encodePolicyMisses`, its records 4d's too."""
    from kube_scheduler_simulator_tpu_torch.server.service import SimulatorService

    rp = serving["replay"]
    old = os.environ.get("KSS_DTYPE_POLICY")
    os.environ["KSS_DTYPE_POLICY"] = "packed"
    try:
        sim = SimulatorService()
        sim.import_(json.loads(json.dumps(rp["snap"])))
        store, sched = sim.store, sim.scheduler
        calls, modes, walls, widen = [], [], [], 0
        for k in range(1, PACKED_SERVING_PASSES + 1):
            if k >= 2:
                for pd in rp["later"][(k - 2) * SERVING_ARRIVALS:(k - 1) * SERVING_ARRIVALS]:
                    store.apply("pods", pd)
                store.apply("nodes", {"metadata": {"name": f"node-{k}"},
                                      "spec": {"unschedulable": True}})
                store.apply("nodes", {"metadata": {"name": f"node-{k - 1}"},
                                      "spec": {"unschedulable": False}})
            if k == PACKED_SERVING_PASSES:
                os.environ["KSS_DTYPE_POLICY"] = "i32"
            cuda.reset_counts()
            scatter.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with K10Recorder(scatter) as rec:
                results = sched.schedule()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            info = dict(sched.last_encode_info)
            modes.append(info)
            widen += cuda.LAUNCHES["pack_widen"]
            if any(cuda.PLAIN_CALLS.values()) or any(scatter.PLAIN_CALLS.values()):
                raise AssertionError(f"4m(c) pass {k}: plain calls")
            want_mode = ("full" if k in (1, PACKED_SERVING_PASSES) else "delta")
            if info["mode"] != want_mode or cuda.LAUNCHES["pack_widen"] != int(
                    k < PACKED_SERVING_PASSES):
                raise AssertionError(f"4m(c) pass {k}: {info}, pack_widen "
                                     f"{cuda.LAUNCHES['pack_widen']}")
            if results != rp["records"][k]:
                raise AssertionError(f"4m(c) pass {k}: records differ from 4d's TPU32 pass")
            calls += [c for c in rec.calls
                      if c[0] == "delta_scatter_set" and c[1].element_size() == 2]
        misses = sched.metrics.phases()["encodePolicyMisses"]
        if modes[-1].get("reason") != "dtype-policy-change" or misses != 1 or not calls:
            raise AssertionError(f"4m(c): last pass {modes[-1]}, encodePolicyMisses {misses}, "
                                 f"{len(calls)} 2-byte sets")
    finally:
        if old is None:
            os.environ.pop("KSS_DTYPE_POLICY", None)
        else:
            os.environ["KSS_DTYPE_POLICY"] = old
    log(f"    serving under PACKED: passes {[m['mode'] for m in modes]} in "
        + ", ".join(f"{w:.3f}" for w in walls) + " s; every pass's records equal 4d's; "
        f"{widen} pack_widen launches; {len(calls)} 2-byte delta_scatter_set launches; the "
        f"flip to TPU32: {modes[-1]}, encodePolicyMisses {misses} [{smi}]")
    return dict(calls=calls, walls=walls, widen=widen)


def drive_packed(kp, cuda, scatter, clusters, runs, dyn_fit, serving, smi):
    """Phase 4m: (a) the fit, affinity and default cells under PACKED
    against their TPU32 runs, (b) the fit cell's gang, (c) the serving
    passes. Returns what phase 5j times."""
    out = {path: packed_pass(kp, cuda, path, clusters[path], runs[path], smi)
           for path in ("fit", "affinity", "default")}
    out["gang"] = packed_gang(kp, cuda, out["fit"]["enc"], dyn_fit, smi)
    out["serving"] = drive_packed_serving(kp, cuda, scatter, serving, smi)
    return out


def pack_rows(kp, cuda, scatter, diff, packed, smi):
    """Phase 5j: K8 on each PACKED encoding of 4m(a), first held bit for bit
    against its plain version on the card over every leaf, then its launch
    timed (a CUDA graph of 100 launches over one table), beside the plain
    version (CUDA events) and `.to(torch.int32)` over the narrow leaves (the
    one PyTorch call for that part; none for the bit planes). Bound: every
    leaf read once and its widened form written once, over 3.35 TB/s. Then
    K10's 2-byte set at 4m(c)'s recorded calls, timed as phase 5c times
    K10."""
    out = []
    for path in ("fit", "affinity", "default"):
        run = packed[path]
        names, leaves, lanes = pack_leaves(run["enc"])
        got = cuda.pack_widen(leaves, lanes)
        want = cuda.pack_widen_plain(leaves, lanes)
        for name, g, w in zip(names, got, want):
            diff.check(path, "pack_widen", f"leaf {name}", g, w)
        outs, table, n_rows, n_chunks = cuda.pack_table(leaves, lanes)
        ms = graph_ms(lambda: cuda.pack_launch(table, n_rows, n_chunks))
        for name, g, w in zip(names, outs, want):
            diff.check(path, "pack_widen", f"timed leaf {name}", g, w)
        plain_ms = events_ms(lambda: cuda.pack_widen_plain(leaves, lanes), 3)
        narrow = [t for t, n in zip(leaves, lanes) if n == 0]
        library_ms = graph_ms(lambda: [t.to(torch.int32) for t in narrow])
        moved = nbytes(*leaves) + nbytes(*outs)
        b = bound(moved, 0)
        out.append({"name": "pack_widen", "path": path, "route": "cuda", "source": PACK_SOURCE,
                    "replaces": PACK_REPLACES, "launches": run["counts"]["pack_widen"],
                    "max_abs_err": diff.err.get((path, "pack_widen"), 0.0), "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                    "library_ms": library_ms, "leaves": len(leaves), "bytes": moved})
        log(f"    {path:8s} pack_widen  {ms:.6f} ms a launch over {len(leaves)} leaves "
            f"({len(leaves) - len(narrow)} bit-packed), {moved} bytes (plain {plain_ms:.4f} ms, "
            f"library (.to(torch.int32), the {len(narrow)} narrow leaves only) "
            f"{library_ms:.6f} ms, bound {b[0]:.7f} ms by {b[1]}), "
            f"{run['counts']['pack_widen']} launch a pass [{smi}]")
    calls = [(before.clone(), [r.to(CARD) for r in rows])
             for _, _, before, rows in packed["serving"]["calls"]]
    for arr, rows in calls:
        diff.check("serving", "delta_scatter_set", f"2-byte {tuple(arr.shape)}",
                   scatter.launch_set(arr.clone(), *rows), scatter.scatter_set_plain(
                       arr.clone(), *rows))

    def run_all():
        for arr, rows in calls:
            scatter.launch_set(arr, *rows)

    def run_plain():
        for arr, rows in calls:
            scatter.scatter_set_plain(arr, *rows)

    lib = [(a, r[0].long(), r[1]) for a, r in calls]

    def run_lib():
        for a, i, r in lib:
            a.index_copy_(0, i, r)

    n = len(calls)
    ms, plain_ms, library_ms = graph_ms(run_all) / n, events_ms(run_plain, 5) / n, \
        graph_ms(run_lib) / n
    moved = sum(rows[0].shape[0] * (2 * arr[0].numel() * arr.element_size() + 4)
                for arr, rows in calls)
    b = bound(moved / n, 0)
    out.append({"name": "delta_scatter_set (2-byte rows)", "path": "serving", "route": "cuda",
                "source": "kube_scheduler_simulator_tpu_torch/csrc/delta_kernels.cu",
                "replaces": REPLACES["delta_scatter_set"], "launches": n,
                "max_abs_err": diff.err.get(("serving", "delta_scatter_set"), 0.0), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                "library_ms": library_ms, "calls_timed": n})
    log(f"    serving  delta_scatter_set, 2-byte rows: {ms:.6f} ms a launch over the {n} calls "
        f"of 4m(c)'s delta passes (plain {plain_ms:.4f} ms, library {library_ms:.6f} ms, bound "
        f"{b[0]:.7f} ms by {b[1]}) [{smi}]")
    return out


# ---------------------------------------------------------------------------
# the fleet & memory observatory (phases 4o and 5l)
# ---------------------------------------------------------------------------

FLEET_SOURCE = "kube_scheduler_simulator_tpu_torch/csrc/fleet_kernels.cu"
FLEET_REPLACES = "kube_scheduler_simulator_tpu/utils/fleetstats.py:258"
# the mean and the fragmentation are float32 sums in another order than the
# plain version's; the bins, pending and the max are exact
FLEET_TOL = 1e-5
FLEET_TENANTS = 2  # 4o's batch window
# 5l: config #5's shape (5,000 nodes x 50,000 pods), a seeded synthetic state
FLEET5_NODES, FLEET5_PODS, FLEET5_RES = 5000, 50000, 4
FLEET_COUNTERS = {"fleet.pendingPods", "fleet.utilizationMax", "fleet.fragmentationIndex",
                  "hbm.bytesInUse"}


def fleet_check(cuda, got, want, what):
    """A K12 buffer against its plain version's: the bins, pending and the
    max bit for bit, the mean and the fragmentation within FLEET_TOL.
    Returns the largest |difference| of the float lanes."""
    g, w = got.cpu(), want.cpu()
    head = cuda.FLEET_BINS + 1
    if g.shape != w.shape or not torch.equal(g[:head], w[:head]) or g[head + 1] != w[head + 1]:
        raise AssertionError(f"{what}: fleet_quality {g.tolist()} against plain {w.tolist()}")
    err = float((g[head:].view(torch.float32).double()
                 - w[head:].view(torch.float32).double()).abs().max())
    if err > FLEET_TOL:
        raise AssertionError(f"{what}: fleet_quality's mean or fragmentation off by {err}")
    return err


class FleetCapture(Swap):
    """While active, every `fleet_quality` call keeps its inputs (cloned)
    and its output buffer. The calls go through unchanged."""

    def __init__(self, cuda):
        self.calls = []

        def make(f):
            def call(*args):
                out = f(*args)
                self.calls.append(([a.clone() for a in args], out))
                return out
            return call

        super().__init__(cuda, {"fleet_quality": make})


def fleet_recorder(fleetstats):
    """The armed recorder, keeping the last sample's arguments and each
    sample's host wall (what the pass paid for it)."""

    class Timed(fleetstats.FleetRecorder):
        def __init__(self):
            super().__init__(capacity=64)
            self.walls, self.last = [], None

        def sample_pass(self, service, enc, state, mode, assignment=None):
            t0 = time.perf_counter()
            out = super().sample_pass(service, enc, state, mode, assignment)
            self.walls.append(time.perf_counter() - t0)
            self.last = (service, enc, assignment)
            return out

    return Timed()


def check_sample(cuda, diff, what, sample, call, mode, pass_id, session):
    """A sample against the K12 call it made (the kernel's buffer held
    against the plain version on the card over the same tensors), and its
    card fields."""
    inputs, buf = call
    diff.err["fleet", "fleet_quality"] = max(diff.err.get(("fleet", "fleet_quality"), 0.0),
                                            fleet_check(cuda, buf, cuda.fleet_quality_plain(
                                                *inputs), what))
    hist, mean, mx, frag, pending = cuda.fleet_fields(buf.cpu())
    f = sample["fleet"]
    if ((sample["mode"], sample["passId"], sample["session"]) != (mode, pass_id, session)
            or f["utilization"]["histogram"] != [int(x) for x in hist]
            or f["pendingPods"] != int(pending)
            or f["utilization"]["mean"] != round(float(mean), 6)
            or f["utilization"]["max"] != round(float(mx), 6)
            or list(f["fragmentation"].values()) != [round(float(x), 6) for x in frag]
            or sum(f["utilization"]["histogram"]) != f["nodes"]):
        raise AssertionError(f"{what}: the sample {sample} does not hold its K12 buffer")
    if (set(sample["hbm"]) != {"bytesInUse", "peakBytesInUse", "bytesLimit"}
            or not {"liveArrays", "liveBytes", "deltaRetainedBytes", "warmEngines"}
            <= set(sample["buffers"])):
        raise AssertionError(f"{what}: the card's memory fields are missing: {sample}")


def sample_split(cuda, fleetstats, rec, inputs, what, smi):
    """A sample's parts again on its own tensors, after the pass: the K12
    launch (CUDA events), the readback, the pending ages (a Python loop
    over the pods) and the census (host clock). Returns the seconds by
    part, the pass's own sample wall beside them."""
    service, enc, assignment = rec.last
    kernel_ms = events_ms(lambda: cuda.fleet_quality(*inputs), 20, 3)
    parts = {"readback": [], "ages": [], "census": []}
    for _ in range(3):
        buf = cuda.fleet_quality(*inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf.cpu()
        t1 = time.perf_counter()
        rec._pending_ages(service.session_id or "default", enc, assignment)
        t2 = time.perf_counter()
        fleetstats.buffer_census(service)
        fleetstats.device_memory([service.device])
        t3 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k].append(v)
    split = {"kernel_ms": kernel_ms, "sample_ms": rec.walls[-1] * 1e3,
             **{f"{k}_ms": statistics.median(v) * 1e3 for k, v in parts.items()}}
    log(f"    {what}: sample {split['sample_ms']:.3f} ms in the pass; parts: K12 "
        f"{kernel_ms:.6f} ms (device), readback {split['readback_ms']:.3f} ms, pending ages "
        f"({enc.n_pods} pods) {split['ages_ms']:.3f} ms, census {split['census_ms']:.3f} ms "
        f"[{smi}]")
    return split


def drive_fleet(kp, cuda, diff, serving, smi):
    """Phase 4o: the fleet & memory observatory on the card at 4d's cluster
    (1,024 nodes, 10,000 bound, TPU32), a `FleetRecorder` armed. A new
    `SimulatorService` replays 4d's first three passes (the snapshot's
    pending pods; then each pass's 128 arrivals, a cordon and an uncordon),
    each `schedule()`'s records held equal to 4d's pass, which ran with
    stats off; then 4d's fourth pass's events and one
    `schedule_gang(record=False)`, its placements held equal to a
    `GangScheduler` of the service's chunk over a from-scratch encode of the
    same store. The counters are set to 0 just before each pass and read
    just after: one `fleet_quality` launch, no plain call. Each sample's
    K12 buffer is held against the plain version on the card over the same
    tensors and its fields against the buffer, the card's memory fields
    are present, and the sample's host split is timed (`sample_split`).
    Then one batch window of FLEET_TENANTS tenants of the snapshot with
    stats on and KSS_TRACE armed: one `batch_run`, one `fleet_quality` a
    tenant, a sample a tenant under its session; the trace's nesting
    balanced, each tenant's `pass.sequential`, `pass.encode` and
    `device.execute` carrying its pass id, the batch plane's spans and the
    four counter tracks; tenant 0's records 4d's first pass's."""
    from kube_scheduler_simulator_tpu_torch.server.service import SimulatorService, gang_chunk
    from kube_scheduler_simulator_tpu_torch.utils import fleetstats, telemetry

    rp = serving["replay"]
    rec = fleet_recorder(fleetstats)
    fleetstats.activate(rec)
    t_start = time.perf_counter()
    sim = SimulatorService()
    sim.import_(rp["snap"])  # the store copies what it is given
    store, sched = sim.store, sim.scheduler
    splits, launches, inputs = [], 0, None
    for k in range(1, 5):
        if k >= 2:
            for pd in rp["later"][(k - 2) * SERVING_ARRIVALS:(k - 1) * SERVING_ARRIVALS]:
                store.apply("pods", pd)
            store.apply("nodes", {"metadata": {"name": f"node-{k}"},
                                  "spec": {"unschedulable": True}})
            store.apply("nodes", {"metadata": {"name": f"node-{k - 1}"},
                                  "spec": {"unschedulable": False}})
        mode = "gang" if k == 4 else "sequential"
        fresh = store_encode(kp, store, sched.config, kp.TPU32) if mode == "gang" else None
        torch.cuda.synchronize()
        cuda.reset_counts()
        with FleetCapture(cuda) as cap:
            if mode == "sequential":
                results = sched.schedule()
            else:
                placements, _, _ = sched.schedule_gang(record=False)
            torch.cuda.synchronize()
        counts, plain = cuda.LAUNCHES["fleet_quality"], cuda.PLAIN_CALLS["fleet_quality"]
        if counts != 1 or plain or len(cap.calls) != 1 or rec.emitted != k:
            raise AssertionError(f"4o pass {k} ({mode}): fleet_quality launches {counts}, plain "
                                 f"calls {plain}, {rec.emitted} samples")
        launches += counts
        # placements as with stats off
        if mode == "sequential" and results != rp["records"][k]:
            raise AssertionError(f"4o pass {k}: records differ from 4d's pass (stats off)")
        if mode == "gang":
            g = kp.GangScheduler(fresh, strict=True, chunk=gang_chunk())
            g.run()
            if placements != fresh.decode_assignment(g._final_state.assignment.cpu().numpy()):
                raise AssertionError("4o gang pass: placements differ from a GangScheduler "
                                     "over a from-scratch encode (stats off)")
        check_sample(cuda, diff, f"4o pass {k}", rec.snapshot()[-1], cap.calls[0], mode, k,
                     "default")
        splits.append(sample_split(cuda, fleetstats, rec, cap.calls[0][0], f"pass {k} ({mode})",
                                   smi))
        if mode == "sequential":
            inputs = cap.calls[0][0]
    log(f"    4 passes with stats on in {time.perf_counter() - t_start:.3f} s (the import "
        f"included): the sequential passes' records 4d's (stats off), the gang pass's "
        f"placements a stats-off GangScheduler's; {launches} fleet_quality launches, no plain "
        f"call")

    # one batch window, stats on and KSS_TRACE armed
    t0 = time.perf_counter()
    mgr = armed_manager(FLEET_TENANTS)
    sessions = [mgr.create(name=f"fleet{i}", snapshot=tenant_copy(rp["snap"], i))[0]
                for i in range(FLEET_TENANTS)]
    old = os.environ.get(telemetry.ENV_VAR)
    os.environ[telemetry.ENV_VAR] = "1"
    try:
        spans = telemetry.active()
        with FleetCapture(cuda) as cap:
            out, wall, counts, plain, _, _, moved = run_window(
                cuda, mgr, sessions, lambda sess: sess.service.scheduler.schedule(),
                "4o window")
        events = spans.snapshot()
    finally:
        if old is None:
            os.environ.pop(telemetry.ENV_VAR)
        else:
            os.environ[telemetry.ENV_VAR] = old
    check_window(moved, counts, plain, {"batch_run": 1, "fleet_quality": FLEET_TENANTS},
                 "4o window")
    samples = rec.snapshot()[-FLEET_TENANTS:]
    ids = {x.id for x in sessions}
    if (rec.emitted != 4 + FLEET_TENANTS or {smp["session"] for smp in samples} != ids
            or len(cap.calls) != FLEET_TENANTS):
        raise AssertionError(f"4o window: samples {[smp['session'] for smp in samples]}, "
                             f"{len(cap.calls)} K12 calls")
    for inputs_w, buf in cap.calls:
        # the tenant whose sample holds this buffer's fields
        hist, mean, mx, frag, pending = cuda.fleet_fields(buf.cpu())
        which = [smp for smp in samples
                 if smp["fleet"]["utilization"]["histogram"] == [int(x) for x in hist]
                 and smp["fleet"]["pendingPods"] == int(pending)
                 and smp["fleet"]["utilization"]["mean"] == round(float(mean), 6)
                 and list(smp["fleet"]["fragmentation"].values())
                 == [round(float(x), 6) for x in frag]]
        if not which:
            raise AssertionError("4o window: a K12 call has no sample")
        check_sample(cuda, diff, "4o window", which[0], (inputs_w, buf), "sequential", 1,
                     which[0]["session"])
    if out[0] != rp["records"][1]:
        raise AssertionError("4o window: tenant 0's records differ from 4d's first pass")
    launches += FLEET_TENANTS
    fleetstats.deactivate()
    # the trace
    telemetry.check_nesting(events)
    ivs = telemetry.span_intervals(events)
    for sid in ids:
        got = {iv["name"]: iv["args"].get("pass") for iv in ivs
               if iv["args"].get("session") == sid}
        if any(got.get(n) != 1 for n in ("pass.sequential", "pass.encode", "device.execute",
                                         "batch.enroll")):
            raise AssertionError(f"4o traced window: tenant {sid}'s spans {got}")
    names = {ev["name"] for ev in events}
    counters = {ev["name"] for ev in events if ev["ph"] == "C"}
    if "batch.execute" not in names or not FLEET_COUNTERS | {"fleet.batchOccupancy"} <= counters:
        raise AssertionError(f"4o traced window: spans {sorted(names)}")
    mgr.shutdown()
    log(f"    window of {FLEET_TENANTS} tenants with stats on and KSS_TRACE armed: "
        f"{time.perf_counter() - t0:.3f} s (imports included; the window {wall:.3f} s), one "
        f"batch_run, {FLEET_TENANTS} fleet_quality launches, a sample a tenant, tenant 0's "
        f"records 4d's first pass's; {len(events)} events, nesting balanced, each tenant's "
        f"pass.sequential / pass.encode / device.execute / batch.enroll carry its pass id, "
        f"batch.execute and the counters {sorted(counters)}")
    last = max(splits, key=lambda x: x["sample_ms"])
    log(f"    the sample's host split at its slowest pass: {last} [{smi}]")
    return dict(launches=launches, splits=splits, inputs=inputs)


def fleet_rows(cuda, diff, fleet, smi):
    """Phase 5l: `fleet_quality` at 4o's serving state (the last sequential
    sample's tensors) and at config #5's shape (FLEET5_NODES x FLEET5_PODS,
    a seeded synthetic state on the card: usage up to 110% of capacity,
    about a third of the pods unassigned), each first held against its plain
    version on the card, then timed (a CUDA graph of launches), beside the
    plain version (CUDA events). No single PyTorch call computes it. Bound:
    the inputs read once and the buffer written once over 3.35 TB/s, against
    about 8 float operations a (node, resource) and 2 a pod over 67
    TFLOP/s."""
    g = torch.Generator(device=CARD).manual_seed(5)
    N, P, R = FLEET5_NODES, FLEET5_PODS, FLEET5_RES
    alloc = torch.randint(1, 1 << 20, (N, R), generator=g, device=CARD, dtype=torch.int32)
    used = (alloc.double() * torch.rand((N, R), generator=g, device=CARD, dtype=torch.float64)
            * 1.1).to(torch.int32)
    assignment = torch.randint(0, N, (P,), generator=g, device=CARD, dtype=torch.int32)
    assignment[torch.rand((P,), generator=g, device=CARD) < 0.3] = -1
    synth = (alloc, torch.ones((N,), dtype=torch.bool, device=CARD), used, assignment,
             torch.ones((P,), dtype=torch.bool, device=CARD))
    out = []
    for label, ins in (("4o serving state", fleet["inputs"]),
                       (f"config #5 shape ({N} x {P})", synth)):
        n, r = ins[0].shape
        err = fleet_check(cuda, cuda.fleet_quality(*ins), cuda.fleet_quality_plain(*ins), label)
        ms = graph_ms(lambda: cuda.fleet_quality(*ins))
        plain_ms = events_ms(lambda: cuda.fleet_quality_plain(*ins), 10)
        moved = nbytes(*ins) + (cuda.FLEET_HEAD + r) * 4
        b = bound(moved, 8 * n * r + 2 * ins[3].shape[0])
        out.append({"name": "fleet_quality", "path": label, "route": "cuda",
                    "source": FLEET_SOURCE, "replaces": FLEET_REPLACES,
                    "launches": fleet["launches"], "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                    "library_ms": None, "nodes": n, "resources": r, "pods": ins[3].shape[0],
                    "bytes": moved})
        log(f"    fleet_quality at {label} ({n} nodes x {r} resources, {ins[3].shape[0]} pods, "
            f"{ins[0].dtype}): {ms:.6f} ms a launch (plain {plain_ms:.4f} ms, bound "
            f"{b[0]:.7f} ms by {b[1]}, {moved} bytes), max |d| {err}, "
            f"{fleet['launches']} launches in 4o [{smi}]")
    return out


# ---------------------------------------------------------------------------
# the second process: the plain versions of whole passes on the host CPU
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the demo out-of-tree plugins at full width (phases 4n and 5k)
# ---------------------------------------------------------------------------

PLUGIN_NAMES = ("NetworkBandwidth", "NodeNumber")
# phase 5k's bodies, each timed alone inside seq_attempt on 4n(a)'s cell
PLUGIN_BODIES = (("filter", "NetworkBandwidth", None), ("score", "NetworkBandwidth", None),
                 ("score", "NodeNumber", None))


def plugins_fit_workload(kp):
    """4n(a)'s cell: phase 4's fit cell annotated for NetworkBandwidth,
    `fit_config()` plus both demo plugins, phase 4's 100 sampled pods:
    (nodes, pods, config, sample)."""
    from kube_scheduler_simulator_tpu_torch.synth import annotate_bandwidth

    demo_plugins()
    nodes, pods, cfg, sample = path_workload(kp, "fit")
    annotate_bandwidth(nodes, pods, seed=7)
    return nodes, pods, kp.demo_config(base=cfg), sample


def plugins_pass(kp, cuda, what, nodes, pods, cfg, sample, policy, smi, objects=None):
    """One pass of a phase-4n cell through the entry points `schedule()`
    composes (encode_cluster, BatchedScheduler.run, placements, the
    sampled records), each part timed, the counters set to 0 just before
    and read just after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cuda.reset_counts()
    t0 = time.perf_counter()
    enc = kp.encode_cluster(nodes, pods, cfg, policy=policy, **(objects or {}))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng = kp.BatchedScheduler(enc)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    state, trace = eng.run()
    e1.record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    placements = eng.placements()
    annotations = {(r.pod_namespace, r.pod_name): r.to_annotations()
                   for r in eng.results(pods=sample)}
    t3 = time.perf_counter()
    counts, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() - base
    if counts["seq_run"] != 1 or any(plain.values()):
        raise AssertionError(f"4n {what}: launches {counts}, plain calls {plain}")
    Q, wall = len(enc.queue), t3 - t0
    slots = cuda.TRACE_SLOTS_PREEMPT if eng.preempts else cuda.TRACE_SLOTS_PLAIN
    t = dict(zip(slots, trace))
    n_nb = nb_rejections(eng, t["codes"][:Q])
    extra = ""
    if eng.preempts:
        did, nom = t["did"][:Q], t["nominated"][:Q]
        extra = f", dry runs {int(did.sum())}, nominations {int((nom >= 0).sum())}"
    placed = sum(1 for v in placements.values() if v)
    log(f"    {what}: {wall:.3f} s wall (encode {t1 - t0:.3f} s, engine + pass {t2 - t1:.3f} s, "
        f"seq_run {e0.elapsed_time(e1):.1f} ms on the card, decode of placements and "
        f"{len(annotations)} records {t3 - t2:.3f} s), {Q / wall:.1f} decisions/s, {placed} of "
        f"{Q} placed{extra}; {n_nb} pods carry NetworkBandwidth's filter message; peak memory "
        f"{peak / 2**30:.3f} GiB; launches { {k: v for k, v in counts.items() if v} } [{smi}]")
    if n_nb < Q // 10:
        raise AssertionError(f"4n {what}: NetworkBandwidth rejects a node for {n_nb} of {Q} "
                             "pods (under a tenth)")
    return dict(enc=enc, eng=eng, state=state, trace=trace, t=t, placements=placements,
                annotations=annotations, counts=counts, pass_ms=e0.elapsed_time(e1),
                split=(t1 - t0, t2 - t1, t3 - t2), wall=wall, peak=peak, nb=n_nb,
                digest=encoding_digest(enc))


def drive_plugins(kp, cuda, diff, smi):
    """Phase 4n: the demo plugins at full width. (a) the fit cell annotated
    under `fit_config()` plus both plugins, TPU32 (its whole pass held
    against the plain version in the second worker, 4h) and PACKED (held
    byte-equal to TPU32's run); (b) `preemption_cluster(1024,
    PLUGINS_PENDING, seed=7)` annotated under the default profile plus both
    plugins: the pass, a PLUGINS_SEGMENT-step segment with nominations held
    against the plain version on the card from the kernel pass's state, and
    the single-pod step path over it (attempt, preempt, evict, bind: the
    counts set to 0 before and read after). Returns what 4h and 5k need."""
    nodes, pods, cfg, sample = plugins_fit_workload(kp)
    fit = plugins_pass(kp, cuda, "(a) fit cell TPU32", nodes, pods, cfg, sample, kp.TPU32, smi)
    fit["mid"] = mid_state(cuda, fit["eng"])
    packed = plugins_pass(kp, cuda, "(a) fit cell PACKED", nodes, pods, cfg, sample, kp.PACKED,
                          smi)
    check_same_run("4n(a) PACKED", packed["trace"], packed["state"], fit["trace"], fit["state"],
                   cuda.TRACE_SLOTS_PLAIN)
    if (packed["placements"], packed["annotations"]) != (fit["placements"], fit["annotations"]):
        raise AssertionError("4n(a) PACKED: placements or sampled records differ from TPU32's")
    if packed["counts"]["pack_widen"] != 1:
        raise AssertionError(f"4n(a) PACKED: launches {packed['counts']}")
    log("    (a) PACKED: trace, state, placements and sampled records equal TPU32's")

    from kube_scheduler_simulator_tpu_torch.synth import annotate_bandwidth

    nodes, pods, objects = kp.preemption_cluster(PLUGINS_NODES, PLUGINS_PENDING, seed=7)
    annotate_bandwidth(nodes, pods, seed=7)
    rng = np.random.default_rng(7)
    sample = {("default", f"pod-{i}") for i in rng.choice(PLUGINS_PENDING, 100, replace=False)}
    dflt = plugins_pass(kp, cuda, f"(b) default profile, {PLUGINS_NODES} nodes", nodes, pods,
                        kp.demo_config(), sample, kp.TPU32, smi, objects)
    enc, eng, t = dflt["enc"], dflt["eng"], dflt["t"]
    prog, a, w = eng.program, enc.arrays, eng.weights
    Q = len(enc.queue)
    host = {k: t[k].cpu().numpy() for k in ("did", "nominated", "voff", "vidx")}
    did, nominated = host["did"][:Q], host["nominated"][:Q]
    s0, n_nom, n_did = segment_of(did, nominated, PLUGINS_SEGMENT, PLUGINS_NOMINATIONS)
    queue = padded_queue(eng)
    seg = queue[s0:s0 + PLUGINS_SEGMENT].contiguous()
    st0, _ = cuda.seq_run(prog, a, enc.state0, queue[:s0].contiguous(), w, record=False)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    s_k, t_k = cuda.seq_run(prog, a, st0, seg, w, record=True, step0=s0)
    e1.record()
    torch.cuda.synchronize()
    seg_ms = e0.elapsed_time(e1)
    t0 = time.perf_counter()
    s_p, t_p = cuda.seq_run_plain(prog, a, st0, seg, w, record=True, step0=s0)
    torch.cuda.synchronize()
    seg_plain_ms = (time.perf_counter() - t0) * 1e3
    for name, g, h in zip(cuda.TRACE_SLOTS_PREEMPT, t_k, t_p):
        diff.check("plugins default", "seq_run", f"segment {name}", g, h)
    for f in STATE_FIELDS:
        diff.check("plugins default", "seq_run", f"segment state {f}", getattr(s_k, f),
                   getattr(s_p, f))
    for name in ("codes", "raw", "final", "sel", "did", "pcode", "nominated", "final_sel"):
        diff.check("plugins default", "seq_run", f"segment against the pass {name}",
                   t_k[cuda.TRACE_SLOTS_PREEMPT.index(name)], t[name][s0:s0 + PLUGINS_SEGMENT])
    steps = range(s0, min(s0 + PLUGINS_SEGMENT, Q))
    st = st0.clone()
    cuda.reset_counts()
    t0 = time.perf_counter()
    bad = default_steps(eng, t, host, st, steps)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_counts, step_plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    if bool(bad):
        raise AssertionError("4n(b): single-pod steps differ from the pass's trace rows")
    for f in STATE_FIELDS:
        diff.check("plugins default", "seq_evict", f"step path state {f}", getattr(st, f),
                   getattr(s_k, f))
    fired = int(did[s0:s0 + PLUGINS_SEGMENT].sum())
    want = {"seq_attempt": len(steps) + fired, "seq_bind": len(steps),
            "seq_preempt": 2 * fired, "seq_evict": int((nominated[steps.start:steps.stop]
                                                        >= 0).sum())}
    if any(step_counts[k] != n for k, n in want.items()) or any(step_plain.values()):
        raise AssertionError(f"4n(b) step path launches {step_counts}, plain {step_plain}")
    log(f"    (b) steps {s0}..{s0 + PLUGINS_SEGMENT - 1} ({n_did} dry runs, {n_nom} nominations) "
        f"again from the kernel pass's state: {seg_ms:.1f} ms, the plain version on the card "
        f"{seg_plain_ms:.1f} ms; trace, victims and state equal, and equal to the pass's rows; "
        f"the single-pod step path over them {step_s:.3f} s, every row and the state equal; "
        f"launches { {k: v for k, v in step_counts.items() if v} } [{smi}]")
    # 5k's dry run: the first nominating step past the middle of the queue
    qf = next(qi for qi in range(Q // 2, Q) if did[qi] and nominated[qi] >= 0)
    st_f, _ = cuda.seq_run(prog, a, enc.state0, queue[:qf].contiguous(), w, record=False)
    dflt.update(seg=(s0, seg, seg_ms, seg_plain_ms, s_k, t_k), step_counts=step_counts,
                dry=(st_f, int(enc.queue[qf]), qf))
    return dict(fit=fit, packed=packed, default=dflt)


def plain_plugins_fit(kp):
    """The second worker's share of phase 4n: 4n(a)'s TPU32 pass through the
    plain versions on the host CPU (trace, state, placements, sampled
    records)."""
    cpu = torch.device("cpu")
    nodes, pods, cfg, sample = plugins_fit_workload(kp)
    enc = kp.encode_cluster(nodes, pods, cfg, policy=kp.TPU32, device=cpu)
    eng = kp.BatchedScheduler(enc, device=cpu)
    t0 = time.perf_counter()
    st, tr = eng.run()
    secs = time.perf_counter() - t0
    ann = {(r.pod_namespace, r.pod_name): r.to_annotations() for r in eng.results(pods=sample)}
    return dict(digest=encoding_digest(enc), state=_state_dict(st), trace=tr,
                placements=eng.placements(), annotations=ann, seconds=secs)


def plugin_rows(kp, cuda, diff, run, smi):
    """Phase 5k: each demo plugin body alone inside `seq_attempt` at 4n(a)'s
    mid-queue state (`body_times`), beside NetworkBandwidth's allocated sum
    as one `index_add_` call; `seq_preempt` with NetworkBandwidth's row at
    4n(b)'s first nominating step past the middle, held against its plain
    version there first; and 4n's passes (`seq_run`: (a)'s whole pass
    against its plain version on the host CPU, (b)'s segment against its
    plain version on the card). Entries of the kernels line."""
    fit, dflt = run["fit"], run["default"]
    enc, fa = fit["enc"], fit["eng"]
    st, q = fit["mid"]
    got = cuda.seq_attempt(fa.program, enc.arrays, st, fa.weights, q)
    want = cuda.seq_attempt_plain(fa.program, enc.arrays, st, fa.weights, q)
    for name, g, h in zip(ATTEMPT_OUT, got, want):
        diff.check("plugins fit", "seq_attempt", f"mid-queue pod {q} {name}", g, h)
    bw = fa.program.planes["nb_bw"]
    bound_ = (st.assignment >= 0) & enc.arrays.pod_mask
    tgt = torch.clamp(st.assignment, min=0).long()
    vals = bw * bound_.to(bw.dtype)
    lib_ms = graph_ms(lambda: torch.zeros(enc.N, dtype=bw.dtype, device=bw.device)
                      .index_add_(0, tgt, vals))
    log(f"    NetworkBandwidth's allocated sum as one torch.zeros({enc.N}).index_add_ call over "
        f"{enc.P} pods: {lib_ms:.6f} ms [{smi}]")
    rows = []
    att = dflt["step_counts"]["seq_attempt"]
    for point, label, ms, plain_ms, b, p in body_times(kp, cuda, fit, PLUGIN_BODIES, smi):
        key = f"{point} {label}"
        rows.append({"name": "seq_attempt", "path": f"plugins: {key}", "route": "cuda",
                     "source": SOURCE, "replaces": REPLACES[key], "launches": att,
                     "max_abs_err": diff.err["plugins fit", "seq_attempt"], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                     "library_ms": lib_ms if label == "NetworkBandwidth" else None,
                     "body": f"{label} {point} alone, pod {p}"})
    enc_b, eng_b = dflt["enc"], dflt["eng"]
    a, prog = enc_b.arrays, eng_b.program
    st_f, p, qf = dflt["dry"]
    got = cuda.seq_preempt(prog, a, st_f, p)
    want = cuda.seq_preempt_plain(prog, a, st_f, p)
    for name, g, h in zip(("pcode", "voff", "vidx", "nominated"), got, want):
        diff.check("plugins default", "seq_preempt", f"step {qf} {name}", g, h)
    ms = graph_ms(lambda: cuda.preempt_launch(prog, a, st_f, p))
    plain_ms = events_ms(lambda: cuda.seq_preempt_plain(prog, a, st_f, p), 3, 3)
    b = preempt_bound(enc_b, prog, st_f, p, int(got[2].shape[0]))
    log(f"    seq_preempt with NetworkBandwidth's row at 4n(b)'s step {qf} (pod {p}, nominated "
        f"{int(got[3])}, {int(got[2].shape[0])} victims named): {ms:.6f} ms (plain {plain_ms:.3f} "
        f"ms, bound {b[0]:.7f} ms by {b[1]}) [{smi}]")
    rows.append({"name": "seq_preempt", "path": "plugins default", "route": "cuda",
                 "source": SOURCE, "replaces": REPLACES["seq_preempt"],
                 "launches": dflt["step_counts"]["seq_preempt"],
                 "max_abs_err": diff.err["plugins default", "seq_preempt"], "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
                 "row": REPLACES["row NetworkBandwidth"]})
    # 4n's passes: (a)'s whole pass, (b)'s segment
    queue = padded_queue(fa)
    run_ms = events_ms(lambda: cuda.seq_run(fa.program, enc.arrays, enc.state0, queue,
                                            fa.weights, record=True), 1, 3)
    step_ops = (ops_per_node(enc, fa.program) * enc.N
                + plugin_cost(enc, fa.program)[1]) * len(queue)
    state_bytes = nbytes(*(getattr(enc.state0, f) for f in STATE_FIELDS))
    b_a = bound(cluster_bytes(enc) + 2 * state_bytes + nbytes(queue, fa.weights)
                + nbytes(*fit["trace"]) + nbytes(*fa.program.planes.values()), step_ops)
    s0, seg, seg_ms, seg_plain_ms, _, t_k = dflt["seg"]
    step_ops_b = (ops_per_node(enc_b, prog) * enc_b.N + plugin_cost(enc_b, prog)[1]
                  + rel_reads(enc_b, prog, st_f, p)[1]) * len(seg)
    b_b = bound(cluster_bytes(enc_b) + 2 * nbytes(*(getattr(enc_b.state0, f)
                                                     for f in STATE_FIELDS))
                + nbytes(seg, eng_b.weights, *t_k, *prog.planes.values()), step_ops_b)
    for path, launches, ms_, plain, b_, basis, extra in (
            ("plugins fit", fit["counts"]["seq_run"], run_ms, fit["plain_run_s"] * 1e3, b_a,
             "host CPU (the second process)", {}),
            ("plugins default", dflt["counts"]["seq_run"], seg_ms, seg_plain_ms, b_b,
             "on the card, in the main process", {"steps": [s0, s0 + len(seg)]})):
        rows.append({"name": "seq_run", "path": path, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES["seq_run"], "launches": launches,
                     "max_abs_err": diff.err[path, "seq_run"], "ms": ms_, "plain_ms": plain,
                     "bound_ms": b_[0], "bound_by": b_[1], "library_ms": None,
                     "plain_basis": basis, **extra})
        log(f"    seq_run {path}: {ms_:.3f} ms (plain {plain:.3f} ms, {basis}; bound "
            f"{b_[0]:.7f} ms by {b_[1]}) [{smi}]")
    return rows


def _state_dict(st):
    return {f: getattr(st, f).cpu() for f in STATE_FIELDS}


def plain_worker(out_dir, part):
    """Run the plain versions the card's phases are held against, on the
    host CPU, and save each result to `out_dir` as it is ready. Part "a":
    phase 3's sweeps, phase 4's and 4b's passes, config #4's variant 0 and
    first sampled variant; part "b" (a process of its own beside it): phase
    3's whole gang pass and gang sweep; part "c": phase 3's whole sequential
    passes. Parts "b" and "c" end with their shares of phase 4k's
    default-profile fault sweep, and every part with its share of 4l(e)'s
    counted one."""
    torch.set_num_threads(PLAIN_THREADS)
    import kube_scheduler_simulator_tpu_torch as kp
    from kube_scheduler_simulator_tpu_torch.engine import cuda

    cpu = torch.device("cpu")
    out_dir = Path(out_dir)

    def save(name, obj):
        tmp = out_dir / f"{name}.tmp"
        torch.save(obj, tmp)
        os.replace(tmp, out_dir / f"{name}.pt")
        log(f"plain worker {part}: {name} saved at {time.perf_counter() - t_start:.1f} s")

    t_start = time.perf_counter()
    if part == "c":
        save("passes3", plain_passes(kp, cuda))
        save("seg4c", plain_segment(kp, cuda, out_dir))
        inp = wait_input(out_dir, "serving4j_in")
        save("batch_serving", tenant_sequence(inp["snap"], inp["arrivals"]))
        save("fault3_c", plain_fault3(kp, out_dir, "fault3_c"))
        save("fault4l_c", plain_fault3(kp, out_dir, "fault4l_c"))
        return
    if part == "b":
        enc = gang_sweep3_encoding(kp, cpu)
        g = kp.GangScheduler(enc, device=cpu)
        t0 = time.perf_counter()
        records = record_rows(g.results())
        save("gang3", dict(digest=encoding_digest(enc), state=_state_dict(g._final_state),
                           rounds=g._rounds, stats=dict(g.last_stats), records=records,
                           seconds=time.perf_counter() - t0))
        w = sweep_weights(kp, enc, PHASE3_VARIANTS, seed=3)
        sweep = kp.GangSweep(enc, device=cpu)
        t0 = time.perf_counter()
        asg, rounds = sweep.run(w)
        save("gangsweep3", dict(digest=encoding_digest(enc), w=w, asg=asg, rounds=rounds,
                                stats=dict(sweep.last_stats), states=_state_dict(sweep._states),
                                seconds=time.perf_counter() - t0))
        snap, arrivals = preempt_base(kp)
        save("batch_preempt", tenant_sequence(tenant_copy(snap, 0),
                                              tenant_copy({"pods": arrivals}, 0)["pods"]))
        save("fault3_b", plain_fault3(kp, out_dir, "fault3_b"))
        save("fault4l_b", plain_fault3(kp, out_dir, "fault4l_b"))
        save("fit4n", plain_plugins_fit(kp))
        return
    sweeps = {}
    for pol in (kp.TPU32, kp.EXACT):
        enc = phase3_sweep_encoding(kp, pol, cpu)
        w = sweep_weights(kp, enc, PHASE3_VARIANTS, seed=3)
        prog = kp.BatchedScheduler(enc, device=cpu).program
        t0 = time.perf_counter()
        st, tr = cuda.sweep_run_plain(prog, enc.arrays, *sweep_inputs(enc, w), record=True)
        sweeps[pol.name] = dict(digest=encoding_digest(enc), states=_state_dict(st), trace=tr,
                                seconds=time.perf_counter() - t0)
    save("sweep3", sweeps)
    for path in ("fit", "affinity"):
        nodes, pods, cfg, sample = path_workload(kp, path)
        enc = kp.encode_cluster(nodes, pods, cfg, policy=kp.TPU32, device=cpu)
        eng = kp.BatchedScheduler(enc, device=cpu)
        t0 = time.perf_counter()
        st, tr = eng.run()
        secs = time.perf_counter() - t0
        ann = {(r.pod_namespace, r.pod_name): r.to_annotations()
               for r in eng.results(pods=sample)}
        save(path, dict(digest=encoding_digest(enc), state=_state_dict(st), trace=tr,
                        placements=eng.placements(), annotations=ann, seconds=secs))
    nodes, pods = kp.synthetic_cluster(SWEEP_NODES, SWEEP_PODS, seed=SWEEP_SEED)
    enc = kp.encode_cluster(nodes, pods, kp.supported_config(), policy=kp.TPU32, device=cpu)
    eng = kp.BatchedScheduler(enc, record=False, device=cpu)
    q = torch.as_tensor(np.asarray(enc.queue, np.int32))
    t0 = time.perf_counter()
    st, sels = cuda.seq_run_plain(eng.program, enc.arrays, enc.state0, q, eng.weights,
                                  record=False)
    digest = encoding_digest(enc)
    save("config4", dict(digest=digest, state=_state_dict(st), sels=sels,
                         seconds=time.perf_counter() - t0))
    v = sampled_variants(SWEEP_VARIANTS)[0]
    wv = sweep_weights(kp, enc, SWEEP_VARIANTS, seed=SWEEP_SEED)[v]
    t0 = time.perf_counter()
    st, sels = cuda.seq_run_plain(eng.program, enc.arrays, enc.state0, q,
                                  torch.as_tensor(wv).to(enc.policy.score), record=False)
    save("config4_sampled", dict(digest=digest, v=v, weights=wv, state=_state_dict(st),
                                 sels=sels, seconds=time.perf_counter() - t0))
    save("fault4l_a", plain_fault3(kp, out_dir, "fault4l_a"))


def save_input(name, obj):
    """An input of the plain workers, from the card's phases."""
    PLAIN_DIR.mkdir(parents=True, exist_ok=True)
    tmp = PLAIN_DIR / f"{name}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, PLAIN_DIR / f"{name}.pt")


def wait_input(out_dir, name):
    """In a plain worker: an input the main process saves when its phase
    reaches it (the worker dies with the main process)."""
    path = Path(out_dir) / f"{name}.pt"
    while not path.exists():
        time.sleep(0.5)
    return torch.load(path, map_location="cpu", weights_only=False)


def plain_segment(kp, cuda, out_dir):
    """Phase 4c's segment with the plain version, on the card (its own
    encode of the cluster, the kernel pass's state the main process saves)."""
    from kube_scheduler_simulator_tpu_torch.engine.encode import SchedState

    nodes, pods, objects = kp.preemption_cluster(1024, 10000, seed=7)
    enc = kp.encode_cluster(nodes, pods, kp.supported_config(), policy=kp.TPU32, **objects)
    eng = kp.BatchedScheduler(enc)
    inp = wait_input(out_dir, "seg4c_in")
    dev = enc.device
    st0 = SchedState(**{f: t.to(dev) for f, t in inp["state"].items()})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, tr = cuda.seq_run_plain(eng.program, enc.arrays, st0, inp["seg"].to(dev), eng.weights,
                                record=True, step0=inp["s0"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return dict(digest=encoding_digest(enc), state=_state_dict(st), trace=[x.cpu() for x in tr],
                seconds=secs)


def _die_with_parent():
    """In the child before it runs: the kernel kills it when this process
    ends, however it ends (Linux's PR_SET_PDEATHSIG)."""
    import ctypes
    import signal

    ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)


PLAIN_PARTS = {"a": ("sweep3", "fit", "affinity", "config4", "config4_sampled", "fault4l_a"),
               "b": ("gang3", "gangsweep3", "batch_preempt", "fault3_b", "fault4l_b", "fit4n"),
               "c": ("passes3", "seg4c", "batch_serving", "fault3_c", "fault4l_c")}


class PlainWorker:
    """The plain versions' processes (`chip_smoke.py --plain-worker DIR
    PART`, one a part of `PLAIN_PARTS`), started at once; `result(name)`
    waits for one of their results."""

    def __init__(self):
        PLAIN_DIR.mkdir(parents=True, exist_ok=True)
        for f in PLAIN_DIR.glob("*"):
            f.unlink()  # earlier runs' results and inputs
        self.logs, self.procs = {}, {}
        for part in PLAIN_PARTS:
            path = PLAIN_DIR / f"worker_{part}.log"
            self.logs[part] = (path, open(path, "w"))
            self.procs[part] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--plain-worker",
                 str(PLAIN_DIR), part],
                stdout=self.logs[part][1], stderr=subprocess.STDOUT,
                cwd=Path(__file__).resolve().parent, preexec_fn=_die_with_parent)

    def result(self, name, deadline):
        part = next(p for p, names in PLAIN_PARTS.items() if name in names)
        proc, log_path = self.procs[part], self.logs[part][0]
        path = PLAIN_DIR / f"{name}.pt"
        while not path.exists():
            if proc.poll() is not None and not path.exists():
                raise RuntimeError(f"plain worker {part} exited ({proc.returncode}) without "
                                   f"{name}:\n{log_path.read_text()[-4000:]}")
            if time.perf_counter() > deadline:
                raise RuntimeError(f"plain worker {part} did not produce {name} in time")
            time.sleep(0.5)
        return torch.load(path, map_location="cpu", weights_only=False)

    def log_lines(self):
        return [ln for path, _ in self.logs.values() for ln in path.read_text().splitlines()]

    def stop(self):
        for part, proc in self.procs.items():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            self.logs[part][1].close()


class Phases:
    """Each phase's seconds, printed as it ends."""

    def __init__(self):
        self.t_start = self.t_last = time.perf_counter()
        self.seconds = {}

    def done(self, name):
        now = time.perf_counter()
        self.seconds[name] = now - self.t_last
        log(f"    phase {name} done at {now - self.t_start:.1f} s ({now - self.t_last:.1f} s)")
        self.t_last = now


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--plain-worker":
        plain_worker(sys.argv[2], sys.argv[3])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    import kube_scheduler_simulator_tpu_torch as kp

    workers = []  # the plain versions of whole passes, beside the card's phases
    try:
        return run_phases(kp, workers)
    finally:
        for w in workers:
            w.stop()


def run_phases(kp, workers) -> int:
    from kube_scheduler_simulator_tpu_torch.engine import cuda, scatter

    ph = Phases()
    t_start = ph.t_start
    deadline = t_start + TIME_LIMIT_S - 60

    # -- 1. device --------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[1] device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"| CUDA {torch.version.cuda} | cards: {torch.cuda.device_count()} | SMs: "
        f"{torch.cuda.get_device_properties(0).multi_processor_count}")

    # -- 2. build ---------------------------------------------------------
    # one library: seq_kernels.cu four times (SEQ_ONLY=32, 64 by SEQ_TENANT=0,
    # 1), delta_kernels.cu, fault_kernels.cu, pack_kernels.cu and
    # fleet_kernels.cu, eight nvcc processes at once, then one link
    t0 = time.perf_counter()
    path, build_s = cuda.build()
    cuda.library()
    log(f"[2] built {path.name} in {build_s:.1f} s, {time.perf_counter() - t0:.1f} s in all")
    for ln in ptxas_report(path.with_suffix(".log").read_text()):
        log(f"    ptxas: {ln}")
    ph.done("2")
    # the plain processes start once the build no longer needs the host's cores
    worker = PlainWorker()
    workers.append(worker)

    # -- 3. kernels vs plain ----------------------------------------------
    log("[3] kernels against their plain versions on the card (exact equality)")
    diff = Diff()
    passes3 = {}
    for path, (nodes, pods, cfgs, bind, objects) in phase3_workloads(kp).items():
        passes3.update(compare_kernels(kp, cuda, diff, path, nodes, pods, cfgs, bind, objects))
    sweep3 = compare_sweep(kp, cuda, diff)
    compare_k10(kp, scatter, diff)
    gang3 = compare_gang(kp, cuda, diff, smi)
    gsweep3 = compare_gang_sweep3(kp, cuda, diff)
    # phase 4k(b)'s inputs, for the workers' plain sweep
    fault3_in = fault3_input(kp, passes3)
    save_input("fault3_in", fault3_in)
    ph.done("3")

    # -- 4. the fit path at full width --------------------------------------
    nodes, pods, cfg, sample = path_workload(kp, "fit")
    log(f"[4] fit path at full width: 1024 nodes x {len(pods)} pods, fit_config(), TPU32, "
        "trace recorded")
    fit = drive_path(kp, cuda, diff, "fit", nodes, pods, cfg, sample, smi)
    clusters = {"fit": (nodes, pods, cfg, sample, {})}  # phase 4m's cells
    ph.done("4")

    # -- 4b. the affinity path at full width (BASELINE config #3) -----------
    nodes, pods, cfg, sample = path_workload(kp, "affinity")
    log(f"[4b] affinity path at full width: 500 nodes x {len(pods)} pods "
        "(synthetic_affinity_cluster, seed 11), affinity_config(), TPU32, trace recorded")
    aff = drive_path(kp, cuda, diff, "affinity", nodes, pods, cfg, sample, smi)
    clusters["affinity"] = (nodes, pods, cfg, sample, {})
    ph.done("4b")

    # -- 4c. the default path at full width (BASELINE config #2's width) ----
    n_nodes, n_pending = 1024, 10000
    nodes, pods, objects = kp.preemption_cluster(n_nodes, n_pending, seed=7)
    rng = np.random.default_rng(7)
    sample = {("default", f"pod-{i}") for i in rng.choice(n_pending, 100, replace=False)}
    n_bound = sum(1 for pd in pods if pd["spec"].get("nodeName", "").startswith("node-"))
    log(f"[4c] default path at full width: {n_nodes} nodes x {n_pending} pending pods on "
        f"{n_bound} pre-bound (preemption_cluster, seed 7), supported_config(), TPU32, trace "
        "recorded")
    dflt = drive_default(kp, cuda, diff, nodes, pods, objects, sample, smi)
    default_cluster = (nodes, pods, objects, sample)
    clusters["default"] = (nodes, pods, kp.supported_config(), sample, objects)
    ph.done("4c")

    # -- 4d. the serving path at BASELINE config #2's width -----------------
    log(f"[4d] serving session at full width: SimulatorService on the card, 1,024 nodes, "
        f"SchedulerConfiguration.default(), TPU32, {SERVING_PASSES} passes of "
        f"{SERVING_ARRIVALS} arrivals and a cordon")
    serving = drive_serving(kp, cuda, scatter, diff, smi)
    ph.done("4d")

    # -- 4e. the gang default path at full width, then the affinity gang ----
    log("[4e] gang default path at full width: GangScheduler(chunk=64) on the 4c cluster, "
        "supported_config(), TPU32 (match width 128)")
    gang = drive_gang_default(kp, cuda, diff, *default_cluster, smi)
    nodes, pods = kp.synthetic_affinity_cluster(500, 5000, seed=11)
    gang_aff = drive_gang_affinity(kp, cuda, nodes, pods, aff["eng"].placements(), smi)
    ph.done("4e")

    # -- 4f. gang passes through the serving path ----------------------------
    log(f"[4f] gang serving session: SimulatorService on the card, {SERVING_NODES} nodes, "
        f"3 schedule_gang(record=True) passes of {SERVING_ARRIVALS} arrivals (the second "
        "with window=64)")
    drive_serving_gang(kp, cuda, diff, smi)
    ph.done("4f")

    # -- 4g. BASELINE config #4: the Monte-Carlo weight sweep ----------------
    log(f"[4g] weight sweep at full width (BASELINE config #4): {SWEEP_VARIANTS} variants of "
        f"synthetic_cluster({SWEEP_NODES}, {SWEEP_PODS}, seed={SWEEP_SEED}), "
        "supported_config(), TPU32, no trace, through WeightSweep.run")
    sweep = drive_sweep(kp, cuda, diff, dflt, smi)
    ph.done("4g")

    # -- 4i. the gang weight sweep ---------------------------------------------
    log(f"[4i] gang weight sweep at full width: GangSweep.run of {GANGSWEEP_VARIANTS} variants "
        f"of config #4's cluster, then {GANGSWEEP_PREEMPT_VARIANTS} variants of the 4c cluster "
        "(chunk 64), supported_config(), TPU32")
    gsweep = drive_gang_sweep(kp, cuda, diff, sweep, gang, smi)
    ph.done("4i")

    # -- 4j. the batch plane: tenants' passes in one launch -------------------
    log(f"[4j] the batch plane through SessionManager on the card, TPU32: {BATCH_TENANTS} "
        f"tenants of the serving cluster, {BATCH_PREEMPT_TENANTS} of the preemption cluster "
        f"({BATCH_PREEMPT_PENDING} pending each), a sequential and a gang window each")
    batch = drive_batch(kp, cuda, diff, serving["batch_in"], smi)
    ph.done("4j")

    # -- 4k. the fault sweep: node-failure scenarios in one pass -----------------
    log(f"[4k] fault sweep: FaultSweep of {FAULT_SCENARIOS} scenarios of phase 4's cluster "
        f"(fit_config(), fail_prob {FAULT_PROB}), then {FAULT3_SCENARIOS} of phase 3's default "
        f"cluster (supported_config(), fail_prob {FAULT3_PROB}), TPU32")
    fault = drive_fault_sweep(kp, cuda, diff, fit, fault3_in, smi)
    ph.done("4k")

    # -- 4l. the counted gang forms (loop="static") -----------------------------
    log("[4l] the counted gang forms (loop=\"static\"), TPU32: GangScheduler on the fit and "
        f"affinity clusters and at a budget of {COUNTED_BUDGET}, GangSweep of "
        f"{COUNTED_SWEEP_VARIANTS} config #4 variants, FaultSweep of 4k(a)'s masks and 4k(b)'s "
        f"scenarios at fail_prob {FAULT3_CARD_PROB}")
    counted = drive_counted(kp, cuda, diff, fit, gang_aff, gsweep, fault, smi)
    ph.done("4l")

    # -- 4m. the PACKED dtype policy at full width ------------------------------
    log("[4m] PACKED (KSS_DTYPE_POLICY=packed) at full width: (a) the fit, affinity and "
        "default cells (phases 4, 4b, 4c) through encode_cluster(policy=PACKED), the pass and "
        "the decode, each against its TPU32 run; (b) the fit cell's gang; (c) 4d's first "
        f"{PACKED_SERVING_PASSES} serving passes, the last after a flip to TPU32")
    packed = drive_packed(kp, cuda, scatter, clusters, {"fit": fit, "affinity": aff,
                                                        "default": dflt}, counted["dyn_fit"],
                          serving, smi)
    ph.done("4m")

    # -- 4n. the demo out-of-tree plugins at full width -------------------------
    log("[4n] the demo plugins (NetworkBandwidth, NodeNumber) at full width, annotated "
        "(synth.annotate_bandwidth, seed 7): (a) the fit cell under fit_config() plus both "
        f"plugins, TPU32 and PACKED; (b) preemption_cluster({PLUGINS_NODES}, "
        f"{PLUGINS_PENDING}, seed=7) under the default profile plus both (16 filters, 9 "
        "scores), TPU32")
    plugins = drive_plugins(kp, cuda, diff, smi)
    ph.done("4n")

    # -- 4o. the fleet & memory observatory ----------------------------------------
    log(f"[4o] the fleet observatory (KSS_FLEET_STATS) on the card at 4d's cluster, TPU32: 4d's "
        f"first 3 schedule() passes and a schedule_gang(record=False) pass with stats on, then "
        f"a batch window of {FLEET_TENANTS} tenants with stats on and KSS_TRACE armed")
    fleet = drive_fleet(kp, cuda, diff, serving, smi)
    ph.done("4o")

    # -- 4h. the kernels' whole passes against the second process's plain ones
    log("[4h] the whole passes against the plain versions run on the host CPU in the second "
        "process (exact equality)")
    check_plain_sweep(cuda, diff, sweep3, worker.result("sweep3", deadline))
    check_plain_passes(cuda, diff, passes3, worker.result("passes3", deadline))
    check_plain_gang(cuda, diff, gang3, worker.result("gang3", deadline))
    check_plain_gang_sweep(cuda, diff, gsweep3, worker.result("gangsweep3", deadline))
    check_plain_path(cuda, diff, "fit", fit, worker.result("fit", deadline))
    check_plain_path(cuda, diff, "affinity", aff, worker.result("affinity", deadline))
    check_plain_segment(cuda, diff, dflt, worker.result("seg4c", deadline))
    check_plain_batch(diff, "serving", batch["serving"],
                      worker.result("batch_serving", deadline))
    check_plain_batch(diff, "preempt", batch["preempt"],
                      worker.result("batch_preempt", deadline))
    check_plain_fault3(diff, fault["fault3"],
                       [worker.result(name, deadline) for name in FAULT3_PARTS])
    check_plain_fault3(diff, counted["fault4l"],
                       [worker.result(name, deadline) for name in FAULT4L_PARTS], "4l(e)",
                       "counted fault")
    check_plain_path(cuda, diff, "plugins fit", plugins["fit"], worker.result("fit4n", deadline))
    config4_plain = worker.result("config4", deadline)
    config4_sampled = worker.result("config4_sampled", deadline)
    ph.done("4h")

    # -- 5. kernel times --------------------------------------------------
    kernels = (kernel_rows(cuda, diff, "fit", fit) + kernel_rows(cuda, diff, "affinity", aff)
               + kernel_rows(cuda, diff, "default", dflt))
    log(f"[5] kernel times at full width, TPU32 [{smi}]")
    for kr in kernels:
        log(f"    {kr['path']:8s} {kr['name']:11s} {kr['ms']:.6f} ms (plain "
            f"{kr['plain_ms']:.3f} ms, bound {kr['bound_ms']:.7f} ms by {kr['bound_by']}), "
            f"{kr['launches']} launches" + (f", steps {kr['steps']}" if "steps" in kr else ""))
    log(f"[5b] plugin bodies alone inside seq_attempt at the mid-queue state, TPU32 [{smi}]")
    log("    fit path's cluster (the first slice's bodies):")
    body_times(kp, cuda, fit, FIT_BODIES, smi)
    log("    affinity path's cluster (the second slice's bodies):")
    body_times(kp, cuda, aff, AFFINITY_BODIES, smi)
    log("    default path's cluster (the volume family):")
    body_times(kp, cuda, dflt, VOLUME_BODIES, smi)
    log(f"[5c] K10 at the real dirty lists of a serving delta pass, TPU32 [{smi}]")
    kernels += k10_rows(kp, scatter, diff, serving, smi)
    log(f"[5d] K9 at round 1 of the full-width default gang, TPU32 [{smi}]")
    kernels += gang_rows(kp, cuda, diff, gang, smi)
    log(f"[5e] K11 at BASELINE config #4's shape, TPU32 [{smi}]")
    kernels += sweep_row(cuda, diff, sweep, config4_plain, config4_sampled, smi)
    log(f"[5f] K9 and the phase's sweep_run of the gang weight sweep (phase 4i), TPU32 [{smi}]")
    kernels += gangsweep_rows(kp, cuda, diff, gsweep, smi)
    log(f"[5g] the batch plane's tenant forms at their launches in phase 4j, TPU32 [{smi}]")
    kernels += batch_rows(cuda, diff, batch, smi)
    log(f"[5h] the fault sweep's kernels at phase 4k(a)'s shapes, TPU32 [{smi}]")
    kernels += fault_rows(kp, cuda, diff, fault, smi)
    log(f"[5i] the counted forms' kernels at phase 4l(a)'s and 4l(d)'s round 1, TPU32 [{smi}]")
    kernels += counted_rows(cuda, diff, counted, smi)
    log(f"[5j] K8 at phase 4m(a)'s three PACKED encodings, K10's 2-byte set at 4m(c)'s delta "
        f"passes [{smi}]")
    kernels += pack_rows(kp, cuda, scatter, diff, packed, smi)
    log(f"[5k] the demo plugins' bodies at 4n(a)'s mid-queue state, seq_preempt with "
        f"NetworkBandwidth's row at 4n(b)'s, 4n's passes, TPU32 [{smi}]")
    kernels += plugin_rows(kp, cuda, diff, plugins, smi)
    log(f"[5l] K12 fleet_quality at 4o's serving state and at config #5's shape "
        f"({FLEET5_NODES} x {FLEET5_PODS}), TPU32 [{smi}]")
    kernels += fleet_rows(cuda, diff, fleet, smi)
    ph.done("5")
    log("    phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in ph.seconds.items())
        + f"; total {time.perf_counter() - t_start:.1f} s")
    log("    the plain workers' logs:")
    for ln in worker.log_lines():
        log(f"      {ln}")
    faulthandler.cancel_dump_traceback_later()

    # -- 6. result --------------------------------------------------------
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
