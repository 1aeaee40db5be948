"""Gang (fixpoint) scheduling: all pending pods per round, in parallel.

The reference package's `engine/gang.py` (SURVEY.md §7 M4). Per round it

  1. evaluates every pending pod against the round-start state with the
     sequential engine's attempt (`cuda.gang_eval`: a grid of blocks, one
     pod a block), giving a [pending, N] matrix of masked totals;
  2. cuts each row to its top `match_width` candidates when that is below
     N (`cuda.gang_topk`, ties to the lower node index);
  3. runs the one-commit-per-node matching (`cuda.gang_match`): each open
     pod takes its best untaken candidate, the earliest queue position wins
     each node and each ReadWriteOncePod claim, losers fall back to their
     next-best candidate, for up to `inner_iters` iterations; under
     `rel_serialize` only pods before the first placeable carrier of a
     required anti-affinity term commit, and a carrier with nothing
     placeable before it takes an exclusive round at its argmax;
  4. binds the whole matching (`cuda.gang_bind`), and repeats until a round
     commits nothing.

When the rounds settle with pods still pending and DefaultPreemption is
enabled, those pods go through a sequential preempt phase — `seq_run` (K3
with the preemption branch) over them in queue order, each bound at its
own queue position (`qpos`) — and rounds resume until a phase binds
nothing. The divergence policy is the reference's (its module docstring):
exact sequential parity where no pod loses a round.

The round loop (`loop="dynamic"`) is driven from the host with one
readback a round (the count `gang_match` committed and the pending count,
two integers a variant): the pending list, its count and the phase segment
are built on the card (a stable order of the queue's pending pods), and
every kernel reads the live row count there. A phase costs one more
readback (the pods it bound), and `seq_run`'s own checks three.

The round body runs on a stack of V variants' states with a [V, S] weight
matrix (`_gang_pass`): one launch of each kernel a round for all of them,
each variant to its own fixpoint. `GangScheduler` is its V = 1 case; the
gang weight sweep (parallel/sweep.py `GangSweep`) drives it with V > 1.
`batch_fixpoint` drives it over B tenants of the batch plane
(server/batchplane.py, `batch.gang.run`), each with its own encoding: the
K9 kernels' tenant forms and, for the preempt phases, `sweep_run`'s
(`batch_seg`); each tenant runs to its own fixpoint as its solo
`GangScheduler.run()` would (the reference's vmapped fused fixpoint, not
the gang sweep's lockstep). `_ScenarioRounds` drives the same tenant forms
over S node-failure scenarios of one cluster (lifecycle/faultsweep.py
`FaultSweep`, `faultsweep.vrun`/`one`): each scenario a tenant whose planes
differ from the cluster's only in the node mask.

The record path (`run_recorded`, `results`) tracks each pod's bind round,
records each preempt phase's trace as it runs, and replays the rounds:
each pod bound in a round is evaluated once more, with its full per-plugin
rows, against the start state of that round, and leftovers against the
final state. The result is the sequential trace in the port's layout
(engine/cuda.py TRACE_SLOTS_PREEMPT, victims as CSR records), decoded by
the sequential engine's `results()`.

The counted loops (`loop="static"`, `inner_loop="static"`: the programs the
reference keeps for a TPU backend that could not compile `while_loop`; the
same placements at equal `inner_iters`). A counted pass (`_counted_pass`)
runs exactly `static_rounds` round slots with no readback between them:
each slot's rows, window and live counts are built on the card, and after
its match and bind `cuda.gang_advance` updates each variant's round
accounting there, so the pass reads back once (rounds progressed and the
pending count). The host auto-resumes a pass that spent its whole budget
(`_resumed_pass`; GangSweep's per-variant form in parallel/sweep.py).
`inner_loop="static"` runs the matching's exactly `inner_iters` iterations
(`cuda.gang_match(counted=True)`, its own kernel).

Under PACKED a drive widens the encoding's planes once at its start
(`packing.widen`, one K8 launch: the reference widens before its
while_loop) and every round and phase reads the widened planes, which are
freed when the drive ends; so do a gang sweep's run, each batch window's
tenants and a fault sweep's scenario rounds.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from . import cuda
from . import kernels as K
from . import packing
from .cuda import NO_ORDER, TRACE_SLOTS_PREEMPT
from .encode import EncodedCluster
from .engine import BatchedScheduler


class _Rounds:
    """The round driver over a stack of V states, shared by `GangScheduler`
    (one cluster: its variants) and `_TenantRounds` (the batch plane's
    tenants, each with its own cluster). A subclass gives `enc` (for P),
    `_wp`, `max_rounds`, `compact`, `device`, `last_stats`, the queue rows
    `_queue` ([Q], or [V, Q] -1 padded), `_pending` and `_round`."""

    def _window_rows(self, rows, lo):
        """Each variant's eval window of its pending-first rows [V, Q]: WP
        rows from lo [V] on the device (-1 past the queue)."""
        WP, Q = self._wp, rows.shape[1]
        padded = torch.cat([rows, rows.new_full((rows.shape[0], 1), -1)], dim=1)
        at = (lo[:, None] + torch.arange(WP, dtype=torch.int32, device=self.device)).clamp(max=Q)
        return padded.gather(1, at.long())

    def _gang_pass(self, states, w, chronology=None, start=None, k0=None):
        """One gang pass of stacked `states` (in place): the counted pass
        under loop="static", else rounds to each variant's fixpoint. Returns
        (rounds, pods still pending), lists of V."""
        fn = self._counted_pass if self.loop == "static" else self._fixpoint_pass
        return fn(states, w, chronology, start, k0)

    def _fixpoint_pass(self, states, w, chronology=None, start=None, k0=None):
        """Rounds to fixpoint from stacked `states` [V, ...] (in place),
        variant v at weights row w[v], one launch of each kernel a round for
        every variant. Each variant runs until its own fixpoint and then
        rides along frozen (live 0, its counters unchanged), as under the
        reference's vmapped while_loop; `start` ([V] bools, None: all) names
        the variants that run at all, the others ride along from the first
        round. `k0`: the rows the first round takes (None: the whole queue),
        at least every variant's pending count. Returns (rounds, pods still
        pending), lists of V. `chronology` (the record path) takes V = 1."""
        V, P = w.shape[0], self.enc.P
        WP = self._wp
        cap = self.max_rounds if self.max_rounds is not None else P + 1
        tracked = chronology is not None
        if tracked:
            start_state = cuda.variant_state(states, 0).clone()
            br = torch.full((P,), -1, dtype=torch.int32, device=self.device)
        rounds, commits, w_idx = [0] * V, [0] * V, [0] * V  # commits: rounds that commit
        n_pend = [None] * V
        active = [cap > 0 and (start is None or bool(start[v])) for v in range(V)]
        sort = self.compact or WP is not None or V > 1
        # the rows a round takes: the queue, then the most pending
        K = self._queue.shape[-1] if k0 is None else k0
        while any(active):
            rows, count = self._pending(states, sort)
            gate = None if all(active) else torch.tensor(active, device=self.device)
            if WP is None:
                live = count if sort else None
                if sort:
                    rows = rows[:, :max(1, K)].contiguous()
            else:
                k = [min(x, -(-P // WP) - 1) for x in w_idx]
                lo = torch.tensor([min(kk * WP, P - WP) for kk in k], dtype=torch.int32,
                                  device=self.device)
                rows, live = self._window_rows(rows, lo), (count - lo).clamp(0, WP)
            if gate is not None:
                live = torch.where(gate, live, 0)
            sel, stat = self._round(states, w, rows, live)
            if tracked:
                hit = sel[0] >= 0
                br[rows[0][hit].long()] = rounds[0]
            got = torch.stack([stat[:, 0], count], dim=1).tolist()
            self.last_stats["host_syncs"] += 1
            for v in range(V):
                if not active[v]:
                    continue
                committed, cnt = got[v]
                rounds[v] += 1
                n_pend[v] = cnt - committed
                if WP is None:
                    commits[v] += 1
                    done = not committed
                else:
                    # a whole sweep of this round's pending windows without a
                    # commit is the fixpoint; a commit restarts at the front
                    done = not committed and k[v] + 1 >= max(1, -(-cnt // WP))
                    w_idx[v] = 0 if committed else w_idx[v] + 1
                    commits[v] += committed > 0
                active[v] = not done and commits[v] < cap
            K = max((n_pend[v] for v in range(V) if active[v]), default=0)
        if None in n_pend:  # a variant that ran no round (max_rounds=0, or not started)
            counts = self._pending(states, sort=False)[1].tolist()
            n_pend = [c if x is None else x for x, c in zip(n_pend, counts)]
            self.last_stats["host_syncs"] += 1
        if tracked:
            chronology.append(("rounds", start_state, br, rounds[0],
                               states.assignment[0].clone()))
        return rounds, n_pend

    def _counted_pass(self, states, w, chronology=None, start=None, k0=None):
        """The counted pass (loop="static"; gang.py `r_scan`/`rw_scan`):
        exactly `static_rounds` round slots of every variant, enqueued with
        no readback between them. Each slot takes the pending-first queue
        (the first slot's row count `k0`, or the queue: pending only
        shrinks within a pass), in its window from the device's `lo` under
        a binding eval_window, at the device's live count; after its match
        and bind, `cuda.gang_advance` updates each variant's rounds
        progressed, window index, done flag and the next slot's window and
        live count (ADVANCE_ROWS). A variant is gated off (live 0) after its
        first round that does not progress: such a round leaves the state
        unchanged, so every later slot of the reference's scan commits
        nothing. Reads back once: rounds progressed (the reference's
        `progressed.sum()`) and pending pods per variant. `start` and
        `chronology` as `_fixpoint_pass`'s; the record path numbers each
        pod's bind round by its slot (gaps where a window slot bound
        nothing, as the reference's tracked scan)."""
        V, P, WP, dev = w.shape[0], self.enc.P, self._wp, self.device
        tracked = chronology is not None
        if tracked:
            start_state = cuda.variant_state(states, 0).clone()
            br = torch.full((P + 1,), -1, dtype=torch.int32, device=dev)
        rows, count = self._pending(states, sort=True)
        K = max(1, rows.shape[1] if k0 is None else min(k0, rows.shape[1]))
        acc = torch.zeros((len(cuda.ADVANCE_ROWS), V), dtype=torch.int32, device=dev)
        _, _, done, pend, lo, live = acc.unbind(0)
        pend.copy_(count)
        if start is not None:
            done.copy_(~torch.as_tensor(start, dtype=torch.bool, device=dev))
        if self.static_rounds < 1:
            done.fill_(1)
        live.copy_(torch.where(done > 0, 0, count if WP is None else count.clamp(max=WP)))
        for slot in range(self.static_rounds):
            if slot:
                rows, _ = self._pending(states, sort=True)
            rows_s = rows[:, :K].contiguous() if WP is None else self._window_rows(rows, lo)
            sel, stat = self._round(states, w, rows_s, live)
            if tracked:
                br.index_fill_(0, torch.where(sel[0] >= 0, rows_s[0], P).long(), slot)
            cuda.gang_advance(stat, acc, WP or 0, P)
        rounds, n_pend = torch.stack([acc[0], pend]).tolist()
        self.last_stats["host_syncs"] += 1
        if tracked:
            br[P] = -1
            chronology.append(("rounds", start_state, br[:P], rounds[0],
                               states.assignment[0].clone()))
        return rounds, n_pend

    def _resumed_pass(self, states, w, chronology=None):
        """One variant's gang pass with the static auto-resume (gang.py
        `_drive.gang_pass`): under loop="static" another counted pass while
        the last used its whole budget, pods are pending and an explicit
        max_rounds (a total cap across passes) is not reached, until the
        pending count stops shrinking. Returns (rounds, pods pending)."""
        r, n = self._gang_pass(states, w, chronology)
        rounds = last = r[0]
        pend = n[0]
        while (self.loop == "static" and pend > 0 and last >= self.static_rounds
               and (self.max_rounds is None or rounds < self.max_rounds)):
            r, n = self._gang_pass(states, w, chronology)
            rounds, last = rounds + r[0], r[0]
            stalled, pend = n[0] >= pend, n[0]
            if stalled:
                break
        return rounds, pend


class GangScheduler(_Rounds):
    """Fixpoint batch scheduler over one `EncodedCluster`, on `device` (the
    CUDA card unless the caller names another). The options are the
    reference's: `chunk` (the evaluation chunk; it sets the window
    granularity), `max_rounds` (a cap on rounds — on commit rounds with a
    binding `eval_window`), `inner_iters` (the matching's fallback depth),
    `match_width` (candidates per pod and round; default N up to 512 nodes,
    else 128), `compact` (evaluate pending pods only; placements are the
    same either way), `rel_serialize` (carrier serialization, effective when
    the InterPodAffinity filter is enabled) and `eval_window` (each round
    evaluates a window of that many pending pods in queue order, rounded up
    to the chunk; a commit resets the window to the front, a round without
    one moves it on, a whole sweep without one ends the pass). `loop` and
    `inner_loop` ("dynamic" or "static"; `inner_loop` None takes `loop`'s)
    choose the counted forms of the round and matching loops;
    `static_rounds` (default `max_rounds`, else ceil(P/N) + 4, raised to
    one whole window sweep under a binding `eval_window`) is a counted
    pass's round budget, read at run time; an explicit one below the sweep
    raises ValueError under loop="static"."""

    def __init__(
        self,
        enc: EncodedCluster,
        *,
        strict: bool = True,
        chunk: int = 256,
        max_rounds: "int | None" = None,
        inner_iters: int = 64,
        loop: str = "dynamic",
        static_rounds: "int | None" = None,
        match_width: "int | None" = None,
        compact: bool = True,
        inner_loop: "str | None" = None,
        rel_serialize: bool = True,
        eval_window: "int | None" = None,
        device: "str | torch.device | None" = None,
    ):
        self.chunk = int(chunk)
        self.inner_iters = int(inner_iters)
        self.rel_serialize = bool(rel_serialize) and (
            "InterPodAffinity" in enc.config.enabled("filter")
        )
        if match_width is None:
            match_width = enc.N if enc.N <= 512 else 128
        self.match_width = max(1, min(int(match_width), enc.N))
        self.compact = bool(compact)
        if eval_window is not None:
            eval_window = int(eval_window)
            if eval_window < 1:
                raise ValueError(f"eval_window must be >= 1, got {eval_window}")
        self.eval_window = eval_window
        if loop not in ("dynamic", "static"):
            raise ValueError(f"loop must be dynamic|static, got {loop!r}")
        if inner_loop is None:
            inner_loop = loop
        if inner_loop not in ("dynamic", "static"):
            raise ValueError(f"inner_loop must be dynamic|static|None, got {inner_loop!r}")
        self.loop, self.inner_loop = loop, inner_loop
        explicit = static_rounds is not None or max_rounds is not None
        if static_rounds is None:
            # an explicit max_rounds is the budget too; else about the most
            # pods a node takes, plus slack (a longer fixpoint auto-resumes)
            static_rounds = (max_rounds if max_rounds is not None
                             else -(-enc.P // max(1, enc.N)) + 4)
        # read at run time (GangSweep's resume rule reads it too)
        self.static_rounds = int(static_rounds)
        self._wp = self.effective_window(enc, self.eval_window, self.chunk)
        if self._wp is not None:
            # a commit resets the window to the front, so a budget below one
            # whole sweep of the windows could end a pass before later windows
            # were evaluated (and a counted pass without a commit would stop
            # the auto-resume with feasible pods pending)
            n_win = -(-enc.P // self._wp)
            if not explicit:
                self.static_rounds = max(self.static_rounds, n_win)
            elif loop == "static" and self.static_rounds < n_win:
                raise ValueError(
                    f"static per-pass budget {self.static_rounds} cannot cover a full "
                    f"eval_window sweep (ceil(P/WP) = {n_win}): raise static_rounds/max_rounds "
                    "or eval_window"
                )
            elif loop == "dynamic" and max_rounds is not None and max_rounds < n_win:
                raise ValueError(
                    f"dynamic per-pass commit budget max_rounds={max_rounds} cannot cover a "
                    f"full eval_window sweep (ceil(P/WP) = {n_win}): raise max_rounds or "
                    "eval_window"
                )
        self.max_rounds = max_rounds
        self._base = BatchedScheduler(enc, record=False, strict=strict, device=device)
        self.enc = self._base.enc
        self.device = self._base.device
        self.signature = self.compile_signature(self.enc)  # what the program baked
        self.skipped_postfilter = [
            n for n in enc.config.enabled("postFilter") if n not in K.POSTFILTER_KERNELS
        ]
        self.preempts = self._base.preempts
        self.weights = self._base.weights
        self._prepped = None
        self._final_state = None
        self._rounds = None
        self._chronology = None
        self._trace = None
        self._recorded_weights = None
        self._rec = None
        self._a = None  # the widened planes while a drive runs (`widened`)
        # what the last drive did: rounds, preempt phases, host readbacks
        self.last_stats: dict = {}

    # -- the queue on the device --------------------------------------------

    def order_arrays(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(order, in_queue): order[p] = pod p's position in the PrioritySort
        queue (NO_ORDER when not queued), in_queue[p] bool; on the engine's
        device."""
        P = self.enc.P
        order = np.full((P,), NO_ORDER, np.int32)
        queue = np.asarray(self.enc.queue, np.int64)
        order[queue] = np.arange(len(queue), dtype=np.int32)
        order_t = torch.as_tensor(order, device=self.device)
        return order_t, order_t != NO_ORDER

    def _prep(self, a=None) -> None:
        """The encoding's device-side round inputs, from its widened planes
        `a` (None: widened here): the queue, the order, each pod's RWOP
        claims as a -1-padded list [P, MC] and the carriers."""
        enc = self.enc
        if self._prepped is enc:
            return
        if a is None:
            a = packing.widen(enc)
        self._order, _ = self.order_arrays()
        self._queue = torch.as_tensor(np.asarray(enc.queue, np.int32), device=self.device)
        pc = a.pod_claim
        C = pc.shape[1]
        mc = max(1, int(pc.sum(dim=1).max())) if pc.numel() else 1
        cols = torch.where(pc, torch.arange(C, device=self.device, dtype=torch.int32), C)
        cols = torch.sort(cols, dim=1).values[:, :mc] if C else cols.new_full((enc.P, 1), C)
        self._claims = torch.where(cols < C, cols, -1).to(torch.int32).contiguous()
        self._carrier = (
            (a.rel.ian_key >= 0).any(dim=1).contiguous() if self.rel_serialize else None
        )
        self._prepped = enc

    def _pending(self, states, sort: bool):
        """(rows [V, Q], counts [V] int32) for stacked states [V, ...]: each
        variant's queue pods — pending first, in queue order, when `sort`,
        else as queued — and its pending count, both on the device."""
        q = self._queue.long()
        pend = (states.assignment[:, q] < 0) & self.enc.arrays.pod_mask[q]  # 1-D: never packed
        count = pend.sum(dim=1, dtype=torch.int32)
        if not sort:
            return self._queue.expand(pend.shape[0], -1), count
        return self._queue[torch.argsort((~pend).to(torch.int8), dim=1, stable=True)], count

    # -- one round -----------------------------------------------------------

    def _round(self, states, w, rows, live):
        """eval → top-k → match → bind of every variant of stacked `states`
        (weights [V, S], rows [V, K]) over rows [0, live[v]) (all rows when
        live is None), in place: one launch of each kernel. Returns the
        round's sel [V, K] and stat [V, 2]."""
        enc, prog, a = self.enc, self._base.program, self._a
        scores = cuda.gang_eval(prog, a, states, w, rows, live, self._order)
        if self.match_width < enc.N:
            vals, idx = cuda.gang_topk(scores, live, self.match_width)
        else:
            vals, idx = scores, None
        sel, stat = cuda.gang_match(
            vals, idx, rows, live, self._order, self._claims, self._carrier, enc.N,
            packing.logical_dim(enc, "pod_claim"), self.inner_iters,
            counted=self.inner_loop == "static",
        )
        cuda.gang_bind(prog, a, states, rows, live, sel, self._order)
        return sel, stat

    # -- execution ------------------------------------------------------------

    def run(self, weights: "torch.Tensor | None" = None):
        """Execute to fixpoint; returns (final_state, rounds). With
        DefaultPreemption enabled the rounds alternate with preempt phases
        until a phase binds nothing."""
        return self._drive(weights, chronology=None)

    def run_recorded(self, weights: "torch.Tensor | None" = None):
        """`run()` that also keeps what the records need: per gang pass its
        start state, each pod's bind round and the pass-end assignment; per
        preempt phase its segment and its trace; the leftovers when no phase
        exists. Same placements as `run()`."""
        return self._drive(weights, chronology=[])

    def warmup(self, record: bool = False) -> "GangScheduler":
        """One full drive whose result is dropped (the kernels build and
        load; a later pass on a retargeted encoding starts warm)."""
        self.run_recorded() if record else self.run()
        self._final_state = self._rounds = self._chronology = None
        self._trace = self._recorded_weights = None
        return self

    @contextlib.contextmanager
    def widened(self):
        """The encoding's logical planes for one drive (`packing.widen`),
        kept as `_a` while it runs and let go after it; the round inputs
        prepared from them."""
        self._a = packing.widen(self.enc)
        try:
            self._prep(self._a)
            yield self._a
        finally:
            self._a = None

    def _drive(self, weights, chronology: "list | None"):
        """The one driver behind `run()` and `run_recorded()`: gang passes
        alternating with preempt phases, on the widened planes."""
        with self.widened():
            return self._drive_widened(weights, chronology)

    def _drive_widened(self, weights, chronology: "list | None"):
        w = self.weights if weights is None else torch.as_tensor(
            weights, dtype=self.enc.policy.score, device=self.device)
        tracked = chronology is not None
        self.last_stats = {"rounds": 0, "phases": 0, "host_syncs": 0, "phase_pods": 0}
        state = self.enc.state0.clone()
        # the one-variant stack of the round kernels (views of `state`)
        rounds, n_pend = self._resumed_pass(cuda.as_variants(state), w[None], chronology)
        prog, a = self._base.program, self._a
        if self.preempts:
            while n_pend > 0:
                rows, _ = self._pending(cuda.as_variants(state), sort=True)
                seg = rows[0, :n_pend].contiguous()
                qpos = self._order[seg.long()].contiguous()
                state, out = cuda.seq_run(prog, a, state, seg, w, record=tracked, qpos=qpos)
                self.last_stats["phases"] += 1
                self.last_stats["phase_pods"] += n_pend
                if tracked:
                    chronology.append(("phase", seg, out))
                    out = out[TRACE_SLOTS_PREEMPT.index("final_sel")]
                n_bound = int((out >= 0).sum())
                self.last_stats["host_syncs"] += 1
                if n_bound == 0:
                    break
                r, n_pend = self._resumed_pass(cuda.as_variants(state), w[None], chronology)
                rounds += r
        elif tracked and n_pend > 0:
            rows, _ = self._pending(cuda.as_variants(state), sort=True)
            chronology.append(("leftover", rows[0, :n_pend].contiguous()))
        self.last_stats["rounds"] = rounds
        self._final_state = state
        self._rounds = rounds
        if tracked:
            self._chronology = chronology
            self._recorded_weights = w
            self._trace = None  # assembled by results()
        return state, rounds

    def placements(self) -> dict[tuple[str, str], str]:
        """pod (ns, name) → node name ("" = unschedulable)."""
        if self._final_state is None:
            self.run()
        return self.enc.decode_assignment(self._final_state.assignment)

    # -- record path (the reference's 13-annotation product) ------------------

    def _recorder(self) -> BatchedScheduler:
        """The record-mode base engine whose `results()` decodes the trace."""
        if self._rec is None:
            self._rec = BatchedScheduler(self.enc, record=True, strict=False,
                                         device=self.device)
        return self._rec

    def _assemble_trace(self) -> tuple:
        """The chronology as the sequential trace (engine/cuda.py
        TRACE_SLOTS_PLAIN or TRACE_SLOTS_PREEMPT, one row per queue
        position), later entries overwriting earlier rows as the reference's
        replay does: a gang round's pods are re-evaluated against the
        round's start state (and their rounds bound in turn), a phase's rows
        are its own trace, leftovers are evaluated against the final state."""
        with self.widened() as a:
            return self._assemble_widened(a)

    def _assemble_widened(self, a) -> tuple:
        enc, prog = self.enc, self._base.program
        rec = self._recorder()
        w = self._recorded_weights
        order = self._order
        dev, dt = self.device, enc.policy.score
        Q, N = len(enc.queue), enc.N
        F, S = len(rec._filter_names), len(rec._score_specs)
        i32 = dict(dtype=torch.int32, device=dev)
        rows = {
            "pf_codes": torch.zeros((Q, len(rec._prefilter_kernel_names)), **i32),
            "codes": torch.zeros((Q, N, F), **i32),
            "raw": torch.zeros((Q, N, S), dtype=dt, device=dev),
            "final": torch.zeros((Q, N, S), dtype=dt, device=dev),
            "sel": torch.full((Q,), -1, **i32),
        }
        if self.preempts:
            rows.update(
                did=torch.zeros((Q,), dtype=torch.bool, device=dev),
                pcode=torch.zeros((Q, N), **i32), nominated=torch.full((Q,), -1, **i32),
                sel2=torch.full((Q,), -1, **i32), pcode2=torch.zeros((Q, N), **i32),
                nominated2=torch.full((Q,), -1, **i32), final_sel=torch.full((Q,), -1, **i32),
                codes2=torch.zeros((Q, N, F), **i32),
                raw2=torch.zeros((Q, N, S), dtype=dt, device=dev),
                final2=torch.zeros((Q, N, S), dtype=dt, device=dev),
                voff=torch.zeros((Q, 2, N + 1), **i32),
            )
        evals = tuple(rows[k] for k in ("pf_codes", "codes", "raw", "final"))
        victims, base = [], 0
        state = None
        for entry in self._chronology:
            if entry[0] == "rounds":
                _, start, br, _, assign_after = entry
                state = start.clone()
                br_np = br.cpu().numpy()
                # the bind rounds present, in order (a counted pass numbers
                # them by slot, with gaps where a slot bound nothing)
                for r in np.unique(br_np[br_np >= 0]):
                    pods = np.nonzero(br_np == r)[0].astype(np.int32)
                    pods_t = torch.as_tensor(pods, device=dev)
                    slot = order[pods_t.long()]
                    cuda.gang_eval(prog, a, state, w, pods_t, None, order, check_pending=False,
                                   slot=slot, trace=evals)
                    sel = assign_after[pods_t.long()]
                    cuda.gang_bind(prog, a, state, pods_t, None, sel, order)
                    rows["sel"][slot.long()] = sel
                    if self.preempts:
                        rows["final_sel"][slot.long()] = sel
            elif entry[0] == "phase":
                _, seg, out = entry
                slot = order[seg.long()].long()
                got = dict(zip(TRACE_SLOTS_PREEMPT, out))
                for name, dst in rows.items():
                    src = got[name] + base if name == "voff" else got[name]
                    dst.index_copy_(0, slot, src)
                victims.append(got["vidx"])
                base += len(got["vidx"])
            else:  # leftovers, evaluated against the final state
                seg = entry[1]
                cuda.gang_eval(prog, a, state, w, seg, None, order, check_pending=False,
                               slot=order[seg.long()], trace=evals)
        names = cuda.TRACE_SLOTS_PLAIN
        if not self.preempts:
            return tuple(rows[n] for n in names)
        vidx = torch.cat(victims) if victims else torch.zeros((0,), **i32)
        return tuple(rows[n] for n in TRACE_SLOTS_PREEMPT[:-1]) + (vidx,)

    def results(self, pods: "set[tuple[str, str]] | None" = None):
        """The per-pod scheduling records of the gang run (the 13-annotation
        wire format, decoded by the sequential engine's `results()`). Runs
        `run_recorded()` first when needed."""
        if self._chronology is None:
            self.run_recorded()
        if self._trace is None:
            self._trace = self._assemble_trace()
        rec = self._recorder()
        rec._trace = self._trace
        rec._final_state = self._final_state
        return rec.results(pods)

    # -- engine reuse ------------------------------------------------------------

    @staticmethod
    def compile_signature(enc: EncodedCluster) -> tuple:
        """What the engine takes from its encoding beyond the tensors: the
        sequential signature without the queue length (the queue rides in
        as a fixed-[P] order)."""
        return BatchedScheduler.compile_signature(enc, record=False, include_queue_len=False)

    @staticmethod
    def effective_window(
        enc: EncodedCluster, eval_window: "int | None", chunk: int = 256
    ) -> "int | None":
        """The chunk-granular window row count the rounds use — None when
        windowing is off or never binds (eval_window >= P)."""
        if eval_window is None:
            return None
        ch = max(1, min(int(chunk), enc.P))
        wp = min(-(-min(int(eval_window), enc.P) // ch) * ch, enc.P)
        return None if wp >= enc.P else wp

    def retarget(self, enc: EncodedCluster) -> "GangScheduler":
        """Point at a compile-compatible new encoding (see
        BatchedScheduler.retarget)."""
        if self.compile_signature(enc) != self.signature:
            raise ValueError("encoding is not compile-compatible; rebuild")
        self._base.enc = self.enc = enc.to(self.device)
        self._prepped = None
        self._final_state = self._rounds = None
        self._chronology = self._trace = self._recorded_weights = None
        self._rec = None
        return self


# ---------------------------------------------------------------------------
# the batch plane's gang passes (server/batchplane.py `batch.gang.run`)
# ---------------------------------------------------------------------------


class _TenantRounds(_Rounds):
    """The round body over B tenants' `GangScheduler`s of one batch window:
    the tenant forms of the K9 kernels (`cuda.batch_eval`, `batch_match`,
    `batch_bind`; `gang_topk` reads only scores), each tenant with its own
    program, planes, order, claims and carriers. The window's tenants share
    one gang signature and effective window, so their options, P and N are
    equal (checked)."""

    _SAME = ("P", "N")
    _OPTIONS = ("_wp", "max_rounds", "compact", "match_width", "inner_iters", "rel_serialize",
                "preempts", "device", "loop", "inner_loop", "static_rounds")
    _table = None  # the tenant table, when built beforehand (`cuda.scenario_table`)

    def __init__(self, gangs: "list[GangScheduler]"):
        if not gangs:
            raise ValueError("a batch needs at least one tenant")
        g0 = gangs[0]
        for i, g in enumerate(gangs):
            bad = [x for x in self._SAME if getattr(g.enc, x) != getattr(g0.enc, x)]
            bad += [x for x in self._OPTIONS if getattr(g, x) != getattr(g0, x)]
            if bad:
                raise ValueError(f"tenant {i} differs from tenant 0 in {bad}")
        # each tenant's widened planes, for this window
        self._arrays = [packing.widen(g.enc) for g in gangs]
        for g, a in zip(gangs, self._arrays):
            g._prep(a)
        self.gangs = gangs
        self.enc = g0.enc
        for x in self._OPTIONS:
            setattr(self, x, getattr(g0, x))
        self.last_stats = {"host_syncs": 0}
        self._progs = [g._base.program for g in gangs]
        dev, P = self.device, g0.enc.P
        # each tenant's queue as a -1 padded row, its order, claims (-1 padded
        # to the widest tenant's) and carriers
        Qm = max(len(g._queue) for g in gangs)
        self._queue = torch.full((len(gangs), Qm), -1, dtype=torch.int32, device=dev)
        for b, g in enumerate(gangs):
            self._queue[b, :len(g._queue)] = g._queue
        self._orders = torch.stack([g._order for g in gangs]).contiguous()
        self._pod_mask = torch.stack([g.enc.arrays.pod_mask for g in gangs])
        mc = max(g._claims.shape[1] for g in gangs)
        self._claims = torch.stack([
            torch.cat([g._claims, g._claims.new_full((P, mc - g._claims.shape[1]), -1)], dim=1)
            for g in gangs]).contiguous()
        self._carriers = (None if g0._carrier is None
                          else torch.stack([g._carrier for g in gangs]).contiguous())

    def _pending(self, states, sort: bool):
        """(rows [B, Q], counts [B] int32): each tenant's queue pods —
        pending first, in queue order, when `sort` — and its pending count;
        padding (-1) last, never pending."""
        q = self._queue.long()
        qc = q.clamp(min=0)
        pend = ((states.assignment.gather(1, qc) < 0) & self._pod_mask.gather(1, qc)
                & (q >= 0))
        count = pend.sum(dim=1, dtype=torch.int32)
        if not sort:
            return self._queue, count
        return self._queue.gather(1, torch.argsort((~pend).to(torch.int8), dim=1,
                                                   stable=True)), count

    def _round(self, states, w, rows, live):
        """eval → top-k → match → bind of every tenant (one launch of each
        kernel), in place. Returns sel [B, K] and stat [B, 2]."""
        enc = self.enc
        scores = cuda.batch_eval(self._progs, self._arrays, states, w, rows, live, self._orders,
                                 table=self._table)
        if self.match_width < enc.N:
            vals, idx = cuda.gang_topk(scores, live, self.match_width)
        else:
            vals, idx = scores, None
        sel, stat = cuda.batch_match(
            vals, idx, rows, live, self._orders, self._claims, self._carriers, enc.N,
            packing.logical_dim(enc, "pod_claim"), self.inner_iters,
            counted=self.inner_loop == "static",
        )
        cuda.batch_bind(self._progs, self._arrays, states, rows, live, sel, self._orders,
                        table=self._table)
        return sel, stat


class _ScenarioRounds(_TenantRounds):
    """The round body over S node-failure scenarios of one cluster (K11
    `faultsweep.vrun`/`one`, lifecycle/faultsweep.py): the K9 kernels'
    tenant forms, each scenario a tenant whose planes are the cluster's but
    for its own node mask row (`cuda.scenario_table`, so every read of the
    node mask — the filters, the relational prologue's topology domains,
    the spread keys — sees the scenario's row), with the cluster's program,
    queue, order, claims and carriers (the last three repeated a scenario,
    as the tenant forms read them: `dup_bytes`). Each scenario evaluates its
    pending rows only; the reference's `compact=False` evaluates every queue
    row, and the same pods commit in the same rounds."""

    _pending = GangScheduler._pending  # one queue for every scenario

    def __init__(self, gang: GangScheduler, node_masks: torch.Tensor, a=None):
        """`a`: the gang's encoding's widened planes (`GangScheduler.widened`;
        None: widened here)."""
        if a is None:
            a = packing.widen(gang.enc)
        gang._prep(a)
        for x in self._OPTIONS:
            setattr(self, x, getattr(gang, x))
        self.compact = True
        self.enc = gang.enc
        self.last_stats = {"host_syncs": 0}
        S, prog = node_masks.shape[0], gang._base.program
        self._progs = [prog] * S
        self._arrays = [dataclasses.replace(a, node_mask=node_masks[s]) for s in range(S)]
        self._queue = gang._queue
        self._orders = gang._order.expand(S, -1).contiguous()
        self._claims = gang._claims.expand(S, -1, -1).contiguous()
        self._carriers = (None if gang._carrier is None
                          else gang._carrier.expand(S, -1).contiguous())
        self.dup_bytes = sum(x.numel() * x.element_size()
                             for x in (self._orders, self._claims, self._carriers)
                             if x is not None)
        self._masks = node_masks  # the table holds its rows' addresses
        self._table = None if cuda._on_cpu(a) else cuda.scenario_table(prog, a, node_masks)


def batch_fixpoint(gangs: "list[GangScheduler]") -> list:
    """K11 `batch.gang.run`: the untracked gang passes (`run()`) of B
    tenants of one batch window, each at its own weights, launched together:
    rounds through the K9 kernels' tenant forms to each tenant's fixpoint,
    then, while a tenant has pods pending and its last phase bound one, a
    preempt phase of every such tenant in one `cuda.batch_seg` launch (its
    pending pods in queue order at their queue positions) and a resumed
    pass of the tenants whose phase bound a pod. A tenant whose phase bound
    nothing stops there, its state and rounds as they are, and rides along
    at live 0 (an all-padding segment in a phase): the reference's vmapped
    fused fixpoint (`gang.py` `fixpoint`), whose session stops with its own
    outer loop — not `GangSweep`'s lockstep. So each tenant's (state,
    rounds) equals its solo `GangScheduler.run()`. Sets each engine's
    `_final_state` and `_rounds` (and `last_stats`: its rounds and phases,
    the window's readbacks); returns [(final state, rounds)] by tenant."""
    t = _TenantRounds(gangs)
    B = len(gangs)
    w = torch.stack([g.weights for g in gangs]).contiguous()
    states = cuda.stack_states([g.enc.state0 for g in gangs])
    rounds, n_pend = t._gang_pass(states, w)
    phases = [0] * B
    if t.preempts:
        active = [n > 0 for n in n_pend]
        while any(active):
            rows, _ = t._pending(states, sort=True)
            K = max(n for n, a in zip(n_pend, active) if a)
            keep = torch.tensor([n if a else 0 for n, a in zip(n_pend, active)],
                                dtype=torch.int32, device=t.device)
            segs = rows[:, :K]
            segs = torch.where(torch.arange(K, device=t.device)[None, :] < keep[:, None], segs,
                               -1).contiguous()
            qpos = torch.where(segs >= 0, t._orders.gather(1, segs.clamp(min=0).long()),
                               0).contiguous()
            states, sel = cuda.batch_seg(t._progs, t._arrays, states, segs, w, qpos)
            n_bound = (sel >= 0).sum(dim=1).tolist()
            t.last_stats["host_syncs"] += 1
            resumed = []
            for b in range(B):
                phases[b] += active[b]
                resumed.append(active[b] and n_bound[b] > 0)
            if not any(resumed):
                break
            r, n = t._gang_pass(states, w, start=resumed)
            for b in range(B):
                if resumed[b]:
                    rounds[b] += r[b]
                    n_pend[b] = n[b]
            active = [resumed[b] and n_pend[b] > 0 for b in range(B)]
    out = []
    for b, g in enumerate(gangs):
        g._final_state = cuda.variant_state(states, b)
        g._rounds = rounds[b]
        g._chronology = g._trace = g._recorded_weights = None
        g.last_stats = {"rounds": rounds[b], "phases": phases[b],
                        "host_syncs": t.last_stats["host_syncs"], "tenants": B}
        out.append((g._final_state, rounds[b]))
    return out
