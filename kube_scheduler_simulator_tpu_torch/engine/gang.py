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

The round loop is driven from the host with one readback a round (the
count `gang_match` committed and the pending count, two integers a
variant): the pending list, its count and the phase segment are built on
the card (a stable order of the queue's pending pods), and every kernel
reads the live row count there. A phase costs one more readback (the pods
it bound), and `seq_run`'s own checks three.

The round body runs on a stack of V variants' states with a [V, S] weight
matrix (`_gang_pass`): one launch of each kernel a round for all of them,
each variant to its own fixpoint. `GangScheduler` is its V = 1 case; the
gang weight sweep (parallel/sweep.py `GangSweep`) drives it with V > 1.

The record path (`run_recorded`, `results`) tracks each pod's bind round,
records each preempt phase's trace as it runs, and replays the rounds:
each pod bound in a round is evaluated once more, with its full per-plugin
rows, against the start state of that round, and leftovers against the
final state. The result is the sequential trace in the port's layout
(engine/cuda.py TRACE_SLOTS_PREEMPT, victims as CSR records), decoded by
the sequential engine's `results()`.

Not ported: `loop="static"` and `inner_loop="static"` (the counted-loop
programs the reference keeps for a TPU backend that could not compile
`while_loop`; the same placements), which raise NotImplementedError
(ROADMAP.md), and the batch plane.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda
from . import kernels as K
from .cuda import NO_ORDER, TRACE_SLOTS_PREEMPT
from .encode import EncodedCluster
from .engine import BatchedScheduler


class GangScheduler:
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
    one moves it on, a whole sweep without one ends the pass)."""

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
        if "static" in (loop, inner_loop) or static_rounds is not None:
            raise NotImplementedError(
                "the counted-loop gang programs (loop='static', inner_loop='static', "
                "static_rounds) are not ported yet (ROADMAP.md); loop='dynamic' places the "
                "same pods"
            )
        self.loop, self.inner_loop = loop, inner_loop
        self._wp = self.effective_window(enc, self.eval_window, self.chunk)
        if self._wp is not None and max_rounds is not None:
            n_win = -(-enc.P // self._wp)
            if max_rounds < n_win:
                # a commit resets the window to the front, so a smaller cap
                # could end the pass before later windows were evaluated
                raise ValueError(
                    f"dynamic per-pass commit budget max_rounds={max_rounds} cannot cover a "
                    f"full eval_window sweep (ceil(P/WP) = {n_win}): raise max_rounds or "
                    "eval_window"
                )
        self.max_rounds = max_rounds
        self._base = BatchedScheduler(enc, record=False, strict=strict, device=device)
        self.enc = self._base.enc
        self.device = self._base.device
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

    def _prep(self) -> None:
        """The encoding's device-side round inputs: the queue, the order,
        each pod's RWOP claims as a -1-padded list [P, MC] and the carriers."""
        enc = self.enc
        if self._prepped is enc:
            return
        a = enc.arrays
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
        pend = (states.assignment[:, q] < 0) & self.enc.arrays.pod_mask[q]
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
        enc, prog, a = self.enc, self._base.program, self.enc.arrays
        scores = cuda.gang_eval(prog, a, states, w, rows, live, self._order)
        if self.match_width < enc.N:
            vals, idx = cuda.gang_topk(scores, live, self.match_width)
        else:
            vals, idx = scores, None
        sel, stat = cuda.gang_match(
            vals, idx, rows, live, self._order, self._claims, self._carrier, enc.N,
            a.pod_claim.shape[1], self.inner_iters,
        )
        cuda.gang_bind(prog, a, states, rows, live, sel, self._order)
        return sel, stat

    def _window_rows(self, rows, count, w_idx):
        """Each variant's eval window of its pending-first rows [V, Q]: WP
        rows from lo = min(k * WP, P - WP), k = min(w_idx, windows - 1)
        (-1 past the queue), and its live count. Returns (rows [V, WP], live
        [V], k per variant)."""
        P, WP, dev = self.enc.P, self._wp, self.device
        n_win = -(-P // WP)
        k = [min(x, n_win - 1) for x in w_idx]
        lo = torch.tensor([min(kk * WP, P - WP) for kk in k], dtype=torch.int32, device=dev)
        Q = rows.shape[1]
        padded = torch.cat([rows, rows.new_full((rows.shape[0], 1), -1)], dim=1)
        at = (lo[:, None] + torch.arange(WP, dtype=torch.int32, device=dev)).clamp(max=Q)
        return padded.gather(1, at.long()), (count - lo).clamp(0, WP), k

    def _gang_pass(self, states, w, chronology=None):
        """Rounds to fixpoint from stacked `states` [V, ...] (in place),
        variant v at weights row w[v], one launch of each kernel a round for
        every variant. Each variant runs until its own fixpoint and then
        rides along frozen (live 0, its counters unchanged), as under the
        reference's vmapped while_loop. Returns (rounds, pods still pending),
        lists of V. `chronology` (the record path) takes V = 1."""
        V, P = w.shape[0], self.enc.P
        WP = self._wp
        cap = self.max_rounds if self.max_rounds is not None else P + 1
        tracked = chronology is not None
        if tracked:
            start = cuda.variant_state(states, 0).clone()
            br = torch.full((P,), -1, dtype=torch.int32, device=self.device)
        rounds, commits, w_idx = [0] * V, [0] * V, [0] * V  # commits: rounds that commit
        n_pend = [None] * V
        active = [cap > 0] * V
        sort = self.compact or WP is not None or V > 1
        K = len(self._queue)  # the rows a round takes: the queue, then the most pending
        while any(active):
            rows, count = self._pending(states, sort)
            gate = None if all(active) else torch.tensor(active, device=self.device)
            if WP is None:
                live = count if sort else None
                if sort:
                    rows = rows[:, :max(1, K)].contiguous()
            else:
                rows, live, k = self._window_rows(rows, count, w_idx)
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
        if None in n_pend:  # no round ran (max_rounds=0)
            n_pend = self._pending(states, sort=False)[1].tolist()
            self.last_stats["host_syncs"] += 1
        if tracked:
            chronology.append(("rounds", start, br, rounds[0], states.assignment[0].clone()))
        return rounds, n_pend

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

    def _drive(self, weights, chronology: "list | None"):
        """The one driver behind `run()` and `run_recorded()`: gang passes
        alternating with preempt phases."""
        w = self.weights if weights is None else torch.as_tensor(
            weights, dtype=self.enc.policy.score, device=self.device)
        self._prep()
        tracked = chronology is not None
        self.last_stats = {"rounds": 0, "phases": 0, "host_syncs": 0, "phase_pods": 0}
        state = self.enc.state0.clone()
        # the one-variant stack of the round kernels (views of `state`)
        r, n = self._gang_pass(cuda.as_variants(state), w[None], chronology)
        rounds, n_pend = r[0], n[0]
        prog, a = self._base.program, self.enc.arrays
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
                r, n = self._gang_pass(cuda.as_variants(state), w[None], chronology)
                rounds, n_pend = rounds + r[0], n[0]
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
        enc, prog, a = self.enc, self._base.program, self.enc.arrays
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
                _, start, br, n_rounds, assign_after = entry
                state = start.clone()
                br_np = br.cpu().numpy()
                for r in range(n_rounds):
                    pods = np.nonzero(br_np == r)[0].astype(np.int32)
                    if not pods.size:
                        continue
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
        if self.compile_signature(enc) != self.compile_signature(self.enc):
            raise ValueError("encoding is not compile-compatible; rebuild")
        self._base.enc = self.enc = enc.to(self.device)
        self._prepped = None
        self._final_state = self._rounds = None
        self._chronology = self._trace = self._recorded_weights = None
        self._rec = None
        return self
