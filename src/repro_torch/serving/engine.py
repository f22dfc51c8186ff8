"""Continuous-batching serving engine over the paged KV cache (port of
`repro.serving.engine`).

One engine iteration interleaves both kinds of work:

    fault hooks + deadline expiry -> admission (FIFO or EDF, optional
                        preemption-by-eviction) -> queue backpressure
    one PREFILL unit  - the oldest admitted request's whole prompt, or
                        its next chunk when `prefill_chunk` is set
    one DECODE step   - every request with a committed prompt, batched
                        through one `decode_batch` call at a power-of-two
                        slot bucket (one CUDA graph replay on the card)
    retire completions - pages return to the free list (metadata only)

so new requests reach their first token without draining the running
batch, and running requests never stall behind a long prompt for more
than one prefill unit.  All numbers the engine reports come from the
injected clock (`perf_counter`-backed wall clock by default, virtual
clock for deterministic runs), never `time.time()`.

Budgets: `hbm_budget_bytes` sizes the page pool (admission is then a
free-list question), and at construction the engine asks the split
decode-attention planner (`kernels.vp_attention.plan_decode`) for the
packed cache at the engine's capacity, so a shape the kernel refuses fails
here, not at the first decode.

Resilience: overflow/NaN escapes from the packed path are an expected
operating condition to contain, not a fatal invariant violation:

  * per-slot finite check - a non-finite logit quarantines ONLY the
    offending request (`on_nonfinite="quarantine"`); surviving slots
    continue bit-identically (the poisoned slot only ever wrote its own
    reserved pages).  `"raise"` keeps the all-or-nothing
    `FloatingPointError`.
  * retry with backoff - transient dispatch failures (`FaultPlan`
    injection, surfaced as `TransientComputeError`) charge an
    exponential backoff to the clock and retry; a request that keeps
    failing is quarantined.
  * graceful degradation - a repeatedly-quarantined request re-runs on
    the static plain path (`runner.oracle_generate`, dense cache,
    optionally separately-quantized `degrade_params`) and is flagged
    `degraded` instead of dropped.
  * bounded submit queue - arrivals that find `max_queue` requests
    already waiting are shed (`shed` outcome).
  * deadlines/SLOs - see `scheduler`; expiry cancels with full page
    reclamation (`timeout` outcome).

Per-request outcomes land on the `run()` records
(`ok|retried|quarantined|degraded|timeout|shed`) and aggregate counters
on `engine.stats`.

Mesh-native serving (`mesh=`, a DeviceMesh with dims "data" and
"model", `launch.mesh`): every rank runs this engine on the same
requests.  The weights are placed once (`shard_ops.place_params`: this
rank's shards), the runner serves tensor parallel over "model" and data
parallel over the slot buckets that divide "data"; the scheduler, page
tables, pools and sampling stay replicated and equal on every rank, and
the clock is agreed (`AgreedClock`: every rank reads the latest rank's
time), so every rank takes the same decisions.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import storage_dtype
from repro_torch.kernels import autotune, paged
from repro_torch.kernels.vp_attention import plan_decode
from repro_torch.models.attention import kv_cache_formats
from repro_torch.parallel import comm
from .faults import FaultPlan, TransientComputeError
from .page_cache import PAGED, PagedKVCache, buf_key
from .runner import ModelRunner, device_of, oracle_generate, \
    supports_chunked
from .scheduler import Request, RunningRequest, Scheduler, SLOClass, \
    WallClock


class AgreedClock:
    """A clock the ranks of a mesh read alike: `now()` is the largest of
    the ranks' readings (one collective over the world); `tick` and
    `wait_until` act on this rank's clock, which it wraps."""

    def __init__(self, clock):
        self._clock = clock

    def now(self) -> float:
        return comm.agree_max(self._clock.now())

    def __getattr__(self, name):
        return getattr(self._clock, name)


class ServingEngine:
    """Paged continuous-batching engine for one model.

    Parameters mirror the static path where they overlap; the engine
    additions are the paging geometry (`max_slots` concurrent requests,
    `capacity` positions per request, `page_size` positions per page)
    and the budgets.  `temperature=0` decodes greedily (the parity
    mode); `prefill_chunk` enables chunked prefill for full-causal
    models.  The cache lives on the device of `params`.
    `check_graphs` holds each decode graph's first replay against the
    eager step (`runner.ModelRunner`).  `mesh`: serve sharded (module
    docstring); `params` is then the whole tree on every rank.

    Resilience knobs (all default OFF / legacy-equivalent):
      policy="fifo"|"edf", preempt, max_queue, check_finite +
      on_nonfinite ("quarantine"|"raise"), max_retries/retry_backoff_s,
      degrade/degrade_after/degrade_params, faults (a `FaultPlan`).
    """

    def __init__(self, params, cfg: ModelConfig, *, max_slots: int,
                 capacity: int, page_size: int,
                 prefill_chunk: Optional[int] = None,
                 decode_lookahead: int = 1,
                 temperature: float = 0.0, seed: int = 0,
                 clock=None, check_finite: bool = False,
                 n_pages: Optional[int] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 mesh=None,
                 policy: str = "fifo", preempt: bool = False,
                 max_queue: Optional[int] = None,
                 on_nonfinite: str = "quarantine",
                 max_retries: int = 2, retry_backoff_s: float = 0.005,
                 degrade: bool = False, degrade_after: int = 2,
                 degrade_params=None,
                 faults: Optional[FaultPlan] = None,
                 check_graphs: bool = False):
        if decode_lookahead < 1:
            raise ValueError("decode_lookahead must be >= 1")
        if on_nonfinite not in ("quarantine", "raise"):
            raise ValueError(
                f"on_nonfinite must be 'quarantine' or 'raise', "
                f"got {on_nonfinite!r}")
        self.mesh = mesh
        if mesh is not None:
            if "model" not in tuple(getattr(mesh, "mesh_dim_names", None)
                                    or ()):
                raise ValueError(
                    f"mesh= takes a DeviceMesh with a 'model' dim (and "
                    f"optionally 'data'; launch.mesh), got {mesh!r}")
            # the weights sharded once: packed words along d_out over
            # "model", MoE experts along their expert dim
            from repro_torch.parallel import shard_ops
            params = shard_ops.place_params(params, cfg, mesh)
            if degrade_params is not None:
                degrade_params = shard_ops.place_params(degrade_params, cfg,
                                                        mesh)
        self.params = params
        self.cfg = cfg
        self.device = device_of(params)
        self.kv = PagedKVCache(cfg, max_slots=max_slots, capacity=capacity,
                               page_size=page_size, n_pages=n_pages,
                               hbm_budget_bytes=hbm_budget_bytes,
                               device=self.device)
        if prefill_chunk is not None and not supports_chunked(self.kv.specs):
            raise ValueError(
                "chunked prefill requires all attention layers to be "
                "full-causal (windowed layers keep rolling ring buffers "
                "whose write offsets the chunk path does not implement); "
                "use whole-prompt prefill for this config")
        self.prefill_chunk = prefill_chunk
        self.decode_lookahead = int(decode_lookahead)
        self.runner = ModelRunner(cfg, self.kv, temperature=temperature,
                                  mesh=mesh, check_graphs=check_graphs)
        self.scheduler = Scheduler(self.kv, policy=policy, preempt=preempt)
        self.clock = clock if clock is not None else WallClock()
        if mesh is not None:
            self.clock = AgreedClock(self.clock)
        self.check_finite = bool(check_finite)
        self.on_nonfinite = on_nonfinite
        self.max_queue = max_queue
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.degrade = bool(degrade)
        self.degrade_after = int(degrade_after)
        self.degrade_params = degrade_params
        self.faults = faults
        self.stats = collections.Counter()
        self._quarantine_counts: Dict[int, int] = {}
        self._decode_fail_streak = 0
        # Sampling noise: one generator seeded from `seed`, advanced by
        # every draw.
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._step = 0
        self.finished: List[RunningRequest] = []
        self._check_plan()

    def _check_plan(self) -> None:
        """Fail fast if the split decode-attention body cannot take the
        packed cache of some layer (a paged layer's view of the engine's
        capacity, a ring's `buf_len` rows; `plan_decode` raises for the
        shapes it refuses, none of the dense configs' at int8 or int16
        words): at construction, not at the first decode, and with the
        plan each decode launch takes (the plan cache's on the card).
        The counterpart of the reference's VMEM budget check.  Under a
        mesh the check is the same: data shards cut only the slot batch,
        which the plan does not read (one row's plan holds for every
        shard), and tensor parallelism gathers q, k and v whole, so each
        rank attends over every head."""
        q = self.cfg.quant
        if not (q.quantize_kv_cache and q.kv_layout == "packed"):
            return
        _, vp = kv_cache_formats(q)
        KV, dh = self.cfg.n_kv_heads, self.cfg.head_dim
        w_bytes = torch.empty((), dtype=storage_dtype(vp)).element_size()
        for spec in self.kv.specs:
            if not spec.has_len:   # an SSM state: no attention
                continue
            smax = self.kv.capacity if spec.kind == PAGED else spec.buf_len
            window = spec.window
            plan_decode(KV, smax, self.cfg.n_heads // KV, dh, w_bytes, None,
                        window, window is not None and smax <= window, vp,
                        autotune.cuda_index(self.device))

    # -- request API --------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               arrival_time: float = 0.0,
               deadline: Optional[float] = None,
               slo: Optional[SLOClass] = None) -> Request:
        self.stats["submitted"] += 1
        return self.scheduler.submit(prompt, max_new_tokens, arrival_time,
                                     deadline=deadline, slo=slo)

    # -- internals ----------------------------------------------------------

    def _next_key(self):
        """The noise source of the next compute unit: the engine's
        generator, which each draw advances; None when decoding greedily,
        where nothing is drawn."""
        if self.runner.temperature == 0:
            return None
        self._step += 1
        return self._gen

    def _timed(self, fn, *args, **kw):
        """Run one step to completion (the device synchronized) and
        charge its wall time to a virtual clock (wall clocks advance on
        their own)."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if hasattr(self.clock, "tick"):
            self.clock.tick(time.perf_counter() - t0)
        return out

    def _charge(self, seconds: float) -> None:
        """Charge non-compute time (backoff, stalls) to the clock."""
        if hasattr(self.clock, "tick"):
            self.clock.tick(seconds)
        else:
            self.clock.wait_until(self.clock.now() + seconds)

    # -- fault containment --------------------------------------------------

    def _screen(self, phase: str, run: RunningRequest, logits) -> bool:
        """Per-slot health screen on one request's host logits.

        Applies any scheduled fault-plan poison (host-side only — the
        device computation and every co-resident slot are untouched),
        then the finite check.  Returns True if the request is healthy;
        False means the caller must quarantine it.  `"raise"` mode keeps
        the legacy all-or-nothing FloatingPointError.
        """
        arr = None
        if self.faults is not None:
            arr = np.asarray(logits)
            poisoned = self.faults.poison(phase, run.req.rid,
                                          len(run.tokens), arr)
            if poisoned is not None:
                arr = poisoned
                self.stats["fault_logit_poisons"] += 1
        if not self.check_finite:
            return True
        if arr is None:
            arr = np.asarray(logits)
        if bool(np.isfinite(arr).all()):
            return True
        if self.on_nonfinite == "raise":
            raise FloatingPointError(
                f"non-finite logits in {phase} rid={run.req.rid} "
                f"(quantization overflow or bad cache read)")
        return False

    def _quarantine(self, run: RunningRequest, where: str) -> None:
        """Contain one poisoned request: cancel it (full page
        reclamation, co-resident slots untouched), then requeue for a
        fresh attempt or degrade to the golden-baseline path."""
        rid = run.req.rid
        count = self._quarantine_counts.get(rid, 0) + 1
        self._quarantine_counts[rid] = count
        run.quarantines = count
        self.stats["quarantine_events"] += 1
        self.scheduler.cancel(run)
        if self.degrade and count >= self.degrade_after:
            self._degrade(run)
        elif self.degrade:
            # fresh retry on the fast path (a transient overflow may not
            # recur); the poisoned transcript is not trusted or resumed
            run.tokens = []
            self.scheduler.requeue(run.req)
            self.stats["quarantine_requeues"] += 1
        else:
            run.outcome = "quarantined"
            run.tokens = []
            run.finish_time = self.clock.now()
            self.finished.append(run)
            self.stats["quarantined"] += 1

    def _degrade(self, run: RunningRequest) -> None:
        """Re-run a repeatedly-quarantined request on the static plain
        path (dense cache, `oracle_generate`; greedy) and flag it: the
        answer arrives late and slow, but it arrives."""
        t0 = time.perf_counter()
        params = self.degrade_params if self.degrade_params is not None \
            else self.params
        toks = oracle_generate(
            params, self.cfg, run.req.prompt, run.req.max_new_tokens,
            self.kv.capacity,
            fns=self.runner.model_fns() if self.mesh is not None else None)
        self._charge(time.perf_counter() - t0)
        run.tokens = toks
        run.outcome = "degraded"
        run.finish_time = self.clock.now()
        if run.first_token_time is None:
            run.first_token_time = run.finish_time
        self.finished.append(run)
        self.stats["degraded"] += 1

    def _transient_failure(self, run: RunningRequest, what: str) -> None:
        """One failed dispatch: exponential backoff charged to the
        clock; persistent failure quarantines the request."""
        run.retries += 1
        self.stats["transient_faults"] += 1
        self._charge(self.retry_backoff_s * (2 ** (run.retries - 1)))
        if run.retries > self.max_retries:
            self._quarantine(run, f"{what} retries exhausted")

    def _apply_kv_flips(self, run: RunningRequest) -> None:
        """Apply scheduled bit flips inside this request's OWN pages
        (silent device-memory corruption; must never escape the page's
        owner).  The pool is flipped in place."""
        for spec in self.faults.kv_flips(run.req.rid):
            keys = sorted(
                buf_key(s, name) for s in self.kv.specs if s.kind == PAGED
                for name, _, _ in s.bufs)
            if not keys:
                continue
            key = spec.buf if spec.buf is not None else keys[0]
            pages = self.kv.slot_pages.get(run.slot, [])
            if not pages:
                continue
            page = pages[spec.page_index % len(pages)]
            paged.flip_bit(self.kv.pools[key], page,
                           spec.offset % self.kv.page_size, spec.bit)
            self.stats["fault_kv_bit_flips"] += 1

    def _shed(self, now: float) -> None:
        """Bounded-queue backpressure: arrivals that find `max_queue`
        requests already waiting are rejected (newest first — they
        found the queue full), not silently parked forever."""
        if self.max_queue is None:
            return
        sched = self.scheduler
        arrived = [r for r in sched.waiting if r.arrival_time <= now]
        while len(arrived) > self.max_queue:
            victim = max(arrived, key=lambda r: (r.arrival_time, r.rid))
            arrived.remove(victim)
            sched.waiting.remove(victim)
            sched.progress.pop(victim.rid, None)
            run = RunningRequest(req=victim, slot=-1, admitted_time=None)
            run.outcome = "shed"
            run.finish_time = now
            self.finished.append(run)
            self.stats["shed"] += 1

    def _record_timeouts(self, expired, now: float) -> None:
        for where, item in expired:
            run = item if where == "running" else \
                RunningRequest(req=item, slot=-1, admitted_time=None)
            run.outcome = "timeout"
            run.finish_time = now
            self.finished.append(run)
            self.stats["timeout"] += 1

    # -- compute units ------------------------------------------------------

    def _prefill_unit(self, run: RunningRequest) -> None:
        """Commit one prefill unit for `run`: the whole source (prompt
        plus any preemption-resumed tokens), or the next `prefill_chunk`
        positions.  The unit that commits the final source position also
        yields the request's next generated token."""
        if self.faults is not None and \
                self.faults.take_transient("prefill", run.req.rid):
            self._transient_failure(run, "prefill")
            return
        src = run.prefill_source
        try:
            if self.prefill_chunk is None:
                tok, logits = self._timed(
                    self.runner.prefill_commit, self.params, src, run.slot,
                    self._next_key())
                run.prefill_pos = len(src)
            else:
                c = min(self.prefill_chunk, len(src) - run.prefill_pos)
                chunk = src[run.prefill_pos:run.prefill_pos + c]
                tok, logits = self._timed(
                    self.runner.chunk_prefill_commit, self.params, chunk,
                    run.slot, self._next_key())
                run.prefill_pos += c
        except TransientComputeError:
            self._transient_failure(run, "prefill")
            return
        if self.faults is not None and run.prefill_done:
            self._apply_kv_flips(run)
        # "prefill"-phase poison fires only on the unit that completes
        # the prompt; intermediate chunks still get the finite check.
        phase = "prefill" if run.prefill_done else "prefill_chunk"
        if not self._screen(phase, run, logits):
            self._quarantine(run, "prefill")
            return
        if run.prefill_done:
            run.tokens.append(int(tok[0, 0]))
            if run.first_token_time is None:
                run.first_token_time = self.clock.now()

    def _lookahead(self, runs: List[RunningRequest]) -> int:
        """Fused steps this batch can run: bounded by the configured
        run-ahead and by every slot's cache headroom (a run-ahead past a
        request's token budget only wastes the tail — admission already
        guarantees the budgeted span fits, so headroom clamping keeps
        over-generation inside the slot's reserved pages).  Restricted
        to {1, decode_lookahead} so the compile cache stays one entry
        per bucket, not one per headroom value."""
        if self.decode_lookahead == 1:
            return 1
        headroom = min(
            self.kv.capacity
            - (len(r.prefill_source) + len(r.tokens)
               - len(r.resumed) - 1) for r in runs)
        return self.decode_lookahead \
            if headroom >= self.decode_lookahead else 1

    def _decode_once(self, runs: List[RunningRequest]) -> None:
        if self.faults is not None and \
                self.faults.take_transient("decode", None):
            # whole-step dispatch failure: nothing committed, the same
            # batch retries next iteration after a charged backoff
            self.stats["transient_faults"] += 1
            self._decode_fail_streak += 1
            for r in runs:
                r.retries += 1
            self._charge(self.retry_backoff_s
                         * (2 ** (self._decode_fail_streak - 1)))
            if self._decode_fail_streak > self.max_retries:
                raise RuntimeError(
                    f"decode step failed {self._decode_fail_streak} "
                    f"consecutive times; giving up")
            return
        slot_tokens = {r.slot: r.tokens[-1] for r in runs}
        if self.runner.graphs_off:
            self.stats["eager_decodes"] += 1
        try:
            out = self._timed(self.runner.decode_batch, self.params,
                              slot_tokens, self._next_key(),
                              self._lookahead(runs),
                              want_logits=self.check_finite
                              or self.faults is not None)
        except TransientComputeError:
            self.stats["transient_faults"] += 1
            self._decode_fail_streak += 1
            for r in runs:
                r.retries += 1
            self._charge(self.retry_backoff_s
                         * (2 ** (self._decode_fail_streak - 1)))
            return
        self._decode_fail_streak = 0
        by_slot = {r.slot: r for r in runs}
        for slot, (toks, logits) in out.items():
            run = by_slot[slot]
            if not self._screen("decode", run, logits):
                # quarantine ONLY this slot: its garbage lived in its
                # own reserved pages (freed by cancel); every other
                # slot's logits came off the same device step untouched
                self._quarantine(run, "decode")
                continue
            run.tokens.extend(toks)
            # run-ahead may overshoot the budget; the overshoot was
            # decoded into the slot's own reserved pages (freed at
            # retire) and is dropped from the transcript here.
            del run.tokens[run.req.max_new_tokens:]

    def _retire(self) -> None:
        now = self.clock.now()
        for run in [r for r in self.scheduler.running.values() if r.done]:
            self.scheduler.finish(run, now)
            run.outcome = "retried" if run.retries > 0 else "ok"
            self.stats[run.outcome] += 1
            self.finished.append(run)

    # -- main loop ----------------------------------------------------------

    def step(self) -> bool:
        """One engine iteration; returns False when fully idle."""
        sched = self.scheduler
        if self.faults is not None:
            self.faults.on_step(self)
        now = self.clock.now()
        self._record_timeouts(sched.expire(now), now)
        sched.admit(now)
        if sched.preempted_log:
            self.stats["preemptions"] += len(sched.preempted_log)
            sched.preempted_log.clear()
        self._shed(now)
        did = False
        run = sched.next_prefill()
        if run is not None:
            self._prefill_unit(run)
            did = True
        decoding = sched.decoding()
        if decoding:
            self._decode_once(decoding)
            did = True
        self._retire()
        if did:
            return True
        if sched.idle:
            return False
        # Nothing computable now: advance the clock to the next event —
        # an arrival, a deadline expiry, or a fault-plan state change
        # (e.g. a page-pressure spike releasing the pages the waiting
        # head needs).
        now = self.clock.now()
        events = []
        nxt = sched.next_arrival()
        if nxt is not None and nxt > now:
            events.append(nxt)
        dl = sched.next_deadline()
        if dl is not None and dl > now:
            events.append(dl + 1e-9)   # expiry is strict `now > deadline`
        if self.faults is not None:
            t = self.faults.next_event(now)
            if t is not None and t > now:
                events.append(t)
        if events:
            self.clock.wait_until(min(events))
            return True
        raise RuntimeError(
            "engine stalled: requests are waiting but cannot be admitted "
            "and no future event (arrival, deadline, fault release) can "
            "unblock them")

    def run(self) -> List[Dict]:
        """Serve until every submitted request reaches a terminal
        outcome; returns per-request records (tokens + timing +
        outcome) sorted by request id."""
        while self.step():
            pass
        if self.faults is not None:
            self.faults.release_all(self)
        recs = []
        for run in sorted(self.finished, key=lambda r: r.req.rid):
            req = run.req
            n = len(run.tokens)
            ttft = None if run.first_token_time is None \
                else run.first_token_time - req.arrival_time
            tpot = None
            if run.first_token_time is not None and n > 1 \
                    and run.finish_time is not None:
                tpot = (run.finish_time - run.first_token_time) / (n - 1)
            deadline_met = run.outcome in ("ok", "retried") and (
                req.deadline is None
                or (run.finish_time is not None
                    and run.finish_time <= req.deadline))
            recs.append({
                "rid": req.rid,
                "prompt_len": len(req.prompt),
                "tokens": list(run.tokens),
                "arrival_time": req.arrival_time,
                "admitted_time": run.admitted_time,
                "first_token_time": run.first_token_time,
                "finish_time": run.finish_time,
                "outcome": run.outcome or "ok",
                "deadline": req.deadline,
                "slo": req.slo.name if req.slo is not None else None,
                "ttft_s": ttft,
                "tpot_s": tpot,
                "deadline_met": deadline_met,
                "slo_met": (deadline_met and req.slo.met(ttft, tpot))
                if req.slo is not None else deadline_met,
                "retries": run.retries,
                "preemptions": run.preemptions,
                "quarantines": run.quarantines,
            })
        return recs
