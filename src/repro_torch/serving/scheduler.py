"""Request lifecycle + admission scheduling for the paged engine (a copy
of `repro.serving.scheduler`: pure Python, no device code).

The scheduler is deliberately host-side and deterministic: given the
same arrival trace it makes the same admission/eviction decisions, so
engine-vs-static parity tests can replay exact schedules.  Time comes
from an injected clock —

  * `WallClock`   — `time.perf_counter` based (NEVER `time.time()`: an
    NTP step mid-run would skew every latency/throughput number, which
    is exactly the bug the static path's reports had);
  * `VirtualClock` — advances only when told, so benchmarks can replay
    a Poisson arrival trace deterministically and tests never sleep.

Admission policies:

  * `fifo` (default) — head-of-line: a request is admitted when a slot
    is free AND the free list holds every page it could EVER need
    (`ceil((prompt + max_new_tokens) / page_size)`).  If the head does
    not fit, nothing behind it jumps the queue (no starvation of long
    requests).  Reserving the full page budget up front means an
    admitted request can never deadlock the engine mid-generation.
  * `edf` — earliest-deadline-first over the ARRIVED queue: requests
    carry absolute deadlines (explicit, or derived from an `SLOClass`),
    and the tightest deadline admits first.  With `preempt=True`, a
    deadline-bearing request that cannot fit may evict the running
    request with the LATEST deadline (strictly later than its own):
    eviction is free-list metadata (no cache copies), the victim's
    generated tokens are parked in `progress`, and re-admission
    re-prefills `prompt + generated` — the re-prefilled cache holds
    exactly the positions a continuous run would, so generation
    continues where it left off.

`expire(now)` enforces deadlines as timeouts: a waiting or running
request past its deadline is cancelled with FULL page reclamation and
reported to the engine for a `timeout` outcome.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple


class WallClock:
    """Monotonic real time; `wait_until` sleeps through idle gaps."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def wait_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)


class VirtualClock:
    """Deterministic clock for benchmarks/tests.

    `tick(dt)` accounts measured compute time; `wait_until` jumps over
    idle gaps instantly.  Arrival traces replay identically across runs.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def tick(self, dt: float) -> None:
        self._t += max(0.0, dt)

    def wait_until(self, t: float) -> None:
        self._t = max(self._t, t)


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A service-level objective class: TTFT/TPOT targets plus a
    relative completion deadline.  `deadline_for` turns the class into
    the absolute deadline the EDF policy and `expire` enforce."""
    name: str
    ttft_s: float = math.inf        # time to first token
    tpot_s: float = math.inf        # time per output token (after first)
    deadline_s: float = math.inf    # arrival -> completion budget

    def deadline_for(self, arrival: float, max_new_tokens: int
                     ) -> Optional[float]:
        budget = min(self.deadline_s,
                     self.ttft_s + self.tpot_s * max(0, max_new_tokens - 1))
        return arrival + budget if math.isfinite(budget) else None

    def met(self, ttft: Optional[float], tpot: Optional[float]) -> bool:
        if ttft is None:
            return False
        if ttft > self.ttft_s:
            return False
        return tpot is None or tpot <= self.tpot_s


# Presets for the CLI / benchmarks (seconds are virtual-clock seconds in
# deterministic runs, so these are traffic-mix knobs, not hardware facts).
SLO_CLASSES = {
    "interactive": SLOClass("interactive", ttft_s=0.5, tpot_s=0.1),
    "standard": SLOClass("standard", ttft_s=2.0, tpot_s=0.5),
    "batch": SLOClass("batch"),
}


@dataclasses.dataclass
class Request:
    """One submitted generation request (immutable intent)."""
    rid: int
    prompt: Sequence[int]
    max_new_tokens: int
    arrival_time: float = 0.0
    deadline: Optional[float] = None     # absolute; None = never expires
    slo: Optional[SLOClass] = None

    @property
    def total_len(self) -> int:
        # Prompt positions + cache growth during generation.  The final
        # sampled token is returned but never written to the cache, so
        # the cache span is prompt + (gen - 1) + the prefill position
        # itself; budgeting prompt + gen is the safe upper bound.
        return len(self.prompt) + self.max_new_tokens


@dataclasses.dataclass
class Progress:
    """Generation state parked across a preemption."""
    tokens: List[int]
    first_token_time: Optional[float]
    retries: int
    preemptions: int


@dataclasses.dataclass
class RunningRequest:
    """Engine-side state of an admitted request."""
    req: Request
    slot: int
    admitted_time: Optional[float]
    prefill_pos: int = 0            # source positions already committed
    tokens: List[int] = dataclasses.field(default_factory=list)
    resumed: List[int] = dataclasses.field(default_factory=list)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    retries: int = 0
    preemptions: int = 0
    quarantines: int = 0
    outcome: Optional[str] = None   # None while live; set at retirement

    @property
    def prefill_source(self) -> List[int]:
        """Positions the prefill must commit: the prompt, plus any
        tokens generated before a preemption (re-prefilling them
        rebuilds the exact cache a continuous run would hold)."""
        return list(self.req.prompt) + self.resumed

    @property
    def prefill_done(self) -> bool:
        return self.prefill_pos >= len(self.req.prompt) + len(self.resumed)

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.req.max_new_tokens


class Scheduler:
    """Admission scheduler over a `PagedKVCache` (FIFO or EDF).

    Owns the waiting queue and the running set; the engine asks it
    "admit whom?", "whose prefill next?", "who decodes?", "who expired?"
    each iteration.
    """

    def __init__(self, kv, max_slots: Optional[int] = None,
                 policy: str = "fifo", preempt: bool = False):
        if policy not in ("fifo", "edf"):
            raise ValueError(f"unknown admission policy {policy!r}")
        self.kv = kv
        self.max_slots = max_slots if max_slots is not None else kv.max_slots
        self.policy = policy
        self.preempt = bool(preempt)
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, RunningRequest] = {}   # slot -> state
        self.progress: Dict[int, Progress] = {}        # rid -> parked state
        self.preempted_log: List[Request] = []         # drained by engine
        self._rid = itertools.count()

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               arrival_time: float = 0.0,
               deadline: Optional[float] = None,
               slo: Optional[SLOClass] = None) -> Request:
        if deadline is None and slo is not None:
            deadline = slo.deadline_for(float(arrival_time),
                                        int(max_new_tokens))
        req = Request(rid=next(self._rid), prompt=list(prompt),
                      max_new_tokens=int(max_new_tokens),
                      arrival_time=float(arrival_time),
                      deadline=deadline, slo=slo)
        self.waiting.append(req)
        return req

    # -- admission ----------------------------------------------------------

    def _candidate(self, now: float) -> Optional[Request]:
        """Next request admission should consider, per policy."""
        if self.policy == "fifo":
            head = self.waiting[0] if self.waiting else None
            return head if head and head.arrival_time <= now else None
        arrived = [r for r in self.waiting if r.arrival_time <= now]
        if not arrived:
            return None
        return min(arrived, key=lambda r: (
            r.deadline if r.deadline is not None else math.inf,
            r.arrival_time, r.rid))

    def _fits(self, req: Request) -> bool:
        return len(self.running) < self.max_slots \
            and self.kv.can_admit(req.total_len)

    def _preempt_for(self, cand: Request) -> bool:
        """Evict latest-deadline decoding victims until `cand` fits.
        Only a candidate WITH a deadline may preempt, and only victims
        with strictly later (or no) deadlines are eligible."""
        if cand.deadline is None:
            return self._fits(cand)
        while not self._fits(cand):
            victims = [r for r in self.running.values()
                       if r.prefill_done and not r.done]
            victims = [r for r in victims
                       if (r.req.deadline is None
                           or r.req.deadline > cand.deadline)]
            if not victims:
                return False
            victim = max(victims, key=lambda r: (
                r.req.deadline if r.req.deadline is not None else math.inf,
                r.req.rid))
            self._park(victim)
        return True

    def _park(self, run: RunningRequest) -> None:
        """Preempt-by-eviction: pages release as free-list metadata,
        generated tokens park in `progress`, the request requeues."""
        self.progress[run.req.rid] = Progress(
            tokens=list(run.tokens),
            first_token_time=run.first_token_time,
            retries=run.retries, preemptions=run.preemptions + 1)
        self.kv.free(run.slot)
        del self.running[run.slot]
        self.waiting.append(run.req)
        self.preempted_log.append(run.req)

    def admit(self, now: float) -> List[RunningRequest]:
        """Admit requests under slot + page budget, per policy."""
        admitted = []
        while True:
            cand = self._candidate(now)
            if cand is None:
                break
            if not self._fits(cand):
                if not (self.policy == "edf" and self.preempt
                        and self._preempt_for(cand)):
                    break
            self.waiting.remove(cand)
            slot = self.kv.alloc(cand.total_len)
            run = RunningRequest(req=cand, slot=slot, admitted_time=now)
            prog = self.progress.pop(cand.rid, None)
            if prog is not None:
                run.resumed = list(prog.tokens)
                run.tokens = list(prog.tokens)
                run.first_token_time = prog.first_token_time
                run.retries = prog.retries
                run.preemptions = prog.preemptions
            self.running[slot] = run
            admitted.append(run)
        return admitted

    # -- queries ------------------------------------------------------------

    def next_prefill(self) -> Optional[RunningRequest]:
        """Oldest admitted request with source positions still uncommitted."""
        cands = [r for r in self.running.values() if not r.prefill_done]
        if not cands:
            return None
        return min(cands, key=lambda r: r.req.rid)

    def decoding(self) -> List[RunningRequest]:
        """Requests with a committed prompt and generation still to do."""
        return sorted(
            (r for r in self.running.values()
             if r.prefill_done and not r.done),
            key=lambda r: r.slot)

    def next_arrival(self) -> Optional[float]:
        if not self.waiting:
            return None
        return min(r.arrival_time for r in self.waiting)

    def next_deadline(self) -> Optional[float]:
        dls = [r.deadline for r in self.waiting if r.deadline is not None]
        dls += [r.req.deadline for r in self.running.values()
                if r.req.deadline is not None]
        return min(dls) if dls else None

    @property
    def idle(self) -> bool:
        return not self.running and not self.waiting

    # -- retirement / cancellation ------------------------------------------

    def finish(self, run: RunningRequest, now: float) -> None:
        run.finish_time = now
        self.kv.free(run.slot)
        del self.running[run.slot]

    def cancel(self, run: RunningRequest) -> None:
        """Remove a running request WITHOUT a finish record (quarantine
        or timeout): full page reclamation, no cache copies."""
        self.kv.free(run.slot)
        del self.running[run.slot]
        self.progress.pop(run.req.rid, None)

    def requeue(self, req: Request) -> None:
        """Resubmit a cancelled request for a fresh attempt (quarantine
        retry: progress intentionally NOT retained — the retry re-runs
        from scratch so a poisoned prefix is not trusted)."""
        self.progress.pop(req.rid, None)
        self.waiting.append(req)

    def expire(self, now: float) -> List[Tuple[str, object]]:
        """Cancel every waiting/running request past its deadline.

        Returns ("waiting", Request) / ("running", RunningRequest) pairs
        for the engine to record as `timeout` outcomes.  Pages of
        running victims reclaim fully; parked progress is dropped.
        """
        out: List[Tuple[str, object]] = []
        for req in [r for r in self.waiting
                    if r.deadline is not None and now > r.deadline]:
            self.waiting.remove(req)
            self.progress.pop(req.rid, None)
            out.append(("waiting", req))
        for run in [r for r in self.running.values()
                    if r.req.deadline is not None
                    and now > r.req.deadline]:
            self.cancel(run)
            out.append(("running", run))
        return out
