"""Deterministic fault injection (chaos harness) for the serving engine
(a copy of `repro.serving.faults`; the bit flip goes through the port's
in-place `kernels.paged.flip_bit`).

Production traffic punishes an engine in ways a clean benchmark never
does: a request quantizes to the edge of its VP format and emits NaN
logits, an HBM word takes a bit flip, a co-tenant grabs the page pool,
a device enqueue transiently fails, a step straggles.  The paper's whole
premise is operating near the edge of a format's dynamic range, so
overflow/NaN escapes from the packed path are an *expected operating
condition* — this module makes every such condition reproducible.

A `FaultPlan` is a list of fault events the engine consults at fixed
hook points.  Every event is host-side and deterministic (keyed on
request ids, token counts, and the injected clock), so a chaos run
replays identically and the chaos suite can assert bit-identical tokens
for every UNAFFECTED request against the fault-free run.

Fault classes:

  * `LogitPoison`     — overwrite one request's host-side logits with
                        NaN/Inf after the device step returns.  The
                        device computation is untouched, so co-resident
                        slots stay bit-identical; the engine's per-slot
                        finite check then quarantines only the victim.
  * `KVBitFlip`       — XOR one bit of one packed KV word inside a page
                        OWNED by the victim request (via
                        `kernels.paged.flip_bit`).  Silent corruption:
                        VP dequant of any word pattern is finite, so no
                        check fires — the chaos suite instead proves the
                        corruption never escapes the owning request's
                        pages.
  * `PagePressure`    — temporarily withhold free pages from the
                        allocator (an HBM co-tenant spike): admissions
                        back up, the bounded submit queue sheds.
  * `TransientFault`  — fail a prefill/decode dispatch before it runs
                        (`TransientComputeError`); the engine retries
                        with backoff charged to the clock.
  * `SlowStep`        — charge extra seconds to the virtual clock at a
                        chosen time (a straggling step); deadlines and
                        SLOs must keep being honored.

Counters for everything injected land on `engine.stats`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class TransientComputeError(RuntimeError):
    """A dispatch failed transiently; the caller may retry."""


@dataclasses.dataclass(frozen=True)
class LogitPoison:
    """Poison request `rid`'s logits once it has `after_tokens` tokens.

    `phase` selects the hook ("prefill" fires on the unit that completes
    the prompt; "decode" on decode steps).  `times` bounds how many
    engine passes get poisoned — a retried request sails through once
    the budget is spent, which is how retry-then-succeed scenarios are
    scripted.
    """
    rid: int
    phase: str = "decode"           # "prefill" | "decode"
    after_tokens: int = 0
    value: float = math.nan
    times: int = 1_000_000          # effectively "always"


@dataclasses.dataclass(frozen=True)
class KVBitFlip:
    """Flip `bit` of the word at (`page_index`, `offset`) of `rid`'s
    pages, in pool buffer `buf` (default: first pooled buffer), once the
    request's prompt is committed."""
    rid: int
    page_index: int = 0
    offset: int = 0
    bit: int = 0
    buf: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class PagePressure:
    """Withhold up to `pages` free pages during [`at`, `release`)."""
    at: float
    release: float
    pages: int


@dataclasses.dataclass(frozen=True)
class TransientFault:
    """Fail the next `times` dispatches of `kind` ("prefill" targets
    request `rid`; "decode" fails the whole batched step — rid ignored)."""
    kind: str = "decode"            # "prefill" | "decode"
    rid: Optional[int] = None
    times: int = 1


@dataclasses.dataclass(frozen=True)
class SlowStep:
    """Charge `extra_s` virtual seconds at the first step with
    `now >= at` (a straggling dispatch / preemption by a co-tenant)."""
    at: float
    extra_s: float


class FaultPlan:
    """A deterministic schedule of fault events, consumed by the engine.

    Construction takes any mix of the event dataclasses above.  The plan
    carries its own mutable consumption state; `reset()` rearms every
    event for a fresh wave.
    """

    def __init__(self, events: Sequence = ()):
        self.poisons: List[LogitPoison] = []
        self.flips: List[KVBitFlip] = []
        self.pressure: List[PagePressure] = []
        self.transients: List[TransientFault] = []
        self.slow: List[SlowStep] = []
        for ev in events:
            if isinstance(ev, LogitPoison):
                self.poisons.append(ev)
            elif isinstance(ev, KVBitFlip):
                self.flips.append(ev)
            elif isinstance(ev, PagePressure):
                self.pressure.append(ev)
            elif isinstance(ev, TransientFault):
                self.transients.append(ev)
            elif isinstance(ev, SlowStep):
                self.slow.append(ev)
            else:
                raise TypeError(f"unknown fault event {ev!r}")
        self.reset()

    def reset(self) -> None:
        """Rearm every event (held pages must have been released —
        i.e. call between engine waves, not mid-run)."""
        self._poison_used: Dict[int, int] = {}
        self._flip_done: set = set()
        self._transient_used: Dict[int, int] = {}
        self._slow_done: set = set()
        # id -> (spec, held page ids); pages outstanding only mid-spike
        self._held: Dict[int, Tuple[PagePressure, List[int]]] = {}

    # -- engine hook: once per engine iteration -----------------------------

    def on_step(self, engine) -> None:
        """Advance time-keyed faults: engage/release page-pressure
        spikes and charge slow-step stalls."""
        now = engine.clock.now()
        for i, spec in enumerate(self.slow):
            if i not in self._slow_done and now >= spec.at:
                self._slow_done.add(i)
                if hasattr(engine.clock, "tick"):
                    engine.clock.tick(spec.extra_s)
                else:  # wall clock: model the stall as a sleep-through
                    engine.clock.wait_until(now + spec.extra_s)
                engine.stats["fault_slow_steps"] += 1
        for i, spec in enumerate(self.pressure):
            held = self._held.get(i)
            if held is None and now >= spec.at and now < spec.release:
                pages = engine.kv.reserve_pages(spec.pages)
                self._held[i] = (spec, pages)
                engine.stats["fault_page_spikes"] += 1
            elif held is not None and now >= spec.release:
                engine.kv.release_pages(held[1])
                self._held[i] = (spec, [])
                if not held[1]:
                    pass  # already drained
        # fully-released spikes keep an empty entry so they never rearm

    def next_event(self, now: float) -> Optional[float]:
        """Earliest future time a time-keyed fault changes state — the
        engine waits for this when otherwise stalled (e.g. a spike holds
        every page the waiting request needs)."""
        times = []
        for i, spec in enumerate(self.pressure):
            held = self._held.get(i)
            if held is None and spec.at > now:
                times.append(spec.at)
            elif held is not None and held[1] and spec.release > now:
                times.append(spec.release)
        for i, spec in enumerate(self.slow):
            if i not in self._slow_done and spec.at > now:
                times.append(spec.at)
        return min(times) if times else None

    def release_all(self, engine) -> None:
        """Return any still-held pages (end-of-run conservation)."""
        for i, (spec, pages) in list(self._held.items()):
            if pages:
                engine.kv.release_pages(pages)
                self._held[i] = (spec, [])

    # -- engine hook: dispatch failures -------------------------------------

    def take_transient(self, kind: str, rid: Optional[int]) -> bool:
        """True if this dispatch should fail (consumes one failure)."""
        for i, spec in enumerate(self.transients):
            if spec.kind != kind:
                continue
            if kind == "prefill" and spec.rid is not None and spec.rid != rid:
                continue
            used = self._transient_used.get(i, 0)
            if used < spec.times:
                self._transient_used[i] = used + 1
                return True
        return False

    # -- engine hook: host-side logit poisoning -----------------------------

    def poison(self, phase: str, rid: int, n_tokens: int,
               logits: np.ndarray) -> Optional[np.ndarray]:
        """Poisoned copy of `logits` if an event matches, else None.

        Host-side only: the device computation (and every other slot's
        logits) is untouched.
        """
        for i, spec in enumerate(self.poisons):
            if spec.rid != rid or spec.phase != phase:
                continue
            if n_tokens < spec.after_tokens:
                continue
            used = self._poison_used.get(i, 0)
            if used >= spec.times:
                continue
            self._poison_used[i] = used + 1
            out = np.array(logits, copy=True)
            out.flat[0] = spec.value
            return out
        return None

    # -- engine hook: cache corruption --------------------------------------

    def kv_flips(self, rid: int) -> List[KVBitFlip]:
        """Un-consumed bit flips targeting `rid` (consumed once each)."""
        out = []
        for i, spec in enumerate(self.flips):
            if spec.rid == rid and i not in self._flip_done:
                self._flip_done.add(i)
                out.append(spec)
        return out

    @property
    def holding_pages(self) -> int:
        return sum(len(p) for _, p in self._held.values())
