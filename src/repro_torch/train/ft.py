"""Fault-tolerance driver: heartbeats, straggler mitigation, elastic
re-mesh (a copy of `repro.train.ft`, which is pure Python).

On a real fleet each host runs this controller around the training
loop; `launch/train.py --ft-sim` drives the same logic with a simulated
host set.  The mechanisms:

  * heartbeats: every host stamps a heartbeat each step; a host that
    misses more than `dead_after` beats is declared dead.
  * straggler mitigation: per-host step durations are tracked with an
    EMA; a host slower than `straggler_factor` x the median is marked a
    straggler and left out at the next elastic boundary.
  * elastic re-mesh: when the healthy set changes, propose the largest
    (pods, data, model) mesh that fits the survivors with the model axis
    kept, and restart from the latest checkpoint.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class HostState:
    host_id: int
    last_beat: float = 0.0
    step_ema: Optional[float] = None
    missed: int = 0
    alive: bool = True
    straggler: bool = False


@dataclasses.dataclass(frozen=True)
class FTConfig:
    dead_after: int = 3           # missed heartbeats before eviction
    straggler_factor: float = 2.0
    ema: float = 0.8
    min_hosts: int = 1


class FaultToleranceController:
    def __init__(self, n_hosts: int, cfg: FTConfig = FTConfig()):
        self.cfg = cfg
        self.hosts: Dict[int, HostState] = {
            i: HostState(i) for i in range(n_hosts)}
        self.generation = 0           # bumps on every elastic transition

    # ---- signals ------------------------------------------------------
    def heartbeat(self, host_id: int, step_duration: float,
                  now: Optional[float] = None):
        h = self.hosts[host_id]
        h.last_beat = time.monotonic() if now is None else now
        h.missed = 0
        if h.step_ema is None:
            h.step_ema = step_duration
        else:
            h.step_ema = (self.cfg.ema * h.step_ema
                          + (1 - self.cfg.ema) * step_duration)

    def tick(self):
        """One controller round: age heartbeats, classify hosts."""
        alive = [h for h in self.hosts.values() if h.alive]
        for h in alive:
            h.missed += 1
            if h.missed > self.cfg.dead_after:
                h.alive = False
        # straggler detection against the median EMA of live hosts
        emas = sorted(h.step_ema for h in alive
                      if h.alive and h.step_ema is not None)
        if emas:
            median = emas[len(emas) // 2]
            for h in alive:
                if h.alive and h.step_ema is not None:
                    h.straggler = h.step_ema > self.cfg.straggler_factor * median
        return self.healthy()

    def healthy(self) -> List[int]:
        return [i for i, h in self.hosts.items()
                if h.alive and not h.straggler]

    def topology_changed(self, previous: List[int]) -> bool:
        return set(previous) != set(self.healthy())

    # ---- elastic re-mesh ---------------------------------------------
    def propose_mesh(self, chips_per_host: int, model_axis: int,
                     multi_pod_hosts: Optional[int] = None
                     ) -> Tuple[int, int, int]:
        """Largest (pods, data, model) using the healthy hosts.

        Keeps `model_axis` fixed (weight shards must fit); data axis is the
        largest value such that pods*data*model <= healthy chips, power-of-
        two-friendly by truncation to the largest divisor.
        """
        n = len(self.healthy()) * chips_per_host
        if n < model_axis:
            raise RuntimeError(
                f"elastic: only {n} chips healthy, need >= {model_axis}")
        usable = n // model_axis           # data-parallel replicas
        if multi_pod_hosts:
            pods = max(1, usable // multi_pod_hosts)
        else:
            pods = 1
        data = usable // pods
        # largest power of two <= data (keeps collectives balanced)
        data = 1 << (data.bit_length() - 1)
        self.generation += 1
        return (pods, data, model_axis)


def run_with_restarts(train_loop, max_restarts: int = 3):
    """Crash-containment wrapper: rerun `train_loop` (which resumes from
    the latest checkpoint) until it completes or exhausts restarts."""
    for attempt in range(max_restarts + 1):
        try:
            return train_loop(attempt)
        except RuntimeError:                 # simulated node failure
            if attempt == max_restarts:
                raise
    return None
