"""Launch plans: the shape-clamped default tiling, and the measured plan
cache with its resolution policy (port of `repro.kernels.autotune`).

  * `heuristic_blocks`: each axis `min(base, next_pow2(dim))`.  It is
    semantics, not tuning: the CSPADE paths of `mimo.mvm_engine` build
    their tile-activity masks on its grid.
  * `tune`: time candidate plans of one kernel on the card (a warm-up
    launch, then the median of `repeats` runs on CUDA events, the L2
    flushed before each; a sum over several benches where one plan
    serves several shapes), skip the ones the model of the card's limits
    (`analysis/smem.py`) rejects, take the earliest candidate (the
    heuristic first) within MARGIN of the fastest, keep it over the
    heuristic only if it still beats it by MARGIN timed in turns with
    it, and persist the plan in an on-disk JSON cache keyed by (kernel,
    shape, formats, device name, mesh).
  * `tuned`: what a planner reads: the cache's plan for a shape on a
    device, or None (then the planner's heuristic).  The planners that
    read it memoise their plans (`memoised_planner`) and `record` /
    `clear_cache` drop those memos, so a launch pays the planner's one
    lookup.

A plan is a tuple of ints whose meaning the planner that reads it fixes
(`vp_dequant_matmul.plan_skinny`: (split, k_per); `vp_attention.
plan_decode`: (cluster, warps)).  Only the CUDA wrappers read the cache:
the plain path on the CPU never reads or writes it.

Cache location: `$REPRO_TORCH_AUTOTUNE_CACHE` if set, else
`~/.cache/repro-vp-torch/autotune.json`.  Delete the file (or call
`clear_cache()`) to re-tune; every launch then takes its heuristic plan.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import statistics
import threading
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import torch

try:  # POSIX advisory file lock
    import fcntl
except ImportError:  # pragma: no cover
    fcntl = None

Blocks = Tuple[int, int, int]
Plan = Tuple[int, ...]
Bench = Callable[[Plan], None]

_BASE: Blocks = (256, 256, 256)
_ENV_VAR = "REPRO_TORCH_AUTOTUNE_CACHE"
# `tune` keeps the earliest candidate (the heuristic first) that reads
# within this share of the fastest: on an H100 80GB HBM3 at 700 W the
# skinny body's splits near the heuristic's read within 1-7 % of it, in
# either order, from one timing procedure or card to the next, and the
# decode body's fastest (cluster, warps) changed from run to run
# (PERF.md §6).
MARGIN = 0.03
# Rounds of the heuristic and the first pass's winner timed in turns
# before the winner replaces the heuristic: the first pass times the
# candidates seconds apart and keeps the luckiest of their readings (on
# the card a split 7.6 % slower than the heuristic in the chip_smoke
# Timer beat it by 3 % there).
CONFIRM_ROUNDS = 3

_lock = threading.Lock()
# path -> {key: [ints]}: the in-memory layer over the JSON file.
_caches: Dict[str, Dict[str, list]] = {}
# The memoised planners that read `tuned` (functools.lru_cache).
_planners: List[Callable] = []


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def heuristic_blocks(M: int, K: int, N: int, base: Blocks = _BASE) -> Blocks:
    """Each axis: `min(base, next_pow2(dim))`, so a dimension smaller
    than the base block gets one power-of-two tile covering it."""
    return (
        min(base[0], _pow2_at_least(max(M, 1))),
        min(base[1], _pow2_at_least(max(K, 1))),
        min(base[2], _pow2_at_least(max(N, 1))),
    )


# ---------------------------------------------------------------------------
# Cache plumbing
# ---------------------------------------------------------------------------

def cache_path() -> str:
    """The on-disk cache file (env override, else ~/.cache)."""
    env = os.environ.get(_ENV_VAR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-vp-torch",
                        "autotune.json")


def _is_plan(v) -> bool:
    return (isinstance(v, (list, tuple)) and len(v) > 0
            and all(isinstance(x, int) and not isinstance(x, bool)
                    for x in v))


def _read(path: str) -> Dict[str, list]:
    """The file's entries that are plans; {} if it is missing or corrupt."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(raw, dict):
        return {}
    return {k: list(v) for k, v in raw.items() if _is_plan(v)}


def _load(path: str) -> Dict[str, list]:
    with _lock:
        if path not in _caches:
            _caches[path] = _read(path)
        return _caches[path]


def _save(path: str, data: Dict[str, list]) -> None:
    """Write a temporary file, then rename it over the cache: a reader
    never sees a half-written file."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


@contextlib.contextmanager
def _file_lock(path: str):
    """Cross-process lock around a read-merge-write cycle, on a sidecar
    `<path>.lock` (the data file is replaced by rename, which would
    orphan a lock on its inode).  A no-op where `fcntl` is missing."""
    if fcntl is None:
        yield
        return
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(f"{path}.lock", "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


def memoised_planner(planner: Callable) -> Callable:
    """Register an lru-cached planner that reads `tuned`: `record` and
    `clear_cache` clear its memo."""
    _planners.append(planner)
    return planner


def _drop_plans() -> None:
    for planner in _planners:
        planner.cache_clear()


def clear_cache() -> None:
    """Drop the cache file, the in-memory layer and the memoised plans."""
    path = cache_path()
    with _lock:
        _caches.pop(path, None)
        _drop_plans()
    try:
        os.remove(path)
    except OSError:
        pass


_mesh_local = threading.local()
_MESH_DESC = re.compile(r"^(\D+?)(\d+)\.(\w+)$")


@contextlib.contextmanager
def mesh_scope(desc: str):
    """Tag the launches inside with the mesh and shard geometry, e.g.
    `model2.N` (the weights' output dim N cut 2 ways over "model") or
    `model2.H` (the heads cut 2 ways): the reference's scope.

    Entered by the sharded paths (`parallel.shard_ops`, `layers.qdot`
    under `QuantConfig.tp_axis`) around each shard's kernel launch.
    Inside it `make_key` appends `|mesh=<desc>`, so a plan tuned on a
    shard's operand never replaces the unsharded shape's entry; and the
    planners that choose a summation order from a dim the shard cuts
    plan it from the unsharded size instead (`unsharded`), reading the
    cache under the unsharded shape's key: a shard sums each output in
    the unsharded launch's order, so the concatenated shards equal the
    unsharded launch bit for bit."""
    prev = getattr(_mesh_local, "desc", None)
    _mesh_local.desc = str(desc)
    try:
        yield
    finally:
        _mesh_local.desc = prev


def mesh_desc(mesh, axis: str = "model", spec: str = "N") -> str:
    """The scope string of a mesh dim and shard spec, e.g. `model8.N`
    (`mesh` a DeviceMesh with named dims)."""
    names = tuple(mesh.mesh_dim_names or ())
    size = mesh.size(names.index(axis)) if axis in names else 1
    return f"{axis}{size}.{spec}"


def current_mesh_desc() -> str:
    return getattr(_mesh_local, "desc", None) or "1"


def unsharded(spec: str, n: int) -> int:
    """`n`, a launch's size along the dim that shard spec `spec` ("N":
    the weights' output columns; "H": the attention heads) names, as the
    unsharded launch sees it: times the scope's shard count where the
    active `mesh_scope` cuts that dim, else `n`."""
    m = _MESH_DESC.match(current_mesh_desc())
    if m is None or m.group(3) != spec:
        return n
    return n * int(m.group(2))


def make_key(kernel: str, shape: Sequence[int], formats: Sequence,
             backend: str, mesh: Optional[str] = None) -> str:
    """`kernel|dims|fmts|backend|mesh=<m>`, the reference's key: `shape`
    the dims the plan depends on, `formats` FXPFormat / VPFormat (their
    reprs are stable), `backend` the device's name, `mesh` the mesh and
    shard geometry (default: the active `mesh_scope`'s, "1" outside
    any)."""
    fmts = ",".join(repr(f) for f in formats)
    dims = "x".join(str(int(d)) for d in shape)
    seg = mesh if mesh is not None else current_mesh_desc()
    return f"{kernel}|{dims}|{fmts}|{backend}|mesh={seg}"


def entries() -> Dict[str, Plan]:
    """Every plan in the cache, by key."""
    return {k: tuple(v) for k, v in _load(cache_path()).items()}


def get_cached(key: str) -> Optional[Plan]:
    v = _load(cache_path()).get(key)
    return tuple(v) if v else None


def record(key: str, plan: Plan) -> None:
    """Persist one entry, merged with what is on disk now: the cycle runs
    under the thread lock and the file lock, then writes through a
    rename, so writers in other threads or processes keep their
    entries."""
    path = cache_path()
    mem = _load(path)
    with _lock, _file_lock(path):
        fresh = _read(path)
        fresh.update(mem)
        fresh[key] = [int(x) for x in plan]
        _caches[path] = fresh
        _drop_plans()
        _save(path, fresh)


@functools.lru_cache(maxsize=None)
def backend_name(device: Union[int, torch.device]) -> str:
    """The key's backend for a CUDA device (or its index): its name."""
    return torch.cuda.get_device_name(device)


def cuda_index(device: torch.device) -> Optional[int]:
    """The CUDA index of `device`, the planners' argument for reading the
    cache; None off the card (the plain path reads no cache)."""
    if device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None \
        else device.index


def tuned(kernel: str, shape: Tuple[int, ...], formats: Tuple,
          device: int) -> Optional[Plan]:
    """The cache's plan for a launch of `kernel` at `shape` on CUDA
    device `device` (an index), or None.  Not memoised: a planner that
    reads it memoises its own plan (`memoised_planner`), so the cache
    file's path is read at the first launch after a `record` or
    `clear_cache`: call `clear_cache()` after pointing
    `REPRO_TORCH_AUTOTUNE_CACHE` elsewhere.  Always the unsharded entry
    (`mesh=1`): inside a `mesh_scope` a planner passes the unsharded
    shape, and a plan tuned on a shard never changes a shard's sums."""
    return get_cached(make_key(kernel, shape, formats, backend_name(device),
                               mesh="1"))


# ---------------------------------------------------------------------------
# Measured tuning
# ---------------------------------------------------------------------------

def event_timer(device: Optional[torch.device] = None
                ) -> Callable[[Callable[[], None]], float]:
    """A timer of one call on the card: an L2 flush (a write of four
    times its size, as a decode step finds its weights cold), a spin
    kernel of ~0.5 ms that outlasts the host's enqueue of the call, then
    the seconds between two CUDA events around it.  Made after ~0.1 s of
    spinning: a card idle before tuning reads its first candidates slow
    while its clocks come up."""
    size = torch.cuda.get_device_properties(device).L2_cache_size
    flush = torch.empty(max(size, 1), dtype=torch.float32, device=device)
    torch.cuda._sleep(200_000_000)
    torch.cuda.synchronize(device)

    def time_one(fn: Callable[[], None]) -> float:
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    return time_one


def tune(kernel: str, shape: Sequence[int], formats: Sequence, backend: str,
         bench_fn: Union[Bench, Sequence[Bench]], candidates: Iterable[Plan],
         repeats: int = 3,
         timer: Optional[Callable[[Callable[[], None]], float]] = None
         ) -> Plan:
    """Time `bench_fn(plan)` over `candidates`, persist and return the
    fastest.  A cached entry is returned without timing anything.

    `bench_fn` may be a sequence (a decode profile's batch sizes): each
    is timed on its own, each finding the L2 cold as the decode step
    does, and a candidate's time is the sum of their times.  Candidates
    that `analysis/smem.py` rejects for this kernel (shared memory,
    threads, cluster size or registers past the card's limits) are never
    timed.  Every other candidate gets a warm-up call of each bench, then
    `repeats` timed calls in a row (`timer`, default `event_timer()`),
    whose median is the bench's time (the reference takes the minimum,
    which on the card ranks the skinny body's splits otherwise than a
    median of 20); one that raises loses.  The winner is the earliest
    candidate that launched and reads within MARGIN of the fastest: the
    planner's heuristic, which the candidate lists put first, where it
    is that close, and otherwise the same plan from one tuning run to
    the next wherever the leaders sit within the timer's spread (a plan
    fixes the order of a row's sums, so it fixes the served tokens).
    A winner other than the first candidate is then timed with it in
    turns, CONFIRM_ROUNDS rounds, and replaces it only if its median
    still beats the first's by MARGIN.  Raises when every candidate is
    rejected or fails.
    """
    from repro_torch.analysis import smem

    key = make_key(kernel, shape, formats, backend)
    cached = get_cached(key)
    if cached is not None:
        return cached
    benches = [bench_fn] if callable(bench_fn) else list(bench_fn)
    cands = [tuple(c) for c in candidates]
    feasible = [c for c in cands
                if smem.plan_feasible(kernel, c, shape, formats)[0]]
    if not feasible:
        raise RuntimeError(f"autotune: every candidate plan for {key} "
                           f"exceeds the card's limits (analysis/smem.py): "
                           f"{cands}")
    timer = timer or event_timer()

    def read(plan: Plan) -> float:
        return sum(statistics.median(timer(lambda: bench(plan))
                                     for _ in range(repeats))
                   for bench in benches)

    score: Dict[Plan, float] = {}
    last_err: Optional[Exception] = None
    for plan in feasible:
        try:
            for bench in benches:
                bench(plan)
            score[plan] = read(plan)
        except (RuntimeError, ValueError) as e:   # a launch that fails loses
            last_err = e
    if not score:
        raise RuntimeError(f"autotune: all {len(feasible)} feasible "
                           f"candidates failed for {key}; last error: "
                           f"{last_err!r}") from last_err
    fastest = min(score.values())
    best = next(p for p, t in score.items() if t <= fastest * (1 + MARGIN))
    first = next(iter(score))
    if best != first:
        turns: Dict[Plan, list] = {first: [], best: []}
        for _ in range(CONFIRM_ROUNDS):
            for plan in turns:
                turns[plan].append(read(plan))
        if statistics.median(turns[best]) * (1 + MARGIN) >= \
                statistics.median(turns[first]):
            best = first
    record(key, best)
    return best
