"""Paged KV cache: page pools, block tables, free-list admission (port of
`repro.serving.page_cache`).

The static path's `init_cache(cfg, B, max_len)` gives every request a
contiguous `(B, max_len)` cache slice for its whole lifetime.  This
module replaces the SEQUENCE axis of every full-causal attention cache
with a pool of fixed-size pages plus one per-slot block table:

    pool        (L, n_pages, page_size, *tail)   per cache buffer
    block_table (max_slots, pages_per_slot) int32  shared by all pools
    lengths     (max_slots,) int32                 valid span per slot

The port's caches are a list of per-layer dicts, so the L layers of a
dense model form one group (one `SubSpec`), the counterpart of the
reference's `reps` axis.  One free list allocates PAGE GROUPS: page id
`p` addresses the p-th page of every pool at once (all layers advance
in lockstep, so one block-table row serves the whole model).  Admission
pops `ceil((prompt + gen) / page_size)` ids; eviction pushes them back.
The VP words inside pages are never copied or dequantized by either.

Windowed (rolling ring) layers stay DENSE per-slot rows: their size is
bounded by the window and the ring arithmetic needs a contiguous buffer.

Page 0 is the dummy page (masked writes land there, nothing reads it);
the free list hands out ids 1..n_pages-1.  `n_pages` is sized from a
device byte budget when given, so "how many requests fit" is answered
at construction, not by an out-of-memory error at admission.

The pools, `block_table` and `lengths` are updated IN PLACE, never
reassigned: the runner's CUDA graphs read and write their memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import paged
from repro_torch.models.model import init_cache, layer_pattern, resolve_device

# Buffer kinds (the reference's SSM "state" rows come with its families) --
PAGED = "paged"      # full-causal attention cache: seq axis -> pages
DENSE = "dense"      # rolling / windowed ring buffer: per-slot dense rows


@dataclasses.dataclass(frozen=True)
class SubSpec:
    """Static plan of one group's cache storage."""
    gi: int                 # group index
    sub: str                # sub-layer key ("sub0")
    pattern: str
    kind: str               # PAGED | DENSE
    window: Optional[int]
    buf_len: int            # seq-buffer length
    reps: int               # layers in the group
    # (name, tail_shape, dtype) per buffer; tail = dims after the seq
    # axis.  "len" excluded.
    bufs: Tuple[Tuple[str, Tuple[int, ...], Any], ...]


def plan_cache(cfg: ModelConfig, capacity: int) -> List[SubSpec]:
    """Classify the model's caches: paged, or a dense ring.

    Uses `init_cache` itself (on the meta device: no allocation) as the
    single source of buffer names, shapes and dtypes.
    """
    if cfg.family == "encdec":
        raise ValueError(
            "paged serving does not support encoder-decoder models (the "
            "cross-attention source is request-specific; use the static "
            "path)")
    tmpl = init_cache(cfg, 1, capacity, device="meta")
    pattern, window = layer_pattern(cfg)
    entry = tmpl[0]
    names = sorted(n for n in entry if n != "len")
    return [SubSpec(
        gi=0, sub="sub0", pattern=pattern,
        kind=DENSE if window is not None else PAGED, window=window,
        buf_len=int(entry[names[0]].shape[1]), reps=len(tmpl),
        bufs=tuple((n, tuple(entry[n].shape[2:]), entry[n].dtype)
                   for n in names))]


def buf_key(spec: SubSpec, name: str) -> str:
    return f"g{spec.gi}.{spec.sub}.{name}"


def page_group_bytes(specs: List[SubSpec], page_size: int) -> int:
    """Device bytes one page id costs across ALL pools (the admission
    unit)."""
    total = 0
    for spec in specs:
        if spec.kind != PAGED:
            continue
        for _, tail, dtype in spec.bufs:
            elems = int(np.prod(tail, dtype=np.int64))
            total += (spec.reps * page_size * elems
                      * torch.empty((), dtype=dtype).element_size())
    return int(total)


class PagedKVCache:
    """Page pools + block table + free list for one serving engine.

    Device state (updated in place by the runner):
      pools        {buf_key: (L, n_pages, page_size, *tail)}
      dense        {buf_key: (L, max_slots, buf_len, *tail)}  ring buffers
      block_table  (max_slots, pages_per_slot) int32
      lengths      (max_slots,) int32

    Host state: the free-page list and per-slot page ownership.
    """

    def __init__(self, cfg: ModelConfig, max_slots: int, capacity: int,
                 page_size: int, n_pages: Optional[int] = None,
                 hbm_budget_bytes: Optional[int] = None, device="cuda"):
        if capacity % page_size:
            raise ValueError(
                f"capacity {capacity} must be a multiple of page_size "
                f"{page_size}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_slots = int(max_slots)
        self.capacity = int(capacity)
        self.page_size = int(page_size)
        self.pages_per_slot = capacity // page_size
        self.specs = plan_cache(cfg, capacity)
        self.bytes_per_page = page_group_bytes(self.specs, page_size)

        want = 1 + self.max_slots * self.pages_per_slot  # fully committed
        if n_pages is None:
            n_pages = want
            if hbm_budget_bytes is not None and self.bytes_per_page:
                n_pages = min(
                    n_pages, 1 + hbm_budget_bytes // self.bytes_per_page)
        if self.has_paged and n_pages < 1 + self.pages_per_slot:
            raise ValueError(
                f"page budget too small: {n_pages} pages "
                f"({self.bytes_per_page} B each) cannot hold even one "
                f"request of {self.pages_per_slot} pages + the dummy page")
        self.n_pages = int(n_pages)

        dev = self.device
        self.pools: Dict[str, torch.Tensor] = {}
        self.dense: Dict[str, torch.Tensor] = {}
        for spec in self.specs:
            for name, tail, dtype in spec.bufs:
                k = buf_key(spec, name)
                if spec.kind == PAGED:
                    self.pools[k] = torch.zeros(
                        (spec.reps, self.n_pages, page_size) + tail,
                        dtype=dtype, device=dev)
                else:
                    self.dense[k] = torch.zeros(
                        (spec.reps, max_slots, spec.buf_len) + tail,
                        dtype=dtype, device=dev)
        self.block_table = torch.zeros(
            (max_slots, self.pages_per_slot), dtype=torch.int32, device=dev)
        self.lengths = torch.zeros((max_slots,), dtype=torch.int32,
                                   device=dev)

        # Host-side allocator: LIFO free list over page ids 1..n_pages-1.
        self.free_pages: List[int] = list(range(self.n_pages - 1, 0, -1))
        self.slot_pages: Dict[int, List[int]] = {}
        self.free_slots: List[int] = list(range(max_slots - 1, -1, -1))
        self._reserved: set = set()   # withheld by reserve_pages

    # -- capacity queries ---------------------------------------------------

    @property
    def has_paged(self) -> bool:
        return any(s.kind == PAGED for s in self.specs)

    def pages_needed(self, total_len: int) -> int:
        if not self.has_paged:
            return 0
        return math.ceil(total_len / self.page_size)

    def can_admit(self, total_len: int) -> bool:
        if total_len > self.capacity:
            raise ValueError(
                f"request needs {total_len} positions > engine capacity "
                f"{self.capacity}")
        return bool(self.free_slots) \
            and self.pages_needed(total_len) <= len(self.free_pages)

    def hbm_bytes(self) -> int:
        """Bytes of pool + dense cache storage actually allocated."""
        return int(sum(
            a.numel() * a.element_size()
            for a in list(self.pools.values()) + list(self.dense.values())))

    # -- admission / eviction ----------------------------------------------

    def alloc(self, total_len: int) -> int:
        """Claim a slot + pages for a request of `total_len` positions.

        Returns the slot id.  The slot's dense rows are zeroed (a fresh
        request must not see the previous tenant's ring); its PAGES are
        handed over as they are: page contents are garbage until written,
        and every read is masked by `lengths` (the tests poison free
        pages to pin this).
        """
        n = self.pages_needed(total_len)
        if not self.free_slots or n > len(self.free_pages):
            raise RuntimeError("alloc called without can_admit")
        slot = self.free_slots.pop()
        pages = [self.free_pages.pop() for _ in range(n)]
        self.slot_pages[slot] = pages
        row = torch.zeros((self.pages_per_slot,), dtype=torch.int32)
        row[:n] = torch.tensor(pages, dtype=torch.int32)
        self.block_table[slot] = row.to(self.device)
        self.lengths[slot] = 0
        for spec in self.specs:
            if spec.kind == PAGED:
                continue
            for name, _, _ in spec.bufs:
                self.dense[buf_key(spec, name)][:, slot] = 0
        return slot

    def free(self, slot: int) -> None:
        """Evict a request: return its pages to the free list.

        Metadata only: no page contents move.  The block-table row is
        zeroed (points at the dummy page) so a stale row can never alias
        a page's next owner.
        """
        pages = self.slot_pages.pop(slot, [])
        self.free_pages.extend(reversed(pages))
        self.free_slots.append(slot)
        self.block_table[slot] = 0
        self.lengths[slot] = 0

    # -- external pressure (fault injection / co-tenant reservations) -------

    def reserve_pages(self, n: int) -> List[int]:
        """Withhold up to `n` free pages from the allocator (a device
        memory pressure spike: admissions back up while it holds).
        Returns the withheld ids; the caller MUST hand them back to
        `release_pages` unchanged."""
        take = min(int(n), len(self.free_pages))
        held = [self.free_pages.pop() for _ in range(take)]
        self._reserved.update(held)
        return held

    def release_pages(self, pages: List[int]) -> None:
        """Return pages withheld by `reserve_pages`."""
        for p in pages:
            if p not in self._reserved:
                raise ValueError(f"page {p} was not reserved")
            self._reserved.discard(p)
        self.free_pages.extend(reversed(pages))

    # -- invariants (chaos-suite assertions) --------------------------------

    def check_conservation(self) -> None:
        """Every page id 1..n_pages-1 is free, reserved, or owned by
        exactly one slot; raises on any leak, double free or aliasing.
        Quarantine, preemption, timeout and shed paths all promise this.
        """
        free = list(self.free_pages)
        if len(set(free)) != len(free):
            raise AssertionError("duplicate ids on the free list")
        owned: Dict[int, int] = {}
        for slot, pages in self.slot_pages.items():
            for p in pages:
                if p in owned:
                    raise AssertionError(
                        f"page {p} owned by slots {owned[p]} and {slot}")
                owned[p] = slot
        seen = set(free) | set(owned) | set(self._reserved)
        want = set(range(1, self.n_pages))
        if seen != want:
            leaked = sorted(want - seen)
            extra = sorted(seen - want)
            raise AssertionError(
                f"free-list conservation violated: leaked={leaked} "
                f"extra={extra}")
        if 0 in seen:
            raise AssertionError("dummy page 0 entered circulation")

    def page0_fingerprint(self) -> Dict[str, bytes]:
        """Host bytes of page 0 in every pool: nothing may READ page 0,
        and chaos tests snapshot it around faulted runs."""
        return {k: pool[:, 0].contiguous().view(torch.uint8).cpu()
                .numpy().tobytes() for k, pool in self.pools.items()}

    # -- debug/test helpers -------------------------------------------------

    def gather_slot(self, key: str, slot: int) -> torch.Tensor:
        """One slot's contiguous view of one pooled buffer (tests)."""
        bt = self.block_table[slot][None]
        return paged.gather_pages(self.pools[key], bt)[:, 0]
