"""Model runner: prefill and decode steps over the paged cache (port of
`repro.serving.runner`).

A decode step is gather -> compute -> commit -> sample on the device:

  gather  - block-table rows -> contiguous per-slot cache views
            (`kernels.paged.gather_pages`; dense ring rows and SSM state
            rows slice directly).  A view spans the slot's whole
            capacity, so one step serves every mix of request lengths:
            positions past a slot's `lengths` entry are outside the
            attention's valid span.
  compute - the port's UNCHANGED `decode_step`, `steps` times.  Its
            attention writes each new K/V in place, here into the view.
  commit  - scatter only the `steps` new positions of each active slot
            back to the pools (inactive padding rows to the dummy page
            0), write back the active rows of dense rings and SSM states
            whole, and advance `lengths` on the device.  Nothing else in
            the cache is copied or dequantized.
  sample  - argmax, or with a temperature the Gumbel-max draw
            argmax(logits / T + g), g from an explicit `torch.Generator`
            drawn into the step's input before it runs (the form of
            `jax.random.categorical`; the streams differ from JAX's).

Decode runs at power-of-two slot buckets; padding rows are distinct
parked slots whose view lengths are taken as 0 and whose commits are
masked.  On CUDA each `(bucket, steps)` step is ONE CUDA graph: on first
use the step runs once eagerly (that builds the kernel libraries and
makes the planners' and wrappers' one-time allocations), then it is
captured with `torch.cuda.graph` into one memory pool shared by all
buckets, and every later call copies its inputs into the graph's input
tensors and replays it.  The pools, `block_table` and `lengths` are the
graph's own tensors, updated in place.  A failed capture raises; nothing
falls back to eager.  On the CPU the same step function runs eagerly.
`check_graphs=True` holds each bucket's first replay bit for bit against
the eager run of the same step on the same inputs and state (outputs,
pools past page 0, dense rows, lengths) and raises if they differ.

Kernel wrappers count their launches on the host (`build.LAUNCHES`), so
a capture counts each of its kernels once and a replay not at all: the
runner keeps `captured` (the launches recorded into graphs) and
`replayed` (the same per replay), and the kernels that ran are
`LAUNCHES - captured + replayed`.

Prefill and chunked prefill run eagerly: their shapes follow the prompt.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import build, paged
from repro_torch.models.model import decode_step, init_cache, prefill
from .page_cache import DENSE, PAGED, PagedKVCache, SubSpec, buf_key


def gumbel_noise(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Gumbel(0, 1) draws from `gen`: -log of Exp(1) draws."""
    e = torch.empty(shape, dtype=torch.float32, device=device)
    return -e.exponential_(generator=gen).log()


def sample(logits: torch.Tensor, noise: Optional[torch.Tensor],
           temperature: float) -> torch.Tensor:
    """Next token (B, V) -> (B, 1) int32 on the device: argmax, or for
    temperature > 0 argmax(logits / temperature + noise)."""
    if temperature > 0:
        logits = logits / temperature + noise
    return torch.argmax(logits, -1).to(torch.int32)[:, None]


def build_view(specs: Sequence[SubSpec], pools, dense, block_table,
               lengths, slots, lens=None):
    """Reassemble the `init_cache`-shaped per-layer caches for a batch of
    slots -> (caches, stacked).

    Paged buffers gather their block-table pages into a contiguous
    capacity-long view, dense ring buffers and SSM states slice their
    slot rows;
    `stacked` holds each buffer's (reps, B, ...) copy, and the cache
    entry of the spec's r-th layer is its view [r], so the model's
    in-place writes land there.
    `len` is `lens` (default `lengths[slots]`) for every layer with a
    sequence axis (an SSM state has none).
    """
    if lens is None:
        lens = lengths[slots]
    n_layers = sum(spec.reps for spec in specs)
    caches: List[dict] = [dict() for _ in range(n_layers)]
    stacked: Dict[str, torch.Tensor] = {}
    for spec in specs:
        for name, _, _ in spec.bufs:
            k = buf_key(spec, name)
            if spec.kind == PAGED:
                stacked[k] = paged.gather_pages(pools[k], block_table[slots])
            else:
                stacked[k] = dense[k][:, slots]
            for r, l in enumerate(spec.layers):
                caches[l][name] = stacked[k][r]
        if spec.has_len:
            for l in spec.layers:
                caches[l]["len"] = lens
    return caches, stacked


def device_of(tree) -> torch.device:
    """The device of the first tensor in a parameter tree."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, (dict, list, tuple, torch.Tensor)):
            return device_of(v)
    raise ValueError("no tensor in the parameter tree")


def oracle_generate(params, cfg: ModelConfig, prompt: Sequence[int],
                    max_new_tokens: int, capacity: int) -> List[int]:
    """Static B=1 greedy generation on the plain serving path.

    The engine's graceful-degradation fallback: a request that is
    repeatedly quarantined on the paged path re-runs here, whole-prompt
    `prefill` and per-token `decode_step` on a fresh DENSE cache
    (`init_cache`, max_len = capacity), with no paged pools and no state
    shared with the engine's cache.  `params` may be the serving params
    or a separately quantized copy (the engine's `degrade_params`).
    """
    dev = device_of(params)
    caches = init_cache(cfg, 1, capacity, device=dev)
    logits, caches = prefill(
        params, torch.tensor([list(prompt)], dtype=torch.int64, device=dev),
        caches, cfg)
    toks = [int(torch.argmax(logits[0]))]
    for _ in range(max_new_tokens - 1):
        logits, caches = decode_step(
            params, torch.tensor([[toks[-1]]], dtype=torch.int32,
                                 device=dev), caches, cfg)
        toks.append(int(torch.argmax(logits[0])))
    return toks


def supports_chunked(specs: Sequence[SubSpec]) -> bool:
    """Chunked prefill needs offset-aware attention writes, which the
    chunk path implements for full-causal (non-windowed) layers only;
    SSM states carry across chunks natively."""
    return all(s.kind != DENSE for s in specs)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of t, for bit-for-bit comparison (NaN included)."""
    return t.contiguous().view(paged.INT_OF_WIDTH[t.element_size()])


class _DecodeGraph:
    """One captured decode step: its input tensors, graph and outputs."""

    def __init__(self, step, inputs: Dict[str, torch.Tensor], pool):
        self.inputs = inputs
        self.graph = torch.cuda.CUDAGraph()
        before = collections.Counter(build.LAUNCHES)
        with torch.cuda.graph(self.graph, pool=pool):
            self.outputs = step(**inputs)
        self.launches = collections.Counter(build.LAUNCHES) - before

    def replay(self, **values) -> Tuple[torch.Tensor, torch.Tensor]:
        for k, v in values.items():
            self.inputs[k].copy_(v)
        self.graph.replay()
        return self.outputs


class ModelRunner:
    """Step functions, CUDA graphs and in-place state for one engine."""

    def __init__(self, cfg: ModelConfig, kv: PagedKVCache,
                 temperature: float = 0.0, mesh=None,
                 check_graphs: bool = False):
        if mesh is not None:
            raise NotImplementedError(
                "mesh-native serving is not ported yet (ROADMAP.md queue "
                "1 item 6)")
        self.cfg = cfg
        self.kv = kv
        self.temperature = float(temperature)
        self.use_graphs = kv.device.type == "cuda"
        self.check_graphs = bool(check_graphs)
        self._graphs: Dict[Tuple[int, int], _DecodeGraph] = {}
        self._graph_params = None
        self._pool = None
        # Launches recorded into graphs, and the same per replay.
        self.captured: collections.Counter = collections.Counter()
        self.replayed: collections.Counter = collections.Counter()
        self.replays = 0
        # [{"bucket": (Bp, steps), "launches": {...}}] per capture, with
        # the check's verdict under check_graphs.
        self.graph_log: List[dict] = []
        # (slots, active) device operands keyed by batch composition: it
        # changes only on admission / retirement.
        self._comp_cache: Dict[Tuple[Tuple[int, ...], int], tuple] = {}

    # -- helpers -------------------------------------------------------------

    def _noise(self, key, shape) -> Optional[torch.Tensor]:
        if self.temperature <= 0:
            return None
        return gumbel_noise(key, shape, self.kv.device)

    def _fresh_cache(self, prompt_pad: int):
        """Zero B=1 caches for a whole-prompt prefill -> (caches,
        stacked): paged buffers sized to the page-rounded prompt, dense
        rings and SSM states at their engine shapes (rows write back
        verbatim)."""
        kv = self.kv
        n_layers = sum(spec.reps for spec in kv.specs)
        caches: List[dict] = [dict() for _ in range(n_layers)]
        stacked: Dict[str, torch.Tensor] = {}
        for spec in kv.specs:
            rows = ((prompt_pad,) if spec.kind == PAGED else
                    (spec.buf_len,) if spec.kind == DENSE else ())
            for name, tail, dtype in spec.bufs:
                k = buf_key(spec, name)
                stacked[k] = torch.zeros((spec.reps, 1) + rows + tail,
                                         dtype=dtype, device=kv.device)
                for r, l in enumerate(spec.layers):
                    caches[l][name] = stacked[k][r]
            if spec.has_len:
                for l in spec.layers:
                    caches[l]["len"] = torch.zeros(
                        (1,), dtype=torch.int32, device=kv.device)
        return caches, stacked

    def _tokens(self, toks: Sequence[int], shape) -> torch.Tensor:
        return torch.tensor(list(toks), dtype=torch.int64).reshape(
            shape).to(self.kv.device)

    # -- prefill (eager) -----------------------------------------------------

    def prefill_commit(self, params, prompt, slot: int, key):
        """Whole-prompt prefill into the slot's pages -> (first sampled
        token (1, 1), last-position logits (1, V)) on the host."""
        kv = self.kv
        prompt = [int(t) for t in prompt]
        S, ps = len(prompt), kv.page_size
        Sp = min(-(-S // ps) * ps, kv.capacity) if kv.has_paged else S
        fresh, stacked = self._fresh_cache(Sp)
        logits, _ = prefill(params, self._tokens(prompt, (1, S)), fresh,
                            self.cfg)
        nxt = sample(logits, self._noise(key, logits.shape),
                     self.temperature)
        bt_row = kv.block_table[slot]
        for spec in kv.specs:
            for name, _, _ in spec.bufs:
                k = buf_key(spec, name)
                if spec.kind == PAGED:
                    paged.scatter_pages(kv.pools[k], bt_row[:Sp // ps],
                                        stacked[k][:, 0])
                else:
                    kv.dense[k][:, slot] = stacked[k][:, 0]
        kv.lengths[slot] = S
        return nxt.cpu().numpy(), logits.cpu().numpy()

    def chunk_prefill_commit(self, params, chunk, slot: int, key):
        """One prompt chunk through the offset-aware prefill path ->
        (sampled token, logits) on the host; only the FINAL chunk's
        sample is the request's first generated token."""
        kv = self.kv
        chunk = [int(t) for t in chunk]
        C, ps = len(chunk), kv.page_size
        slots = torch.tensor([slot], dtype=torch.int64, device=kv.device)
        view, stacked = build_view(kv.specs, kv.pools, kv.dense,
                                   kv.block_table, kv.lengths, slots)
        logits, _ = prefill(params, self._tokens(chunk, (1, C)), view,
                            self.cfg, chunked=True)
        nxt = sample(logits, self._noise(key, logits.shape),
                     self.temperature)
        idxs = kv.lengths[slot].to(torch.int64) + torch.arange(
            C, device=kv.device)
        for spec in kv.specs:
            for name, _, _ in spec.bufs:
                k = buf_key(spec, name)
                if spec.kind == PAGED:
                    paged.scatter_positions(
                        kv.pools[k], kv.block_table[slot].long()[idxs // ps],
                        idxs % ps, stacked[k][:, 0, idxs])
                else:
                    kv.dense[k][:, slot] = stacked[k][:, 0]
        kv.lengths[slot] += C
        return nxt.cpu().numpy(), logits.cpu().numpy()

    # -- decode (one CUDA graph per bucket) -----------------------------------

    def _commit(self, stacked, slots, active, pos0, n: int) -> None:
        """Scatter the n new positions of every active row back to the
        pools (inactive rows to the dummy page 0), write back the active
        rows of dense rings and SSM states (inactive rows keep theirs),
        advance `lengths`.  Device-side only."""
        kv = self.kv
        ps, Bp = kv.page_size, slots.shape[0]
        idxs = pos0.to(torch.int64)[:, None] + torch.arange(
            n, device=kv.device)[None]                       # (Bp, n)
        rows = torch.arange(Bp, device=kv.device)[:, None]
        pages = torch.where(
            active[:, None],
            torch.gather(kv.block_table[slots].long(), 1, idxs // ps), 0)
        for spec in kv.specs:
            for name, _, _ in spec.bufs:
                k = buf_key(spec, name)
                nb = stacked[k]
                if spec.kind == PAGED:
                    paged.scatter_positions(kv.pools[k], pages, idxs % ps,
                                            nb[:, rows, idxs])
                else:
                    mask = active.reshape((1, Bp) + (1,) * (nb.ndim - 2))
                    kv.dense[k][:, slots] = torch.where(
                        mask, nb, kv.dense[k][:, slots])
        kv.lengths[slots] = kv.lengths[slots] + n * active.to(torch.int32)

    def _make_decode(self, params, n: int):
        """The decode step: gather the slot views once, run n feedback
        `decode_step`s, commit the n new positions per slot once.  Each
        step is the model's own decode on the same contiguous view a
        single-step call would see, so n steps give the logits of n
        separate calls."""
        kv, cfg, temperature = self.kv, self.cfg, self.temperature

        def step(tokens, slots, active, noise=None):
            lens = torch.where(active, kv.lengths[slots], 0)
            view, stacked = build_view(kv.specs, kv.pools, kv.dense,
                                       kv.block_table, kv.lengths, slots,
                                       lens=lens)
            toks, nxts, lgs = tokens, [], []
            for i in range(n):
                logits, view = decode_step(params, toks, view, cfg)
                toks = sample(logits, None if noise is None else noise[i],
                              temperature)
                nxts.append(toks)
                lgs.append(logits)
            self._commit(stacked, slots, active, lens, n)
            nxt = torch.where(active[None, :, None], torch.stack(nxts), 0)
            return nxt, torch.stack(lgs)

        return step

    def _state(self) -> Dict[str, torch.Tensor]:
        kv = self.kv
        out = {f"pool {k}": p[:, 1:].clone() for k, p in kv.pools.items()}
        out.update({f"dense {k}": d.clone() for k, d in kv.dense.items()})
        out["lengths"] = kv.lengths.clone()
        return out

    def _restore(self, state: Dict[str, torch.Tensor]) -> None:
        kv = self.kv
        for k, p in kv.pools.items():
            p[:, 1:] = state[f"pool {k}"]
        for k, d in kv.dense.items():
            d.copy_(state[f"dense {k}"])
        kv.lengths.copy_(state["lengths"])

    def _first_use(self, params, Bp: int, n: int,
                   inputs: Dict[str, torch.Tensor]):
        """Run the step eagerly, capture it, and (under check_graphs)
        hold the first replay against the eager run bit for bit."""
        step = self._make_decode(params, n)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static = {k: v.clone() for k, v in inputs.items()}
        if not self.check_graphs:
            out = step(**static)
            g = _DecodeGraph(step, static, self._pool)
            entry = {"bucket": (Bp, n), "launches": dict(g.launches)}
        else:
            before = self._state()
            want = tuple(t.clone() for t in step(**static))
            after = self._state()
            self._restore(before)
            g = _DecodeGraph(step, static, self._pool)
            out = g.replay()
            self._count(g)
            diffs = [name for name, a, b in
                     [("tokens", want[0], out[0]), ("logits", want[1], out[1])]
                     + [(k, v, s) for (k, v), s in
                        zip(after.items(), self._state().values())]
                     if not torch.equal(_bits(a), _bits(b))]
            entry = {"bucket": (Bp, n), "launches": dict(g.launches),
                     "identical": not diffs}
            if diffs:
                raise AssertionError(
                    f"decode graph ({Bp}, {n}): the replay differs from the "
                    f"eager step in {diffs}")
        self.captured.update(g.launches)
        self.graph_log.append(entry)
        self._graphs[(Bp, n)] = g
        return out

    def _count(self, g: _DecodeGraph) -> None:
        self.replayed.update(g.launches)
        self.replays += 1

    def decode_batch(self, params, slot_tokens: Dict[int, int], key,
                     steps: int = 1, want_logits: bool = True):
        """`steps` fused decode steps for every slot in `slot_tokens`.

        Pads the active set to a power-of-two bucket with DISTINCT parked
        slots, so there is one step (one graph) per (bucket size, steps),
        not per batch composition.  The caller guarantees every active
        slot has `steps` positions of cache headroom.  Returns {slot:
        (tokens, list[int] of length `steps`; logits np.ndarray (steps,
        V), or None without `want_logits`)}, each copied to the host in
        one transfer.
        """
        kv = self.kv
        act = sorted(slot_tokens)
        Bp = 1
        while Bp < len(act):
            Bp <<= 1
        Bp = min(Bp, kv.max_slots) if Bp > len(act) else Bp
        pad = [s for s in range(kv.max_slots) if s not in slot_tokens]
        slots = act + pad[:Bp - len(act)]
        comp = self._comp_cache.get((tuple(slots), len(act)))
        if comp is None:
            comp = (torch.tensor(slots, dtype=torch.int64, device=kv.device),
                    torch.tensor([True] * len(act)
                                 + [False] * (Bp - len(act)),
                                 device=kv.device))
            self._comp_cache[(tuple(slots), len(act))] = comp
        inputs = {"tokens": self._tokens(
                      [slot_tokens.get(s, 0) for s in slots], (Bp, 1)).to(
                      torch.int32),
                  "slots": comp[0], "active": comp[1]}
        noise = self._noise(key, (steps, Bp, self.cfg.vocab))
        if noise is not None:
            inputs["noise"] = noise
        if not self.use_graphs:
            nxt, logits = self._make_decode(params, steps)(**inputs)
        else:
            if params is not self._graph_params:
                self._graphs.clear()
                self._graph_params = params
            g = self._graphs.get((Bp, steps))
            if g is None:
                nxt, logits = self._first_use(params, Bp, steps, inputs)
            else:
                nxt, logits = g.replay(**inputs)
                self._count(g)
        nxt_h = nxt.cpu().numpy()                 # (steps, Bp, 1)
        logits_h = logits.cpu().numpy() if want_logits else None
        return {s: ([int(t) for t in nxt_h[:, i, 0]],
                    None if logits_h is None else logits_h[:, i])
                for i, s in enumerate(act)}
