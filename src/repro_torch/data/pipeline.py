"""Deterministic, resumable synthetic token pipeline (port of
`repro.data.pipeline`).

Batch i is a pure function of (seed, i, host): any host can regenerate
any batch, so resuming is setting the counter (stored in the checkpoint
manifest).  The tokens are Zipfian over the vocab with short-range
copies, so a model learns from them.  The generation is the reference's
numpy code, so the batches equal the reference's; only the last step
puts them on the device as torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.model import resolve_device


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    repeat_p: float = 0.3       # probability of a short-range copy


@dataclasses.dataclass
class DataState:
    """Checkpointable pipeline position."""
    batch_index: int = 0


class SyntheticLM:
    """Batches {"tokens", "labels"} (local_batch, seq_len) int32 on
    `device` (CUDA by default; raises without it unless given "cpu")."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1,
                 device="cuda"):
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} is not "
                             f"divisible by {n_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.device = resolve_device(device)
        self.local_batch = cfg.global_batch // n_hosts
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._cdf = np.cumsum(p / p.sum())

    def batch_at(self, index: int) -> Dict[str, torch.Tensor]:
        """Batch `index` of this host."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, index, self.host_id]))
        shape = (self.local_batch, cfg.seq_len + 1)
        u = rng.random(shape)
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        toks = np.minimum(toks, cfg.vocab - 1)
        copy = rng.random(shape) < cfg.repeat_p
        lag = rng.integers(1, 8, size=shape)
        idx = np.maximum(np.arange(cfg.seq_len + 1)[None, :] - lag, 0)
        toks = np.where(copy, np.take_along_axis(toks, idx, 1), toks)
        return {
            "tokens": torch.from_numpy(toks[:, :-1].copy()).to(self.device),
            "labels": torch.from_numpy(toks[:, 1:].copy()).to(self.device),
        }

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1

    def resume_iter(self, state: DataState):
        i = state.batch_index
        while True:
            yield self.batch_at(i), DataState(i + 1)
            i += 1
