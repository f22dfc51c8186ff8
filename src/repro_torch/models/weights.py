"""Carry the reference's parameters across as numpy arrays.

`params_from_numpy` takes the JAX parameter tree of a dense model with
every leaf converted to numpy (nested dicts and lists, as
`jax.tree_util.tree_map(np.asarray, params)` gives it), float or
exported by `quantize_params`, and returns the port's parameter dict.
The reference stacks each scanned layer group on a leading (L, ...)
axis; here every layer is its own entry.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from .model import _check_family, resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16: carry the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _convert(node, device, index=None):
    """Dicts/lists of arrays -> tensors; `index` picks one layer of a
    stacked leaf."""
    if isinstance(node, dict):
        return {k: _convert(v, device, index) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, device, index) for v in node]
    a = np.asarray(node)
    return _tensor(a if index is None else a[index], device)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device="cuda") -> Dict[str, Any]:
    _check_family(cfg)
    dev = resolve_device(device)
    if len(tree["groups"]) != 1 or set(tree["groups"][0]) != {"sub0"}:
        raise ValueError("a dense model has one scanned group of one "
                         "sub-layer")
    stacked = tree["groups"][0]["sub0"]
    return {
        "embed": _convert(tree["embed"], dev),
        "final_norm": _convert(tree["final_norm"], dev),
        "lm_head": _convert(tree["lm_head"], dev),
        "layers": [_convert(stacked, dev, index=l)
                   for l in range(cfg.n_layers)],
    }
