"""Carry the reference's parameters across as numpy arrays.

`params_from_numpy` takes the JAX parameter tree of a model of any
family with every leaf converted to numpy (nested dicts and
lists, as `jax.tree_util.tree_map(np.asarray, params)` gives it), float
or exported by `quantize_params` (packed words, planes or block VP; QKV
biases, norms and SSM parameters as they are), and returns the port's
serving parameter dict.  The reference stacks each sub-layer of each
scanned group on a leading (repeats, ...) axis; here every layer is its
own entry, in the order the scans apply them (`model.layer_plan`): an
MoE layer's (L, E, d, ff) expert stacks and their (L, E) scales become
(E, d, ff) and (E,).  The hybrid's "shared_attn" is converted once and
every application of it in the list is that one dict (its tensors are
never copied).  An encoder-decoder's "encoder" and "cross" stacks
become one dict per layer, and its "enc_ln_g/b" and a VLM's
"patch_proj" are carried as they are.  `caches_from_numpy` does the
same for the reference's decode caches, where each application of the
shared block has its own cache in its group, an SSM layer its state
rows, and the encoder-decoder keeps [{"self": (L, ...) buffers}].
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from .model import SHARED, layer_plan, resolve_device

# family -> the top-level keys of its tree beside the LM's
EXTRA_KEYS = {"encdec": ("encoder", "cross", "enc_ln_g", "enc_ln_b"),
              "vlm": ("patch_proj",)}


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


def _per_layer(groups, cfg: ModelConfig, dev, shared=None) -> List[Any]:
    """The reference's stacked groups [{"sub{j}": (repeats, ...) tree}]
    -> one converted tree per layer of `layer_plan`.  With `shared` (a
    converted dict) the shared block's applications are that dict and
    the groups do not hold them (parameters); without it the groups do
    (caches)."""
    plan = layer_plan(cfg)
    want = {(s.gi, f"sub{s.sub}") for s in plan
            if shared is None or s.pattern != SHARED}
    have = {(gi, k) for gi, g in enumerate(groups) for k in g}
    if want != have:
        raise ValueError(f"the tree's groups {sorted(have)} are not the "
                         f"config's {sorted(want)}")
    return [shared if shared is not None and s.pattern == SHARED
            else _convert(groups[s.gi][f"sub{s.sub}"], dev, index=s.rep)
            for s in plan]


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    shared = _convert(tree[SHARED], dev) if SHARED in tree else None
    if (shared is None) != all(s.pattern != SHARED for s in layer_plan(cfg)):
        raise ValueError("the tree's shared block does not match the config")
    extra = EXTRA_KEYS.get(cfg.family, ())
    have = {k for k in tree if k in sum(EXTRA_KEYS.values(), ())}
    if have != set(extra):
        raise ValueError(f"the tree's keys {sorted(have)} are not the "
                         f"{cfg.family} config's {sorted(extra)}")
    out = {
        "embed": _convert(tree["embed"], dev),
        "final_norm": _convert(tree["final_norm"], dev),
        "lm_head": _convert(tree["lm_head"], dev),
        "layers": _per_layer(tree["groups"], cfg, dev, shared),
    }
    for key in extra:
        if key in ("encoder", "cross"):
            n = cfg.encoder_layers if key == "encoder" else cfg.n_layers
            out[key] = [_convert(tree[key], dev, index=i) for i in range(n)]
        else:
            out[key] = _convert(tree[key], dev)
    return out


def caches_from_numpy(caches: List[Dict[str, Any]], cfg: ModelConfig,
                      device="cuda") -> List[dict]:
    """The reference's decode caches (one dict per group of {"sub{j}":
    buffers with a leading repeats axis}, as numpy) -> the port's list of
    per-layer cache dicts."""
    if cfg.family == "encdec":
        caches = [{"sub0": caches[0]["self"]}]
    return _per_layer(caches, cfg, resolve_device(device))
