"""Serving-side profiling helpers: panel discovery and decode autotuning
(port of `repro.serving.profile`).

`tune_decode_profile` times the launch plans of the two decode kernels a
serving process runs most, at the shapes this model gives them, and
persists the fastest in the plan cache (`kernels.autotune`), which the
wrappers then read at every launch:

  * the skinny `vp_dequant_matmul` body over every packed weight panel
    (K, N): its split of K, (split, k_per), one plan for every decode
    batch (the split fixes the order of a row's sums, so a plan chosen
    per M would make a row's bits depend on its batch), scored by the
    sum of its times at M = 1, 2, 4, ... up to the batch, each launch
    finding the weights cold;
  * the split `vp_decode_attention` body over the model's cache
    geometries (buffer length, window, ring) with a packed VP KV cache:
    its (cluster, warps), at the serving batch (the batch does not enter
    the plan).

Timed operands are random words and activations drawn from one
`torch.Generator` seeded with `seed`, each tensor its own draw (the
reference folds a key per panel).  On the CPU nothing is timed: the
plain path does not read the cache.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core.packing import storage_dtype
from repro_torch.models.layers import canonical_formats
from repro_torch.models.model import layer_groups, model_dtype

REPEATS = 7   # timed launches per candidate and bench (the median counts)


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _leaves(v)
    elif isinstance(node, torch.Tensor):
        yield node


def quantized_bytes(params) -> int:
    """Bytes of integer serving storage (packed words, significand and
    index planes; the f32 scales are not counted), each tensor once (the
    hybrid's shared block appears at each of its applications)."""
    seen = {id(t): t for t in _leaves(params)
            if not (t.is_floating_point() or t.is_complex()
                    or t.dtype == torch.bool)}
    return sum(t.numel() * t.element_size() for t in seen.values())


def weight_panels(params) -> List[Tuple[int, int]]:
    """Distinct (d_in, d_out) of every packed weight that feeds the
    serving matmul.  The embedding table is left out: it is read by a row
    gather, never by `vp_dequant_matmul` (lm_head's (d, vocab) is the
    panel that counts)."""
    panels = set()

    def walk(node, name=""):
        if isinstance(node, dict):
            if "w_packed" in node:
                if name != "embed":
                    w = node["w_packed"]
                    panels.add((int(w.shape[-2]), int(w.shape[-1])))
                return
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, list):
            for v in node:
                walk(v, name)

    walk(params)
    return sorted(panels)


def attn_cache_geometries(cfg, max_len: int) -> List[Tuple[int, int, bool]]:
    """Distinct decode-attention cache geometries of the model's layer
    plan, (buf_len, window, rolling) per attention pattern: the shapes
    `attn_block` launches `vp_decode_attention` with."""
    shapes = set()
    for group in layer_groups(cfg):
        for pattern in group.patterns:
            if pattern in ("mamba", "rwkv"):
                continue
            window = (cfg.sliding_window if pattern in ("swa", "moe_swa")
                      else (cfg.local_window if pattern == "local"
                            else None))
            buf_len = min(max_len, window) if window else max_len
            rolling = window is not None and buf_len <= window
            shapes.add((buf_len, window or 0, rolling))
    if cfg.family == "encdec":
        shapes.add((max_len, 0, False))
    return sorted(shapes)


def _device(params) -> torch.device:
    return next(_leaves(params)).device


def tune_decode_profile(params, cfg, batch: int, max_len: int = 0,
                        seed: int = 0) -> Dict[Any, Tuple[int, ...]]:
    """Tune the decode launches of this model on the card, persist the
    winners and return {(K, N): (split, k_per)} for the weight panels
    and {("attn", batch, buf_len, KV, dh, window, rolling): (cluster,
    warps)} for the cache geometries (with a packed VP KV cache and
    `max_len`).  On the CPU prints the skip line and returns {}."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.vp_attention import (
        DECODE_KERNEL, decode_candidates, vp_decode_attention_cuda)
    from repro_torch.kernels.vp_dequant_matmul import (
        SKINNY_KERNEL, fwd_body, skinny_candidates, vp_dequant_matmul_cuda)
    from repro_torch.models.attention import kv_cache_formats

    device = _device(params)
    if device.type != "cuda":
        # The plain path's math does not depend on a plan and never
        # reads the cache: timing candidates would record noise.
        print("[serve] decode autotune profile skipped: the plain PyTorch "
              "path on the CPU (plans only affect the CUDA kernels)")
        return {}
    _, vp = canonical_formats(cfg.quant)
    dtype = model_dtype(cfg)
    backend = autotune.backend_name(device)
    num_sms = torch.cuda.get_device_properties(device).multi_processor_count
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = sorted({1 << p for p in range(batch.bit_length())
                    if (1 << p) <= batch} | {batch})
    sizes = [m for m in sizes if fwd_body(m, dtype, vp) == "skinny"]
    profile: Dict[Any, Tuple[int, ...]] = {}
    for K, N in (weight_panels(params) if sizes else []):
        w = torch.randint(-8, 8, (K, N), generator=gen, device=device,
                          dtype=torch.int32).to(storage_dtype(vp))
        x = torch.randn((sizes[-1], K), generator=gen, device=device).to(
            dtype)

        def bench(m, w=w, x=x):
            return lambda split_k: vp_dequant_matmul_cuda(
                x[:m], w, vp, dtype, body="skinny", plan=split_k)

        profile[(K, N)] = autotune.tune(
            SKINNY_KERNEL, (K, N), (vp,), backend,
            [bench(m) for m in sizes], skinny_candidates(K, N, num_sms),
            repeats=REPEATS)
    q = cfg.quant
    if q.quantize_kv_cache and q.kv_layout == "packed" and max_len:
        _, kv_vp = kv_cache_formats(q)
        KV, dh, H = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
        G = H // KV
        wt = storage_dtype(kv_vp)
        w_bytes = torch.empty((), dtype=wt).element_size()
        for buf_len, window, rolling in attn_cache_geometries(cfg, max_len):
            kw = torch.randint(-8, 8, (batch, buf_len, KV, dh), generator=gen,
                               device=device, dtype=torch.int32).to(wt)
            ks = torch.ones((batch, buf_len), device=device)
            qq = torch.randn((batch, KV, G, dh), generator=gen,
                             device=device).to(dtype)
            lens = torch.full((batch,), buf_len, dtype=torch.int32,
                              device=device)

            def bench_attn(cw, kw=kw, ks=ks, qq=qq, lens=lens,
                           window=window, rolling=rolling):
                vp_decode_attention_cuda(qq, kw, kw, ks, ks, lens, kv_vp,
                                         window or None, rolling, dh ** -0.5,
                                         plan=cw)

            shape = (KV, buf_len, G, dh, w_bytes, window, int(rolling))
            profile[("attn", batch, buf_len, KV, dh, window, rolling)] = \
                autotune.tune(DECODE_KERNEL, shape, (kv_vp,), backend,
                              bench_attn,
                              decode_candidates(KV, buf_len, G, dh, w_bytes),
                              repeats=REPEATS)
    return profile
