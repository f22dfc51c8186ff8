"""Dense transformer serving and training paths (port of the dense
branches of `repro.models.model`).

Parameters are plain dicts of tensors: {"embed", "final_norm", "lm_head",
"layers": [per-layer {"attn", "mlp", "ln1", "ln2"}]}, the serving
layout.  The reference stacks layers for `lax.scan`; here a Python loop
walks the list.  Training keeps the reference's stack instead
(`stack_layers`: "layers" is one dict of (L, ...) tensors), so that every
per-tensor scale of the gradient and moment codecs covers the same
elements as the reference's.
Caches are a list of per-layer dicts (see `models.attention.attn_block`).

Entry points default to device="cuda" and raise when CUDA is absent;
the CPU (plain versions of the kernels) must be asked for explicitly.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import storage_dtype
from repro_torch.core.vp_tensor import significand_dtype
from .attention import attn_block, kv_cache_formats
from .layers import embed_lookup, qdot, quantize_weight, rms_norm
from .mlp import swiglu

QUANT_KEYS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "embed", "lm_head"}


def resolve_device(device="cuda") -> torch.device:
    """The device to run on; raises rather than fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")


def layer_pattern(cfg: ModelConfig) -> Tuple[str, Optional[int]]:
    """(attention pattern, window) of every layer of a dense model."""
    if cfg.sliding_window:
        return "local", cfg.sliding_window
    return "causal", None


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Random float weights from a seeded torch.Generator, with the
    reference's shapes and scales (normal * 0.02; output projections
    * 0.02 / sqrt(2 L); norms zero)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = model_dtype(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def dense(shape, scale=0.02):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (w * scale).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    d, ff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out_scale = 0.02 / max(1, 2 * L) ** 0.5
    params: Dict[str, Any] = {
        "embed": dense((cfg.vocab, d)),
        "final_norm": zeros(d),
        "lm_head": dense((d, cfg.vocab)),
        "layers": [],
    }
    for _ in range(L):
        attn = {"wq": dense((d, H * dh)), "wk": dense((d, KV * dh)),
                "wv": dense((d, KV * dh)), "wo": dense((H * dh, d), out_scale)}
        if cfg.qk_norm:
            attn["q_norm"] = zeros(dh)
            attn["k_norm"] = zeros(dh)
        mlp = {"w_gate": dense((d, ff)), "w_up": dense((d, ff)),
               "w_down": dense((ff, d), out_scale)}
        params["layers"].append(
            {"attn": attn, "mlp": mlp, "ln1": zeros(d), "ln2": zeros(d)})
    return params


def quantize_params(params: Dict[str, Any], cfg: ModelConfig
                    ) -> Dict[str, Any]:
    """Export: every weight matrix -> its serving dict
    (`layers.quantize_weight`: {"w_packed", "scale"} in mode vp, {"m",
    "i_blk", "scale"} in vp_block, {"m", "scale"} in fxp).

    On the card each packed matrix goes through the quant kernel once;
    block VP and FXP are plain tensor code.  The float tensors are not
    kept: drop the input tree to free them.
    """
    if cfg.quant.mode == "none":
        return params

    def walk(node):
        if isinstance(node, dict):
            return {k: (quantize_weight(v, cfg.quant)
                        if k in QUANT_KEYS and isinstance(v, torch.Tensor)
                        and v.ndim == 2 else walk(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def init_cache(cfg: ModelConfig, B: int, max_len: int,
               device="cuda") -> List[dict]:
    """Per-layer decode caches.  With `quantize_kv_cache`: packed VP
    words + per-position f32 scales (kv_layout "packed"), or
    significands (int8 for M <= 8), uint8 indices packed 8 // E to a byte where dh allows,
    and the scales ("planes"); else float K/V in the model dtype.
    device="meta" gives the shapes without allocating."""
    _check_family(cfg)
    dev = resolve_device(device)
    KV, dh = cfg.n_kv_heads, cfg.head_dim
    _, window = layer_pattern(cfg)
    buf = min(max_len, window) if window else max_len

    def zeros(tail, dtype):
        return torch.zeros((B, buf) + tail, dtype=dtype, device=dev)

    caches = []
    for _ in range(cfg.n_layers):
        ln = torch.zeros((B,), dtype=torch.int32, device=dev)
        if not cfg.quant.quantize_kv_cache:
            dtype = model_dtype(cfg)
            caches.append(dict(k=zeros((KV, dh), dtype),
                               v=zeros((KV, dh), dtype), len=ln))
            continue
        _, vp = kv_cache_formats(cfg.quant)
        if cfg.quant.kv_layout == "packed":
            wdt = storage_dtype(vp)
            caches.append(dict(
                k_w=zeros((KV, dh), wdt), k_s=zeros((1, 1), torch.float32),
                v_w=zeros((KV, dh), wdt), v_s=zeros((1, 1), torch.float32),
                len=ln))
            continue
        per = 8 // vp.E if vp.E else 1
        dh_i = dh // per if (vp.E and dh % per == 0) else dh
        mdt = significand_dtype(vp.M)
        caches.append(dict(
            k_m=zeros((KV, dh), mdt),
            k_i=zeros((KV, dh_i), torch.uint8),
            k_s=zeros((1, 1), torch.float32),
            v_m=zeros((KV, dh), mdt),
            v_i=zeros((KV, dh_i), torch.uint8),
            v_s=zeros((1, 1), torch.float32), len=ln))
    return caches


def stack_layers(params: Dict[str, Any]) -> Dict[str, Any]:
    """Serving layout -> training layout: the per-layer list becomes one
    dict of tensors stacked on a leading (L, ...) axis (copies)."""
    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack(nodes)

    return {**params, "layers": stack(params["layers"])}


def _unbind(node) -> List[Any]:
    """A stacked dict of (L, ...) tensors -> L per-layer dicts of views
    (`unbind`, whose gradient is one stack)."""
    if isinstance(node, dict):
        parts = {k: _unbind(v) for k, v in node.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(node.unbind(0))


def _backbone(layers, x, cfg: ModelConfig, positions,
              caches: Optional[List[dict]] = None, train: bool = False,
              chunked: bool = False):
    pattern, window = layer_pattern(cfg)
    new_caches = []
    for i, p in enumerate(layers):
        cache = None if caches is None else caches[i]
        h, cache = attn_block(rms_norm(x, p["ln1"]), p["attn"], cfg,
                              positions, pattern, window, cache, train,
                              chunked)
        x = x + h
        x = x + swiglu(rms_norm(x, p["ln2"]), p["mlp"], cfg.quant, train)
        new_caches.append(cache)
    return x, new_caches


def chunked_cross_entropy(hidden: torch.Tensor, lm_head: torch.Tensor,
                          labels: torch.Tensor, cfg: ModelConfig,
                          chunk: int = 1024) -> torch.Tensor:
    """Mean cross entropy over valid labels (-1 = ignore), logits in f32,
    taken over sequence chunks (the largest divisor of S up to `chunk`)
    so the (B, S, V) logits exist one chunk at a time in the forward.
    The `lm_head` product is `qdot` without `train`: a float matmul."""
    B, S, _ = hidden.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for j in range(0, S, c):
        y = labels[:, j:j + c].to(torch.int64)
        logits = qdot(hidden[:, j:j + c], lm_head, cfg.quant).to(
            torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, torch.clamp(y, min=0)[..., None])[..., 0]
        valid = (y >= 0).to(torch.float32)
        tot = tot + ((logz - gold) * valid).sum()
        cnt = cnt + valid.sum()
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params, batch, cfg: ModelConfig, train: bool = True):
    """batch {"tokens" (B, S), "labels" (B, S)} -> (loss, metrics), for
    parameters in the training layout (`stack_layers`).

    `train` runs every weight matmul as a QAT `qdot` and attention as the
    differentiable walk.  Dense models have no router, so the reference's
    load-balance and router-z terms are 0 and the loss is the CE.
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_lookup(tokens, params["embed"], cfg.quant, train).to(
        model_dtype(cfg))
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x, _ = _backbone(_unbind(params["layers"]), x, cfg, positions,
                     train=train)
    x = rms_norm(x, params["final_norm"])
    ce = chunked_cross_entropy(x, params["lm_head"], batch["labels"], cfg,
                               cfg.loss_chunk)
    zero = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce, {"ce": ce, "load_balance": zero, "router_z": zero}


@torch.no_grad()
def prefill(params, tokens: torch.Tensor, caches, cfg: ModelConfig,
            chunked: bool = False):
    """One causal pass over the prompt (B, S) into empty caches ->
    (last-position logits (B, V) f32, filled caches).

    chunked: `tokens` is a prompt CHUNK continuing already-prefilled
    caches (continuous batching): positions are offset by the cache
    length and attention appends at that offset."""
    _check_family(cfg)
    B, S = tokens.shape
    x = embed_lookup(tokens, params["embed"], cfg.quant).to(model_dtype(cfg))
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    if chunked:
        positions = caches[0]["len"][:, None] + positions
    x, caches = _backbone(params["layers"], x, cfg, positions, caches,
                          chunked=chunked)
    x = rms_norm(x, params["final_norm"])
    logits = qdot(x[:, -1], params["lm_head"], cfg.quant)
    return logits.to(torch.float32), caches


@torch.no_grad()
def decode_step(params, token: torch.Tensor, caches, cfg: ModelConfig):
    """One decode step: token (B, 1) -> (logits (B, V) f32, caches)."""
    _check_family(cfg)
    x = embed_lookup(token, params["embed"], cfg.quant).to(model_dtype(cfg))
    positions = caches[0]["len"][:, None]
    x, caches = _backbone(params["layers"], x, cfg, positions, caches)
    x = rms_norm(x, params["final_norm"])
    logits = qdot(x[:, 0], params["lm_head"], cfg.quant)
    return logits.to(torch.float32), caches
