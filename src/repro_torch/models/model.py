"""Dense and MoE transformer serving and training paths (port of the
dense and MoE branches of `repro.models.model`).

Parameters are plain dicts of tensors: {"embed", "final_norm", "lm_head",
"layers": [per-layer {"attn", "mlp" (dense) or "moe" (MoE: `w_router`
and the stacked experts), "ln1", "ln2"}]}, the serving layout.  The
reference stacks layers for `lax.scan`, one stack per
sub-layer of each scanned group (`layer_groups`: gemma3's period of 5
local + 1 global layers, then a tail of locals); here a Python loop
walks the list in the order the scans apply them (`layer_plan`), each
layer with its own attention pattern and window.  Training keeps the
reference's stack instead
(`stack_layers`: "layers" is one dict of (L, ...) tensors), so that every
per-tensor scale of the gradient and moment codecs covers the same
elements as the reference's.
Caches are a list of per-layer dicts (see `models.attention.attn_block`).
With `remat="full"` training recomputes each scanned group's repetition
in the backward (`torch.utils.checkpoint`), the unit the reference's
`jax.checkpoint` wraps; "dots" runs as "none", as in the reference.

Entry points default to device="cuda" and raise when CUDA is absent;
the CPU (plain versions of the kernels) must be asked for explicitly.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import storage_dtype
from repro_torch.core.vp_tensor import significand_dtype
from .attention import attn_block, kv_cache_formats
from .layers import embed_lookup, qdot, quantize_weight, rms_norm
from .mlp import swiglu
from .moe import moe_block

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


FAMILIES = ("dense", "moe")
MOE_PATTERNS = ("moe", "moe_swa")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet ({', '.join(FAMILIES)}"
            " only)")


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    """One scanned group of the reference: `repeats` times the sub-layers
    `patterns` (causal | local | global | swa)."""
    repeats: int
    patterns: Tuple[str, ...]


def layer_groups(cfg: ModelConfig) -> List[LayerGroup]:
    """The reference's scanned groups of a dense or MoE model (those
    branches of `repro.models.model.layer_groups`)."""
    _check_family(cfg)
    if cfg.local_global_period:
        per = cfg.local_global_period
        n_full, tail = divmod(cfg.n_layers, per)
        groups = []
        if n_full:
            groups.append(
                LayerGroup(n_full, ("local",) * (per - 1) + ("global",)))
        if tail:
            groups.append(LayerGroup(1, ("local",) * tail))
        return groups
    if cfg.family == "moe":
        return [LayerGroup(cfg.n_layers, (
            "moe_swa" if cfg.sliding_window else "moe",))]
    return [LayerGroup(cfg.n_layers,
                       ("swa" if cfg.sliding_window else "causal",))]


def pattern_window(cfg: ModelConfig, pattern: str
                   ) -> Tuple[str, Optional[int]]:
    """A sub-layer pattern's attention: (causal | local, window)."""
    if pattern == "local":
        return "local", cfg.local_window
    if pattern in ("swa", "moe_swa"):
        return "local", cfg.sliding_window
    return "causal", None


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Layer `index` of the port's list: repeat `rep` of sub-layer `sub`
    of group `gi`, with its attention pattern and window."""
    index: int
    gi: int
    sub: int
    rep: int
    pattern: str
    attention: str
    window: Optional[int]


@functools.lru_cache(maxsize=64)
def layer_plan(cfg: ModelConfig) -> Tuple[LayerSpec, ...]:
    """Every layer in the order the reference's scans apply them: group
    g, repeat r, sub-layer j is layer offset_g + r * len(patterns_g) +
    j.  Made once per config (each forward walks it)."""
    out: List[LayerSpec] = []
    for gi, group in enumerate(layer_groups(cfg)):
        for r in range(group.repeats):
            for j, pattern in enumerate(group.patterns):
                attention, window = pattern_window(cfg, pattern)
                out.append(LayerSpec(len(out), gi, j, r, pattern, attention,
                                     window))
    return tuple(out)


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Random float weights from a seeded torch.Generator, with the
    reference's shapes and scales (normal * 0.02; output projections
    * 0.02 / sqrt(2 L); norms and QKV biases zero; MoE layers a f32
    router (d, E) and experts stacked (E, d, ff) / (E, ff, d))."""
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
    for spec in layer_plan(cfg):
        attn = {"wq": dense((d, H * dh)), "wk": dense((d, KV * dh)),
                "wv": dense((d, KV * dh)), "wo": dense((H * dh, d), out_scale)}
        if cfg.qkv_bias:
            for name, n in (("bq", H * dh), ("bk", KV * dh), ("bv", KV * dh)):
                attn[name] = torch.zeros((n,), dtype=dtype, device=dev)
        if cfg.qk_norm:
            attn["q_norm"] = zeros(dh)
            attn["k_norm"] = zeros(dh)
        layer = {"attn": attn, "ln1": zeros(d), "ln2": zeros(d)}
        if spec.pattern in MOE_PATTERNS:
            E = cfg.n_experts
            router = torch.randn((d, E), generator=gen, device=dev,
                                 dtype=torch.float32) * 0.02
            layer["moe"] = {"w_router": router,
                            "w_gate": dense((E, d, ff)),
                            "w_up": dense((E, d, ff)),
                            "w_down": dense((E, ff, d), out_scale)}
        else:
            layer["mlp"] = {"w_gate": dense((d, ff)), "w_up": dense((d, ff)),
                            "w_down": dense((ff, d), out_scale)}
        params["layers"].append(layer)
    return params


def quantize_params(params: Dict[str, Any], cfg: ModelConfig,
                    layout: str = "packed") -> Dict[str, Any]:
    """Export: every weight matrix -> its serving dict
    (`layers.quantize_weight`: {"w_packed", "scale"} in mode vp, or
    {"m", "i_packed", "scale"} with `layout="planes"`; {"m", "i_blk",
    "scale"} in vp_block; {"m", "scale"} in fxp).  A stack of matrices
    (3-D: the experts (E, d_in, d_out), or layers; 4-D: layers of
    experts) is exported matrix by matrix, one scale each, and stacked
    back, as the reference's vmap of the export does.  Biases, norms and
    the MoE router stay float.

    On the card each VP matrix goes through the quant kernel (words or
    planes) once, each block-VP one through the block quantizer; FXP is
    plain tensor code.  The float tensors are not kept: drop the input
    tree to free them.
    """
    if cfg.quant.mode == "none":
        return params

    def export(w):
        if w.ndim == 2:
            return quantize_weight(w, cfg.quant, layout)
        parts = [export(wi) for wi in w]
        if isinstance(parts[0], torch.Tensor):
            return torch.stack(parts)
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}

    def walk(node):
        if isinstance(node, dict):
            return {k: (export(v)
                        if k in QUANT_KEYS and isinstance(v, torch.Tensor)
                        and v.ndim in (2, 3, 4) else walk(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def init_cache(cfg: ModelConfig, B: int, max_len: int,
               device="cuda") -> List[dict]:
    """Per-layer decode caches.  With `quantize_kv_cache`: packed VP
    words + per-position f32 scales (kv_layout "packed"), or
    significands (int8 for M <= 8), uint8 indices packed 8 // E to a
    byte where dh allows, and the scales ("planes"); else float K/V in
    the model dtype.  A windowed layer's buffer holds min(max_len,
    window) positions (a rolling ring once the window is the shorter),
    every other layer's max_len.  device="meta" gives the shapes without
    allocating."""
    dev = resolve_device(device)
    KV, dh = cfg.n_kv_heads, cfg.head_dim

    caches = []
    for spec in layer_plan(cfg):
        buf = min(max_len, spec.window) if spec.window else max_len

        def zeros(tail, dtype):
            return torch.zeros((B, buf) + tail, dtype=dtype, device=dev)

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


def _sublayer(x, p, spec: LayerSpec, cfg: ModelConfig, positions, cache,
              train: bool, chunked: bool):
    """One layer: attention, then the MLP or the MoE block -> (x, cache,
    aux (2,) f32 [load_balance, router_z], zero for a dense MLP)."""
    h, cache = attn_block(rms_norm(x, p["ln1"]), p["attn"], cfg, positions,
                          spec.attention, spec.window, cache, train, chunked)
    x = x + h
    if spec.pattern in MOE_PATTERNS:
        h, aux = moe_block(rms_norm(x, p["ln2"]), p["moe"], cfg, train=train)
        aux = torch.stack([aux["load_balance"], aux["router_z"]])
    else:
        h = swiglu(rms_norm(x, p["ln2"]), p["mlp"], cfg.quant, train)
        aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
    return x + h, cache, aux


def _repetition(x, layers, specs, cfg: ModelConfig, positions,
                train: bool):
    """One repetition of a scanned group without caches (training):
    its sub-layers in order -> (x, aux summed over them)."""
    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
    for spec, p in zip(specs, layers):
        x, _, a = _sublayer(x, p, spec, cfg, positions, None, train, False)
        aux = aux + a
    return x, aux


def _backbone(layers, x, cfg: ModelConfig, positions,
              caches: Optional[List[dict]] = None, train: bool = False,
              chunked: bool = False):
    """Every layer in `layer_plan` order -> (x, new caches, aux (2,) f32
    summed over the layers).  Training with `remat="full"` checkpoints
    each repetition of a scanned group (its sub-layers together, the
    unit of the reference's `jax.checkpoint`): its activations are
    recomputed in the backward, bit for bit."""
    plan = layer_plan(cfg)
    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
    if caches is None and cfg.remat == "full" and torch.is_grad_enabled():
        reps: Dict[Tuple[int, int], List[int]] = {}
        for spec in plan:
            reps.setdefault((spec.gi, spec.rep), []).append(spec.index)
        for idx in reps.values():
            x, a = torch.utils.checkpoint.checkpoint(
                _repetition, x, [layers[i] for i in idx],
                [plan[i] for i in idx], cfg, positions, train,
                use_reentrant=False)
            aux = aux + a
        return x, None, aux
    new_caches = []
    for spec, p in zip(plan, layers, strict=True):
        cache = None if caches is None else caches[spec.index]
        x, cache, a = _sublayer(x, p, spec, cfg, positions, cache, train,
                                chunked)
        aux = aux + a
        new_caches.append(cache)
    return x, new_caches, aux


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
    differentiable walk.  The loss is ce + 0.01 load_balance + 1e-3
    router_z, the aux terms summed over the MoE layers (0 for a dense
    model), as the reference's.  `cfg.remat == "full"` checkpoints each
    scanned group's repetition (`_backbone`).
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_lookup(tokens, params["embed"], cfg.quant, train).to(
        model_dtype(cfg))
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x, _, aux = _backbone(_unbind(params["layers"]), x, cfg, positions,
                          train=train)
    x = rms_norm(x, params["final_norm"])
    ce = chunked_cross_entropy(x, params["lm_head"], batch["labels"], cfg,
                               cfg.loss_chunk)
    loss = ce + 0.01 * aux[0] + 1e-3 * aux[1]
    return loss, {"ce": ce, "load_balance": aux[0], "router_z": aux[1]}


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
    x, caches, _ = _backbone(params["layers"], x, cfg, positions, caches,
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
    x, caches, _ = _backbone(params["layers"], x, cfg, positions, caches)
    x = rms_norm(x, params["final_norm"])
    logits = qdot(x[:, 0], params["lm_head"], cfg.quant)
    return logits.to(torch.float32), caches
