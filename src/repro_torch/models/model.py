"""Dense, MoE, SSM and hybrid serving and training paths (port of
those branches of `repro.models.model`).

Serving parameters are plain dicts of tensors: {"embed", "final_norm",
"lm_head", "layers": [one dict per layer]}.  A layer is {"attn", "mlp"
(dense) or "moe" (MoE: `w_router` and the stacked experts), "ln1",
"ln2"}, an RWKV6 layer (`models.rwkv6`: time and channel mix) or a
Mamba2 layer (`models.mamba2`, with its pre-norm "ln").  The reference
stacks layers for `lax.scan`, one stack per sub-layer of each scanned
group (`layer_groups`: gemma3's period of 5 local + 1 global layers,
then a tail of locals; zamba2's 6 mamba layers and the shared attention
block, then a tail of mambas); here a Python loop walks the list in the
order the scans apply them (`layer_plan`), each layer with its own
pattern and window.  The hybrid's shared attention block is ONE dict,
and every application of it in the list is that same dict.

Training takes the reference's own tree instead (`stack_layers`):
{"embed", "final_norm", "lm_head", "groups": [{"sub{j}": a dict of
(repeats, ...) tensors}], "shared_attn"?}, one stack per sub-layer of
each scanned group and the shared block once, outside the groups.  So
every per-tensor scale of the gradient and moment codecs covers the
same elements as the reference's, on every model, and the shared
block's gradient is the sum over its applications.  `_unbind` gives the
per-layer list back as views into those stacks.

Caches are a list of per-layer dicts (see `models.attention.attn_block`;
an SSM layer's state rows {"s", "last_tm", "last_cm"} or {"h", "conv"}
have no sequence axis and no "len", and are updated in place).
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
from .mamba2 import D_CONV, mamba2_block, mamba2_dims
from .mlp import swiglu
from .moe import moe_block
from .rwkv6 import HEAD_DIM as RWKV_HEAD
from .rwkv6 import rwkv6_channel_mix, rwkv6_time_mix

QUANT_KEYS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in",
              "w_out", "w_r", "w_k", "w_v", "w_g", "w_o", "w_ck", "w_cv",
              "w_cr", "w_z", "w_x", "w_bc", "w_dt", "embed", "lm_head"}


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


FAMILIES = ("dense", "moe", "ssm", "hybrid")
MOE_PATTERNS = ("moe", "moe_swa")
SSM_PATTERNS = ("mamba", "rwkv")
SHARED = "shared_attn"


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet ({', '.join(FAMILIES)}"
            " only)")


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    """One scanned group of the reference: `repeats` times the sub-layers
    `patterns` (causal | local | global | swa | moe | moe_swa | mamba |
    rwkv | shared_attn)."""
    repeats: int
    patterns: Tuple[str, ...]


def layer_groups(cfg: ModelConfig) -> List[LayerGroup]:
    """The reference's scanned groups (its `layer_groups`, but for the
    encoder-decoder family)."""
    _check_family(cfg)
    if cfg.family == "hybrid":
        per = cfg.shared_attn_period
        n_full, tail = divmod(cfg.n_layers, per)
        groups = []
        if n_full:
            groups.append(LayerGroup(n_full, ("mamba",) * per + (SHARED,)))
        if tail:
            groups.append(LayerGroup(1, ("mamba",) * tail))
        return groups
    if cfg.family == "ssm" and cfg.rwkv:
        return [LayerGroup(cfg.n_layers, ("rwkv",))]
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
    """A sub-layer pattern's attention: (causal | local, window); the
    shared block is causal with no window."""
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
    router (d, E) and experts stacked (E, d, ff) / (E, ff, d); RWKV6
    and Mamba2 layers their f32 mixes, decays, conv and norms as the
    reference's `_rwkv_params` / `_mamba_params`).  The hybrid's shared
    block is made once and every application refers to it."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = model_dtype(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def dense(shape, scale=0.02, dt=dtype):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (w * scale).to(dt)

    def full(shape, value=0.0):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    def zeros(n):
        return full((n,))

    d, ff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out_scale = 0.02 / max(1, 2 * L) ** 0.5

    def attn_mlp():
        attn = {"wq": dense((d, H * dh)), "wk": dense((d, KV * dh)),
                "wv": dense((d, KV * dh)), "wo": dense((H * dh, d), out_scale)}
        if cfg.qkv_bias:
            for name, n in (("bq", H * dh), ("bk", KV * dh), ("bv", KV * dh)):
                attn[name] = torch.zeros((n,), dtype=dtype, device=dev)
        if cfg.qk_norm:
            attn["q_norm"] = zeros(dh)
            attn["k_norm"] = zeros(dh)
        return {"attn": attn, "ln1": zeros(d), "ln2": zeros(d)}

    def rwkv():
        lora = max(32, d // 16)
        p = {"w_r": dense((d, d)), "w_k": dense((d, d)),
             "w_v": dense((d, d)), "w_g": dense((d, d)),
             "w_o": dense((d, d), out_scale),
             "w_dec_a": dense((d, lora), dt=torch.float32),
             "w_dec_b": dense((lora, d), dt=torch.float32),
             "w_dec0": zeros(d),
             "u_bonus": full((d // RWKV_HEAD, RWKV_HEAD)),
             "ln_x": zeros(d),
             "w_ck": dense((d, ff)), "w_cv": dense((ff, d), out_scale),
             "w_cr": dense((d, d))}
        for name in ("r", "k", "v", "g", "w", "ck", "cr"):
            p[f"mu_{name}"] = full((d,), 0.5)
        p["ln1"], p["ln2"] = zeros(d), zeros(d)
        return p

    def mamba():
        di, n, nh, _, conv_dim, _ = mamba2_dims(cfg)
        return {"w_z": dense((d, di)), "w_x": dense((d, di)),
                "w_bc": dense((d, 2 * n)), "w_dt": dense((d, nh)),
                "conv_w": dense((D_CONV, conv_dim), 0.2, torch.float32),
                "conv_b": zeros(conv_dim), "dt_bias": zeros(nh),
                "a_log": zeros(nh), "d_skip": full((nh,), 1.0),
                "out_norm": zeros(di), "w_out": dense((di, d), out_scale),
                "ln": zeros(d)}

    params: Dict[str, Any] = {
        "embed": dense((cfg.vocab, d)),
        "final_norm": zeros(d),
        "lm_head": dense((d, cfg.vocab)),
        "layers": [],
    }
    shared = None
    for spec in layer_plan(cfg):
        if spec.pattern == SHARED:
            if shared is None:
                shared = attn_mlp()
                shared["mlp"] = {"w_gate": dense((d, ff)),
                                 "w_up": dense((d, ff)),
                                 "w_down": dense((ff, d), out_scale)}
            layer = shared
        elif spec.pattern == "rwkv":
            layer = rwkv()
        elif spec.pattern == "mamba":
            layer = mamba()
        else:
            layer = attn_mlp()
            if spec.pattern in MOE_PATTERNS:
                E = cfg.n_experts
                router = torch.randn((d, E), generator=gen, device=dev,
                                     dtype=torch.float32) * 0.02
                layer["moe"] = {"w_router": router,
                                "w_gate": dense((E, d, ff)),
                                "w_up": dense((E, d, ff)),
                                "w_down": dense((E, ff, d), out_scale)}
            else:
                layer["mlp"] = {"w_gate": dense((d, ff)),
                                "w_up": dense((d, ff)),
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
    back, as the reference's vmap of the export does.  Biases, norms,
    the MoE router and RWKV6's f32 low-rank decay stay float.  A dict
    met again (the hybrid's shared block, at each of its applications)
    is exported once and the result shared.

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

    done: Dict[int, Any] = {}

    def walk(node):
        if isinstance(node, dict):
            if id(node) not in done:
                done[id(node)] = {
                    k: (export(v)
                        if k in QUANT_KEYS and isinstance(v, torch.Tensor)
                        and v.ndim in (2, 3, 4) else walk(v))
                    for k, v in node.items()}
            return done[id(node)]
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
    every other layer's max_len.  An RWKV6 layer keeps its state rows
    {"s" (B, H, 64, 64) f32, "last_tm", "last_cm" (B, d)}, a Mamba2
    layer {"h" (B, heads, P, N) f32, "conv" (B, D_CONV - 1, conv
    channels)}, in the model dtype where not f32; each application of
    the shared block has its own attention cache.  device="meta" gives
    the shapes without allocating."""
    dev = resolve_device(device)
    KV, dh = cfg.n_kv_heads, cfg.head_dim
    dtype, d, f32 = model_dtype(cfg), cfg.d_model, torch.float32

    caches = []
    for spec in layer_plan(cfg):
        if spec.pattern == "rwkv":
            H = d // RWKV_HEAD
            caches.append(dict(
                s=torch.zeros((B, H, RWKV_HEAD, RWKV_HEAD), dtype=f32,
                              device=dev),
                last_tm=torch.zeros((B, d), dtype=dtype, device=dev),
                last_cm=torch.zeros((B, d), dtype=dtype, device=dev)))
            continue
        if spec.pattern == "mamba":
            _, n, nh, p, conv_dim, _ = mamba2_dims(cfg)
            caches.append(dict(
                h=torch.zeros((B, nh, p, n), dtype=f32, device=dev),
                conv=torch.zeros((B, D_CONV - 1, conv_dim), dtype=dtype,
                                 device=dev)))
            continue
        buf = min(max_len, spec.window) if spec.window else max_len

        def zeros(tail, dtype):
            return torch.zeros((B, buf) + tail, dtype=dtype, device=dev)

        ln = torch.zeros((B,), dtype=torch.int32, device=dev)
        if not cfg.quant.quantize_kv_cache:
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


def stack_layers(params: Dict[str, Any], cfg: ModelConfig
                 ) -> Dict[str, Any]:
    """Serving layout -> training layout, the reference's tree: the
    layers of sub-layer j of scanned group g become "groups"[g]["sub{j}"],
    one dict of tensors stacked on a leading (repeats, ...) axis
    (copies), and the hybrid's shared block "shared_attn" (its tensors,
    not copied), outside the groups."""
    groups: List[Dict[str, Any]] = [{} for _ in layer_groups(cfg)]
    members: Dict[Tuple[int, int], List[Any]] = {}
    out = {k: v for k, v in params.items() if k != "layers"}
    for spec, layer in zip(layer_plan(cfg), params["layers"], strict=True):
        if spec.pattern == SHARED:
            out[SHARED] = layer
        else:
            members.setdefault((spec.gi, spec.sub), []).append(layer)

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack(nodes)

    for (gi, j), nodes in members.items():
        groups[gi][f"sub{j}"] = stack(nodes)
    out["groups"] = groups
    return out


def _unbind_stack(node) -> List[Any]:
    """A dict of (R, ...) tensors -> R dicts of views (`unbind`, whose
    gradient is one stack)."""
    if isinstance(node, dict):
        parts = {k: _unbind_stack(v) for k, v in node.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(node.unbind(0))


def _unbind(params: Dict[str, Any], cfg: ModelConfig) -> List[Any]:
    """Training layout -> the per-layer list in `layer_plan` order: each
    layer a view into its (group, sub-layer) stack at its repeat, each
    application of the shared block the same dict."""
    views = {(gi, key): _unbind_stack(node)
             for gi, g in enumerate(params["groups"])
             for key, node in g.items()}
    return [params[SHARED] if spec.pattern == SHARED
            else views[(spec.gi, f"sub{spec.sub}")][spec.rep]
            for spec in layer_plan(cfg)]


def _sublayer(x, p, spec: LayerSpec, cfg: ModelConfig, positions, cache,
              train: bool, chunked: bool):
    """One layer -> (x, cache, aux (2,) f32 [load_balance, router_z],
    zero but for an MoE block).  RWKV6: time mix then channel mix;
    Mamba2: the block after its norm; otherwise attention, then the MLP
    or the MoE block.  An SSM layer's cache is its state, updated in
    place and returned."""
    zero = torch.zeros((2,), dtype=torch.float32, device=x.device)
    if spec.pattern == "rwkv":
        h, cache = rwkv6_time_mix(rms_norm(x, p["ln1"]), p, cfg, cache,
                                  train)
        x = x + h
        h, cache = rwkv6_channel_mix(rms_norm(x, p["ln2"]), p, cfg, cache,
                                     train)
        return x + h, cache, zero
    if spec.pattern == "mamba":
        h, cache = mamba2_block(rms_norm(x, p["ln"]), p, cfg, cache, train)
        return x + h, cache, zero
    h, cache = attn_block(rms_norm(x, p["ln1"]), p["attn"], cfg, positions,
                          spec.attention, spec.window, cache, train, chunked)
    x = x + h
    if spec.pattern in MOE_PATTERNS:
        h, aux = moe_block(rms_norm(x, p["ln2"]), p["moe"], cfg, train=train)
        aux = torch.stack([aux["load_balance"], aux["router_z"]])
    else:
        h = swiglu(rms_norm(x, p["ln2"]), p["mlp"], cfg.quant, train)
        aux = zero
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
    router_z, the aux terms summed over the MoE layers (0 for the other
    families), as the reference's.  `cfg.remat == "full"` checkpoints each
    scanned group's repetition (`_backbone`).
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_lookup(tokens, params["embed"], cfg.quant, train).to(
        model_dtype(cfg))
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x, _, aux = _backbone(_unbind(params, cfg), x, cfg, positions,
                          train=train)
    x = rms_norm(x, params["final_norm"])
    ce = chunked_cross_entropy(x, params["lm_head"], batch["labels"], cfg,
                               cfg.loss_chunk)
    loss = ce + 0.01 * aux[0] + 1e-3 * aux[1]
    return loss, {"ce": ce, "load_balance": aux[0], "router_z": aux[1]}


def _decode_positions(caches: List[dict]) -> torch.Tensor:
    """The current position (B, 1) of each row: the length of the first
    cache that has one (every attention cache advances together), or
    zeros for a model of SSM layers only (no rope reads it)."""
    for cache in caches:
        if "len" in cache:
            return cache["len"][:, None]
    B = next(iter(caches[0].values())).shape[0]
    return torch.zeros((B, 1), dtype=torch.int32,
                       device=next(iter(caches[0].values())).device)


@torch.no_grad()
def prefill(params, tokens: torch.Tensor, caches, cfg: ModelConfig,
            chunked: bool = False):
    """One causal pass over the prompt (B, S) into empty caches ->
    (last-position logits (B, V) f32, filled caches).

    chunked: `tokens` is a prompt CHUNK continuing already-prefilled
    caches (continuous batching): positions are offset by the cache
    length (`_decode_positions`) and attention appends at that offset;
    SSM states carry forward."""
    _check_family(cfg)
    B, S = tokens.shape
    x = embed_lookup(tokens, params["embed"], cfg.quant).to(model_dtype(cfg))
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    if chunked:
        positions = _decode_positions(caches) + positions
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
    positions = _decode_positions(caches)
    x, caches, _ = _backbone(params["layers"], x, cfg, positions, caches)
    x = rms_norm(x, params["final_norm"])
    logits = qdot(x[:, 0], params["lm_head"], cfg.quant)
    return logits.to(torch.float32), caches
