"""Serving and training paths of every family: dense, MoE, SSM, hybrid,
encoder-decoder and VLM (port of `repro.models.model`).

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

The encoder-decoder (whisper) adds {"encoder": [one dict per encoder
layer: "attn", a GELU "mlp" with biases, "ln1_g/b", "ln2_g/b"], "cross":
[one dict per decoder layer: "attn" (no biases), "ln_g/b"], "enc_ln_g/b"},
lists in serving and (L, ...) stacks in training, as the reference
keeps them.  Its decoder layers are the causal layers of `layer_plan`,
each followed by cross-attention over the encoder's K/V (`cross_kv`);
no attention of it takes rope, the decoder's positions are sinusoids.
The VLM (internvl2) adds "patch_proj" (d, d): its prefill and loss
prepend the projected patch embeddings to the tokens' and run the dense
stack over both.

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
from .attention import attn_block, buffer_len, kv_cache_formats
from .layers import (block_activation, embed_lookup, layer_norm, qdot,
                     quantize_weight, rms_norm, sinusoid_pos)
from .mamba2 import D_CONV, mamba2_block, mamba2_dims
from .mlp import gelu_mlp, swiglu
from .moe import moe_block
from .rwkv6 import HEAD_DIM as RWKV_HEAD
from .rwkv6 import rwkv6_channel_mix, rwkv6_time_mix

QUANT_KEYS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in",
              "w_out", "w_r", "w_k", "w_v", "w_g", "w_o", "w_ck", "w_cv",
              "w_cr", "w_z", "w_x", "w_bc", "w_dt", "embed", "lm_head",
              "patch_proj"}


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


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
MOE_PATTERNS = ("moe", "moe_swa")
SSM_PATTERNS = ("mamba", "rwkv")
SHARED = "shared_attn"


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"unknown family {cfg.family!r} (one of {', '.join(FAMILIES)})")


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    """One scanned group of the reference: `repeats` times the sub-layers
    `patterns` (causal | local | global | swa | moe | moe_swa | mamba |
    rwkv | shared_attn)."""
    repeats: int
    patterns: Tuple[str, ...]


def layer_groups(cfg: ModelConfig) -> List[LayerGroup]:
    """The reference's scanned groups (its `layer_groups`): the
    encoder-decoder's decoder and the VLM's backbone are one group of
    causal layers."""
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
    block is made once and every application refers to it.  An
    encoder-decoder also gets its encoder layers (GELU MLP with zero
    biases, LayerNorm gains one and biases zero), one cross-attention per
    decoder layer (no QKV bias) and the encoder's final LayerNorm; a VLM
    its patch projection (d, d)."""
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

    def attention(cross=False):
        attn = {"wq": dense((d, H * dh)), "wk": dense((d, KV * dh)),
                "wv": dense((d, KV * dh)), "wo": dense((H * dh, d), out_scale)}
        if cfg.qkv_bias and not cross:
            for name, n in (("bq", H * dh), ("bk", KV * dh), ("bv", KV * dh)):
                attn[name] = torch.zeros((n,), dtype=dtype, device=dev)
        if cfg.qk_norm:
            attn["q_norm"] = zeros(dh)
            attn["k_norm"] = zeros(dh)
        return attn

    def attn_mlp():
        return {"attn": attention(), "ln1": zeros(d), "ln2": zeros(d)}

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
    if cfg.family == "encdec":
        def ones():
            return full((d,), 1.0)

        def bias(n):
            return torch.zeros((n,), dtype=dtype, device=dev)

        params["encoder"] = [
            {"attn": attention(),
             "mlp": {"w_in": dense((d, ff)), "b_in": bias(ff),
                     "w_out": dense((ff, d)), "b_out": bias(d)},
             "ln1_g": ones(), "ln1_b": zeros(d),
             "ln2_g": ones(), "ln2_b": zeros(d)}
            for _ in range(cfg.encoder_layers)]
        params["cross"] = [{"attn": attention(cross=True), "ln_g": ones(),
                            "ln_b": zeros(d)} for _ in range(L)]
        params["enc_ln_g"], params["enc_ln_b"] = ones(), zeros(d)
    if cfg.family == "vlm":
        params["patch_proj"] = dense((d, d))
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


class Caches(list):
    """The per-layer caches of one batch (a list, as any other) that also
    know on the host `hi`, the largest length a row has reached: a
    decode step checks its room from it without reading the lengths from
    the device, which would stall the host on every step.  `init_cache`
    returns one; `prefill` and `decode_step` return one where they got
    one."""

    def __init__(self, caches, hi: int):
        super().__init__(caches)
        self.hi = hi


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
    the shared block has its own attention cache; the encoder-decoder
    one full-causal self-attention cache per decoder layer (the
    cross-attention source is not cached: `cross_kv`).  A VLM's
    full-causal buffers must hold its patches too (n_patches + prompt +
    generation): a write past a full-causal buffer raises.
    device="meta" gives the shapes without allocating.  Returns `Caches`
    (all lengths 0)."""
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
    return Caches(caches, 0)


def stack_layers(params: Dict[str, Any], cfg: ModelConfig
                 ) -> Dict[str, Any]:
    """Serving layout -> training layout, the reference's tree: the
    layers of sub-layer j of scanned group g become "groups"[g]["sub{j}"],
    one dict of tensors stacked on a leading (repeats, ...) axis
    (copies), and the hybrid's shared block "shared_attn" (its tensors,
    not copied), outside the groups; the encoder-decoder's "encoder" and
    "cross" lists become (L, ...) stacks the same way."""
    groups: List[Dict[str, Any]] = [{} for _ in layer_groups(cfg)]
    members: Dict[Tuple[int, int], List[Any]] = {}
    out = {k: v for k, v in params.items() if k != "layers"}
    for spec, layer in zip(layer_plan(cfg), params["layers"], strict=True):
        if spec.pattern == SHARED:
            out[SHARED] = layer
        else:
            members.setdefault((spec.gi, spec.sub), []).append(layer)

    for (gi, j), nodes in members.items():
        groups[gi][f"sub{j}"] = _stack(nodes)
    out["groups"] = groups
    for key in ("encoder", "cross"):
        if key in params:
            out[key] = _stack(params[key])
    return out


def _stack(nodes):
    """Equal trees of tensors -> one tree of (len(nodes), ...) stacks."""
    if isinstance(nodes[0], dict):
        return {k: _stack([n[k] for n in nodes]) for k in nodes[0]}
    return torch.stack(nodes)


def _unbind_stack(node) -> List[Any]:
    """A dict of (R, ...) tensors -> R dicts of views (`unbind`, whose
    gradient is one stack)."""
    if isinstance(node, dict):
        parts = {k: _unbind_stack(v) for k, v in node.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(node.unbind(0))


def _layer_list(node) -> List[Any]:
    """A list of per-layer dicts (serving) or a dict of (L, ...) stacks
    (training) -> the per-layer dicts."""
    return node if isinstance(node, list) else _unbind_stack(node)


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


def encoder_forward(params, frames: torch.Tensor, cfg: ModelConfig,
                    train: bool = False) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings (B, S_enc, d) -> (B,
    S_enc, d) in their dtype (the reference's `_encoder_forward`): the
    sinusoid positions added, then per encoder layer full self-attention
    without rope under layer_norm(ln1) (`ops.flash_prefill` at pattern
    "full" when serving) and the GELU MLP under layer_norm(ln2), each
    added to the residual, then layer_norm(enc_ln)."""
    S = frames.shape[1]
    x = frames + sinusoid_pos(torch.arange(S, device=frames.device),
                              cfg.d_model, frames.dtype)
    for p in _layer_list(params["encoder"]):
        a, _ = attn_block(layer_norm(x, p["ln1_g"], p["ln1_b"]), p["attn"],
                          cfg, None, "full", None, train=train)
        x = x + a
        x = x + gelu_mlp(layer_norm(x, p["ln2_g"], p["ln2_b"]), p["mlp"],
                         cfg.quant, train)
    return layer_norm(x, params["enc_ln_g"], params["enc_ln_b"])


def cross_kv(params, enc: torch.Tensor, cfg: ModelConfig
             ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The encoder output (B, S_enc, d) -> per decoder layer its
    cross-attention source (k, v), each (B, S_enc, KV, dh) in enc's
    dtype: the layer's wk and wv through `qdot` without QAT, in training
    too, as the reference's `_cross_kv`."""
    B, S, _ = enc.shape
    KV, dh = cfg.n_kv_heads, cfg.head_dim
    out = []
    for p in _layer_list(params["cross"]):
        wk, wv = p["attn"]["wk"], p["attn"]["wv"]
        xq = block_activation(enc, (wk, wv), cfg.quant)
        out.append((qdot(enc, wk, cfg.quant, xq=xq).reshape(B, S, KV, dh),
                    qdot(enc, wv, cfg.quant, xq=xq).reshape(B, S, KV, dh)))
    return out


def _decoder(params, layers, x, cfg: ModelConfig, ckv, caches=None,
             train: bool = False):
    """Whisper decoder (the reference's `_decoder_backbone`) -> (x,
    caches): per layer causal self-attention without rope under
    rms_norm(ln1), writing its cache; cross-attention over the layer's
    (k, v) of `ckv` under layer_norm(ln_g, ln_b); SwiGLU under
    rms_norm(ln2); each added to the residual."""
    new_caches = []
    for i, (p, pc) in enumerate(zip(layers, _layer_list(params["cross"]),
                                    strict=True)):
        cache = None if caches is None else caches[i]
        a, cache = attn_block(rms_norm(x, p["ln1"]), p["attn"], cfg, None,
                              "causal", None, cache, train)
        x = x + a
        a, _ = attn_block(layer_norm(x, pc["ln_g"], pc["ln_b"]), pc["attn"],
                          cfg, None, "full", None, train=train,
                          kv_override=ckv[i])
        x = x + a
        x = x + swiglu(rms_norm(x, p["ln2"]), p["mlp"], cfg.quant, train)
        new_caches.append(cache)
    return x, (None if caches is None else new_caches)


def _require(batch, key: str, cfg: ModelConfig, shape: str) -> torch.Tensor:
    if key not in batch:
        raise ValueError(f"family {cfg.family!r} needs batch[{key!r}] "
                         f"{shape}")
    return batch[key]


def loss_fn(params, batch, cfg: ModelConfig, train: bool = True):
    """batch {"tokens" (B, S), "labels" (B, S)} -> (loss, metrics), for
    parameters in the training layout (`stack_layers`); an
    encoder-decoder also takes "frames" (B, S_enc, d), a VLM "patches"
    (B, P, d) (a missing one raises ValueError naming it).

    `train` runs every weight matmul as a QAT `qdot` and attention as the
    differentiable walk.  The loss is ce + 0.01 load_balance + 1e-3
    router_z, the aux terms summed over the MoE layers (0 for the other
    families), as the reference's.  `cfg.remat == "full"` checkpoints each
    scanned group's repetition (`_backbone`).  An encoder-decoder encodes
    the frames, adds the decoder's sinusoid positions and runs the
    decoder over the cross K/V; a VLM prepends the projected patches and
    ignores their labels (-1).
    """
    _check_family(cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    B, S = tokens.shape
    dtype = model_dtype(cfg)
    x = embed_lookup(tokens, params["embed"], cfg.quant, train).to(dtype)
    dev = tokens.device
    if cfg.family == "encdec":
        frames = _require(batch, "frames", cfg, "(B, encoder_seq, d_model)")
        enc = encoder_forward(params, frames.to(dtype), cfg, train)
        x = x + sinusoid_pos(torch.arange(S, device=dev), cfg.d_model, dtype)
        x, _ = _decoder(params, _unbind(params, cfg), x, cfg,
                        cross_kv(params, enc, cfg), train=train)
        aux = torch.zeros((2,), dtype=torch.float32, device=dev)
    else:
        if cfg.family == "vlm":
            patches = _require(batch, "patches", cfg, "(B, P, d_model)")
            pp = qdot(patches.to(dtype), params["patch_proj"], cfg.quant,
                      train)
            x = torch.cat([pp, x], dim=1)
            labels = torch.cat([torch.full(
                (B, pp.shape[1]), -1, dtype=labels.dtype, device=dev),
                labels], dim=1)
            S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
        x, _, aux = _backbone(_unbind(params, cfg), x, cfg, positions,
                              train=train)
    x = rms_norm(x, params["final_norm"])
    ce = chunked_cross_entropy(x, params["lm_head"], labels, cfg,
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


def _check_room(caches: List[dict], cfg: ModelConfig, S: int
                ) -> Optional[int]:
    """Raise ValueError where writing S positions at the cache length
    would pass the end of a full-causal buffer (the reference's JAX
    clamps such a write onto the last slot; the port never does).  Every
    attention cache advances together, so the first full-causal one
    speaks for all.  The length is `Caches.hi` where the caches carry it
    (returned: the length after the write), else one host read of the
    lengths (returns None), skipped inside CUDA graph capture (the
    engine's views have room by construction)."""
    known = caches.hi if isinstance(caches, Caches) else None
    for spec, cache in zip(layer_plan(cfg), caches):
        if "len" in cache and spec.window is None:
            if known is None:
                if (torch.cuda.is_available()
                        and torch.cuda.is_current_stream_capturing()):
                    return None
                at = int(cache["len"].max())
            else:
                at = known
            room = buffer_len(cache)
            if at + S > room:
                raise ValueError(
                    f"writing {S} position(s) at length {at} passes the end"
                    f" of a full-causal KV cache of {room} positions: size "
                    "it to the whole sequence (patches, prompt and "
                    "generation)")
            break
    return None if known is None else known + S


def _with_hi(caches, hi: Optional[int]):
    return caches if hi is None else Caches(caches, hi)


@torch.no_grad()
def prefill(params, tokens: torch.Tensor, caches, cfg: ModelConfig,
            chunked: bool = False, patches: Optional[torch.Tensor] = None,
            cross_kv: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None):
    """One causal pass over the prompt (B, S) into empty caches ->
    (last-position logits (B, V) f32, filled caches).

    chunked: `tokens` is a prompt CHUNK continuing already-prefilled
    caches (continuous batching): positions are offset by the cache
    length (`_decode_positions`) and attention appends at that offset;
    SSM states carry forward.

    patches (VLM, B, P, d): projected by `patch_proj` and prepended to
    the tokens' embeddings, positions 0 .. P + S - 1 (the caches must
    hold P + S; not with `chunked`).  cross_kv (encoder-decoder, required
    there): the decoder's per-layer cross-attention sources
    (`cross_kv(params, encoder_forward(...))`); the decoder's sinusoid
    positions are added; `chunked` is refused, as in the reference.
    """
    _check_family(cfg)
    B, S = tokens.shape
    dtype = model_dtype(cfg)
    x = embed_lookup(tokens, params["embed"], cfg.quant).to(dtype)
    dev = tokens.device
    known = caches.hi if isinstance(caches, Caches) else None
    if cfg.family == "encdec":
        if chunked:
            raise ValueError("chunked prefill is not supported for encdec")
        if cross_kv is None:
            raise ValueError("an encoder-decoder prefill takes cross_kv, "
                             "the encoded source's K/V")
        x = x + sinusoid_pos(torch.arange(S, device=dev), cfg.d_model, dtype)
        x, caches = _decoder(params, params["layers"], x, cfg, cross_kv,
                             caches)
        hi = None if known is None else known + S
    else:
        if patches is not None:
            if cfg.family != "vlm" or chunked:
                raise ValueError("patches go with a whole-prompt prefill "
                                 "of a VLM")
            pp = qdot(patches.to(dtype), params["patch_proj"], cfg.quant)
            x = torch.cat([pp, x], dim=1)
            S = x.shape[1]
        hi = None if known is None else known + S
        positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
        if chunked:
            hi = _check_room(caches, cfg, S)
            positions = _decode_positions(caches) + positions
        x, caches, _ = _backbone(params["layers"], x, cfg, positions, caches,
                                 chunked=chunked)
    x = rms_norm(x, params["final_norm"])
    logits = qdot(x[:, -1], params["lm_head"], cfg.quant)
    return logits.to(torch.float32), _with_hi(caches, hi)


@torch.no_grad()
def decode_step(params, token: torch.Tensor, caches, cfg: ModelConfig,
                cross_kv: Optional[List[Tuple[torch.Tensor, torch.Tensor]]]
                = None):
    """One decode step: token (B, 1) -> (logits (B, V) f32, caches).  An
    encoder-decoder takes `cross_kv` (as `prefill`) and adds the
    sinusoid row at position clip(len, 0, smax - 1), as the reference."""
    _check_family(cfg)
    hi = _check_room(caches, cfg, 1)
    dtype = model_dtype(cfg)
    x = embed_lookup(token, params["embed"], cfg.quant).to(dtype)
    if cfg.family == "encdec":
        if cross_kv is None:
            raise ValueError("an encoder-decoder decode step takes cross_kv")
        first = caches[0]
        pos = torch.clamp(first["len"], 0, buffer_len(first) - 1)
        x = x + sinusoid_pos(pos, cfg.d_model, dtype)[:, None]
        x, caches = _decoder(params, params["layers"], x, cfg, cross_kv,
                             caches)
    else:
        positions = _decode_positions(caches)
        x, caches, _ = _backbone(params["layers"], x, cfg, positions, caches)
    x = rms_norm(x, params["final_norm"])
    logits = qdot(x[:, 0], params["lm_head"], cfg.quant)
    return logits.to(torch.float32), _with_hi(caches, hi)
