"""The train step (port of `make_train_step` of
`repro.train.train_step`).

One step: gradients of `models.model.loss_fn` by autograd (summed over
microbatches in f32 when the batch is split), optional error-feedback
gradient compression, then one AdamW update.  With `qat` the float
master weights are fine-tuned into a VP format: `qat_mode="packed"`
runs the quant and serving kernels forward and the packed-word
`vp_matmul_dx` kernel backward for every weight matmul
(`kernels.ops.vp_qat_matmul`), so training optimizes the numerics that
serving runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.models.model import loss_fn
from repro_torch.optim.optimizer import OptConfig, OptState, apply_updates
from repro_torch.tree import tree_leaves, tree_map
from .compression import CompressionConfig, compress_decompress


def value_and_grad(params, batch, cfg: ModelConfig):
    """(loss, metrics, grads) of `loss_fn(params, batch, cfg, train=True)`;
    grads are shaped like `params`, in each parameter's dtype."""
    req = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(req, batch, cfg, True)
        flat = torch.autograd.grad(loss, tree_leaves(req),
                                   allow_unused=True, materialize_grads=True)
    parts = iter(flat)
    grads = tree_map(lambda _: next(parts), params)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    microbatches: int = 1,
                    compress_grads: Union[bool, CompressionConfig] = False,
                    qat: Optional[QuantConfig] = None):
    """Returns train_step(params, opt_state, batch[, cmp_state]) ->
    (params, opt_state, metrics[, cmp_state]).

    `qat` replaces the model's QuantConfig (every `qdot` then runs with
    `train=True` under it).  `compress_grads` is a bool (True: the int8
    codec) or a CompressionConfig picking the codec.  With `microbatches`
    > 1 the batch is split along its leading axis into contiguous
    microbatches; their f32 gradient sum is averaged, as are the loss and
    the metrics.
    """
    if qat is not None:
        cfg = dataclasses.replace(cfg, quant=qat)
    cmp_cfg = (compress_grads
               if isinstance(compress_grads, CompressionConfig)
               else CompressionConfig())

    def train_step(params, opt_state: OptState, batch, cmp_state=None):
        if microbatches == 1:
            loss, metrics, grads = value_and_grad(params, batch, cfg)
        else:
            for key, leaf in batch.items():
                if leaf.shape[0] % microbatches:
                    raise ValueError(
                        f"batch leaf {key!r} has leading (global batch) dim "
                        f"{leaf.shape[0]}, not divisible by microbatches="
                        f"{microbatches}; pick a microbatch count that "
                        f"divides the batch")
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses, stacked = [], []
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, -1, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, metrics, g = value_and_grad(params, mb, cfg)
                grads = tree_map(lambda a, b: a + b.to(torch.float32),
                                 grads, g)
                losses.append(loss)
                stacked.append(metrics)
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in stacked]).mean(0)
                       for k in stacked[0]}
        if compress_grads:
            grads, cmp_state = compress_decompress(grads, cmp_state, cmp_cfg)
        params, opt_state, opt_metrics = apply_updates(
            params, grads, opt_state, opt_cfg)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        if compress_grads:
            return params, opt_state, metrics, cmp_state
        return params, opt_state, metrics

    return train_step
