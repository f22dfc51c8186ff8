"""Training CLI of the port, with checkpoint/restart and a simulated
fault-tolerance fleet (counterpart of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 200 --batch 8 --seq 128 --qat packed --compress-grads \\
        --grad-codec vp --compress-moments --ckpt-dir /tmp/ckpt

Runs on the card by default and raises when CUDA is absent; `--device
cpu` runs the plain PyTorch versions of the kernels (`--smoke` gives the
reduced config the CPU can train).  `--arch` takes the dense, MoE, SSM
(rwkv6-3b), hybrid (zamba2-7b), encoder-decoder (whisper-tiny: zero
frames (B, encoder_seq, d_model) in every batch) and VLM (internvl2-1b:
zero patches (B, n_patches, d_model)) configs, the stub inputs the
reference's CLI gives them; parameters train in the
reference's tree (`models.model.stack_layers`: one stack per sub-layer
of each scanned group, the hybrid's shared block once), so every
per-leaf scale of `--compress-grads` and `--compress-moments` covers the
reference's elements.  Weights are random from seed 0 (torch
generator), batches come from `data.SyntheticLM` (numpy, seed 0).  With
`--qat packed` every weight matmul quantizes its float master to packed
VP words and runs the quant and `vp_dequant_matmul` kernels forward and
the `vp_matmul_dx` kernel backward.

Each step advances the data position deterministically; on restart the
newest intact checkpoint and its data index resume the run
(`CheckpointManager.restore_latest` walks past checkpoints that fail
their checksums).  `--ft-sim` drives `FaultToleranceController` and
`run_with_restarts` with a simulated host set: every live host
heartbeats each step (`--ft-straggler` reports 3x durations),
`--ft-fail-steps` crashes one host at the named steps, and the loop
restarts from the latest checkpoint while the controller evicts the dead
host and proposes a shrunken mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import QuantConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.model import init_params, resolve_device, stack_layers
from repro_torch.optim.optimizer import OptConfig, OptState, init_opt_state
from repro_torch.train.ckpt import CheckpointManager
from repro_torch.train.compression import (
    CompressionConfig, init_compressor_state)
from repro_torch.train.ft import FaultToleranceController, run_with_restarts
from repro_torch.train.train_step import make_train_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=registry.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU tests)")
    ap.add_argument("--remat", default=None, choices=["none", "full", "dots"],
                    help="activation checkpointing (default: the config's; "
                         "full recomputes each scanned group's repetition "
                         "in the backward, dots runs as none)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true",
                    help="error-feedback gradient compression (codec per "
                         "--grad-codec)")
    ap.add_argument("--grad-codec", default="int8", choices=["int8", "vp"],
                    help="int8 linear, or packed VP words + pow2 scale")
    ap.add_argument("--compress-moments", action="store_true",
                    help="keep Adam mu/nu between steps as packed VP words "
                         "(sqrt(nu) encoding)")
    ap.add_argument("--qat", default="off", choices=["off", "fake", "packed"],
                    help="quantization-aware fine-tune into the serving VP "
                         "format: 'fake' = STE in the float graph, 'packed' "
                         "= packed-word kernels forward and backward")
    ap.add_argument("--quant", default="none",
                    choices=["none", "fxp", "vp", "vp_block"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ft-sim", action="store_true",
                    help="drive the FT controller and restart wrapper with a "
                         "simulated host set")
    ap.add_argument("--ft-hosts", type=int, default=4)
    ap.add_argument("--ft-fail-steps", default="",
                    help="comma-separated steps at which a simulated host "
                         "crashes (kills the loop; restarted)")
    ap.add_argument("--ft-straggler", type=int, default=-1,
                    help="simulated host id reporting 3x step durations")
    ap.add_argument("--ft-max-restarts", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    quant = QuantConfig(mode=args.quant)
    cfg = (registry.get_smoke_config(args.arch, quant) if args.smoke
           else registry.get_config(args.arch, quant))
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=args.remat)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10),
                        total_steps=args.steps,
                        moment_codec="vp" if args.compress_moments else None)
    qat = (QuantConfig(mode="vp", qat_mode=args.qat)
           if args.qat != "off" else None)
    cmp_cfg = (CompressionConfig(codec=args.grad_codec)
               if args.compress_grads else False)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch), device=device)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                              compress_grads=cmp_cfg, qat=qat)
    extra_batch = {}
    if cfg.family == "encdec":
        extra_batch["frames"] = torch.zeros(
            (args.batch, cfg.encoder_seq, cfg.d_model), device=device)
    if cfg.family == "vlm":
        extra_batch["patches"] = torch.zeros(
            (args.batch, cfg.n_patches, cfg.d_model), device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    report = {"arch": args.arch, "remat": cfg.remat,
              "smoke": args.smoke, "qat": args.qat,
              "batch": args.batch, "seq": args.seq, "device": str(device),
              "steps": [], "resumed_from": None, "restarts": 0}

    # One manager for every attempt: an in-process restart leaves the
    # previous attempt's async writer alive, and a fresh manager would
    # sweep its half-written temp dir, losing the checkpoint to resume.
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    # The simulated fleet outlives a crash-restart, as a controller
    # service does on a real fleet.
    ft = sim = None
    if args.ft_sim:
        ft = FaultToleranceController(args.ft_hosts)
        sim = {"dead": set(),
               "pending": sorted({int(s) for s in args.ft_fail_steps.split(",")
                                  if s.strip()}),
               "healthy": ft.healthy(), "now": 0.0}
        if args.ckpt_dir is None:
            print("[ft] warning: --ft-sim without --ckpt-dir restarts from "
                  "step 0 every crash")

    def _ft_step(i: int) -> None:
        """One simulated fleet round: heartbeats, aging, crash injection."""
        sim["now"] += 1.0
        for h in range(args.ft_hosts):
            if h not in sim["dead"]:
                ft.heartbeat(h, 0.3 if h == args.ft_straggler else 0.1,
                             now=sim["now"])
        ft.tick()
        if ft.topology_changed(sim["healthy"]):
            sim["healthy"] = ft.healthy()
            mesh = ft.propose_mesh(chips_per_host=1, model_axis=1)
            print(f"[ft] topology changed: healthy={sim['healthy']} "
                  f"-> elastic mesh {mesh} (generation {ft.generation})")
        if sim["pending"] and i >= sim["pending"][0]:
            sim["pending"].pop(0)
            live = [h for h in range(args.ft_hosts) if h not in sim["dead"]]
            victim = live[-1] if live else 0
            sim["dead"].add(victim)
            raise RuntimeError(f"simulated failure of host{victim} at step {i}")

    def _state(params, opt_state, cmp_state):
        state = {"params": params, "opt": opt_state._asdict()}
        if cmp_state is not None:
            state["cmp"] = cmp_state
        return state

    def train_loop(attempt: int = 0):
        if attempt:
            print(f"[restart] attempt {attempt}")
            report["restarts"] = attempt
        start = 0
        params = stack_layers(init_params(cfg, seed=0, device=device), cfg)
        opt_state = init_opt_state(params, opt_cfg)
        cmp_state = (init_compressor_state(params)
                     if args.compress_grads else None)
        if mgr:
            res = mgr.restore_latest(_state(params, opt_state, cmp_state))
            if res is not None:
                restored, manifest, s = res
                params = restored["params"]
                opt_state = OptState(**restored["opt"])
                # the error-feedback residual resumes too: dropping it
                # would re-inject one step's quantization error
                cmp_state = restored.get("cmp", cmp_state)
                start = manifest["extra"]["data_index"]
                report["resumed_from"] = s
                print(f"[resume] from step {s}, data index {start}")

        tokens = args.batch * args.seq
        for i in range(start, args.steps):
            batch = {**data.batch_at(i), **extra_batch}
            _sync(device)
            t0 = time.perf_counter()
            if args.compress_grads:
                params, opt_state, metrics, cmp_state = step_fn(
                    params, opt_state, batch, cmp_state)
            else:
                params, opt_state, metrics = step_fn(params, opt_state, batch)
            _sync(device)
            dt = time.perf_counter() - t0
            rec = {"step": i, "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]), "seconds": dt,
                   "tokens_per_s": tokens / dt}
            report["steps"].append(rec)
            if i % args.log_every == 0 or i == args.steps - 1:
                print(f"step {i:5d} loss {rec['loss']:.4f} gnorm "
                      f"{rec['grad_norm']:.3f} lr {rec['lr']:.2e} "
                      f"({dt:.3f}s, {rec['tokens_per_s']:.0f} tok/s)")
            if ft is not None:
                _ft_step(i)
            if mgr and (i + 1) % args.ckpt_every == 0:
                mgr.save(i + 1, _state(params, opt_state, cmp_state),
                         extra={"data_index": i + 1})
        if mgr:
            mgr.save(args.steps, _state(params, opt_state, cmp_state),
                     extra={"data_index": args.steps})
            mgr.wait()
        print("done.")

    if args.ft_sim:
        run_with_restarts(train_loop, max_restarts=args.ft_max_restarts)
    else:
        train_loop()
    if device.type == "cuda":
        report["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return report


if __name__ == "__main__":
    main()
