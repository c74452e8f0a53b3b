"""End-to-end training driver on one card.

Counterpart of the JAX package's ``launch/train.py``: any ported arch (full
or smoke config), global-batch training with checkpoint/restart, the same
flags, plus ``--device`` (the card by default; ``cpu`` on request, the
kernels' plain versions). There is one card, so no mesh.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b --smoke \\
      --steps 30 --seq 64 --batch 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m --smoke \\
      --steps 20 --ckpt /tmp/ck --restore
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import archs
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.fl_train import batch_to_device
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adamw


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true", help="reduced config")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--ckpt-every", type=int, default=10)
    p.add_argument("--restore", action="store_true")
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = archs.get(args.arch)
    if args.smoke:
        cfg = archs.smoke_cfg(cfg)
    shape = ShapeConfig("custom", "train", args.seq, args.batch)
    opt_cfg = adamw.OptConfig(
        peak_lr=args.lr, warmup_steps=5, decay_steps=max(args.steps, 10)
    )
    train_step = steps_lib.build_train_step(cfg, opt_cfg)

    state = steps_lib.init_state(args.seed, cfg, opt_cfg, device)
    start_step = 0
    if args.ckpt and args.restore and ckpt_lib.latest_step(args.ckpt) is not None:
        start_step, state = ckpt_lib.restore(args.ckpt, target=state, device=device)
        print(f"restored checkpoint at step {start_step}")

    stream = pipeline.SyntheticStream(cfg, shape, seed=args.seed)
    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = batch_to_device(stream.batch(step), device)
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0:
            print(
                f"step {step:4d} loss {loss:8.4f} "
                f"gnorm {float(metrics['grad_norm']):8.3f} "
                f"lr {float(metrics['lr']):.2e}",
                flush=True,
            )
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt_lib.save(args.ckpt, step + 1, state)
    ckpt_lib.wait_all()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    if losses:
        print(
            f"done: {args.steps - start_step} steps in {dt:.1f}s; "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}"
        )
    else:
        print(f"nothing to do: restored step {start_step} >= --steps {args.steps}")
    return losses


if __name__ == "__main__":
    main()
