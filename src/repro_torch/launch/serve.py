"""Single-host serving driver: one model replica behind the fleet scheduler.

Counterpart of the JAX package's ``launch/serve.py``.
:class:`BatchedServer` is the degenerate fleet (one satellite, one replica,
no contact graph): the same wave admission, per-replica decode cache, and
continuous-batching semantics as the constellation engine
(:mod:`repro_torch.serving.engine`), so both exercise identical code. For
requests that arrive at ground stations and route over inter-satellite
links, use :mod:`repro_torch.launch.serve_constellation`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
        [--smoke] --requests 6 --max-new 12 [--device cuda|cpu]

``--arch`` takes the ssm, dense and moe configs (mamba2-780m, gemma2-9b,
qwen3-moe-30b-a3b, ...).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List

import numpy as np

from repro_torch.configs import archs
from repro_torch.serving.replica import ModelDecoder, ReplicaFleet


@dataclasses.dataclass
class Request:
    """A local request: duck-compatible with the fleet's lane protocol
    (``prompt`` / ``out`` / ``done``), minus the ground-segment lifecycle
    fields of :class:`repro_torch.serving.requests.InferenceRequest`."""

    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


class BatchedServer:
    """Fixed-width decode batch; free lanes refill from the queue whenever
    the replica goes idle (wave discipline — the decode cache keeps one
    ``pos`` per replica, so waves prefill together)."""

    _SAT = 0   # the single pseudo-satellite id

    def __init__(self, cfg, batch: int, max_len: int, seed: int = 0, device=None):
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.fleet = ReplicaFleet(
            [self._SAT],
            batch,
            ModelDecoder(cfg, 1, batch, max_len, seed=seed, device=device),
        )
        self.steps = 0

    @property
    def queue(self) -> List[Request]:
        return list(self.fleet.queues[self._SAT])

    @property
    def active(self) -> Dict[int, Request]:
        return {
            lane: r
            for lane, r in enumerate(self.fleet.lanes[self._SAT])
            if r is not None
        }

    def submit(self, req: Request) -> None:
        self.fleet.enqueue(self._SAT, req)

    def step(self) -> bool:
        """Admit if idle, then one decode step. False when fully drained."""
        self.fleet.admit({self._SAT})
        self.fleet.tick()   # finished requests already carry their full output
        if self.fleet.busy(self._SAT):
            self.steps += 1
        return self.fleet.busy(self._SAT) or bool(self.fleet.queues[self._SAT])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=8)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    args = p.parse_args(argv)

    cfg = archs.get(args.arch)
    if args.smoke:
        cfg = archs.smoke_cfg(cfg)
    max_len = args.prompt_len + args.max_new + 8
    srv = BatchedServer(cfg, args.batch, max_len, seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        srv.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
            max_new=args.max_new,
        ))
    t0 = time.time()
    while srv.step():
        pass
    dt = time.time() - t0
    total_tokens = args.requests * args.max_new
    print(f"served {args.requests} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s, {srv.steps} steps)")
    return srv


if __name__ == "__main__":
    main()
