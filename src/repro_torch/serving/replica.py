"""Replica decode: per-satellite decode-state caches behind one fleet.

Two interchangeable decoders drive the serving engine:

- :class:`NullDecoder` — a pure-host deterministic token source, no model
  and no device; it exists so the transport/scheduling/audit logic (the
  part this subsystem actually adds) is testable fast and bit-deterministic.
- :class:`ModelDecoder` — the real thing: one model replica per satellite,
  all on one device. One copy of the params serves every replica; the
  decode caches carry a leading replica axis, and the lanes of the replicas
  that take part in a call are folded into one batch (the reference runs
  one replica per device under ``shard_map``).

Both expose the same two calls: ``prefill_waves({replica_idx: prompts})``
admits whole waves (the decode cache keeps a single ``pos`` per replica, so
lanes inside one replica cannot stagger — wave discipline per replica,
continuous batching across the fleet), and ``step(active_mask)`` advances
every busy replica one decode step.

:class:`ReplicaFleet` owns the mapping satellite-id → replica lane state:
admission queues, lane occupancy, wave admission, drain-on-churn.

Counterpart of the JAX package's ``serving/replica.py``: ``NullDecoder`` and
``ReplicaFleet`` are copies; ``ModelDecoder`` keeps the reference's
constructor, ``params`` attribute, ``_bucket``, ``prefill_waves`` and
``step``.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.pytree import tree_map
from repro_torch.serving import requests as rq

_NULL_MOD = 65521  # largest prime < 2**16: cheap LCG modulus


class NullDecoder:
    """Deterministic host-side decoder (no model, no devices).

    First token of a lane is a hash of its prompt; each step advances a
    per-lane LCG. Tokens are meaningless but reproducible — exactly what
    the transport tests and the deterministic benchmark layer need.
    """

    def __init__(self, n_replicas: int, batch: int, vocab: int = 128):
        self.n_replicas = n_replicas
        self.batch = batch
        self.vocab = vocab
        self._state = np.zeros((n_replicas, batch), np.int64)

    def prefill_waves(
        self, waves: Dict[int, List[np.ndarray]]
    ) -> Dict[int, List[int]]:
        firsts: Dict[int, List[int]] = {}
        for ridx, prompts in waves.items():
            out: List[int] = []
            for lane, prompt in enumerate(prompts):
                h = (int(np.sum(prompt, dtype=np.int64)) * 31 + lane) % _NULL_MOD
                self._state[ridx, lane] = h
                out.append(h % self.vocab)
            firsts[ridx] = out
        return firsts

    def step(self, active: np.ndarray) -> np.ndarray:
        nxt = (self._state * 75 + 74) % _NULL_MOD
        self._state = np.where(active[:, None], nxt, self._state)
        return (self._state % self.vocab).astype(np.int64)




class ModelDecoder:
    """Every replica's decode state on one device, driven as one batch.

    ``params`` is one shared copy (the reference replicates it over its
    replica mesh). The cache's leaves carry a leading ``(R,)`` replica axis
    (``(R, layers, batch, ...)``) and ``pos`` is one value per replica.
    ``prefill_waves`` left-pads every admitted wave into one prompt-length
    bucket and runs ONE prefill over the admitted replicas' lanes (so one
    kernel launch per layer serves all of them: ``ssd_scan`` or
    ``flash_attention_fwd``), then writes their new caches back; ``step``
    runs one ``decode_step`` over the lanes of the active replicas, whose
    ``pos`` differ (``decode_step`` expands them to one per lane for the
    rope, the cache write and the attention's ``kv_len``) and updates the
    folded cache in place. With one replica active the fold is a view of its
    cache and nothing is copied; with several, a tick moves their caches
    twice (concatenated into the fold, copied back). Folding and
    unfolding work leaf by leaf, so ``KVCache`` and ``MambaCache`` fields
    alike keep their replica axis. In a folded tick each replica's lanes are
    one MoE decode group (``decode_step`` passes the number of replicas), as
    each replica decodes alone under the reference's ``shard_map``; at
    prefill a group is a batch row on both sides. Replicas outside a call keep their cache and
    ``pos`` frozen, as under the reference's ``jnp.where`` merge (which
    computes them and discards the result; skipping them gives the same
    outputs). Under tracing, each call is a ``serve.prefill`` or
    ``serve.decode`` span; both end by copying the next tokens to the host,
    which waits for the device.
    """

    def __init__(
        self,
        cfg,
        n_replicas: int,
        batch: int,
        max_len: int,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_replicas = n_replicas
        self.batch = batch
        self.max_len = max_len
        self.bundle = registry.bundle(cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.bundle.init(gen)
        units = self.bundle.init_cache(batch, max_len, self.device)["units"]
        self._cache = {
            "pos": torch.zeros((n_replicas,), dtype=torch.int32, device=self.device),
            "units": tree_map(
                lambda x: x[None].expand((n_replicas,) + tuple(x.shape)).contiguous(),
                units,
            ),
        }
        self._last = np.zeros((n_replicas, batch), np.int64)

    @staticmethod
    def _bucket(plen: int) -> int:
        b = 8
        while b < plen:
            b *= 2
        return b

    def _lanes(self, ridxs: Sequence[int]) -> Dict:
        """The cache of replicas ``ridxs`` as ``(layers, k*batch, ...)``, with
        one ``pos`` per replica. One replica's cache already has that layout
        and is returned as a view, so decode updates it in place; several are
        concatenated into a copy."""
        rs = [int(r) for r in ridxs]

        def fold(x):
            return x[rs[0]] if len(rs) == 1 else torch.cat([x[r] for r in rs], dim=1)

        sel = torch.as_tensor(rs, dtype=torch.long, device=self.device)
        return {"pos": self._cache["pos"].index_select(0, sel),
                "units": tree_map(fold, self._cache["units"])}

    def _write(self, ridxs: Sequence[int], new: Dict) -> None:
        """Write folded caches of replicas ``ridxs`` back under the replica
        axis. A leaf that is a view of the cache itself (one replica's fold,
        updated in place by decode) needs no copy."""
        rs = [int(r) for r in ridxs]

        def put(dst, src):
            if src.untyped_storage().data_ptr() == dst.untyped_storage().data_ptr():
                return
            for i, r in enumerate(rs):
                dst[r].copy_(src[:, i * self.batch:(i + 1) * self.batch])

        tree_map(put, self._cache["units"], new["units"])
        sel = torch.as_tensor(rs, dtype=torch.long, device=self.device)
        self._cache["pos"].index_copy_(
            0, sel, new["pos"].to(torch.int32).expand(len(rs)).contiguous())

    def _tokens(self, logits: torch.Tensor, k: int) -> np.ndarray:
        nxt = torch.argmax(logits[:, -1], dim=-1)
        return nxt.view(k, self.batch).cpu().numpy().astype(np.int64)

    @torch.no_grad()
    def prefill_waves(
        self, waves: Dict[int, List[np.ndarray]]
    ) -> Dict[int, List[int]]:
        plen = self._bucket(max(len(p) for ps in waves.values() for p in ps))
        if plen + 1 > self.max_len:
            raise ValueError(
                f"prompt bucket {plen} does not fit max_len={self.max_len}"
            )
        ridxs = sorted(waves)
        toks = np.zeros((len(ridxs), self.batch, plen), np.int64)
        for k, ridx in enumerate(ridxs):
            for lane, prompt in enumerate(waves[ridx]):
                toks[k, lane, plen - len(prompt):] = prompt  # left-pad
        rec = telemetry.get_recorder()
        with rec.span("serve.prefill", cat="serve", bucket=plen,
                      lanes=len(ridxs) * self.batch):
            tokens = torch.from_numpy(toks.reshape(-1, plen)).to(self.device)
            logits, new = self.bundle.prefill_fn(self.params, {"tokens": tokens},
                                                 self.max_len)
            self._write(ridxs, new)
            first = self._tokens(logits, len(ridxs))
        rec.counter("serve.prefill.calls")
        out: Dict[int, List[int]] = {}
        for k, ridx in enumerate(ridxs):
            out[ridx] = [int(first[k, lane]) for lane in range(len(waves[ridx]))]
            self._last[ridx] = first[k]
        return out

    @torch.no_grad()
    def step(self, active: np.ndarray) -> np.ndarray:
        ridxs = np.flatnonzero(active)
        if ridxs.size == 0:
            return self._last.copy()
        rec = telemetry.get_recorder()
        with rec.span("serve.decode", cat="serve", lanes=int(ridxs.size) * self.batch):
            tok = torch.from_numpy(self._last[ridxs].reshape(-1, 1)).to(self.device)
            logits, new = self.bundle.decode_fn(self.params, self._lanes(ridxs),
                                                {"token": tok})
            self._write(ridxs, new)
            nxt = self._tokens(logits, int(ridxs.size))
        self._last[ridxs] = nxt
        return self._last.copy()


class ReplicaFleet:
    """Slot-aware continuous batching across the satellite replica set.

    Each replica runs wave discipline (a new wave is admitted only when its
    lanes are all free — the decode cache is one unit per replica); the
    *fleet* batches continuously: waves start and finish independently
    across replicas, and requests finishing early inside a wave release
    their response immediately while the wave's stragglers keep decoding.
    """

    def __init__(self, replica_ids: Sequence[int], batch: int, decoder):
        self.replica_ids: List[int] = sorted(int(s) for s in replica_ids)
        self.index = {sat: i for i, sat in enumerate(self.replica_ids)}
        self.batch = batch
        self.decoder = decoder
        self.queues: Dict[int, Deque[rq.InferenceRequest]] = {
            sat: deque() for sat in self.replica_ids
        }
        self.lanes: Dict[int, List[Optional[rq.InferenceRequest]]] = {
            sat: [None] * batch for sat in self.replica_ids
        }

    # ------------------------------------------------------------- queries
    def queued(self, sat: int) -> int:
        return len(self.queues[sat])

    def busy(self, sat: int) -> bool:
        return any(r is not None for r in self.lanes[sat])

    def active_requests(self, sat: int) -> List[rq.InferenceRequest]:
        return [r for r in self.lanes[sat] if r is not None and not r.done]

    def occupancy(self) -> float:
        """Active decode lanes / total lanes (fleet utilization gauge)."""
        total = len(self.replica_ids) * self.batch
        if total == 0:
            return 0.0
        busy = sum(
            1
            for sat in self.replica_ids
            for r in self.lanes[sat]
            if r is not None and not r.done
        )
        return busy / total

    # ----------------------------------------------------------- admission
    def enqueue(self, sat: int, req: rq.InferenceRequest) -> None:
        self.queues[sat].append(req)

    def admit(self, eligible) -> Dict[int, List[rq.InferenceRequest]]:
        """Start a wave on every eligible idle replica with queued work.

        Returns the admitted requests per satellite; each already carries
        its first decoded token (prefill emits it), so a ``max_new=1``
        request is complete straight out of admission.
        """
        waves: Dict[int, List[rq.InferenceRequest]] = {}
        prompts: Dict[int, List[np.ndarray]] = {}
        for sat in self.replica_ids:
            if sat not in eligible or self.busy(sat) or not self.queues[sat]:
                continue
            wave = [
                self.queues[sat].popleft()
                for _ in range(min(self.batch, len(self.queues[sat])))
            ]
            for lane, req in enumerate(wave):
                self.lanes[sat][lane] = req
            waves[sat] = wave
            prompts[self.index[sat]] = [r.prompt for r in wave]
        if not waves:
            return {}
        firsts = self.decoder.prefill_waves(prompts)
        for sat, wave in waves.items():
            for lane, req in enumerate(wave):
                req.out.append(int(firsts[self.index[sat]][lane]))
            if all(r.done for r in wave):
                # one-token requests: the wave completed at prefill, so the
                # lanes free immediately (tick would never see it active)
                self.lanes[sat] = [None] * self.batch
        return waves

    # -------------------------------------------------------------- decode
    def tick(self) -> Dict[int, List[rq.InferenceRequest]]:
        """One decode step for every replica with unfinished lanes.

        Returns the requests that just finished, keyed by satellite; fully
        finished waves release their lanes (the replica goes idle and can
        admit again next admission pass)."""
        active = np.zeros((len(self.replica_ids),), np.bool_)
        for i, sat in enumerate(self.replica_ids):
            active[i] = bool(self.active_requests(sat))
        if not active.any():
            return {}
        toks = self.decoder.step(active)
        finished: Dict[int, List[rq.InferenceRequest]] = {}
        for i, sat in enumerate(self.replica_ids):
            if not active[i]:
                continue
            for lane, req in enumerate(self.lanes[sat]):
                if req is None or req.done:
                    continue
                req.out.append(int(toks[i, lane]))
                if req.done:
                    finished.setdefault(sat, []).append(req)
            if all(r is None or r.done for r in self.lanes[sat]):
                self.lanes[sat] = [None] * self.batch
        telemetry.get_recorder().counter(
            "serve.decode.steps", float(int(active.sum()))
        )
        return finished

    # --------------------------------------------------------------- churn
    def drain(self, sat: int) -> List[rq.InferenceRequest]:
        """A replica lost visibility: abandon its wave and queue.

        Returns every request that still needs serving (mid-decode lanes
        and the admission queue); finished lanes keep nothing — their
        responses already left the fleet. The lane state clears so a
        re-admitted replica starts idle."""
        if sat not in self.index:
            return []
        out = [r for r in self.lanes[sat] if r is not None and not r.done]
        out.extend(self.queues[sat])
        self.lanes[sat] = [None] * self.batch
        self.queues[sat].clear()
        if out:
            telemetry.get_recorder().counter("serve.fleet.drained", len(out))
        return out




__all__ = ["ModelDecoder", "NullDecoder", "ReplicaFleet"]
