"""Checkpointing: the JAX package's format, read and written by the port.

Layout per checkpoint directory (``<dir>/step_<N>/``), as the reference
writes it (``checkpoint/checkpoint.py``), so a checkpoint saved by either
package restores in the other:

    manifest.msgpack   {step, keys: {path: {shape, dtype, bytes, sha256}},
                        tree_hash, meta}
    data.msgpack.zst   {path: raw bytes}

- ``path`` is a leaf's position in the tree: dict keys (sorted), NamedTuple
  field names (an int8 moment's ``q`` and ``scale``), list indices, joined
  by ``/`` (``opt/mu/embed/tok/q``); ``dtype`` is numpy's name
  (``float32``, ``bfloat16``, ``int8``, ``int32``); the bytes are the
  leaf's, C order.
- The blob is zstd-compressed when ``zstandard`` is importable, zlib
  otherwise; restore tells them apart by zstd's magic number.
- ``save`` snapshots the tree to host memory at once (the device tensors
  may change at the next step), then writes ``step_<N>.tmp`` and renames
  it, in a thread when async (:func:`wait_all` joins them); a crash
  mid-save never corrupts the latest checkpoint. ``keep`` prunes the
  oldest after a successful save.
- Every tensor carries a sha256, checked by ``restore``.
- ``restore`` rebuilds a target tree's structure and dtypes on a device;
  placement across a mesh (the reference's ``shardings``) has no
  counterpart on one card.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import re
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import msgpack
import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim.adamw import QTensor

try:  # optional: better ratio/speed when available
    import zstandard
except ImportError:  # pragma: no cover - depends on environment
    zstandard = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

_SAVE_LOCK = threading.Lock()
_PENDING: List[threading.Thread] = []

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _flatten_with_paths(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in ``jax.tree_util.tree_flatten_with_path``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for name, child in zip(tree._fields, tree):
            out += _flatten_with_paths(child, prefix + (name,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, child in enumerate(tree):
            out += _flatten_with_paths(child, prefix + (str(i),))
        return out
    return [("/".join(prefix), tree)]


def _unflatten_like(target: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(c) for c in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(c) for c in t)
        return next(it)

    return build(target)


def _compress(raw: bytes) -> bytes:
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=3).compress(raw)
    return zlib.compress(raw, level=6)


def _decompress(raw: bytes) -> bytes:
    if raw[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise ImportError(
                "checkpoint was written with zstd but the 'zstandard' "
                "package is not installed"
            )
        return zstandard.ZstdDecompressor().decompress(raw)
    return zlib.decompress(raw)


def _tree_def_hash(keys: List[str]) -> str:
    h = hashlib.sha256()
    for k in keys:
        h.update(k.encode())
    return h.hexdigest()[:16]


def _host(leaf) -> Tuple[str, List[int], bytes]:
    """(dtype name, shape, raw bytes) of one leaf, on the host."""
    t = torch.as_tensor(leaf).detach().to("cpu").contiguous()
    if t.dtype not in _NAMES:
        raise TypeError(f"cannot checkpoint dtype {t.dtype}")
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
    return _NAMES[t.dtype], list(t.shape), raw


def _tensor(raw: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype not in _DTYPES:
        raise TypeError(f"checkpoint dtype {dtype!r} is not supported")
    buf = torch.frombuffer(bytearray(raw), dtype=torch.uint8) if raw else \
        torch.zeros(0, dtype=torch.uint8)
    return buf.view(_DTYPES[dtype]).reshape(shape)


def save(
    ckpt_dir: str | os.PathLike,
    step: int,
    tree: Any,
    meta: Optional[Dict] = None,
    keep: int = 3,
    async_save: bool = True,
) -> threading.Thread | None:
    """Serialize ``tree`` (tensors, or anything ``torch.as_tensor`` takes)
    for ``step``. Returns the writer thread when async (join it or call
    :func:`wait_all`)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    # snapshot to host memory now (device tensors may change next step)
    host = [(k, _host(v)) for k, v in _flatten_with_paths(tree)]

    def write():
        with _SAVE_LOCK:
            final = ckpt_dir / f"step_{step:010d}"
            tmp = ckpt_dir / f"step_{step:010d}.tmp"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "keys": {}, "meta": meta or {}}
            blobs = {}
            for k, (dtype, shape, raw) in host:
                manifest["keys"][k] = {
                    "shape": shape,
                    "dtype": dtype,
                    "bytes": len(raw),
                    "sha256": hashlib.sha256(raw).hexdigest(),
                }
                blobs[k] = raw
            manifest["tree_hash"] = _tree_def_hash(sorted(blobs))
            with open(tmp / "data.msgpack.zst", "wb") as f:
                f.write(_compress(msgpack.packb(blobs, use_bin_type=True)))
            with open(tmp / "manifest.msgpack", "wb") as f:
                f.write(msgpack.packb(manifest, use_bin_type=True))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            _prune(ckpt_dir, keep)

    if async_save:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        _PENDING.append(t)
        return t
    write()
    return None


def wait_all() -> None:
    for t in list(_PENDING):
        t.join()
        _PENDING.remove(t)


def _prune(ckpt_dir: pathlib.Path, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:010d}", ignore_errors=True)


def all_steps(ckpt_dir: str | os.PathLike) -> List[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    out = []
    if not ckpt_dir.exists():
        return out
    for p in ckpt_dir.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and p.is_dir():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str | os.PathLike) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(
    ckpt_dir: str | os.PathLike,
    step: Optional[int] = None,
    target: Any = None,
    device=None,
) -> Tuple[int, Any]:
    """Load a checkpoint: ``(step, tree)``. With ``target`` (a tree of
    tensors, or anything with a ``dtype``, in the saved structure) the tree
    is rebuilt in its structure and dtypes on ``device`` (the card unless
    asked otherwise); without, ``{path: tensor}`` on ``device``. Raises on a
    sha256 mismatch or a missing tensor."""
    dev = resolve_device(device)
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:010d}"
    with open(d / "manifest.msgpack", "rb") as f:
        manifest = msgpack.unpackb(f.read(), raw=False)
    with open(d / "data.msgpack.zst", "rb") as f:
        blobs = msgpack.unpackb(_decompress(f.read()), raw=False)

    arrays: Dict[str, torch.Tensor] = {}
    for k, info in manifest["keys"].items():
        raw = blobs[k]
        if hashlib.sha256(raw).hexdigest() != info["sha256"]:
            raise IOError(f"checkpoint corruption: sha256 mismatch for {k}")
        arrays[k] = _tensor(raw, info["dtype"], info["shape"])

    if target is None:
        return step, {k: v.to(dev) for k, v in arrays.items()}
    leaves = []
    for k, tgt in _flatten_with_paths(target):
        if k not in arrays:
            raise KeyError(f"checkpoint missing tensor {k}")
        want = getattr(tgt, "dtype", torch.float32)
        if isinstance(want, np.dtype) or not isinstance(want, torch.dtype):
            want = _DTYPES[np.dtype(want).name]
        leaves.append(arrays[k].to(device=dev, dtype=want))
    return step, _unflatten_like(target, leaves)


__all__ = ["QTensor", "all_steps", "latest_step", "restore", "save", "wait_all"]
